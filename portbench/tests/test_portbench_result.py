"""A run's last line: the contract's keys, ``checks`` last."""

import json
import subprocess
import sys

import pytest

from portbench.cells import ROOT
from portbench_small import run

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    res, rows = run("nanograv-lband.wb_campaign", trace=trace)
    assert all(k in res for k in REQUIRED)
    assert list(res)[-1] == "checks"
    assert {k for k, _, _ in rows} == set(res["checks"])
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(res)
    if trace:
        assert set(res["metrics"]) <= {
            "prepare_ms_per_archive", "drain_wait_pct", "copy_stage_gb_per_s",
            "nfev_per_toa", "median_device_pct", "b1_roofline",
            "device_idle_pct"}
        assert "nfev_per_toa" in res["metrics"]
        assert {"busy_s", "window_s"} <= set(res["device"])
        bd = res["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    else:
        assert set(res["metrics"]) == {"toas_per_s", "setup_s"}
        assert res["metrics"]["toas_per_s"]["value"] > 0


def test_no_card_exits_nonzero_without_a_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "nanograv-lband.wb_campaign", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""

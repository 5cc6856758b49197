"""The port's scale-out across two REAL processes: a gloo process group
on the CPU (parallel.init_multihost, device='cpu'), both ranks started as
tests/test_multihost_spawn.py starts its workers, and one spawn running
every check:

- fit_portrait_sharded_fast on a 2 x 1 mesh (the batch over 'data') and
  on a 1 x 2 mesh (shard_channels=True: each rank holds half of the
  channels, B1's plain version sees (nb, nchan/2, nbin) rows, and the
  chi^2 channel sums are combined over 'chan'), the scattering lane and
  the complex engine (fit_portrait_sharded) at 1 x 2 too, against the
  same call at world size 1 on the whole batch in this process and
  against the JAX program on a 4 x 2 mesh with shard_channels=True;
- align_iteration_sharded on the 2 x 1 mesh (the accumulators summed
  over 'data') and on the 1 x 2 mesh (the template gathered over
  'chan') against world size 1 and the JAX program;
- process_allgather of ragged lengths (3 and 2);
- stream_ipta_campaign(shard=True) over two small pulsars: the union of
  the ranks' .tim shards equals the one-process .tim field by field
  after parsing, and every rank returns the same summary, whose values
  are the one-process summary's.

Tolerances: the sharded fits and align run the same float64 programs on
the same rows as world size 1 (the channel sums in the same tree order),
so they are held equal to 1e-12 (relative to max |ref|; phi 1e-12 rot);
against JAX, tests/test_torch_parallel.py's: 1e-8 (the scattering lane
1e-7), the template 1e-10; the .tim fields exactly.  Every
wait on the children has a timeout that kills both and fails the test: a
hung collective fails fast (test_hung_rank_fails_within_timeout).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import jax.numpy as jnp

from test_torch_helpers import SCALE_K as K
from test_torch_helpers import rel_err, scale_calls, scale_inputs

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import parallel as JPar
from pulseportraiture_tpu.fit import FitFlags as JFlags
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import parallel as TPar
from pulseportraiture_tpu_torch.fit.portrait import FitFlags as TFlags

TIMEOUT = 120.0

PRELUDE = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from pulseportraiture_tpu_torch import config as cfg
from pulseportraiture_tpu_torch import parallel
assert parallel.init_multihost(f"127.0.0.1:{port}", num_processes=2,
                               process_id=rank, device="cpu",
                               timeout=60) is True
import torch.distributed as dist
assert dist.get_backend() == "gloo"
assert parallel.process_count() == 2 and parallel.process_index() == rank
"""

WORKER = PRELUDE + r"""
sys.path.insert(0, os.environ["PPT_TEST_DIR"])
from test_torch_helpers import SCALE_K as K
from test_torch_helpers import scale_calls
from pulseportraiture_tpu_torch.fit import portrait
from pulseportraiture_tpu_torch.ops import fused
cfg.use_fast_fit = True
cfg.fit_fused = True
cfg.fit_harmonic_window = K
cfg.scatter_compensated = False
out = {}
seen = []
def spy(fn, label):
    def run(port, *a, **k):
        seen.append([label, list(port.shape), bool(k.get("want_m2"))])
        return fn(port, *a, **k)
    return run
# the engines' local ports, and B1's (its plain version here) rows
for mod, name in ((portrait, "fit_portrait_batch_fast"),
                  (portrait, "fit_portrait_batch"),
                  (fused, "fused_cross_spectrum")):
    setattr(mod, name, spy(getattr(mod, name), name))
for name, nd, nc, call in scale_calls(parallel, portrait.FitFlags):
    mesh = parallel.make_mesh(n_data=nd, n_chan=nc, devices=["cpu"])
    assert mesh.coords == divmod(rank, nc)
    del seen[:]
    r = call(mesh)
    if name.startswith("align"):
        out[name + "_template"] = r[0].numpy().tolist()
        r = r[1]
    out[name] = {k: v.numpy().tolist() for k, v in r._asdict().items()}
    out[name + "_seen"] = list(seen)
g = parallel.process_allgather(np.arange(3.0 - rank) + 10 * rank)
out["allgather"] = [x.tolist() for x in g]

from pulseportraiture_tpu_torch.pipeline.ipta import (IPTAJob,
                                                      stream_ipta_campaign)
camp = json.load(open(os.path.join(outdir, "campaign.json")))
jobs = [IPTAJob(n, f, camp["gmodel"]) for n, f in camp["files"].items()]
res = stream_ipta_campaign(jobs, outdir=os.path.join(outdir, "sharded"),
                           nsub_batch=2, quiet=True, device="cpu")
out["summary"] = {k: [m.tolist(), e.tolist()]
                  for k, (m, e) in res.DeltaDM_summary.items()}
out["ntoa"] = len(res.TOA_list)
with open(os.path.join(outdir, f"out{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""

HUNG = PRELUDE + r"""
import time
if rank == 0:
    parallel.process_allgather(np.arange(3.0))  # rank 1 never joins
else:
    time.sleep(600)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(code, outdir, timeout=TIMEOUT):
    """Start two ranks of ``code`` and wait for both; on the timeout both
    are killed and the test fails.  Returns their outputs."""
    script = os.path.join(outdir, "rank.py")
    with open(script, "w") as f:
        f.write(code)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PPT_TEST_DIR=here,
               PYTHONPATH=os.path.dirname(here) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, script, str(r), port, outdir],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the ranks did not finish within {timeout} s")
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{o}"
    return outs


def _parse_tim(paths):
    """{(archive, subint): {field: value}} over the TOA lines of .tim
    files: archive, frequency, MJD (as printed), error, site and every
    flag."""
    out = {}
    for path in paths:
        with open(path) as f:
            for ln in f:
                tok = ln.split()
                if not tok or tok[0] in ("C", "FORMAT", "MODE"):
                    continue
                rec = {"freq": float(tok[1]), "mjd": tok[2],
                       "err": float(tok[3]), "site": tok[4]}
                rec.update(zip(tok[5::2], tok[6::2]))
                key = (tok[0], rec["-subint"])
                assert key not in out, key
                out[key] = rec
    return out


@pytest.fixture
def campaign(tmp_path):
    """Two pulsars of two archives each (2 subints x 16 channels x 128
    bins) and their template, listed in campaign.json for the ranks."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    model = default_test_model(1500.0)
    gmodel = str(tmp_path / "m.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = {}
    for k, name in enumerate(("PSRA", "PSRB")):
        files[name] = []
        for i in range(2):
            p = str(tmp_path / f"{name}-{i}.fits")
            make_fake_pulsar(model, {"PSR": name, "P0": 0.003 + 0.001 * k,
                                     "DM": 10.0, "PEPOCH": 55000.0},
                             outfile=p, nsub=2, nchan=16, nbin=128,
                             dDM=2e-4 * (i + 2 * k),
                             start_MJD=MJD(55100 + i, 0.1 + 0.1 * k),
                             noise_stds=0.05, dedispersed=False, quiet=True,
                             rng=10 * k + i, device="cpu")
            files[name].append(p)
    with open(tmp_path / "campaign.json", "w") as f:
        json.dump({"gmodel": gmodel, "files": files}, f)
    return files, gmodel


@pytest.fixture
def fast_config():
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window",
            "scatter_compensated")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = K
    jcfg.scatter_compensated = tcfg.scatter_compensated = False
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def test_two_gloo_ranks_match_world_size_one(tmp_path, campaign,
                                             fast_config):
    from pulseportraiture_tpu_torch.pipeline.ipta import (
        IPTAJob, stream_ipta_campaign)

    outs = run_ranks(WORKER, str(tmp_path))
    got = []
    for r in range(2):
        with open(tmp_path / f"out{r}.json") as f:
            got.append(json.load(f))

    # the world-size-1 references on the whole batch, in this process (no
    # process group), and the JAX programs on a 4 x 2 mesh
    mesh = TPar.make_mesh(devices=["cpu"])
    jmesh = JPar.make_mesh(n_data=4, n_chan=2)
    jcalls = {n: c for n, _, _, c in scale_calls(JPar, JFlags, jnp.asarray)}
    for name, nd, nc, call in scale_calls(TPar, TFlags):
        ref = call(mesh)
        jref = jcalls[name](jmesh) if nc == 2 else None
        if name.startswith("align"):
            ref_t, ref = ref
            if jref is not None:
                jref_t, jref = jref
            for g in got:
                assert rel_err(g[name + "_template"], ref_t) <= 1e-12, name
                if jref is not None:
                    assert rel_err(g[name + "_template"], jref_t) <= 1e-10
        ref = {k: v.numpy() for k, v in ref._asdict().items()}
        for g in got:
            fit = {k: np.asarray(v) for k, v in g[name].items()}
            assert_parity(fit, ref, 1e-12, 1e-12, name)
            if jref is not None:
                assert_parity(fit, {k: np.asarray(v) for k, v in
                                    jref._asdict().items()},
                              1e-7 if name.startswith("scat") else 1e-8,
                              1e-9, name)
            # each rank's engine saw its block: the whole batch over
            # 'data' at 1 x 2, nchan / 2 channels; B1 on the same rows
            nb, nchan, nbin = scale_inputs(name)[0].shape
            local = [nb // nd, nchan // nc]
            assert g[name + "_seen"], name
            for label, shape, m2 in g[name + "_seen"]:
                assert shape[:2] == local, (name, label, shape)
                assert m2 == (label == "fused_cross_spectrum"
                              and name.startswith("scat")), (name, label)
            if not name.startswith("complex"):
                assert ["fused_cross_spectrum", local + [nbin],
                        name.startswith("scat")] in g[name + "_seen"]
    for g in got:
        assert g["allgather"] == [[0.0, 1.0, 2.0], [10.0, 11.0]]

    files, gmodel = campaign
    jobs = [IPTAJob(n, f, gmodel) for n, f in files.items()]
    one = stream_ipta_campaign(jobs, outdir=str(tmp_path / "one"),
                               nsub_batch=2, quiet=True, device="cpu")
    for name in files:
        shards = [str(tmp_path / "sharded" / f"{name}.p{r}.tim")
                  for r in range(2)]
        assert all(os.path.exists(p) for p in shards), outs
        union = _parse_tim(shards)
        whole = _parse_tim([str(tmp_path / "one" / f"{name}.tim")])
        assert union.keys() == whole.keys() and len(whole) == 4
        for key, rec in whole.items():
            assert union[key] == rec, (key, union[key], rec)
        # every rank returns the same summary: rank 0's shard then rank
        # 1's, so the one-process summary's values in another order
        s0, s1 = (g["summary"][name] for g in got)
        assert s0 == s1
        m1, e1 = one.DeltaDM_summary[name]
        assert sorted(s0[0]) == sorted(m1.tolist())
        assert sorted(s0[1]) == sorted(e1.tolist())
    assert sum(g["ntoa"] for g in got) == len(one.TOA_list) == 8


def assert_parity(got, ref, tol, phi_tol, name):
    """A gathered fit's fields against a reference: phi within phi_tol
    rot, the floating fields within tol of max |ref| (the covariance,
    the inverse of the Hessian combined over 'chan', among them), the
    counts equal."""
    dphi = np.abs((got["phi"] - ref["phi"] + 0.5) % 1.0 - 0.5)
    assert np.all(dphi <= phi_tol), (name, dphi)
    for k in ("DM", "phi_err", "DM_err", "tau", "tau_err", "snr", "nu_DM",
              "chi2", "scales", "scale_errs", "channel_snrs", "covariance"):
        if np.any(ref[k] != 0):
            assert rel_err(got[k], ref[k]) <= tol, (name, k)
    for k in ("nfeval", "return_code", "dof"):
        assert np.array_equal(got[k], ref[k]), (name, k)


def test_hung_rank_fails_within_timeout(tmp_path):
    """A collective that never completes (rank 1 never joins) fails the
    test at run_ranks' timeout, with both children killed."""
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="did not finish"):
        run_ranks(HUNG, str(tmp_path), timeout=10.0)
    assert time.monotonic() - t0 < 30.0

"""One run of one cell: set-up, the measured window, the check.

``run_cell`` is what ``run.py`` calls once it has found the cards the cell
asks for; the tests call it on the CPU at a small size.
"""

import gc
import json
import math
import os
import sys
import tempfile
import time

import torch

from . import cells, compare, importcheck, pool as poolmod, reference
from . import trace as tracemod
from .window import Campaign, b1_calls_recorded, default_nsub_batch

# the longest window a traced run profiles: the profiler's record of a
# longer one takes minutes to read back (the scattering cell's 51 s took
# ~200 s), and a run has to end within 360 s
TRACE_WINDOW_S = 20.0

# passes over the pool before the window: two, so the pipeline reaches
# its full depth of dispatches in flight and every allocation the window
# makes has been made once
WARM_PASSES = 2


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_info(device, count=1):
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def setup_cell(cell, seed, device, cfg_over=None):
    """The cell's configuration (``cfg_over``: sizes the tests cut),
    traffic, limits and pool."""
    bench = cells.load_benchmark()
    w = cells.find_cell(bench, cell)
    cfg = dict(cells.load_config(w["config"]), **(cfg_over or {}))
    traffic = cells.load_traffic(w["traffic"])
    limits = cells.load_limits(cell)
    pool = poolmod.make_pool(cfg, traffic, seed, device)
    return bench, w, cfg, traffic, limits, pool


def program_lane(pool, traffic, device, nsub_batch, tracer=None):
    """The port's wideband lane and loader for this pool."""
    from pulseportraiture_tpu_torch.pipeline.stream import make_wideband_lane

    return make_wideband_lane(pool.template_path, nsub_batch=nsub_batch,
                              device=device, tracer=tracer, quiet=True,
                              **traffic.get("lane", {}))


def load_pool(pool, loader):
    loaded = poolmod.load_through(pool, loader)
    for f, d in loaded:
        if not d.get("raw_mode", False):
            raise RuntimeError(f"{f}: the loader took the host-decoded lane, "
                               "not the raw int16 lane")
    return loaded


# faults planted in the reference put in the program's place, to read
# what each number gives when an answer is wrong: one TOA of every archive
# moved by one phase bin, and half of every archive's TOAs left out
FAULTS = ("answer_one_bin", "half_left_out")


def reference_numbers(pool, camp_or_none, device, control=None, fault=None,
                      dump=None):
    """The reference's TOAs, then the numbers of the program's run (or,
    with ``control``, of the reference at that precision in its place; or
    with ``fault``, of the reference in its place with that fault)."""
    ref = reference.fit_pool(pool, device)
    if control is not None or fault is not None:
        ctl = (reference.fit_pool(pool, device, control=control)
               if control is not None else ref)
        idx, prog = compare.reference_as_program(pool, ctl)
        admitted = pool.narchive * pool.nsub
        if fault == "answer_one_bin":
            i = Campaign.FIELDS.index("frac")
            prog[:, 1, i] += pool.period_s / pool.nbin / 86400.0
        elif fault == "half_left_out":
            prog[:, pool.nsub // 2:] = float("nan")
    else:
        idx, prog = camp_or_none.stacked()
        admitted = camp_or_none.admitted_toas
    if dump:
        import numpy as np

        os.makedirs(os.path.dirname(dump), exist_ok=True)
        np.savez(dump, idx=idx, prog=prog, fields=Campaign.FIELDS,
                 **{f"ref_{k}": v for k, v in ref.items()})
    return compare.compare(pool, idx, prog, ref, Campaign.FIELDS, admitted)


def run_cell(cell, seed, seconds, trace=False, device="cuda", control=None,
             t_start=None, cfg_over=None, nsub_batch=None,
             warm_passes=WARM_PASSES):
    """One run; returns (result dict, [(name, value, limit)])."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases = {"start_s": time.perf_counter() - t_start}
    bench, w, cfg, traffic, limits, pool = setup_cell(
        cell, seed, device, cfg_over)
    _sync(device)
    phases["pool_s"] = time.perf_counter() - t_start
    nsb = default_nsub_batch() if nsub_batch is None else nsub_batch
    tracer = None
    trace_path = None
    if trace and control is None:
        from pulseportraiture_tpu_torch.telemetry import Tracer

        fd, trace_path = tempfile.mkstemp(prefix="portbench-", suffix=".jsonl")
        os.close(fd)
        tracer = Tracer(trace_path, run=f"portbench {cell}")
    camp = None
    window_s = None
    prof_out = None
    b1_calls = []
    if control is None:
        lane, loader = program_lane(pool, traffic, device, nsb, tracer)
        phases["lane_s"] = time.perf_counter() - t_start
        loaded = load_pool(pool, loader)
        phases["load_s"] = time.perf_counter() - t_start
        camp = Campaign(pool, lane, loaded, device, nsb, tracer=tracer,
                        spans=bool(trace))
        camp.run(passes=warm_passes)
        phases["warm_s"] = time.perf_counter() - t_start
        camp.results.clear()
        camp.admitted_toas = 0
        # what set-up left behind is collected once and then never
        # traversed again by the collector inside the window
        gc.collect()
        gc.freeze()
        _sync(device)
        setup_s = time.perf_counter() - t_start
        if trace:
            from torch.profiler import ProfilerActivity, profile

            cuda = torch.device(device).type == "cuda"
            acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
            tracer.emit("portbench_window", edge="start")
            camp.spans.done.clear()
            with b1_calls_recorded(b1_calls, camp.spans), \
                    profile(activities=acts) as prof:
                t_mark = tracemod.mark(device) if cuda else None
                window_s = camp.run(seconds=min(seconds, TRACE_WINDOW_S))
                _sync(device)
            tracer.emit("portbench_window", edge="end")
            t_trace = time.perf_counter()
            dev = tracemod.profile_events(prof)
            del prof
            # the CPU has no device ops to place the spans among
            spans = (tracemod.align_marker(dev, t_mark, camp.spans.done)
                     if cuda else camp.spans.done)
            prof_out = tracemod.reduce(dev, spans)
            phases["trace_s"] = time.perf_counter() - t_trace
        else:
            window_s = camp.run(seconds=seconds)
        camp.close()
    else:
        setup_s = time.perf_counter() - t_start
    attempted = camp.admitted_toas if camp else pool.narchive * pool.nsub
    returned = camp.returned_toas() if camp else attempted
    dev_info = _device_info(device)
    if camp is not None:
        # free the program's state before the reference runs, so the
        # reference never sets the peak
        camp.ex = None
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = reference_numbers(pool, camp, device, control)
    phases["reference_s"] = time.perf_counter() - t_ref
    ok, rows = compare.judge(numbers, limits)
    found = importcheck.forbidden_modules(list(sys.modules))
    if found:
        raise RuntimeError("the run loaded " + ", ".join(found))
    metrics = {}
    if not trace:
        for m in cells.cell_metrics(bench, cell, "end_to_end"):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == "toas_per_s" and window_s:
                metrics["toas_per_s"] = {"value": returned / window_s,
                                         "unit": m["unit"]}
    result = {"correct": ok, "attempted": int(attempted),
              "failed": int(numbers["missing_toas"]), "metrics": metrics,
              "device": dev_info}
    if trace and prof_out is not None:
        tracer.close()
        events = _window_events(trace_path)
        os.unlink(trace_path)
        ctx = {"events": events, "window_s": prof_out["window_s"],
               "busy_s": prof_out["busy_s"], "device": prof_out["device"],
               "b1_calls": b1_calls}
        for m in cells.cell_metrics(bench, cell, "per_layer"):
            v = cells.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"]["busy_s"] = prof_out["busy_s"]
        result["device"]["window_s"] = prof_out["window_s"]
        result["breakdown"] = prof_out["breakdown"]
    # not read by the check: the work done and where set-up went (seconds
    # since the process started, the reference's own length)
    result["work"] = {"returned_toas": int(returned),
                      "window_s": window_s, **phases}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def _window_events(path):
    """The program's trace events between the harness's window marks."""
    out, on = [], False
    with open(path) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("type") == "portbench_window":
                on = ev.get("edge") == "start"
                continue
            if on:
                out.append(ev)
    return out


def finite_json(obj):
    """obj with non-finite floats as strings (JSON has no inf or NaN)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: finite_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite_json(v) for v in obj]
    return obj

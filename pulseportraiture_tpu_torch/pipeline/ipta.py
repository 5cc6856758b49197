"""IPTA-scale multi-pulsar campaign driver, BASELINE.md config 5
(counterpart of pulseportraiture_tpu/pipeline/ipta.py).

The orchestration layer above pipeline/stream.py:

- a **job registry**: each pulsar brings its own archive list, template
  and optional per-pulsar fit options;
- **per-pulsar buckets and outputs**: each pulsar streams through
  stream_wideband_TOAs with its own template (different template
  portraits never share a dispatch), and TOAs append to
  ``outdir/<pulsar>.tim`` as archives complete, so an interrupted
  campaign keeps every completed archive on disk;
- **one trace**: a single tracer is threaded through every per-pulsar
  stream call and the timing stage, with dispatch seqs unique across
  the per-pulsar executors (telemetry.Tracer.next_seq);
- **the fleet timing stage** (``timing_pars=``): the measured TOAs of
  the listed pulsars feed timing.fleet.fleet_gls_fit on the same
  tracer, so archives -> TOAs -> timing solutions run as one pipeline.

- **the thin-client modes**: with ``server=`` every pulsar's shard is
  one request to a running serve.ToaServer, so the warm executor
  carries across pulsars and small shards coalesce into shared
  dispatches; with ``router=`` each request is placed on a fleet of
  such servers by a serve.ToaRouter.

- **multi-process sharding across the (pulsar, archive) grid**: under a
  ``torch.distributed`` process group (parallel.init_multihost) the
  flattened grid is dealt round-robin over the ranks
  (parallel.shard_files), each rank writes its own checkpoint shards
  ``outdir/<pulsar>.p<rank>.tim``, and the per-pulsar DeltaDM summaries
  are allgathered (parallel.process_allgather), so every rank returns
  the whole campaign's summary.
"""

import glob
import os
import re
import time

import numpy as np

from .. import parallel
from ..telemetry import log, resolve_tracer
from ..utils.bunch import DataBunch
from .stream import (checkpoint_completed, sanitize_checkpoint,
                     stream_wideband_TOAs)
from .toas import _is_metafile, _read_metafile

__all__ = ["IPTAJob", "stream_ipta_campaign"]


def _shard_checkpoints(outdir, pulsar):
    """Existing checkpoint shards belonging to `pulsar`, anchored to the
    shard naming scheme ({pulsar}.tim and {pulsar}.pN.tim): a bare
    prefix glob would absorb another pulsar whose name extends this one
    (e.g. 'J1713' reading 'J1713+0747.p0.tim')."""
    shard_re = re.compile(re.escape(pulsar) + r"(\.p\d+)?\.tim$")
    return sorted(
        p for p in glob.glob(os.path.join(outdir, f"{pulsar}*.tim"))
        if shard_re.fullmatch(os.path.basename(p)))


class IPTAJob:
    """One pulsar's campaign slice: archives + template + options.

    datafiles: list of paths or a metafile path; modelfile: .gmodel /
    spline / PSRFITS template; kwargs: per-pulsar overrides forwarded
    to stream_wideband_TOAs (e.g. fit_scat=True for the scattered
    pulsars only, DM0=...)."""

    def __init__(self, pulsar, datafiles, modelfile, **kwargs):
        self.pulsar = str(pulsar)
        if isinstance(datafiles, str):
            self.datafiles = (_read_metafile(datafiles)
                              if _is_metafile(datafiles) else [datafiles])
        else:
            self.datafiles = list(datafiles)
        self.modelfile = str(modelfile)
        self.kwargs = dict(kwargs)


def _serve_campaign(server, router, jobs, by_psr, stream_kwargs, outdir,
                    tim_name, tracer, per_pulsar, TOA_list):
    """The thin-client path: submit every pulsar's shard to ``server``
    (retrying on backpressure) or to ``router`` (which owns the
    backpressure retries across its fleet), then collect the results in
    job order into ``per_pulsar`` and ``TOA_list``."""
    from ..serve import ServeRejected

    target = "ToaServer" if server is not None else "ToaRouter"
    # executor-level knobs belong to the server (it was built with
    # them); as lane options they would fail every request with a
    # TypeError on the serving thread, so they are refused here by name
    executor_kw = {"max_inflight", "pipeline_depth", "stream_devices",
                   "prefetch", "tim_out", "resume", "skip_archives"}
    bad = executor_kw & (set(stream_kwargs)
                         | {k for j in jobs for k in j.kwargs})
    if bad:
        raise ValueError(
            f"stream_ipta_campaign: {sorted(bad)} are executor-level "
            f"options — configure them on the {target} when using "
            f"{'server=' if server is not None else 'router='}")
    handles = []
    for job in jobs:
        files = by_psr.get(job.pulsar, [])
        if not files:
            continue
        kw = {**stream_kwargs, **job.kwargs}
        kw.pop("telemetry", None)
        tim_out = tim_name(job.pulsar) if outdir else None
        if router is not None:
            h = router.submit(files, job.modelfile, tim_out=tim_out,
                              name=job.pulsar, **kw)
        else:
            while True:
                try:
                    h = server.submit(files, job.modelfile,
                                      tim_out=tim_out, name=job.pulsar,
                                      **kw)
                    break
                except ServeRejected as e:
                    if not e.retryable:
                        raise
                    time.sleep(0.05)  # honour the backpressure
        handles.append((job, time.time(), h))
    for job, t_job, h in handles:
        res = per_pulsar[job.pulsar] = h.result()
        TOA_list.extend(res.TOA_list)
        if tracer.enabled:
            tracer.emit("pulsar_done", pulsar=job.pulsar,
                        n_toas=len(res.TOA_list),
                        n_archives=len(res.order), nfit=0,
                        wall_s=round(time.time() - t_job, 6))


def stream_ipta_campaign(jobs, outdir=None, shard=True, nsub_batch=256,
                         quiet=False, resume=False, telemetry=None,
                         server=None, router=None, timing_pars=None,
                         timing_kwargs=None, device=None,
                         **stream_kwargs):
    """Measure wideband TOAs for a multi-pulsar campaign.

    jobs: sequence of IPTAJob (or (pulsar, datafiles, modelfile)
    tuples).  outdir: directory for per-pulsar .tim outputs (created;
    None = no .tim files).  shard=True deals the flattened (pulsar,
    archive) grid over the ranks of the process group
    (parallel.shard_files; a no-op at one process).  stream_kwargs: campaign-wide defaults
    forwarded to every stream_wideband_TOAs call (per-job kwargs
    override them).  device: the torch device of every per-pulsar
    stream call and of the timing stage (default cuda; per-job or
    stream_kwargs ``stream_devices`` still win for the stream calls).

    resume=True scans every existing checkpoint shard of a pulsar
    (``<pulsar>*.tim`` in outdir) for per-archive completion sentinels,
    drops partial tails, and measures only archives not yet recorded
    complete, so the union of the .tim files equals an uninterrupted
    run's lines.  Requires outdir.

    telemetry: a trace path or telemetry.Tracer: ONE tracer is threaded
    through every per-pulsar stream call and the timing stage, so the
    whole campaign (campaign start/end, the resume rollup, per-pulsar
    rollups, every per-bucket dispatch/drain record and the timing
    solves) lands in one trace; None follows config.telemetry_path.
    Read it with ``python -m pulseportraiture_tpu_torch.cli.pptrace``.

    timing_pars: {pulsar: parfile path or mapping}: after TOA
    collection, each listed pulsar's measured TOAs feed
    timing.fleet.fleet_gls_fit on the same tracer; timing_kwargs
    forwards its options (fit_f1=, gls_device=, batched=, ...).  The
    result's ``timing`` field carries the fleet_gls_fit DataBunch (None
    without timing_pars).  Refused with resume=True (a resumed run's
    TOAs cover only this run's archives) and under multi-process
    sharding.

    server: a started serve.ToaServer: the campaign becomes its thin
    client.  Each pulsar's shard is submitted as one request against
    the shared warm executor (all shards first, then the results are
    collected), and the per-request .tim files land in outdir as the
    executor-per-pulsar path writes them.  The server's nsub_batch,
    devices and telemetry govern the dispatches (their events ride the
    SERVER's trace; this call's telemetry= records the campaign
    rollup); job kwargs must be lane options (fit_scat=, DM0=, ...):
    the executor-level ones raise ValueError, as does resume=True
    (restart by submitting again; the request .tim files are the
    durable artifact).  ``device`` then applies to the timing stage
    only.

    router: a serve.ToaRouter over a fleet of warm servers: the same thin
    client as server=, but each pulsar's request is placed on the
    least-loaded host (sticky per-template affinity; the router owns the
    backpressure retries), and its .tim is written by whichever host
    served it (or by the router: its codec lane, hedges, failovers),
    byte-identical to the one-host path.  Archive paths and outdir must
    be readable on every host.  Mutually exclusive with server=; the same
    lane-option and resume rules apply.

    Returns a DataBunch with pulsars (job order), per_pulsar ({pulsar:
    stream result DataBunch}), TOA_list (all pulsars), DeltaDM_summary
    ({pulsar: (means, errs)} of the per-archive offset-DM statistics,
    gathered over processes), timing, nfit, fit_duration and wall_s.
    """
    jobs = [j if isinstance(j, IPTAJob) else IPTAJob(*j) for j in jobs]
    names = [j.pulsar for j in jobs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate pulsar names in jobs: {names}")
    if resume and not outdir:
        raise ValueError("stream_ipta_campaign: resume=True needs "
                         "outdir (the checkpoints live there)")
    if server is not None and router is not None:
        raise ValueError(
            "stream_ipta_campaign: pass server= OR router=, not both "
            "(a router already owns its fleet of serving loops)")
    if (server is not None or router is not None) and resume:
        raise ValueError(
            "stream_ipta_campaign: resume=True is not supported with "
            "server=/router= — restart by re-submitting; the "
            "per-request .tim files are the durable artifact")
    if outdir:
        os.makedirs(outdir, exist_ok=True)

    # ---- the flattened (pulsar, archive) grid ------------------------
    grid = [(j.pulsar, f) for j in jobs for f in j.datafiles]
    pid, nproc = parallel.process_index(), parallel.process_count()
    if timing_pars and shard and nproc > 1:
        raise ValueError(
            "stream_ipta_campaign: timing_pars= is not supported with "
            "multi-process sharding: each process holds only its shard "
            "of every pulsar's TOAs, and timing a subsampled campaign "
            "would misreport every solution.  Merge the checkpoint .tim "
            "shards and run pptime instead.")
    if timing_pars and resume:
        raise ValueError(
            "stream_ipta_campaign: timing_pars= is not supported with "
            "resume=True: a resumed run's TOA_list covers only the "
            "archives measured THIS run (checkpointed archives are "
            "skipped), so the timing stage would fit a subsampled "
            "campaign.  Run pptime on the completed .tim checkpoints "
            "instead.")
    if timing_pars:
        unknown = sorted(set(timing_pars) - set(names))
        if unknown:
            raise ValueError(
                f"stream_ipta_campaign: timing_pars names pulsars not "
                f"in jobs: {unknown}")
    mine = parallel.shard_files(grid) if shard else grid
    tracer, own_tracer = resolve_tracer(telemetry,
                                        run="stream_ipta_campaign")
    tracer.emit("campaign_start", n_jobs=len(jobs), pid=pid,
                nproc=nproc, resume=bool(resume),
                n_archives_shard=len(mine))
    try:
        by_psr = {}
        for psr, f in mine:
            by_psr.setdefault(psr, []).append(f)

        def _tim_name(pulsar, p=None):
            suffix = f".p{p if p is not None else pid}" \
                if (shard and nproc > 1) else ""
            return os.path.join(outdir, f"{pulsar}{suffix}.tim")

        completed = {}
        if resume:
            current_outputs = {os.path.abspath(_tim_name(j.pulsar, p))
                               for j in jobs for p in range(nproc)}
            for job in jobs:
                done = set()
                own = os.path.abspath(_tim_name(job.pulsar))
                will_stream = bool(by_psr.get(job.pulsar))
                for path in _shard_checkpoints(outdir, job.pulsar):
                    ap = os.path.abspath(path)
                    if ap == own and not will_stream:
                        # this process owns the file but streams nothing
                        # of the pulsar this run: no stream call will
                        # sanitize it, so drop its torn tail here
                        done |= sanitize_checkpoint(path)
                    elif ap in current_outputs:
                        # a live shard: its stream call sanitizes it
                        done |= checkpoint_completed(path)
                    elif pid == 0:
                        # an orphaned shard of an earlier process layout
                        done |= sanitize_checkpoint(path)
                    else:
                        done |= checkpoint_completed(path)
                completed[job.pulsar] = done
            ntot = sum(len(v) for v in completed.values())
            tracer.emit("resume_skip", n_skipped=ntot)
            log(f"IPTA resume: {ntot} archive(s) recorded complete "
                "across existing checkpoint shards will be skipped",
                quiet=quiet)

        t0 = time.time()
        per_pulsar = {}
        TOA_list = []
        nfit = 0
        fit_duration = 0.0
        thin = server is not None or router is not None
        if thin:
            _serve_campaign(server, router, jobs, by_psr, stream_kwargs,
                            outdir, _tim_name, tracer, per_pulsar,
                            TOA_list)
        for job in (jobs if not thin else ()):
            files = by_psr.get(job.pulsar, [])
            if not files:
                continue
            tim_out = _tim_name(job.pulsar) if outdir else None
            kw = {"device": device, **stream_kwargs, **job.kwargs}
            t_job = time.time()
            res = stream_wideband_TOAs(
                files, job.modelfile, nsub_batch=nsub_batch,
                tim_out=tim_out, quiet=True, resume=resume,
                skip_archives=completed.get(job.pulsar),
                telemetry=kw.pop("telemetry", tracer), **kw)
            per_pulsar[job.pulsar] = res
            TOA_list.extend(res.TOA_list)
            nfit += res.nfit
            fit_duration += res.fit_duration
            if tracer.enabled:
                tracer.emit("pulsar_done", pulsar=job.pulsar,
                            n_toas=len(res.TOA_list),
                            n_archives=len(res.order), nfit=res.nfit,
                            fit_s=round(res.fit_duration, 6),
                            peak_inflight=res.peak_inflight,
                            wall_s=round(time.time() - t_job, 6))

        # ---- per-pulsar DeltaDM summaries, gathered over processes ---
        summary = {}
        for job in jobs:
            res = per_pulsar.get(job.pulsar)
            means = np.asarray(res.DeltaDM_means if res else [], float)
            errs = np.asarray(res.DeltaDM_errs if res else [], float)
            gm = parallel.process_allgather(means)
            ge = parallel.process_allgather(errs)
            summary[job.pulsar] = (
                np.concatenate([np.atleast_1d(g) for g in gm]),
                np.concatenate([np.atleast_1d(g) for g in ge]))

        # ---- the fleet timing stage (archives -> TOAs -> solutions) --
        timing = None
        if timing_pars:
            from ..timing.fleet import (TimingJob, fleet_gls_fit,
                                        toas_from_measurements)

            tjobs = []
            for job in jobs:
                par = timing_pars.get(job.pulsar)
                res = per_pulsar.get(job.pulsar)
                if par is None or res is None:
                    continue
                tjobs.append(TimingJob(
                    job.pulsar, toas_from_measurements(res.TOA_list), par))
            if tjobs:
                timing = fleet_gls_fit(
                    tjobs, telemetry=tracer, quiet=quiet,
                    **{"device": device, **(timing_kwargs or {})})

        wall = time.time() - t0
        n = len(TOA_list)
        log(f"IPTA campaign: {n} TOAs across {len(per_pulsar)}/"
            f"{len(jobs)} pulsars on process {pid}/{nproc} in "
            f"{wall:.2f} s ({nfit} dispatches, "
            f"{n / max(wall, 1e-9):.1f} TOAs/s end to end)",
            quiet=quiet, tracer=tracer)
        tracer.emit("campaign_end", n_toas=n, nfit=nfit,
                    n_pulsars=len(per_pulsar), wall_s=round(wall, 6))
    finally:
        # a failed resume scan or pulsar still leaves a closed,
        # counter-bearing trace
        if own_tracer:
            tracer.close()
    return DataBunch(pulsars=names, per_pulsar=per_pulsar,
                     TOA_list=TOA_list, DeltaDM_summary=summary,
                     timing=timing, nfit=nfit, fit_duration=fit_duration,
                     wall_s=wall)

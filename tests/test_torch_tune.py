"""The PyTorch port's autotune subsystem (pulseportraiture_tpu_torch/tune/)
against the JAX package's, on the CPU.

- the backend fingerprint and the capability record (cached, upgraded by
  a probe, the stat wire's keys), and the ONE tri-state resolver;
- the tuning store: roundtrip, the loud refusals (corrupt, stale,
  mis-versioned), and DBs read across the two packages under one
  fingerprint (a DB of the JAX package's own fingerprint is refused);
- the knob tiers (both the JAX package's verbatim);
- sweep / ensure_tuned parity: the same deterministic run/time stubs
  give equal SweepResults and equal tune_sweep / tune_apply fields;
- ``pptoas --stream --autotune`` in both packages on the
  tests/test_torch_toas.py corpus with the same deterministic clock: the
  same winners and DB entries (fingerprint apart), .tim files in parity
  (tests/test_torch_toas._assert_tim_parity) and byte-identical to the
  untuned run, a warm second run with db_hit true and no tune_sweep;
- the PPT_TUNE_DB / PPT_AUTOTUNE / PPT_TUNE_NUMERICS hooks.

Every comparison here is exact (stubbed clocks, JSON values) unless a
line says otherwise.
"""

import json
import warnings

import pytest
import torch

from test_torch_helpers import trace_events
from test_torch_toas import _assert_tim_parity

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import telemetry as JT
from pulseportraiture_tpu import tune as JTU
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import device as TD
from pulseportraiture_tpu_torch import telemetry as TT
from pulseportraiture_tpu_torch import tune as TTU
from pulseportraiture_tpu_torch.tune import autotune as tauto
from pulseportraiture_tpu_torch.tune import capability as tcap

FP = f"cpu:cpu:torch-{torch.__version__}"


# ---------------------------------------------------------------------------
# capability record


def test_backend_fingerprint():
    """type:name:torch-version, the string the server's stat wire
    carries; no card and no device given is an error, not the CPU."""
    assert TTU.backend_fingerprint("cpu") == FP
    assert tcap.capability_summary("cpu")["fingerprint"] == FP


def test_backend_fingerprint_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTU.backend_fingerprint()


def test_capability_record_cached_and_upgraded(monkeypatch):
    """probe=False serves the static record; probe=True upgrades it in
    the cache; reading kernels_loaded never builds the kernels; the wire
    summary is JSON-safe with the JAX summary's keys (kernels_loaded for
    pallas_available) and the port's earlier sm / torch / cuda."""
    from pulseportraiture_tpu_torch.ops import fused

    def no_build(*a, **k):
        raise AssertionError("the capability record built the kernels")

    monkeypatch.setattr(fused, "build_kernels", no_build)
    monkeypatch.setattr(tcap, "_cached", {})
    rec0 = tcap.capability_record(probe=False, device="cpu")
    assert rec0.dispatch_floor_s is None and rec0.kernels_loaded is False
    assert (rec0.platform, rec0.device_kind, rec0.n_devices, rec0.sm) == \
        ("cpu", "cpu", 1, None)
    rec1 = tcap.capability_record(device="cpu")
    assert rec1.fingerprint == rec0.fingerprint == FP
    assert rec1.dispatch_floor_s >= 0
    assert rec1.matmul_gflops > 0 and rec1.dft_gflops > 0
    assert tcap.capability_record(device="cpu") is rec1
    wire = tcap.capability_summary("cpu")
    json.dumps(wire)
    jkeys = set(JTU.capability_summary()) - {"pallas_available"}
    assert set(wire) == jkeys | {"kernels_loaded", "sm", "torch", "cuda"}
    assert wire["torch"] == torch.__version__
    assert wire["cuda"] == torch.version.cuda


def test_resolve_auto_is_the_device_resolver():
    assert TTU.resolve_auto is TD.resolve_auto
    assert TTU.KNOB_POLARITY is TD.KNOB_POLARITY
    assert TTU.resolve_auto("fit_fused", "auto", "cpu") is False
    assert TTU.resolve_auto("dft_fold", " AUTO ", "cpu") is True


# ---------------------------------------------------------------------------
# the tuning store


def test_store_roundtrip(tmp_path):
    db = str(tmp_path / "db.json")
    TTU.TuningStore(db, device="cpu").put(
        "16x128", {"fused_block": 16}, default_s=1.0, tuned_s=0.8,
        n_swept=7, identity_preserving=True)
    fresh = TTU.TuningStore(db, device="cpu")
    ent = fresh.get("16x128")
    assert ent["knobs"] == {"fused_block": 16}
    assert ent["tuned_s"] == 0.8 and ent["identity_preserving"] is True
    assert fresh.shape_classes() == ["16x128"]
    assert fresh.get("999x999") is None
    raw = json.load(open(db))
    assert raw["fingerprint"] == FP and raw["version"] == 1


@pytest.mark.parametrize("case", ["corrupt", "stale", "version"])
def test_store_refusals(tmp_path, case):
    """A corrupt, foreign-fingerprint or mis-versioned DB warns and
    reads empty (never raises); the next put rewrites it clean under the
    live fingerprint.  The JAX package's messages."""
    db = str(tmp_path / "db.json")
    if case == "corrupt":
        open(db, "w").write("{not json!!")
        match = "corrupt"
    elif case == "stale":
        json.dump({"version": 1, "fingerprint": "tpu:TPU v4:jax-9.9",
                   "entries": {"16x128": {"knobs": {"fused_block": 8}}}},
                  open(db, "w"))
        match = "measured on backend"
    else:
        json.dump({"version": 99, "fingerprint": FP, "entries": {}},
                  open(db, "w"))
        match = "version"
    msgs = []
    for pkg in (TTU, JTU):
        with pytest.warns(UserWarning, match=match) as rec:
            assert pkg.TuningStore(db, fingerprint=FP).get("16x128") is None
        msgs.append(str(rec[0].message))
    assert msgs[0] == msgs[1]
    with pytest.warns(UserWarning, match=match):
        TTU.TuningStore(db, device="cpu").put("16x128", {"fused_block": 16})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TTU.TuningStore(db, device="cpu").get("16x128")["knobs"] \
            == {"fused_block": 16}


def test_store_across_packages(tmp_path):
    """One fingerprint, two writers: each package reads the other's DB
    entry for entry; a DB the JAX package wrote under its own (jax-)
    fingerprint is refused by the port."""
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    TTU.TuningStore(a, device="cpu").put("32x256", {"bucket_pad": True},
                                         default_s=2.0, tuned_s=1.5)
    JTU.TuningStore(b, fingerprint=FP).put("32x256", {"bucket_pad": True},
                                           default_s=2.0, tuned_s=1.5)
    assert open(a).read() == open(b).read()
    assert JTU.TuningStore(a, fingerprint=FP).get("32x256") == \
        TTU.TuningStore(b, device="cpu").get("32x256")
    j = str(tmp_path / "jax.json")
    JTU.TuningStore(j).put("32x256", {"bucket_pad": True})
    assert json.load(open(j))["fingerprint"].endswith(
        f"jax-{__import__('jax').__version__}")
    with pytest.warns(UserWarning, match="jax-"):
        assert TTU.TuningStore(j, device="cpu").shape_classes() == []


# ---------------------------------------------------------------------------
# the knob tiers and the sweep harness


def test_tiers():
    """Both tiers are the JAX package's verbatim (the DB keys agree);
    dft_precision is back in the numerics tier, as CUDA runs its
    'default' arm (TF32 matmul DFTs)."""
    assert TTU.IDENTITY_TIER == JTU.IDENTITY_TIER
    assert TTU.NUMERICS_TIER == JTU.NUMERICS_TIER
    assert "dft_precision" in {k.name for k in TTU.NUMERICS_TIER}
    assert TTU.shape_class_for(16.0, 128.0) == "16x128"


def _stubs(cfg, tuned_config, byte_changers=(), times=None, combo=None):
    """run_fn / time_fn reading ONE package's live config: bytes change
    when a knob of ``byte_changers`` leaves its default; the time is
    ``times[(knob, value)]`` for the first match (1.0 otherwise), or
    ``combo`` when every knob of it matches."""
    times = times or {}
    defaults = {k: getattr(cfg, k) for k in byte_changers}

    def run_fn(overrides):
        with tuned_config(overrides):
            moved = tuple(k for k in byte_changers
                          if getattr(cfg, k) != defaults[k])
        return b"tim" + repr(moved).encode()

    def time_fn(overrides):
        with tuned_config(overrides):
            if combo and all(getattr(cfg, k) == v
                             for (k, v) in combo[0].items()):
                return combo[1]
            for (k, v), t in times.items():
                if getattr(cfg, k) == v:
                    return t
        return 1.0

    return run_fn, time_fn


SWEEPS = {
    # a faster, byte-identical value wins
    "winner": dict(times={("stream_pipeline_depth", 1): 0.5}),
    # the fastest candidate changes the bytes: refused before the clock
    "identity_gate": dict(byte_changers=("fused_block",),
                          times={("fused_block", 16): 0.01,
                                 ("lm_compact_every", 8): 0.7}),
    # each wins alone, together they regress: the defaults ship
    "combined_regression": dict(
        times={("stream_pipeline_depth", 1): 0.5,
               ("lm_compact_every", 8): 0.5},
        combo=({"stream_pipeline_depth": 1, "lm_compact_every": 8}, 2.0)),
}


def _sweep_events(path):
    """The tune_* events of a trace, without the clock and with each DB
    path's directory dropped."""
    import os

    return [{k: (os.path.basename(v) if k == "db_path" and v else v)
             for k, v in e.items() if k != "t"}
            for e in trace_events(path) if e["type"].startswith("tune_")]


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_sweep_parity(case, tmp_path):
    """The port's sweep and the JAX sweep over the identity tier with
    the same stubs: equal SweepResults, equal tune_sweep events; the
    winners never applied by sweep itself."""
    out = {}
    for name, pkg, cfg, T in (("jax", JTU, jcfg, JT),
                              ("torch", TTU, tcfg, TT)):
        run_fn, time_fn = _stubs(cfg, pkg.tuned_config, **SWEEPS[case])
        path = str(tmp_path / f"{name}.jsonl")
        with T.Tracer(path, run="tune") as tr:
            res = pkg.sweep(run_fn, time_fn=time_fn, tracer=tr,
                            shape_class="16x128")
        out[name] = (res, _sweep_events(path))
        assert cfg.stream_pipeline_depth == 2
    (rj, ej), (rt, et) = out["jax"], out["torch"]
    assert tuple(rt) == tuple(rj)
    assert et == ej and len(et) == len(TTU.IDENTITY_TIER)
    if case == "winner":
        assert rt.knobs == {"stream_pipeline_depth": 1}
        assert rt.tuned_s == 0.5 < rt.default_s == 1.0
    elif case == "identity_gate":
        assert rt.knobs == {"lm_compact_every": 8} and rt.n_rejected == 3
    else:
        assert rt.knobs == {} and rt.tuned_s == rt.default_s == 1.0


def test_numerics_tier_opt_in():
    """The default sweep never touches the numerics tier; numerics=True
    sweeps cross_spectrum_dtype and dft_precision, as the JAX package
    does."""
    seen = []

    def run_fn(overrides):
        seen.append(dict(overrides))
        return b"tim"

    TTU.sweep(run_fn, time_fn=lambda ov: 1.0)
    assert not {"cross_spectrum_dtype", "dft_precision"} & \
        {k for ov in seen for k in ov}
    seen.clear()
    # the numerics tier is exempt from the byte gate: it is only timed
    TTU.sweep(run_fn, time_fn=lambda ov: seen.append(dict(ov)) or 1.0,
              numerics=True)
    swept = {k for ov in seen for k in ov}
    assert "cross_spectrum_dtype" in swept and "dft_precision" in swept


def test_ensure_tuned_parity_and_warm_db(tmp_path, monkeypatch):
    """ensure_tuned in both packages on one DB each: the first call
    sweeps and persists (equal tune_sweep / tune_apply fields, the
    backend fields of tune_probe apart), the second applies the stored
    winners without calling the workload (db_hit true, no tune_sweep);
    apply_from_db replays them."""
    for cfg in (jcfg, tcfg):
        monkeypatch.setattr(cfg, "stream_pipeline_depth",
                            cfg.stream_pipeline_depth)
    events = {}
    for name, pkg, cfg, T, kw in (
            ("jax", JTU, jcfg, JT, {}),
            ("torch", TTU, tcfg, TT, {"device": "cpu"})):
        (tmp_path / name).mkdir()
        db = str(tmp_path / name / "tune.json")
        run, time_fn = _stubs(cfg, pkg.tuned_config,
                              times={("stream_pipeline_depth", 1): 0.5})
        calls = []

        def run_fn(ov, run=run, calls=calls):
            calls.append(ov)
            return run(ov)

        evs = []
        for i in (1, 2):
            path = str(tmp_path / f"{name}{i}.jsonl")
            with T.Tracer(path, run="tune") as tr:
                w = pkg.ensure_tuned(run_fn, "16x128", db_path=db,
                                     time_fn=time_fn, tracer=tr,
                                     apply=False, **kw)
            assert w == {"stream_pipeline_depth": 1}
            evs.append(_sweep_events(path))
            if i == 1:
                assert calls
                calls.clear()
        assert not calls
        assert cfg.stream_pipeline_depth == 2
        assert pkg.apply_from_db(db_path=db, **kw) == w
        assert cfg.stream_pipeline_depth == 1
        entry = json.load(open(db))["entries"]
        events[name] = (evs, entry)
    (ej, dj), (et, dt) = events["jax"], events["torch"]
    assert dt == dj
    probe = {"backend", "device_kind", "fingerprint", "dispatch_floor_s",
             "matmul_gflops", "dft_gflops"}
    for run_j, run_t in zip(ej, et):
        assert [{k: v for k, v in e.items() if k not in probe}
                for e in run_t] == \
            [{k: v for k, v in e.items() if k not in probe} for e in run_j]
    first, second = et
    assert [e["type"] for e in second] == ["tune_probe", "tune_apply"]
    assert second[1]["db_hit"] is True and first[-1]["db_hit"] is False
    assert second[0]["fingerprint"] == FP
    assert sum(e["type"] == "tune_sweep" for e in first) == \
        len(TTU.IDENTITY_TIER)


# ---------------------------------------------------------------------------
# pptoas --autotune, both packages


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_torch_toas.py's corpus: 2 archives of 3 subints x 32
    channels x 256 bins and the .gmodel."""
    from test_torch_toas import DDMS, PAR

    from pulseportraiture_tpu.io import write_gmodel
    from pulseportraiture_tpu.synth import (default_test_model,
                                            make_fake_pulsar)
    from pulseportraiture_tpu.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_tune")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i, dDM in enumerate(DDMS):
        path = str(root / f"fake-{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=3, nchan=32,
                         nbin=256, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.0, dDM=dDM,
                         start_MJD=MJD(55100 + 10 * i, 0.1),
                         noise_stds=1.0, dedispersed=False, quiet=True,
                         rng=300 + i)
        files.append(path)
    meta = root / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    return str(meta), gmodel


def _clock(cfg):
    """The deterministic clock both packages' sweeps read: pipeline
    depth 1 runs in half the time."""
    def make(run_fn, nrun):
        def time_fn(overrides):
            depth = overrides.get("stream_pipeline_depth",
                                  cfg.stream_pipeline_depth)
            return 0.5 if depth == 1 else 1.0
        return time_fn
    return make


def test_pptoas_autotune_parity(corpus, tmp_path, monkeypatch):
    """pptoas --stream --autotune --tune-db in both packages (JAX on one
    device) with each package's _default_time_fn on the same clock: the
    same winners and DB entries (the fingerprint apart), the tuned .tim
    byte-identical to the untuned run of the same package and in .tim
    parity across the packages; the winner reaches the campaign (its
    run_end records pipeline depth 1); a second run hits the DB with no
    tune_sweep and the same .tim."""
    from pulseportraiture_tpu.cli.pptoas import main as jmain
    from pulseportraiture_tpu.tune import autotune as jauto
    from pulseportraiture_tpu_torch.cli.pptoas import main as tmain

    meta, gmodel = corpus
    for cfg in (jcfg, tcfg):
        for k in ("use_fast_fit", "stream_pipeline_depth", "tune_db",
                  "autotune", "tune_numerics"):
            monkeypatch.setattr(cfg, k, getattr(cfg, k))
        cfg.use_fast_fit = True
    monkeypatch.setattr(jcfg, "fit_pallas", False)
    monkeypatch.setattr(jcfg, "stream_devices", 1)
    monkeypatch.setattr(jauto, "_default_time_fn", _clock(jcfg))
    monkeypatch.setattr(tauto, "_default_time_fn", _clock(tcfg))
    out = {}
    for name, main, cfg, extra in (("jax", jmain, jcfg, []),
                                   ("torch", tmain, tcfg,
                                    ["--device", "cpu"])):
        base = ["-d", meta, "-m", gmodel, "--stream", "--quiet"] + extra
        plain = str(tmp_path / f"{name}_plain.tim")
        assert main(base + ["-o", plain]) == 0
        db = str(tmp_path / f"{name}.json")
        runs = []
        for i in (1, 2):
            tim = str(tmp_path / f"{name}{i}.tim")
            trace = str(tmp_path / f"{name}{i}.jsonl")
            cfg.stream_pipeline_depth = 2
            assert main(base + ["--autotune", "--tune-db", db, "-o", tim,
                                "--telemetry", trace]) == 0
            assert cfg.stream_pipeline_depth == 1
            runs.append((open(tim, "rb").read(), trace_events(trace)))
        plain_bytes = open(plain, "rb").read()
        assert runs[0][0] == runs[1][0] == plain_bytes
        out[name] = (json.load(open(db)), runs, plain)
    (dj, rj, pj), (dt, rt, pt) = out["jax"], out["torch"]
    assert dt["fingerprint"] == FP and dj["fingerprint"] != FP
    assert dt["entries"] == dj["entries"]
    assert dt["entries"]["32x256"]["knobs"] == {"stream_pipeline_depth": 1}
    _assert_tim_parity(pj, pt)
    for name, (_, runs, _) in out.items():
        (_, ev1), (_, ev2) = runs
        kinds = [[e["type"] for e in ev if e["type"].startswith("tune_")]
                 for ev in (ev1, ev2)]
        assert kinds[1] == ["tune_probe", "tune_apply"], name
        assert kinds[0].count("tune_sweep") == len(TTU.IDENTITY_TIER)
        hits = [[e["db_hit"] for e in ev if e["type"] == "tune_apply"]
                for ev in (ev1, ev2)]
        assert hits == [[False], [True]], name
        for ev in (ev1, ev2):
            ends = [e for e in ev if e["type"] == "run_end"]
            assert ends and all(e["pipeline_depth"] == 1 for e in ends)
    sweeps = [[{k: e[k] for k in ("knob", "default", "winner",
                                  "n_rejected", "default_s", "best_s")}
               for e in runs[0][1] if e["type"] == "tune_sweep"]
              for _, runs, _ in (out["jax"], out["torch"])]
    assert sweeps[1] == sweeps[0]


# ---------------------------------------------------------------------------
# environment hooks


def test_tune_env_hooks(monkeypatch):
    """The JAX package's values and ValueErrors, applied in process."""
    old = (tcfg.tune_db, tcfg.autotune, tcfg.tune_numerics)
    try:
        for name in ("PPT_TUNE_DB", "PPT_AUTOTUNE", "PPT_TUNE_NUMERICS"):
            assert name in tcfg.HOOKED_PPT_ENV
            assert name not in tcfg.UNPORTED_PPT_ENV
        monkeypatch.setenv("PPT_TUNE_DB", "/tmp/db.json")
        monkeypatch.setenv("PPT_AUTOTUNE", "on")
        monkeypatch.setenv("PPT_TUNE_NUMERICS", "off")
        changed = tcfg.env_overrides()
        assert {"tune_db", "autotune", "tune_numerics"} <= set(changed)
        assert (tcfg.tune_db, tcfg.autotune, tcfg.tune_numerics) == \
            ("/tmp/db.json", True, False)
        monkeypatch.setenv("PPT_TUNE_DB", "off")
        tcfg.env_overrides()
        assert tcfg.tune_db is None
        for name, bad in (("PPT_AUTOTUNE", "maybe"),
                          ("PPT_TUNE_NUMERICS", "2")):
            monkeypatch.setenv(name, bad)
            errs = []
            for cfg in (jcfg, tcfg):
                with pytest.raises(ValueError, match=name) as ei:
                    cfg.env_overrides()
                errs.append(str(ei.value))
            assert errs[0] == errs[1]
            monkeypatch.setenv(name, "off")
    finally:
        for name in ("PPT_TUNE_DB", "PPT_AUTOTUNE", "PPT_TUNE_NUMERICS"):
            monkeypatch.delenv(name, raising=False)
        (tcfg.tune_db, tcfg.autotune, tcfg.tune_numerics) = old
        jcfg.autotune = jcfg.tune_numerics = False
        jcfg.tune_db = None

"""The PyTorch port's channel zapping and post-fit quality cut on the CPU,
against the JAX package: quality/excision, quality/postfit,
synth/rfi.inject_rfi, pipeline/zap, pipeline/portrait.normalize_portrait,
GetTOAs.get_channels_to_zap, cli/ppzap, the stream drivers' zap_inline /
zap_channels / postfit_cut, and the PPT_* environment hooks.

The corpus is tests/test_quality.py's: 3 archives of 2 subints x 32
channels x 128 bins, two of them with tones (white 8x, structured 60x)
and one with a burst (subint 1, 20x), at the contamination fractions
the 3-sigma iterative cut peels one strength per round.  Gates:
- masked medians equal np.median and the JAX median bit for bit;
- zap masks, iteration counts and flagged lists equal (float64; float32
  for the random rows), post-fit bad masks equal with NaN entries never
  flagged;
- inject_rfi writes the JAX function's archive (decoded amplitudes
  within 1e-12 relative) and ground truth;
- stream TOAs through test_torch_toas._assert_tim_parity (TOA and DM
  within 0.05 sigma, flags to the last printed digit);
- ppzap's stdout lines and -o files equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_helpers import PAR, event_counts, trace_events
from test_torch_stream import _tim_lines
from test_torch_toas import _assert_tim_parity, _parse_tim

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.io import write_gmodel
from pulseportraiture_tpu.io.psrfits import load_data as jload
from pulseportraiture_tpu.pipeline import stream as JS
from pulseportraiture_tpu.quality import excision as JE
from pulseportraiture_tpu.quality import postfit as JP
from pulseportraiture_tpu.synth import default_test_model, make_fake_pulsar
from pulseportraiture_tpu.synth.rfi import inject_rfi as jinject
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.io.psrfits import load_data as tload
from pulseportraiture_tpu_torch.pipeline import stream as TS
from pulseportraiture_tpu_torch.quality import excision as TE
from pulseportraiture_tpu_torch.quality import postfit as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX corpus spec (tests/test_quality.py rfi_corpus)
SPECS = [dict(tone_channels=[3, 11], tone_white=8.0, tone_structured=60.0,
              bursts=[(1, [20, 21], 20.0)]),
         dict(tone_channels=[7, 19], tone_white=8.0, tone_structured=60.0),
         None]


def _make(path, i, nbin=128):
    make_fake_pulsar(default_test_model(1500.0), PAR, outfile=path, nsub=2,
                     nchan=32, nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                     phase=0.01 * i, dDM=1e-4 * (i - 1), noise_stds=0.05,
                     dedispersed=False, quiet=True, rng=300 + i)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(archives, .gmodel, JAX inject_rfi truths): the JAX corpus."""
    root = tmp_path_factory.mktemp("torch_quality")
    gmodel = str(root / "model.gmodel")
    write_gmodel(default_test_model(1500.0), gmodel, quiet=True)
    files, truths = [], []
    for i, spec in enumerate(SPECS):
        path = str(root / f"ep{i}.fits")
        _make(path, i)
        truths.append(jinject(path, rng=40 + i, **spec) if spec else None)
        files.append(path)
    return files, gmodel, truths


@pytest.fixture(scope="module")
def corpus_2bit(tmp_path_factory, corpus):
    """The first two corpus specs at 256 bins, re-quantized to NBIT=2
    with rectangular dither after the injection (inject_rfi writes 16
    bits): the decode-fused lane's input."""
    from pulseportraiture_tpu_torch.io.psrfits import (read_archive,
                                                       write_archive_file)

    root = tmp_path_factory.mktemp("torch_quality_2bit")
    files = []
    for i, spec in enumerate(SPECS[:2]):
        path = str(root / f"ep{i}-2bit.fits")
        _make(path, i, nbin=256)
        jinject(path, rng=40 + i, **spec)
        write_archive_file(path, read_archive(path), nbit=2,
                           dither=np.random.default_rng(70 + i))
        files.append(path)
    return files, corpus[1]


@pytest.fixture
def fast_fused():
    """The stream's fast fit, the fused lane and a 128-harmonic window
    in both packages (test_torch_stream.stream_config); restored
    afterwards."""
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 128
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def _zap_map(files, load, **kw):
    """Offline model-less lists of every archive (JAX host lane)."""
    from pulseportraiture_tpu.pipeline.zap import get_zap_channels

    return {f: get_zap_channels(load(f, dedisperse=False, dededisperse=True,
                                     pscrunch=True, quiet=True, **kw),
                                device=False)
            for f in files}


# ---------------------------------------------------------------------
# quality/excision and quality/postfit


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_masked_median_bit_exact(dtype):
    """Random masks with empty rows, odd and even counts, ties and
    negatives: np.median and the JAX median, bit for bit."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    x = rng.normal(0.2, 0.5, (40, 31)).astype(dtype)
    x[5, :12] = x[5, 0]
    x[7] = np.round(x[7], 1)
    keep = rng.random((40, 31)) > 0.3
    keep[3] = False
    keep[4, :6], keep[4, 6:] = True, False
    keep[8, :7], keep[8, 7:] = True, False
    got = TE.masked_median_lastaxis(torch.as_tensor(x),
                                    torch.as_tensor(keep)).numpy()
    ref = np.asarray(JE.masked_median_lastaxis(jnp.asarray(x),
                                               jnp.asarray(keep)))
    assert got.dtype == dtype and np.isfinite(got[3])
    for i in range(len(x)):
        v = x[i, keep[i]]
        if v.size:
            assert got[i] == np.median(v) == ref[i], i


def _reference_zap(noise_row, ichans, nstd):
    """A literal transcription of the reference loop (ppzap.py:24-54)."""
    ichans = list(ichans)
    zap = []
    while len(ichans):
        ns = noise_row[ichans]
        med, std = np.median(ns), np.std(ns)
        bad = list(np.where(ns > med + nstd * std)[0])
        if not bad:
            break
        flagged = [ichans[i] for i in bad]
        zap.extend(flagged)
        for c in flagged:
            ichans.remove(c)
    return sorted(zap)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_zap_keep_lanes_agree(dtype):
    """The torch cut, its numpy oracle, both JAX lanes and the reference
    loop: identical masks and iteration counts, a multi-pass cascade
    included; the torch lane's syncs are counted."""
    rng = np.random.default_rng(7)
    noise = rng.normal(1.0, 0.04, (8, 33)).astype(dtype)
    noise[0, [3, 17]] = [6.0, 3.5]
    noise[2, 5] = 9.0
    noise[4] = 1.0  # constant row: std 0, nothing flagged
    noise[5, [1, 2, 3]] = [2.0, 4.0, 8.0]
    keep = rng.random((8, 33)) > 0.15
    keep[6] = False
    TE.reset_zap_stats()
    kt, it = TE.zap_keep_device(noise, keep, 3.0, device="cpu")
    st = TE.zap_stats()
    assert st["calls"] == 1 and st["syncs"] >= 1
    assert st["passes"] == st["syncs"] * TE.ZAP_CHECK_EVERY
    for k, i in (TE.zap_keep_np(noise, keep, 3.0),
                 JE.zap_keep_device(noise, keep, 3.0),
                 JE.zap_keep_np(noise, keep, 3.0)):
        assert np.array_equal(kt, k) and np.array_equal(it, i)
    assert it.max() >= 2  # the cascade iterated
    lists = TE.zap_lists_from_masks(keep, kt)
    assert lists == JE.zap_lists_from_masks(keep, kt)
    for r in range(8):
        assert lists[r] == _reference_zap(noise[r], np.flatnonzero(keep[r]),
                                          3.0)


def test_zap_keep_corpus(corpus):
    """The corpus's per-channel noise (float64 load): torch, numpy and
    JAX lanes flag the same channels with the same counts."""
    files, _, truths = corpus
    for f in files:
        d = tload(f, dedisperse=False, dededisperse=True, pscrunch=True,
                  quiet=True)
        noise = d.noise_stds[:, 0]
        keep = d.weights > 0
        kt, it = TE.zap_keep_device(noise, keep, 3.0, device="cpu")
        kj, ij = JE.zap_keep_device(noise, keep, 3.0)
        assert np.array_equal(kt, kj) and np.array_equal(it, ij)
        assert np.array_equal(kt, TE.zap_keep_np(noise, keep, 3.0)[0])


@pytest.mark.parametrize("iterate", [True, False])
def test_postfit_cut(iterate):
    """Torch twin and numpy oracle against both JAX lanes, NaN rchi2 and
    S/N entries and a NaN total S/N included: identical bad masks, and a
    NaN entry is never flagged."""
    rng = np.random.default_rng(8)
    rchi2 = rng.uniform(0.6, 1.25, (7, 24))
    rchi2[1, [2, 3]] = [40.0, 6.0]
    rchi2[3, 9] = 2.0
    rchi2[6, [1, 5]] = [np.nan, 30.0]
    snr = rng.uniform(5.0, 60.0, (7, 24))
    snr[4, 7] = 0.05
    snr[6, 8] = np.nan
    snr_tot = np.array([50.0, 45.0, np.nan, 55.0, 30.0, 20.0, 40.0])
    okc = rng.random((7, 24)) > 0.15
    okc[5] = False
    okc[6, [1, 5, 8]] = True
    got = TP.postfit_cut_device(rchi2, snr, snr_tot, okc, iterate=iterate,
                                device="cpu")
    assert got.any()
    assert not got[6, 1] and not got[6, 8]
    for ref in (TP.postfit_cut_np(rchi2, snr, snr_tot, okc,
                                  iterate=iterate),
                JP.postfit_cut_device(rchi2, snr, snr_tot, okc,
                                      iterate=iterate),
                JP.postfit_cut_np(rchi2, snr, snr_tot, okc,
                                  iterate=iterate)):
        assert np.array_equal(got, ref)


# ---------------------------------------------------------------------
# synth/rfi, zap_bunch, pipeline/zap, normalize_portrait


def test_inject_rfi_matches_jax(tmp_path):
    """The same seed writes the same archive and ground truth."""
    from pulseportraiture_tpu.io.psrfits import read_archive
    from pulseportraiture_tpu_torch.synth import inject_rfi

    a, b = str(tmp_path / "a.fits"), str(tmp_path / "b.fits")
    _make(a, 0)
    _make(b, 0)
    spec = dict(SPECS[0], tone_channels=[3, 11, 30])
    tj = jinject(a, rng=41, **spec)
    tt = inject_rfi(b, rng=41, **spec)
    for k in ("zap_truth", "contaminated"):
        assert tt[k] == tj[k]
    assert tt.noise_base == tj.noise_base
    ja, ta = read_archive(a).amps, read_archive(b).amps
    assert np.max(np.abs(ta - ja)) <= 1e-12 * np.max(np.abs(ja))
    with pytest.raises(ValueError, match="outside"):
        inject_rfi(b, tone_channels=[32])


@pytest.mark.parametrize("kind", ["load_data", "raw"])
def test_zap_bunch(corpus, tmp_path, kind):
    """zap_bunch on the port's load_data bunch and on its raw stream
    bunch: the derived fields equal the JAX function's on the same
    bunch, and a load of the weight-zapped archive."""
    from pulseportraiture_tpu_torch.pipeline.zap import apply_zaps

    files, _, _ = corpus
    zaps = [[3, 11], []]

    def load(f):
        if kind == "raw":
            return TS._load_raw(f, torch.device("cpu"))
        return tload(f, dedisperse=False, dededisperse=True, pscrunch=True,
                     quiet=True)

    d = TE.zap_bunch(load(files[0]), zaps)
    e = JE.zap_bunch(load(files[0]), zaps)
    zapped = str(tmp_path / "zapped.fits")
    apply_zaps(files[0], zaps, outfile=zapped, quiet=True)
    z = load(zapped)
    for ref in (e, z):
        assert np.array_equal(d.weights, ref.weights)
        assert np.array_equal(d.ok_isubs, ref.ok_isubs)
        if kind == "load_data":
            assert all(np.array_equal(a, b)
                       for a, b in zip(d.ok_ichans, ref.ok_ichans))
            assert np.array_equal(d.masks, ref.masks)
    assert 3 not in d.get("ok_ichans", [[]])[0]
    # emptying a whole subint drops it from ok_isubs
    assert list(TE.zap_bunch(d, [list(range(32)), []]).ok_isubs) == [1]


@pytest.mark.parametrize("zap_device", [False, True])
def test_get_zap_channels(corpus, zap_device, tmp_path):
    """Port lists (host and torch lanes) equal the JAX package's and
    recover the injected white channels with at most one extra per
    subint; a tracer (ported) receives the JAX package's zap_propose."""
    from pulseportraiture_tpu.pipeline.zap import get_zap_channels as jget
    from pulseportraiture_tpu_torch.pipeline.zap import get_zap_channels

    files, _, truths = corpus
    for f, truth in zip(files, truths):
        d = tload(f, dedisperse=False, dededisperse=True, pscrunch=True,
                  quiet=True)
        got = get_zap_channels(d, zap_device=zap_device, device="cpu")
        assert got == jget(jload(f, dedisperse=False, dededisperse=True,
                                 pscrunch=True, quiet=True), device=False)
        assert len(got) == d.nsub
        for isub, flagged in enumerate(got):
            expect = truth.zap_truth[isub] if truth else []
            assert set(expect) <= set(flagged)
            assert len(flagged) <= len(expect) + 1
    from pulseportraiture_tpu import telemetry as JTel
    from pulseportraiture_tpu_torch import telemetry as TTel

    props = []
    for mod, fn, load, kw in (
            (JTel, jget, jload, {"device": False}),
            (TTel, get_zap_channels, tload, {"zap_device": zap_device,
                                             "device": "cpu"})):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        with mod.Tracer(path) as tr:
            for f in files:
                fn(load(f, dedisperse=False, dededisperse=True,
                        pscrunch=True, quiet=True), tracer=tr, **kw)
        props.append([(e["datafile"], e["n_channels"], e["n_iter"])
                      for e in trace_events(path)
                      if e["type"] == "zap_propose"])
    assert props[1] == props[0] and len(props[1]) == len(files)


def test_paz_cmds_and_apply_zaps(tmp_path):
    """print_paz_cmds' lines (every mode, write then append) and
    apply_zaps' weights equal the JAX functions'; on an archive whose
    first subint is dead the rows stay indexed by true subint."""
    from pulseportraiture_tpu.pipeline import zap as JZ
    from pulseportraiture_tpu_torch.pipeline import zap as TZ

    zaps = [[[2, 5], []], [[], [1]]]
    names = ["a.fits", "b.ar"]
    for kw in ({}, {"modify": False}, {"all_subs": True}):
        assert TZ.print_paz_cmds(names, zaps, quiet=True, **kw) == \
            JZ.print_paz_cmds(names, zaps, quiet=True, **kw)
    out_t, out_j = tmp_path / "t.sh", tmp_path / "j.sh"
    for append in (False, True):
        TZ.print_paz_cmds(names, zaps, outfile=str(out_t), quiet=True,
                          append=append)
        JZ.print_paz_cmds(names, zaps, outfile=str(out_j), quiet=True,
                          append=append)
    assert out_t.read_text() == out_j.read_text()

    path = str(tmp_path / "deadsub.fits")
    make_fake_pulsar(default_test_model(1500.0), PAR, outfile=path, nsub=2,
                     nchan=32, nbin=128, tsub=60.0,
                     noise_stds=np.where(np.arange(32) == 6, 1.2, 0.06),
                     weights=np.stack([np.zeros(32), np.ones(32)]),
                     dedispersed=False, quiet=True, rng=91)
    d = tload(path, dedisperse=False, dededisperse=True, pscrunch=True,
              quiet=True)
    lists = TZ.get_zap_channels(d, zap_device=True, device="cpu")
    assert lists == [[], [6]]
    for all_subs in (False, True):
        wt = TZ.apply_zaps(path, lists, all_subs=all_subs, quiet=True,
                           outfile=str(tmp_path / "t.fits"))
        wj = JZ.apply_zaps(path, lists, all_subs=all_subs, quiet=True,
                           outfile=str(tmp_path / "j.fits"))
        assert np.array_equal(wt, wj)
    assert 6 not in tload(str(tmp_path / "t.fits"), pscrunch=True,
                          quiet=True).ok_ichans[1]


@pytest.mark.parametrize("method", ["mean", "max", "prof", "rms", "abs"])
def test_normalize_portrait(corpus, method):
    from pulseportraiture_tpu.pipeline.portrait import \
        normalize_portrait as jnorm
    from pulseportraiture_tpu_torch.pipeline.portrait import \
        normalize_portrait

    files, _, _ = corpus
    port = tload(files[0], pscrunch=True, quiet=True).subints[0, 0].copy()
    port[4] = 0.0
    got, gv = normalize_portrait(port, method, return_norms=True,
                                 device="cpu")
    ref, rv = jnorm(port, method, return_norms=True)
    tol = 1e-10 if method == "prof" else 1e-14
    assert np.max(np.abs(gv - rv)) <= tol * np.max(np.abs(rv))
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


# ---------------------------------------------------------------------
# ppzap and GetTOAs.get_channels_to_zap


def _ppzap(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("extra", [[], ["-N", "rms", "-n", "2.5"],
                                   ["-m", "MODEL"]],
                         ids=["median", "norm_rms", "model"])
def test_ppzap_main(corpus, tmp_path, capsys, extra):
    """ppzap, model-less (-N rms included) and -m: the port's stdout
    lines and -o file equal the JAX CLI's; the -m path runs GetTOAs
    and get_channels_to_zap in both."""
    from pulseportraiture_tpu.cli.ppzap import main as jmain
    from pulseportraiture_tpu_torch.cli.ppzap import main as tmain

    files, gmodel, _ = corpus
    meta = tmp_path / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    args = ["-d", str(meta)] + [gmodel if a == "MODEL" else a
                                for a in extra]
    out = str(tmp_path / "paz.sh")
    ref = _ppzap(jmain, args + ["-o", out], capsys)
    ref_file = open(out).read()
    got = _ppzap(tmain, args + ["-o", out, "--device", "cpu",
                                "--zap-device", "on"], capsys)
    assert got == ref and len(ref) == 2
    # -N rms whitens every channel to unit noise: nothing left to flag
    assert (int(ref[0].split()[0]) > 0) == ("-N" not in args)
    assert open(out).read() == ref_file


@pytest.mark.parametrize("flag", ["--telemetry", "--hist"])
def test_ppzap_refusals(corpus, flag, tmp_path, capsys):
    """--hist writes the JAX CLI's reduced-chi^2 histogram under Agg
    (the same bin counts, to the bin; the same threshold line);
    --telemetry writes the JAX CLI's zap_propose/zap_apply events."""
    from pulseportraiture_tpu.cli.ppzap import main as jmain
    from pulseportraiture_tpu_torch.cli.ppzap import main

    files, gmodel, _ = corpus
    if flag == "--hist":
        import matplotlib
        import matplotlib.pyplot as plt

        matplotlib.use("Agg", force=True)
        bars = {}
        for name, m, extra in (("jax", jmain, []),
                               ("torch", main, ["--device", "cpu"])):
            arch = str(tmp_path / f"{name}.fits")
            with open(files[0], "rb") as fi, open(arch, "wb") as fo:
                fo.write(fi.read())
            saved = plt.Figure.savefig
            figs = []

            def spy(fig, *a, **k):
                figs.append(fig)
                return saved(fig, *a, **k)

            plt.Figure.savefig = spy
            try:
                m(["-d", arch, "-m", gmodel, "--quiet", flag] + extra)
            finally:
                plt.Figure.savefig = saved
            assert os.path.getsize(arch + ".rchi2.png") > 0
            (ax,) = figs[0].axes
            bars[name] = ([(p.get_x(), p.get_height()) for p in ax.patches],
                          ax.lines[0].get_xdata(), ax.get_xlabel())
        capsys.readouterr()
        (pj, lj, xj), (pt, lt, xt) = bars["jax"], bars["torch"]
        assert [h for _, h in pt] == [h for _, h in pj] and len(pj) == 30
        # edges from each package's red_chi2 (float64 fits): 1e-6 relative
        np.testing.assert_allclose([x for x, _ in pt], [x for x, _ in pj],
                                   rtol=1e-6)
        assert list(lt) == list(lj) and xt == xj
        return
    traces = {}
    for name, m, extra in (("jax", jmain, []),
                           ("torch", main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        arch = [str(work / os.path.basename(f)) for f in files]
        for src, dst in zip(files, arch):
            with open(src, "rb") as fi, open(dst, "wb") as fo:
                fo.write(fi.read())
        meta = work / "meta.txt"
        meta.write_text("\n".join(arch) + "\n")
        traces[name] = str(work / "t.jsonl")
        m(["-d", str(meta), "--apply", "--quiet", flag, traces[name]]
          + extra)
    capsys.readouterr()
    assert event_counts(traces["torch"]) == event_counts(traces["jax"])
    for typ in ("zap_propose", "zap_apply"):
        got = [(os.path.basename(e["datafile"]), e["n_channels"])
               for e in trace_events(traces["torch"]) if e["type"] == typ]
        ref = [(os.path.basename(e["datafile"]), e["n_channels"])
               for e in trace_events(traces["jax"]) if e["type"] == typ]
        assert got == ref and len(got) == len(files)


def test_get_channels_to_zap(corpus):
    """GetTOAs (the complex engine in float64 on both sides) then
    get_channels_to_zap: the port's lists, through the host and the
    torch lane, equal the JAX package's; the structured tones are
    flagged."""
    from pulseportraiture_tpu.pipeline import GetTOAs as JGetTOAs
    from pulseportraiture_tpu_torch.pipeline import GetTOAs

    files, gmodel, truths = corpus
    jg = JGetTOAs(files, gmodel, quiet=True)
    jg.get_TOAs(quiet=True)
    ref = jg.get_channels_to_zap(device=False)
    tg = GetTOAs(files, gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True)
    assert tg.get_channels_to_zap(zap_device=False) == ref
    assert tg.get_channels_to_zap(zap_device=True) == ref
    for ch in truths[0].contaminated[0]:
        assert ch in ref[0][0]
    # the reconstruction show_fit draws, at a fitted subint
    d = tload(files[0], dedisperse=False, dededisperse=True, pscrunch=True,
              quiet=True)
    freqs0 = np.asarray(d.freqs[0], float)
    mj = jg.model.portrait(freqs0, d.nbin, P=float(np.mean(d.Ps)))
    got = tg._fitted_model(0, 1, d, mj, freqs0)
    want = jg._fitted_model(0, 1, d, mj, freqs0)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    # show=True draws show_fit (data / model / residuals) for each subint
    # with a flagged channel, under Agg, and flags the same lists
    import matplotlib
    import matplotlib.pyplot as plt

    matplotlib.use("Agg", force=True)
    plt.close("all")
    assert tg.get_channels_to_zap(zap_device=False, show=True) == ref
    nflagged = sum(bool(c) for arch in ref for c in arch)
    assert len(plt.get_fignums()) == nflagged > 0
    fig = plt.figure(plt.get_fignums()[0])
    assert [a.get_title() for a in fig.axes if a.get_images()][1:] == \
        [gmodel, "Residuals"]
    plt.close("all")


# ---------------------------------------------------------------------
# the stream drivers


def _stream_pair(files, gmodel, root, kw, tkw=None, jkw=None):
    """The JAX and the port's stream_wideband_TOAs with the same
    options; returns (jax result, port result, jax .tim, port .tim),
    the .tims without their sentinel comments."""
    out = {}
    res = {}
    for name, mod, extra in (("jax", JS, jkw or {}),
                             ("torch", TS, dict(tkw or {}, device="cpu"))):
        tim = str(root / f"{name}.tim")
        if os.path.exists(tim):
            os.remove(tim)
        res[name] = mod.stream_wideband_TOAs(files, gmodel, nsub_batch=8,
                                             quiet=True, tim_out=tim,
                                             **kw, **extra)
        out[name] = _tim_lines(tim, root / f"{name}_lines.tim")
    return res["jax"], res["torch"], out["jax"], out["torch"]


def test_stream_zap_inline_int16(corpus, tmp_path):
    """The raw int16 lane's inline cut: .tim parity with the JAX
    stream, and the same TOAs as the port's own zap_channels= run with
    the offline lists."""
    files, gmodel, _ = corpus
    _, _, ref, got = _stream_pair(files, gmodel, tmp_path,
                                  dict(zap_inline=True))
    _assert_tim_parity(ref, got)
    zap_map = _zap_map(files, tload)
    assert sum(len(z) for zs in zap_map.values() for z in zs) > 0
    off = str(tmp_path / "offline.tim")
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=8, quiet=True,
                            tim_out=off, zap_channels=zap_map, device="cpu")
    assert open(off).read() == open(str(tmp_path / "torch.tim")).read()
    none = str(tmp_path / "none.tim")
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=8, quiet=True,
                            tim_out=none, device="cpu")
    assert open(off).read() != open(none).read()


def test_stream_zap_inline_2bit_decode_fused(corpus_2bit, fast_fused,
                                             tmp_path, monkeypatch):
    """A 2-bit bucket on the decode-fused lane: the spy on B2's plain
    version sees the inline cut's zeroed channels in its weights (its S0
    rows there are 0) and the archives' own bytes, and the .tim agrees
    with the JAX stream."""
    from pulseportraiture_tpu_torch.ops import fused as TFu

    files, gmodel = corpus_2bit
    calls = []
    orig = TFu.fused_decode_cross_spectrum_ref

    def spy(raw, scl, offs, model, w, *a, **k):
        out = orig(raw, scl, offs, model, w, *a, **k)
        calls.append((k["code"], raw.clone(), w.clone(), out[2].clone()))
        return out

    monkeypatch.setattr(TFu, "fused_decode_cross_spectrum_ref", spy)
    _, _, ref, got = _stream_pair(files, gmodel, tmp_path,
                                  dict(zap_inline=True))
    _assert_tim_parity(ref, got)
    assert len(calls) == 1
    code, raw, w, S0 = calls[0]
    # the 4 subints, padded to nsub_batch with copies of the first
    assert code == "p2" and raw.shape[0] == 8
    assert torch.equal(raw[4:], raw[:1].expand(4, *raw.shape[1:]))
    zap_map = _zap_map(files, tload)
    rows = [(f, isub) for f in files for isub in range(2)]
    zapped = [(j, c) for j, (f, isub) in enumerate(rows)
              for c in zap_map[f][isub]]
    assert zapped
    live = (w[:4] != 0).any(dim=-1)
    assert int(live.sum()) == 4 * 32 - len(zapped)
    for j, c in zapped:
        assert not live[j, c] and S0[j, c] == 0.0
    # the wire bytes B2 decodes are the archives' own
    plain = TS._load_raw(files[0], torch.device("cpu")).raw
    assert np.array_equal(raw[:2].reshape(plain.shape).numpy(), plain)


def test_stream_zap_inline_decoded_lane(corpus, tmp_path):
    """tscrunch takes the host-decoded lane, which cuts at prepare: .tim
    parity with the JAX stream and the port's zap_channels= run."""
    files, gmodel, _ = corpus
    _, _, ref, got = _stream_pair(files, gmodel, tmp_path,
                                  dict(zap_inline=True, tscrunch=True))
    _assert_tim_parity(ref, got)
    zap_map = _zap_map(files, tload, tscrunch=True)
    off = str(tmp_path / "offline.tim")
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=8, quiet=True,
                            tim_out=off, tscrunch=True, zap_channels=zap_map,
                            device="cpu")
    assert open(off).read() == open(str(tmp_path / "torch.tim")).read()


def test_stream_postfit_cut(corpus, tmp_path):
    """postfit_cut: the port's postfit_zaps equal the JAX stream's and
    its own GetTOAs + get_channels_to_zap lists; the .tim is the same
    with the cut on or off."""
    from pulseportraiture_tpu_torch.pipeline import GetTOAs

    files, gmodel, _ = corpus
    rj, rt, ref, got = _stream_pair(files, gmodel, tmp_path,
                                    dict(postfit_cut=True))
    _assert_tim_parity(ref, got)
    assert rt.postfit_zaps == rj.postfit_zaps
    assert sum(len(z) for z in rt.postfit_zaps[files[0]].values()) > 0
    assert not any(rt.postfit_zaps[files[2]].values())
    tg = GetTOAs(files, gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True)
    for f, rows in zip(files, tg.get_channels_to_zap(zap_device=False)):
        assert {i: z for i, z in enumerate(rows)} == rt.postfit_zaps[f]
    off = str(tmp_path / "off.tim")
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=8, quiet=True,
                            tim_out=off, device="cpu")
    assert open(off).read() == open(str(tmp_path / "torch.tim")).read()


def test_stream_edge_emptied_subint(corpus, tmp_path, monkeypatch):
    """A subint the inline cut empties keeps its (all-masked) TOA row in
    both packages, where the zap_channels= run drops the subint.  No
    finite noise row can be emptied by the median cut (at least half the
    channels survive), so both packages' cuts are patched to empty
    subint 0 of every bucket."""
    import pulseportraiture_tpu.quality.excision as je

    files, gmodel, _ = corpus

    def emptying(cut):
        def run(noise, keep, nstd, *a, **k):
            kb, it = cut(noise, keep, nstd, *a, **k)
            return kb.at[0].set(False) if hasattr(kb, "at") else \
                torch.cat([torch.zeros_like(kb[:1]), kb[1:]]), it
        return run

    monkeypatch.setattr(je, "zap_keep_mask", emptying(je.zap_keep_mask))
    monkeypatch.setattr(TE, "zap_keep_mask", emptying(TE.zap_keep_mask))
    JS._raw_fit_fn_cached.cache_clear()
    try:
        rj, rt, _, _ = _stream_pair(files[:1], gmodel, tmp_path,
                                    dict(zap_inline=True))
    finally:
        monkeypatch.undo()
        JS._raw_fit_fn_cached.cache_clear()
    keys = [(t.archive, t.flags["subint"]) for t in rt.TOA_list]
    assert keys == [(t.archive, t.flags["subint"]) for t in rj.TOA_list]
    assert keys == [(files[0], 0), (files[0], 1)]
    res = TS.stream_wideband_TOAs(files[:1], gmodel, nsub_batch=8,
                                  quiet=True, device="cpu",
                                  zap_channels={files[0]: [list(range(32)),
                                                           []]})
    assert [t.flags["subint"] for t in res.TOA_list] == [1]


def test_stream_edge_degenerate_group(tmp_path):
    """A raw-lane subint the inline cut leaves with 2 usable channels
    keeps its pre-zap fit-flag group (GM fitted): the same dispatches as
    the JAX stream, one fewer than the zap_channels= run, which demotes
    the subint to its own no-GM bucket.  Subint 0 has channels 0-2
    (noise 0.05, 0.05, 0.5: the cut at 1.9 sigma flags channel 2),
    subint 1 channels 3-5 (noise 0.02, 0.06, 0.10: evenly spaced, 1.22
    sigma from the median at most, so nothing is cut)."""
    gmodel = str(tmp_path / "model.gmodel")
    write_gmodel(default_test_model(1500.0), gmodel, quiet=True)
    path = str(tmp_path / "three.fits")
    w = np.zeros((2, 32))
    w[0, :3] = w[1, 3:6] = 1.0
    noise = np.full(32, 0.05)
    noise[2:6] = [0.5, 0.02, 0.06, 0.10]
    make_fake_pulsar(default_test_model(1500.0), PAR, outfile=path, nsub=2,
                     nchan=32, nbin=128, tsub=60.0, noise_stds=noise,
                     weights=w, dedispersed=False, quiet=True, rng=17)
    kw = dict(zap_inline=True, zap_nstd=1.9, fit_GM=True)
    rj, rt, _, _ = _stream_pair([path], gmodel, tmp_path, kw)
    assert rt.nfit == rj.nfit == 1
    assert len(rt.TOA_list) == len(rj.TOA_list) == 2
    d = tload(path, dedisperse=False, dededisperse=True, pscrunch=True,
              quiet=True)
    from pulseportraiture_tpu_torch.pipeline.zap import get_zap_channels

    lists = get_zap_channels(d, nstd=1.9, zap_device=True, device="cpu")
    assert lists == [[2], []]
    off = TS.stream_wideband_TOAs([path], gmodel, nsub_batch=8, quiet=True,
                                  device="cpu", fit_GM=True,
                                  zap_channels={path: lists})
    assert off.nfit == 2


@pytest.mark.parametrize("tscrunch", [False, True], ids=["raw", "decoded"])
def test_stream_narrowband_zap_inline(corpus, tmp_path, tscrunch):
    """The narrowband stream's inline cut: .tim parity with the JAX
    stream, and exactly the unzapped run's lines minus the offline
    lists' channels."""
    files, gmodel, _ = corpus
    tims = {}
    for name, mod, kw in (("jax", JS, {}), ("torch", TS, {"device": "cpu"}),
                          ("none", TS, {"device": "cpu"})):
        tim = str(tmp_path / f"{name}.tim")
        mod.stream_narrowband_TOAs(files, gmodel, nsub_batch=8, quiet=True,
                                   tim_out=tim, tscrunch=tscrunch,
                                   zap_inline=name != "none", **kw)
        tims[name] = _tim_lines(tim, tmp_path / f"{name}_lines.tim")
    _assert_tim_parity(tims["jax"], tims["torch"],
                       derived={"snr", "gof", "phs", "phs_err"})
    zap_map = _zap_map(files, tload, tscrunch=tscrunch)
    key = {(t[0], t[5]["-subint"], t[5]["-chan"])
           for t in _parse_tim(tims["torch"])}
    expect = {(t[0], t[5]["-subint"], t[5]["-chan"])
              for t in _parse_tim(tims["none"])
              if int(t[5]["-chan"]) not in zap_map[t[0]][
                  int(t[5]["-subint"])]}
    assert key == expect and len(key) < len(_parse_tim(tims["none"]))


def test_no_card(corpus, monkeypatch):
    """Without a card the new entry points' CUDA default raises instead
    of running on the CPU; 'auto' picks the host lane only for an
    explicit CPU device."""
    from pulseportraiture_tpu_torch.cli.ppzap import main
    from pulseportraiture_tpu_torch.pipeline import zap as TZ

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    files, gmodel, _ = corpus
    d = tload(files[0], pscrunch=True, quiet=True)
    noise, keep = d.noise_stds[:, 0], d.weights > 0
    for call in (lambda: TE.zap_keep_device(noise, keep, 3.0),
                 lambda: TP.postfit_cut_device(noise, noise, noise[:, 0],
                                               keep),
                 lambda: TZ.get_zap_channels(d),
                 lambda: TZ.resolve_zap_device(),
                 lambda: TS.stream_wideband_TOAs(files, gmodel,
                                                 zap_inline=True),
                 lambda: main(["-d", files[0]])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert TZ.resolve_zap_device("auto", "cpu") is False
    assert TZ.resolve_zap_device(True, "cpu") is True
    with pytest.raises(ValueError, match="nstd"):
        TZ.resolve_zap_nstd(0.0)


# ---------------------------------------------------------------------
# PPT_* environment hooks

# variable -> (good value, knob, bad value)
HOOKS = {
    "PPT_FIT_FUSED": ("off", "fit_fused", "maybe"),
    "PPT_FUSED_BLOCK": ("16", "fused_block", "0"),
    "PPT_XSPEC": ("float32", "cross_spectrum_dtype", "fp8"),
    "PPT_DFT_PRECISION": ("high", "dft_precision", "low"),
    "PPT_DFT_FOLD": ("on", "dft_fold", "2"),
    "PPT_STREAM_DEVICES": ("2", "stream_devices", "0"),
    "PPT_MAX_INFLIGHT": ("3", "stream_max_inflight", "x"),
    "PPT_PIPELINE_DEPTH": ("1", "stream_pipeline_depth", "0"),
    "PPT_BUCKET_PAD": ("auto", "bucket_pad", "yes"),
    "PPT_RAW_SUBBYTE": ("off", "raw_subbyte", "auto"),
    "PPT_ZAP_DEVICE": ("on", "zap_device", "gpu"),
    "PPT_ALIGN_DEVICE": ("off", "align_device", "gpu"),
    "PPT_ZAP_NSTD": ("4.5", "zap_nstd", "-1"),
    "PPT_GAUSS_DEVICE": ("on", "gauss_device", "gpu"),
    "PPT_LM_JACOBIAN": ("ad", "lm_jacobian", "numeric"),
    "PPT_GLS_DEVICE": ("on", "gls_device", "gpu"),
    "PPT_GLS_RESOLVE_EVERY": ("8", "gls_resolve_every", "-1"),
    "PPT_TRANSPORT_COMPRESS": ("auto", "transport_compress", "maybe"),
    # any string is a trace path: 'off' is the value that turns it off
    "PPT_TELEMETRY": ("t.jsonl", "telemetry_path", "off"),
    "PPT_QUALITY_REFIT": ("on", "quality_refit", "maybe"),
    "PPT_QUALITY_MAX_GOF": ("2.5", "quality_max_gof", "0"),
    "PPT_QUALITY_MIN_SNR": ("8", "quality_min_snr", "-1"),
    "PPT_SERVE_MAX_WAIT_MS": ("125.5", "serve_max_wait_ms", "-1"),
    "PPT_SERVE_QUEUE_DEPTH": ("9", "serve_queue_depth", "0"),
    "PPT_SERVE_TENANT_QUOTA": ("a:4,*:8", "serve_tenant_quota", "a:0"),
    "PPT_SERVE_TENANT_WEIGHT": ("a:4,b:1", "serve_tenant_weight", "3"),
    "PPT_RESULT_CACHE": ("on", "result_cache", "maybe"),
    # any string is a directory: 'off' is the value that turns it off
    "PPT_CACHE_DIR": ("cache", "cache_dir", "off"),
    "PPT_CACHE_MAX_MB": ("64", "cache_max_mb", "0"),
    "PPT_METRICS": ("off", "metrics", "maybe"),
    "PPT_SLO_TARGETS": ("interactive:0.5,*:5", "slo_targets", "a:b"),
    "PPT_ROUTER_HOSTS": ("nodeA:9090, nodeB:9091", "router_hosts", "a:1,a:1"),
    "PPT_ROUTER_RETRY_MAX": ("7", "router_retry_max", "0"),
    "PPT_SERVE_LISTEN": ("0.0.0.0:9090", "serve_listen", "nowhere"),
    "PPT_ROUTER_PROBE_MS": ("250", "router_probe_ms", "soon"),
    "PPT_ROUTER_HEDGE_MS": ("1500", "router_hedge_ms", "-1"),
    "PPT_ROUTER_FLEET_FILE": ("fleet.txt", "router_fleet_file", "off"),
    "PPT_INGEST_POLL_MS": ("75.5", "ingest_poll_ms", "0"),
    "PPT_INGEST_STABLE_MS": ("0", "ingest_stable_ms", "-1"),
    "PPT_ALERT_CUSUM_K": ("0.75", "alert_cusum_k", "-0.1"),
    "PPT_ALERT_CUSUM_H": ("6.5", "alert_cusum_h", "0"),
    "PPT_MON_INTERVAL_MS": ("250", "mon_interval_ms", "soon"),
    # any string is a DB path: 'off' is the value that turns it off
    "PPT_TUNE_DB": ("tune.json", "tune_db", "off"),
    "PPT_AUTOTUNE": ("on", "autotune", "maybe"),
    "PPT_TUNE_NUMERICS": ("on", "tune_numerics", "2"),
    # any string is a directory: 'off' is the value that turns it off
    "PPT_COMPILE_CACHE": ("kcache", "compile_cache_dir", "off"),
}

# Loads both packages' config.py by path (neither package's __init__, so
# no jax or torch import), under the environment given; prints each knob
# in both, then applies the bad value through env_overrides() in both
# and prints the two ValueErrors.
_HOOK_PROBE = r"""
import importlib.util, json, os, sys
root, name, knob, bad = sys.argv[1:5]
mods = []
for pkg in ("pulseportraiture_tpu", "pulseportraiture_tpu_torch"):
    spec = importlib.util.spec_from_file_location(
        pkg + "_config", os.path.join(root, pkg, "config.py"))
    m = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = m
    spec.loader.exec_module(m)
    mods.append(m)
out = {"values": [repr(getattr(m, knob)) for m in mods], "errors": []}
os.environ[name] = bad
for m in mods:
    try:
        m.env_overrides()
        out["errors"].append(None)
    except ValueError as e:
        out["errors"].append(str(e))
print(json.dumps(out))
"""


def _probe(name, good, knob, bad, extra_env=None):
    import json

    env = {k: v for k, v in os.environ.items() if not k.startswith("PPT_")}
    env[name] = good
    env.update(extra_env or {})
    r = subprocess.run([sys.executable, "-c", _HOOK_PROBE, ROOT, name, knob,
                        bad], env=env, capture_output=True, text=True,
                       timeout=60, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr


@pytest.mark.parametrize("name", sorted(HOOKS))
def test_env_hook(name):
    """Each hook moves its knob the same way in both packages (applied
    at import), and a bad value raises the same ValueError in both."""
    good, knob, bad = HOOKS[name]
    out, _ = _probe(name, good, knob, bad)
    vj, vt = out["values"]
    assert vt == vj
    default = repr(getattr(tcfg, knob))
    assert vt != default, (name, vt)
    ej, et = out["errors"]
    assert et == ej
    if name in ("PPT_TELEMETRY", "PPT_CACHE_DIR", "PPT_ROUTER_FLEET_FILE",
                "PPT_TUNE_DB", "PPT_COMPILE_CACHE"):
        # no value of these is invalid; 'off' disables in both packages
        assert ej is None
    else:
        assert ej is not None


def test_env_unported_and_unknown_warn():
    """A JAX-package hook whose knob the port lacks warns with its
    reason; a typo warns with the closest known name; both once.  The
    tuning hooks and PPT_COMPILE_CACHE are hooked now: they warn not."""
    out, err = _probe("PPT_ZAP_NSTD", "3", "zap_nstd", "2",
                      {"PPT_COMPILE_CACHE": "cache",
                       "PPT_FIT_PALLAS": "on",
                       "PPT_TUNE_DB": "tune.json",
                       "PPT_NCHAN": "64",
                       "PPT_ZAP_NSTDS": "2"})
    port = [ln for ln in err.splitlines()
            if ln.startswith("pulseportraiture_tpu_torch.config")]
    assert any("PPT_FIT_PALLAS" in ln and "PPT_FIT_FUSED" in ln
               for ln in port)
    assert not any("PPT_TUNE_DB" in ln or "PPT_COMPILE_CACHE" in ln
                   for ln in port)
    assert "PPT_COMPILE_CACHE" in tcfg.HOOKED_PPT_ENV
    for name in ("PPT_TUNE_DB", "PPT_AUTOTUNE", "PPT_TUNE_NUMERICS"):
        assert name in tcfg.HOOKED_PPT_ENV
        assert name not in tcfg.UNPORTED_PPT_ENV
    assert any("PPT_NCHAN" in ln and "A5" in ln for ln in port)
    assert any("PPT_ZAP_NSTDS" in ln and "did you mean PPT_ZAP_NSTD" in ln
               for ln in port)
    assert len(port) == 3
    assert set(tcfg.KNOWN_PPT_ENV) == set(jcfg.KNOWN_PPT_ENV)
    assert tcfg.HOOKED_PPT_ENV == set(HOOKS)
    assert set(tcfg.UNPORTED_PPT_ENV) == tcfg.KNOWN_PPT_ENV - set(HOOKS)

"""The PyTorch port's timing on the CPU, against the JAX package:
utils.spin, timing.tim.read_tim, timing.binary (the torch delay ops
against the jnp ones), synth.fake_timing_campaign, timing.gls
(build_gls_system, wideband_gls_fit), timing.fleet (fleet_gls_fit's
batched, serial and host lanes, the pad systems, the pseudoinverse's
cut-off), timing.incremental, make_fake_pulsar(spin_coherent=True) and
cli.pptime.

Gates (each test states its own): Fractions and TimTOA records equal;
the delay ops within 1e-12 relative; the GLS system's A and r within
1e-12 relative; fitted parameters and DMX within 1e-10 x their errors
(the same .tim through both packages' fits); the fleet lanes within
1e-10 (batched vs serial) and 1e-8 (vs the host lane and the JAX fleet)
of max(|value|, error), tests/test_timing_binary.py's gates.
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout
from fractions import Fraction

import numpy as np
import pytest
import torch

from test_torch_helpers import event_counts, rel_err, trace_events

from pulseportraiture_tpu.cli import pptime as jpptime
from pulseportraiture_tpu.io import write_gmodel
from pulseportraiture_tpu.io.psrfits import load_data, parse_parfile
from pulseportraiture_tpu.io.tim import write_TOAs
from pulseportraiture_tpu.pipeline import GetTOAs as JGetTOAs
from pulseportraiture_tpu.synth import default_test_model
from pulseportraiture_tpu.synth import fake_timing_campaign as j_fake
from pulseportraiture_tpu.synth import make_fake_pulsar as j_mfp
from pulseportraiture_tpu.timing import binary as JB
from pulseportraiture_tpu.timing import fleet as JF
from pulseportraiture_tpu.timing import gls as JG
from pulseportraiture_tpu.timing import incremental as JI
from pulseportraiture_tpu.timing import tim as JT
from pulseportraiture_tpu.utils import spin as JS
from pulseportraiture_tpu.utils.mjd import MJD
from pulseportraiture_tpu_torch.cli import pptime as tpptime
from pulseportraiture_tpu_torch.synth import default_test_model as t_model
from pulseportraiture_tpu_torch.synth import fake_timing_campaign as t_fake
from pulseportraiture_tpu_torch.synth import make_fake_pulsar as t_mfp
from pulseportraiture_tpu_torch.timing import binary as TB
from pulseportraiture_tpu_torch.timing import fleet as TF
from pulseportraiture_tpu_torch.timing import gls as TG
from pulseportraiture_tpu_torch.timing import incremental as TI
from pulseportraiture_tpu_torch.timing import tim as TT
from pulseportraiture_tpu_torch.utils import spin as TS
from pulseportraiture_tpu_torch.utils.mjd import MJD as TMJD

SECPERDAY = 86400.0
# tests/test_timing.py's pulsar and campaign
PAR = {"PSR": "J1744-1134", "RAJ": "17:44:29.4", "DECJ": "-11:34:54.6",
       "P0": 0.004074, "PEPOCH": 55150.0, "DM": 3.139}
DDMS = [3e-4, -2e-4, 5e-4, -4e-4]
# the fleet parfiles of tests/test_incremental.py and bench_gls
IPAR = {"PSR": "FAKE", "F0": "218.8", "PEPOCH": "55500", "DM": "15.9"}
EPAR = dict(IPAR, BINARY="ELL1", PB="1.53", A1="1.89", TASC="55499.5",
            EPS1="2.1e-7", EPS2="-1.4e-7")
BTPAR = {"PSR": "G", "F0": "180.0", "PEPOCH": "55500", "DM": "5",
         "BINARY": "BT", "PB": "0.9", "A1": "0.4", "T0": "55499.4",
         "ECC": "0.15", "OM": "100.0"}


def _rows(toas):
    return [dataclasses.astuple(t) for t in toas]


# --------------------------------------------------------------------------
# utils.spin and read_tim

@pytest.mark.parametrize("v", ["245.4261196898081", "1.5D-3", "55000.5",
                               0.004074, 7, Fraction(3, 7)])
def test_spin_rational(v):
    assert TS.rational(v) == JS.rational(v)


@pytest.mark.parametrize("par", [{"F0": "245.4261196898081"},
                                 {"P0": 0.004074},
                                 {"F0": None, "P0": "0.0016"}])
def test_spin_phase_fractions(par):
    """spin_F0 the same Fraction; spin_phase_frac and day_phase_frac the
    same floats over a decade of epochs."""
    F0j, F0t = JS.spin_F0(par), TS.spin_F0(par)
    assert F0t == F0j
    for day, frac in ((55000, 0.0), (55123, 0.318), (58650, 0.9999999),
                      (54001, 0.5)):
        assert TS.spin_phase_frac(F0t, "55000.25", day, frac) == \
            JS.spin_phase_frac(F0j, "55000.25", day, frac)
        assert TS.day_phase_frac(F0t, 55000, day) == \
            JS.day_phase_frac(F0j, 55000, day)


TIM_LINES = [
    "FORMAT 1\n", "MODE 1\n", "# a comment\n", "C ignored\n", "\n",
    "ep0.fits 1500.000 55100.212345678901234 0.123 @ -pp_dm 3.14 "
    "-pp_dme 0.0002 -subint 0 -flag\n",
    "ep1.fits 0.0 55101 1.5 gbt -pp_dm 3.1\n",
    "ep2.fits 1400.5 55102.5 0.2 ao -pp_dme 1e-4 -snr 12.5\n",
    "EFAC 1 2 3 4 5\n", "bad.fits x 55100.1 0.1 @\n",
]


def test_read_tim_records():
    """The same TimTOA records from lines and from a file: the digit-
    exact MJD split, the 0.0 MHz = inf convention, flags, DMs."""
    a, b = JT.read_tim(TIM_LINES), TT.read_tim(TIM_LINES)
    assert len(b) == 3 and _rows(b) == _rows(a)
    assert b[0].mjd_frac == 0.212345678901234 and b[1].frequency == np.inf


# --------------------------------------------------------------------------
# timing.binary: the torch delay ops against the jnp ones

def test_binary_ops_against_jnp(rng):
    """ELL1 and BT delays and partials within 1e-12 relative (of each
    row's max) of the jnp ops, float64 throughout, and the torch op
    against the NumPy oracle."""
    dt = rng.uniform(-3e5, 5e7, 257)
    ell1 = (0.3 * SECPERDAY, 0.6, 1e-4, -5e-5, 1e-12, 1e-14, 1e-18,
            -1e-18)
    bt = (0.9 * SECPERDAY, 0.4, 0.37, 123.0, 1e-12, 1e-14)
    for jf, tf, npf, args in (
            (JB.ell1_delay_and_partials, TB.ell1_delay_and_partials,
             TB.ell1_delay_np, ell1),
            (JB.bt_delay_and_partials, TB.bt_delay_and_partials,
             TB.bt_delay_np, bt)):
        dj, pj = (np.asarray(v) for v in jf(dt, *args))
        dtt, pt = tf(dt, *args, device="cpu")
        assert dtt.dtype == pt.dtype == torch.float64
        assert pt.shape == (5, len(dt))
        assert rel_err(dtt.numpy(), dj) <= 1e-12
        for i in range(5):
            assert rel_err(pt[i].numpy(), pj[i]) <= 1e-12, i
        assert rel_err(dtt.numpy(), npf(dt, *args)) <= 1e-12


@pytest.mark.parametrize("par", [EPAR, BTPAR], ids=["ELL1", "BT"])
def test_binary_delay_and_partials(par):
    """The parfile-unit dispatch (PB/TASC/T0 per day, OM per degree)
    within 1e-12 relative, from a parsed BinaryParams of each package."""
    bj, bt = JB.parse_binary(par), TB.parse_binary(par)
    assert dataclasses.astuple(bt) == dataclasses.astuple(bj)
    mi = np.arange(55400, 56400, 7, dtype=np.int64)
    mf = np.linspace(0.01, 0.99, len(mi))
    dj, pj = (np.asarray(v) for v in JB.binary_delay_and_partials(bj, mi,
                                                                  mf))
    dt, pt = TB.binary_delay_and_partials(bt, mi, mf, device="cpu")
    assert rel_err(dt.numpy(), dj) <= 1e-12
    for i in range(5):
        assert rel_err(pt[i].numpy(), pj[i]) <= 1e-12, bt.param_names[i]


def test_binary_parse_refusals():
    for bad, match in (({"BINARY": "DD", "PB": 1, "A1": 1, "T0": 5e4},
                        "not implemented"),
                       ({"BINARY": "ELL1", "PB": 1.0, "A1": 1.0}, "TASC"),
                       ({"PB": 1.0, "A1": 1.0}, "underspecified")):
        with pytest.raises(ValueError, match=match):
            TB.parse_binary(bad)


# --------------------------------------------------------------------------
# synth.fake_timing_campaign

@pytest.mark.parametrize("par,kw", [
    (IPAR, dict(dmx=2e-4)),
    (EPAR, dict(truth={"PB": 1.53 + 3e-9, "A1": 1.89 + 2e-7}, dmx=3e-4,
                toas_per_epoch=3)),
    (BTPAR, dict(truth={"PB": 0.9 + 4e-9}, dmx=np.linspace(-1e-4, 1e-4,
                                                           10))),
    (IPAR, dict(glitch={"epoch": 4, "dphi": 0.1, "df0": 1e-9},
                dm_step={"epoch": 6, "ddm": 1e-3})),
], ids=["isolated", "ELL1", "BT", "glitch"])
def test_fake_timing_campaign_bit_for_bit(par, kw):
    """The same rng gives the same TimTOA records, bit for bit, and the
    same truth (injected corrections, DMX draws, events)."""
    a, ta = j_fake(par, n_epochs=10, rng=7, **kw)
    b, tb = t_fake(par, n_epochs=10, rng=7, **kw)
    assert _rows(b) == _rows(a)
    assert tb.injected == ta.injected
    assert np.array_equal(tb.dmx, ta.dmx)
    assert (tb.glitch, tb.dm_step) == (ta.glitch, ta.dm_step)


# --------------------------------------------------------------------------
# timing.gls

@pytest.mark.parametrize("par,kw", [
    (IPAR, {}), (IPAR, dict(fit_f1=True)), (EPAR, {}), (BTPAR, {}),
    (EPAR, dict(fit_binary=False))],
    ids=["isolated", "fit_f1", "ELL1", "BT", "no_fit_binary"])
def test_build_gls_system(par, kw):
    """The whitened design matrix and residuals within 1e-12 relative of
    the JAX package's (per column for A), the same names and epochs."""
    toas, _ = j_fake(par, truth={"F0": float(par["F0"]) * (1 + 1e-13)},
                     n_epochs=9, toas_per_epoch=2, dmx=2e-4, rng=11)
    sj = JG.build_gls_system(toas, par, **kw)
    st = TG.build_gls_system(toas, par, **kw)
    assert st.names == sj.names and st.nep == sj.nep
    assert np.array_equal(st.epochs, sj.epochs)
    assert st.A.dtype == st.r.dtype == np.float64
    assert rel_err(st.r, sj.r) <= 1e-12
    for j in range(sj.A.shape[1]):
        assert rel_err(st.A[:, j], sj.A[:, j]) <= 1e-12, j


def test_gls_refusals():
    toas, _ = j_fake(IPAR, n_epochs=4, rng=1)
    for par, match in (({"F0": 333.0, "DM": 10.0}, "PEPOCH"),
                       ({"PEPOCH": 55000.0, "DM": 10.0}, "F0"),
                       (dict(EPAR, SINI="0.9", M2="0.2"), "M2.*SINI")):
        with pytest.raises(ValueError, match=match):
            TG.wideband_gls_fit(toas, par)
    many, _ = j_fake(IPAR, n_epochs=10, toas_per_epoch=3, rng=1)
    for fit in (JG.wideband_gls_fit, TG.wideband_gls_fit):
        with pytest.raises(ValueError, match="phase connection"):
            fit(many, dict(IPAR, F0="218.8003"))
    with pytest.warns(UserWarning, match="dropped 1"):
        TG.wideband_gls_fit([dataclasses.replace(toas[0], dm=None)]
                            + toas[1:], IPAR)


@pytest.fixture(scope="module")
def spin_campaign(tmp_path_factory):
    """tests/test_timing.py's campaign (4 spin-coherent epochs of 3
    subints x 32 channels x 256 bins with injected dDMs) written by both
    packages, and the JAX pipeline's .tim of the JAX archives."""
    root = tmp_path_factory.mktemp("ttiming")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = {"jax": [], "torch": []}
    for i, dDM in enumerate(DDMS):
        for pkg, mfp, mjd, m, extra in (
                ("jax", j_mfp, MJD, model, {}),
                ("torch", t_mfp, TMJD, t_model(1500.0), {"device": "cpu"})):
            path = str(root / f"{pkg}-ep{i}.fits")
            mfp(m, PAR, outfile=path, nsub=3, nchan=32, nbin=256,
                nu0=1500.0, bw=800.0, tsub=120.0, phase=0.017, dDM=dDM,
                start_MJD=mjd(55100 + 30 * i, 0.2), noise_stds=0.05,
                dedispersed=False, quiet=True, rng=500 + i,
                spin_coherent=True, **extra)
            files[pkg].append(path)
    gt = JGetTOAs(files["jax"], gmodel, quiet=True)
    gt.get_TOAs(quiet=True)
    tim = str(root / "epochs.tim")
    write_TOAs(gt.TOA_list, outfile=tim)
    return root, files, gmodel, tim


def test_spin_coherent_archives_equal(spin_campaign):
    """make_fake_pulsar(spin_coherent=True): both packages write the same
    DATA (the spin-phase rotation per subint included)."""
    _, files, _, _ = spin_campaign
    for fj, ft in zip(files["jax"], files["torch"]):
        a = load_data(fj, dedisperse=False, quiet=True)
        b = load_data(ft, dedisperse=False, quiet=True)
        assert np.array_equal(np.asarray(b.subints), np.asarray(a.subints))


def _params_close(got, ref, tol):
    """Every parameter and DMX within tol x its (reference) error."""
    assert list(got.params) == list(ref.params)
    for k in ref.params:
        assert abs(got.params[k] - ref.params[k]) <= \
            tol * ref.param_errs[k], k
        assert got.param_errs[k] == pytest.approx(ref.param_errs[k],
                                                  rel=1e-8), k
    assert np.all(np.abs(got.dmx - ref.dmx) <= tol * ref.dmx_errs)


@pytest.mark.parametrize("fit_f0,perturb", [(True, False), (True, True),
                                            (False, False)])
def test_wideband_gls_fit(spin_campaign, fit_f0, perturb):
    """The same .tim through both packages' fits: parameters and DMX
    within 1e-10 x their errors, chi2 within 1e-10 relative; with the
    par's F0 perturbed as in tests/test_timing.py."""
    _, _, _, tim = spin_campaign
    par = dict(PAR)
    if perturb:
        par.pop("P0")
        par["F0"] = (1.0 / PAR["P0"]) * (1.0 + 3e-12)
    ref = JG.wideband_gls_fit(JT.read_tim(tim), par, fit_f0=fit_f0)
    got = TG.wideband_gls_fit(TT.read_tim(tim), par, fit_f0=fit_f0)
    _params_close(got, ref, 1e-10)
    assert got.chi2 == pytest.approx(ref.chi2, rel=1e-10)
    assert got.dof == ref.dof and got.n_dropped_no_dm == 0


def test_port_timing_chain(spin_campaign, tmp_path):
    """The port end to end on its own archives: GetTOAs (the fused lane
    forced, as in test_torch_toas) -> .tim -> wideband_gls_fit with F0
    perturbed, held to tests/test_timing.py's gates."""
    from pulseportraiture_tpu_torch import config as tcfg
    from pulseportraiture_tpu_torch.io.tim import write_TOAs as t_write
    from pulseportraiture_tpu_torch.pipeline import GetTOAs as TGetTOAs

    _, files, gmodel, _ = spin_campaign
    saved = tcfg.use_fast_fit, tcfg.fit_fused
    tcfg.use_fast_fit, tcfg.fit_fused = True, True
    try:
        gt = TGetTOAs(files["torch"], gmodel, quiet=True, device="cpu")
        gt.get_TOAs(quiet=True)
    finally:
        tcfg.use_fast_fit, tcfg.fit_fused = saved
    tim = str(tmp_path / "port.tim")
    t_write(gt.TOA_list, outfile=tim)
    par = {k: v for k, v in PAR.items() if k != "P0"}
    f0 = 1.0 / PAR["P0"]
    par["F0"] = f0 * (1.0 + 3e-12)
    res = TG.wideband_gls_fit(TT.read_tim(tim), par)
    assert len(res.dmx) == 4
    assert 0.3 < res.red_chi2 < 3.0, res.red_chi2
    assert np.all(np.abs(res.time_resids_us) < 5.0 * res.toa_errs_us)
    for j, dDM in enumerate(DDMS):
        assert abs(res.dmx[j] - dDM) <= max(4.0 * res.dmx_errs[j], 3e-5)
    assert res.params["F0"] == pytest.approx(-f0 * 3e-12, rel=0.01)
    # the in-memory adapter gives the same records as the .tim round trip
    mem = TF.toas_from_measurements(gt.TOA_list)
    assert [(t.archive, t.mjd_int) for t in mem] == \
        [(t.archive, t.mjd_int) for t in TT.read_tim(tim)]


def test_spin_coherent_composes_with_dither(tmp_path):
    """The port's make_fake_pulsar(spin_coherent=True, nbit=2,
    dither=True): the spin rotation is applied before the dithered
    quantizer, so each subint's profile sits at the same phase as the
    16-bit spin-coherent subint's (noise draws shared), and away from
    the unrotated one's."""
    model = t_model(1500.0)
    kw = dict(nsub=3, nchan=16, nbin=256, tsub=4000.0, noise_stds=0.02,
              start_MJD=TMJD(55321, 0.37), dedispersed=True, quiet=True,
              device="cpu")
    prof = {}
    for name, extra in (("coherent16", dict(spin_coherent=True)),
                        ("coherent2", dict(spin_coherent=True, nbit=2,
                                           dither=True)),
                        ("plain16", {})):
        path = str(tmp_path / f"{name}.fits")
        t_mfp(model, PAR, outfile=path, rng=3, **kw, **extra)
        d = load_data(path, dedisperse=False, quiet=True)
        prof[name] = np.asarray(d.subints)[:, 0].mean(axis=1)

    def lag(a, b):
        x = np.fft.irfft(np.fft.rfft(a) * np.fft.rfft(b).conj(), n=len(a))
        return int((np.argmax(x) + len(a) // 2) % len(a) - len(a) // 2)

    F0r = TS.spin_F0(PAR)
    for isub in range(3):
        e = TMJD(55321, 0.37).add_seconds((isub + 0.5) * 4000.0)
        turns = TS.spin_phase_frac(F0r, PAR["PEPOCH"], e.day, e.frac)
        want = int(round(-((turns + 0.5) % 1.0 - 0.5) * 256))
        assert lag(prof["coherent2"][isub], prof["coherent16"][isub]) == 0
        assert abs(lag(prof["coherent2"][isub], prof["plain16"][isub])
                   - want) <= 1, isub


# --------------------------------------------------------------------------
# timing.fleet

def _fleet_jobs(n=7, nep=5, span=90.0):
    """bench_gls's ELL1 / BT / isolated mix (tiny by default):
    heterogeneous epoch counts, so the buckets carry pad rows, pad
    columns and all-zero pad systems."""
    jobs = []
    for i in range(n):
        par = {"PSR": f"B{i:03d}", "F0": str(180.0 + 17.3 * i),
               "PEPOCH": "55500", "DM": str(8.0 + 1.5 * i)}
        kind = i % 3
        if kind == 0:
            par.update({"BINARY": "ELL1", "PB": str(0.4 + 0.07 * i),
                        "A1": str(0.04 + 0.005 * i), "TASC": "55499.13",
                        "EPS1": "1.5e-6", "EPS2": "-6e-7"})
        elif kind == 1:
            par.update({"BINARY": "BT", "PB": str(0.9 + 0.05 * i),
                        "A1": str(0.3 + 0.02 * i), "T0": "55499.4",
                        "ECC": "0.12", "OM": str(20.0 + 10.0 * i)})
        truth = {"F0": float(par["F0"]) * (1.0 + 1e-13)}
        if kind != 2:
            truth["PB"] = float(par["PB"]) + 2e-9
        toas, _ = j_fake(par, truth=truth, n_epochs=nep + (i % 3),
                         toas_per_epoch=2, span_days=span, toa_err_us=0.1,
                         dmx=2e-4, rng=400 + i)
        jobs.append((par["PSR"], toas, par))
    return jobs


def _max_delta(a, b):
    worst = 0.0
    for name in a.pulsars:
        ra, rc = a.results[name], b.results[name]
        pairs = [(ra.params[k], rc.params[k], ra.param_errs[k])
                 for k in ra.params]
        pairs += list(zip(ra.dmx, rc.dmx, ra.dmx_errs))
        for va, vc, err in pairs:
            worst = max(worst, abs(va - vc)
                        / max(abs(vc), float(err), 1e-300))
    return worst


@pytest.fixture(scope="module")
def fleets():
    jobs = _fleet_jobs()
    out = {"jax": JF.fleet_gls_fit(jobs, device=True, batched=True)}
    for label, kw in (("batched", dict(gls_device=True)),
                      ("serial", dict(gls_device=True, batched=False)),
                      ("host", dict(gls_device=False))):
        out[label] = TF.fleet_gls_fit(jobs, device="cpu", **kw)
        out[label + "_stats"] = TF.fleet_stats()
    return jobs, out


def test_fleet_lanes(fleets):
    """tests/test_timing_binary.py's fleet gates on the port's lanes and
    against the JAX fleet: batched vs serial <= 1e-10, vs host and vs
    JAX <= 1e-8 of max(|value|, error); fewer batched calls; the
    buckets carry pad rows and pad columns."""
    jobs, out = fleets
    b = out["batched"]
    assert _max_delta(b, out["serial"]) <= 1e-10
    assert _max_delta(b, out["host"]) <= 1e-8
    assert _max_delta(b, out["jax"]) <= 1e-8
    assert b.n_dispatches < out["serial"].n_dispatches == len(jobs)
    assert b.n_dispatches == out["jax"].n_dispatches
    assert (b.device, b.batched) == (True, True)
    assert (out["host"].device, out["serial"].batched) == (False, False)
    solves = out["batched_stats"]["solves"]
    assert sum(s["rows"] for s in solves) == len(jobs)
    assert any(s["B"] > s["rows"] for s in solves)  # all-zero pad systems
    for name in b.pulsars:
        rb, rj = b.results[name], out["jax"].results[name]
        assert list(rb.params) == list(rj.params)
        assert rb.chi2 == pytest.approx(rj.chi2, rel=1e-8)
        assert rb.dof == rj.dof


def test_fleet_lanes_decade():
    """BASELINE config 5's pulsar count over a decade of monthly epochs
    (43 synthetic pulsars, 120-122 epochs, one 512 x 128 bucket of 64):
    the batched and serial lanes bit for bit (a BT member's normal
    matrix has cond ~1e7, so any batch-width dependence of the solve's
    arithmetic would show here), the host lane within 1e-8."""
    jobs = _fleet_jobs(43, 120, 3650.0)
    b = TF.fleet_gls_fit(jobs, gls_device=True, device="cpu")
    assert [(s["bucket"], s["B"]) for s in TF.fleet_stats()["solves"]] == \
        [("512x128", 64)]
    s = TF.fleet_gls_fit(jobs, gls_device=True, batched=False,
                         device="cpu")
    h = TF.fleet_gls_fit(jobs, gls_device=False, device="cpu")
    assert _max_delta(b, s) == 0.0
    assert _max_delta(b, h) <= 1e-8


def test_solve_program_batch_invariant():
    """Every row of _solve_program at B = 8 equals the same system
    solved alone (B = 1), bit for bit, on a batch of badly conditioned
    systems (two nearly collinear columns each)."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((8, 96, 24))
    A[:, :, 1] = A[:, :, 0] + 1e-5 * rng.standard_normal((8, 96))
    r = rng.standard_normal((8, 96))
    At, rt = torch.as_tensor(A), torch.as_tensor(r)
    big = TF._solve_program(At, rt)
    for i in range(8):
        one = TF._solve_program(At[i:i + 1], rt[i:i + 1])
        for a, b in zip(big, one):
            assert torch.equal(a[i], b[0]), i


def test_fleet_matches_single_pulsar_fit(fleets):
    jobs, out = fleets
    name, toas, par = jobs[1]
    solo = TG.wideband_gls_fit(toas, par)
    rb = out["batched"].results[name]
    for k in solo.params:
        assert rb.params[k] == pytest.approx(
            solo.params[k], rel=1e-8, abs=1e-8 * solo.param_errs[k]), k


def test_solve_program_pad_systems():
    """_solve_program on a batch with an all-zero pad system and zero pad
    columns: finite, exactly zero where padded, and the real systems
    equal to the host oracle's solve (1e-8 relative)."""
    rng = np.random.default_rng(3)
    A = np.zeros((4, 32, 8))
    r = np.zeros((4, 32))
    A[:3, :20, :6] = rng.standard_normal((3, 20, 6))
    r[:3, :20] = rng.standard_normal((3, 20))
    x, perr, post, chi2 = (v.numpy() for v in TF._solve_program(
        torch.as_tensor(A), torch.as_tensor(r)))
    for v in (x, perr, post, chi2):
        assert np.all(np.isfinite(v))
    assert not (x[3].any() or perr[3].any() or post[3].any() or chi2[3])
    assert not (x[:, 6:].any() or perr[:, 6:].any())
    for b in range(3):
        xh, ph, _, posth, chi2h = TG.gls_solve_np(A[b, :20, :6], r[b, :20])
        assert rel_err(x[b, :6], xh) <= 1e-8
        assert rel_err(perr[b, :6], ph) <= 1e-8
        assert chi2[b] == pytest.approx(chi2h, rel=1e-8)


def test_solve_program_pinv_cutoff():
    """A marginal system (two unit columns at an angle whose normal
    matrix has a singular-value ratio between torch's default cut-off,
    p * eps, and JAX's, 10 * p * eps): the port drops the direction as
    the JAX program does, where torch's default would keep it."""
    import jax.numpy as jnp

    theta = 9.4e-8  # ratio theta^2 / 4 ~ 2.2e-15: between 4.4e-16, 4.4e-15
    m = 8
    A = np.zeros((1, m, 2))
    A[0, 0, 0] = 1.0
    A[0, 0, 1], A[0, 1, 1] = np.cos(theta), np.sin(theta)
    r = np.zeros((1, m))
    r[0, :2] = (1.0, 1.0)
    x = TF._solve_program(torch.as_tensor(A), torch.as_tensor(r))[0]
    jx = JF._solve_program(1, m, 2)(jnp.asarray(A), jnp.asarray(r))[0]
    assert rel_err(x.numpy(), np.asarray(jx)) <= 1e-8
    G = torch.as_tensor(A[0].T @ A[0])
    kept = torch.linalg.pinv(G) @ torch.as_tensor(A[0].T @ r[0])
    assert np.max(np.abs(kept.numpy())) > 1e3 * np.max(np.abs(x.numpy()))


def test_fleet_refusals(tmp_path):
    """The JAX package's ValueErrors; telemetry= (ported) writes its
    timing_fit per solve and the fleet_end rollup, on the host lane and
    the batched lane, as the JAX fleet does."""
    jobs = _fleet_jobs()[:2]
    for lane in (False, True):
        jt = str(tmp_path / f"jax{lane}.jsonl")
        tt = str(tmp_path / f"torch{lane}.jsonl")
        JF.fleet_gls_fit(jobs, device=lane, telemetry=jt)
        TF.fleet_gls_fit(jobs, gls_device=lane, telemetry=tt, device="cpu")
        assert event_counts(tt) == event_counts(jt)

        def fits(path):
            return [(e["bucket"], e["rows"], e["pad"], e["batched"])
                    for e in trace_events(path) if e["type"] == "timing_fit"]

        assert fits(tt) == fits(jt) and fits(tt)
        end = [e for e in trace_events(tt) if e["type"] == "fleet_end"]
        assert [e["n_pulsars"] for e in end] == [2]
    with pytest.raises(ValueError, match="duplicate"):
        TF.fleet_gls_fit(jobs + jobs[:1], device="cpu")
    with pytest.raises(ValueError, match="gls_device"):
        TF.fleet_gls_fit(jobs, gls_device="sometimes", device="cpu")
    bad = (jobs[0][0], jobs[0][1], {"F0": "200"})
    with pytest.raises(ValueError, match="B000.*PEPOCH"):
        TF.fleet_gls_fit([bad], device="cpu")
    # 'auto' is the host lane on the CPU, the batched lane for CUDA
    assert TF.resolve_gls_device("auto", "cpu") is False


# --------------------------------------------------------------------------
# timing.incremental

def _inc_campaign(par, rng):
    return j_fake(par, n_epochs=8, toas_per_epoch=3, span_days=80.0,
                  dmx=2e-4, rng=rng)[0]


def _inc_equal(got, ref, tol=1e-10):
    for k, v in ref.params.items():
        assert abs(got.params[k] - v) <= tol * max(1.0, abs(v)), k
    assert np.max(np.abs(got.dmx - ref.dmx)
                  / np.maximum(1.0, np.abs(ref.dmx))) <= tol


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_incremental_against_jax(order):
    """Both packages' lanes over the same TOA stream, in time order and
    shuffled (a TOA out of order renumbers the epochs and rebuilds):
    the same solution after every update (1e-10), the same structural
    resolves, and a periodic resolve every 5 updates."""
    toas = _inc_campaign(IPAR, 2)
    if order == "shuffled":
        toas = list(toas)
        np.random.default_rng(5).shuffle(toas)
    lj = JI.IncrementalGLS(IPAR, fit_binary=False, resolve_every=5)
    lt = TI.IncrementalGLS(IPAR, fit_binary=False, resolve_every=5)
    for toa in toas:
        rj, rt = lj.update(toa), lt.update(toa)
        assert (rj is None) == (rt is None)
        if rj is not None:
            _inc_equal(rt, rj)
    assert (lt.n_updates, lt.n_resolves) == (lj.n_updates, lj.n_resolves)
    _inc_equal(lt.result, TG.wideband_gls_fit(toas, IPAR,
                                              fit_binary=False))


def test_incremental_binary_against_jax():
    """An ELL1 stream: the torch partials at each update through the
    CPU op, the final solution equal to the JAX lane's (1e-10)."""
    toas = _inc_campaign(EPAR, 1)
    lj = JI.IncrementalGLS(EPAR, resolve_every=0)
    lt = TI.IncrementalGLS(EPAR, resolve_every=0)
    for toa in toas:
        lj.update(toa)
        lt.update(toa)
    _inc_equal(lt.result, lj.result)


def test_incremental_drift_and_refusals(monkeypatch, tmp_path):
    """A corrupted accumulator raises GLSDriftError at the next periodic
    resolve, as in the JAX package; the cadence defaults to
    config.gls_resolve_every; a tracer (ported) counts the resolves as
    the JAX package's does; an unusable par raises."""
    from pulseportraiture_tpu_torch import config as tcfg

    toas = sorted(_inc_campaign(IPAR, 4),
                  key=lambda t: t.mjd_int + t.mjd_frac)
    lane = TI.IncrementalGLS(IPAR, fit_binary=False, resolve_every=4)
    with pytest.raises(TI.GLSDriftError, match="drifted"):
        for i, toa in enumerate(toas):
            if i == 6:
                lane._b = lane._b * 1.5
            lane.update(toa)
    monkeypatch.setattr(tcfg, "gls_resolve_every", 7)
    assert TI.IncrementalGLS(IPAR).resolve_every == 7
    from pulseportraiture_tpu import telemetry as JTel
    from pulseportraiture_tpu_torch import telemetry as TTel

    counts = []
    for mod, inc in ((JTel, JI), (TTel, TI)):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        with mod.Tracer(path) as tr:
            lane = inc.IncrementalGLS(IPAR, fit_binary=False,
                                      resolve_every=4, tracer=tr)
            for toa in toas:
                lane.update(toa)
        counts.append(trace_events(path)[-1]["counters"])
    assert counts[1] == counts[0]
    assert counts[1]["incremental_resolves"] >= 2
    with pytest.raises(ValueError, match="PEPOCH"):
        TI.IncrementalGLS({"PSR": "X", "F0": "100"})


# --------------------------------------------------------------------------
# cli.pptime

@pytest.fixture(scope="module")
def pptime_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("pptime")
    lines = []
    for i, (par, n) in enumerate(((IPAR, 6), (EPAR, 7), (BTPAR, 6))):
        toas, _ = j_fake(par, truth={"F0": float(par["F0"]) * (1 + 1e-13)},
                         n_epochs=n, toas_per_epoch=2, dmx=2e-4, rng=20 + i)
        tim, pf = root / f"p{i}.tim", root / f"p{i}.par"
        tim.write_text("".join(
            f"{t.archive} 0.0 {t.mjd_int}.{f'{t.mjd_frac:.17f}'[2:]} "
            f"{t.error_us} {t.site} -pp_dm {float(t.dm)!r} "
            f"-pp_dme {t.dm_err!r}\n"
            for t in toas))
        pf.write_text("".join(f"{k} {v}\n" for k, v in par.items()))
        lines.append(f"P{i} {tim} {pf}")
    jobs = root / "jobs.txt"
    jobs.write_text("# fleet\n" + "\n".join(lines) + "\n")
    return root, str(jobs)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("argv", [
    ["-j", "JOBS", "--json"],
    ["-j", "JOBS", "--json", "--gls-device", "on"],
    ["-j", "JOBS", "--json", "--gls-device", "on", "--serial",
     "--fit-f1", "--no-fit-binary"],
    ["-j", "JOBS", "--json", "--epoch-gap", "20", "--allow-wraps"],
    ["TIM", "PAR", "--json"],
], ids=["host", "batched", "serial-f1-nobinary", "gap-wraps", "single"])
def test_pptime_json(pptime_ws, argv):
    """--json lines of both CLIs: the same pulsars, TOA counts, dof,
    binary kinds and parameter names; values within 1e-8 x max(|v|,
    err)."""
    root, jobs = pptime_ws
    argv = [jobs if a == "JOBS" else str(root / "p1.tim") if a == "TIM"
            else str(root / "p1.par") if a == "PAR" else a for a in argv]
    ref = [json.loads(ln) for ln in _run(jpptime.main, argv)
           if ln.startswith("{")]
    got = [json.loads(ln) for ln in _run(tpptime.main,
                                         argv + ["--device", "cpu"])
           if ln.startswith("{")]
    assert len(got) == len(ref) and ref
    for g, r in zip(got, ref):
        for k in ("pulsar", "n_toas", "dof", "binary"):
            assert g[k] == r[k], k
        assert list(g["params"]) == list(r["params"])
        for k, v in r["params"].items():
            assert abs(g["params"][k] - v) <= 1e-8 * max(
                abs(v), r["param_errs"][k]), k
        assert np.allclose(g["dmx"], r["dmx"], rtol=0, atol=1e-12)
        assert g["chi2"] == pytest.approx(r["chi2"], rel=1e-8)


def test_pptime_table(pptime_ws):
    """The table output line for line (the walls aside): pulsar lines
    equal; parameter lines the same names, values equal to their 6
    printed digits but for a last-digit rounding."""
    _, jobs = pptime_ws
    ref = _run(jpptime.main, ["-j", jobs, "--gls-device", "on"])
    got = _run(tpptime.main, ["-j", jobs, "--gls-device", "on", "--device",
                              "cpu"])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if g.startswith("fleet GLS") or g == got[-1]:
            assert g.rsplit(" in ", 1)[0] == r.rsplit(" in ", 1)[0]
            continue
        if not g.startswith("    "):
            assert g == r
            continue
        gk, gv, _, ge = g.split()
        rk, rv, _, re_ = r.split()
        assert gk == rk and ge == re_
        assert abs(float(gv) - float(rv)) <= 1.01e-6 * abs(float(rv))


def test_pptime_refusals(pptime_ws, tmp_path):
    root, jobs = pptime_ws
    # --telemetry (ported): the JAX CLI's events
    jt, tt = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    _run(jpptime.main, ["-j", jobs, "--telemetry", jt, "--quiet"])
    _run(tpptime.main, ["-j", jobs, "--telemetry", tt, "--device", "cpu",
                        "--quiet"])
    assert event_counts(tt) == event_counts(jt)
    assert event_counts(tt)["fleet_end"] == 1
    with pytest.raises(SystemExit, match="not both"):
        tpptime.main(["-j", jobs, "a.tim", "a.par", "--device", "cpu"])
    with pytest.raises(SystemExit, match="need a timfile"):
        tpptime.main(["--device", "cpu"])
    bad = tmp_path / "bad.txt"
    bad.write_text("only two\n")
    with pytest.raises(SystemExit, match="expected"):
        tpptime.main(["-j", str(bad), "--device", "cpu"])
    parsed = parse_parfile(str(root / "p1.par"))
    assert TB.parse_binary(parsed).kind == "ELL1"

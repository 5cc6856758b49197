"""The PyTorch port's scattering lane against the JAX package.

Inputs are made from numpy seeds at small sizes (3 subints x 16
channels x 256 bins, a 128-harmonic window) and pushed through the JAX
function and the port's counterpart on the CPU.  Tolerances, each
stated where it is checked:

- (a) the Dot2 helpers in float32: bit for bit against the JAX
  functions run op by op (jax.disable_jit: under jit XLA's CPU fusion
  may contract a product and a sum into one FMA, which the error-free
  transforms exclude), and within 2 eps x sum|a b| of the exact dot;
- (b) _cgh_scatter's f, g, H and (C, S) in float64 within 1e-10 x
  max|ref|, log10 tau on and off, compensated on and off;
- (c) prepare_scatter_fit_real: the port's plain want_m2 version
  against the JAX fused scan (fit_pallas=False) within 1e-12 x max|ref|
  per output, with and without an instrumental response;
- (d) the fast scatter batch fit, (e) the complex engine
  (fit_portrait_batch, fit_portrait) in float64: phi within 1e-9 rot,
  tau and alpha within 1e-7 relative, their errors within 1e-7
  relative, chi2 within 1e-10 relative, nfeval and return codes equal;
- (f) estimate_tau_batch within 1e-10 relative, the instrumental
  response and the scattering kernels within 1e-12 x max|ref|.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import rel_err

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.fit import portrait as JP
from pulseportraiture_tpu.ops import gaussian as JG
from pulseportraiture_tpu.ops import scattering as JS
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.fit import portrait as TP
from pulseportraiture_tpu_torch.io.gmodel import gen_gmodel_portrait
from pulseportraiture_tpu_torch.ops import gaussian as TG
from pulseportraiture_tpu_torch.ops import scattering as TS
from pulseportraiture_tpu_torch.synth import default_test_model

NB, NCHAN, NBIN, K = 3, 16, 256, 128
P0 = 0.004074
Dconst = tcfg.Dconst


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def data():
    """Noisy dispersed, scattered portraits (injected phi, DM, tau, alpha
    per subint) against a shared Gaussian template; channel 5 masked."""
    rng = np.random.default_rng(5)
    freqs = np.linspace(1150.0, 1850.0, NCHAN)
    model = gen_gmodel_portrait(default_test_model(1500.0), np.arange(NBIN),
                                freqs, device="cpu")
    nu_fit = np.full(NB, 1450.0)
    phis = np.array([0.013, -0.21, 0.37])
    DMs = np.array([0.0021, -0.0013, 0.0008])
    taus = np.array([0.01, 0.02, 0.006])
    alphas = np.array([-4.0, -3.6, -4.3])
    k = np.arange(NBIN // 2 + 1)
    ports = np.empty((NB, NCHAN, NBIN))
    for b in range(NB):
        t = phis[b] + Dconst * DMs[b] / P0 * (freqs**-2 - nu_fit[b]**-2)
        tn = taus[b] * (freqs / nu_fit[b]) ** alphas[b]
        kern = 1.0 / (1.0 + 2j * np.pi * tn[:, None] * k)
        ports[b] = np.fft.irfft(np.fft.rfft(model, axis=-1) * kern
                                * np.exp(-2j * np.pi * k * t[:, None]),
                                n=NBIN, axis=-1)
    noise = np.full((NB, NCHAN), 0.3)
    ports += noise[..., None] * rng.standard_normal(ports.shape)
    masks = np.ones((NB, NCHAN))
    masks[:, 5] = 0.0
    # a channel-dependent boxcar response
    ir = np.sinc(k[None, :] * 0.01 * np.linspace(0.5, 1.5, NCHAN)[:, None])
    return dict(ports=ports, model=model, noise=noise, freqs=freqs,
                P=np.full(NB, P0), nu_fit=nu_fit, masks=masks, ir=ir)


@pytest.fixture
def scatter_config():
    keys = ("use_fast_fit", "fit_fused", "scatter_compensated")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def _theta0(log10_tau, tau=0.008, alpha=-4.0):
    th = np.zeros((NB, 5))
    th[:, 1] = 0.0005  # nonzero DM guess: the seeds derotate
    th[:, 3] = np.log10(tau) if log10_tau else tau
    th[:, 4] = alpha
    return th


# ---------------------------------------------------------------------
# (a) Dot2 helpers, float32

@pytest.mark.parametrize("n", [1, 7, 129, 384])
@pytest.mark.parametrize("fn", ["two_product", "pair_sum", "dot2"])
def test_dot2_helpers_f32_bitwise(fn, n):
    """Bit for bit against the JAX helpers run op by op; the odd lengths
    take _pair_sum_df64's padding (384 reaches 3 and pads to 4)."""
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((4, n)) * 1e3).astype(np.float32)
    b = rng.standard_normal((4, n)).astype(np.float32)
    jfn = {"two_product": JP._two_product, "dot2": JP._dot2,
           "pair_sum": lambda x, y: JP._pair_sum_df64(x * y)}[fn]
    tfn = {"two_product": TP._two_product, "dot2": TP._dot2,
           "pair_sum": lambda x, y: TP._pair_sum_df64(x * y)}[fn]
    with jax.disable_jit():
        ref = jfn(jnp.asarray(a), jnp.asarray(b))
    got = tfn(torch.as_tensor(a), torch.as_tensor(b))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if fn == "two_product":
        # p + e is the product exactly
        p, e = got
        np.testing.assert_array_equal(
            p.double() + e.double(), torch.as_tensor(a).double()
            * torch.as_tensor(b).double())
    if fn == "dot2":
        exact = (a.astype(np.float64) * b).sum(-1)
        bound = 2 * np.finfo(np.float32).eps * np.abs(
            a.astype(np.float64) * b).sum(-1)
        assert np.all(np.abs(got[0].numpy() - exact) <= bound)


# ---------------------------------------------------------------------
# (b) the scattering evaluator, float64

@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("log10_tau", [False, True])
def test_cgh_scatter_f64(log10_tau, compensated):
    rng = np.random.default_rng(7)
    nchan, nharm = 16, 64
    Xr = rng.standard_normal((NB, nchan, nharm))
    Xi = rng.standard_normal((NB, nchan, nharm))
    M2 = rng.random((NB, nchan, nharm))
    freqs = np.linspace(1100.0, 1900.0, nchan)
    nu_fit = np.array([1400.0, 1500.0, 1450.0])
    P = np.full(NB, 0.004)
    theta = np.array([[0.01, 0.001, 0.1, -2.3, -4.0],
                      [0.02, -0.001, 0.0, -2.0, -3.5],
                      [-0.1, 0.002, 0.2, -2.5, -4.4]])
    if not log10_tau:
        theta[:, 3] = 10.0 ** theta[:, 3]
    cv, gv = TP._t_coeffs(_t(freqs), _t(P), _t(nu_fit))
    f, g, H, (C, S) = TP._cgh_scatter(
        _t(theta), _t(Xr), _t(Xi), _t(M2), _t(freqs), _t(nu_fit), cv, gv,
        log10_tau, compensated)
    for b in range(NB):
        jcv, jgv = JP._t_coeffs(jnp.asarray(freqs), P[b], nu_fit[b])
        rf, rg, rH, (rC, rS) = JP._cgh_scatter(
            jnp.asarray(theta[b]), jnp.asarray(Xr[b]), jnp.asarray(Xi[b]),
            jnp.asarray(M2[b]), jnp.asarray(freqs), nu_fit[b], jcv, jgv,
            log10_tau, compensated)
        for got, ref in ((f[b], rf), (g[b], rg), (H[b], rH), (C[b], rC),
                         (S[b], rS)):
            assert rel_err(got.numpy(), ref) <= 1e-10


# ---------------------------------------------------------------------
# (c) the prepare stage of the scattering lane

@pytest.mark.parametrize("with_ir", [False, True])
def test_prepare_scatter_fit_real(data, scatter_config, with_ir):
    """B1's want_m2 form (the plain version on the CPU) against the JAX
    fused scan, with the response folded in; the tau-matched seeds
    agree exactly."""
    d = data
    th0 = _theta0(True)
    ir = d["ir"][:, :K] if with_ir else None
    ir_r, ir_i = TP.split_ir_host(ir, torch.float64, "cpu")
    got = TP.prepare_scatter_fit_real(
        _t(d["ports"]), _t(d["model"]), _t(d["noise"]), _t(d["masks"]),
        _t(d["freqs"]), _t(d["P"]), _t(d["nu_fit"]), _t(th0), ir_r, ir_i,
        fit_flags=TP.FitFlags(True, True, False, True, True),
        log10_tau=True, nharm_eff=K, fit_fused=True)
    for b in range(NB):
        jr, ji = JP.split_ir_host(ir, jnp.float64)
        ref = JP.prepare_scatter_fit_real(
            jnp.asarray(d["ports"][b]), jnp.asarray(d["model"]),
            jnp.asarray(d["noise"][b]), jnp.asarray(d["masks"][b]),
            jnp.asarray(d["freqs"]), P0, d["nu_fit"][b],
            jnp.asarray(th0[b]), jr, ji,
            fit_flags=JP.FitFlags(True, True, False, True, True),
            log10_tau=True, nharm_eff=K, fit_fused=True)
        for name, g, r in zip(("Xr", "Xi", "M2w", "Sd", "theta0"), got,
                              ref):
            assert rel_err(g[b].numpy(), r) <= 1e-12, name
        assert float(got[4][b, 0]) == float(ref[4][0])


# ---------------------------------------------------------------------
# (d) the fast scatter batch fit, float64

def _assert_fit_parity(got, ref):
    got = {k: v.numpy() for k, v in got._asdict().items()}
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    assert got["phi"].dtype == np.float64
    dphi = np.abs((got["phi"] - ref["phi"] + 0.5) % 1.0 - 0.5)
    assert np.all(dphi <= 1e-9), dphi
    for k in ("tau", "alpha", "tau_err", "alpha_err", "phi_err", "nu_tau"):
        scale = np.maximum(np.abs(ref[k]), 1e-300)
        assert np.all(np.abs(got[k] - ref[k]) <= 1e-7 * scale), k
    for k in ("DM", "DM_err", "snr"):
        assert rel_err(got[k], ref[k]) <= 1e-7, k
    assert np.all(np.abs(got["chi2"] - ref["chi2"])
                  <= 1e-10 * np.abs(ref["chi2"]))
    np.testing.assert_array_equal(got["dof"], ref["dof"])
    np.testing.assert_array_equal(got["nfeval"], ref["nfeval"])
    np.testing.assert_array_equal(got["return_code"], ref["return_code"])
    assert rel_err(got["scales"], ref["scales"]) <= 1e-7
    assert rel_err(got["covariance"], ref["covariance"]) <= 1e-7


FAST_CASES = {
    "tau_alpha": dict(flags=(1, 1, 0, 1, 1)),
    "fix_alpha": dict(flags=(1, 1, 0, 1, 0)),
    "no_DM": dict(flags=(1, 0, 0, 1, 1)),
}


@pytest.mark.parametrize("case,log10_tau,compensated", [
    ("tau_alpha", True, False), ("tau_alpha", False, False),
    ("tau_alpha", True, True), ("fix_alpha", True, False),
    ("fix_alpha", False, True)])
def test_fast_scatter_fit_f64(data, scatter_config, case, log10_tau,
                              compensated):
    """The flag x log10 x compensated lattice, thinned to five corners
    that cover each value of each axis (every JAX program compiles)."""
    _run_fast(data, FAST_CASES[case]["flags"], log10_tau, compensated)


@pytest.mark.parametrize("variant", ["bounded", "ir", "no_DM",
                                     "full_spectrum", "unfused"])
def test_fast_scatter_fit_variants_f64(data, scatter_config, variant):
    """A log10-tau bound the fits converge onto (return code 0 or 1 as
    in the JAX package), the response, DM fixed, no harmonic window,
    the unfused DFTs."""
    kw = {}
    flags = (1, 1, 0, 1, 1)
    if variant == "bounded":
        b = np.tile([-np.inf, np.inf], (5, 1))
        b[3] = (-2.5, -1.9)
        kw["bounds"] = b
    elif variant == "ir":
        kw["ir_FT"] = data["ir"]
    elif variant == "no_DM":
        flags = FAST_CASES["no_DM"]["flags"]
    elif variant == "full_spectrum":
        kw["window"] = False
    else:
        jcfg.fit_fused = tcfg.fit_fused = False
    got = _run_fast(data, flags, True, False, **kw)
    if variant == "bounded":
        assert np.any(got.return_code.numpy() == 0)


def _run_fast(data, flags, log10_tau, compensated, window=K, **kw):
    d = data
    jcfg.scatter_compensated = tcfg.scatter_compensated = compensated
    th0 = _theta0(log10_tau)
    ref = JP.fit_portrait_batch_fast(
        jnp.asarray(d["ports"]), d["model"], jnp.asarray(d["noise"]),
        jnp.asarray(d["freqs"]), jnp.asarray(d["P"]),
        jnp.asarray(d["nu_fit"]), theta0=jnp.asarray(th0),
        fit_flags=JP.FitFlags(*map(bool, flags)),
        chan_masks=jnp.asarray(d["masks"]), harmonic_window=window,
        log10_tau=log10_tau, **kw)
    got = TP.fit_portrait_batch_fast(
        d["ports"], d["model"], d["noise"], d["freqs"], d["P"], d["nu_fit"],
        theta0=th0, fit_flags=TP.FitFlags(*map(bool, flags)),
        chan_masks=d["masks"], harmonic_window=window, log10_tau=log10_tau,
        device="cpu", **kw)
    _assert_fit_parity(got, ref)
    return got


def test_fast_lane_routing(data, scatter_config):
    """use_scatter=False with a response is an error; a fixed tau seed
    on the no-scatter path is refused (the JAX package's rules)."""
    d = data
    args = (d["ports"], d["model"], d["noise"], d["freqs"], d["P"],
            d["nu_fit"])
    with pytest.raises(ValueError, match="scatter"):
        TP.fit_portrait_batch_fast(*args, ir_FT=d["ir"], use_scatter=False,
                                   device="cpu")
    with pytest.raises(ValueError, match="tau"):
        TP.fit_portrait_batch_fast(*args, theta0=_theta0(False),
                                   use_scatter=False, device="cpu")
    assert TP.derive_use_scatter((1, 1, 0, 0, 0), False, _theta0(False))
    assert not TP.derive_use_scatter((1, 1, 0, 0, 0), False, None)


# ---------------------------------------------------------------------
# (e) the complex engine, float64

COMPLEX_CASES = {
    "tau_alpha_log10": dict(flags=(1, 1, 0, 1, 1), log10_tau=True),
    "tau_alpha_linear": dict(flags=(1, 1, 0, 1, 1), log10_tau=False),
    "fix_alpha_log10": dict(flags=(1, 1, 0, 1, 0), log10_tau=True),
    "compensated": dict(flags=(1, 1, 0, 1, 1), log10_tau=True,
                        compensated=True),
    "no_scatter": dict(flags=(1, 1, 0, 0, 0), tau=0.0),
    "GM": dict(flags=(1, 1, 1, 0, 0), tau=0.0),
    "phase_only_log10_seed": dict(flags=(1, 0, 0, 0, 0), log10_tau=True),
    "ir_scatter": dict(flags=(1, 1, 0, 1, 1), log10_tau=True, ir=True),
    "ir_no_scatter": dict(flags=(1, 1, 0, 0, 0), tau=0.0, ir=True),
    "bounded": dict(flags=(1, 1, 0, 0, 0), tau=0.0, bounded=True),
}


@pytest.mark.parametrize("case", sorted(COMPLEX_CASES))
def test_complex_engine_batch_f64(data, scatter_config, case):
    c = COMPLEX_CASES[case]
    d = data
    log10_tau = c.get("log10_tau", False)
    jcfg.scatter_compensated = tcfg.scatter_compensated = \
        c.get("compensated", False)
    th0 = _theta0(log10_tau, tau=c.get("tau", 0.008))
    kw = {}
    if c.get("ir"):
        kw["ir_FT"] = d["ir"]
    if c.get("bounded"):
        b = np.tile([-np.inf, np.inf], (5, 1))
        b[1] = (-0.01, 0.0015)
        kw["bounds"] = b
    flags = tuple(map(bool, c["flags"]))
    ref = JP.fit_portrait_batch(
        jnp.asarray(d["ports"]),
        jnp.asarray(np.broadcast_to(d["model"], d["ports"].shape)),
        jnp.asarray(d["noise"]), jnp.asarray(d["freqs"]),
        jnp.asarray(d["P"]), jnp.asarray(d["nu_fit"]),
        theta0=jnp.asarray(th0), fit_flags=JP.FitFlags(*flags),
        chan_masks=jnp.asarray(d["masks"]), log10_tau=log10_tau, **kw)
    # the port keeps the shared template 2-D
    got = TP.fit_portrait_batch(
        d["ports"], d["model"], d["noise"], d["freqs"], d["P"],
        d["nu_fit"], theta0=th0, fit_flags=TP.FitFlags(*flags),
        chan_masks=d["masks"], log10_tau=log10_tau, device="cpu", **kw)
    _assert_fit_parity(got, ref)


@pytest.mark.parametrize("kw", [
    dict(), dict(fit_flags=(1, 1, 0, 1, 1), tau0=0.01, log10_tau=True),
    dict(fit_flags=(1, 1, 0, 1, 0), tau0=0.01, phi0=0.01, nu_out=1400.0)],
    ids=["no_scatter", "scatter_log10", "fixed_alpha_phi0_nu_out"])
def test_fit_portrait_f64(data, scatter_config, kw):
    d = data
    jkw = dict(kw)
    tkw = dict(kw)
    if "fit_flags" in kw:
        jkw["fit_flags"] = JP.FitFlags(*map(bool, kw["fit_flags"]))
        tkw["fit_flags"] = TP.FitFlags(*map(bool, kw["fit_flags"]))
    ref = JP.fit_portrait(jnp.asarray(d["ports"][1]),
                          jnp.asarray(d["model"]),
                          jnp.asarray(d["noise"][1]),
                          jnp.asarray(d["freqs"]), P0, **jkw)
    got = TP.fit_portrait(d["ports"][1], d["model"], d["noise"][1],
                          d["freqs"], P0, device="cpu", **tkw)
    assert got.phi.dim() == 0
    assert abs(float(got.phi) - float(ref.phi)) <= 1e-9
    for k in ("tau", "alpha", "DM", "phi_err", "tau_err"):
        r = float(getattr(ref, k))
        assert abs(float(getattr(got, k)) - r) <= 1e-7 * max(abs(r), 1e-300)
    assert int(got.nfeval) == int(ref.nfeval)
    assert int(got.return_code) == int(ref.return_code)


def test_chi2_prime_f64(data):
    d = data
    th = _theta0(True)
    th[:, 0] = 0.01
    dFT = np.fft.rfft(d["ports"], axis=-1)
    mFT = np.fft.rfft(d["model"], axis=-1)
    w = np.asarray(JP.make_weights(jnp.asarray(d["noise"]), NBIN,
                                   jnp.asarray(d["masks"])))
    got = TP.chi2_prime(_t(th), _t(dFT), _t(mFT), _t(w), _t(d["freqs"]),
                        _t(d["P"]), _t(d["nu_fit"]), _t(d["ir"] + 0j),
                        log10_tau=True)
    for b in range(NB):
        ref = JP.chi2_prime(jnp.asarray(th[b]), jnp.asarray(dFT[b]),
                            jnp.asarray(mFT), jnp.asarray(w[b]),
                            jnp.asarray(d["freqs"]), P0, d["nu_fit"][b],
                            ir_FT=jnp.asarray(d["ir"] + 0j), log10_tau=True)
        assert abs(float(got[b]) - float(ref)) <= 1e-12 * abs(float(ref))


# ---------------------------------------------------------------------
# (f) tau seeds, the instrumental response, the scattering kernels

@pytest.mark.parametrize("masked,per_element", [(False, False),
                                                (True, False), (True, True)])
def test_estimate_tau_batch_f64(data, masked, per_element):
    d = data
    models = (np.broadcast_to(d["model"], d["ports"].shape).copy()
              if per_element else d["model"])
    masks = d["masks"] if masked else None
    ref = np.asarray(JP.estimate_tau_batch(
        jnp.asarray(d["ports"]), jnp.asarray(models),
        jnp.asarray(d["noise"]),
        None if masks is None else jnp.asarray(masks)))
    got = TP.estimate_tau_batch(_t(d["ports"]), _t(models), _t(d["noise"]),
                                None if masks is None else _t(masks))
    assert got.dtype == torch.float64
    assert np.all(np.abs(got.numpy() - ref) <= 1e-10 * np.abs(ref))
    one = TP.estimate_tau(_t(d["ports"][0]), _t(d["model"]),
                          _t(d["noise"][0]))
    assert one.dim() == 0


@pytest.mark.parametrize("spec", [
    dict(widths=(0.01,), kinds=("rect",)),
    dict(widths=(0.02,), kinds=("gauss",)),
    dict(widths=(0.01, 0.005), kinds=("rect", "gauss"), DM_smear=30.0),
    dict(DM_smear=100.0)], ids=["rect", "gauss", "both_dm", "dm_only"])
def test_instrumental_response_port_FT(spec):
    freqs = np.linspace(1150.0, 1850.0, NCHAN)
    kw = dict(spec)
    if "DM_smear" in kw:
        kw.update(chan_bw=43.75, P=P0)
    ref = np.asarray(JG.instrumental_response_port_FT(
        NBIN // 2 + 1, jnp.asarray(freqs), **kw))
    got = TG.instrumental_response_port_FT(NBIN // 2 + 1, _t(freqs), **kw)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert rel_err(got.numpy(), ref) <= 1e-12
    with pytest.raises(ValueError, match="kind"):
        TG.instrumental_response_FT(0.01, 8, kind="box")


def _crel(got, ref):
    """max |got - ref| / max |ref| of complex (or real) arrays."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                   1e-300))


def test_scattering_kernels():
    taus = np.linspace(0.0, 0.05, NCHAN)
    for jf, tf, arg in (
            (JS.scattering_profile_FT, TS.scattering_profile_FT, 0.013),
            (JS.scattering_profile_FT_dtau, TS.scattering_profile_FT_dtau,
             0.013),
            (JS.scattering_portrait_FT, TS.scattering_portrait_FT, taus),
            (JS.scattering_portrait_FT_dtau, TS.scattering_portrait_FT_dtau,
             taus)):
        ref = np.asarray(jf(jnp.asarray(np.asarray(arg, np.float64)), 129))
        got = tf(_t(arg), 129).numpy()
        assert got.dtype == np.complex128
        assert _crel(got, ref) <= 1e-12
    for tau in (0.0, 0.02):
        ref = np.asarray(JS.scattering_kernel_time(jnp.asarray(tau), NBIN))
        assert rel_err(TS.scattering_kernel_time(tau, NBIN).numpy(),
                       ref) <= 1e-12
    rng = np.random.default_rng(3)
    port = rng.standard_normal((NCHAN, NBIN))
    ref = np.asarray(JS.add_scattering(jnp.asarray(port), jnp.asarray(taus)))
    assert rel_err(TS.add_scattering(_t(port), _t(taus)).numpy(),
                   ref) <= 1e-12
    assert math.isclose(float(TS.scattering_kernel_time(0.02, NBIN).sum()),
                        1.0, rel_tol=1e-12)


# ---------------------------------------------------------------------
# the forger's dithered sub-byte quantizer

def test_dither_removes_2bit_quantizer_bias(tmp_path, scatter_config):
    """A 4-level quantizer spanning each row's range bends a high-S/N
    scattered profile, and a scattering fit reads the bend as tau;
    rectangular dither (make_fake_pulsar(dither=True)) makes each
    sample's mean the profile.  The same scattered 2-bit data, fitted by
    the port's stream lane: without dither the tau and phi pulls exceed
    5 sigma, with it they stay under 3."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.pipeline.stream import (
        stream_wideband_TOAs)
    from pulseportraiture_tpu_torch.synth import make_fake_pulsar
    from pulseportraiture_tpu_torch.utils.mjd import MJD
    from test_torch_helpers import PAR

    model = default_test_model(1500.0)
    gmodel = str(tmp_path / "m.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    phi, ddm, t_scat = 0.0123, 2e-4, 4e-5
    pulls = {}
    for dither in (False, True):
        path = str(tmp_path / f"d{int(dither)}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=128,
                         nbin=1024, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=phi, dDM=ddm, t_scat=t_scat, alpha=-4.0,
                         start_MJD=MJD(55400, 0.1), noise_stds=0.5,
                         dedispersed=False, quiet=True,
                         rng=np.random.default_rng(11), nbit=2,
                         dither=dither, device="cpu")
        res = stream_wideband_TOAs([path], gmodel, nsub_batch=4,
                                   device="cpu", quiet=True, fit_scat=True,
                                   scat_guess="auto", print_phase=True)
        pulls[dither] = []
        for t in res.TOA_list:
            f = t.flags
            nu = t.frequency
            exp_phi = (phi + Dconst * (PAR["DM"] + ddm) * nu**-2.0 / P0
                       - Dconst * PAR["DM"] * 1500.0**-2.0 / P0)
            dphi = (f["phs"] - exp_phi + 0.5) % 1.0 - 0.5
            # tau re-referenced to 1500 MHz, its sigma with alpha's
            r = (1500.0 / f["scat_ref_freq"]) ** f["scat_ind"]
            tau = f["scat_time"] * r
            s_tau = math.hypot(
                f["scat_time"] * math.log(10.0) * f["log10_scat_time_err"]
                * r, tau * math.log(1500.0 / f["scat_ref_freq"])
                * f["scat_ind_err"])
            pulls[dither].append((dphi / f["phs_err"],
                                  (tau - t_scat * 1e6) / s_tau))
    assert all(abs(p) > 5.0 for pair in pulls[False] for p in pair)
    assert all(abs(p) < 3.0 for pair in pulls[True] for p in pair)

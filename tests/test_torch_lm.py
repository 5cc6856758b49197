"""The PyTorch port's LM engines and Gaussian template fits on the CPU,
against the JAX package, in float64: ops.gaussian, models.gaussian's
Jacobian pieces, fit.lm (single and batched, with compaction), fit.gauss
(the analytic Jacobians, the trial machinery) and fit.powlaw.

The problems are tests/test_gauss_fit.py's and tests/test_lm_batched.py's.
Gates:
- the ops: 1e-12 x max|ref|;
- the single-problem engine against JAX's: x within 1e-8 relative to
  max|x| (1e-8 absolute for parameters near 0), success, stalled and
  nfev equal;
- the port's batched engine against its serial one, and compacted
  chunks against one dispatch: 1e-10 (the same arithmetic row by row,
  the blocking and compaction exact by construction);
- the analytic Jacobians against torch.func.jacfwd: 1e-10 x the
  Jacobian's scale;
- the trial pipeline: the same selected ngauss, parameters within 1e-6
  x their errors.
"""

import importlib

import numpy as np
import pytest
import torch

from test_torch_helpers import rel_err

import jax.numpy as jnp

from pulseportraiture_tpu.fit import gauss as JG
from pulseportraiture_tpu.fit import lm as JL
from pulseportraiture_tpu.models import gaussian as JM
from pulseportraiture_tpu.ops import gaussian as JO
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.fit import gauss as TG
from pulseportraiture_tpu_torch.fit import lm as TL
from pulseportraiture_tpu_torch.models import gaussian as TM
from pulseportraiture_tpu_torch.ops import gaussian as TO

# the fit packages export a function named powlaw, which shadows the
# module as an attribute
JPL = importlib.import_module("pulseportraiture_tpu.fit.powlaw")
TPL = importlib.import_module("pulseportraiture_tpu_torch.fit.powlaw")

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x, float), dtype=F64)


# --------------------------------------------------------------------------
# ops and model pieces

def test_gaussian_profile_and_function():
    for loc, wid, amp in ((0.3, 0.05, 1.2), (0.98, 0.1, 0.5), (0.0, -0.04,
                                                                2.0)):
        ref = np.asarray(JO.gaussian_profile(128, loc, wid, amp))
        got = TO.gaussian_profile(128, loc, wid, amp).numpy()
        assert rel_err(got, ref) <= 1e-12
    xs = np.linspace(-1.0, 2.0, 301)
    for norm in (False, True):
        ref = np.asarray(JO.gaussian_function(xs, 0.4, 0.2, norm=norm))
        got = TO.gaussian_function(xs, 0.4, 0.2, norm=norm).numpy()
        assert rel_err(got, ref) <= 1e-12


def test_gaussian_profile_FT_jac():
    """Every block, including sign(wid) at wid = 0 (+1, the JAX
    package's autodiff convention) and a negative width."""
    loc = np.array([0.2, 0.6, 0.9])[:, None]
    wid = np.array([0.03, 0.0, -0.05])[:, None]
    amp = np.array([1.0, 0.7, 0.0])[:, None]
    ref = JO.gaussian_profile_FT_jac(33, jnp.asarray(loc), jnp.asarray(wid),
                                     jnp.asarray(amp))
    got = TO.gaussian_profile_FT_jac(33, _t(loc), _t(wid), _t(amp))
    for r, g in zip(ref, got):
        assert rel_err(g.numpy(), np.asarray(r)) <= 1e-12


def _params(ngauss, rng):
    return {"dc": 0.03, "tau": 0.0, "alpha": -4.0,
            "locs": rng.uniform(0.2, 0.8, ngauss),
            "mlocs": rng.uniform(-0.02, 0.02, ngauss),
            "wids": rng.uniform(0.02, 0.06, ngauss),
            "mwids": rng.uniform(-0.3, 0.3, ngauss),
            "amps": rng.uniform(0.5, 2.0, ngauss),
            "mamps": rng.uniform(-1.5, 0.5, ngauss)}


@pytest.mark.parametrize("code", ["000", "111", "010"])
def test_gaussian_components_FT_jac(code):
    rng = np.random.default_rng(3)
    p = _params(3, rng)
    freqs = np.linspace(1200.0, 1800.0, 8)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    ref_F, ref_d = JM.gaussian_components_FT_jac(pj, jnp.asarray(freqs),
                                                 1500.0, 65, code)
    got_F, got_d = TM.gaussian_components_FT_jac(pt, _t(freqs), 1500.0, 65,
                                                 code)
    assert rel_err(got_F.numpy(), np.asarray(ref_F)) <= 1e-12
    assert set(got_d) == set(ref_d)
    for k in ref_d:
        assert rel_err(got_d[k].numpy(), np.asarray(ref_d[k])) <= 1e-12, k
    ref = JM.gaussian_components_FT(pj, jnp.asarray(freqs), 1500.0, 65, code)
    got = TM.gaussian_components_FT(pt, _t(freqs), 1500.0, 65, code)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-12


@pytest.mark.parametrize("digit", ["0", "1"])
def test_evolution_grads(digit):
    v, m = np.array([0.3, 1.2]), np.array([-0.4, 0.02])
    f = np.linspace(1100.0, 1900.0, 5)[:, None]
    ref = JM._EVOLUTION_GRADS[digit](jnp.asarray(v), jnp.asarray(m),
                                     jnp.asarray(f), 1500.0)
    got = TM._EVOLUTION_GRADS[digit](_t(v), _t(m), _t(f), 1500.0)
    for r, g in zip(ref, got):
        assert rel_err(g.numpy(), np.asarray(r)) <= 1e-12
    ref = JM.evolve_parameter(jnp.asarray(v), jnp.asarray(m), jnp.asarray(f),
                              1500.0, digit)
    got = TM.evolve_parameter(_t(v), _t(m), _t(f), 1500.0, digit)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-12


def test_apply_scattering_FT_and_model_from_params():
    rng = np.random.default_rng(4)
    pFT = rng.standard_normal((6, 33)) + 1j * rng.standard_normal((6, 33))
    freqs = np.linspace(1200.0, 1800.0, 6)
    ref = JM.apply_scattering_FT(jnp.asarray(pFT), 0.01, -4.0,
                                 jnp.asarray(freqs), 1500.0)
    got = TM.apply_scattering_FT(torch.as_tensor(pFT), 0.01, -4.0,
                                 _t(freqs), 1500.0)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-12
    from pulseportraiture_tpu.synth import default_test_model

    model = default_test_model(1500.0)
    ref = np.asarray(JM.model_from_params(model, freqs, 128, P=0.004))
    tmodel = TM.GaussianModel(**{k: getattr(model, k) for k in (
        "name", "code", "nu_ref", "dc", "tau", "alpha", "locs", "wids",
        "amps", "mlocs", "mwids", "mamps")})
    got = TM.model_from_params(tmodel, freqs, 128, P=0.004,
                               device="cpu").numpy()
    assert rel_err(got, ref) <= 1e-12


# --------------------------------------------------------------------------
# the single-problem engine against JAX's (tests/test_gauss_fit.py TestLM)

def _j_rosenbrock(x):
    return jnp.array([10.0 * (x[1] - x[0] ** 2.0), 1.0 - x[0]])


def _t_rosenbrock(x):
    return torch.stack([10.0 * (x[..., 1] - x[..., 0] ** 2.0),
                        1.0 - x[..., 0]], dim=-1)


def _j_linear(x, t, y, s):
    return (y - (x[0] + x[1] * t)) / s


def _t_linear(x, t, y, s):
    return (y - (x[..., :1] + x[..., 1:2] * t)) / s


def _j_shift(x):
    return x - 2.0


def _t_shift(x):
    return x - 2.0


def _lm_cases():
    rng = np.random.default_rng(42)
    t = np.linspace(0, 1, 50)
    y = 2.0 + 3.0 * t + 0.1 * rng.normal(size=50)
    s = np.full(50, 0.1)
    return {
        "rosenbrock": ((_j_rosenbrock, _t_rosenbrock), np.array([-1.2, 1.0]),
                       (), dict(max_iter=200)),
        "linear_with_errors": ((_j_linear, _t_linear), np.zeros(2),
                               (t, y, s), {}),
        "bounds_respected": ((_j_shift, _t_shift), np.array([0.0]), (),
                             dict(upper=np.array([1.0]), max_iter=100)),
        "vary_mask_freezes": ((_j_rosenbrock, _t_rosenbrock),
                              np.array([-1.2, 1.0]), (),
                              dict(vary=np.array([False, True]),
                                   max_iter=100)),
    }


@pytest.mark.parametrize("name", sorted(_lm_cases()))
@pytest.mark.parametrize("jac", ["ad"])
def test_lm_matches_jax(name, jac, monkeypatch):
    (jf, tf), x0, aux, kw = _lm_cases()[name]
    monkeypatch.setattr(tcfg, "lm_jacobian", jac)
    ref = JL.levenberg_marquardt(jf, x0, aux=aux, **kw)
    got = TL.levenberg_marquardt(tf, x0, aux=aux, device="cpu", **kw)
    xr, xg = np.asarray(ref.x), got.x.numpy()
    assert np.max(np.abs(xg - xr)) <= 1e-8 * max(np.max(np.abs(xr)), 1.0)
    assert bool(got.success) == bool(ref.success)
    assert bool(got.stalled) == bool(ref.stalled)
    assert int(got.nfev) == int(ref.nfev)
    er, eg = np.asarray(ref.x_err), got.x_err.numpy()
    assert np.max(np.abs(eg - er)) <= 1e-6 * max(np.max(np.abs(er)), 1e-300)
    if name == "vary_mask_freezes":
        assert float(got.x[0]) == -1.2 and float(got.x_err[0]) == 0.0


def _j_zero(x):
    return jnp.ones(3) + 0.0 * x[0]


def _t_zero(x):
    return torch.ones(x.shape[:-1] + (3,), dtype=x.dtype) + 0.0 * x[..., :1]


def test_singular_system_like_jax(monkeypatch):
    """A residual that does not depend on its parameters: J = 0, so the
    damped system and the final J^T J are singular.  jnp.linalg.solve
    and inv return non-finite values; the port's solve_ex / inv_ex do
    the same and nothing raises."""
    monkeypatch.setattr(tcfg, "lm_jacobian", "ad")
    x0 = np.array([0.5, -1.0])
    ref = JL.levenberg_marquardt(_j_zero, x0)
    got = TL.levenberg_marquardt(_t_zero, x0, device="cpu")
    assert np.array_equal(got.x.numpy(), np.asarray(ref.x))
    assert np.array_equal(np.isfinite(got.x_err.numpy()),
                          np.isfinite(np.asarray(ref.x_err)))
    assert int(got.nfev) == int(ref.nfev)
    assert bool(got.success) == bool(ref.success)
    # a batch with one singular row and one regular row: the singular
    # row does not poison its neighbour
    target = torch.tensor([0.4, 1.6], dtype=F64)

    def mixed(x, w):
        return w * (x - target) + (1.0 - w) * (1.0 + 0.0 * x)

    out = TL.levenberg_marquardt_batched(
        mixed, np.array([[0.0, 0.0], [0.0, 0.0]]),
        aux=(np.array([[1.0, 1.0], [0.0, 0.0]]),), device="cpu")
    assert np.allclose(out.x.numpy()[0], target.numpy(), atol=1e-12)
    assert bool(out.success[0]) and np.all(np.isfinite(
        out.x_err.numpy()[0]))


# --------------------------------------------------------------------------
# batched engine (tests/test_lm_batched.py)

def _t_quad(x, t, y, s):
    return (y - (x[..., :1] + x[..., 1:2] * t + x[..., 2:3] * t ** 2)) / s


def _j_quad(x, t, y, s):
    return (y - (x[0] + x[1] * t + x[2] * t ** 2)) / s


@pytest.mark.parametrize("jac", ["auto", "ad"])
def test_batched_vs_serial_mixed_bounds_vary(jac, monkeypatch):
    """Every bound kind (free / lower / upper / two-sided) and a
    per-problem vary mask: the port's batched engine against its serial
    one <= 1e-10, and the serial one against JAX's <= 1e-8."""
    monkeypatch.setattr(tcfg, "lm_jacobian", jac)
    rng = np.random.default_rng(42)
    B, npts = 6, 40
    t = np.linspace(0.0, 1.0, npts)
    ys, x0s, vs, los, his = [], [], [], [], []
    for b in range(B):
        ys.append((1.0 + b) + (2.0 + 0.5 * b) * t + 0.4 * t ** 2
                  + 0.05 * rng.normal(size=npts))
        los.append([-np.inf, 0.0 if b % 2 else -np.inf, -1.0])
        his.append([np.inf if b % 3 else 10.0, np.inf, 1.0])
        vs.append([True, True, b % 2 == 0])
        x0s.append([0.0, 1.0, 0.4])
    s = np.full(npts, 0.05)
    aux = (np.stack([t] * B), np.stack(ys), np.stack([s] * B))
    res = TL.levenberg_marquardt_batched(
        _t_quad, np.array(x0s), aux=aux, lower=np.array(los),
        upper=np.array(his), vary=np.array(vs), device="cpu")
    for b in range(B):
        one = TL.levenberg_marquardt(
            _t_quad, np.array(x0s[b]), aux=(t, ys[b], s), lower=los[b],
            upper=his[b], vary=np.array(vs[b]), device="cpu")
        for f in ("x", "x_err", "chi2", "dof", "nfev"):
            got = getattr(res, f)[b].double().numpy()
            want = getattr(one, f).double().numpy()
            assert np.max(np.abs(got - want)) <= 1e-10, (b, f)
        assert bool(res.success[b]) == bool(one.success)
        # against JAX: the same minimum (a near-threshold stop test may
        # flip by an ulp between two programs, moving the stop by one
        # polishing step, as tests/test_lm_batched.py allows)
        ref = JL.levenberg_marquardt(_j_quad, np.array(x0s[b]),
                                     aux=(t, ys[b], s), lower=los[b],
                                     upper=his[b], vary=np.array(vs[b]))
        assert np.max(np.abs(one.x.numpy() - np.asarray(ref.x))) <= 1e-8
        assert float(one.chi2) == pytest.approx(float(ref.chi2), rel=1e-12)


def _straggler_problem():
    rng = np.random.default_rng(42)
    npts = 30
    t = np.linspace(0.0, 2.0, npts)
    s = np.full(npts, 0.02)
    y_easy = 2.0 - 1.0 * t + 0.1 * t ** 2 + 0.02 * rng.normal(size=npts)
    y_hard = 5.0 + 3.0 * t - 0.8 * t ** 2 + 0.02 * rng.normal(size=npts)
    return t, s, y_easy, y_hard


def test_straggler_leaves_finished_rows_untouched():
    """One far-seeded problem shares the loop with an easy one; the easy
    row's result equals its standalone fit, nfev exactly (a done row
    holds its state through torch.where), the values to 1e-12 (a batch
    of another width may associate a reduction differently)."""
    t, s, y_easy, y_hard = _straggler_problem()
    x_easy, x_hard = np.array([2.0, -1.0, 0.1]), np.array([-50.0, 40.0,
                                                           -20.0])
    alone = TL.levenberg_marquardt(_t_quad, x_easy, aux=(t, y_easy, s),
                                   device="cpu")
    rb = TL.levenberg_marquardt_batched(
        _t_quad, np.stack([x_easy, x_hard]),
        aux=(np.stack([t, t]), np.stack([y_easy, y_hard]),
             np.stack([s, s])), device="cpu")
    assert int(rb.nfev[1]) > int(rb.nfev[0])
    assert int(rb.nfev[0]) == int(alone.nfev)
    for f in ("x", "x_err", "chi2"):
        assert torch.max(torch.abs(getattr(rb, f)[0]
                                   - getattr(alone, f))) <= 1e-12, f
    assert np.allclose(rb.x[1].numpy(), [5.0, 3.0, -0.8], atol=0.2)
    # the same against JAX's batched engine
    ref = JL.levenberg_marquardt_batched(
        _j_quad, np.stack([x_easy, x_hard]),
        aux=(np.stack([t, t]), np.stack([y_easy, y_hard]),
             np.stack([s, s])))
    assert np.array_equal(rb.nfev.numpy(), np.asarray(ref.nfev))
    assert np.max(np.abs(rb.x.numpy() - np.asarray(ref.x))) <= 1e-8


def _two_component_profile(nbin=128, seed=42):
    rng = np.random.default_rng(seed)
    grid = np.arange(nbin) / nbin
    d1 = np.mod(grid - 0.3 + 0.5, 1.0) - 0.5
    d2 = np.mod(grid - 0.45 + 0.5, 1.0) - 0.5
    return (2.0 * np.exp(-4 * np.log(2) * (d1 / 0.05) ** 2)
            + 0.8 * np.exp(-4 * np.log(2) * (d2 / 0.03) ** 2)
            + 0.03 * rng.standard_normal(nbin))


@pytest.mark.parametrize("K,min_rows", [(8, 2), (3, 1), (16, 1)])
def test_compacted_chunks_equal_one_dispatch(K, min_rows):
    """The breadth-first trials of a two-component profile (ngauss 1..4:
    their iteration counts straggle) in chunks of K with compaction
    against one dispatch: the same trajectories (nfev, success equal)
    and every value within 1e-12.  The split at an iteration boundary
    is exact; re-batching a row into a narrower batch may associate
    some reductions differently (pocketfft's multi-row path here,
    library heuristics on the card), ~1e-15 measured, which the JAX
    package's own compaction test allows too (1e-12)."""
    prof = _two_component_profile()
    seeds = TG.profile_trial_seeds(prof, 4, noise=0.03)
    x0s = np.stack([TG.pad_profile_params(sd, 4)[0] for sd in seeds])
    varys = np.stack([TG.profile_vary(g + 1, 4) for g in range(4)])
    lower, upper = TG.profile_bounds(4, len(prof))
    aux = (np.broadcast_to(prof, (4, len(prof))), np.full((4, len(prof)),
                                                         0.03))
    kw = dict(aux=aux, lower=lower, upper=upper, vary=varys,
              jacobian=TG._profile_resid_jac, device="cpu")
    whole = TL.levenberg_marquardt_batched(TG._profile_resid, x0s, **kw)
    TL.reset_lm_stats()
    comp = TL.levenberg_marquardt_batched(
        TG._profile_resid, x0s, compact_every=K, compact_min_rows=min_rows,
        **kw)
    nf = whole.nfev.numpy()
    assert nf.max() > nf.min() + K  # the trials really straggle
    assert min(TL.lm_stats()[-1]["classes"]) < 4
    assert torch.equal(comp.success, whole.success)
    assert torch.equal(comp.nfev, whole.nfev)
    for f in ("x", "x_err", "chi2", "dof"):
        assert torch.max(torch.abs(getattr(comp, f)
                                   - getattr(whole, f))) <= 1e-12, f


def test_nfev_success_per_problem():
    t = np.linspace(0.0, 2.0, 30)
    s = np.full(30, 0.02)
    y = 2.0 + 1.0 * t + 0.3 * t ** 2
    good, bad = np.array([2.0, 1.0, 0.3]), np.array([-200.0, 150.0, -90.0])
    aux = (np.stack([t, t]), np.stack([y, y]), np.stack([s, s]))
    rb = TL.levenberg_marquardt_batched(_t_quad, np.stack([good, bad]),
                                        aux=aux, max_iter=3, device="cpu")
    assert bool(rb.success[0]) and not bool(rb.success[1])
    assert int(rb.nfev[1]) >= 3
    ref = JL.levenberg_marquardt_batched(_j_quad, np.stack([good, bad]),
                                         aux=aux, max_iter=3)
    assert np.array_equal(rb.nfev.numpy(), np.asarray(ref.nfev))
    assert np.array_equal(rb.success.numpy(), np.asarray(ref.success))
    frozen = TL.levenberg_marquardt_batched(
        _t_quad, np.stack([good, good]), aux=aux,
        vary=np.stack([np.ones(3, bool), np.zeros(3, bool)]), device="cpu")
    assert int(frozen.nfev[1]) <= 2
    assert np.all(frozen.x[1].numpy() == good)


def test_x0_must_be_2d():
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        TL.levenberg_marquardt_batched(_t_quad, np.zeros(3), device="cpu")


def test_knobs_strict(monkeypatch):
    assert TL.resolve_lm_jacobian(TG._profile_resid_jac, "auto") \
        is TG._profile_resid_jac
    assert TL.resolve_lm_jacobian(TG._profile_resid_jac, "ad") is None
    with pytest.raises(ValueError, match="analytic"):
        TL.resolve_lm_jacobian(None, "analytic")
    monkeypatch.setattr(tcfg, "lm_jacobian", "sometimes")
    with pytest.raises(ValueError, match="lm_jacobian"):
        TL.use_lm_jacobian()
    assert TG.use_gauss_device(True, "cpu") is True
    assert TG.use_gauss_device("auto", "cpu") is False
    with pytest.raises(ValueError, match="gauss_device"):
        TG.use_gauss_device("sometimes", "cpu")
    assert TL.resolve_compact_every(TL.COMPACT_EVERY_CONFIG) == \
        tcfg.lm_compact_every
    with pytest.raises(ValueError):
        TL.resolve_compact_every(0)


# --------------------------------------------------------------------------
# Gaussian fits

def test_fit_gaussian_profile_matches_jax():
    rng = np.random.default_rng(42)
    nbin = 512
    truth = np.array([0.05, 0.0, 0.30, 0.04, 1.0, 0.55, 0.02, 0.6])
    prof = np.asarray(JG.gen_gaussian_profile_flat(truth, nbin))
    got_prof = TG.gen_gaussian_profile_flat(truth, nbin, device="cpu")
    assert rel_err(got_prof.numpy(), prof) <= 1e-12
    data = prof + 0.01 * rng.normal(size=nbin)
    x0 = np.array([0.0, 0.0, 0.28, 0.05, 0.8, 0.57, 0.03, 0.5])
    ref = JG.fit_gaussian_profile(data, x0, 0.01)
    got = TG.fit_gaussian_profile(data, x0, 0.01, device="cpu")
    assert np.all(np.abs(got.fitted_params - ref.fitted_params)
                  <= 1e-6 * np.where(ref.fit_errs > 0, ref.fit_errs, 1e-12))
    assert got.chi2 == pytest.approx(ref.chi2, rel=1e-9)
    assert got.dof == ref.dof
    # scattering, seeded at the tau bound
    truth = np.array([0.0, 12.0, 0.5, 0.03, 1.0])
    data = np.asarray(JG.gen_gaussian_profile_flat(truth, nbin)) \
        + 0.005 * rng.normal(size=nbin)
    x0 = np.array([0.0, 0.0, 0.49, 0.035, 0.9])
    ref = JG.fit_gaussian_profile(data, x0, 0.005, fit_scattering=True)
    got = TG.fit_gaussian_profile(data, x0, 0.005, fit_scattering=True,
                                  device="cpu")
    assert np.all(np.abs(got.fitted_params - ref.fitted_params)
                  <= 1e-6 * ref.fit_errs)


@pytest.mark.parametrize("join", [False, True])
def test_fit_gaussian_portrait_matches_jax(join):
    rng = np.random.default_rng(42)
    nchan, nbin = 32, 256
    freqs = np.linspace(1300.0, 1700.0, nchan)
    truth = np.array([0.0, 0.0, 0.45, 0.02, 0.03, -0.3, 1.0, -1.5])
    jm = np.zeros((1, nchan), bool)
    jm[0, 16:] = True
    kw = dict(join_theta=np.array([[0.02, 1e-3]]), join_mask=jm,
              P=0.004) if join else {}
    port = np.asarray(JG.gen_gaussian_portrait_flat(truth, freqs, 1500.0,
                                                    nbin, -4.0, **kw))
    got = TG.gen_gaussian_portrait_flat(truth, freqs, 1500.0, nbin, -4.0,
                                        device="cpu", **kw).numpy()
    assert rel_err(got, port) <= 1e-12
    data = port + 0.01 * rng.normal(size=(nchan, nbin))
    x0 = np.array([0.0, 0.0, 0.44, 0.0, 0.035, 0.0, 0.9, 0.0])
    flags = np.array([1, 0, 1, 1, 1, 1, 1, 1])
    jp = ([np.arange(16), np.arange(16, 32)], [0.0, 0.0, 0.015, 0.0],
          [0, 0, 1, 1]) if join else None
    args = (data, x0, -4.0, np.full(nchan, 0.01), flags, False, freqs,
            1500.0)
    ref = JG.fit_gaussian_portrait(*args, join_params=jp, P=0.004)
    got = TG.fit_gaussian_portrait(*args, join_params=jp, P=0.004,
                                   device="cpu")
    errs = np.where(ref.fit_errs > 0, ref.fit_errs, 1e-12)
    assert np.all(np.abs(got.fitted_params - ref.fitted_params)
                  <= 1e-6 * errs)
    if join:
        je = np.where(ref.join_fit_errs > 0, ref.join_fit_errs, 1e-12)
        assert np.all(np.abs(got.join_fit - ref.join_fit) <= 1e-6 * je)
        assert abs(got.join_fit[2] - 0.02) < 5 * ref.join_fit_errs[2]
    assert got.chi2 == pytest.approx(ref.chi2, rel=1e-9)
    assert got.nfev == ref.nfev


# --------------------------------------------------------------------------
# analytic Jacobians against torch.func.jacfwd (tests/test_lm_batched.py
# TestAnalyticJacobian), through fit.lm._make_jac

GATE = 1e-10


def _jac_pair(resid, jac, aux, x0, lower, upper, vary, nudge=True):
    x0 = _t(x0)[None]
    lo, hi, kind = TL._bounds_spec(lower, upper, tuple(x0.shape), F64,
                                   "cpu")
    vary_b = torch.as_tensor(np.asarray(vary, bool))[None]
    if nudge:
        x0 = TL._nudge_into_bounds(x0, lo, hi, kind, vary_b)
    vf = vary_b.to(F64)
    u0 = TL._to_internal(x0, lo, hi, kind)
    aux = tuple(a[None] for a in aux)
    J_ad = TL._make_jac(resid, None, aux, lo, hi, kind, vf)(u0)[0].numpy()
    J_an = TL._make_jac(resid, jac, aux, lo, hi, kind, vf)(u0)[0].numpy()
    return J_ad, J_an


def _gate(J_ad, J_an, vary):
    scale = max(float(np.max(np.abs(J_ad))), 1.0)
    assert float(np.max(np.abs(J_ad - J_an))) / scale <= GATE
    frozen = ~np.asarray(vary, bool)
    assert np.all(J_ad[:, frozen] == 0.0) and np.all(J_an[:, frozen] == 0.0)


@pytest.mark.parametrize("ngauss,ngauss_pad", [(1, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("fit_scat", [False, True])
def test_profile_jacobian_lattice(ngauss, ngauss_pad, fit_scat):
    rng = np.random.default_rng(77)
    nbin = 64
    data = _t(rng.standard_normal(nbin))
    errs = torch.full((nbin,), 0.1, dtype=F64)
    for freeze in (None, 0):
        seed = [0.05, 0.8 if fit_scat else 0.0]
        for ig in range(ngauss):
            seed += [0.2 + 0.25 * ig, 0.03, 1.0 + ig]
        padded, _ = TG.pad_profile_params(seed, ngauss_pad)
        vary = TG.profile_vary(ngauss, ngauss_pad, fit_scattering=fit_scat)
        if freeze is not None:
            vary = vary.copy()
            vary[2 + 3 * freeze] = False
        lower, upper = TG.profile_bounds(ngauss_pad, nbin)
        _gate(*_jac_pair(TG._profile_resid, TG._profile_resid_jac,
                         (data, errs), padded, lower, upper, vary), vary)


@pytest.mark.parametrize("code", ["000", "010", "111"])
@pytest.mark.parametrize("ngauss,gpad", [(1, 1), (2, 4)])
def test_portrait_jacobian_lattice(code, ngauss, gpad):
    rng = np.random.default_rng(77)
    nchan, nbin = 6, 64
    data = _t(rng.standard_normal((nchan, nbin)))
    errs = torch.full((nchan,), 0.1, dtype=F64)
    freqs = torch.linspace(1300.0, 1900.0, nchan, dtype=F64)
    seed = [0.02, 0.5]
    for ig in range(ngauss):
        seed += [0.3 + 0.2 * ig, 0.01, 0.04, 0.1, 1.0 + ig, -0.4]
    padded, _ = TG.pad_portrait_params(seed, gpad)
    nmain = 2 + 6 * gpad
    x0 = np.concatenate([padded, [-4.0]])
    vary = TG.portrait_vary(np.ones(2 + 6 * ngauss, bool), gpad,
                            fit_scattering_index=True)
    lower, upper = TG.portrait_bounds(gpad, nbin)
    resid, rjac = TG._portrait_fns(code, nbin, 0, nmain)
    aux = (data, errs, freqs, _t(1500.0), _t(0.003),
           torch.zeros((0, nchan), dtype=torch.bool))
    _gate(*_jac_pair(resid, rjac, aux, x0, lower, upper, vary), vary)


def test_portrait_join_columns_and_jax_jacobian():
    """The JOIN (phase, DM) columns and the rotation of every base column
    against autodiff, and the analytic Jacobian against the JAX
    package's own (its _make_jac, analytic lane) on the same layout."""
    rng = np.random.default_rng(77)
    nchan, nbin, njoin = 6, 64, 1
    nmain = 2 + 6 * 2
    d = rng.standard_normal((nchan, nbin))
    freqs = np.linspace(1300.0, 1900.0, nchan)
    jm = np.zeros((njoin, nchan), bool)
    jm[0, 3:] = True
    x0 = np.concatenate([[0.02, 0.5], [0.3, 0.01, 0.04, 0.1, 2.0, -0.5],
                         [0.6, -0.02, 0.02, 0.3, 1.0, 0.2], [0.01, 0.4],
                         [-3.8]])
    lower = np.full(len(x0), -np.inf)
    upper = np.full(len(x0), np.inf)
    lower[1] = 0.0
    lower[4:nmain:6] = 0.5 / nbin
    upper[4:nmain:6] = 0.25
    lower[6:nmain:6] = 0.0
    vary = np.ones(len(x0), bool)
    resid, rjac = TG._portrait_fns("000", nbin, njoin, nmain)
    aux = (_t(d), torch.full((nchan,), 0.1, dtype=F64), _t(freqs),
           _t(1500.0), _t(0.003), torch.as_tensor(jm))
    J_ad, J_an = _jac_pair(resid, rjac, aux, x0, lower, upper, vary)
    _gate(J_ad, J_an, vary)
    jr, jj = JG._portrait_fns("000", nbin, njoin, nmain)
    lo, hi, kind = JL._bounds_spec(lower, upper, len(x0), jnp.float64)
    xj = JL._nudge_into_bounds(jnp.asarray(x0), lo, hi, kind,
                               jnp.asarray(vary))
    J_jax = np.asarray(JL._make_jac(
        jr, jj, (jnp.asarray(d), jnp.full(nchan, 0.1), jnp.asarray(freqs),
                 jnp.asarray(1500.0), jnp.asarray(0.003), jnp.asarray(jm)),
        lo, hi, kind, jnp.asarray(vary, float))(
            JL._to_internal(xj, lo, hi, kind)))
    assert np.max(np.abs(J_an - J_jax)) / np.max(np.abs(J_jax)) <= 1e-12


def test_zero_width_frozen_pad_ad_convention():
    """|.|' at 0: JAX's autodiff gives 1, torch's 0.  The analytic dwid
    column follows JAX (sign(0) = +1), so on a zero-width component the
    port's 'ad' lane differs from its analytic lane in that column
    alone, and the vary mask of a frozen pad zeroes it in both."""
    nbin = 64
    rng = np.random.default_rng(5)
    data = _t(rng.standard_normal(nbin))
    errs = torch.full((nbin,), 0.1, dtype=F64)
    x0 = np.array([0.0, 0.0, 0.3, 0.05, 1.0, 0.5, 0.0, 0.7])
    lower = np.full(8, -np.inf)
    upper = np.full(8, np.inf)
    vary = np.array([True, False, True, True, True, False, False, False])
    J_ad, J_an = _jac_pair(TG._profile_resid, TG._profile_resid_jac,
                           (data, errs), x0, lower, upper, vary,
                           nudge=False)
    _gate(J_ad, J_an, vary)
    vary_all = np.ones(8, bool)
    J_ad, J_an = _jac_pair(TG._profile_resid, TG._profile_resid_jac,
                           (data, errs), x0, lower, upper, vary_all,
                           nudge=False)
    diff = np.max(np.abs(J_ad - J_an), axis=0)
    assert diff[6] > 0.0                       # the zero-width dwid column
    assert np.all(diff[np.arange(8) != 6] <= GATE * np.max(np.abs(J_ad)))


# --------------------------------------------------------------------------
# power-law fits

def test_fit_powlaw_and_dm_fit():
    rng = np.random.default_rng(8)
    freqs = np.linspace(1100.0, 1900.0, 40)
    errs = np.full(40, 0.02)
    data = 1.3 * (freqs / 1500.0) ** -1.7 + errs * rng.normal(size=40)
    ref = JPL.fit_powlaw(data, errs=errs, nu_ref=1500.0, freqs=freqs)
    got = TPL.fit_powlaw(data, errs=errs, nu_ref=1500.0, freqs=freqs,
                         device="cpu")
    for k in ("amp", "alpha"):
        assert abs(got[k] - ref[k]) <= 1e-6 * ref[k + "_err"]
        assert got[k + "_err"] == pytest.approx(ref[k + "_err"], rel=1e-8)
    assert got.chi2 == pytest.approx(ref.chi2, rel=1e-9)
    resid = 3e-6 * (freqs ** -2.0 - 1500.0 ** -2.0) * 1e6 + 1e-7 \
        + 1e-8 * rng.normal(size=40)
    e = np.full(40, 1e-8)
    ref = JPL.fit_DM_to_freq_resids(freqs, resid, e)
    got = TPL.fit_DM_to_freq_resids(freqs, resid, e)
    for k in ("DM", "DM_err", "offset", "offset_err", "nu_ref",
              "nu_ref_err", "chi2"):
        assert got[k] == pytest.approx(ref[k], rel=1e-10, abs=1e-300), k


# --------------------------------------------------------------------------
# the trial machinery

def test_trial_seeds_and_selection_rules():
    prof = np.zeros(64)
    prof[20] = 1.0
    ref = JG.profile_trial_seeds(prof, 3, wid0=0.05, noise=0.1)
    got = TG.profile_trial_seeds(prof, 3, wid0=0.05, noise=0.1)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    for args, kw in (([10.0, 5.0, 4.999], {}), ([1.05, 0.9], {}),
                     ([np.nan, 2.0], {}), ([np.nan, np.inf], {}),
                     ([3139.0, 0.84], dict(success=[True, False])),
                     ([10.0, 9.8], dict(success=[True, False])),
                     ([10.0, 9.8], dict(success=[True, True],
                                        stalled=[False, True])),
                     ([10.0, 9.8], {})):
        assert TG.select_best_trial(args, **kw) == \
            JG.select_best_trial(args, **kw)


@pytest.mark.parametrize("serial", [True, False])
def test_fit_profile_trials_matches_jax(serial, capsys):
    """The same selected ngauss as the JAX package and parameters within
    1e-6 x their errors; the margin of the selection (the selected
    trial's reduced chi2 against the next one's) is printed."""
    prof = _two_component_profile()
    ref = JG.fit_profile_trials(prof, 3, 0.03, serial=serial)
    got = TG.fit_profile_trials(prof, 3, 0.03, serial=serial, device="cpu")
    assert got.ngauss == ref.ngauss
    assert np.all(np.abs(got.params - ref.params)
                  <= 1e-6 * np.where(ref.param_errs > 0, ref.param_errs,
                                     1e-12))
    red = got.red_chi2s
    nxt = red[got.index + 1] if got.index + 1 < len(red) else np.nan
    with capsys.disabled():
        print(f"\nfit_profile_trials(serial={serial}): ngauss {got.ngauss}, "
              f"red chi2 {red[got.index]:.6f}, next trial {nxt:.6f}")
    if not serial:
        one = TG.fit_profile_trials(prof, 3, 0.03, serial=True,
                                    device="cpu")
        assert np.max(np.abs(one.params - got.params)) <= 1e-10


@pytest.mark.parametrize("jac", ["ad", "analytic"])
def test_batched_trials_ad_and_analytic_select_alike(jac, monkeypatch):
    rng = np.random.default_rng(42)
    nbin = 128
    grid = np.arange(nbin) / nbin
    d = np.mod(grid - 0.3 + 0.5, 1.0) - 0.5
    prof = 2.0 * np.exp(-4 * np.log(2) * (d / 0.05) ** 2) \
        + 0.03 * rng.standard_normal(nbin)
    monkeypatch.setattr(tcfg, "lm_jacobian", "auto")
    base = TG.fit_profile_trials(prof, 2, 0.03, serial=False, device="cpu")
    monkeypatch.setattr(tcfg, "lm_jacobian", jac)
    got = TG.fit_profile_trials(prof, 2, 0.03, serial=False, device="cpu")
    assert got.ngauss == base.ngauss
    assert np.max(np.abs(got.params - base.params)) < 1e-6


def test_padded_components_identity():
    rng = np.random.default_rng(42)
    nbin = 128
    truth = np.array([0.01, 0.0, 0.3, 0.04, 1.0, 0.6, 0.02, 0.5])
    data = TG.gen_gaussian_profile_flat(truth, nbin, device="cpu").numpy() \
        + 0.01 * rng.normal(size=nbin)
    x0 = np.array([0.0, 0.0, 0.29, 0.05, 0.9, 0.61, 0.03, 0.4])
    single = TG.fit_gaussian_profile(data, x0, 0.01, device="cpu")
    padded, g = TG.pad_profile_params(x0, 4)
    rb = TG.fit_gaussian_profiles_batched(
        data[None], padded[None], np.array([0.01]),
        TG.profile_vary(g, 4)[None], device="cpu")
    assert np.max(np.abs(rb.x[0, :8].numpy() - single.fitted_params)) \
        <= 1e-12
    assert int(rb.dof[0]) == single.dof
    with pytest.raises(ValueError, match="cannot pad"):
        TG.pad_profile_params(np.zeros(2 + 3 * 4), 2)


def test_portraits_batched_vs_serial():
    """The portrait front-end with channel padding (+inf errors) and
    nchan_valid: batched against serial <= 1e-10, and the padded problem
    against the unpadded fit."""
    rng = np.random.default_rng(9)
    nchan, nbin = 8, 64
    freqs = np.linspace(1300.0, 1700.0, nchan)
    truth = np.array([0.0, 0.0, 0.45, 0.02, 0.05, -0.3, 1.0, -1.5])
    port = TG.gen_gaussian_portrait_flat(truth, freqs, 1500.0, nbin, -4.0,
                                         device="cpu").numpy()
    data = np.stack([port + 0.02 * rng.normal(size=port.shape)
                     for _ in range(2)])
    data[1, 6:] = 0.0
    errs = np.full((2, nchan), 0.02)
    errs[1, 6:] = np.inf
    fr = np.stack([freqs, np.concatenate([freqs[:6], [freqs[5]] * 2])])
    x0, _ = TG.pad_portrait_params([0.0, 0.0, 0.44, 0.0, 0.06, 0.0, 0.9,
                                    0.0], 2)
    x0s = np.stack([np.append(x0, -4.0)] * 2)
    v = TG.portrait_vary(np.array([1, 0, 1, 1, 1, 1, 1, 1]), 2)
    kw = dict(nchan_valid=[8, 6], device="cpu")
    rb = TG.fit_gaussian_portraits_batched(data, x0s, errs, np.stack([v] * 2),
                                           fr, 1500.0, 0.004, **kw)
    rs = TG.fit_gaussian_portraits_batched(data, x0s, errs, np.stack([v] * 2),
                                           fr, 1500.0, 0.004, serial=True,
                                           **kw)
    for f in ("x", "x_err", "chi2", "dof", "nfev"):
        assert np.max(np.abs(getattr(rb, f).double().numpy()
                             - getattr(rs, f).double().numpy())) <= 1e-10, f
    one = TG.fit_gaussian_portrait(data[1, :6], x0[:8], -4.0, errs[1, :6],
                                   np.array([1, 0, 1, 1, 1, 1, 1, 1]), False,
                                   freqs[:6], 1500.0, P=0.004, device="cpu")
    assert np.max(np.abs(rb.x[1, :8].numpy() - one.fitted_params)) <= 1e-8
    assert int(rb.dof[1]) == one.dof


def test_fit_profile_auto_gauss(tmp_path):
    """GaussPortrait.fit_profile's single auto Gaussian (a phase-shift
    seed, then fit_gaussian_profile) on tests/test_cli.py's first
    archive: parameters within 1e-6 x their errors of the JAX
    package's."""
    from pulseportraiture_tpu.pipeline.gauss import GaussPortrait as JGauss
    from pulseportraiture_tpu.synth import default_test_model
    from pulseportraiture_tpu.synth import make_fake_pulsar
    from pulseportraiture_tpu.utils.mjd import MJD
    from pulseportraiture_tpu_torch.pipeline.gauss import (
        GaussPortrait as TGauss)

    par = {"PSR": "J2145-0750", "RAJ": "21:45:50.5", "DECJ": "-07:50:18.5",
           "P0": 0.016052, "PEPOCH": 55000.0, "DM": 9.003}
    path = str(tmp_path / "example-1.fits")
    make_fake_pulsar(default_test_model(1500.0), par, outfile=path, nsub=3,
                     nchan=32, nbin=256, nu0=1500.0, bw=800.0, tsub=60.0,
                     dDM=4e-4, start_MJD=MJD(55150, 0.3), noise_stds=0.07,
                     dedispersed=False, quiet=True, rng=50)
    j = JGauss(path, quiet=True)
    t = TGauss(path, quiet=True, device="cpu")
    pj = j.fit_profile(auto_gauss=0.04)
    pt = t.fit_profile(auto_gauss=0.04)
    assert t.ngauss == j.ngauss == 1
    assert np.all(np.abs(pt - pj) <= 1e-6 * np.where(
        j.init_param_errs > 0, j.init_param_errs, 1e-12))

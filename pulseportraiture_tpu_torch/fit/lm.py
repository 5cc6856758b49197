"""Bounded Levenberg-Marquardt least squares in torch (counterpart of
pulseportraiture_tpu/fit/lm.py).

The template builders' engine (fit/gauss.py, fit/powlaw.py).  Bounds
use the MINUIT-style transforms lmfit uses, so bounded parameters stay
strictly inside their intervals and the Jacobian is taken in the
unbounded internal space: by forward-mode autodiff (torch.func.jacfwd),
or, when the caller provides an analytic external-space companion
(``jacobian=``), by the closed form chained through the transform's
elementwise dx/du (config.lm_jacobian: 'auto' / 'analytic' / 'ad', 'ad'
being the oracle lane).  Frozen parameters (vary=False) have their
Jacobian columns masked in one place (_make_jac).  Error bars follow
lmfit's scale_covar convention: the covariance scaled by reduced chi^2,
reported in external space through the transform's chain rule.

Everything runs batched: a state holds B problems along a leading axis,
the residual function maps (B, n) parameters and per-problem ``aux``
tensors (each with a leading B axis) to (B, nres) residuals, and the
single-problem engine (levenberg_marquardt, the oracle) is the same
step at B = 1.  Every step runs in float64 on the device of x0.

The JAX package runs the loop as a lax.while_loop with no host in it.
A literal torch port would read ``done`` back every iteration (a host
sync of ~22 us on the card, and up to 200 iterations per portrait fit),
so the loop runs in blocks: SYNC_EVERY (or compact_every) iterations
with no host read, then one read of (done, it).  A row that is done (or
at its iteration cap) keeps every field of its state, ``it`` and
``nfev`` included, through torch.where(active, new, old): a step past
convergence is an exact no-op.  So a split at any iteration boundary
reproduces the unsplit trajectory exactly, which both the blocking and
the batched engine's straggler compaction rely on.  (Compaction also
re-batches rows into a narrower batch, where a library may associate a
reduction differently: ~1e-15 on the CPU, the same trajectories.)

Two further departures from a literal port, each keeping the JAX
package's results:
- the JAX serial engine evaluates the Jacobian only on an accepted step
  (lax.cond); under vmap that is a select.  Here the Jacobian is
  evaluated for every row each step and selected, as vmap does: indexing
  the accepted rows would need a host read of the mask per iteration.
- jnp.linalg.solve / inv return NaN/inf for a singular system, and
  torch.linalg.solve raises (its check a sync on CUDA).  solve_ex /
  inv_ex keep JAX's semantics: the step goes non-finite, is rejected,
  and lam grows.
"""

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["LMResult", "levenberg_marquardt", "levenberg_marquardt_batched",
           "use_lm_jacobian", "resolve_lm_jacobian", "resolve_compact_every",
           "COMPACT_EVERY_CONFIG", "lm_stats", "reset_lm_stats"]

# iterations per block between two host reads of (done, it) when no
# compaction chunk is given
SYNC_EVERY = 4

# per-call records of the engine (iterations, nfev, host reads of the
# loop state, compaction classes) for chip_smoke's LM lines
_STATS = []


def lm_stats():
    """The records of every LM call since reset_lm_stats(): one dict per
    call with B, the largest iteration count and nfev, the number of
    host reads of the loop state, and the batch widths of the chunks
    (the compaction classes)."""
    return list(_STATS)


def reset_lm_stats():
    _STATS.clear()


def use_lm_jacobian(setting=None):
    """The engine's Jacobian-source knob, config.lm_jacobian ('auto' |
    'analytic' | 'ad'), strict (a typo must not mean 'auto'); read per
    call.  setting: an explicit override (the CLIs' --lm-jacobian)."""
    if setting is None:
        from .. import config

        setting = getattr(config, "lm_jacobian", "auto")
    if setting not in ("auto", "analytic", "ad"):
        raise ValueError(
            f"lm_jacobian must be 'auto', 'analytic' or 'ad'; got "
            f"{setting!r}")
    return setting


def resolve_lm_jacobian(jacobian, setting=None):
    """The jacobian function to use, or None for jacfwd.  'analytic'
    with no companion raises: an A/B run forcing the analytic lane must
    not fall back to autodiff."""
    mode = use_lm_jacobian(setting)
    if mode == "ad":
        return None
    if jacobian is None:
        if mode == "analytic":
            raise ValueError(
                "lm_jacobian='analytic' but this fit's residual "
                "function provides no analytic Jacobian companion; "
                "use 'auto' (analytic when available) or 'ad'")
        return None
    return jacobian


# --- bound transforms (lmfit/MINUIT convention) ---------------------------
# free:        x = u
# lower only:  x = lo - 1 + sqrt(u^2 + 1)
# upper only:  x = hi + 1 - sqrt(u^2 + 1)
# two-sided:   x = lo + (hi - lo)/2 * (sin(u) + 1)


def _to_external(u, lo, hi, kind):
    s = torch.sqrt(u**2.0 + 1.0)
    return torch.where(
        kind == 0, u,
        torch.where(kind == 1, lo - 1.0 + s,
                    torch.where(kind == 2, hi + 1.0 - s,
                                lo + 0.5 * (hi - lo) * (torch.sin(u)
                                                        + 1.0))))


def _to_internal(x, lo, hi, kind):
    xl = torch.sqrt(torch.clamp((x - lo + 1.0) ** 2.0 - 1.0, min=0.0))
    xu = torch.sqrt(torch.clamp((hi - x + 1.0) ** 2.0 - 1.0, min=0.0))
    frac = torch.clamp(
        2.0 * (x - lo) / torch.where(hi > lo, hi - lo,
                                     torch.ones_like(hi)) - 1.0, -1.0, 1.0)
    return torch.where(
        kind == 0, x,
        torch.where(kind == 1, xl,
                    torch.where(kind == 2, -xu, torch.arcsin(frac))))


def _to_external_grad(u, lo, hi, kind):
    """Elementwise dx/du of _to_external in closed form: the analytic
    Jacobian's chain factor and the covariance transform's (the JAX
    package takes the latter by jax.grad under vmap, the same values)."""
    s = torch.sqrt(u**2.0 + 1.0)
    return torch.where(
        kind == 0, torch.ones_like(u),
        torch.where(kind == 1, u / s,
                    torch.where(kind == 2, -u / s,
                                0.5 * (hi - lo) * torch.cos(u))))


def _make_jac(resid_fn, jacobian, aux, lo, hi, kind, vary):
    """THE Jacobian evaluator, u (B, n) -> (B, nres, n), and the one
    place the vary mask (float, (B, n)) is applied, for both sources and
    both call sites (the initial state and the loop).

    jacobian None: torch.func.jacfwd of residual-of-transform, vmapped
    over the problems.  jacobian given: the analytic external-space
    Jacobian J_x(x, *aux) -> (B, nres, n), chained by dx/du."""
    if jacobian is None:
        from torch.func import jacfwd, vmap

        def one(u, lo_, hi_, kind_, *aux_):
            x = _to_external(u, lo_, hi_, kind_)
            return resid_fn(x[None], *[a[None] for a in aux_])[0]

        jf = vmap(jacfwd(one))

        def jac(u):
            return jf(u, lo, hi, kind, *aux) * vary[:, None, :]
    else:
        def jac(u):
            Jx = jacobian(_to_external(u, lo, hi, kind), *aux)
            D = _to_external_grad(u, lo, hi, kind)
            return Jx * (D * vary)[:, None, :]
    return jac


def _bounds_spec(lower, upper, shape, dtype, device):
    """(lo, hi, kind) tensors of ``shape`` from (lower, upper) bounds
    with +-inf for unbounded (broadcast from (n,) or given per row)."""
    lo = np.full(shape, -np.inf) if lower is None \
        else np.broadcast_to(np.asarray(lower, float), shape).copy()
    hi = np.full(shape, np.inf) if upper is None \
        else np.broadcast_to(np.asarray(upper, float), shape).copy()
    kind = np.zeros(shape, np.int32)
    kind[np.isfinite(lo) & ~np.isfinite(hi)] = 1
    kind[~np.isfinite(lo) & np.isfinite(hi)] = 2
    kind[np.isfinite(lo) & np.isfinite(hi)] = 3
    # dummies for the infinite bounds: the transforms never see inf
    lo = np.where(np.isfinite(lo), lo, 0.0)
    hi = np.where(np.isfinite(hi), hi, 0.0)
    return (torch.as_tensor(lo, dtype=dtype, device=device),
            torch.as_tensor(hi, dtype=dtype, device=device),
            torch.as_tensor(kind, device=device))


class LMResult(NamedTuple):
    x: torch.Tensor          # fitted external parameters
    x_err: torch.Tensor      # 1-sigma errors (scale_covar convention)
    chi2: torch.Tensor
    dof: torch.Tensor
    nfev: torch.Tensor
    cov: torch.Tensor        # external-space covariance (scaled)
    success: torch.Tensor
    # the fit stopped on the STALL criterion (two consecutive accepted
    # steps with sub-ftol improvement at high damping); counted as
    # success, but its stop point is not reproducible across program
    # variants the way a clean convergence is, so template-trial
    # selection holds such trials to a wider margin
    stalled: torch.Tensor


class _LMState(NamedTuple):
    u: torch.Tensor      # (B, n)
    f: torch.Tensor      # (B,)
    r: torch.Tensor      # (B, nres) residual at u
    J: torch.Tensor      # (B, nres, n) Jacobian at u
    lam: torch.Tensor    # (B,)
    it: torch.Tensor     # (B,) int32
    nfev: torch.Tensor   # (B,) int32
    nstall: torch.Tensor  # (B,) int32 consecutive sub-ftol accepts
    done: torch.Tensor   # (B,) bool


def _select(mask, new, old):
    """Per-row torch.where over every field of two states."""
    def w(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)

    return _LMState(*[w(a, b) for a, b in zip(new, old)])


def _lm_step(s, rfun, jac, vary, it_cap, ftol, lam0):
    """One LM iteration of every row; rows that are done or at it_cap
    keep their state exactly."""
    active = (s.it < it_cap) & ~s.done
    JT = s.J.transpose(-1, -2)
    g = (JT @ s.r[..., None])[..., 0]
    JTJ = JT @ s.J
    dJ = torch.diagonal(JTJ, dim1=-2, dim2=-1)
    dJ = torch.maximum(dJ, 1e-14 * torch.amax(dJ, dim=-1, keepdim=True))
    A = (JTJ + torch.diag_embed(s.lam[:, None] * dJ)
         + torch.diag_embed(1.0 - vary))
    step = -torch.linalg.solve_ex(A, g[..., None])[0][..., 0] * vary
    # near-degenerate Jacobian columns (a parameter just inside a bound)
    # can give explosive internal steps; clamp each element to a
    # generous multiple of its current scale
    smax = 100.0 * (1.0 + torch.abs(s.u))
    step = torch.minimum(torch.maximum(step, -smax), smax)
    u_try = s.u + step
    r_try = rfun(u_try)
    f_new = torch.sum(r_try**2.0, dim=-1)
    accept = f_new < s.f
    # converged: an accepted near-Newton step (small damping) with
    # negligible relative improvement, or an essentially zero gradient
    rel = (s.f - f_new) / (torch.abs(s.f) + 1e-300)
    done_clean = accept & (rel < ftol) & (s.lam <= lam0)
    gnorm = torch.amax(torch.abs(g * vary), dim=-1)
    done_clean = done_clean | (gnorm < 1e-14 * (s.f + 1.0))
    # STALL: two consecutive accepted sub-ftol steps at high damping; a
    # clean convergence on this iteration resets the counter, so
    # `stalled` means the stall criterion is what stopped the fit
    nstall = torch.where(accept, torch.where(rel < ftol, s.nstall + 1,
                                             torch.zeros_like(s.nstall)),
                         s.nstall)
    nstall = torch.where(done_clean, torch.zeros_like(nstall), nstall)
    done = done_clean | (nstall >= 2)
    u_new = torch.where(accept[:, None], u_try, s.u)
    J_new = torch.where(accept[:, None, None], jac(u_new), s.J)
    new = _LMState(
        u=u_new,
        f=torch.where(accept, f_new, s.f),
        r=torch.where(accept[:, None], r_try, s.r),
        J=J_new,
        lam=torch.clamp(torch.where(accept, s.lam * 0.3, s.lam * 5.0),
                        1e-12, 1e12),
        it=s.it + 1,
        nfev=s.nfev + 1,
        nstall=nstall,
        done=done)
    return _select(active, new, s)


class _Problem:
    """The fixed data of a set of rows: residual function, aux, bounds,
    vary mask; take(idx) gives the subset for a compacted chunk."""

    def __init__(self, resid_fn, jacobian, aux, lo, hi, kind, vary):
        self.resid_fn, self.jacobian = resid_fn, jacobian
        self.aux, self.lo, self.hi, self.kind = aux, lo, hi, kind
        self.vary = vary.to(lo.dtype)

    def take(self, idx):
        return _Problem(self.resid_fn, self.jacobian,
                        tuple(a[idx] for a in self.aux), self.lo[idx],
                        self.hi[idx], self.kind[idx], self.vary[idx])

    def rfun(self, u):
        return self.resid_fn(_to_external(u, self.lo, self.hi, self.kind),
                             *self.aux)

    def jac(self):
        return _make_jac(self.resid_fn, self.jacobian, self.aux, self.lo,
                         self.hi, self.kind, self.vary)

    def run(self, s, it_cap, ftol, lam0, nsteps):
        """nsteps iterations with no host read."""
        jac = self.jac()
        for _ in range(nsteps):
            s = _lm_step(s, self.rfun, jac, self.vary, it_cap, ftol, lam0)
        return s


def _lm_init(p, x0, lam0=1e-3):
    """Initial state at x0 (B, n): one residual and one Jacobian, the
    latter from the same _make_jac the loop uses."""
    B = x0.shape[0]
    u0 = _to_internal(x0, p.lo, p.hi, p.kind)
    r0 = p.rfun(u0)
    i32 = dict(dtype=torch.int32, device=x0.device)
    return _LMState(
        u=u0, f=torch.sum(r0**2.0, dim=-1), r=r0, J=p.jac()(u0),
        lam=torch.full((B,), lam0, dtype=x0.dtype, device=x0.device),
        it=torch.zeros(B, **i32), nfev=torch.ones(B, **i32),
        nstall=torch.zeros(B, **i32),
        done=torch.zeros(B, dtype=torch.bool, device=x0.device))


def _lm_finalize(s, p, nres_valid, max_iter):
    """Final state -> LMResult (external-space covariance, lmfit's
    scale_covar convention)."""
    vary = p.vary
    nvary = torch.sum(vary, dim=-1)
    JT = s.J.transpose(-1, -2)
    JTJ = JT @ s.J + torch.diag_embed(1.0 - vary)
    cov_u = torch.linalg.inv_ex(JTJ)[0]
    # padded residual entries (zero-weight channels) carry no
    # information; nres_valid restores the true degrees of freedom
    nres = s.r.shape[-1] if nres_valid is None else nres_valid
    dof = nres - nvary
    red = s.f / torch.clamp(dof, min=1.0)
    cov_u = cov_u * red[:, None, None]
    # the transform is elementwise, so dx/du is diagonal
    D = _to_external_grad(s.u, p.lo, p.hi, p.kind)
    cov_x = (cov_u * (D[:, :, None] * D[:, None, :])
             * (vary[:, :, None] * vary[:, None, :]))
    x = _to_external(s.u, p.lo, p.hi, p.kind)
    x_err = torch.sqrt(torch.clamp(torch.diagonal(cov_x, dim1=-2,
                                                  dim2=-1), min=0.0))
    return LMResult(x=x, x_err=x_err, chi2=s.f, dof=dof, nfev=s.nfev,
                    cov=cov_x, success=s.done | (s.it < max_iter),
                    stalled=s.nstall >= 2)


def _nudge_into_bounds(x0, lo, hi, kind, vary):
    """Nudge VARYING parameters strictly inside their bounds (at the
    exact bound dx/du = 0 zeroes the Jacobian column and freezes the
    parameter); frozen parameters keep their value, clipped into the
    interval so that their internal coordinate is finite."""
    eps = 1e-4
    inside3 = torch.minimum(torch.maximum(x0, lo + eps * (hi - lo)),
                            hi - eps * (hi - lo))
    inside1 = torch.maximum(x0, lo + eps * (1.0 + torch.abs(lo)))
    inside2 = torch.minimum(x0, hi - eps * (1.0 + torch.abs(hi)))
    x0 = torch.where(vary & (kind == 3), inside3, x0)
    x0 = torch.where(vary & (kind == 1), inside1, x0)
    x0 = torch.where(vary & (kind == 2), inside2, x0)
    x0 = torch.where(~vary & (kind == 3),
                     torch.minimum(torch.maximum(x0, lo), hi), x0)
    x0 = torch.where(~vary & (kind == 1), torch.maximum(x0, lo), x0)
    x0 = torch.where(~vary & (kind == 2), torch.minimum(x0, hi), x0)
    return x0


def _host_alive(s, max_iter):
    """The one host read of a block: the rows still iterating."""
    alive = (~s.done & (s.it < max_iter)).cpu().numpy()
    return np.nonzero(alive)[0]


def _pow2ceil(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def _as_tensor(a, device, dtype=None):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    arr = np.asarray(a)
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype is None and arr.dtype.kind == "f":
        dtype = torch.float64
    return torch.as_tensor(arr, dtype=dtype, device=device)


def _prepare(x0, B, n, lower, upper, vary, device):
    lo, hi, kind = _bounds_spec(lower, upper, (B, n), torch.float64,
                                device)
    if vary is None:
        vary = torch.ones((B, n), dtype=torch.bool, device=device)
    vary = torch.broadcast_to(_as_tensor(vary, device, torch.bool),
                              (B, n))
    return _nudge_into_bounds(x0, lo, hi, kind, vary), lo, hi, kind, vary


def _drive(p, x0, max_iter, ftol, nres_valid, compact_every,
           compact_min_rows, lam0=1e-3):
    """Init, the blocked loop with optional straggler compaction, and
    finalize; records the call in lm_stats()."""
    B = x0.shape[0]
    s = _lm_init(p, x0, lam0)
    max_iter = int(max_iter)
    K = SYNC_EVERY if compact_every is None else int(compact_every)
    reads, classes, it_cap = 0, [], 0
    while True:
        alive = _host_alive(s, max_iter)
        reads += 1
        if alive.size == 0:
            break
        it_cap = min(it_cap + K, max_iter)
        cls = B if compact_every is None else min(
            max(_pow2ceil(alive.size), int(compact_min_rows)), B)
        classes.append(cls)
        if cls == B:
            s = p.run(s, it_cap, ftol, lam0, K)
            continue
        # compaction: the rows still iterating, padded to the class with
        # copies of the first one forced done (their results dropped)
        idx = torch.as_tensor(np.concatenate(
            [alive, np.full(cls - alive.size, alive[0])]),
            device=x0.device)
        sub = _LMState(*[a[idx] for a in s])
        if cls > alive.size:
            pad = torch.arange(cls, device=x0.device) >= alive.size
            sub = sub._replace(done=sub.done | pad)
        out = p.take(idx).run(sub, it_cap, ftol, lam0, K)
        ai = idx[:alive.size]
        s = _LMState(*[full.index_copy(0, ai, part[:alive.size])
                       for full, part in zip(s, out)])
    res = _lm_finalize(s, p, nres_valid, max_iter)
    _STATS.append(dict(B=B, it=int(s.it.max()), nfev=int(s.nfev.max()),
                       host_reads=reads, classes=classes))
    return res


def levenberg_marquardt(resid_fn, x0, aux=(), lower=None, upper=None,
                        vary=None, max_iter=100, ftol=1e-10,
                        nres_valid=None, jacobian=None, device=None):
    """Minimize sum(resid_fn(x, *aux)**2) over x with optional bounds:
    the single-problem engine, the batched step at B = 1.

    resid_fn: the BATCHED residual function (B, n), *aux -> (B, nres);
    aux: tensors (or arrays) of ONE problem, without the batch axis.
    x0: (n,) initial external parameters (nudged into bounds);
    lower/upper: (n,) with +-inf for unbounded; vary: (n,) bool.
    nres_valid: the true residual count for dof when some residual
    entries are zero-weight padding.  jacobian: optional analytic
    companion (B, n), *aux -> (B, nres, n) in external space, routed by
    config.lm_jacobian.  Runs in float64 on ``device`` (default: x0's
    device when x0 is a tensor, else cuda).  Returns an LMResult of
    tensors without the batch axis."""
    from ..device import resolve_device

    if device is None and isinstance(x0, torch.Tensor):
        device = x0.device
    dev = resolve_device(device)
    x0 = _as_tensor(x0, dev, torch.float64)
    n = x0.shape[0]
    x0, lo, hi, kind, vary = _prepare(
        x0[None], 1, n, lower, upper,
        None if vary is None else _as_tensor(vary, dev, torch.bool)[None],
        dev)
    aux = tuple(_as_tensor(a, dev)[None] for a in aux)
    p = _Problem(resid_fn, resolve_lm_jacobian(jacobian), aux, lo, hi,
                 kind, vary)
    nv = None if nres_valid is None else torch.as_tensor(
        [float(nres_valid)], dtype=torch.float64, device=dev)
    res = _drive(p, x0, max_iter, ftol, nv, None, 1)
    return LMResult(*[f[0] for f in res])


# the sentinel for "compact_every from config.lm_compact_every": the
# template fits keep None meaning one uninterrupted dispatch
COMPACT_EVERY_CONFIG = "config"


def resolve_compact_every(setting):
    """COMPACT_EVERY_CONFIG reads config.lm_compact_every; None and
    positive ints pass through; anything else raises."""
    if setting == COMPACT_EVERY_CONFIG:
        from .. import config

        setting = getattr(config, "lm_compact_every", 16)
    if setting is None:
        return None
    k = int(setting)
    if k < 1:
        raise ValueError(
            f"compact_every must be a positive int or None; got "
            f"{setting!r}")
    return k


def levenberg_marquardt_batched(resid_fn, x0, aux=(), lower=None,
                                upper=None, vary=None, max_iter=100,
                                ftol=1e-10, nres_valid=None,
                                compact_every=None, compact_min_rows=4,
                                jacobian=None, device=None):
    """Minimize B independent problems at once: every row steps
    together, a row that is done holds its state while stragglers
    iterate, so nfev/success keep their per-problem meaning.

    resid_fn / jacobian: as in levenberg_marquardt; aux: tensors each
    with a leading B axis.  x0: (B, n), heterogeneous problems padded to
    a common width n with their pad entries frozen (vary=False).
    lower/upper: (n,) shared or (B, n); vary: (B, n).  nres_valid: (B,)
    true residual counts under channel padding.  Returns an LMResult of
    tensors with a leading B axis.

    compact_every: with an int K, the loop runs in chunks of K
    iterations, and between chunks the rows still iterating are
    re-batched into the next power-of-two width (never below
    compact_min_rows), so one straggler stops costing a full-width
    step.  Trajectories are exact either way.  None: the full width
    throughout, with a host read of the loop state every SYNC_EVERY
    iterations."""
    from ..device import resolve_device

    if device is None and isinstance(x0, torch.Tensor):
        device = x0.device
    dev = resolve_device(device)
    x0 = _as_tensor(x0, dev, torch.float64)
    if x0.dim() != 2:
        raise ValueError(
            f"levenberg_marquardt_batched needs x0 of shape (B, n); "
            f"got {tuple(x0.shape)}")
    B, n = x0.shape
    x0, lo, hi, kind, vary = _prepare(x0, B, n, lower, upper, vary, dev)
    aux = tuple(_as_tensor(a, dev) for a in aux)
    p = _Problem(resid_fn, resolve_lm_jacobian(jacobian), aux, lo, hi,
                 kind, vary)
    nv = None if nres_valid is None else _as_tensor(
        nres_valid, dev, torch.float64)
    return _drive(p, x0, max_iter, ftol, nv, compact_every,
                  compact_min_rows)

"""The float32 GEMM arm of the fused kernels (B1, B2) on the tensor cores,
on the CPU: what the card's kernel (csrc/fcs_gemm.cuh, fcs_tc_kernel)
reads and computes, held here without the card.

(a) The host twiddles (ops.fourier "tf32x3"): hi = TF32(w) with the low
    13 mantissa bits zero, lo = TF32(w - hi), |hi + lo - w| <= 2^-22 |w|
    (w built in float64), K-major (2, Kp, Lp) planes [cos, -sin][k][j],
    the padding zero, the folded form the direct form's times 1 ... n/2-1.
(b) A numpy emulation of the kernel's arithmetic, kept here and not in
    the package: the samples split in TF32 (nearest, ties away, as
    cvt.rna.tf32.f32), the three products lo hi, hi lo, hi hi per k8 step
    (8 samples) summed from zero with each MMA's result rounded toward
    zero (the tensor cores' internal sums are assumed to truncate), each
    step's sum promoted into an FP32 accumulator with a round-to-nearest
    add; the folded form (the wrapper's at every even nbin) stages x[j] +-
    x[n - j] in float32 and adds x[0] + x[n/2] (-1)^k.  On baselined
    rows (a DC harmonic summing ~nbin values of one sign) it stays within
    1e-5 x max|ref| of the float64 DFT (the bound phase 3 holds the card
    to; each case asserts a margin of at least 4x), and a single TF32
    product (hi hi) does not.
(c) The shape rule between the arms is unchanged: 1022 and 1032 bins take
    the GEMM arm, 1000 the FFT arm.
"""

import numpy as np
import pytest
import torch

from pulseportraiture_tpu_torch.ops import fourier as TF
from pulseportraiture_tpu_torch.ops import fused as TFu
from pulseportraiture_tpu_torch.ops.noise import min_window_baseline

# the kernel's promotion span: one m16n8k8 step (csrc/fcs_gemm.cuh)
SPAN = 8
TOL = 1e-5
# the least margin asserted below the tolerance (the emulation's error
# was 0.3-1.1e-6 x max|ref| over these cases; the card's phase-3 runs
# 0.3-2.5e-6)
MARGIN = 4.0

SHAPES = [(1022, 384), (1032, 517), (2048, 384), (12, 7), (8200, 129),
          (1023, 512)]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("n,K,fold", [(n, K, f) for n, K in SHAPES
                                       for f in (False, True)
                                       if not (f and n % 2)])
def test_host_twiddles(n, K, fold):
    hi, lo, sgn = TF._tf32x3_weights(n, K, fold)
    L = n // 2 - 1 if fold else n
    Lp = -(-L // TF.TF32_TIME_CHUNK) * TF.TF32_TIME_CHUNK
    Kp = -(-K // TF.TF32_HARM_TILE) * TF.TF32_HARM_TILE
    # K-major planes, padded to whole tiles with zeros
    assert hi.shape == lo.shape == (2, Kp, Lp)
    assert hi.dtype == lo.dtype == np.float32
    assert not hi[:, K:].any() and not hi[:, :, L:].any()
    assert not lo[:, K:].any() and not lo[:, :, L:].any()
    # TF32: the low 13 mantissa bits zero
    assert not (_bits(hi) & 0x1FFF).any()
    assert not (_bits(lo) & 0x1FFF).any()
    j = np.arange(1, n // 2) if fold else np.arange(n)
    ang = 2.0 * np.pi * np.outer(np.arange(K), j) / n
    w = np.stack([np.cos(ang), -np.sin(ang)])
    got = hi[:, :K, :L].astype(np.float64) + lo[:, :K, :L]
    assert np.all(np.abs(got - w) <= 2.0 ** -22 * np.abs(w))
    np.testing.assert_array_equal(sgn, (-1.0) ** np.arange(K))
    # the device copy is the host's
    dh, dl, ds = TF.device_weights("tf32x3", "cpu", n, K, fold)
    np.testing.assert_array_equal(dh.numpy(), hi)
    np.testing.assert_array_equal(dl.numpy(), lo)


@pytest.mark.parametrize("n,K", [s for s in SHAPES if s[0] % 2 == 0])
def test_host_twiddles_fold_matches_direct(n, K):
    """The folded planes are the direct ones at times 1 ... n/2 - 1."""
    hi, lo, _ = TF._tf32x3_weights(n, K, False)
    fh, fl, _ = TF._tf32x3_weights(n, K, True)
    L = n // 2 - 1
    np.testing.assert_array_equal(fh[:, :, :L], hi[:, :fh.shape[1], 1:L + 1])
    np.testing.assert_array_equal(fl[:, :, :L], lo[:, :fl.shape[1], 1:L + 1])


def test_tf32_rna_ties_away():
    """Nearest, ties away from zero, 11 significant bits."""
    one = 1.0
    ulp = 2.0 ** -10
    assert TF.tf32_rna(one + ulp / 2) == one + ulp
    assert TF.tf32_rna(-(one + ulp / 2)) == -(one + ulp)
    assert TF.tf32_rna(one + ulp / 2 - 2.0 ** -30) == one
    assert TF.tf32_rna(0.0) == 0.0
    x = np.random.default_rng(0).normal(size=1000)
    r = TF.tf32_rna(x)
    assert np.all(np.abs(r - x) <= 2.0 ** -11 * np.abs(x))
    assert not (_bits(r) & 0x1FFF).any()


# --- (b) the kernel's arithmetic, emulated --------------------------------

def _rz32(x):
    """float64 -> float32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma(a, b, c):
    """One m16n8k8 TF32 MMA as modelled: the 8 exact products and c
    summed, the result truncated to FP32."""
    return _rz32(a.astype(np.float64) @ b.astype(np.float64)
                 + c.astype(np.float64))


def _emulate(x, W_hi, W_lo, products=3):
    """(rows, L) float32 samples against (L, K) TF32 twiddle planes: the
    kernel's per-k8-step chain from zero, promoted into FP32."""
    rows, L = x.shape
    Lp = -(-L // SPAN) * SPAN
    xp = np.zeros((rows, Lp), np.float32)
    xp[:, :L] = x
    x_hi = TF.tf32_rna(xp).astype(np.float32)
    x_lo = TF.tf32_rna(xp.astype(np.float64) - x_hi).astype(np.float32)
    Wh = np.zeros((Lp, W_hi.shape[1]), np.float32)
    Wl = np.zeros_like(Wh)
    Wh[:L], Wl[:L] = W_hi, W_lo
    acc = np.zeros((rows, Wh.shape[1]), np.float32)
    zero = np.zeros_like(acc)
    for s in range(0, Lp, SPAN):
        sl = slice(s, s + SPAN)
        if products == 3:
            t = _mma(x_lo[:, sl], Wh[sl], zero)
            t = _mma(x_hi[:, sl], Wl[sl], t)
            t = _mma(x_hi[:, sl], Wh[sl], t)
        else:
            t = _mma(x_hi[:, sl], Wh[sl], zero)
        acc = (acc + t).astype(np.float32)
    return acc


def _kernel_dft(x, K, fold, products=3):
    """(dr, di) of float32 rows x (rows, n) as the kernel computes them."""
    n = x.shape[-1]
    hi, lo, sgn = TF._tf32x3_weights(n, K, fold)
    L = n // 2 - 1 if fold else n
    if fold:
        head = x[:, 1:n // 2]
        tail = x[:, n - 1:n // 2:-1]
        a_c = (head + tail).astype(np.float32)
        a_s = (head - tail).astype(np.float32)
    else:
        a_c = a_s = x
    dr = _emulate(a_c, hi[0, :K, :L].T, lo[0, :K, :L].T, products)
    di = _emulate(a_s, hi[1, :K, :L].T, lo[1, :K, :L].T, products)
    if fold:
        dr = ((dr + x[:, :1]).astype(np.float32)
              + x[:, n // 2:n // 2 + 1] * sgn).astype(np.float32)
    return dr, di


def _baselined_rows(n, rows=6, seed=0):
    """Pulse profiles of peak 50 over an offset of 3 with white noise,
    minus the least-window mean (ops.noise): the DC harmonic sums ~n
    values of one sign, as on a baselined archive's rows."""
    rng = np.random.default_rng(seed)
    ph = np.arange(n) / n
    x = 3.0 + 50.0 * np.exp(-0.5 * ((ph - 0.3) / 0.02) ** 2) \
        + 0.1 * rng.normal(size=(rows, n))
    b = min_window_baseline(torch.from_numpy(x)).numpy()
    return (x - b[:, None]).astype(np.float32)


def _ref(x, K):
    """The float64 DFT of x at harmonics 0 ... K - 1 (past n/2 they
    alias, as the twiddles do)."""
    full = np.fft.fft(x.astype(np.float64), axis=-1)
    k = np.arange(K) % x.shape[-1]
    return full[:, k].real, full[:, k].imag


EMU_CASES = [(n, K) for n in (1022, 1032, 2048, 12)
             for K in (384, n // 2 + 1)]


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("n,K", EMU_CASES)
def test_emulated_kernel_within_tolerance(n, K, fold):
    x = _baselined_rows(n, seed=n + K)
    rr, ri = _ref(x, K)
    scale = max(np.abs(rr).max(), np.abs(ri).max())
    dr, di = _kernel_dft(x, K, fold)
    err = max(np.abs(dr - rr).max(), np.abs(di - ri).max()) / scale
    assert err * MARGIN <= TOL, (err, TOL)
    # the DC harmonic alone (the sum of ~n values of one sign)
    assert np.abs(dr[:, 0] - rr[:, 0]).max() / scale * MARGIN <= TOL


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("n", [1022, 1032, 2048])
def test_single_tf32_product_is_not_enough(n, fold):
    """hi hi alone (one TF32 product) misses the tolerance by far: the
    three products are what makes the arm FP32-accurate."""
    K = 384
    x = _baselined_rows(n, seed=3 * n)
    rr, ri = _ref(x, K)
    scale = max(np.abs(rr).max(), np.abs(ri).max())
    dr, di = _kernel_dft(x, K, fold, products=1)
    err = max(np.abs(dr - rr).max(), np.abs(di - ri).max()) / scale
    assert err > 5 * TOL, err


# --- (c) the rule --------------------------------------------------------

@pytest.mark.parametrize("nbin,arm", [(1022, False), (1032, False),
                                      (1023, False), (1000, True),
                                      (2048, True)])
def test_shape_rule_unchanged(nbin, arm):
    for K in (1, 384, nbin // 2 + 1):
        assert TFu.fft_arm(nbin, K) is arm

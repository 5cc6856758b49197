"""The CPU gate of the fused kernels' FFT arm (csrc/fft_smem.cuh).

The CUDA kernel cannot run here, so its plan is emulated in numpy, step
for step: the mixed-radix pass plan of fft_plan (fft_radices below: the
radix-3 passes, the radix-5 passes, radix 8 while three factors of 2
remain, then one radix-4 or radix-2 pass), the in-place
decimation-in-frequency butterflies over a block's flat buffer (the
same index arithmetic, the same radix-8/5/4/3/2 networks and twiddle
products from the same host table, ops.fourier device_weights kind
"fft"), the digit-reversed read-out and the two-for-one split of two
real rows per complex transform, in the kernel's dtype, at powers of two
and at 5-smooth lengths (odd ones included).  The emulated spectra are
held to torch.fft.rfft, the emulated cross-spectrum to the port's plain
version and to the JAX package's Pallas kernel in interpret mode; the
shared-memory layout (padding, sizes, bank conflicts) and the
baseline's scan order are checked as the source states them.
"""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_helpers import rel_err, tol_for

from pulseportraiture_tpu_torch.ops import fourier as TF
from pulseportraiture_tpu_torch.ops import fused as TFu
from pulseportraiture_tpu_torch.ops import noise as TN

from pulseportraiture_tpu.ops import fused as JFu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "pulseportraiture_tpu_torch", "ops", "csrc",
                      "fft_smem.cuh")

# the header's constants per dtype: complex values per block (n <= ELEMS)
# and log2 of the complex values in 128 bytes (the first pad's period)
GEOM = {"float32": dict(ELEMS=4096, PAD=4, CBYTES=8),
        "float64": dict(ELEMS=2048, PAD=3, CBYTES=16)}
NBINS = [2 ** p for p in range(4, 14)]
# 5-smooth lengths that are not powers of two, odd ones (375, 1125)
# included: the mixed-radix plan's
NBINS_MIXED = [48, 96, 120, 375, 1000, 1125, 1536, 3000, 3072, 6000, 7680]
# every length the FFT arm takes
NBINS_ALL = [n for n in range(16, 8193) if TFu._five_smooth(n)]
FFT_MAX_PASSES = 8


def exponents(n):
    """(a, b, c) with n = 2^a 3^b 5^c; raises for any other prime."""
    e = []
    for p in (2, 3, 5):
        k = 0
        while n % p == 0:
            n //= p
            k += 1
        e.append(k)
    if n != 1:
        raise ValueError("not 5-smooth")
    return tuple(e)


def fft_radices(nbin):
    """The pass plan of fft_smem.cuh fft_plan: the radix-3 passes, the
    radix-5 passes, radix 8 while three factors of 2 remain, then one
    radix-4 or radix-2 pass; e.g. 2048 -> (8, 8, 8, 4), 1000 -> (5, 5,
    5, 8), 3072 -> (3, 8, 8, 8, 2)."""
    a, b, c = exponents(int(nbin))
    tail = {0: (), 1: (2,), 2: (4,)}[a % 3]
    return (3,) * b + (5,) * c + (8,) * (a // 3) + tail


def fft_passes(nbin):
    """[(R, m, s)] of the plan: radix, the butterfly's stride m (span
    L = R m) and the twiddle step s = n / L."""
    out, L = [], nbin
    for R in fft_radices(nbin):
        out.append((R, L // R, nbin // L))
        L //= R
    return out


def phys(i, dt):
    """fft_phys: the shared-memory slot of complex value i."""
    return i + (i >> GEOM[dt]["PAD"]) + (i >> 7)


def rows_per_block(n, dt):
    """fft_rows_per_block: 2 p, p the largest power of two with p n <=
    ELEMS (1 when n >= ELEMS), by the header's bit smear."""
    q = GEOM[dt]["ELEMS"] // n
    for sh in (1, 2, 4, 8):
        q |= q >> sh
    return 2 * (q - (q >> 1)) if q else 2


def buffer_bytes(n, dt):
    E = rows_per_block(n, dt) // 2 * n
    b = (phys(E - 1, dt) + 1) * GEOM[dt]["CBYTES"]
    return (b + 15) & ~15


def magic(d):
    """fft_magic: ceil(2^32 / d), 0 for d = 1."""
    return -(-(1 << 32) // d) if d > 1 else 0


def fft_div(u, d):
    """fft_div: u / d by the multiply-high of the plan's magic (exact
    for u, d < 2^16, which the kernel's blocks keep)."""
    u = np.asarray(u, np.uint64)
    assert u.size == 0 or int(u.max()) < 1 << 16
    return u if d == 1 else (u * np.uint64(magic(d))) >> np.uint64(32)


# --- the kernel's arithmetic on (re, im) pairs of arrays in its dtype ---

def cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def mul_mi(a):
    return (a[1], -a[0])


def dft2(v):
    return [cadd(v[0], v[1]), csub(v[0], v[1])]


def dft3(v, dt):
    f = np.dtype(dt).type
    h, s3 = f(0.5), f(0.86602540378443864676)
    t1, t2 = cadd(v[1], v[2]), csub(v[1], v[2])
    a = (v[0][0] - h * t1[0], v[0][1] - h * t1[1])
    b = (s3 * t2[1], -s3 * t2[0])
    return [cadd(v[0], t1), cadd(a, b), csub(a, b)]


def dft4(v):
    a0, a2 = cadd(v[0], v[2]), csub(v[0], v[2])
    a1, a3 = cadd(v[1], v[3]), mul_mi(csub(v[1], v[3]))
    return [cadd(a0, a1), cadd(a2, a3), csub(a0, a1), csub(a2, a3)]


def dft5(v, dt):
    f = np.dtype(dt).type
    c1, c2 = f(0.30901699437494742410), f(-0.80901699437494742410)
    s1, s2 = f(0.95105651629515357212), f(0.58778525229247312917)
    t1, t2 = cadd(v[1], v[4]), cadd(v[2], v[3])
    d1, d2 = csub(v[1], v[4]), csub(v[2], v[3])
    a1 = tuple(v[0][i] + c1 * t1[i] + c2 * t2[i] for i in range(2))
    a2 = tuple(v[0][i] + c2 * t1[i] + c1 * t2[i] for i in range(2))
    b1 = mul_mi(tuple(s1 * d1[i] + s2 * d2[i] for i in range(2)))
    b2 = mul_mi(tuple(s2 * d1[i] - s1 * d2[i] for i in range(2)))
    return [cadd(v[0], cadd(t1, t2)), cadd(a1, b1), cadd(a2, b2),
            csub(a2, b2), csub(a1, b1)]


def dft8(v, dt):
    h = np.dtype(dt).type(0.70710678118654752440)
    a0, d0 = cadd(v[0], v[4]), csub(v[0], v[4])
    a1, d1 = cadd(v[1], v[5]), csub(v[1], v[5])
    a2, d2 = cadd(v[2], v[6]), csub(v[2], v[6])
    a3, d3 = cadd(v[3], v[7]), csub(v[3], v[7])
    a4 = d0
    a5 = ((d1[0] + d1[1]) * h, (d1[1] - d1[0]) * h)
    a6 = mul_mi(d2)
    a7 = ((d3[1] - d3[0]) * h, -(d3[0] + d3[1]) * h)
    b0, b2 = cadd(a0, a2), csub(a0, a2)
    b1, b3 = cadd(a1, a3), mul_mi(csub(a1, a3))
    b4, b6 = cadd(a4, a6), csub(a4, a6)
    b5, b7 = cadd(a5, a7), mul_mi(csub(a5, a7))
    out = [None] * 8
    out[0], out[4] = cadd(b0, b1), csub(b0, b1)
    out[2], out[6] = cadd(b2, b3), csub(b2, b3)
    out[1], out[5] = cadd(b4, b5), csub(b4, b5)
    out[3], out[7] = cadd(b6, b7), csub(b6, b7)
    return out


def butterfly(v, R, dt):
    if R == 8:
        return dft8(v, dt)
    if R == 5:
        return dft5(v, dt)
    if R == 4:
        return dft4(v)
    if R == 3:
        return dft3(v, dt)
    return dft2(v)


def fft_dif(re, im, n, tw):
    """fft_dif on a block's flat buffer of E complex values (rows of n
    contiguous), in place, pass by pass as the kernel's threads do."""
    dt = re.dtype.name
    E = re.size
    for R, m, s in fft_passes(n):
        u = np.arange(E // R)
        if R in (3, 5):
            blk = fft_div(u, m).astype(np.int64)
            a = u - blk * m
        else:  # m is a power of two: the odd passes come first
            assert m & (m - 1) == 0
            blk, a = u >> (m.bit_length() - 1), u & (m - 1)
        base = blk * R * m + a
        idx = [base + j * m for j in range(R)]
        v = butterfly([(re[i], im[i]) for i in idx], R, dt)
        if m > 1:
            t = a * s
            w1 = (tw[t, 0], tw[t, 1])
            v[1] = cmul(v[1], w1)
            if R in (3, 5):
                for q in range(2, R):
                    v[q] = cmul(v[q], (tw[q * t, 0], tw[q * t, 1]))
            elif R != 2:
                w2 = (tw[2 * t, 0], tw[2 * t, 1])
                w3 = cmul(w1, w2)
                v[2], v[3] = cmul(v[2], w2), cmul(v[3], w3)
                if R == 8:
                    w4 = (tw[4 * t, 0], tw[4 * t, 1])
                    v[4] = cmul(v[4], w4)
                    v[5] = cmul(v[5], cmul(w1, w4))
                    v[6] = cmul(v[6], cmul(w2, w4))
                    v[7] = cmul(v[7], cmul(w3, w4))
        for i, (vr, vi) in zip(idx, v):
            re[i], im[i] = vr, vi


def fft_pos(k, n):
    """fft_pos: the slot of frequency k, the mixed-radix digit reversal
    of the plan: the radix-3 and radix-5 passes' digits, then the
    power-of-two passes' 3-bit digits and a 1- or 2-bit one."""
    k = np.asarray(k)
    pos = np.zeros_like(k)
    for R, m, _ in fft_passes(n):
        if R in (3, 5):
            q = k // R
            pos = pos + (k - q * R) * m
            k = q
    lg2 = exponents(n)[0]
    L = 1 << lg2
    for _ in range(lg2 // 3):
        L >>= 3
        pos = pos + (k & 7) * L
        k = k >> 3
    rem = lg2 % 3
    if rem:
        pos = pos + (k & ((1 << rem) - 1)) * (L >> rem)
    return pos


def emulate_rfft(x, K):
    """The FFT arm's spectra of real rows x (R, n) in x's dtype: rows
    (2g, 2g+1) as one complex row (a lone last row against zeros), the
    transform, then the split for k < K.  Returns (dr, di), (R, K)."""
    R, n = x.shape
    dt = x.dtype.name
    tw, = TF._fft_twiddles(n, dt)
    rows = np.zeros((R + R % 2, n), x.dtype)
    rows[:R] = x
    re = rows[0::2].reshape(-1).copy()
    im = rows[1::2].reshape(-1).copy()
    fft_dif(re, im, n, tw)
    k = np.arange(K)
    half = np.dtype(dt).type(0.5)
    g0 = (np.arange(rows.shape[0] // 2) * n)[:, None]
    zk = g0 + fft_pos(k, n)[None, :]
    zc = g0 + fft_pos((n - k) % n, n)[None, :]
    ar, ai, cr, ci = re[zk], im[zk], re[zc], im[zc]
    X = ((ar + cr) * half, (ai - ci) * half)
    Y = ((ai + ci) * half, (cr - ar) * half)
    dr = np.empty((rows.shape[0], K), x.dtype)
    di = np.empty_like(dr)
    dr[0::2], di[0::2] = X
    dr[1::2], di[1::2] = Y
    return dr[:R], di[:R]


def emulate_cross_spectrum(port, model, w, K, want_m2=False):
    """The FFT arm's B1 outputs: the model spectrum, then the data rows'
    with the epilogue's arithmetic (S0 summed over k)."""
    nchan, n = port.shape[-2], port.shape[-1]
    M = port.size // n
    mr, mi = emulate_rfft(model.reshape(-1, n), K)
    dr, di = emulate_rfft(port.reshape(M, n), K)
    rows = np.arange(M)
    mr, mi = mr[rows % mr.shape[0]], mi[rows % mi.shape[0]]
    wk = w.reshape(-1, K)[rows % (w.size // K)]
    Xr = (dr * mr + di * mi) * wk
    Xi = (di * mr - dr * mi) * wk
    m2 = (mr * mr + mi * mi) * wk
    o2 = m2 if want_m2 else m2.sum(axis=-1)
    lead = port.shape[:-1]
    return (Xr.reshape(lead + (K,)), Xi.reshape(lead + (K,)),
            o2.reshape(lead + ((K,) if want_m2 else ())))


def _k_cases():
    out = []
    for n in NBINS + NBINS_MIXED:
        for K in sorted({1, 100, n // 2 + 1}):
            if K <= n // 2 + 1:
                out.append((n, K))
    return out


class TestFFTPlan:
    """The emulated plan against torch.fft.rfft of the same rows taken
    in float64.  Tolerance per output array: max abs error <= 5e-6 x
    max|ref| in float32 (torch's own float32 rfft reaches 1.8e-6 on
    these rows; the kernel's check on the cross-spectrum is 1e-5),
    1e-13 in float64 (the emulation reaches 5.2e-16; the check is
    1e-12)."""

    TOL = {"float32": 5e-6, "float64": 1e-13}

    @pytest.mark.parametrize("dt", ["float32", "float64"])
    @pytest.mark.parametrize("n,K", _k_cases())
    def test_rfft_vs_torch(self, n, K, dt):
        rng = np.random.default_rng(n + K)
        x = rng.normal(size=(3, n)).astype(dt)  # odd: a lone last row
        x[1] += 5.0  # a DC offset, as the baselined data carry
        dr, di = emulate_rfft(x, K)
        ref = torch.fft.rfft(torch.from_numpy(x.astype(np.float64)))
        ref = ref[:, :K].numpy()
        assert dr.dtype == np.dtype(dt)
        for got, r, part in ((dr, ref.real, "re"), (di, ref.imag, "im")):
            assert rel_err(got, r) <= self.TOL[dt], part
            if K == n // 2 + 1:
                # DC and, for even n, Nyquist are real
                assert np.all(di[:, [0, -1] if n % 2 == 0 else [0]] == 0)

    @pytest.mark.parametrize("dt", ["float32", "float64"])
    def test_sign_matches_rfft_weights(self, dt):
        """Re = sum x cos, Im = -sum x sin: the matmul DFT's twiddles."""
        n, K = 64, 20
        x = np.random.default_rng(1).normal(size=(2, n)).astype(dt)
        Wc, Ws = TF._rfft_weights(n, dt, K)
        dr, di = emulate_rfft(x, K)
        assert rel_err(dr, x @ Wc) <= tol_for(dt)
        assert rel_err(di, x @ Ws) <= tol_for(dt)

    @pytest.mark.parametrize("n", NBINS + NBINS_MIXED)
    def test_digit_reversal_is_a_permutation(self, n):
        assert sorted(fft_pos(np.arange(n), n).tolist()) == list(range(n))

    def test_digit_reversal_walks_the_plan(self):
        """fft_pos's shortcut over the power-of-two passes (3-bit digits)
        gives the generic mixed-radix walk's slots at every length."""
        for n in NBINS_ALL:
            k, pos = np.arange(n), np.zeros(n, np.int64)
            for R, m, _ in fft_passes(n):
                pos, k = pos + (k % R) * m, k // R
            assert np.array_equal(fft_pos(np.arange(n), n), pos), n

    def test_magic_division_is_exact(self):
        """fft_div's multiply-high equals u / d for every u < 2^16 and
        every length and radix-3/5 stride of every plan."""
        u = np.arange(1 << 16)
        ds = {n for n in NBINS_ALL} | {m for n in NBINS_ALL
                                       for R, m, _ in fft_passes(n)
                                       if R in (3, 5)}
        for d in sorted(ds):
            assert np.array_equal(fft_div(u, d), u // d), d


class TestFFTCrossSpectrum:
    """The emulated FFT arm of B1 against the port's plain version and
    the JAX Pallas kernel (interpret mode).  Tolerance: max abs error
    <= 1e-12 x max|ref| in float64, 1e-5 x max|ref| in float32, per
    output: the chip's check of the kernel."""

    # (nchan, nbin, dt, want_m2, per_element, nb, K)
    CASES = [
        (13, 128, "float64", False, False, 2, 40),
        (13, 128, "float32", True, False, None, 65),
        (7, 256, "float64", False, True, 3, 1),
        (24, 256, "float32", False, False, 2, 100),
        (5, 16, "float64", True, False, None, 9),
        (3, 2048, "float32", False, False, 1, 384),
        # the mixed-radix plan: 8 3, 8 4 3, 3 5 8 and the odd 3 5 5 5
        (6, 96, "float64", False, False, 2, 49),
        (5, 120, "float32", True, False, None, 61),
        (7, 375, "float64", True, True, 2, 100),
        (4, 375, "float32", False, False, 1, 188),
        (5, 1000, "float32", False, False, 2, 384),
        (3, 1000, "float64", True, False, None, 501),
    ]

    @staticmethod
    def _problem(nchan, n, dt, per_element, nb, K, seed=11):
        rng = np.random.default_rng(seed)
        lead = () if nb is None else (nb,)
        port = rng.normal(size=lead + (nchan, n)).astype(dt)
        mshape = lead + (nchan, n) if per_element else (nchan, n)
        model = rng.normal(size=mshape).astype(dt)
        w = rng.uniform(0.5, 2.0, size=lead + (nchan, K)).astype(dt)
        return port, model, w

    @pytest.mark.parametrize(
        "nchan,n,dt,want_m2,per_element,nb,K,ref_impl",
        [c + ("torch_ref",) for c in CASES]
        # the Pallas kernel takes one shared template
        + [c + ("pallas_interpret",) for c in CASES if not c[4]])
    def test_cross_spectrum(self, nchan, n, dt, want_m2, per_element, nb, K,
                            ref_impl):
        port, model, w = self._problem(nchan, n, dt, per_element, nb, K)
        assert TFu.fft_arm(n, K)
        got = emulate_cross_spectrum(port, model, w, K, want_m2)
        if ref_impl == "torch_ref":
            ref = TFu.fused_cross_spectrum_ref(
                torch.from_numpy(port), torch.from_numpy(model),
                torch.from_numpy(w), K, want_m2=want_m2)
            ref = [r.numpy() for r in ref]
        else:
            fn = jax.jit(lambda p, m, wk: JFu.fused_cross_spectrum_pallas(
                p, m, wk, K, want_m2=want_m2, interpret=True))
            if nb is None:
                ref = fn(jnp.asarray(port), jnp.asarray(model),
                         jnp.asarray(w))
            else:
                ref = jax.vmap(fn, (0, None, 0))(
                    jnp.asarray(port), jnp.asarray(model), jnp.asarray(w))
            ref = [np.asarray(r) for r in ref]
        for g, r, part in zip(got, ref, ("Xr", "Xi", "o2")):
            assert g.shape == r.shape, part
            assert rel_err(g, r) <= tol_for(dt), part


class TestSharedMemoryLayout:
    """The padding, sizes and rows per block of the source note."""

    def test_header_constants(self):
        """The Python mirror and the header state the same geometry."""
        src = open(HEADER).read()
        assert re.search(r"FFT_MIN_N = (\d+);", src).group(1) == "16"
        assert re.search(r"FFT_MAX_N = (\d+);", src).group(1) == "8192"
        assert int(re.search(r"FFT_MAX_PASSES = (\d+);", src).group(1)) \
            == FFT_MAX_PASSES
        assert TFu.FFT_NBIN_MIN == 16 and TFu.FFT_NBIN_MAX == 8192
        elems = [int(v) for v in re.findall(r"ELEMS = (\d+);", src)]
        pads = [int(v) for v in re.findall(r"PAD = (\d+);", src)]
        assert elems == [GEOM["float32"]["ELEMS"], GEOM["float64"]["ELEMS"]]
        assert pads == [GEOM["float32"]["PAD"], GEOM["float64"]["PAD"]]
        assert "return i + (i >> Fft<T>::PAD) + (i >> 7);" in src

    @pytest.mark.parametrize("dt", ["float32", "float64"])
    @pytest.mark.parametrize("n", NBINS + NBINS_MIXED)
    def test_padding_fits(self, n, dt):
        """phys is injective on a block's values and fits the buffer;
        B2's block (the buffer or, while the baselines are taken, the
        padded float64 prefix arrays of all its rows up to one per warp,
        whichever is larger; then the packed rows at 4 bits, scratch,
        baselines and reduction) fits the 227 KB of an SM, and at
        n <= 2048 in float32 two blocks do."""
        E = rows_per_block(n, dt) // 2 * n
        p = phys(np.arange(E), dt)
        assert np.all(np.diff(p) > 0)
        nbytes = buffer_bytes(n, dt)
        assert p[-1] < nbytes // GEOM[dt]["CBYTES"]
        rb = rows_per_block(n, dt)
        ng = min(rb, 8)
        chunk = -(-n // (256 // ng))
        front = max(nbytes, ng * (n + n // chunk + 1) * 8)
        extra = ((rb * n // 2 + 15) & ~15) + 64 + rb * 8 + 2 * 64
        assert front + extra <= 232448
        if dt == "float32" and n <= 2048:
            assert 2 * (front + extra) <= 232448

    @pytest.mark.parametrize("dt", ["float32", "float64"])
    def test_rows_split_evenly(self, dt):
        """At every length the arm takes, a block's rows are a power of
        two: its row pairs split evenly over the epilogue's 8 warps (a
        warp group per pair, every warp of it at the S0 barrier, or
        whole pairs per warp), and B2's stat groups (up to one row per
        warp) are a power of two threads wide, a multiple of 32, with
        the rows a whole number of rounds."""
        for n in NBINS_ALL:
            rb = rows_per_block(n, dt)
            assert rb >= 2 and rb & (rb - 1) == 0, n
            assert rb // 2 * n * 2 > GEOM[dt]["ELEMS"] or rb == 2, n
            assert rb // 2 * n <= max(GEOM[dt]["ELEMS"], n), n
            npair = rb // 2
            assert npair % 8 == 0 or 8 % npair == 0, n
            ng = min(rb, 8)
            G = 256 // ng
            assert rb % ng == 0 and G % 32 == 0 and G & (G - 1) == 0, n

    @staticmethod
    def _wavefronts(slots, cbytes):
        """Shared-memory wavefronts of one warp access of complex slots
        (8-byte values per half-warp, 16-byte per quarter-warp); a warp
        of fewer than 32 threads leaves its last groups empty."""
        per = 128 // cbytes
        tot = 0
        for h in range(0, 32, per):
            banks = {}
            for e in slots[h:h + per]:
                for q in range(cbytes // 4):
                    word = e * cbytes // 4 + q
                    banks.setdefault(word % 32, set()).add(word)
            if banks:
                tot += max(len(b) for b in banks.values())
        return tot

    @classmethod
    def _pass_factors(cls, n, dt):
        """Wavefronts per ideal one of each pass of the plan over a
        block, the kernel's threads in warps of 32 (the last one partial)
        and its index arithmetic."""
        cb = GEOM[dt]["CBYTES"]
        E = rows_per_block(n, dt) // 2 * n
        factors = []
        for R, m, _ in fft_passes(n):
            tot = ideal = 0
            for w0 in range(0, E // R, 32):
                u = np.arange(w0, min(w0 + 32, E // R))
                base = (u // m) * R * m + (u % m)
                for j in range(R):
                    tot += cls._wavefronts(
                        [phys(int(i), dt) for i in base + j * m], cb)
                    ideal += -(-len(u) // (128 // cb))
            factors.append(tot / ideal)
        return factors

    @pytest.mark.parametrize("dt", ["float32", "float64"])
    def test_bank_conflicts(self, dt):
        """Per pass at n = 2048, the butterflies' accesses cost at most
        2x the ideal wavefronts and 1.25x (f32) / 1x (f64) on average:
        the figures of the source note."""
        factors = self._pass_factors(2048, dt)
        assert max(factors) <= 2.0
        assert np.mean(factors) <= (1.25 if dt == "float32" else 1.0)

    # the source note's figures, pass by pass
    MIXED_FACTORS = {
        (1000, "float32"): [1.42, 1.52, 2.0, 1.0],
        (1536, "float32"): [1.0, 1.0, 2.0, 1.0],
        (3072, "float32"): [1.0, 1.0, 1.0, 2.0, 1.0],
        (1000, "float64"): [1.0] * 4,
        (1536, "float64"): [1.0] * 4,
        (3072, "float64"): [1.0] * 5,
    }

    @pytest.mark.parametrize("n,dt", sorted(MIXED_FACTORS))
    def test_bank_conflicts_mixed(self, n, dt):
        """The mixed-radix passes at 1000, 1536 and 3072 bins cost at
        most 2 wavefronts per ideal one under the power-of-two padding
        (the odd radices first): the figures of the source note, which
        is why the padding stays."""
        factors = self._pass_factors(n, dt)
        assert max(factors) <= 2.0
        assert np.round(factors, 2).tolist() == self.MIXED_FACTORS[(n, dt)]

    @pytest.mark.parametrize("n,dt,want", [
        (2048, "float32", 2.3), (2048, "float64", 2.4),
        (1000, "float32", 2.4), (1000, "float64", 2.8),
        (1536, "float32", 2.0), (1536, "float64", 3.5),
        (3072, "float32", 2.0), (3072, "float64", 3.0)])
    def test_epilogue_gathers(self, n, dt, want):
        """The epilogue's digit-reversed reads of Z_k and Z_{n-k}, a
        warp's 32 harmonics at a time, at K = 384: wavefronts per ideal
        one as the source note states them."""
        cb, K = GEOM[dt]["CBYTES"], 384
        tot = ideal = 0
        for w0 in range(0, K, 32):
            k = np.arange(w0, min(K, w0 + 32))
            for kk in (k, (n - k) % n):
                tot += self._wavefronts(
                    [phys(int(i), dt) for i in fft_pos(kk, n)], cb)
                ideal += -(-len(k) // (128 // cb))
        assert round(tot / ideal, 1) == want


def _scan_baseline(s, nbin, win, sc, of, nt):
    """row_baseline's arithmetic in numpy for a group of nt threads:
    float64 chunk sums, their warp scan and the warps' totals in index
    order, every circular window sum, the least one over win, cast to
    the dtype."""
    a = (s.astype(sc.dtype) * sc + of).astype(np.float64)
    chunk = -(-nbin // nt)
    P = np.empty(nbin)
    run = np.zeros(nt)
    for t in range(nt):
        j0, j1 = min(nbin, t * chunk), min(nbin, t * chunk + chunk)
        acc = 0.0
        for j in range(j0, j1):
            acc += a[j]
            P[j] = acc
        run[t] = acc
    incl = run.copy()
    for lane_block in range(0, nt, 32):
        v = run[lane_block:lane_block + 32].copy()
        o = 1
        while o < 32:
            v = v + np.concatenate([np.zeros(o), v[:-o]])
            o <<= 1
        incl[lane_block:lane_block + 32] = v
    totals = incl[31::32]
    for t in range(nt):
        warp, lane = divmod(t, 32)
        off = 0.0
        for q in range(warp):
            off += totals[q]
        excl = off + incl[t - 1] if lane else off
        j0, j1 = min(nbin, t * chunk), min(nbin, t * chunk + chunk)
        P[j0:j1] += excl
    total = P[-1]
    lo = np.inf
    for t in range(nbin):
        before = P[t - 1] if t else 0.0
        end = t + win - 1
        S = P[end] - before if end < nbin else total - before + P[end - nbin]
        lo = min(lo, S)
    return sc.dtype.type(lo / win)


# (nbin, threads per row): the GEMM arm's stats kernel takes a row per
# block of 256 threads; the FFT arm splits its block into groups, 64
# threads a row at 2048 bins in float32, a warp a row at 16 bins
# and 32 at 1000 bins (chunks of 32), 64 at 1536 (chunks of 24)
@pytest.mark.parametrize("nbin,nt", [(16, 32), (16, 256), (200, 256),
                                     (2048, 64), (2048, 256), (1000, 32),
                                     (1536, 64)])
def test_baseline_scan_matches_plain(nbin, nt):
    """The kernels' baseline scan gives the plain min_window_baseline's
    b (float32 rows of 2-bit samples) to within one float32 ulp: both
    sum in float64, in different orders."""
    rng = np.random.default_rng(nbin)
    s = rng.integers(0, 4, size=(4, nbin)).astype(np.uint8)
    sc = rng.uniform(0.5, 1.5, size=4).astype(np.float32)
    of = rng.normal(size=4).astype(np.float32)
    win = TN.baseline_window(nbin)
    x = torch.from_numpy(s.astype(np.float32) * sc[:, None] + of[:, None])
    ref = TN.min_window_baseline(x).numpy()
    for r in range(4):
        got = _scan_baseline(s[r], nbin, win, sc[r], of[r], nt)
        assert abs(float(got) - float(ref[r])) <= np.spacing(abs(ref[r]))


class TestShapeRule:
    """ops.fused.fft_arm, and the pass plan the emulation follows."""

    @pytest.mark.parametrize("nbin,K,arm", [
        (16, 9, True), (8192, 4097, True), (2048, 384, True),
        (2048, 1025, True), (2048, 1026, False), (8, 5, False),
        (16384, 100, False), (1000, 100, True), (1536, 100, True),
        (1022, 100, False), (8100, 100, True), (375, 188, True),
        (375, 189, False), (8748, 100, False), (15, 8, False)])
    def test_fft_arm(self, nbin, K, arm):
        assert TFu.fft_arm(nbin, K) is arm

    def test_fft_arm_every_nbin(self):
        """True at K = 1 exactly for the nbin in [16, 8192] that are
        products of powers of 2, 3 and 5, listed here by their exponents."""
        smooth = {2 ** a * 3 ** b * 5 ** c for a in range(14)
                  for b in range(9) for c in range(6)}
        for n in range(1, 9000):
            assert TFu.fft_arm(n, 1) is (16 <= n <= 8192 and n in smooth), n

    def test_radices(self):
        assert fft_radices(2048) == (8, 8, 8, 4)
        assert fft_radices(16) == (8, 2)
        assert fft_radices(512) == (8, 8, 8)
        assert fft_radices(1000) == (5, 5, 5, 8)
        assert fft_radices(1536) == (3, 8, 8, 8)
        assert fft_radices(3072) == (3, 8, 8, 8, 2)
        assert fft_radices(375) == (3, 5, 5, 5)
        assert fft_radices(6000) == (3, 5, 5, 5, 8, 2)
        for n in NBINS_ALL:
            r = fft_radices(n)
            assert int(np.prod(r)) == n
            assert 1 <= len(r) <= FFT_MAX_PASSES
        assert max(len(fft_radices(n)) for n in NBINS_ALL) == FFT_MAX_PASSES

    def test_forced_fft_arm_outside_the_rule_raises(self):
        port = torch.zeros((2, 1022), dtype=torch.float32)
        w = torch.ones((2, 10), dtype=torch.float32)
        with pytest.raises(ValueError, match="CUDA"):
            TFu.fused_cross_spectrum_cuda(port, port, w, 10, arm="fft")
        with pytest.raises(ValueError, match="FFT arm"):
            TFu._resolve_arm("fft", 1022, 10, "x")
        with pytest.raises(ValueError, match="arm must be"):
            TFu._resolve_arm("cufft", 2048, 10, "x")
        assert TFu._resolve_arm(None, 2048, 384, "x") == "fft"
        assert TFu._resolve_arm("gemm", 2048, 384, "x") == "gemm"
        assert TFu._resolve_arm(None, 1022, 384, "x") == "gemm"
        assert TFu._resolve_arm(None, 1000, 384, "x") == "fft"
        assert TFu._resolve_arm("gemm", 1000, 384, "x") == "gemm"

"""The PyTorch port's ops against the JAX package on the CPU.

B1 (the fused DFT -> cross-spectrum kernel): the port's plain PyTorch
version against the JAX package's scan AND its Pallas kernel run under
``pallas_call(interpret=True)``, over the directed set of
tests/test_pallas_interpret.py.  B2 (the decode-fused kernel): the
port's plain version against the JAX Pallas kernel in interpret mode,
and the decode and noise ops of the streaming lane against the JAX
package's.  Also the matmul DFTs, the Gaussian template carried across
by convert.py, archive loading through the shared native decoder,
import hygiene and the device rule.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_helpers import PAR, rel_err, tol_for

import pulseportraiture_tpu_torch as PT
from pulseportraiture_tpu_torch.ops import decode as TD
from pulseportraiture_tpu_torch.ops import fourier as TF
from pulseportraiture_tpu_torch.ops import fused as TFu
from pulseportraiture_tpu_torch.ops import noise as TN

from pulseportraiture_tpu.ops import decode as JD
from pulseportraiture_tpu.ops import fourier as JF
from pulseportraiture_tpu.ops import fused as JFu
from pulseportraiture_tpu.ops import noise as JN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the kernels' launch counters: each kernel's total and its two arms,
# and B1's want_m2 form
LAUNCH_KEYS = [f"{k}{arm}" for k in ("fused_cross_spectrum",
                                     "fused_decode_cross_spectrum")
               for arm in ("", ".fft", ".gemm")] + ["fused_cross_spectrum.m2"]


def _problem(nchan, nbin, dt, seed=0, nb=None):
    rng = np.random.default_rng(seed)
    lead = () if nb is None else (nb,)
    port = rng.normal(size=lead + (nchan, nbin)).astype(dt)
    model = rng.normal(size=(nchan, nbin)).astype(dt)
    nharm = nbin // 4
    w = rng.uniform(0.5, 2.0, size=lead + (nchan, nharm)).astype(dt)
    return port, model, w, nharm


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestFusedCrossSpectrumParity:
    """B1's plain version vs the JAX scan and the JAX Pallas kernel
    (interpret mode).  Tolerance: max abs error <= 1e-12 x max|ref| in
    float64, 1e-5 x max|ref| in float32."""

    # ragged nchan=13 (never divides the block), f32/f64, fold,
    # want_m2, block override, block not dividing nchan, tiny shape
    DIRECTED = [
        (13, 128, "float64", True, False, None),
        (13, 128, "float32", True, False, None),
        (13, 128, "float64", False, True, None),
        (13, 128, "float64", True, True, 5),
        (24, 256, "float32", False, False, 8),
        (8, 64, "float64", True, False, None),
        # nbin with a prime factor above 5 (1022 = 2 7 73, 1032 = 2^3 3
        # 43): the shapes the kernels' GEMM arm takes on the card
        (13, 1022, "float64", False, False, None),
        (13, 1022, "float32", True, True, None),
        (13, 1032, "float32", False, False, 5),
        (13, 1032, "float64", True, True, None),
    ]

    @pytest.mark.parametrize("jax_impl", ["scan", "pallas_interpret"])
    @pytest.mark.parametrize("nchan,nbin,dt,fold,want_m2,block", DIRECTED)
    def test_parity_directed(self, nchan, nbin, dt, fold, want_m2, block,
                             jax_impl):
        port, model, w, nharm = _problem(nchan, nbin, dt)
        if jax_impl == "scan":
            ref_fn = jax.jit(lambda p, m, wk: JFu.fused_cross_spectrum(
                p, m, wk, nharm, fold=fold, want_m2=want_m2, block=block,
                pallas=False))
        else:
            ref_fn = jax.jit(lambda p, m, wk: JFu.fused_cross_spectrum_pallas(
                p, m, wk, nharm, fold=fold, want_m2=want_m2, block=block,
                interpret=True))
        ref = ref_fn(jnp.asarray(port), jnp.asarray(model), jnp.asarray(w))
        got = TFu.fused_cross_spectrum(_t(port), _t(model), _t(w), nharm,
                                       fold=fold, want_m2=want_m2,
                                       block=block)
        for r, g, name in zip(ref, got, ("Xr", "Xi", "o2")):
            assert g.shape == r.shape, name
            assert g.dtype == getattr(torch, dt), name
            assert rel_err(g.numpy(), r) <= tol_for(dt), name

    @pytest.mark.parametrize("dt", ["float64", "float32"])
    def test_batched_shared_template(self, dt):
        """The deployed shape: a batch of subints against one shared
        template, vs the JAX scan vmapped with the model unbatched."""
        port, model, w, nharm = _problem(16, 128, dt, seed=7, nb=3)
        ref = jax.jit(jax.vmap(
            lambda p, wk: JFu.fused_cross_spectrum(
                p, jnp.asarray(model), wk, nharm, pallas=False),
            (0, 0)))(jnp.asarray(port), jnp.asarray(w))
        got = TFu.fused_cross_spectrum(_t(port), _t(model), _t(w), nharm)
        for r, g, name in zip(ref, got, ("Xr", "Xi", "S0")):
            assert rel_err(g.numpy(), r) <= tol_for(dt), name

    def test_per_element_models_match_shared(self):
        """Per-element models equal to the shared template give the
        shared-template result exactly (same arithmetic per row)."""
        port, model, w, nharm = _problem(13, 128, "float64", seed=3, nb=2)
        shared = TFu.fused_cross_spectrum(_t(port), _t(model), _t(w), nharm)
        per = TFu.fused_cross_spectrum(
            _t(port), _t(np.broadcast_to(model, port.shape).copy()), _t(w),
            nharm)
        for a, b in zip(shared, per):
            assert torch.equal(a, b)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        port, model, w, nharm = _problem(8, 64, "float32")
        with pytest.raises(ValueError):
            TFu.fused_cross_spectrum_cuda(_t(port), _t(model), _t(w), nharm)

    def test_cpu_dispatch_launches_no_kernel(self):
        TFu.reset_kernel_launches()
        port, model, w, nharm = _problem(8, 64, "float32")
        TFu.fused_cross_spectrum(_t(port), _t(model), _t(w), nharm)
        assert TFu.kernel_launches() == dict.fromkeys(LAUNCH_KEYS, 0)


def _packed_problem(code, nchan, nbin, dt, seed=3):
    """test_pallas_interpret.TestDecodeKernelParity's inputs: random
    packed bytes, scl in [0.5, 2), normal offs, a normal model and
    weights in [0.5, 2) over nbin // 4 harmonics."""
    rng = np.random.default_rng(seed)
    nbit = JD.PACKED_BITS[code]
    bpc = (nbin * nbit) // 8
    packed = rng.integers(0, 256, size=(nchan * bpc,)).astype(np.uint8)
    scl = rng.uniform(0.5, 2.0, size=(nchan,)).astype(dt)
    offs = rng.normal(size=(nchan,)).astype(dt)
    model = rng.normal(size=(nchan, nbin)).astype(dt)
    nharm = nbin // 4
    w = rng.uniform(0.5, 2.0, size=(nchan, nharm)).astype(dt)
    return packed.reshape(nchan, bpc), scl, offs, model, w, nharm


class TestFusedDecodeCrossSpectrumParity:
    """B2's plain version vs the JAX Pallas kernel in interpret mode at
    13 x 128 (ragged against every block).  Tolerance: max abs error
    <= 1e-12 x max|ref| in float64, 1e-5 x max|ref| in float32, per
    output (Xr, Xi, S0, pwr, x0)."""

    @pytest.mark.parametrize("code", ["p1", "p2", "p4"])
    @pytest.mark.parametrize("fold,block,dt", [
        (False, None, "float64"), (True, None, "float64"),
        (False, 7, "float64"), (True, 7, "float64"),
        (False, None, "float32"), (True, 7, "float32")])
    def test_parity(self, code, fold, block, dt):
        nchan, nbin = 13, 128
        raw, scl, offs, model, w, nharm = _packed_problem(code, nchan, nbin,
                                                          dt)
        ref = jax.jit(lambda p, s, o, m, wk:
                      JFu.fused_decode_cross_spectrum_pallas(
                          p, s, o, m, wk, nharm, code=code, nbin=nbin,
                          fold=fold, block=block, interpret=True))(
            jnp.asarray(raw), jnp.asarray(scl), jnp.asarray(offs),
            jnp.asarray(model), jnp.asarray(w))
        got = TFu.fused_decode_cross_spectrum(
            _t(raw), _t(scl), _t(offs), _t(model), _t(w), nharm, code=code,
            nbin=nbin, fold=fold, block=block)
        for r, g, name in zip(ref, got, ("Xr", "Xi", "S0", "pwr", "x0")):
            assert g.shape == r.shape, name
            assert g.dtype == getattr(torch, dt), name
            assert rel_err(g.numpy(), r) <= tol_for(dt), name

    # nbin with a prime factor above 5: 1032 = 2^3 3 43 packs at 1, 2
    # and 4 bits, 1022 = 2 7 73 at 4 bits only (nbin nbit / 8 whole)
    @pytest.mark.parametrize("code,nbin,fold,dt", [
        ("p1", 1032, False, "float32"), ("p2", 1032, False, "float64"),
        ("p2", 1032, True, "float32"), ("p4", 1032, False, "float32"),
        ("p4", 1022, True, "float64"), ("p4", 1022, False, "float32")])
    def test_parity_prime_nbin(self, code, nbin, fold, dt):
        nchan = 13
        raw, scl, offs, model, w, nharm = _packed_problem(code, nchan, nbin,
                                                          dt)
        ref = jax.jit(lambda p, s, o, m, wk:
                      JFu.fused_decode_cross_spectrum_pallas(
                          p, s, o, m, wk, nharm, code=code, nbin=nbin,
                          fold=fold, interpret=True))(
            jnp.asarray(raw), jnp.asarray(scl), jnp.asarray(offs),
            jnp.asarray(model), jnp.asarray(w))
        got = TFu.fused_decode_cross_spectrum(
            _t(raw), _t(scl), _t(offs), _t(model), _t(w), nharm, code=code,
            nbin=nbin, fold=fold)
        for r, g, name in zip(ref, got, ("Xr", "Xi", "S0", "pwr", "x0")):
            assert g.shape == r.shape, name
            assert g.dtype == getattr(torch, dt), name
            assert rel_err(g.numpy(), r) <= tol_for(dt), name

    def test_batched_rows_match_per_element(self):
        """A (B, nchan, bpc) batch gives each element's unbatched
        result: the decode and the tiling are per row."""
        raw, scl, offs, model, w, nharm = _packed_problem("p2", 9, 128,
                                                          "float64")
        raw2 = np.stack([raw, raw[::-1].copy()])
        scl2, offs2 = np.stack([scl, scl[::-1]]), np.stack([offs, offs])
        w2 = np.stack([w, w[::-1]])
        got = TFu.fused_decode_cross_spectrum(
            _t(raw2), _t(scl2), _t(offs2), _t(model), _t(w2), nharm,
            code="p2", nbin=128)
        for b in range(2):
            one = TFu.fused_decode_cross_spectrum(
                _t(raw2[b]), _t(scl2[b]), _t(offs2[b]), _t(model),
                _t(w2[b]), nharm, code="p2", nbin=128)
            for a, c in zip(got, one):
                assert rel_err(a[b].numpy(), c.numpy()) <= 1e-14

    @pytest.mark.parametrize("code", ["p1", "p2", "p4"])
    def test_unpack_exact(self, code):
        nbit = TD.PACKED_BITS[code]
        raw = np.random.default_rng(5).integers(
            0, 256, size=(3, 40)).astype(np.uint8)
        nsamp = 40 * (8 // nbit) - 3  # trims a partial byte's samples
        ref = np.asarray(JD.unpack_bitplanes(jnp.asarray(raw), nbit, nsamp))
        got = TD.unpack_bitplanes(_t(raw), nbit, nsamp)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_refuses_bad_inputs(self):
        """The JAX kernel's refusals, by every entry point of B2."""
        model = torch.zeros((4, 100), dtype=torch.float64)
        w = torch.ones((4, 25), dtype=torch.float64)
        raw = torch.zeros((4, 25), dtype=torch.uint8)
        one = torch.ones(4, dtype=torch.float64)
        for fn in (TFu.fused_decode_cross_spectrum,
                   TFu.fused_decode_cross_spectrum_ref,
                   TFu.fused_decode_cross_spectrum_cuda):
            with pytest.raises(ValueError, match="packed sub-byte"):
                fn(raw, one, one, model, w, 25, code="i16", nbin=100)
            with pytest.raises(ValueError, match="byte-aligned"):
                # 100 bins x 1 bit = 100 bits: not a whole byte count
                fn(raw, one, one, model, w, 25, code="p1", nbin=100)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        raw, scl, offs, model, w, nharm = _packed_problem("p4", 4, 64,
                                                          "float32")
        with pytest.raises(ValueError, match="CUDA"):
            TFu.fused_decode_cross_spectrum_cuda(
                _t(raw), _t(scl), _t(offs), _t(model), _t(w), nharm,
                code="p4", nbin=64)

    def test_cpu_dispatch_launches_no_kernel(self):
        TFu.reset_kernel_launches()
        raw, scl, offs, model, w, nharm = _packed_problem("p2", 4, 64,
                                                          "float32")
        TFu.fused_decode_cross_spectrum(_t(raw), _t(scl), _t(offs),
                                        _t(model), _t(w), nharm, code="p2",
                                        nbin=64)
        assert TFu.kernel_launches() == dict.fromkeys(LAUNCH_KEYS, 0)


def _raw_payload(code, nb, nchan, nbin, rng, npol=None):
    """Random wire samples of a raw code: (nb, [npol,] nchan, nbin)
    samples, or (nb, [npol,] plane_bytes) packed bytes."""
    lead = (nb,) if npol is None else (nb, npol)
    nbit = TD.PACKED_BITS.get(code)
    if nbit is not None:
        return rng.integers(0, 256, size=lead + (nchan * nbin * nbit // 8,)
                            ).astype(np.uint8)
    if code == "i16":
        return rng.integers(-3000, 3000, size=lead + (nchan, nbin)
                            ).astype(np.int16)
    if code == "f32":
        return rng.normal(size=lead + (nchan, nbin)).astype(np.float32)
    return rng.integers(0, 256, size=lead + (nchan, nbin)).astype(np.uint8)


class TestDecodeOpsParity:
    """ops.decode and ops.noise vs the JAX package's, on the same
    numpy inputs: decode_stokes_I for every raw code, the two-pol sum
    and TSCAL/TZERO column scaling; the baseline, noise and S/N in
    float64 (1e-12 x max|ref|) and float32 (1e-5 x max|ref|)."""

    @pytest.mark.parametrize("dt", ["float64", "float32"])
    @pytest.mark.parametrize("code", list(TD.RAW_CODES))
    def test_decode_stokes_I(self, code, dt):
        assert TD.RAW_CODES == JD.RAW_CODES
        rng = np.random.default_rng(21)
        nb, nchan, nbin = 3, 5, 64
        raw = _raw_payload(code, nb, nchan, nbin, rng)
        scl = rng.uniform(0.5, 2.0, size=(nb, nchan)).astype(dt)
        offs = rng.normal(size=(nb, nchan)).astype(dt)
        ref = JD.decode_stokes_I(jnp.asarray(raw), jnp.asarray(scl),
                                 jnp.asarray(offs), getattr(jnp, dt),
                                 code=code, nbin=nbin)
        got = TD.decode_stokes_I(_t(raw), _t(scl), _t(offs),
                                 getattr(torch, dt), code=code, nbin=nbin)
        assert tuple(got.shape) == (nb, nchan, nbin)
        assert rel_err(got.numpy(), ref) <= tol_for(dt)

    @pytest.mark.parametrize("code", ["i16", "p2"])
    def test_pol_sum(self, code):
        rng = np.random.default_rng(22)
        nb, nchan, nbin = 2, 4, 64
        raw = _raw_payload(code, nb, nchan, nbin, rng, npol=2)
        scl = rng.uniform(0.5, 2.0, size=(nb, 2, nchan))
        offs = rng.normal(size=(nb, 2, nchan))
        ref = JD.decode_stokes_I(jnp.asarray(raw), jnp.asarray(scl),
                                 jnp.asarray(offs), jnp.float64,
                                 code=code, pol_sum=True, nbin=nbin)
        got = TD.decode_stokes_I(_t(raw), _t(scl), _t(offs),
                                 torch.float64, code=code, pol_sum=True,
                                 nbin=nbin)
        assert tuple(got.shape) == (nb, nchan, nbin)
        assert rel_err(got.numpy(), ref) <= 1e-12

    @pytest.mark.parametrize("code", ["i16", "u8", "i8"])
    def test_column_scaling(self, code):
        rng = np.random.default_rng(23)
        nb, nchan, nbin = 3, 4, 32
        raw = _raw_payload(code, nb, nchan, nbin, rng)
        scl = rng.uniform(0.5, 2.0, size=(nb, nchan))
        offs = rng.normal(size=(nb, nchan))
        tscal = rng.uniform(0.5, 1.5, size=nb)
        tzero = rng.normal(size=nb)
        ref = JD.decode_stokes_I(jnp.asarray(raw), jnp.asarray(scl),
                                 jnp.asarray(offs), jnp.float64, code=code,
                                 tscal=jnp.asarray(tscal),
                                 tzero=jnp.asarray(tzero))
        got = TD.decode_stokes_I(_t(raw), _t(scl), _t(offs), torch.float64,
                                 code=code, tscal=_t(tscal),
                                 tzero=_t(tzero))
        assert rel_err(got.numpy(), ref) <= 1e-12

    def test_unknown_code_refused(self):
        with pytest.raises(ValueError, match="unknown raw sample code"):
            TD.affine_decode(torch.zeros(1, 2, 3), torch.ones(1, 2),
                             torch.zeros(1, 2), torch.float64, code="i32")

    @pytest.mark.parametrize("dt", ["float64", "float32"])
    @pytest.mark.parametrize("nbin", [128, 101])
    def test_baseline_noise_snr(self, dt, nbin):
        rng = np.random.default_rng(24)
        x = (rng.normal(size=(3, 6, nbin))
             + 4.0 * np.exp(-0.5 * ((np.arange(nbin) - 30.0) / 4.0) ** 2)
             + rng.normal(size=(3, 6, 1))).astype(dt)
        xj, xt = jnp.asarray(x), _t(x)
        pairs = [(JN.min_window_baseline(xj), TN.min_window_baseline(xt)),
                 (JN.get_noise_PS(xj), TN.get_noise_PS(xt)),
                 (JN.get_SNR(xj), TN.get_SNR(xt)),
                 (JN.get_SNR(xj, 0.5 * JN.get_noise_PS(xj)),
                  TN.get_SNR(xt, 0.5 * TN.get_noise_PS(xt)))]
        for r, g in pairs:
            assert g.dtype == getattr(torch, dt)
            assert rel_err(g.numpy(), r) <= tol_for(dt)

    @pytest.mark.parametrize("dt", ["float64", "float32"])
    def test_median_even_length_is_mean_of_middles(self, dt):
        """jnp.median's semantics: with an even count the median is the
        mean of the two middle values (torch.median would return the
        lower one)."""
        x = np.array([[4.0, 1.0, 3.0, 2.0], [7.0, 7.0, 1.0, 9.0]], dt)
        got = TN.median_lastaxis(_t(x))
        np.testing.assert_array_equal(got.numpy(), np.array([2.5, 7.0], dt))
        big = np.random.default_rng(25).normal(size=(5, 2048)).astype(dt)
        ref = JN.exact_median_lastaxis(jnp.asarray(big))
        np.testing.assert_array_equal(TN.median_lastaxis(_t(big)).numpy(),
                                      np.asarray(ref))
        assert not torch.equal(TN.median_lastaxis(_t(big)),
                               torch.median(_t(big), dim=-1).values)


class TestMatmulDFTParity:
    """rfft_mm / irfft_mm vs the JAX package's, same tolerances."""

    @pytest.mark.parametrize("dt", ["float64", "float32"])
    @pytest.mark.parametrize("nharm,fold", [(None, False), (40, False),
                                            (None, True), (40, True)])
    def test_rfft_mm(self, dt, nharm, fold):
        x = np.random.default_rng(11).normal(size=(5, 128)).astype(dt)
        ref = JF.rfft_mm(jnp.asarray(x), nharm=nharm, fold=fold)
        got = TF.rfft_mm(_t(x), nharm=nharm, fold=fold)
        for r, g in zip(ref, got):
            assert rel_err(g.numpy(), r) <= tol_for(dt)

    @pytest.mark.parametrize("dt", ["float64", "float32"])
    @pytest.mark.parametrize("nharm,n", [(65, None), (40, 256)])
    def test_irfft_mm(self, dt, nharm, n):
        rng = np.random.default_rng(12)
        Xr = rng.normal(size=(3, nharm)).astype(dt)
        Xi = rng.normal(size=(3, nharm)).astype(dt)
        ref = JF.irfft_mm(jnp.asarray(Xr), jnp.asarray(Xi), n=n)
        got = TF.irfft_mm(_t(Xr), _t(Xi), n=n)
        assert rel_err(got.numpy(), ref) <= tol_for(dt)

    def test_rfft_mm_matches_numpy(self):
        x = np.random.default_rng(13).normal(size=(4, 96))
        Xr, Xi = TF.rfft_mm(_t(x))
        X = np.fft.rfft(x, axis=-1)
        assert rel_err(Xr.numpy(), X.real) <= 1e-12
        assert rel_err(Xi.numpy(), X.imag) <= 1e-12

    def test_precision_knob_is_strict(self):
        x = _t(np.zeros((2, 16)))
        with pytest.raises(ValueError):
            TF.rfft_mm(x, precision="fast")
        # the CPU computes full float32 products for every setting
        TF.rfft_mm(x, precision="high")


class TestGaussianTemplateParity:
    """gen_gmodel_portrait of a model carried across by convert.py, in
    float64, within 1e-12 x max|ref|."""

    @pytest.mark.parametrize("tau", [0.0, 2e-4])
    def test_template_from_fields(self, tau):
        from pulseportraiture_tpu.io.gmodel import gen_gmodel_portrait as jg
        from pulseportraiture_tpu.synth import default_test_model as jdm
        from pulseportraiture_tpu_torch.convert import (
            gaussian_model_from_fields)
        from pulseportraiture_tpu_torch.io.gmodel import (
            gen_gmodel_portrait as tg)

        jm = jdm(1500.0)
        jm.tau = tau
        freqs = np.linspace(1100.0, 1900.0, 24)
        P = PAR["P0"]
        ref = jg(jm, np.arange(256), freqs, P=P)
        tm = gaussian_model_from_fields(jm)
        got = tg(tm, np.arange(256), freqs, P=P, device="cpu")
        assert got.dtype == np.float64
        assert rel_err(got, ref) <= 1e-12

    def test_template_from_flat(self):
        from pulseportraiture_tpu.io.gmodel import gen_gmodel_portrait as jg
        from pulseportraiture_tpu.io.gmodel import model_to_flat
        from pulseportraiture_tpu.synth import default_test_model as jdm
        from pulseportraiture_tpu_torch.convert import (
            gaussian_model_from_flat)
        from pulseportraiture_tpu_torch.io.gmodel import (
            gen_gmodel_portrait as tg)

        jm = jdm(1400.0)
        params, flags = model_to_flat(jm)
        tm = gaussian_model_from_flat(jm.name, jm.code, jm.nu_ref, params,
                                      flags, jm.alpha)
        freqs = np.linspace(1200.0, 1600.0, 9)
        ref = jg(jm, np.arange(128), freqs)
        got = tg(tm, np.arange(128), freqs, device="cpu")
        assert rel_err(got, ref) <= 1e-12

    def test_gmodel_file_round_trip(self, tmp_path):
        """A .gmodel written by the JAX package reads back in the port
        as the same model."""
        from pulseportraiture_tpu.io.gmodel import write_gmodel
        from pulseportraiture_tpu.synth import default_test_model as jdm
        from pulseportraiture_tpu_torch.io.gmodel import read_gmodel

        path = str(tmp_path / "m.gmodel")
        jm = jdm(1500.0)
        write_gmodel(jm, path, quiet=True)
        tm = read_gmodel(path, quiet=True)
        for k in ("locs", "wids", "amps", "mlocs", "mwids", "mamps"):
            np.testing.assert_allclose(getattr(tm, k), getattr(jm, k),
                                       rtol=1e-7)
        assert (tm.nu_ref, tm.code, tm.alpha) == (jm.nu_ref, jm.code,
                                                  jm.alpha)


class TestArchiveLoading:
    """load_data through the shared native decoder returns the JAX
    package's arrays exactly, and the port builds the decoder into its
    own build directory."""

    @staticmethod
    def _assert_same_load(path):
        from pulseportraiture_tpu.io.psrfits import load_data as jl
        from pulseportraiture_tpu_torch.io.psrfits import load_data as tl

        a = jl(path, quiet=True)
        b = tl(path, quiet=True)
        for k in ("subints", "freqs", "weights", "noise_stds", "SNRs",
                  "Ps", "doppler_factors", "subtimes"):
            np.testing.assert_array_equal(np.asarray(b[k]),
                                          np.asarray(a[k]), err_msg=k)
        assert list(b.ok_isubs) == list(a.ok_isubs)
        assert (b.nsub, b.nchan, b.nbin, b.DM) == (a.nsub, a.nchan, a.nbin,
                                                   a.DM)
        assert [e.to_float() for e in b.epochs] == \
            [e.to_float() for e in a.epochs]

    def test_native_decoder_in_port_build_dir(self):
        from pulseportraiture_tpu_torch.io import native

        assert native._SO.startswith(os.path.join(REPO, "build", "native"))
        assert native._SRC == os.path.join(REPO, "native", "ppt_native.cpp")
        assert native.available()

    def test_forged_archive(self, tmp_path):
        from fits_forge import forge_archive

        path = str(tmp_path / "forged.fits")
        forge_archive(path, nsub=3, nchan=8, nbin=64)
        self._assert_same_load(path)

    def test_fake_pulsar_archive(self, tmp_path):
        from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                      make_fake_pulsar)

        path = str(tmp_path / "fake.fits")
        make_fake_pulsar(default_test_model(1500.0), PAR, outfile=path,
                         nsub=2, nchan=16, nbin=128, tsub=60.0,
                         noise_stds=0.1, quiet=True, rng=5, device="cpu")
        self._assert_same_load(path)


def test_import_hygiene():
    """Every module of the port imports with neither jax nor the JAX
    package ending up in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pulseportraiture_tpu_torch as p\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        "new = {p.__name__ + '.' + n for n in ('ops.decode', 'ops.noise',"
        " 'pipeline.stream', 'ops.phasor', 'ops.rotation', 'models.spline',"
        " 'io.splmodel', 'fit.phase_shift', 'convert', 'quality.excision',"
        " 'quality.postfit', 'pipeline.zap', 'pipeline.portrait',"
        " 'synth.rfi', 'cli.ppzap', 'parallel.batch', 'pipeline.align',"
        " 'models.wavelet', 'cli.ppalign', 'fit.lm', 'fit.gauss',"
        " 'fit.powlaw', 'pipeline.gauss', 'pipeline.spline',"
        " 'cli.ppgauss', 'cli.ppspline', 'utils.spin', 'timing',"
        " 'timing.tim', 'timing.binary', 'timing.gls', 'timing.fleet',"
        " 'timing.incremental', 'cli.pptime', 'pipeline.factory',"
        " 'cli.ppfactory', 'synth.fake', 'obs.trace', 'obs.metrics',"
        " 'obs.slo', 'serve.queue', 'serve.codec', 'serve.cache',"
        " 'serve.server', 'serve.client', 'utils.device',"
        " 'cli.ppserve', 'serve.transport', 'serve.fleet',"
        " 'serve.router', 'cli.pproute', 'ingest', 'ingest.source',"
        " 'ingest.alerts', 'ingest.driver', 'cli.ppwatch', 'obs.merge',"
        " 'cli.ppmon', 'tune', 'tune.capability', 'tune.store',"
        " 'tune.autotune', 'profiling', 'viz', 'viz.plots',"
        " 'viz.selector', 'ops.filters', 'ops.ism', 'fit.reference_numpy',"
        " 'parallel.mesh', 'parallel.multihost', 'utils.collectives')}\n"
        "assert new <= names, new - names\n"
        "assert 'matplotlib' not in sys.modules\n"
        "bad = [k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'pulseportraiture_tpu' or "
        "k.startswith('pulseportraiture_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


class TestDeviceRule:
    """With no card, an entry point given no device raises instead of
    running on the CPU."""

    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_resolver(self):
        with pytest.raises(RuntimeError):
            PT.resolve_device()
        assert PT.resolve_device("cpu").type == "cpu"

    def test_fit_entry_point(self):
        from pulseportraiture_tpu_torch.fit import fit_portrait_batch_fast

        port, model, _, _ = _problem(4, 64, "float64", nb=1)
        with pytest.raises(RuntimeError):
            fit_portrait_batch_fast(port, model, np.ones((1, 4)),
                                    np.linspace(1200, 1500, 4), 0.004,
                                    np.array([1300.0]))

    def test_pipeline_entry_point(self, tmp_path):
        from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
        from pulseportraiture_tpu_torch.pipeline import GetTOAs
        from pulseportraiture_tpu_torch.synth import default_test_model

        g = str(tmp_path / "m.gmodel")
        write_gmodel(default_test_model(), g, quiet=True)
        with pytest.raises(RuntimeError):
            GetTOAs(g, g, quiet=True)

    def test_template_entry_points(self, tmp_path):
        from pulseportraiture_tpu_torch.cli.ppgauss import main as ppgauss
        from pulseportraiture_tpu_torch.cli.ppspline import main as ppspline
        from pulseportraiture_tpu_torch.pipeline.gauss import GaussPortrait
        from pulseportraiture_tpu_torch.pipeline.spline import (
            SplinePortrait)

        path = str(tmp_path / "a.fits")
        for cls in (GaussPortrait, SplinePortrait):
            with pytest.raises(RuntimeError):
                cls(path, quiet=True)
        for main in (ppgauss, ppspline):
            with pytest.raises(RuntimeError):
                main(["-d", path])

    def test_factory_and_timing_entry_points(self, tmp_path):
        from pulseportraiture_tpu_torch.cli.ppfactory import main as ppfac
        from pulseportraiture_tpu_torch.cli.pptime import main as pptime
        from pulseportraiture_tpu_torch.pipeline import build_templates
        from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                      fake_timing_campaign)
        from pulseportraiture_tpu_torch.synth import make_fake_pulsar
        from pulseportraiture_tpu_torch.timing import fleet_gls_fit
        from pulseportraiture_tpu_torch.timing.binary import (
            ell1_delay_and_partials)

        path = str(tmp_path / "a.fits")
        meta = tmp_path / "meta.txt"
        meta.write_text(path + "\n")
        with pytest.raises(RuntimeError):
            build_templates([path])
        with pytest.raises(RuntimeError):
            ppfac(["-M", str(meta)])
        par = {"PSR": "X", "F0": "200.0", "PEPOCH": "55000", "DM": "10"}
        toas, _ = fake_timing_campaign(par, n_epochs=3, rng=1)
        with pytest.raises(RuntimeError):
            fleet_gls_fit([("X", toas, par)])
        tim, pf = tmp_path / "x.tim", tmp_path / "x.par"
        tim.write_text("a 0.0 55000.5 0.1 @ -pp_dm 10 -pp_dme 1e-4\n"
                       "b 0.0 55001.5 0.1 @ -pp_dm 10 -pp_dme 1e-4\n")
        pf.write_text("F0 200.0\nPEPOCH 55000\nDM 10\n")
        with pytest.raises(RuntimeError):
            pptime([str(tim), str(pf)])
        with pytest.raises(RuntimeError):
            ell1_delay_and_partials(np.zeros(3), 86400.0, 0.1, 0.0, 0.0)
        with pytest.raises(RuntimeError):
            make_fake_pulsar(default_test_model(), {"P0": 0.004,
                                                    "PEPOCH": 55000.0},
                             outfile=path, spin_coherent=True, quiet=True)

    def test_align_entry_point(self, tmp_path):
        from pulseportraiture_tpu_torch.cli.ppalign import main
        from pulseportraiture_tpu_torch.pipeline import (
            align_archives, gaussian_seed_portrait)

        with pytest.raises(RuntimeError):
            align_archives([str(tmp_path / "a.fits")], np.ones((4, 64)),
                           outfile=str(tmp_path / "out.fits"), quiet=True)
        with pytest.raises(RuntimeError):
            gaussian_seed_portrait(4, 64, 0.05)
        meta = tmp_path / "meta.txt"
        meta.write_text(str(tmp_path / "a.fits") + "\n")
        with pytest.raises(RuntimeError):
            main(["-M", str(meta), "-o", str(tmp_path / "out.fits")])

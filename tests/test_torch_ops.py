"""The PyTorch port's ops against the JAX package on the CPU.

B1 (the fused DFT -> cross-spectrum kernel): the port's plain PyTorch
version against the JAX package's scan AND its Pallas kernel run under
``pallas_call(interpret=True)``, over the directed set of
tests/test_pallas_interpret.py.  Also the matmul DFTs, the Gaussian
template carried across by convert.py, archive loading through the
shared native decoder, import hygiene and the device rule.
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
from pulseportraiture_tpu_torch.ops import fourier as TF
from pulseportraiture_tpu_torch.ops import fused as TFu

from pulseportraiture_tpu.ops import fourier as JF
from pulseportraiture_tpu.ops import fused as JFu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        assert TFu.kernel_launches() == {"fused_cross_spectrum": 0}


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
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
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

"""The port's scale-out layer in one process (world size 1): the rank
mesh, shard_batch, the sharded fits and align iteration against the JAX
package's sharded programs, init_multihost and the backend rule.

The JAX side runs on make_mesh() over the 8 virtual CPU devices of
tests/conftest.py (4 x 2 where channels are sharded); the port's on its
1 x 1 mesh.  Both run float64 on the fast path (config.use_fast_fit,
config.fit_fused, an explicit harmonic window K = 128 at 256 bins,
ROADMAP's parity rule).  Tolerances: phi within 1e-9 rot; DM, the
errors, snr, scales and chi2 within 1e-8 relative (1e-7 on the
scattering lane, as tests/test_torch_scatter.py); nfeval and return
codes equal; the align template within 1e-10 of max |template|.
Two real processes are tests/test_torch_multiprocess.py.
"""

import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import SCALE_K as K
from test_torch_helpers import SCALE_NB as NB
from test_torch_helpers import SCALE_P0 as P0
from test_torch_helpers import make_sharded_batch as make_batch
from test_torch_helpers import rel_err

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import parallel as JPar
from pulseportraiture_tpu.fit import FitFlags as JFlags
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import parallel as TPar
from pulseportraiture_tpu_torch.fit.portrait import FitFlags as TFlags
from pulseportraiture_tpu_torch.parallel import mesh as TMesh
from pulseportraiture_tpu_torch.parallel import multihost as TM

NCHAN, NBIN = 16, 256
CLUSTER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE", "SLURM_PROCID",
                "SLURM_NTASKS", "SLURM_NODELIST", "SLURM_STEP_NODELIST",
                "SLURM_JOB_NODELIST", "SLURM_LOCALID",
                "SLURM_NTASKS_PER_NODE")


@pytest.fixture
def fast_config():
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window",
            "scatter_compensated")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = K
    jcfg.scatter_compensated = tcfg.scatter_compensated = False
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def assert_fit_parity(got, ref, tol=1e-8):
    got = {k: v.numpy() for k, v in got._asdict().items()}
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    assert got["phi"].dtype == np.float64
    assert got["phi"].shape == ref["phi"].shape == (NB,)
    dphi = np.abs((got["phi"] - ref["phi"] + 0.5) % 1.0 - 0.5)
    assert np.all(dphi <= 1e-9), dphi
    for k in ("DM", "phi_err", "DM_err", "snr", "nu_DM", "scales", "chi2",
              "tau", "tau_err"):
        if np.any(ref[k] != 0):
            assert rel_err(got[k], ref[k]) <= tol, k
    np.testing.assert_array_equal(got["dof"], ref["dof"])
    np.testing.assert_array_equal(got["nfeval"], ref["nfeval"])
    np.testing.assert_array_equal(got["return_code"], ref["return_code"])


def one_mesh():
    return TPar.make_mesh(devices=["cpu"])


def test_mesh_and_shard_batch_world_size_one():
    for m in (TPar.make_mesh(), TPar.global_mesh(), one_mesh()):
        assert m.shape == (1, 1) and m.coords == (0, 0) and m.groups == {}
        assert m.axis_names == ("data", "chan") and m.size == 1
        assert m.axis_index("data") == 0 == m.axis_index("chan")
    assert one_mesh().device == torch.device("cpu")
    assert TPar.make_mesh().device is None  # the entry points' default
    with pytest.raises(ValueError, match="ranks"):
        TPar.make_mesh(n_data=2)
    with pytest.raises(ValueError, match="one process per device"):
        TPar.make_mesh(devices=["cpu", "cpu"])
    m = one_mesh()
    assert TPar.batch_sharding(m, 3, 1).spec == ("data", "chan", None)
    assert TPar.batch_sharding(m, 2).spec == ("data", None)
    assert TPar.batch_sharding(m, 2, 5).spec == ("data", None)
    assert TPar.replicated(m).spec == ()
    ports, model, noise, freqs, masks = make_batch(nb=3)
    for chan_axis in (None, 1):
        for arrays in ((ports, noise), [ports, noise],
                       {"p": ports, "n": noise}):
            got = TPar.shard_batch(m, arrays, chan_axis=chan_axis)
            assert type(got) is type(arrays)
            vals = got.values() if isinstance(got, dict) else got
            src = arrays.values() if isinstance(arrays, dict) else arrays
            for g, a in zip(vals, src):
                assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
                assert np.array_equal(g.numpy(), a)
    assert np.array_equal(TPar.shard_batch(m, freqs, device="cpu").numpy(),
                          freqs)


def test_sharding_slices_and_refusals():
    """The slice rule on a fabricated 2 x 2 mesh (no group needed): rank
    3 at (1, 1) takes the second half of each sliced axis; an axis that
    does not divide refuses, as JAX's device_put does."""
    m = TMesh.Mesh(shape=(2, 2), rank=3, world=4, coords=(1, 1))
    assert m.axis_index("data") == 1 and m.axis_size("chan") == 2
    sh = TMesh.batch_sharding(m, 3, 1)
    assert sh.slices((4, 6, 8)) == (slice(2, 4), slice(3, 6), slice(None))
    with pytest.raises(ValueError, match="does not divide"):
        sh.slices((3, 6, 8))
    out = TMesh.Mesh(shape=(1, 2), rank=2, world=3, coords=None)
    with pytest.raises(ValueError, match="outside"):
        out.axis_index("data")


@pytest.mark.parametrize("case", ["data", "shared_template", "chan",
                                  "scatter"])
def test_sharded_fast_matches_jax(fast_config, case):
    tau = 0.004 if case == "scatter" else None
    ports, model, noise, freqs, masks = make_batch(tau=tau)
    models = np.broadcast_to(model, ports.shape).copy()
    nu_fit = 1500.0
    kw = dict(chan_masks=masks, harmonic_window=K)
    jmesh = JPar.make_mesh(n_data=8, n_chan=1)
    if case == "shared_template":
        models = model
    if case == "chan":
        kw["shard_channels"] = True
        jmesh = JPar.make_mesh(n_data=4, n_chan=2)
    flags = (True, True, False, False, False)
    if case == "scatter":
        flags = (True, True, False, True, False)
        th0 = np.zeros((NB, 5))
        th0[:, 3] = np.log10(0.5 / NBIN)
        th0[:, 4] = -4.0
        kw.update(theta0=th0, log10_tau=True, max_iter=60)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref = JPar.fit_portrait_sharded_fast(
        jmesh, jnp.asarray(ports), jnp.asarray(models), jnp.asarray(noise),
        jnp.asarray(freqs), P0, nu_fit, fit_flags=JFlags(*flags), **jkw)
    got = TPar.fit_portrait_sharded_fast(
        one_mesh(), ports, models, noise, freqs, P0, nu_fit,
        fit_flags=TFlags(*flags), **kw)
    assert_fit_parity(got, ref, tol=1e-7 if case == "scatter" else 1e-8)


def test_sharded_fast_validations(fast_config):
    """A fixed nonzero tau seed routes to the scattering lane (as in the
    JAX package); a bad window, a batch that does not divide the mesh's
    'data' ranks and, with shard_channels, channels that do not divide
    its 'chan' ranks refuse."""
    ports, model, noise, freqs, masks = make_batch(nb=2, tau=0.004)
    th0 = np.zeros((2, 5))
    th0[:, 3] = 1e-3
    r = TPar.fit_portrait_sharded_fast(
        one_mesh(), ports, model, noise, freqs, P0, 1500.0, theta0=th0,
        fit_flags=TFlags(True, True, False, False, False))
    assert torch.all(torch.isfinite(r.phi)) and torch.all(r.tau > 0)
    with pytest.raises(ValueError, match="fit_harmonic_window"):
        TPar.fit_portrait_sharded_fast(one_mesh(), ports, model, noise,
                                       freqs, P0, 1500.0,
                                       harmonic_window="wide")
    two = TMesh.Mesh(shape=(2, 1), rank=0, world=2, coords=(0, 0),
                     device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        TPar.fit_portrait_sharded_fast(two, ports[:1], model, noise[:1],
                                       freqs, P0, 1500.0)
    # shard_channels: the channels must divide over 'chan', as in JAX
    chan = TMesh.Mesh(shape=(1, 2), rank=0, world=2, coords=(0, 0),
                      device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        TPar.fit_portrait_sharded_fast(chan, ports[:, :15], model[:15],
                                       noise[:, :15], freqs[:15], P0,
                                       1500.0, shard_channels=True)


@pytest.mark.parametrize("shard_channels", [False, True])
def test_sharded_complex_matches_jax(fast_config, shard_channels):
    ports, model, noise, freqs, _ = make_batch(seed=8)
    models = np.broadcast_to(model, ports.shape).copy()
    jmesh = JPar.make_mesh(n_data=4 if shard_channels else 8,
                           n_chan=2 if shard_channels else 1)
    ref = JPar.fit_portrait_sharded(
        jmesh, jnp.asarray(ports), jnp.asarray(models), jnp.asarray(noise),
        jnp.asarray(freqs), P0, 1500.0, shard_channels=shard_channels)
    got = TPar.fit_portrait_sharded(
        one_mesh(), ports, models, noise, freqs, P0, 1500.0,
        shard_channels=shard_channels)
    assert_fit_parity(got, ref)


@pytest.mark.parametrize("fit_dm", [True, False])
def test_align_iteration_sharded_matches_jax(fast_config, fit_dm):
    ports, model, noise, freqs, masks = make_batch(seed=9)
    jmesh = JPar.make_mesh(n_data=4, n_chan=2)
    ref_t, ref = JPar.align_iteration_sharded(
        jmesh, jnp.asarray(ports), jnp.asarray(model), jnp.asarray(noise),
        jnp.asarray(masks), jnp.asarray(freqs), P0, fit_dm=fit_dm,
        shard_channels=True)
    got_t, got = TPar.align_iteration_sharded(
        one_mesh(), ports, model, noise, masks, freqs, P0, fit_dm=fit_dm,
        shard_channels=True)
    assert got_t.shape == (NCHAN, NBIN) and got_t.dtype == torch.float64
    assert rel_err(got_t, ref_t) <= 1e-10
    assert_fit_parity(got, ref)
    # the iteration aligns: the template beats the unaligned mean
    clean = np.abs(model).max()
    err = np.abs(got_t.numpy() - model)[masks[0] > 0].max() / clean
    assert err < 0.05 and np.abs(ports.mean(0) - model).max() / clean \
        > 5 * err


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_init_multihost_without_cluster(monkeypatch):
    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert TM.init_multihost() is False
    assert TM.init_multihost(device="cpu") is False
    assert TM.process_count() == 1
    with pytest.raises(ValueError, match="together"):
        TM.init_multihost("127.0.0.1:1", num_processes=2)


def test_init_multihost_unanswered_coordinator_raises(monkeypatch):
    """torchrun's variables name a coordinator nobody serves: the
    bootstrap raises within its timeout instead of running as rank 0 of
    1."""
    import torch.distributed as dist

    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(RuntimeError):
        TM.init_multihost(device="cpu", timeout=1)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        TM.init_multihost(f"127.0.0.1:{_free_port()}", num_processes=2,
                          process_id=1, device="cpu", timeout=1)
    assert not dist.is_initialized()


def test_cluster_detection(monkeypatch):
    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert TM._cluster_env() is None
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_NODELIST", "gpu[07-08],cpu1")
    assert TM._cluster_env() == ("tcp://gpu07:29500", 8, 3)
    monkeypatch.setenv("SLURM_NTASKS_PER_NODE", "4")
    monkeypatch.setenv("SLURM_LOCALID", "3")
    assert TM._local_layout("gpu07", 8, 3) == (4, 3)
    monkeypatch.setenv("MASTER_ADDR", "head")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "6")
    assert TM._cluster_env() == ("env://", 6, 5)
    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert TM._local_layout("127.0.0.1", 4, 2) == (4, 2)
    assert TM._local_layout("elsewhere.example", 4, 2) == (1, 0)


@pytest.mark.parametrize("device,local,gpus,want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo"), ("cuda", 1, 0, "gloo"),
    ("cpu", 1, 8, "gloo"), ("cpu", 4, 0, "gloo")])
def test_backend_rule(device, local, gpus, want):
    assert TM.select_backend(device, local, gpus) == want

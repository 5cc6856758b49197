"""The lossless transport codec in the port (io/blockcodec.py, the
codec's device stage ops/decode.decode_transport and the stream's raw
copy stage) against the JAX package's.

- probe_width / encode_rows / decode_rows are bit-equal to the JAX
  copy's on random integer payloads (the JAX package's
  test_blockcodec_roundtrip_property, run through both), and the
  CostModel makes the same decisions on the same observations;
- the port's _raw_decode with pack_w 1/2/4/8 gives exactly the floats
  of the unpacked payload (every integer is below 2**24, exact in
  float32; tolerance 0);
- end to end on the JAX package's e2e corpus (nbit=8, levels=4: coarse
  bytes that pack to 2 bits): the .tim is identical for
  transport_compress False / True / 'auto', the shipped-byte saving
  h2d_bytes_logical - h2d_bytes equals the JAX package's on the same
  run (full buckets, so the JAX package's pad rows ship nothing extra),
  'auto' never engages on the CPU's memcpy link, and the trace's
  decision ledger matches the JAX package's;
- pptoas --stream --transport-compress runs and its .tim equals the
  JAX CLI's; PPT_TRANSPORT_COMPRESS is hooked (tests/test_torch_quality
  .py::test_env_hook holds its parse against the JAX package's).
"""

import io

import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (one torch thread per worker)
from test_torch_stream import _tim_lines
from test_torch_toas import _assert_tim_parity

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import telemetry as JT
from pulseportraiture_tpu.io import blockcodec as JB
from pulseportraiture_tpu.pipeline import stream as JS
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import telemetry as TT
from pulseportraiture_tpu_torch.io import blockcodec as TB
from pulseportraiture_tpu_torch.pipeline import stream as TS


def _payloads(seed=7, n=20):
    """The JAX package's round-trip property draws: random integer
    payloads across dtypes, spans and row counts."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        nb = int(rng.integers(1, 5))
        nsamp = int(rng.integers(1, 8)) * 8
        dtype = rng.choice([np.uint8, np.int16])
        width_target = int(rng.choice([1, 2, 4, 8]))
        base = rng.integers(-200 if dtype == np.int16 else 0, 100, nb)
        yield (base[:, None]
               + rng.integers(0, 1 << width_target, (nb, nsamp))) \
            .astype(dtype), width_target


def test_blockcodec_bit_equal_to_jax():
    n_coded = 0
    for arr, width_target in _payloads():
        vmin_t, w_t = TB.probe_width(arr)
        vmin_j, w_j = JB.probe_width(arr)
        assert w_t == w_j
        if w_t is None:
            assert vmin_t is None and vmin_j is None
            continue
        assert w_t <= width_target
        np.testing.assert_array_equal(vmin_t, vmin_j)
        assert vmin_t.dtype == vmin_j.dtype
        packed = TB.encode_rows(arr, vmin_t, w_t)
        np.testing.assert_array_equal(packed, JB.encode_rows(arr, vmin_j,
                                                             w_j))
        assert packed.dtype == np.uint8 and packed.nbytes < arr.nbytes
        back = TB.decode_rows(packed, vmin_t, w_t, arr.shape, arr.dtype)
        np.testing.assert_array_equal(back, arr)
        np.testing.assert_array_equal(
            back, JB.decode_rows(packed, vmin_j, w_j, arr.shape, arr.dtype))
        n_coded += 1
    assert n_coded > 10
    rng = np.random.default_rng(8)
    full = rng.integers(-30000, 30000, (2, 64)).astype(np.int16)
    assert TB.probe_width(full) == JB.probe_width(full) == (None, None)
    assert TB.probe_width(full.astype(np.float32)) == (None, None)


def test_resolve_transport_compress(monkeypatch):
    for v in (False, True, "auto"):
        assert TB.resolve_transport_compress(v) == \
            JB.resolve_transport_compress(v) == v
    monkeypatch.setattr(tcfg, "transport_compress", "auto")
    assert TB.resolve_transport_compress() == "auto"
    with pytest.raises(ValueError, match="transport_compress"):
        TB.resolve_transport_compress("on")


def test_cost_model_decisions():
    """The same observations give the same decisions in both packages:
    no link measured -> never; a memcpy-class link -> never; a
    tunnel-class link -> engage a worthwhile reduction; no saving ->
    never; the EWMA learns the same rates."""
    cases = [(1 << 20, 1 << 18), (1 << 20, 1 << 20), (4096, 1024),
             (1 << 24, 1 << 22)]
    obs = [("link", 1 << 20, 1e-4), ("link", 1 << 20, 0.5),
           ("codec", 1 << 20, 1e-3), ("link", 1 << 16, 0.2),
           ("codec", 1 << 22, 0.5), ("link", 0, 1.0), ("link", 10, 0.0)]
    mt, mj = TB.CostModel(), JB.CostModel()
    for kind, nbytes, sec in [(None, 0, 0)] + obs:
        if kind is not None:
            getattr(mt, f"observe_{kind}")(nbytes, sec)
            getattr(mj, f"observe_{kind}")(nbytes, sec)
        assert mt.link_bps == mj.link_bps
        assert mt.codec_bps == mj.codec_bps
        for logical, shipped in cases:
            assert mt.predict(logical, shipped) == \
                mj.predict(logical, shipped)
    m = TB.CostModel()
    assert not m.predict(1 << 20, 1 << 18)
    m.observe_link(1 << 20, 0.5)
    assert m.predict(1 << 20, 1 << 18)
    assert not m.predict(1 << 20, 1 << 20)


# a byte payload has no width below its own 8 bits; int16 packs to 8 too
_PACK_CASES = [(w, c, p) for c, p in (("i16", False), ("u8", False),
                                      ("i8", False), ("i16", True))
               for w in ((1, 2, 4, 8) if c == "i16" else (1, 2, 4))]


@pytest.mark.parametrize("pack_w,code,pol_sum", _PACK_CASES)
def test_raw_decode_pack_w_exact(pack_w, code, pol_sum):
    """_raw_decode(pack_w=w) on the codec's payload equals _raw_decode on
    the plain payload, bit for bit, in float32."""
    rng = np.random.default_rng(10 * pack_w + len(code))
    nb, nchan, nbin = 3, 8, 32
    shape = (nb, 2, nchan, nbin) if pol_sum else (nb, nchan, nbin)
    dtype = np.int16 if code == "i16" else np.uint8
    lo = rng.integers(-300, 300, nb) if code == "i16" else \
        rng.integers(0, 256 - (1 << pack_w), nb)
    span = (1 << pack_w) - 1 if pack_w < 8 else 255
    raw = (lo.reshape((-1,) + (1,) * (len(shape) - 1))
           + rng.integers(0, span + 1, shape)).astype(dtype)
    if pack_w == 8 and code == "i16":
        raw = np.clip(raw, -32768, 32767).astype(dtype)
    vmin, w = TB.probe_width(raw)
    assert w is not None and w <= pack_w
    packed = TB.encode_rows(raw, vmin, pack_w)
    sshape = (nb, 2, nchan) if pol_sum else (nb, nchan)
    scl = torch.as_tensor(rng.uniform(0.5, 2.0, sshape), dtype=torch.float32)
    offs = torch.as_tensor(rng.normal(0.0, 3.0, sshape), dtype=torch.float32)
    ft = torch.float32
    got = TS._raw_decode(torch.as_tensor(packed), scl, offs, nbin, ft,
                         code=code, pol_sum=pol_sum, pack_w=pack_w,
                         vmin=torch.as_tensor(vmin))
    ref = TS._raw_decode(torch.as_tensor(raw), scl, offs, nbin, ft,
                         code=code, pol_sum=pol_sum)
    assert torch.equal(got, ref)
    # the device stage alone: exactly the integer samples
    from pulseportraiture_tpu_torch.ops.decode import decode_transport

    samples = decode_transport(torch.as_tensor(packed), pack_w,
                               torch.as_tensor(vmin), shape, ft)
    np.testing.assert_array_equal(samples.numpy(), raw.astype(np.float32))


@pytest.fixture(scope="module")
def byte_corpus(tmp_path_factory):
    """The JAX package's e2e codec corpus: two archives of 2 subints x
    16 channels x 128 bins, written with nbit=8, levels=4."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_codec")
    model = default_test_model(1500.0)
    gmodel = str(root / "m.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i in range(2):
        p = str(root / f"c{i}.fits")
        make_fake_pulsar(model, {"PSR": "TC", "P0": 0.003, "DM": 10.0,
                                 "PEPOCH": 55000.0},
                         outfile=p, nsub=2, nchan=16, nbin=128,
                         start_MJD=MJD(55100 + i, 0.1), noise_stds=0.05,
                         dedispersed=False, quiet=True, rng=i, nbit=8,
                         levels=4, device="cpu")
        files.append(p)
    return root, files, gmodel


@pytest.fixture
def codec_config():
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window",
            "transport_compress")
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


def test_transport_compress_e2e(byte_corpus, codec_config, tmp_path):
    root, files, gmodel = byte_corpus
    tims, res, resj, sums, sumsj = {}, {}, {}, {}, {}
    for mode in (False, True, "auto"):
        jcfg.transport_compress = tcfg.transport_compress = mode
        tim = str(tmp_path / f"t_{mode}.tim")
        trace = str(tmp_path / f"t_{mode}.jsonl")
        res[mode] = TS.stream_wideband_TOAs(
            files, gmodel, nsub_batch=4, quiet=True, tim_out=tim,
            telemetry=trace, device="cpu")
        tims[mode] = open(tim).read()
        sums[mode] = TT.report(trace, file=io.StringIO())
        jtrace = str(tmp_path / f"j_{mode}.jsonl")
        resj[mode] = JS.stream_wideband_TOAs(
            files, gmodel, nsub_batch=4, quiet=True,
            tim_out=str(tmp_path / f"j_{mode}.tim"), telemetry=jtrace,
            stream_devices=1)
        sumsj[mode] = JT.report(jtrace, file=io.StringIO())
    assert tims[False] == tims[True] == tims["auto"]
    assert res[True].h2d_bytes < res[False].h2d_bytes
    assert res[True].h2d_bytes_logical == res[False].h2d_bytes
    saving = res[True].h2d_bytes_logical - res[True].h2d_bytes
    assert saving == resj[True].h2d_bytes_logical - resj[True].h2d_bytes
    assert saving > 0
    # 'auto' on the CPU's memcpy link: never engaged
    assert res["auto"].h2d_bytes == res["auto"].h2d_bytes_logical
    assert sums[True]["codec_decisions"] == {"engaged": sums[True]["n_h2d"]}
    assert sums["auto"]["codec_decisions"].get("engaged", 0) == 0
    assert sums["auto"]["codec_decisions"].get("cost", 0) > 0
    for mode in (False, True, "auto"):
        assert sums[mode]["codec_decisions"] == \
            sumsj[mode]["codec_decisions"], mode
        assert sums[mode]["n_h2d"] == sumsj[mode]["n_h2d"]
    assert sums[True]["h2d_compression"] > 1.0
    _assert_tim_parity(_tim_lines(tmp_path / "j_True.tim",
                                  tmp_path / "j_lines.tim"),
                       _tim_lines(tmp_path / "t_True.tim",
                                  tmp_path / "t_lines.tim"))


def test_pptoas_transport_compress_cli(byte_corpus, codec_config,
                                       tmp_path):
    """pptoas --stream --transport-compress on: runs, and its .tim
    equals the JAX CLI's; off/auto parse, anything else exits."""
    from pulseportraiture_tpu.cli.pptoas import main as jmain
    from pulseportraiture_tpu_torch.cli.pptoas import main as tmain

    root, files, gmodel = byte_corpus
    meta = tmp_path / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    args = ["--stream", "-d", str(meta), "-m", gmodel, "--quiet",
            "--transport-compress", "on"]
    ref, got = str(tmp_path / "jax.tim"), str(tmp_path / "torch.tim")
    jmain(args + ["-o", ref, "--stream-devices", "1"])
    assert tmain(args + ["-o", got, "--device", "cpu"]) == 0
    assert tcfg.transport_compress is True
    _assert_tim_parity(ref, got)
    with pytest.raises(SystemExit):
        tmain(["--stream", "-d", str(meta), "-m", gmodel, "--device", "cpu",
               "--transport-compress", "maybe"])

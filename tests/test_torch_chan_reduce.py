"""The port's channel reduction (fit.portrait.chan_sum / chan_sums): one
summation order for every batch size and every channel split.

- A row's sum has the same bits in batches of 1, 2 and 8, at a
  power-of-two channel count (512) and another (500), over either axis.
- A 2-way (and 4-way) split of the channels, each block summed alone and
  the partial sums combined as the ranks combine them, gives the whole
  sum's bits: the ranks' all_gather is replaced by the blocks' partials
  in rank order (the real gloo group is tests/test_torch_multiprocess.py).
- The fixed-order 5 x 5 products of the packaging (_bmm, _quad) agree
  with torch.matmul to float64 rounding and are batch-invariant.
- A float32 scattering fit (phi, DM, tau free, log10 tau) of each subint
  has the same bits fitted alone and in a batch of 8.

Tolerances: bit for bit, except the sums against torch.sum and the
products against torch.matmul (float64, 1e-13 relative).
"""

import numpy as np
import pytest
import torch

from test_torch_helpers import make_sharded_batch, rel_err

from pulseportraiture_tpu_torch.fit import portrait as TP
from pulseportraiture_tpu_torch.utils import collectives

BATCHES = (1, 2, 8)


def _rows(seed, *shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nchan", [512, 500])
def test_chan_sum_batch_invariant(nchan, dtype):
    x = _rows(1, 8, 31, nchan, dtype=dtype)
    y = _rows(2, 8, nchan, 24, dtype=dtype)
    one = (TP.chan_sum(x[:1])[0], TP.chan_sum(y[:1], -2)[0])
    for b in BATCHES[1:]:
        assert torch.equal(TP.chan_sum(x[:b])[0], one[0]), b
        assert torch.equal(TP.chan_sum(y[:b], -2)[0], one[1]), b
    ref = x.double().sum(-1)
    assert rel_err(TP.chan_sum(x.double()), ref) <= 1e-13
    assert rel_err(TP.chan_sum(y.double(), -2), y.double().sum(-2)) <= 1e-13


@pytest.mark.parametrize("nchan, nsplit", [(512, 2), (500, 2), (512, 4),
                                           (16, 2)])
def test_split_and_combine_matches_whole(monkeypatch, nchan, nsplit):
    """Each block's partial sums (chan_sums without a group), combined
    by chan_sums with a group whose all_gather hands back the blocks'
    partials in rank order, equal the whole-portrait sums bit for bit,
    on every rank; two tensors in one call, and complex parts too."""
    x = _rows(3, 4, 5, nchan)
    w = _rows(4, 4, nchan)
    z = torch.complex(_rows(5, 4, nchan, 6), _rows(6, 4, nchan, 6))
    m = nchan // nsplit

    def block(t, dim, r):
        return t.narrow(dim, r * m, m)

    def flat(parts):
        return torch.cat([torch.view_as_real(p).reshape(-1)
                          if p.is_complex() else p.reshape(-1)
                          for p in parts])

    for ts, dim in (((x, w), -1), ((z,), -2)):
        partials = [flat(TP.chan_sums([block(t, dim, r) for t in ts], dim))
                    for r in range(nsplit)]
        monkeypatch.setattr(collectives, "all_gather",
                            lambda t, group, p=partials: [q.clone()
                                                          for q in p])
        whole = TP.chan_sums(ts, dim)
        for r in range(nsplit):
            got = TP.chan_sums([block(t, dim, r) for t in ts], dim, "chan")
            for g, ref in zip(got, whole):
                assert g.dtype == ref.dtype and torch.equal(g, ref), (dim, r)


def test_tree_layout_blocks_are_subtrees():
    """_tree_layout(n) places the block [r m, (r+1) m) of every split of
    n into a power-of-two count R of equal blocks as one aligned subtree
    of the padded order, laid out as _tree_layout(m)."""
    for n in (16, 48, 500, 512, 1000):
        size, pos = TP._tree_layout(n)
        assert size == 1 << (n - 1).bit_length()
        assert sorted(pos) == list(pos)
        for R in (2, 4, 8):
            if n % R:
                continue
            m = n // R
            msize, mpos = TP._tree_layout(m)
            assert msize * R == size
            for r in range(R):
                assert [p - r * msize for p in pos[r * m:(r + 1) * m]] == \
                    list(mpos)


def test_fixed_order_products():
    A = _rows(6, 8, 5, 5, dtype=torch.float64)
    u = _rows(7, 8, 5, dtype=torch.float64)
    assert rel_err(TP._bmm(A, A.transpose(-1, -2)),
                   A @ A.transpose(-1, -2)) <= 1e-13
    assert rel_err(TP._quad(u, A),
                   torch.einsum("bi,bij,bj->b", u, A, u)) <= 1e-13
    a32 = A.float()
    full = TP._bmm(a32, a32.transpose(-1, -2))
    for b in BATCHES:
        assert torch.equal(TP._bmm(a32[:b], a32[:b].transpose(-1, -2)),
                           full[:b])


def test_scatter_fit_batch_invariant():
    """Each subint's float32 scattering fit (the fast lane, harmonic
    window 128 at 256 bins, B1's plain version) has the same bits alone
    and in the batch of 8."""
    from pulseportraiture_tpu_torch import config

    ports, model, noise, freqs, masks = make_sharded_batch(tau=0.004)
    nb, _, nbin = ports.shape
    th0 = np.zeros((nb, 5))
    th0[:, 3] = np.log10(0.5 / nbin)
    th0[:, 4] = -4.0
    f32 = {k: np.asarray(v, np.float32) for k, v in dict(
        ports=ports, noise=noise, masks=masks, th0=th0).items()}

    def fit(sl):
        return TP.fit_portrait_batch_fast(
            f32["ports"][sl], model.astype(np.float32), f32["noise"][sl],
            freqs.astype(np.float32), 0.004074, 1500.0,
            theta0=f32["th0"][sl], chan_masks=f32["masks"][sl],
            fit_flags=TP.FitFlags(True, True, False, True, False),
            log10_tau=True, max_iter=60, harmonic_window=128,
            compensated=False, device="cpu")

    old = config.fit_fused
    config.fit_fused = True
    try:
        whole = fit(slice(None))
        for i in range(nb):
            one = fit(slice(i, i + 1))
            for k in whole._fields:
                assert torch.equal(getattr(one, k)[0],
                                   getattr(whole, k)[i]), (i, k)
    finally:
        config.fit_fused = old
    assert torch.all(whole.return_code <= 2)

"""Every seed of a cell does the same work: shapes, counts, weights,
injected values and the template are the cell's data; only the noise
comes from the seed."""

import numpy as np
import pytest

from portbench import cells, pool as poolmod
from portbench_small import CELLS, CFG


def _pool(cell, seed):
    w = cells.find_cell(cells.load_benchmark(), cell)
    cfg = dict(cells.load_config(w["config"]), **CFG)
    return poolmod.make_pool(cfg, cells.load_traffic(w["traffic"]), seed,
                             "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_two_seeds_differ_only_in_the_noise(cell):
    a, b = _pool(cell, 11), _pool(cell, 2 ** 31 + 12345)
    assert a.q.shape == b.q.shape == (8, CFG["nsub_per_archive"],
                                      CFG["nchan"], CFG["nbin"])
    for k in ("freqs", "phase", "dm", "tau_rot", "alpha"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(a.template["comps"], b.template["comps"])
    assert a.template["nu_ref"] == b.template["nu_ref"]
    assert (a.period_s, a.tsub_s, a.start) == (b.period_s, b.tsub_s, b.start)
    assert not np.array_equal(a.q, b.q)
    # the decoded samples differ by noise of unit std, nothing more
    da = a.q * a.scl[..., None] + a.offs[..., None]
    db = b.q * b.scl[..., None] + b.offs[..., None]
    diff = (da - db).ravel()
    assert abs(diff.mean()) < 0.05 and 1.3 < diff.std() < 1.5  # sqrt(2)


@pytest.mark.parametrize("cell", CELLS)
def test_a_seed_repeats(cell):
    a, b = _pool(cell, 7), _pool(cell, 7)
    np.testing.assert_array_equal(a.q, b.q)
    np.testing.assert_array_equal(a.scl, b.scl)


def test_archives_read_back_through_the_port_loader():
    from portbench.harness import load_pool, program_lane

    p = _pool(CELLS[0], 5)
    w = cells.find_cell(cells.load_benchmark(), CELLS[0])
    _, loader = program_lane(p, cells.load_traffic(w["traffic"]), "cpu", 8)
    loaded = load_pool(p, loader)
    assert len(loaded) == p.narchive
    for a, (_, d) in enumerate(loaded):
        np.testing.assert_array_equal(d.raw, p.q[a])
        np.testing.assert_array_equal(d.scl, p.scl[a])
        np.testing.assert_allclose(d.freqs[0], p.freqs)
        assert np.all(d.Ps == p.period_s)
        assert float(d.DM) == p.header_dm

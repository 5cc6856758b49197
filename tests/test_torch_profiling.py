"""The PyTorch port's stage-attribution profiler
(pulseportraiture_tpu_torch/profiling.py) against the JAX package's,
case for case with tests/test_profiling.py.

The same stubbed ``devtime_fn`` drives both packages' profile_stages:
their Attributions and breakdown_ms() must be identical (exact: the
arithmetic is the same float64 sums and differences).  A real dispatch
smoke runs the port's devtime on the CPU.
"""

import pytest
import torch

from pulseportraiture_tpu import profiling as JP
from pulseportraiture_tpu_torch import profiling as TP


def _fake_devtime(table):
    """Stub timer: each stage fn returns its key into ``table``."""

    def dt(fn, pick=None, K=4, warm=1, nrun=3):
        s = table[fn()]
        return s, s

    return dt


def _both(table, stages, full="full"):
    """profile_stages of both packages on the same stub; the stage
    lists are built from (name, key, kind) triples."""
    out = []
    for P in (JP, TP):
        st = [P.Stage(n, (lambda k=k: k), kind) for n, k, kind in stages]
        out.append(P.profile_stages(lambda: full, st,
                                    devtime_fn=_fake_devtime(table)))
    ja, ta = out
    assert tuple(ta) == tuple(ja)
    assert ta.breakdown_ms() == ja.breakdown_ms()
    return ta


def test_prefix_differencing_and_attribution_math():
    att = _both({"full": 10.0, "a": 2.0, "b": 5.0, "p": 4.0},
                [("a", "a", "prefix"), ("b", "b", "prefix"),
                 ("p", "p", "piece")])
    assert att.total_s == 10.0
    # prefix costs are differenced; the piece adds directly
    assert (att.cost("a"), att.cost("b"), att.cost("p")) == (2.0, 3.0, 4.0)
    # attributed = last prefix slope + pieces, never built from the total
    assert att.attributed_s == 9.0
    assert att.attributed_frac == pytest.approx(0.9, rel=1e-15)
    assert att.check(0.9) and not att.check(0.95)


def test_breakdown_ms_fields():
    att = _both({"full": 0.010, "a": 0.004, "p": 0.005},
                [("a", "a", "prefix"), ("p", "p", "piece")])
    assert att.breakdown_ms() == {"stage_a_ms": 4.0, "stage_p_ms": 5.0,
                                  "full_ms": 10.0, "attributed_frac": 0.9}


def test_negative_prefix_difference_clamps_to_zero():
    # load noise can make a later prefix measure faster: its cost clamps
    # at 0, and the attribution still uses the last prefix's own slope
    att = _both({"full": 10.0, "a": 5.0, "b": 4.0},
                [("a", "a", "prefix"), ("b", "b", "prefix")])
    assert att.cost("b") == 0.0 and att.attributed_s == 4.0


@pytest.mark.parametrize("P", [JP, TP], ids=["jax", "torch"])
def test_prefix_after_piece_raises(P):
    with pytest.raises(ValueError, match="prefix.*piece"):
        P.profile_stages(
            lambda: "full",
            [P.Stage("p", lambda: "p", "piece"), P.Stage("a", lambda: "a")],
            devtime_fn=_fake_devtime({"full": 1.0, "a": 0.5, "p": 0.2}))


@pytest.mark.parametrize("P", [JP, TP], ids=["jax", "torch"])
def test_unknown_stage_kind_raises(P):
    with pytest.raises(ValueError, match="unknown stage kind"):
        P.profile_stages(lambda: "full",
                         [P.Stage("x", lambda: "full", "weird")],
                         devtime_fn=_fake_devtime({"full": 1.0}))


def test_unknown_stage_name_raises():
    att = TP.Attribution(1.0, 1.0, (), 1.0, 1.0)
    with pytest.raises(KeyError):
        att.cost("nope")
    assert tuple(att) == tuple(JP.Attribution(1.0, 1.0, (), 1.0, 1.0))


def test_devtime_real_dispatch_smoke():
    """The port's devtime on the CPU: positive slope and single time;
    pick selects the tensor reduced on the device."""
    x = torch.arange(64.0)
    slope, single = TP.devtime(lambda: x * 2.0, K=2, warm=1, nrun=1)
    assert slope > 0.0 and single > 0.0
    slope, single = TP.devtime(lambda: (x, x * 2.0), pick=lambda r: r[1],
                               K=2, warm=1, nrun=1)
    assert slope > 0.0 and single > 0.0


def test_profile_stages_real_dispatch_smoke():
    """profile_stages on a real CPU program: a prefix (the rfft) and a
    piece (a product on its precomputed output); every cost finite and
    non-negative, attributed_frac finite."""
    x = torch.randn(8, 256, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    X = torch.fft.rfft(x)

    def full():
        return (torch.fft.rfft(x) * X.conj()).real

    att = TP.profile_stages(
        full, [TP.Stage("rfft", lambda: torch.fft.rfft(x).real),
               TP.Stage("product", lambda: (X * X.conj()).real, "piece")],
        K=2, nrun=1)
    assert all(s.cost_s >= 0.0 for s in att.stages)
    assert att.total_s > 0.0 and att.attributed_frac == att.attributed_frac
    assert set(att.breakdown_ms()) == {"stage_rfft_ms", "stage_product_ms",
                                       "full_ms", "attributed_frac"}

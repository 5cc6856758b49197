"""The trace's reduction on synthetic spans and device ops: busy time,
the window, the longest ops and the idle gaps named by the host phase."""

import pytest

from portbench import trace as T


def _window():
    # host spans on the device timeline: (name, start, end)
    spans = [("admit", 0.0, 0.2), ("launch", 0.2, 1.0), ("copy", 0.3, 0.9),
             ("fit", 0.5, 2.0), ("drain", 1.0, 3.0)]
    dev = [("b1_kernel", 0.1, 0.4), ("kthvalue", 0.35, 0.6),
           ("b1_kernel", 1.5, 1.7), ("outside", 3.5, 4.0)]
    return dev, spans


def test_reduce_counts_busy_time_once_and_only_inside_the_window():
    dev, spans = _window()
    r = T.reduce(dev, spans)
    assert r["window_s"] == pytest.approx(3.0)
    # [0.1, 0.6] and [1.5, 1.7]: overlaps merged, "outside" left out
    assert r["busy_s"] == pytest.approx(0.7)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops == pytest.approx({"b1_kernel": 0.5, "kthvalue": 0.25})


def test_idle_gaps_longest_first_named_by_the_open_host_spans():
    dev, spans = _window()
    gaps = T.reduce(dev, spans)["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([1.3, 0.9, 0.1])
    # 1.7-3.0: drain alone; 0.6-1.5: at 1.05 drain, the fit stage open;
    # 0.0-0.1: admit
    assert [g[0] for g in gaps] == ["host:drain", "host:drain+fit",
                                    "host:admit"]


@pytest.mark.parametrize("t,name", [
    (0.4, "host:launch+copy"),
    (0.7, "host:launch+copy+fit"),
    (5.0, "host:no_span"),
])
def test_host_phase_innermost_main_span_then_stages(t, name):
    _, spans = _window()
    assert T._host_phase(spans, t) == name


def test_marker_places_host_spans_on_the_device_clock():
    dev = [("Memcpy HtoD (Pageable -> Device)", 100.5, 100.50001)]
    placed = T.align_marker(dev, 2.0, [("admit", 2.1, 2.3)])
    assert placed == [("admit", pytest.approx(100.6), pytest.approx(100.8))]
    assert T.align_marker([], 2.0, [("admit", 2.1, 2.3)]) == []

"""``correct`` reads true on a sound run and false on the control and on
every fault a cell can have: the comparison has been shown to fail."""

import numpy as np
import pytest

from portbench_small import CELLS, run


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, rows = run(cell)
    assert res["correct"], rows
    assert res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_control_is_not_correct(cell):
    res, rows = run(cell, control="lower")
    assert not res["correct"], rows


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    """One TOA altered where it is produced, by a tenth of a period."""
    from pulseportraiture_tpu_torch.pipeline import stream

    orig = stream._assemble_archive
    hit = []

    def altered(m, results, *a, **kw):
        toas, mean, err = orig(m, results, *a, **kw)
        # one answer of one pool archive, wherever it is produced
        if m.datafile.endswith("-3.fits") and len(toas) > 1:
            toas[1].MJD = toas[1].MJD.add_seconds(0.1 * m.Ps[1])
            hit.append(1)
        return toas, mean, err

    monkeypatch.setattr(stream, "_assemble_archive", altered)
    res, rows = run(cell)
    assert hit and not res["correct"], rows


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    """Every dispatch returns its first half of subints only."""
    from pulseportraiture_tpu_torch.pipeline import stream

    orig = stream._launch

    def half(bucket, *a, **kw):
        rec = orig(bucket, *a, **kw)
        if rec is None:
            return rec
        handle, owners, extra = rec
        return handle, owners[:len(owners) // 2], extra

    monkeypatch.setattr(stream, "_launch", half)
    res, rows = run(cell)
    assert not res["correct"], rows
    assert res["failed"] > 0

"""The small sizes the CPU tests run the cells at: every width of the
configuration cut so that a run takes seconds on the CPU."""

CFG = {"nchan": 16, "nbin": 128, "nsub_per_archive": 4}
NSUB_BATCH = 8
CELLS = ("nanograv-lband.wb_campaign", "meertime-lband.wb_campaign")


def run(cell, seed=3141592653, trace=False, control=None, seconds=0.5):
    from portbench.harness import run_cell

    return run_cell(cell, seed, seconds, trace=trace, device="cpu",
                    control=control, cfg_over=CFG, nsub_batch=NSUB_BATCH,
                    warm_passes=1)

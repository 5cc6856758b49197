#!/usr/bin/env python3
"""The null rate of the median zap cut: how many channels the iterative
median + 3-sigma cut (the host oracle, quality.excision.zap_keep_np)
flags per subint when every channel is white noise, at the chip check's
widths (512 channels x 2048 bins, noise levels from the power-spectrum
estimator io.psrfits.noise_std_ps).  Host numpy only, seeded.

    python tools/zap_null_rate.py [--rows 192] [--seed 1]

Prints the number of subints, the count of subints with 0, 1, 2, ...
flagged channels, and the mean per subint.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pulseportraiture_tpu_torch.io.psrfits import noise_std_ps  # noqa: E402
from pulseportraiture_tpu_torch.quality.excision import \
    zap_keep_np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=192)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--nchan", type=int, default=512)
    p.add_argument("--nbin", type=int, default=2048)
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    counts = []
    for start in range(0, args.rows, 16):  # 16 rows at a time: ~67 MB
        x = rng.standard_normal((min(16, args.rows - start), args.nchan,
                                 args.nbin)).astype(np.float32)
        noise = noise_std_ps(x)
        keep, _ = zap_keep_np(noise, np.ones_like(noise, bool), 3.0)
        counts += list((~keep).sum(axis=1))
    c = np.asarray(counts)
    print(f"{len(c)} subints; subints with 0, 1, ... flagged channels "
          f"{np.bincount(c).tolist()}; mean {c.mean():.4f} per subint")


if __name__ == "__main__":
    main()

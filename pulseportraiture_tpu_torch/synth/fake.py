"""Synthetic template models (counterpart of pulseportraiture_tpu/synth/fake.py).

Only default_test_model is ported: the known-truth template that the
synthetic archives (synth/archive.py) are generated from.
"""

import numpy as np

from ..models.gaussian import GaussianModel

__all__ = ["default_test_model"]


def default_test_model(nu_ref=1500.0):
    """A 3-component evolving-Gaussian model (the same values as the
    JAX package's default_test_model)."""
    return GaussianModel(
        name="FAKE_0000+0000",
        code="000",
        nu_ref=nu_ref,
        dc=0.0,
        tau=0.0,
        alpha=-4.0,
        locs=np.array([0.48, 0.505, 0.52]),
        wids=np.array([0.045, 0.015, 0.022]),
        amps=np.array([4.0, 9.5, 2.5]),
        mlocs=np.array([-0.005, -0.003, 0.003]),
        mwids=np.array([-0.2, 0.16, -0.3]),
        mamps=np.array([-1.6, -2.0, -0.9]),
    )

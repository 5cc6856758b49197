"""pulseportraiture_tpu_torch — the PyTorch/CUDA port of pulseportraiture_tpu.

Wideband pulsar timing (PulsePortraiture's pptoas) on an NVIDIA GPU:
PSRFITS archive + template -> per-subint (phi, DM[, GM]) fits -> .tim.
The package keeps the JAX package's layout (io/, ops/, models/, fit/,
pipeline/, cli/, synth/) so every module has a named counterpart there,
and imports neither JAX nor the JAX package.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; see device.py.
"""

from . import config  # noqa: F401
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"

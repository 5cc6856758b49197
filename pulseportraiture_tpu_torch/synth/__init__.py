"""Synthetic data with known injected parameters."""

from .archive import add_scintillation, make_fake_pulsar  # noqa: F401
from .fake import (default_test_model, fake_observation,  # noqa: F401
                   fake_portrait, fake_timing_campaign)
from .rfi import inject_rfi  # noqa: F401

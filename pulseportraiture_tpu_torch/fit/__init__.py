"""Fit engines: the wideband fast lane."""

from .portrait import (FitFlags, FitResult,  # noqa: F401
                       fit_portrait_batch_fast)

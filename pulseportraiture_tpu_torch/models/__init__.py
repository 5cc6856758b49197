"""Template models."""

from .gaussian import (GaussianModel, gen_gaussian_portrait,  # noqa: F401
                       gen_gaussian_profile)

"""Host-side matplotlib diagnostics (counterpart of
pulseportraiture_tpu/viz/).  Importing the package needs no matplotlib;
drawing a plot does (viz/plots.py)."""

from .plots import (  # noqa: F401
    plot_flux_profile,
    set_colormap,
    show_eigenprofiles,
    show_portrait,
    show_profiles,
    show_residual_plot,
    show_spline_curve_projections,
    show_stacked_profiles,
)

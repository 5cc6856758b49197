"""Data quality (counterpart of pulseportraiture_tpu/quality): the
iterative median noise cut behind ppzap and the stream's inline zap, and
the model-based post-fit channel cut behind GetTOAs.get_channels_to_zap
and the stream's postfit_cut.

- :mod:`.excision`: the median + nstd noise cut over a batch of rows in
  torch, its host numpy oracle, and the in-memory weight zap
  (:func:`zap_bunch`) of the stream's ``zap_channels=``.
- :mod:`.postfit`: the reference red-chi^2 / S-N channel cut, host
  oracle and batched torch twin.
"""

from .excision import (masked_median_lastaxis, zap_bunch,  # noqa: F401
                       zap_keep_device, zap_keep_mask, zap_keep_np,
                       zap_lists_from_masks)
from .postfit import (postfit_cut_device, postfit_cut_mask,  # noqa: F401
                      postfit_cut_np)

__all__ = ["masked_median_lastaxis", "zap_bunch", "zap_keep_device",
           "zap_keep_mask", "zap_keep_np", "zap_lists_from_masks",
           "postfit_cut_device", "postfit_cut_mask", "postfit_cut_np"]

"""Pipeline layer: template dispatch, wideband TOA measurement, and the
streaming campaign lane."""

from .models import TemplateModel, sniff_model_type  # noqa: F401
from .stream import stream_wideband_TOAs  # noqa: F401
from .toas import GetTOAs  # noqa: F401
from .zap import apply_zaps, get_zap_channels, print_paz_cmds  # noqa: F401

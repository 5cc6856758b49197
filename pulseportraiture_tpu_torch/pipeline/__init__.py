"""Pipeline layer: template dispatch, wideband TOA measurement, the
streaming campaign lane, the multi-pulsar campaign driver, zapping,
align-and-average, and the template factory."""

from .align import (align_archives, gaussian_seed_portrait,  # noqa: F401
                    make_constant_portrait, psradd_archives,
                    psrsmooth_archive)
from .factory import TemplateJob, build_templates  # noqa: F401
from .ipta import IPTAJob, stream_ipta_campaign  # noqa: F401
from .models import TemplateModel, sniff_model_type  # noqa: F401
from .portrait import DataPortrait, normalize_portrait  # noqa: F401
from .stream import (stream_narrowband_TOAs,  # noqa: F401
                     stream_wideband_TOAs)
from .toas import GetTOAs  # noqa: F401
from .zap import (apply_zaps, get_zap_channels,  # noqa: F401
                  print_paz_cmds, resolve_zap_device)

"""Pipeline layer: template dispatch and wideband TOA measurement."""

from .models import TemplateModel, sniff_model_type  # noqa: F401
from .toas import GetTOAs  # noqa: F401

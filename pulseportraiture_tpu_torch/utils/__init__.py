from .bunch import DataBunch  # noqa: F401
from .mjd import MJD  # noqa: F401
from .device import host_compute  # noqa: F401

from .bunch import DataBunch  # noqa: F401
from .mjd import MJD  # noqa: F401

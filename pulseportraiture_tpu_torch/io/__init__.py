"""Data access & formats: PSRFITS archives without PSRCHIVE, the
.gmodel format, TOA/.tim writers, telescope codes."""

from .gmodel import (  # noqa: F401
    gen_gmodel_portrait,
    model_from_flat,
    model_to_flat,
    read_gmodel,
    write_gmodel,
)
from .psrfits import (  # noqa: F401
    Archive,
    load_data,
    new_archive,
    parse_parfile,
    read_archive,
)
from .tim import TOA, toa_string, write_TOAs  # noqa: F401

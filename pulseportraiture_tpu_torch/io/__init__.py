"""Data access & formats: PSRFITS archives without PSRCHIVE, the
.gmodel and .spl formats, TOA/.tim writers, telescope codes."""

from .fitsio import TruncatedFits, scan_fits  # noqa: F401
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
    unload_new_archive,
    write_archive_file,
)
from .splmodel import (  # noqa: F401
    SplineModel,
    read_spline_model,
    spline_model_coords,
    write_spline_model,
)
from .telescopes import telescope_code, telescope_code_dict  # noqa: F401
from .tim import (  # noqa: F401
    TOA,
    filter_TOAs,
    toa_string,
    write_princeton_TOAs,
    write_TOAs,
)

"""The port's field, NTT and polynomial modules; the re-exports of
``twenty_first_tpu/math/__init__.py``, from the port's own modules."""

import importlib

from . import gf  # noqa: F401
from . import gf_numpy  # noqa: F401
from .b_field_element import BFieldElement, bfe, bfe_vec, bfe_array  # noqa: F401
from .x_field_element import (  # noqa: F401
    XFieldElement,
    EXTENSION_DEGREE,
    xfe,
    xfe_vec,
    xfe_array,
)


def __getattr__(name):
    # ``ntt`` on first access: it imports the kernel wrappers, which import
    # this package's ``gf``, so importing it here would be circular
    if name == "ntt":
        return importlib.import_module(f"{__name__}.ntt")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

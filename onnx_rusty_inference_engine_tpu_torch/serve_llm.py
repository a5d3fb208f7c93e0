"""Compatibility shim: the serving stack lives in the serving/ package;
this module keeps `from ...serve_llm import X` working, as the JAX
package's does, for what the port has."""

from .serving import DecodeServer  # noqa: F401
from .serving.base import _ServerBase  # noqa: F401
from .serving.request import (  # noqa: F401
    _Request,
    _bias_penalize,
    _device_select,
    _fetch,
    _hits_stop,
    _select_token,
)

__all__ = ["DecodeServer"]

"""Compatibility shim: the serving stack lives in the serving/ package;
this module keeps `from ...serve_llm import X` working, as the JAX
package's does."""

from .serving import (  # noqa: F401
    DecodeServer,
    Seq2SeqServer,
    SpeculativeServer,
)
from .engine import _fetch  # noqa: F401
from .serving.base import _ServerBase  # noqa: F401
from .serving.request import (  # noqa: F401
    _Request,
    _bias_penalize,
    _device_select,
    _hits_stop,
    _select_token,
)

__all__ = ["DecodeServer", "Seq2SeqServer", "SpeculativeServer"]

"""Token-level continuous batching for the GPT-2 decoder, on one device.

The port's counterpart of onnx_rusty_inference_engine_tpu/serving/: one
decode graph over a fixed pool of B slots runs every step; finished
sequences free their slot and newly admitted prompts are prefilled into it
while the other slots keep generating. On the card each graph the server
runs is a captured CUDA graph, and `multi_step=K` runs K steps as one.

Package map:
  request.py      _Request + host/device token selection helpers
  base.py         _ServerBase (slot pool, dispatcher, lifecycle, stats)
  decode.py       DecodeServer (decoder-only continuous batching)
  decode_multi.py K-step blocks (mixin)
  seq2seq.py      Seq2SeqServer (encoder-decoder families)
  spec.py         SpeculativeServer (lossless speculative serving)
"""

from .decode import DecodeServer  # noqa: F401
from .seq2seq import Seq2SeqServer  # noqa: F401
from .spec import SpeculativeServer  # noqa: F401

__all__ = ["DecodeServer", "Seq2SeqServer", "SpeculativeServer"]

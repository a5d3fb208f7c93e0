"""The kernel wrappers' launch counters, read and moved as one.

Each wrapper counts its launches on the host, in `.launches` and, for some,
per variant in `.schedules` (int4; the grouped conv's forms), `.a_dtypes`
(int4: the activations' type), `.epilogues` (int8 GEMM and conv),
`.producers` (int8 conv) and `.forms` (the int8 kernels' zero-point and
uint8 forms, several of which one launch may be). A CUDA graph replays the kernels
without calling the wrappers, and capturing one calls them without
launching anything. So whoever captures a graph takes the counters' change
over the capture back out, and adds it again on every replay
(`engine.capture`): the counters keep meaning launches on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["wrappers", "snapshot", "delta", "add"]

SPLITS = ("schedules", "a_dtypes", "epilogues", "producers", "forms")

Key = Tuple[str, str, str]


def wrappers() -> dict:
    """Every kernel wrapper that counts its launches, by kernel name."""
    from . import (decode_attn, qconv_grouped_int8, qconv_int8, qmatmul_int4,
                   qmatmul_int8)

    return {"qconv_int8_requant": qconv_int8.qconv_int8_requant,
            "qconv_grouped_int8_requant":
                qconv_grouped_int8.qconv_grouped_int8_requant,
            "qmatmul_int8": qmatmul_int8.qmatmul_int8,
            "qmatmul_int4_bf16": qmatmul_int4.qmatmul_int4_bf16,
            "qmatmul_int4_planar": qmatmul_int4.qmatmul_int4_planar,
            "decode_attention_int8": decode_attn.decode_attention_int8,
            "decode_attention_int8_mxu":
                decode_attn.decode_attention_int8_mxu,
            "nibble_probe": qmatmul_int4.nibble_probe}


def snapshot() -> Dict[Key, int]:
    """(kernel, counter, variant) -> count, for every counter."""
    out: Dict[Key, int] = {}
    for name, w in wrappers().items():
        out[(name, "launches", "")] = w.launches
        for split in SPLITS:
            for variant, n in getattr(w, split, {}).items():
                out[(name, split, variant)] = n
    return out


def delta(before: Dict[Key, int]) -> Dict[Key, int]:
    """What each counter gained since `before`, the non-zero gains only."""
    return {k: n - before.get(k, 0) for k, n in snapshot().items()
            if n != before.get(k, 0)}


def add(gains: Dict[Key, int], times: int = 1) -> None:
    """Add `times` x `gains` to the counters (times -1 takes them out)."""
    ws = wrappers()
    for (name, counter, variant), n in gains.items():
        w = ws[name]
        if counter == "launches":
            w.launches += times * n
        else:
            getattr(w, counter)[variant] += times * n

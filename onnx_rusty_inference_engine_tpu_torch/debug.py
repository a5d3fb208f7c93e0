"""Per-node intermediate tensor inspection.

The port's copy of onnx_rusty_inference_engine_tpu/debug.py:
`probe_graph`, a copy of a graph whose outputs are every intermediate
tensor (`quant.calibrate` runs it to see every value once);
`dump_intermediates`, one eager run of it (no capture) that returns every
value as numpy (`intermediates`: the same values as device tensors);
`tensor_stats`, the rows `run --dump-stats` prints.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .graph import Graph


def probe_graph(graph: Graph, names: Optional[Sequence[str]] = None,
                max_tensors: Optional[int] = None) -> Graph:
    """A copy of `graph` whose outputs are every intermediate tensor (or
    the given `names`), in topological production order. Inputs are
    included so the probe also surfaces what the model actually saw."""
    if names is None:
        out: List[str] = []
        seen = set(graph.constants)
        for spec in graph.inputs:
            out.append(spec.name)
            seen.add(spec.name)
        for node in graph.nodes:
            for o in node.outputs:
                if o and o not in seen:
                    out.append(o)
                    seen.add(o)
        names = out
    if max_tensors is not None and len(names) > max_tensors:
        import logging
        logging.getLogger(__name__).warning(
            "probe graph truncated to first %d of %d tensors",
            max_tensors, len(names))
        names = list(names)[:max_tensors]
    return Graph(
        name=graph.name,
        nodes=graph.nodes,
        constants=graph.constants,
        inputs=graph.inputs,
        outputs=list(names),
        opset=graph.opset,
        weight_names=graph.weight_names,
    )


def intermediates(graph: Graph, feed: Dict[str, np.ndarray],
                  names: Optional[Sequence[str]] = None, *, device="cuda",
                  max_tensors: Optional[int] = None, params=None,
                  packed=None) -> Dict[str, "torch.Tensor"]:
    """`dump_intermediates`' values as tensors on `device`, laid out as the
    run left them (channels-last between the card's int8 convs). `params`
    and `packed` reuse an Engine's weights on that device (`Engine.params`,
    `Engine.packed`) in place of placing and packing the graph's again."""
    import torch

    from .engine import lower, resolve_device
    from .weights import (as_device_tensor, params_from_numpy,
                          prepack_int8_weights)

    dev = resolve_device(device)
    probe = probe_graph(graph, names, max_tensors)
    if params is None:
        params = params_from_numpy(
            {k: graph.constants[k] for k in graph.weight_names}, dev)
        packed = prepack_int8_weights(graph, params)
    with torch.no_grad():
        return lower(probe, dev, packed)(
            params, {k: as_device_tensor(v, dev) for k, v in feed.items()})


def dump_intermediates(graph: Graph, feed: Dict[str, np.ndarray],
                       names: Optional[Sequence[str]] = None, *,
                       device="cuda", max_tensors: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """Run the probe graph once, eagerly (no capture), on `device` (the
    card unless told "cpu"); return {tensor_name: value} for every
    intermediate (or just `names`, or the first `max_tensors`), as numpy
    (bf16 as f32)."""
    import torch

    out = intermediates(graph, feed, names, device=device,
                        max_tensors=max_tensors)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in out.items()}


def tensor_stats(values: Dict[str, np.ndarray]) -> List[Dict]:
    """Compact per-tensor stats rows (what --dump-stats prints), key for
    key the JAX package's."""
    rows = []
    for name, v in values.items():
        row = {"name": name, "shape": list(v.shape), "dtype": str(v.dtype)}
        if np.issubdtype(v.dtype, np.number) and v.size:
            vf = v.astype(np.float64)
            row.update(min=float(vf.min()), max=float(vf.max()),
                       mean=float(vf.mean()))
            if np.issubdtype(v.dtype, np.floating):
                row["nonfinite"] = int((~np.isfinite(vf)).sum())
        rows.append(row)
    return rows

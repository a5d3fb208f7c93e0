"""Per-node intermediate tensor inspection.

The port's copy of `probe_graph` from onnx_rusty_inference_engine_tpu/
debug.py: a copy of a graph whose outputs are every intermediate tensor.
`quant.calibrate` runs it to see every value once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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

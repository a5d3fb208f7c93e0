"""Python API: the port's copy of onnx_rusty_inference_engine_tpu/api.py.

`onnx_make_inference(onnx_file, input_path, output_path, ...)` loads an
ONNX model, runs the bundled TensorProto input(s) and checks a golden
output, with the JAX package's meaning. The port adds one keyword, `device`
(default "cuda", which raises without a card; "cpu" runs on the CPU),
passed to the Engine.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

from . import onnx_io
from .engine import Engine, InferenceResult
from .graph import import_onnx


def onnx_make_inference(
    onnx_file: str,
    input_path: Union[str, Sequence[str]],
    output_path: Optional[Union[str, Sequence[str]]] = None,
    input_tensor_names: Optional[Sequence[str]] = None,
    *,
    dtype: str = "float32",
    rtol: float = 1e-4,
    atol: float = 1e-4,
    device="cuda",
) -> Dict[str, object]:
    """Load an ONNX model, run the bundled TensorProto input(s), and — if a
    golden output is given — verify against it (replaces the reference's
    eyeball diff, src/main.rs:39-41).

    Returns {"outputs": {name: np.ndarray}, "latency_s": float,
             "top1": np.ndarray, "golden_match": Optional[bool],
             "max_abs_err": Optional[float]}.
    """
    graph = import_onnx(onnx_file)
    engine = Engine(graph, dtype=dtype, device=device)

    in_paths = [input_path] if isinstance(input_path, str) else list(input_path)
    tensors = [onnx_io.read_tensor_file(p) for p in in_paths]
    feeds: Dict[str, np.ndarray] = {}
    for i, t in enumerate(tensors):
        name = t.name
        if input_tensor_names is not None and i < len(input_tensor_names):
            name = input_tensor_names[i]
        if not name:
            name = graph.input_names[i]
        feeds[name] = t.array

    result: InferenceResult = engine.run(feeds)
    report: Dict[str, object] = {
        "outputs": result.outputs,
        "latency_s": result.latency_s,
        "top1": result.top1(),
    }

    golden_match = None
    max_abs_err = None
    if output_path:
        out_paths = [output_path] if isinstance(output_path, str) else list(output_path)
        golden_match = True
        max_abs_err = 0.0
        for p in out_paths:
            g = onnx_io.read_tensor_file(p)
            name = g.name if g.name in result.outputs else next(iter(result.outputs))
            got = result.outputs[name].reshape(g.array.shape)
            max_abs_err = max(max_abs_err, float(np.max(np.abs(got - g.array))))
            golden_match &= bool(np.allclose(got, g.array, rtol=rtol, atol=atol))
    report["golden_match"] = golden_match
    report["max_abs_err"] = max_abs_err
    return report

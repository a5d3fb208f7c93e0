"""The port's INT8 accuracy benchmark
(onnx_rusty_inference_engine_tpu_torch/benchmarks/accuracy.py) on the CPU,
against the JAX package's benchmarks/accuracy.py.

At --model squeezenet --batches 1 --batch 4 --cpu: the script prints the
JAX script's three JSON lines (the same keys, metric and calibration
names), and each Engine's per-image top-1 (fp32, bf16, INT8 minmax,
percentile and mse) equals the JAX Engine's on the same inputs (the seeds
and builders of the JAX script). An image is excused only where the JAX
Engine's top-2 margin is under 1e-4 of its output's range; the test
prints the count of excused images (0 on this input).
"""

import json
import os

import numpy as np

from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models.squeezenet import (
    build_squeezenet)
from onnx_rusty_inference_engine_tpu.quant import (
    QuantConfig as JQuantConfig, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch.benchmarks import accuracy

ARGV = ["--model", "squeezenet", "--batches", "1", "--batch", "4", "--cpu"]
JAX_KEYS = ["metric", "calibration", "value", "bf16_floor", "unit", "n",
            "target"]


def _jax_outputs(batches: int, batch: int) -> dict:
    """The JAX script's Engines on its inputs: name -> [n, classes]."""
    graph = j_import(build_squeezenet())
    shape = (3, 224, 224)
    rng = np.random.default_rng(7)
    calib = rng.standard_normal((8,) + shape).astype(np.float32)
    engines = {"fp32": JEngine(graph),
               "bf16": JEngine(graph, dtype="bfloat16")}
    for m in accuracy.METHODS:
        engines[m] = JEngine(j_quantize(
            graph, calibration_inputs=[{"data_0": calib}],
            config=JQuantConfig(calibration=m)))
    out = {k: [] for k in engines}
    for _ in range(batches):
        x = rng.standard_normal((batch,) + shape).astype(np.float32)
        for k, eng in engines.items():
            res = eng.run({"data_0": x})
            out[k].append(np.asarray(res[next(iter(res.outputs))]).reshape(
                batch, -1))
    return {k: np.concatenate(v) for k, v in out.items()}


def test_lines_and_per_image_top1_equal_jax(capsys, monkeypatch):
    seen = {}
    real = accuracy.top1s

    def spy(*args):
        seen.update(real(*args))
        return seen

    monkeypatch.setattr(accuracy, "top1s", spy)
    accuracy.main(ARGV)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["calibration"] for ln in lines] == list(accuracy.METHODS)
    for ln in lines:
        assert list(ln) == JAX_KEYS
        assert ln["metric"] == "squeezenet_int8_top1_disagreement"
        assert ln["n"] == 4 and 0.0 <= ln["value"] <= 1.0

    got = seen
    want = _jax_outputs(1, 4)
    excused = 0
    for name, logits in want.items():
        top2 = np.sort(logits, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        span = logits.max(-1) - logits.min(-1)
        tie = margin < 1e-4 * span
        differ = got[name] != logits.argmax(-1)
        assert not (differ & ~tie).any(), (name, got[name],
                                           logits.argmax(-1))
        excused += int((differ & tie).sum())
    print(f"near-tie images excused: {excused}")


def test_jax_script_has_these_lines():
    """The JAX script prints the same keys (read from its source, which
    parses sys.argv and imports JAX at run time)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "accuracy.py")
    src = open(path).read()
    for key in JAX_KEYS:
        assert f'"{key}"' in src, key
    assert "default_rng(7)" in src and '"minmax", "percentile", "mse"' in src

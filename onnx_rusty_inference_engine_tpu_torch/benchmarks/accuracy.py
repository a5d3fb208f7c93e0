"""INT8 accuracy: top-1 disagreement between the fp32 Engine and the INT8
Engines on held-out inputs. The port's counterpart of
benchmarks/accuracy.py, with its flags, seeds, builders and JSON lines.

No labelled dataset ships, so the fp32 model's own predictions are the
ground truth and the metric is the INT8 Engine's top-1 disagreement on
inputs not used for calibration (label-free PTQ fidelity: every
disagreement costs accuracy at most once, and only where fp32 was right).
The bf16 Engine's disagreement is the model's own conditioning floor: on
random weights some families have near-uniform logits, and any
perturbation flips their top-1. One line per calibration method (minmax,
percentile, mse).

    python -m onnx_rusty_inference_engine_tpu_torch.benchmarks.accuracy \\
        [--model squeezenet|resnet50|mobilenetv2] [--batches 8 --batch 32]
        [--cpu]

It runs on the card unless --cpu is passed.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

from ._common import device_name, device_of, emit

METHODS = ("minmax", "percentile", "mse")

# model -> (input name, input shape, builder module and function)
_BUILDERS = {
    "squeezenet": ("data_0", (3, 224, 224), ("squeezenet",
                                             "build_squeezenet")),
    "resnet50": ("data", (3, 128, 128), ("resnet", "build_resnet50")),
    "mobilenetv2": ("input", (3, 128, 128), ("mobilenet",
                                             "build_mobilenetv2")),
}


def top1s(model: str, batches: int, batch: int, device
          ) -> Dict[str, np.ndarray]:
    """Each Engine's top-1 over the held-out inputs, by name ("fp32",
    "bf16" and each calibration method), from the seeds of the reference
    script: default_rng(7) draws 8 calibration inputs, then the batches."""
    import importlib

    from ..engine import Engine
    from ..graph import import_model
    from ..quant import QuantConfig, quantize_graph

    input_name, shape, (module, fn) = _BUILDERS[model]
    build = getattr(importlib.import_module(f"..models.{module}",
                                            __package__), fn)
    graph = import_model(build())
    rng = np.random.default_rng(7)
    calib = rng.standard_normal((8,) + shape).astype(np.float32)
    engines = {"fp32": Engine(graph, device=device),
               "bf16": Engine(graph, dtype="bfloat16", device=device)}
    for method in METHODS:
        engines[method] = Engine(quantize_graph(
            graph, calibration_inputs=[{input_name: calib}],
            config=QuantConfig(calibration=method), device=device),
            device=device)
    out: Dict[str, List[np.ndarray]] = {k: [] for k in engines}
    for _ in range(batches):
        x = rng.standard_normal((batch,) + shape).astype(np.float32)
        for name, eng in engines.items():
            out[name].append(eng.run({input_name: x}).top1())
    return {k: np.concatenate(v) for k, v in out.items()}


def lines(model: str, top: Dict[str, np.ndarray]) -> List[dict]:
    """The three JSON lines of `top1s`'s result, one per calibration."""
    total = top["fp32"].size
    floor = 1.0 - int((top["fp32"] == top["bf16"]).sum()) / total
    return [{
        "metric": f"{model}_int8_top1_disagreement",
        "calibration": m,
        "value": round(1.0 - int((top["fp32"] == top[m]).sum()) / total, 4),
        "bf16_floor": round(floor, 4),
        "unit": "fraction",
        "n": total,
        "target": "<= 0.005 (+ floor)",
    } for m in METHODS]


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="squeezenet", choices=sorted(_BUILDERS))
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    dev = device_of(args.cpu)
    top = top1s(args.model, args.batches, args.batch, dev)
    for line in lines(args.model, top):
        emit({**line, "device": device_name(dev)} if not args.cpu
             else line)


if __name__ == "__main__":
    main()

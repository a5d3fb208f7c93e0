"""Prefill (prompt-processing) throughput: tokens/s of the GPT-2 prefill
graph at serving prompt lengths, fp32, bf16, INT4 weight-only and dynamic
W8A8 (f32 and bf16 Engines). The port's counterpart of
benchmarks/prefill.py, with its flags and metric names.

On the card each Engine's forward is timed with CUDA events over device
resident inputs (utils.timing.engine_throughput).

    python -m onnx_rusty_inference_engine_tpu_torch.benchmarks.prefill \\
        [--layers 12 --d 768 --batch 8 --prompt 256] [--cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ._common import clock, device_name, device_of, emit, seconds_per_step


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--vocab", type=int, default=50257)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt", type=int, default=256)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from ..engine import Engine
    from ..graph import import_model
    from ..models.gpt2 import GPT2Config, build_gpt2
    from ..quant import quantize_matmuls_w8a8, quantize_weights_int4

    dev = device_of(args.cpu)
    cfg = GPT2Config(vocab_size=args.vocab, n_positions=args.prompt,
                     n_embd=args.d, n_layer=args.layers, n_head=args.heads)
    B, P = args.batch, args.prompt
    g = import_model(build_gpt2(cfg, batch=B, seq_len=P,
                                with_presents=False))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
    feed = {"input_ids": torch.as_tensor(ids).to(dev)}
    results = {}
    for label, make in (
            ("fp32", lambda: Engine(g, device=dev)),
            ("bf16", lambda: Engine(g, device=dev, dtype="bfloat16")),
            ("int4_weights", lambda: Engine(quantize_weights_int4(g),
                                            device=dev)),
            # dynamic W8A8: int8 x int8 MatMulIntegers on the int8 kernel,
            # per-row activation scales computed in the graph
            ("w8a8", lambda: Engine(quantize_matmuls_w8a8(g), device=dev)),
            ("w8a8_bf16", lambda: Engine(quantize_matmuls_w8a8(g),
                                         device=dev, dtype="bfloat16"))):
        eng = make()
        if dev.type == "cuda":
            from ..utils.timing import engine_throughput

            seq_per_s = engine_throughput(eng, feed, iters=args.iters)
        else:
            def forward(carry, eng=eng):
                eng(feed)
                return carry

            seq_per_s = B / seconds_per_step(forward, None, args.iters, dev)
        results[label] = tok_s = seq_per_s * P
        emit({"metric": f"gpt2_prefill_{label}", "layers": cfg.n_layer,
              "d_model": cfg.n_embd, "batch": B, "prompt_len": P,
              "tokens_per_sec": tok_s, "clock": clock(dev),
              "device": device_name(dev)})
        del eng
    emit({"metric": "gpt2_prefill_bf16_speedup",
          "value": results["bf16"] / results["fp32"]})
    emit({"metric": "gpt2_prefill_w8a8_vs_bf16",
          "value": results["w8a8_bf16"] / results["bf16"]})


if __name__ == "__main__":
    main()

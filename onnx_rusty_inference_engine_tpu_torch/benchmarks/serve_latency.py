"""Served decode throughput: the wall-clock time of Generator.generate(),
every host dispatch included, the number a client sees, for the host loop
(device_loop 0) and K-step blocks replayed as one CUDA graph each
(device_loop K). The port's counterpart of benchmarks/serve_latency.py,
with its flags and JSON lines, at GPT-2 124M's widths (12 layers, 768)
with INT4 weights and an INT8 KV cache by default. --adapters N attaches a
seeded N-adapter LoRA bank over the attention and MLP projections and
decodes on adapter 1.

    python -m onnx_rusty_inference_engine_tpu_torch.benchmarks.serve_latency \\
        [--new 96] [--loops 0,8,24] [--family gpt2|llama|moe]
        [--adapters N] [--cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from ._common import device_of, device_name, emit


def make_cfg(family: str, d: int, layers: int, max_len: int):
    if family == "gpt2":
        from ..models.gpt2 import GPT2Config
        return GPT2Config(n_embd=d, n_layer=layers, n_head=d // 64,
                          n_positions=max_len)
    if family == "llama":
        from ..models.llama import LlamaConfig
        return LlamaConfig(dim=d, n_layer=layers, n_head=d // 64,
                           n_kv_head=max(1, d // 192),
                           max_positions=max_len)
    if family == "moe":
        from ..models.moe import MoEConfig
        return MoEConfig(n_embd=d, n_layer=layers, n_head=d // 64,
                         n_positions=max_len)
    raise SystemExit(f"unknown family {family}")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--new", type=int, default=96)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--loops", default="0,8,24")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--family", default="gpt2",
                    choices=["gpt2", "llama", "moe"])
    ap.add_argument("--adapters", type=int, default=0,
                    help="attach a seeded N-adapter LoRA bank (overhead "
                         "measurement; gpt2 only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0: sampled device loop (selection on the card)")
    ap.add_argument("--int4", action="store_true", default=True)
    ap.add_argument("--no-int4", dest="int4", action="store_false")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from ..generate import Generator

    dev = device_of(args.cpu)
    cfg = make_cfg(args.family, args.d, args.layers, args.max_len)
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, 8)).astype(np.int64)
    gkw = dict(kv_dtype="int8", int4_weights=args.int4, family=args.family,
               device=dev)
    if args.adapters:
        from ..graph import import_model
        from ..lora import make_adapter_stack
        from ..models import decoder_family

        build_prefill, _, _ = decoder_family(args.family)
        pg = import_model(build_prefill(cfg, batch=args.batch, seq_len=8,
                                        with_presents=True, past_len=0))
        gkw["lora_bank"] = make_adapter_stack(pg, n_adapters=args.adapters,
                                              rank=8,
                                              targets=("attn", "mlp"))
        gkw["adapter"] = 1
    skw = ({"temperature": args.temperature, "sample_seed": 7}
           if args.temperature > 0 else {})
    results = {}
    for k in [int(x) for x in args.loops.split(",")]:
        gen = Generator(cfg, batch=args.batch, prompt_len=8,
                        max_len=args.max_len, device_loop=k, **gkw)
        gen.generate(ids, min(args.new, 8), **skw)  # build, calibrate, capture
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            gen.generate(ids, args.new, **skw)
            best = min(best, time.perf_counter() - t0)
        tps = args.batch * args.new / best
        results[k] = tps
        emit({"bench": "served_decode", "family": args.family,
              "device_loop": k, "batch": args.batch,
              "new_tokens": args.new, "adapters": args.adapters,
              "temperature": args.temperature, "wall_s": best,
              "tokens_per_s": tps, "device": device_name(dev)})
        del gen
    if 0 in results:
        for k, tps in results.items():
            if k:
                emit({"bench": "served_speedup", "family": args.family,
                      "device_loop": k, "vs_host_loop": tps / results[0]})


if __name__ == "__main__":
    main()

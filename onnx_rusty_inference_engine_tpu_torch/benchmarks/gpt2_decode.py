"""GPT-2 decode throughput (tokens/s): fp32 vs INT4 weights, INT8 and INT4
KV caches, fused attention, and the scan-over-layers graphs. The port's
counterpart of benchmarks/gpt2_decode.py, with its flags and metric names.

Each configuration's fixed-cache decode step runs through its Engine (on
the card: the first call eager, later calls a replayed CUDA graph), the
presents and the greedy token fed back as the next step's inputs, and the
steady-state step is timed with CUDA events (utils/timing.py). Random
weights from seed 0, random caches at position max_len / 2.

    python -m onnx_rusty_inference_engine_tpu_torch.benchmarks.gpt2_decode \\
        [--layers 12 --d 768 --batch 8] [--cpu]
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
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from ..engine import Engine
    from ..graph import import_model
    from ..models import host_memo
    from ..models.gpt2 import GPT2Config, build_gpt2_decode
    from ..quant import quantize_weights_int4

    dev = device_of(args.cpu)
    cfg = GPT2Config(vocab_size=args.vocab, n_positions=args.max_len,
                     n_embd=args.d, n_layer=args.layers, n_head=args.heads)
    B, H, L, hd = args.batch, cfg.n_head, args.max_len, cfg.head_dim
    NL = cfg.n_layer
    rng = np.random.default_rng(0)

    def graph(**kw):
        return import_model(build_gpt2_decode(cfg, batch=B, max_len=L, **kw))

    def make_feed(int8_kv: bool, stacked: bool = False,
                  int4_kv: bool = False):
        feed = {"input_ids": rng.integers(0, cfg.vocab_size, (B, 1)),
                "pos": np.full((B,), L // 2, dtype=np.int64)}
        shape = (NL, B, H, L, hd) if stacked else (B, H, L, hd)
        for kind in ("key", "value"):
            if int4_kv:  # nibble-packed bytes, two 4-bit values each
                q = rng.integers(-128, 128, (B, H, L, hd // 2)).astype(
                    np.int8)
                for i in range(NL):
                    feed[f"past_{kind}_{i}"] = q
                    feed[f"kv_scale_{kind}_{i}"] = np.full((H,), 1 / 16,
                                                           np.float32)
                continue
            kv = rng.standard_normal(shape).astype(np.float32)
            if int8_kv:
                kv = np.clip(np.round(kv * 32), -127, 127).astype(np.int8)
            if stacked:
                feed[f"past_{kind}"] = kv
                if int8_kv:
                    feed[f"kv_scale_{kind}"] = np.full((NL, H), 1 / 32,
                                                       np.float32)
            else:
                for i in range(NL):
                    feed[f"past_{kind}_{i}"] = kv
                    if int8_kv:
                        feed[f"kv_scale_{kind}_{i}"] = np.full(
                            (H,), 1 / 32, np.float32)
        return {k: torch.as_tensor(v).to(dev) for k, v in feed.items()}

    def bench(g, label, feed) -> float:
        eng = Engine(g, device=dev)
        pasts = [k for k in feed if k.startswith("past_")]

        def step(carry):
            out = eng(carry)
            new = dict(carry)
            # feed the presents back in, as the decode loop does
            for name in pasts:
                new[name] = out[name.replace("past_", "present_", 1)]
            new["input_ids"] = out["logits"][:, -1, :].argmax(-1)[:, None]
            return new

        sec = seconds_per_step(step, feed, args.iters, dev)
        emit({"metric": f"gpt2_decode_{label}", "layers": cfg.n_layer,
              "d_model": cfg.n_embd, "batch": B, "cache_len": L,
              "step_ms": sec * 1e3, "tokens_per_sec": B / sec,
              "clock": clock(dev), "device": device_name(dev)})
        del eng
        return sec

    with host_memo():  # every graph of the config draws its weights once
        t_f = bench(graph(), "fp32", make_feed(False))
        t_4 = bench(quantize_weights_int4(graph()), "int4_weights",
                    make_feed(False))
        t_48 = bench(quantize_weights_int4(graph(kv_dtype="int8")),
                     "int4_weights_int8_kv", make_feed(True))
        t_f48 = bench(quantize_weights_int4(graph(
            kv_dtype="int8", fused_attention=True)),
            "int4_weights_int8_kv_fusedattn", make_feed(True))
        # int4 KV: the nibble-packed [B,H,L,hd/2] cache, half the int8
        # cache's bytes
        t_k4 = bench(quantize_weights_int4(graph(kv_dtype="int4")),
                     "int4_weights_int4_kv", make_feed(False, int4_kv=True))
        # scan-over-layers forms: the same math, one Scan over stacked
        # weights and a stacked cache
        t_sf = bench(graph(scan_layers=True), "scan_fp32",
                     make_feed(False, stacked=True))
        t_s48 = bench(quantize_weights_int4(graph(
            kv_dtype="int8", scan_layers=True)),
            "scan_int4_weights_int8_kv", make_feed(True, stacked=True))
    for name, t in (("gpt2_decode_int4_speedup", t_4),
                    ("gpt2_decode_int4_int8kv_speedup", t_48),
                    ("gpt2_decode_int4_int4kv_speedup", t_k4),
                    ("gpt2_decode_fusedattn_speedup", t_f48),
                    ("gpt2_decode_scan_speedup_vs_fp32", t_sf),
                    ("gpt2_decode_scan_int4_int8kv_speedup", t_s48)):
        emit({"metric": name, "value": t_f / t})


if __name__ == "__main__":
    main()

"""Llama-family decode throughput (tokens/s): fp32 vs INT4 weights with
INT8 and INT4 KV caches, fused attention, and the scan-over-layers graph.
The port's counterpart of benchmarks/llama_decode.py, with its flags and
metric names; the harness of gpt2_decode.py, for the GQA decoder.

    python -m onnx_rusty_inference_engine_tpu_torch.benchmarks.llama_decode \\
        [--layers 12 --dim 768 --batch 8] [--cpu]
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
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--kv-heads", dest="kv_heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-len", dest="max_len", type=int, default=256)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from ..engine import Engine
    from ..graph import import_model
    from ..models import host_memo
    from ..models.llama import LlamaConfig, build_llama_decode
    from ..quant import pack_int4_kv, quantize_weights_int4

    dev = device_of(args.cpu)
    cfg = LlamaConfig(vocab_size=args.vocab, max_positions=args.max_len,
                      dim=args.dim, n_layer=args.layers, n_head=args.heads,
                      n_kv_head=args.kv_heads)
    B, L, Hkv, hd = args.batch, args.max_len, cfg.n_kv_head, cfg.head_dim
    NL = cfg.n_layer
    rng = np.random.default_rng(0)

    def graph(**kw):
        return import_model(build_llama_decode(cfg, batch=B, max_len=L,
                                               **kw))

    def make_feed(int8_kv: bool, stacked: bool = False,
                  int4_kv: bool = False):
        feed = {"input_ids": rng.integers(0, cfg.vocab_size, (B, 1)),
                "pos": np.full((B,), L // 2, dtype=np.int64)}
        shape = (NL, B, Hkv, L, hd) if stacked else (B, Hkv, L, hd)
        for kind in ("key", "value"):
            kv = rng.standard_normal(shape).astype(np.float32)
            if int4_kv:
                sc = (np.abs(kv).max(axis=(0, 2, 3)) / 7.0).astype(
                    np.float32)
                q = pack_int4_kv(torch.from_numpy(kv), torch.from_numpy(
                    sc[None, :, None, None])).numpy()
                for i in range(NL):
                    feed[f"past_{kind}_{i}"] = q
                    feed[f"kv_scale_{kind}_{i}"] = sc
                continue
            if int8_kv:
                kv = np.clip(np.round(kv * 32), -127, 127).astype(np.int8)
            if stacked:
                feed[f"past_{kind}"] = kv
                if int8_kv:
                    feed[f"kv_scale_{kind}"] = np.full((NL, Hkv), 1 / 32,
                                                       np.float32)
            else:
                for i in range(NL):
                    feed[f"past_{kind}_{i}"] = kv
                    if int8_kv:
                        feed[f"kv_scale_{kind}_{i}"] = np.full(
                            (Hkv,), 1 / 32, np.float32)
        return {k: torch.as_tensor(v).to(dev) for k, v in feed.items()}

    def bench(g, label, feed) -> float:
        eng = Engine(g, device=dev)
        pasts = [k for k in feed if k.startswith("past_")]

        def step(carry):
            out = eng(carry)
            new = dict(carry)
            for name in pasts:
                new[name] = out[name.replace("past_", "present_", 1)]
            new["input_ids"] = out["logits"][:, -1, :].argmax(-1)[:, None]
            return new

        sec = seconds_per_step(step, feed, args.iters, dev)
        emit({"metric": f"llama_decode_{label}", "layers": cfg.n_layer,
              "dim": cfg.dim, "heads": cfg.n_head, "kv_heads": Hkv,
              "batch": B, "cache_len": L, "step_ms": sec * 1e3,
              "tokens_per_sec": B / sec, "clock": clock(dev),
              "device": device_name(dev)})
        del eng
        return sec

    with host_memo():
        t_f = bench(graph(), "fp32", make_feed(False))
        t_48 = bench(quantize_weights_int4(graph(kv_dtype="int8")),
                     "int4_weights_int8_kv", make_feed(True))
        bench(quantize_weights_int4(graph(kv_dtype="int4")),
              "int4_weights_int4_kv", make_feed(False, int4_kv=True))
        t_f48 = bench(quantize_weights_int4(graph(
            kv_dtype="int8", fused_attention=True)),
            "int4_weights_int8_kv_fusedattn", make_feed(True))
        t_s48 = bench(quantize_weights_int4(graph(
            kv_dtype="int8", scan_layers=True)),
            "scan_int4_weights_int8_kv", make_feed(True, stacked=True))
    for name, t in (("llama_decode_int4_int8kv_speedup", t_48),
                    ("llama_decode_fusedattn_speedup", t_f48),
                    ("llama_decode_scan_int4_int8kv_speedup", t_s48)):
        emit({"metric": name, "value": t_f / t})


if __name__ == "__main__":
    main()

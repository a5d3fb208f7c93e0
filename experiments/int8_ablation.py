#!/usr/bin/env python3
"""Where the int8 tensor-core kernels spend their time, by ablation, on one
CUDA card.

    python3 experiments/int8_ablation.py [--out build/int8_ablation.jsonl]

Builds variants of csrc/qconv_int8.cu and csrc/qmatmul_int8.cu from the
package's own sources with one part of the shared mainloop
(csrc/int8_wgmma.cuh) switched off by a text edit, and times each at
SqueezeNet 1.0 b256 and BERT-base shapes through the package's wrappers
(device ms from a replayed CUDA graph, chip_smoke.graph_ms). The variants
compute wrong values on purpose, so nothing is checked: it is a
measurement, not part of the port.

  full         the kernel as it is
  no_mma       no wgmma: the consumers wait for each slot and free it
  no_epilogue  the requant epilogue skipped (no staging, no stores)
  no_store     the epilogue without its global stores
  no_tma_a     (A by TMA) A's loads skipped; no_tma_b: B's
  no_copy      (gather) no copies into the ring
  a+b          variants joined by "+" apply both

Each line also names the tile; `--tiles` runs the full kernel on other
tiles (BM, BN, stages) for the same shapes, and `--gather-1x1` the 1x1
convs through the gather producer (variant "full/gather"). Prints one
JSON line per
(shape, variant, tile), and the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import graph_ms, nvidia_smi  # noqa: E402
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (  # noqa: E402
    _build, qconv_int8 as k, qmatmul_int8 as q8)

HEADER = "int8_wgmma.cuh"
VARIANTS = {
    "full": [],
    "no_mma": [("        Wgmma<BN, AU8>::mma(acc, sw128_desc(a_slot + kk * 32), "
                "sw128_desc(b_slot + kk * 32),\n"
                "                       (kt | kk) != 0);", "        ;")],
    "no_epilogue": [("      uint8_t* stage = staging + wg * 64 * LDS;\n",
                     "      if (p.M > 0) continue;\n"
                     "      uint8_t* stage = staging + wg * 64 * LDS;\n")],
    "no_tma_a": [("          mbar_arrive_tx(full0 + 8 * s, SLOT);\n"
                  "          tma_load_2d(slot, &tm_a, full0 + 8 * s, kt * BK, m0);\n",
                  "          mbar_arrive_tx(full0 + 8 * s, B_BYTES);\n")],
    "no_tma_b": [("          mbar_arrive_tx(full0 + 8 * s, SLOT);\n"
                  "          tma_load_2d(slot, &tm_a, full0 + 8 * s, kt * BK, m0);\n"
                  "          if (!bres) tma_load_2d(slot + A_BYTES, &tm_b, "
                  "full0 + 8 * s, kt * BK, n0);\n",
                  "          mbar_arrive_tx(full0 + 8 * s, A_BYTES);\n"
                  "          tma_load_2d(slot, &tm_a, full0 + 8 * s, kt * BK, m0);\n")],
    "no_copy": [("        cp_async_zfill<G>(dst, src, ok);",
                 "        if (src == nullptr) cp_async_zfill<G>(dst, src, ok);")],
    "no_store": [("        if (wg * 64 + r >= rows || n >= p.N) continue;\n",
                  "        if (wg * 64 + r >= rows || n >= p.N || p.N > 0) "
                  "continue;\n")],
}

# (name, kind, shape): conv (B, C, H, O, k, stride, pad), channels-last
# input; conv1 as the kernel reads it (3 channels padded to 4)
SHAPES = [
    ("conv1", "conv", (256, 4, 224, 96, 7, 2, 0)),
    ("fire2/squeeze", "conv", (256, 96, 54, 16, 1, 1, 0)),
    ("fire2/expand1x1", "conv", (256, 16, 54, 64, 1, 1, 0)),
    ("fire2/expand3x3", "conv", (256, 16, 54, 64, 3, 1, 1)),
    ("fire4/expand1x1", "conv", (256, 32, 54, 128, 1, 1, 0)),
    ("fire4/expand3x3", "conv", (256, 32, 54, 128, 3, 1, 1)),
    ("conv10", "conv", (256, 512, 12, 1000, 1, 1, 0)),
    ("bert_qkvo", "gemm", (4096, 768, 768)),
    ("bert_ffn_in", "gemm", (4096, 768, 3072)),
    ("bert_ffn_out", "gemm", (4096, 3072, 768)),
]


def build_variant(name: str) -> dict:
    """Compile qconv_int8.cu and qmatmul_int8.cu with the variant's edits
    into build/ablation/<name>/; library name -> loaded CDLL."""
    src_dir = os.path.join(HERE, "build", "ablation", name)
    os.makedirs(src_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        header = f.read()
    for old, new in [e for part in name.split("+") for e in VARIANTS[part]]:
        if old not in header:
            raise RuntimeError(f"variant {name}: edit target not found")
        header = header.replace(old, new)
    with open(os.path.join(src_dir, HEADER), "w") as f:
        f.write(header)
    procs = {}
    for lib in ("qconv_int8", "qmatmul_int8"):
        with open(os.path.join(_build.CSRC_DIR, f"{lib}.cu")) as f:
            src = f.read()
        path = os.path.join(src_dir, f"{lib}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(src_dir, f"lib{lib}.so")
        procs[lib] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for lib, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}/{lib}:\n{log}")
        libs[lib] = ctypes.CDLL(so)
    return libs


def operands(kind, shape, rng):
    dev = torch.device("cuda")
    if kind == "conv":
        B, C, H, O, ksz, s, pad = shape
        x = torch.from_numpy(rng.integers(-128, 128, (B, C, H, H), np.int8)
                             ).to(dev).contiguous(
                                 memory_format=torch.channels_last)
        w = torch.from_numpy(rng.integers(-127, 128, (O, C, ksz, ksz),
                                          np.int8)).to(dev)
        mult = torch.full((O,), 1e-4, device=dev)
        bias = torch.zeros(O, dtype=torch.int32, device=dev)
        packed = k.pack_qconv_weight(w, (s, s))
        pads = ((pad, pad), (pad, pad))
        OH = (H + 2 * pad - ksz) // s + 1
        dims = (B * OH * OH, O, packed.shape[1])
        return dims, lambda: k.qconv_int8_requant(
            x, w, mult, bias, stride=(s, s), padding=pads, packed=packed)
    M, K, N = shape
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-128, 128, (K, N), np.int8)).to(dev)
    mult = torch.full((N,), 1e-4, device=dev)
    packed = q8.pack_qmatmul_weight(b)
    return (M, N, K), lambda: q8.qmatmul_int8_requant(a, b, mult,
                                                     packed=packed)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "int8_ablation.jsonl"))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--tiles", default="",
                    help="extra tiles for the full kernel, e.g. "
                         "'128x96x3,64x96x6' (BMxBNxSTAGES)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape names (default: all)")
    ap.add_argument("--gather-1x1", action="store_true",
                    help="also run the 1x1 convs through the gather "
                         "producer (full kernel, picked tile)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    names = args.variants.split(",")
    built = {n: build_variant(n) for n in names}
    extra = [q8.Int8Tile(*map(int, t.split("x")))
             for t in args.tiles.split(",") if t]
    rng = np.random.default_rng(0)
    real_k_tile, real_q8_tile = k.int8_tile, q8.int8_tile
    real_producer = k.conv_producer
    # the mainloop's gather and TMA producers: the 3x3 expands stay on the
    # gather (conv_plan gives them the staged-halo producer, which
    # experiments/conv3d_ablation.py measures)
    k._halo_ok = lambda *a: False
    with open(args.out, "w") as out:
        for sname, kind, shape in SHAPES:
            if args.shapes and sname not in args.shapes.split(","):
                continue
            dims, call = operands(kind, shape, rng)
            picked = q8.int8_tile(*dims)
            runs = [(n, picked) for n in names]
            runs += [("full", t) for t in extra if t != picked]
            if args.gather_1x1 and kind == "conv" and shape[4] == 1:
                runs.append(("full/gather", picked))
            for variant, tile in runs:
                _build._LOADED.update(built[variant.split("/")[0]])
                k.int8_tile = q8.int8_tile = lambda *a, t=tile: t
                if variant.endswith("/gather"):
                    k.conv_producer = lambda *a: "gather"
                try:
                    ms = graph_ms(call, args.iters)
                    err = None
                except RuntimeError as e:  # a tile the kernel refuses
                    ms, err = None, str(e)[-120:]
                finally:
                    k.int8_tile, q8.int8_tile = real_k_tile, real_q8_tile
                    k.conv_producer = real_producer
                line = {"shape": sname, "kind": kind, "dims": list(dims),
                        "variant": variant, "tile": list(tile),
                        "picked": tile == picked, "ms": ms, "error": err,
                        "card": smi}
                print(json.dumps(line), flush=True)
                out.write(json.dumps(line) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the decode-attention kernels spend their time, by ablation, on one
CUDA card.

    python3 experiments/attn_ablation.py [--parent DIR] [--out FILE]

Builds variants of csrc/decode_attn.cu from the package's own source, each
stopping at one stage boundary (every CTA returns there, so no cluster
barrier is left waiting), and times both kernels through the package's
wrapper at GPT-2 decode shapes (device ms from a replayed CUDA graph,
chip_smoke.graph_ms), with every cluster size the shape allows. The
variants compute wrong values on purpose, so nothing is checked: it is a
measurement, not part of the port.

  full            the kernel as it is
  empty           returns at once (the launch alone)
  setup           q, its norms and the bias row's max, then returns
  scores          ... and the scores (K and V loads issued) and the
                  cluster's max, then returns
  softmax         ... and the cluster's sum (and pmax), then returns
  pv              ... and p . V into rank 0's shared memory, no output
  nk8, threads256 the full kernel with 8 loads in flight a thread, or
                  256 threads a CTA
  i2f             bytes to floats by the conversion instruction

--clocks adds a variant with clock64() stamps at the stage boundaries and
prints the cycles CTA 0's thread 0 spends in each stage (one warm call
first). --parent DIR times the decode_attn.cu of another checkout (DIR, e.g. the
parent commit unpacked with git archive) through its own C entry points
(no cluster argument), as variant "parent". --splits also times the full
kernel at every cluster size 1, 2, 4, 8 that fits. Prints one JSON line
per (shape, kernel, variant, cluster), the card's name and power limit
first.
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

from chip_smoke import ATTN_SWEEP, graph_ms, nvidia_smi  # noqa: E402
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (  # noqa: E402
    _build, decode_attn as da)

SOURCE = "decode_attn.cu"
STOP = "  if (s.L > 0) return;\n"
# the same, where the cluster barrier's first arrive waits to be matched
STOP_WAIT = "  if (s.L > 0) {\n    if (C > 1) cluster_wait();\n    return;\n  }\n"
MARKS = {  # variant -> (the line it returns before, the return)
    "empty": ("  const int rank = C > 1", STOP_WAIT),
    "setup": ("  // the first batch of K and V rows", STOP_WAIT),
    "scores": ("  // --- e = exp(s - m)", STOP),
    "softmax": ("  // --- p . V:", STOP),
    "pv": ("  if (rank != 0) return;", STOP),
}
# variants that change a constant of the kernel instead of stopping it
EDITS = {
    "nk8": ("constexpr int NK = 4;", "constexpr int NK = 8;"),
    "threads256": ("constexpr int THREADS = 128;",
                   "constexpr int THREADS = 256;"),
    "i2f": ("    f[c] = __fsub_rn(__int_as_float(static_cast<int>(__byte_perm(w[c >> 2], 0x4B000000u,\n"
            "                                                                 0x7540u | (c & 3)))),\n"
            "                     8388736.f);",
            "    f[c] = static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(\n"
            "        (w[c >> 2] ^ 0x80808080u) >> (8 * (c & 3)))));"),
}
KERNELS = ("decode_attention_int8", "decode_attention_int8_mxu")

# the "clocks" variant: clock64() stamps at the stage boundaries of CTA 0,
# thread 0, written as cycle counts into the rows_read buffer (int32 [16])
# instead of the rows count
STAMPS = (  # (line, stamp before it (True) or after it (False))
    ("  const int rank = C > 1", False),
    ("  // the first batch of K and V rows", True),
    ("  if (C > 1) cluster_wait();  // every peer", False),
    ("  if (rows_read != nullptr) {", True),
    ("  // --- e = exp(s - m)", True),
    ("  // --- the int8 form: p = e / sum", True),
    ("  // --- p . V:", True),
    ("  // --- rank 0 sums", True),
    ("  if (rank != 0) return;", False),
)
STAGES = ("setup", "load_issue_and_wait", "scores", "max_exchange",
          "e_and_sum_exchange", "p_(and_pmax_exchange)", "pv_and_push",
          "final_sync", "output")


PV_START = "  for (int rb = 0; rb < rep; rb += RB) {\n    float acc[RB][16];"


def pv_twice_source(src: str) -> str:
    """The clocks variant with the p . V stage run twice in a row (same
    registers and shared memory, so the second pass differs from the first
    only in finding its instructions cached): its two times go to
    rows_read[9] and [10]."""
    src = clocks_source(src)
    a = src.index(PV_START)
    b = src.index(f"  const long long clk{len(STAMPS) - 2} = clock64();")
    body = src[a:b]
    loop = ("  long long pv_t0 = 0, pv_t1 = 0;\n"
            "#pragma unroll 1\n"
            "  for (int twice = 0; twice < 2; ++twice) {\n"
            "  if (twice == 0) pv_t0 = clock64(); else pv_t1 = clock64();\n"
            + body + "  }\n  const long long pv_t2 = clock64();\n")
    src = src[:a] + loop + src[b:]
    return src.replace(
        "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n",
        "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
        "    rows_read[9] = static_cast<int>(pv_t1 - pv_t0);\n"
        "    rows_read[10] = static_cast<int>(pv_t2 - pv_t1);\n", 1)


def clocks_source(src: str) -> str:
    for k, (line, before) in enumerate(STAMPS):
        if src.count(line) != 1:
            raise RuntimeError(f"clocks: {line!r} not found once")
        stamp = f"  const long long clk{k} = clock64();\n"
        head, tail = src.split(line)
        if before:
            src = head + stamp + line + tail
        else:
            end = tail.index("\n") + 1
            src = head + line + tail[:end] + stamp + tail[end:]
    src = src.replace("  if (rows_read != nullptr) {", "  if (false) {")
    write = "".join(f"    rows_read[{k}] = static_cast<int>(clk{k + 1} - clk{k});\n"
                    for k in range(len(STAMPS) - 1))
    write += (f"    rows_read[{len(STAMPS) - 1}] = static_cast<int>(clock64() "
              f"- clk{len(STAMPS) - 1});\n")
    end = "}\n\nusing KernelFn"
    return src.replace(end, "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
                       + write + "  }\n" + end)


def _compile(name: str, src: str):
    """Start nvcc on `src` into build/attn_ablation/<name>/: (so, proc)."""
    out_dir = os.path.join(HERE, "build", "attn_ablation", name)
    os.makedirs(out_dir, exist_ok=True)
    path, so = os.path.join(out_dir, SOURCE), os.path.join(out_dir,
                                                           "lib.so")
    with open(path, "w") as f:
        f.write(src)
    return so, subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(name: str, started) -> ctypes.CDLL:
    so, proc = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}:\n{log}")
    return ctypes.CDLL(so)


def build_variants(names, parent: str = "") -> dict:
    """Every variant's library (and the other checkout's, as "parent"),
    one nvcc each, all at once."""
    with open(os.path.join(_build.CSRC_DIR, SOURCE)) as f:
        src = f.read()
    started = {}
    for name in names:
        if name in ("clocks", "pv_twice"):
            continue
        edited = src
        if name in EDITS:
            old, new = EDITS[name]
            if edited.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit target not found")
            edited = edited.replace(old, new)
        elif name != "full":
            mark, stop = MARKS[name]
            if edited.count(mark) != 1:
                raise RuntimeError(f"variant {name}: mark not found once")
            edited = edited.replace(mark, stop + mark)
        started[name] = _compile(name, edited)
    if "clocks" in names:
        started["clocks"] = _compile("clocks", clocks_source(src))
    if "pv_twice" in names:
        started["pv_twice"] = _compile("pv_twice", pv_twice_source(src))
    if parent:
        with open(os.path.join(parent, "onnx_rusty_inference_engine_tpu_"
                               "torch", "csrc", SOURCE)) as f:
            started["parent"] = _compile("parent", f.read())
    return {name: _load(name, s) for name, s in started.items()}


def parent_call(lib, name, q, k8, v8, bias, H):
    """A call of the other checkout's kernel through its own C entry point
    (q, k8, v8, bias, out, B, H, Hkv, L, hd, stream)."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, L, hd = bias.shape[0], bias.shape[-1], q.shape[-1]
    Hkv = k8.shape[0] // B
    out = torch.empty_like(q)

    def call():
        err = fn(q.data_ptr(), k8.data_ptr(), v8.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), B, H, Hkv, L, hd,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent {name}: cudaError {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "attn_ablation.jsonl"))
    ap.add_argument("--variants", default="full," + ",".join(MARKS))
    ap.add_argument("--parent", default="")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--shapes", default="",
                    help="comma-separated ATTN_SWEEP labels (default: all)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--clocks", action="store_true",
                    help="also build the clocks variant and print the cycles "
                         "CTA 0 spends in each stage (after a warm-up), and "
                         "the pv_twice variant: p . V run twice, cycles of "
                         "each pass")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    names = args.variants.split(",") + (["clocks", "pv_twice"]
                                         if args.clocks else [])
    libs = build_variants(names, args.parent)
    clocks = libs.pop("clocks", None)
    pv_twice = libs.pop("pv_twice", None)
    parent = libs.pop("parent", None)
    rng = np.random.default_rng(3)
    with open(args.out, "w") as out:
        for label, B, H, Hkv, hd, L, n_valid in ATTN_SWEEP:
            if args.shapes and label not in args.shapes.split(","):
                continue
            q = torch.from_numpy((rng.standard_normal((B * H, 1, hd)) / (
                127 * np.sqrt(hd))).astype(np.float32)).cuda()
            k8, v8 = (torch.from_numpy(rng.integers(
                -127, 128, (B * Hkv, L, hd), dtype=np.int8)).cuda()
                for _ in range(2))
            bias = torch.from_numpy(np.broadcast_to(np.where(
                np.arange(L) < n_valid, 0.0, -1e9).astype(np.float32),
                (B, 1, L)).copy()).cuda()
            picked = da.attn_split(B, H, Hkv, L, hd)
            for kname in KERNELS:
                runs = [(v, picked) for v in libs]
                if args.splits:
                    runs += [("full", c) for c in (1, 2, 4, 8)
                             if c != picked and (c - 1) * -(-L // c) < L]
                if parent is not None:
                    runs.append(("parent", None))
                if clocks is not None:
                    _build._LOADED["decode_attn"] = clocks
                    buf = torch.zeros(16, dtype=torch.int32, device="cuda")
                    for _ in range(5):
                        da._launch(kname, q, k8, v8, bias, H, rows_read=buf)
                    torch.cuda.synchronize()
                    cyc = buf.tolist()[:len(STAGES)]
                    line = {"shape": label, "kernel": kname,
                            "variant": "clocks", "cluster": picked,
                            "cycles": dict(zip(STAGES, cyc)),
                            "total_cycles": sum(cyc),
                            "clocks": subprocess.run(
                                ["nvidia-smi", "--query-gpu=clocks.sm,"
                                 "clocks.max.sm", "--format=csv,noheader"],
                                capture_output=True, text=True).stdout.strip(),
                            "card": smi}
                    print(json.dumps(line), flush=True)
                    out.write(json.dumps(line) + "\n")
                    _build._LOADED["decode_attn"] = pv_twice
                    buf.zero_()
                    for _ in range(5):
                        da._launch(kname, q, k8, v8, bias, H, rows_read=buf)
                    torch.cuda.synchronize()
                    line = {"shape": label, "kernel": kname,
                            "variant": "pv_twice", "cluster": picked,
                            "pv_cycles_first": int(buf[9]),
                            "pv_cycles_second": int(buf[10]), "card": smi}
                    print(json.dumps(line), flush=True)
                    out.write(json.dumps(line) + "\n")
                for variant, c in runs:
                    if variant == "parent":
                        call = parent_call(parent, kname, q, k8, v8, bias, H)
                    else:
                        _build._LOADED["decode_attn"] = libs[variant]

                        def call(c=c, kname=kname):
                            return da._launch(kname, q, k8, v8, bias, H,
                                              split=c)
                    try:
                        ms, err = graph_ms(call, args.iters), None
                    except RuntimeError as e:  # a split the kernel refuses
                        ms, err = None, str(e)[-120:]
                    line = {"shape": label, "kernel": kname,
                            "variant": variant, "cluster": c,
                            "picked": c == picked, "ms": ms, "error": err,
                            "card": smi}
                    print(json.dumps(line), flush=True)
                    out.write(json.dumps(line) + "\n")
            del q, k8, v8, bias
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the 3-D int8 convs' Hopper forms spend their time, by ablation, on
one CUDA card.

    python3 experiments/conv3d_ablation.py [--out build/conv3d_ablation.jsonl]

Builds variants of csrc/qconv_int8.cu (the staged-halo producer of the
shared mainloop, csrc/int8_wgmma.cuh) and csrc/qconv_grouped_int8.cu (the
tile3d form) from the package's own sources with one part changed by a
text edit, and times each at R3D-18's four stride-1 3x3x3 shapes (b16),
four 2-D 3x3s on the same producer (SqueezeNet's and ResNet-50's, b256),
the four stems as their space-to-depth rewrite (and SqueezeNet's as
ORT's dynamic ConvInteger on the int32 epilogue; stem lines also give
`layout_ms`, the layout pass alone; `ms` includes it) and the depthwise
3x3x3 at R3D layer1's activation, through the package's
wrappers (device ms from a replayed CUDA graph, chip_smoke.graph_ms). The
ablations compute wrong values on purpose, so nothing is checked: it is a
measurement, not part of the port.

  full         the kernels as they are
  no_mma       (halo) no wgmma: the consumers walk the slices and barriers
  no_epilogue  (halo) the requant epilogue skipped
  no_box       (halo) no input box loads (the consumers read stale boxes)
  a_sw128      (halo) A read from the weights' 128-byte-swizzled slice (the
               same bytes as B), not the box without swizzle
  wait2        (halo) two slices' products in flight on a ring of weights
               (needs 3 or more stages), not one
  no_store     (tile3d) the outputs not stored
  no_wb        (tile3d) the stride-1 second column's [0, w0, w1, w2] words
               shifted from [w0, w1, w2, 0] at each use, not kept
  lb2          (tile3d) launch bounds of two blocks an SM (<= 128 registers)
  lb1halo      (halo) launch bounds of one block an SM for the BN-96
               tiles of one patch a warpgroup (the first design; the
               kernels hold two, so that one block's epilogue runs beside
               the other's products)
  no_mb2       (build) no halo instances of two planes a warpgroup
  no_u8halo    (build) no halo instances for a uint8 x
  no_halo      (build) no halo instances
  a+b          variants joined by "+" apply both

Each variant's line first gives each library's nvcc seconds (the two
libraries build together).

`--tiles` also runs the full halo kernel on other tiles for the same
shapes (BMxBNxSTAGES, with an `r` for resident weights, e.g. 128x64x4,
128x64x2r). Prints the card's name and power limit, the ptxas lines of
each variant's new kernel instances, then one JSON line per (shape,
variant, tile).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import graph_ms, nvidia_smi  # noqa: E402
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (  # noqa: E402
    _build, qconv_grouped_int8 as g8, qconv_int8 as k, qmatmul_int8 as q8)

# variant -> [(file, old text, new text)]
VARIANTS = {
    "full": [],
    "no_mma": [("int8_wgmma.cuh",
                "            Wgmma<BN, AU8>::mma(acc[mb], a + (uint64_t)(mb * "
                "(patch >> 4)), sw128_desc(b),\n"
                "                                (q | st) != 0);",
                "            acc[mb][0] += (int)a;"),
               ("int8_wgmma.cuh",
                "              Wgmma<BN, AU8>::mma(acc[mb], a + (uint64_t)(mb * "
                "(patch >> 4)),\n"
                "                                  sw128_desc(b_slot + kk * 32)"
                ", (q | j | kk) != 0);",
                "              acc[mb][0] += (int)a;")],
    "no_epilogue": [("int8_wgmma.cuh",
                     "      store_tile<EPI, BN>(p, acc[mb], staging, wg, tid, "
                     "tile % n_tiles * BN,",
                     "      if (p.M > 0) continue;\n"
                     "      store_tile<EPI, BN>(p, acc[mb], staging, wg, tid, "
                     "tile % n_tiles * BN,")],
    "no_box": [("int8_wgmma.cuh",
                "      mbar_arrive_tx(bar, box_tx);\n"
                "      for (int i = 0; i < blocks; ++i)\n",
                "      mbar_arrive(bar);\n"
                "      for (int i = 0; i < blocks && box_tx == 0; ++i)\n")],
    "a_sw128": [("int8_wgmma.cuh",
                 "            Wgmma<BN, AU8>::mma(acc[mb], a + (uint64_t)(mb "
                 "* (patch >> 4)), sw128_desc(b),",
                 "            Wgmma<BN, AU8>::mma(acc[mb], sw128_desc(b + "
                 "((uint32_t)a & 1024)), sw128_desc(b),"),
                ("int8_wgmma.cuh",
                 "              Wgmma<BN, AU8>::mma(acc[mb], a + (uint64_t)(mb "
                 "* (patch >> 4)),",
                 "              Wgmma<BN, AU8>::mma(acc[mb], sw128_desc(b_slot "
                 "+ kk * 32 + ((uint32_t)a & 1024)),")],
    "wait2": [("int8_wgmma.cuh",
               "          wgmma_wait<1>();\n"
               "          if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * "
               "((it - 1) % S));",
               "          wgmma_wait<2>();\n"
               "          if (j > 1 && lane == 0) mbar_arrive(empty0 + 8 * "
               "((it - 2) % S));"),
              ("int8_wgmma.cuh",
               "        if (!bres) mbar_arrive(empty0 + 8 * ((it - 1) % S));\n"
               "        mbar_arrive(box_empty0",
               "        if (!bres && p.chunk_k > 1) mbar_arrive(empty0 + 8 * "
               "((it - 2) % S));\n"
               "        if (!bres) mbar_arrive(empty0 + 8 * ((it - 1) % S));\n"
               "        mbar_arrive(box_empty0")],
    "no_mb2": [("int8_wgmma.cuh",
                "  if (bm == 256)\n"
                "    return bn == 64   ? launch_tile<A_HALO, EPI, 64, 2, AU8, "
                "2>(ta, tb, p, st)\n"
                "           : bn == 96 ? launch_tile<A_HALO, EPI, 96, 2, AU8, "
                "2>(ta, tb, p, st)\n"
                "                      : launch_tile<A_HALO, EPI, 128, 2, "
                "AU8, 2>(ta, tb, p, st);\n",
                "  if (bm == 256) return cudaErrorInvalidValue;\n")],
    "no_u8halo": [("qconv_int8.cu",
                   "    return x_u8 ? i8g::launch_halo<i8g::EPI_REQUANT, true>"
                   "(x, w, Kp, B, p, bm, bn, st)\n",
                   "    return x_u8 ? cudaErrorInvalidValue\n")],
    "no_halo": [("qconv_int8.cu",
                 "    return x_u8 ? i8g::launch_halo<i8g::EPI_REQUANT, true>"
                 "(x, w, Kp, B, p, bm, bn, st)\n"
                 "                : i8g::launch_halo<i8g::EPI_REQUANT, false>"
                 "(x, w, Kp, B, p, bm, bn, st);",
                 "    return cudaErrorInvalidValue;")],
    "no_store": [("qconv_grouped_int8.cu",
                  "  *reinterpret_cast<uint32_t*>(dst) = pack4(q0[0], q0[1], "
                  "q0[2], q0[3]);\n  if (th.col1) "
                  "*reinterpret_cast<uint32_t*>(dst + th.y_col) = "
                  "pack4(q1[0], q1[1], q1[2], q1[3]);\n}\n\n"
                  "// The thread's `rows` output rows of one output plane.",
                  "  if (q0[0] == 0x12345 && q1[1] == 0x54321) "
                  "*reinterpret_cast<uint32_t*>(dst) = q0[2] + q1[3];"
                  "\n}\n\n"
                  "// The thread's `rows` output rows of one output plane.")],
    "no_wb": [("qconv_grouped_int8.cu",
               "  uint32_t wb[S == 1 ? 9 : 1][4];\n",
               "  uint32_t wb[1][4];\n"),
              ("qconv_grouped_int8.cu",
               "      for (int k = 0; k < 4; ++k) th.wb[r][k] = "
               "th.wa[r][k] << 8;",
               "      for (int k = 0; k < 4 && r < 0; ++k) th.wb[r][k] = 0;"),
              ("qconv_grouped_int8.cu",
               "th.wb[3 * kd][k], s1);", "(th.wa[3 * kd][k] << 8), s1);"),
              ("qconv_grouped_int8.cu",
               "th.wb[3 * kd + 1][k], s1);",
               "(th.wa[3 * kd + 1][k] << 8), s1);"),
              ("qconv_grouped_int8.cu",
               "th.wb[3 * kd + 2][k], s1);",
               "(th.wa[3 * kd + 2][k] << 8), s1);")],
    "lb1halo": [("int8_wgmma.cuh",
                 "(PROD == A_HALO ? BN > 96 : BN >= 96) || MB > 1 ? 1 : 2)",
                 "BN >= 96 || MB > 1 ? 1 : 2)")],
    "lb2": [("qconv_grouped_int8.cu",
             "__global__ void __launch_bounds__(TILE_THREADS)\n"
             "    qconv_grouped_int8_requant_tile3d_kernel",
             "__global__ void __launch_bounds__(TILE_THREADS, 2)\n"
             "    qconv_grouped_int8_requant_tile3d_kernel")],
}

# (name, kind, x shape (b16, channels-last), O): R3D-18's stride-1 3x3x3
# convs (pad 1) and the depthwise 3x3x3 at stride 1 and (1, 2, 2)
SHAPES = [
    ("layer1", "halo", (16, 64, 16, 56, 56), 64, (1, 1, 1)),
    ("layer2", "halo", (16, 128, 8, 28, 28), 128, (1, 1, 1)),
    ("layer3", "halo", (16, 256, 4, 14, 14), 256, (1, 1, 1)),
    ("layer4", "halo", (16, 512, 2, 7, 7), 512, (1, 1, 1)),
    ("depthwise", "tile3d", (16, 64, 16, 56, 56), 64, (1, 1, 1)),
    # 2-D convs on the same producer (b256): SqueezeNet's fire2, fire5 and
    # fire6 expand3x3, ResNet-50's layer1 3x3
    ("fire2", "halo2d", (256, 16, 54, 54), 64, (1, 1)),
    ("fire5", "halo2d", (256, 32, 26, 26), 128, (1, 1)),
    ("fire6", "halo2d", (256, 48, 26, 26), 192, (1, 1)),
    ("resnet_l1", "halo2d", (256, 64, 56, 56), 64, (1, 1)),
    ("depthwise_s122", "tile3d", (16, 64, 16, 56, 56), 64, (1, 2, 2)),
    # the stems (NCHW graph inputs, 3 channels) as their space-to-depth
    # rewrite on the same producer: SqueezeNet's, ResNet-50's and
    # MobileNetV2's conv1 (b256), R3D-18's stem (b16); kernel and padding
    # in STEMS
    ("sq_conv1", "stem", (256, 3, 224, 224), 96, (2, 2)),
    ("rn_conv1", "stem", (256, 3, 224, 224), 64, (2, 2)),
    ("mb_conv1", "stem", (256, 3, 224, 224), 32, (2, 2)),
    ("r3d_stem", "stem", (16, 3, 16, 112, 112), 64, (1, 2, 2)),
    # SqueezeNet's conv1 as ORT's dynamic ConvInteger: uint8 x, the int32
    # epilogue, the zero point in device memory
    ("sq_conv1_int32", "stem", (256, 3, 224, 224), 96, (2, 2)),
]

# the stems' kernel and padding
STEMS = {"sq_conv1": ((7, 7), ((0, 0), (0, 0))),
         "rn_conv1": ((7, 7), ((3, 3), (3, 3))),
         "mb_conv1": ((3, 3), ((1, 1), (1, 1))),
         "r3d_stem": ((3, 7, 7), ((1, 1), (3, 3), (3, 3))),
         "sq_conv1_int32": ((7, 7), ((0, 0), (0, 0)))}


def build_variant(name: str) -> tuple:
    """Compile the two conv libraries with the variant's edits into
    build/conv3d_ablation/<name>/: (library name -> loaded CDLL, ptxas lines
    of the new forms' instances)."""
    src_dir = os.path.join(HERE, "build", "conv3d_ablation", name)
    os.makedirs(src_dir, exist_ok=True)
    files = {}
    for f in ("int8_wgmma.cuh", "int8_wgmma_mma.cuh", "qconv_int8.cu",
              "qconv_grouped_int8.cu"):
        with open(os.path.join(_build.CSRC_DIR, f)) as fh:
            files[f] = fh.read()
    for f, old, new in [e for part in name.split("+") for e in VARIANTS[part]]:
        if old not in files[f]:
            raise RuntimeError(f"variant {name}: edit target not found in {f}")
        files[f] = files[f].replace(old, new)
    for f, text in files.items():
        with open(os.path.join(src_dir, f), "w") as fh:
            fh.write(text)
    procs = {}
    t0 = time.perf_counter()
    for lib in ("qconv_int8", "qconv_grouped_int8"):
        so = os.path.join(src_dir, f"lib{lib}.so")
        procs[lib] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-o", so,
             os.path.join(src_dir, f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, []
    for lib, (so, proc) in procs.items():
        log, _ = proc.communicate()
        ptxas.append(f"build {lib}: {time.perf_counter() - t0:.1f} s")
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}/{lib}:\n{log}")
        libs[lib] = ctypes.CDLL(so)
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            # the halo instances (PROD 2) and the tile3d kernels
            if "entry function" in ln and ("ILi2ELi1E" in ln
                                           or "tile3d" in ln):
                ptxas.append(f"{lib} {ln.strip()[-70:]} | "
                             + " | ".join(x.strip() for x in lines[i + 1:i + 5]
                                          if "Used" in x or "spill" in x))
    return libs, ptxas


def operands(kind, xs, O, stride, rng, pad_value=0, stem=None):
    dev = torch.device("cuda")
    if kind == "stem":  # NCHW, as a graph input
        kernel, pad = STEMS[stem]
        x = torch.from_numpy(rng.integers(-128, 128, xs, np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (O, xs[1], *kernel),
                                          np.int8)).to(dev)
        mult = torch.full((O,), 1e-4, device=dev)
        bias = torch.zeros(O, dtype=torch.int32, device=dev)
        packed = k.pack_qconv_weight(w, stride)
        if stem.endswith("int32"):
            xu = x.view(torch.uint8)
            zp = torch.tensor([117], dtype=torch.int32, device=dev)
            return lambda: k.qconv_int8(xu, w, stride=stride, padding=pad,
                                        pad_value=zp, packed=packed)
        return lambda: k.qconv_int8_requant(x, w, mult, bias, stride=stride,
                                            padding=pad, packed=packed)
    x = torch.from_numpy(rng.integers(-128, 128, xs, np.int8)).to(
        dev).contiguous(memory_format=torch.channels_last_3d if len(xs) == 5
                        else torch.channels_last)
    pad = ((1, 1),) * (len(xs) - 2)
    mult = torch.full((O,), 1e-4, device=dev)
    bias = torch.zeros(O, dtype=torch.int32, device=dev)
    if kind.startswith("halo"):
        w = torch.from_numpy(rng.integers(-127, 128, (O, xs[1], 3, 3, 3)[
            :len(xs)], np.int8)).to(dev)
        packed = k.pack_qconv_weight(w)
        return lambda: k.qconv_int8_requant(x, w, mult, bias, padding=pad,
                                            packed=packed)
    w = torch.from_numpy(rng.integers(-127, 128, (O, 1, 3, 3, 3),
                                      np.int8)).to(dev)
    packed = g8.pack_qconv_grouped_weight(w)
    return lambda: g8.qconv_grouped_int8_requant(
        x, w, mult, bias, stride=stride, padding=pad, pad_value=pad_value,
        packed=packed)


def parse_tile(t: str) -> q8.Int8Tile:
    resident = t.endswith("r")
    bm, bn, stages = map(int, t.rstrip("r").split("x"))
    return q8.Int8Tile(bm, bn, stages, resident)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "conv3d_ablation.jsonl"))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--tiles", default="",
                    help="extra tiles for the full halo kernel, e.g. "
                         "'128x64x4,128x128x3' (BMxBNxSTAGES[r])")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape names (default: all)")
    ap.add_argument("--dw-pad", type=int, default=0,
                    help="the depthwise convs' pad byte (x's zero point; "
                         "not 0: border boxes are filled with it)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    names = args.variants.split(",")
    built = {}
    for n in names:
        built[n], ptxas = build_variant(n)
        for ln in ptxas:
            print(f"ptxas {n}: {ln}", flush=True)
    extra = [parse_tile(t) for t in args.tiles.split(",") if t]
    rng = np.random.default_rng(0)
    real_plan = k.conv_plan
    with open(args.out, "w") as out:
        for sname, kind, xs, O, stride in SHAPES:
            if args.shapes and sname not in args.shapes.split(","):
                continue
            call = operands(kind, xs, O, stride, rng, args.dw_pad, sname)
            picked = (k.conv_plan(xs, (O, xs[1], 3, 3, 3)[:len(xs)], stride,
                                  ((1, 1),) * (len(xs) - 2))[1]
                      if kind.startswith("halo") else None)
            layout_ms = None
            if kind == "stem":  # the plan of its rewrite; its layout alone
                kernel, pad = STEMS[sname]
                picked = k.conv_plan(xs, (O, xs[1], *kernel), stride, pad,
                                     None, "int32" if sname.endswith("int32")
                                     else "requant")[1]
                geo = k.s2d_conv(xs, (O, xs[1], *kernel), stride, pad)
                xt = torch.zeros(xs, dtype=torch.int8, device="cuda")
                layout_ms = graph_ms(lambda: k.space_to_depth(xt, geo),
                                     args.iters)
                del xt
            if kind == "halo2d":  # on the halo whatever conv_plan's rule
                picked = k.halo_plan(xs[1], O, (3, 3), xs[2:],
                                     xs[0])["tile"]
            runs = [(n, picked) for n in names]
            runs += [("full", t) for t in extra
                     if kind.startswith(("halo", "stem")) and t != picked]
            for variant, tile in runs:
                _build._LOADED.update(built[variant])
                if tile is not None:
                    k.conv_plan = lambda *a, t=tile: ("halo", t)
                try:
                    ms = graph_ms(call, args.iters)
                    err = None
                except RuntimeError as e:  # a tile the kernel refuses
                    ms, err = None, str(e)[-120:]
                finally:
                    k.conv_plan = real_plan
                line = {"shape": sname, "kind": kind, "x": list(xs), "O": O,
                        "stride": list(stride), "variant": variant,
                        "dw_pad": args.dw_pad if kind == "tile3d" else None,
                        "tile": list(tile) if tile else None,
                        "picked": tile == picked, "ms": ms, "error": err,
                        "layout_ms": layout_ms, "card": smi}
                print(json.dumps(line), flush=True)
                out.write(json.dumps(line) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

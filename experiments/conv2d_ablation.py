#!/usr/bin/env python3
"""Per-conv device times of the group-1 int8 conv kernel on the 2-D CNNs'
INT8 paths, on one CUDA card.

    python3 experiments/conv2d_ablation.py [--root DIR] [--label NAME]
        [--paths squeezenet_int8,...] [--out build/conv2d_ablation.jsonl]
        [--gather] [--check]

Builds each path's INT8 graph through the package's own entry points
(weights from seed 0, inputs `default_rng(0)`, calibration minmax on
x[:8]), records the kernel wrapper calls of one eager forward on the card
(`chip_smoke._recorded_kernel_calls`), and times each
`qconv_int8_requant` / `qconv_int8` call on its own operands (device ms
from a replayed CUDA graph, `chip_smoke.graph_ms`) beside its bound
(`chip_smoke.bound`: 2 x MACs at 1,979 int8 TOP/s, each input read and the
output written once at 3.35 TB/s).

Paths (b256 at 224 x 224 unless named):
  squeezenet_int8     the port's static INT8 (quant.quantize_graph)
  squeezenet_quint8   ONNX Runtime's QOperator QUInt8
                      (tests/torch_port_qoperator.py)
  squeezenet_qint8    its QInt8 twin
  squeezenet_dynamic  ORT's dynamic form: ConvInteger, uint8 x, the zero
                      point computed at run time (tests/torch_port_dynamic.py)
  resnet50_int8       ResNet-50's group-1 convs, static INT8
  mobilenetv2_int8    MobileNetV2's group-1 convs, static INT8 (its 17
                      depthwise convs run on the grouped kernel, untimed)
  unet_int8           UNetConfig() at b32, 256 x 256, static INT8
  r3d18_int8          R3D-18 at b16 clips of 3 x 16 x 112 x 112, static INT8
                      (the 3-D form of the same producers, for comparison)

`--root DIR` imports the package from another checkout (e.g. the parent
unpacked by `git archive` into build/parent), so that two trees are
measured in one chip call, one process each. A stem (a tree with
`qconv_int8.s2d_conv`) also gets `layout_ms`, its space-to-depth layout
pass alone. `--gather` also times every
conv its tree's plan gives the staged-halo producer on the gather (the
plan forced, the same operands; a stem as its rewrite, at 16-byte runs),
`--check` holds each call's output on the
first 2 images to the plain version (bit for bit), `--halo` times on the
staged-halo producer every conv it can take that the plan's fallback rule
leaves on the gather (`halo_ms`), `--halo-bn` and
`--halo-planes` give the staged-halo producer's tiles one BN and one
patch count. Prints the card's name
and power limit, then one JSON line per conv call and one per path with
the sums by producer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PATHS = ("squeezenet_int8", "squeezenet_quint8", "squeezenet_qint8",
         "squeezenet_dynamic", "resnet50_int8", "mobilenetv2_int8",
         "unet_int8", "r3d18_int8")
BATCH, UNET_BATCH, UNET_SIZE, CALIB, CHECK = 256, 32, 256, 8, 2


def _graph(P, path: str):
    """(the path's INT8 graph, its input name, the input x)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    rng = np.random.default_rng(0)
    if path.startswith("r3d18"):
        from torch_port_video import R3D_CLIP, R3D_INPUT, build_r3d18
        g, inp = P.import_model(build_r3d18()), R3D_INPUT
        x = rng.standard_normal((16, *R3D_CLIP)).astype(np.float32)
        return (P.quantize_graph(g, ranges=P.calibrate(g, [{inp: x[:2]}])),
                inp, x)
    if path.startswith("unet"):
        from onnx_rusty_inference_engine_tpu_torch.models.unet import (
            UNetConfig, build_unet)
        g = P.import_model(build_unet(UNetConfig(), batch=UNET_BATCH,
                                      size=UNET_SIZE))
        inp, shape = "image", (UNET_BATCH, 3, UNET_SIZE, UNET_SIZE)
    elif path.startswith("resnet50"):
        g, inp = P.import_model(P.build_resnet50()), "data"
        shape = (BATCH, 3, 224, 224)
    elif path.startswith("mobilenetv2"):
        g, inp = P.import_model(P.build_mobilenetv2()), "input"
        shape = (BATCH, 3, 224, 224)
    else:
        g, inp = P.import_model(P.build_squeezenet()), "data_0"
        shape = (BATCH, 3, 224, 224)
    x = rng.standard_normal(shape).astype(np.float32)
    if path == "squeezenet_dynamic":
        from torch_port_dynamic import dynamic_bytes, reparsed
        return reparsed(dynamic_bytes(g)), inp, x
    ranges = P.calibrate(g, [{inp: x[:CALIB]}])
    if path in ("squeezenet_quint8", "squeezenet_qint8"):
        from torch_port_qoperator import qoperator_graph, reparsed
        return (reparsed(qoperator_graph(g, ranges, path[-5:].lstrip("q"))),
                inp, x)
    return P.quantize_graph(g, ranges=ranges), inp, x


def _plan(k, name, args, kw):
    x, w = args[0], args[1]
    sp = x.dim() - 2
    return k.conv_plan(x.shape, w.shape, kw.get("stride") or (1,) * sp,
                       kw.get("padding") or ((0, 0),) * sp,
                       kw.get("dilation"),
                       "int32" if name == "qconv_int8" else "requant")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose package is measured")
    ap.add_argument("--label", default="")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "conv2d_ablation.jsonl"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--gather", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--halo", action="store_true",
                    help="also time on the staged-halo producer every conv "
                         "it can take that the plan leaves on the gather")
    ap.add_argument("--halo-bn", type=int, default=0,
                    help="the staged-halo producer's one BN (64, 96, 128)")
    ap.add_argument("--halo-planes", type=int, default=0,
                    help="the staged-halo producer's one patch count (2, 4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)  # chip_smoke's helpers, from this checkout
    from chip_smoke import (INT8_OPS_PER_S, _qop_kernel_work,  # noqa: E402
                            _recorded_kernel_calls, _wrapper_and_plain, bound,
                            graph_ms, nvidia_smi)
    sys.path.insert(0, root)  # the package, from the measured checkout
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        _build, qconv_int8 as k, qmatmul_int8 as q8)

    if not P.__file__.startswith(root):
        raise SystemExit(f"the package came from {P.__file__}, not {root}")
    if args.halo_bn:
        k.HALO_BN = (args.halo_bn, args.halo_bn)
    if args.halo_planes:
        k.HALO_PLANES = (args.halo_planes,)
    label = args.label or os.path.basename(root)
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all(["qconv_int8", "qconv_grouped_int8", "qmatmul_int8"])
    print(json.dumps({"label": label, "build_s": time.perf_counter() - t0}),
          flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    real_plan = k.conv_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(args.out, "a") as out:
        def emit(line):
            line = {"label": label, **line, "card": smi}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")

        for path in args.paths.split(","):
            graph, inp, x = _graph(P, path)
            eng = P.Engine(graph)
            dev = {inp: torch.as_tensor(x, device="cuda")}
            calls = []
            with torch.no_grad(), _recorded_kernel_calls(calls):
                eng.forward(dev)
            torch.cuda.synchronize()
            sums = {}
            for i, (name, cargs, kw, y) in enumerate(calls):
                if name not in ("qconv_int8_requant", "qconv_int8"):
                    continue
                kern, plain = _wrapper_and_plain(name)
                producer, tile = _plan(k, name, cargs, kw)
                ms = graph_ms(lambda: kern(*cargs, **kw), args.iters, 2)
                ops, nbytes = _qop_kernel_work(name, cargs, kw, y)
                bound_ms, bound_by, _, _ = bound(ops, nbytes, INT8_OPS_PER_S)
                line = {"path": path, "call": i, "wrapper": name,
                        "x": list(cargs[0].shape), "w": list(cargs[1].shape),
                        "x_dtype": str(cargs[0].dtype),
                        "stride": list(kw.get("stride") or ()),
                        "padding": [list(p) for p in kw.get("padding") or ()],
                        "device_zp": isinstance(kw.get("pad_value"),
                                                torch.Tensor),
                        "producer": producer, "tile": list(tile), "ms": ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
                geo = (k.s2d_conv(cargs[0].shape, cargs[1].shape,
                                  kw.get("stride") or (1,) * (y.dim() - 2),
                                  kw.get("padding")
                                  or ((0, 0),) * (y.dim() - 2),
                                  kw.get("dilation"))
                       if hasattr(k, "s2d_conv") else None)
                if geo is not None:
                    # a stem: its space-to-depth layout pass alone (the
                    # wrapper's ms includes it)
                    line["layout_ms"] = graph_ms(
                        lambda: k.space_to_depth(cargs[0], geo,
                                                 kw.get("pad_value", 0)),
                        args.iters, 2)
                if args.gather and producer == "halo":
                    # the same conv (a stem: its rewrite) on the gather
                    ws = cargs[1].shape if geo is None else geo["w"]
                    M, K = y.numel() // ws[0], -(-int(np.prod(
                        ws[2:])) * k.conv_channels(ws[1]) // 16) * 16
                    if len(ws) == 5:  # the instances with the 3-D form
                        bn = next((b for b in k.TILE_3D_BN if b >= ws[0]),
                                  k.TILE_3D_BN[-1])
                        gtile = q8.int8_tile(M, ws[0], K, bms=k.TILE_3D_BM,
                                             bns=(bn,))
                    else:
                        gtile = q8.int8_tile(M, ws[0], K)
                    k.conv_plan = lambda *a, t=gtile: ("gather", t)
                    try:
                        line["gather_ms"] = graph_ms(
                            lambda: kern(*cargs, **kw), args.iters, 2)
                    finally:
                        k.conv_plan = real_plan
                if (args.halo and producer == "gather"
                        and k._halo_ok(k.conv_channels(cargs[1].shape[1]),
                                       tuple(cargs[1].shape[2:]),
                                       kw.get("stride") or (1, 1),
                                       kw.get("dilation"))):
                    ws = cargs[1].shape
                    htile = k.halo_plan(k.conv_channels(ws[1]), ws[0],
                                        tuple(ws[2:]), tuple(y.shape[2:]),
                                        y.shape[0])["tile"]
                    k.conv_plan = lambda *a, t=htile: ("halo", t)
                    try:
                        line["halo_ms"] = graph_ms(
                            lambda: kern(*cargs, **kw), args.iters, 2)
                    finally:
                        k.conv_plan = real_plan
                if args.check:
                    pkw = {a: v for a, v in kw.items() if a != "packed"}
                    head = (cargs[0][:CHECK],) + tuple(cargs[1:])
                    line["equal_plain"] = bool(torch.equal(
                        y[:CHECK], plain(*head, **pkw)))
                emit(line)
                s = sums.setdefault(producer, {"calls": 0, "ms": 0.0,
                                               "bound_ms": 0.0})
                s["calls"] += 1
                s["ms"] += ms
                s["bound_ms"] += bound_ms
            emit({"path": path, "by_producer": sums,
                  "ms": sum(s["ms"] for s in sums.values()),
                  "bound_ms": sum(s["bound_ms"] for s in sums.values())})
            del eng, calls
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

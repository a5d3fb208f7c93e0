#!/usr/bin/env python3
"""Drive the PyTorch port (onnx_rusty_inference_engine_tpu_torch) on one
NVIDIA H100 and check what comes out.

    python3 chip_smoke.py      # from the root of a checkout, one CUDA card

Phases, each printing one JSON line:

1. device  - the card (name and power limit as nvidia-smi prints them);
             TF32 is off for every comparison (cudnn and matmul flags,
             scoped to this script's run).
2. build   - compiles every kernel from csrc/ with nvcc for sm_90a.
3. slice   - the main path through the port's entry points: SqueezeNet 1.0
             at 224x224 (random weights from seed 0); golden check at b1
             against tests/goldens/squeezenet.pb; fp32 Engine at b256;
             calibrate on x[:8]; quantize_graph; INT8 Engine at b256. The
             kernels' launch counts are set to 0 just before and read just
             after; every QLinearConv must launch the int8 kernel (26 per
             INT8 forward). The card's INT8 intermediates are held against
             the plain versions run on the CPU for the first 8 images.
             fp32 and INT8 images/s from CUDA events over warmed,
             device-resident runs.
4. kernel  - one line per distinct QLinearConv shape of that run: the
             kernel against its plain version on the same (real) inputs on
             the card, bit for bit; kernel, plain and library times and the
             card's bound for the same work.
5. profile - where one fp32 and one INT8 forward spend device time, by
             kernel, from torch.profiler (device busy share of the wall
             time under the profiler).
6. kernels - one line listing every ported kernel.

Then the nvidia-smi line again and, last, {"ok": true, "device": ...}. Any
failed check raises: the script exits non-zero and prints no last line. It
fails the same way without a CUDA device, or when the package is not beside
it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "onnx_rusty_inference_engine_tpu_torch"

BATCH = 256
CALIB = 8          # calibration images, as bench.py calibrates on x[:8]
CPU_CHECK = 8      # images re-run through the plain versions on the CPU
WARMUP, ITERS = 3, 20

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12

KERNEL_ROWS = {  # name -> (source, TPU kernel it replaces)
    "qconv_int8_requant": (
        f"{PKG}/csrc/qconv_int8.cu",
        "onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py:102"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms per call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def phase_device() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build() -> None:
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    regs = {name: [ln.strip() for ln in info.log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, info in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": sorted(built), "ptxas": regs})


def _squeezenet_golden_input() -> np.ndarray:
    """The b1 input tests/test_regression_goldens.py::_cases draws for its
    squeezenet case: default_rng(123) after three earlier draws."""
    rng = np.random.default_rng(123)
    rng.standard_normal((1, 3, 64, 64))
    rng.standard_normal((1, 3, 96, 96))
    rng.integers(0, 128, (1, 8))
    return rng.standard_normal((1, 3, 224, 224)).astype(np.float32)


def phase_slice():
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch import onnx_io
    from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels.qconv_int8 import (
        qconv_int8_requant)
    from onnx_rusty_inference_engine_tpu_torch.utils.timing import (
        engine_throughput)

    graph = P.import_model(P.build_squeezenet())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 3, 224, 224)).astype(np.float32)
    feed = {"data_0": x}

    qconv_int8_requant.launches = 0
    t0 = time.perf_counter()
    # golden at b1
    golden = onnx_io.read_tensor_file(
        os.path.join(HERE, "tests", "goldens", "squeezenet.pb")).array
    eng = P.Engine(graph)
    got = eng.run({"data_0": _squeezenet_golden_input()})["softmaxout_1"]
    golden_err = float(np.abs(got - golden).max())
    require(got.shape == golden.shape and np.allclose(got, golden, rtol=1e-3,
                                                      atol=1e-3),
            f"fp32 b1 golden (max abs err {golden_err})")

    # fp32 at b256
    y32 = eng(feed)["softmaxout_1"]
    require(tuple(y32.shape) == (BATCH, 1000, 1, 1)
            and bool(torch.isfinite(y32).all()), "fp32 b256 output")
    require(bool(torch.allclose(y32.sum(dim=1), torch.ones_like(
        y32.sum(dim=1)), atol=1e-4)), "fp32 softmax rows sum to 1")
    fp32_ips = engine_throughput(eng, feed, iters=ITERS, warmup=WARMUP)

    # quantize and run INT8 at b256
    ranges = P.calibrate(graph, [{"data_0": x[:CALIB]}])
    qgraph = P.quantize_graph(graph, ranges=ranges)
    n_qconv = sum(n.op_type == "QLinearConv" for n in qgraph.nodes)
    require(n_qconv == 26, f"26 QLinearConv nodes in INT8 SqueezeNet, got "
            f"{n_qconv}")
    eng8 = P.Engine(qgraph)
    y8 = eng8(feed)["softmaxout_1"]
    torch.cuda.synchronize()
    require(qconv_int8_requant.launches == n_qconv,
            f"one kernel launch per QLinearConv ({qconv_int8_requant.launches}"
            f" for {n_qconv})")
    require(tuple(y8.shape) == (BATCH, 1000, 1, 1)
            and bool(torch.isfinite(y8).all()), "INT8 b256 output")
    int8_ips = engine_throughput(eng8, feed, iters=ITERS, warmup=WARMUP)
    int8_forwards = 1 + WARMUP + ITERS
    launches = qconv_int8_requant.launches
    main_path_s = time.perf_counter() - t0
    require(launches == n_qconv * int8_forwards,
            f"{launches} launches for {int8_forwards} INT8 forwards")

    # every intermediate of the INT8 graph, on the card at b256 and through
    # the plain versions on the CPU for the first CPU_CHECK images
    probe = probe_graph(qgraph)
    with torch.no_grad():
        card = P.lower(probe, "cuda", eng8.packed)(
            eng8.params, {"data_0": torch.as_tensor(x, device="cuda")})
        host = P.Engine(probe, device="cpu")(
            {"data_0": x[:CPU_CHECK]})
    n_eq = n_all = 0
    worst = 0
    for name, v in host.items():
        if v.dtype != torch.int8:
            continue
        c = card[name][:CPU_CHECK].cpu()
        n_eq += int((c == v).sum())
        n_all += v.numel()
        worst = max(worst, int((c.int() - v.int()).abs().max()))
    out_err = float((card["softmaxout_1"][:CPU_CHECK].cpu()
                     - host["softmaxout_1"]).abs().max())
    frac = n_eq / n_all
    require(frac > 0.99, f"card vs plain INT8 intermediates: {frac} equal")
    require(out_err <= 1e-3, f"card vs plain INT8 softmax: {out_err}")
    top1_agree = float((y8.reshape(BATCH, -1).argmax(1)
                        == y32.reshape(BATCH, -1).argmax(1)).float().mean())
    emit({"phase": "slice", "model": "squeezenet1.0 224x224", "batch": BATCH,
          "golden_b1_max_abs_err": golden_err,
          "fp32_images_per_s": fp32_ips, "int8_images_per_s": int8_ips,
          "int8_over_fp32": int8_ips / fp32_ips,
          "qlinearconv_nodes": n_qconv, "int8_forwards": int8_forwards,
          "qconv_launches": launches,
          "launches_per_int8_forward": launches / int8_forwards,
          "int8_vs_plain_equal_fraction": frac,
          "int8_vs_plain_max_lsb": worst,
          "int8_vs_plain_softmax_max_abs_err": out_err,
          "int8_vs_fp32_top1_agreement": top1_agree,
          "main_path_seconds": main_path_s})
    return eng, qgraph, eng8, card, launches, feed


# device kernel name fragment -> bucket, first match wins
_BUCKETS = (("qconv_int8_requant", "qconv_int8_requant (int8 conv)"),
            ("max_pool", "max-pool"), ("CatArray", "concat"),
            ("cat_", "concat"), ("softmax", "softmax"),
            ("reduce", "reductions (GlobalAveragePool)"),
            ("conv", "fp32 conv (cuDNN)"), ("gemm", "fp32 conv (cuDNN)"),
            ("sm90", "fp32 conv (cuDNN)"), ("xmma", "fp32 conv (cuDNN)"),
            ("elementwise", "elementwise / copies"),
            ("copy", "elementwise / copies"))


def phase_profile(eng, eng8, feed, reps: int = 3) -> None:
    from torch.profiler import ProfilerActivity, profile

    dev_feed = {k: torch.as_tensor(v, device="cuda") for k, v in feed.items()}
    for name, e in (("fp32", eng), ("int8", eng8)):
        with torch.no_grad():
            e._fn(e.params, dev_feed)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    e._fn(e.params, dev_feed)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = {}
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / reps
        buckets = {}
        for kname, ms in kernels.items():
            b = next((label for frag, label in _BUCKETS
                      if frag in kname), "other")
            buckets[b] = buckets.get(b, 0.0) + ms
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        emit({"phase": "profile", "engine": name, "batch": BATCH,
              "wall_ms_per_forward_profiled": wall_ms,
              "device_busy_ms_per_forward": busy,
              "device_idle_share": (1 - busy / wall_ms) if busy else None,
              "buckets_ms": dict(sorted(buckets.items(),
                                        key=lambda kv: -kv[1])),
              "top_kernels_ms": [[k[:90], v] for k, v in top]})


def _conv_work(x, w, stride, padding):
    """(operations, bytes) the conv needs: 2 * MACs over in-bounds taps,
    each input read once and the int8 output written once."""
    B, C, H, W = x.shape
    O, _, KH, KW = w.shape
    (pt, pb), (pl, pr) = padding
    OH = (H + pt + pb - KH) // stride[0] + 1
    OW = (W + pl + pr - KW) // stride[1] + 1

    def taps(n_out, k, s, lo, size):
        return sum(1 for o in range(n_out) for t in range(k)
                   if 0 <= o * s - lo + t < size)

    macs = (B * O * C * taps(OH, KH, stride[0], pt, H)
            * taps(OW, KW, stride[1], pl, W))
    nbytes = x.numel() + w.numel() + 4 * O + 4 * O + B * O * OH * OW
    return 2 * macs, nbytes


def phase_kernels(qgraph, eng8, card, launches: int, smi: str) -> None:
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels.qconv_int8 import (
        qconv_int8_requant, qconv_int8_requant_plain)
    from onnx_rusty_inference_engine_tpu_torch.ops.standard import (
        _conv_padding)

    params = eng8.params

    def const(name):
        v = params.get(name)
        return v if v is not None else torch.as_tensor(
            np.asarray(qgraph.constants[name]), device="cuda")

    shapes = {}
    for node in qgraph.nodes:
        if node.op_type != "QLinearConv":
            continue
        x = card[node.inputs[0]]
        w = params[node.inputs[3]]
        stride = tuple(int(s) for s in node.attr("strides", [1, 1]))
        padding = tuple(tuple(p) for p in _conv_padding(
            node, x.shape[2:], w.shape[2:], stride, (1, 1)))
        key = (tuple(x.shape), tuple(w.shape), stride, padding)
        if key in shapes:
            shapes[key]["count"] += 1
            continue
        mult = (const(node.inputs[1]).float() * const(node.inputs[4]).float()
                / const(node.inputs[6]).float())
        bias = params.get(node.inputs[8]) if len(node.inputs) > 8 else None
        shapes[key] = {"node": node.name or node.outputs[0], "count": 1,
                       "x": x, "w": w, "mult": mult, "bias": bias,
                       "stride": stride, "padding": padding,
                       "packed": eng8.packed[node.inputs[3]]}

    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
           "bytes_ms": 0.0}
    max_err = 0
    for (xs, ws, stride, padding), s in shapes.items():
        x, w, mult, bias = s["x"], s["w"], s["mult"], s["bias"]

        def kern():
            return qconv_int8_requant(x, w, mult, bias, stride=stride,
                                      padding=padding, packed=s["packed"])

        def plain():
            return qconv_int8_requant_plain(x, w, mult, bias, stride=stride,
                                            padding=padding)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        require(torch.equal(got, want), f"kernel == plain at {s['node']} "
                f"x{xs} w{ws} (max |diff| {err})")
        ms = cuda_ms(kern, ITERS)
        plain_ms = cuda_ms(plain, 3)
        library_ms = None
        if ws[2:] == (1, 1) and stride == (1, 1) and not any(
                sum(padding, ())):
            # one PyTorch call with the same contraction (int32 out, no
            # epilogue), on the same data already channels-last
            a = x.permute(0, 2, 3, 1).reshape(-1, xs[1]).contiguous()
            b = w.reshape(ws[0], ws[1]).contiguous()
            library_ms = cuda_ms(lambda: torch._int_mm(a, b.t()), ITERS)
        ops, nbytes = _conv_work(x, w, stride, padding)
        ops_ms = ops / INT8_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        emit({"phase": "kernel", "kernel": "qconv_int8_requant",
              "node": s["node"], "x": list(xs), "w": list(ws),
              "stride": list(stride), "padding": [list(p) for p in padding],
              "count_per_forward": s["count"], "equal": True,
              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
              "ops": ops, "bytes": nbytes, "tops": ops / ms / 1e9})
        n = s["count"]
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["bound_ms"] += n * bound_ms
        tot["ops_ms"] += n * ops_ms
        tot["bytes_ms"] += n * bytes_ms

    require(launches > 0, "qconv_int8_requant launched on the main path")
    source, replaces = KERNEL_ROWS["qconv_int8_requant"]
    emit({"kernels": [{
        "name": "qconv_int8_requant", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                     else "bytes"),
        "library_ms": None,
        "per": "one INT8 SqueezeNet 1.0 forward at b256: the sum over its "
               "26 QLinearConvs (library_ms: no PyTorch call computes an "
               "int8 kxk conv; the 1x1 shapes carry torch._int_mm times)",
        "distinct_shapes": len(shapes), "card": smi}]})


def main() -> int:
    require(torch.cuda.is_available(),
            "a CUDA device (torch.cuda.is_available() is false)")
    require(os.path.isdir(os.path.join(HERE, PKG)),
            f"the package {PKG}/ beside this script")
    sys.path.insert(0, HERE)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            smi = phase_device()
            phase_build()
            eng, qgraph, eng8, card, launches, feed = phase_slice()
            phase_profile(eng, eng8, feed)
            phase_kernels(qgraph, eng8, card, launches, smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

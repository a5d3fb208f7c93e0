"""One-node cases of every op the port's op library took over from the JAX
package's ops/standard.py, ops/extra.py, ops/contrib_transformers.py,
ops/core_attention.py, ops/bounded.py, ops/losses.py, ops/vision_roi.py
and ops/ml.py (numeric labels only: string labels run on the host): the
op, its inputs (graph inputs, and initializers
for what must be known before the run), its attributes and the tolerance a
float output is held to (None: exact, as integer, boolean and index
outputs always are).

`model(case, io)` builds the case's ONNX model with either package's
onnx_io. It imports neither package itself, so the CPU tests (against the
JAX emitters) and chip_smoke.py (the card against the port's CPU run) use
the same table.

CASES holds the cases both packages run the same way; ATTENTION_CASES
the contrib and core attention ops; SPEC_CASES the ones where the JAX
emitter breaks the ONNX spec and the port follows it, each with a numpy
reference of the spec (`SPEC_REFS`); RANDOM_CASES the random ops, held
to their seed contract and their moments rather than to JAX's values.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

F32 = (1e-5, 1e-6)     # elementwise and short reductions
F32_SUM = (1e-5, 1e-5)  # products and sums over tens of terms
FFT = (1e-4, 1e-4)     # transforms (another summation order)


class Case(NamedTuple):
    id: str
    op: str
    ins: List[str]
    feeds: Dict[str, np.ndarray]
    inits: Dict[str, np.ndarray]
    attrs: dict
    opset: int
    n_out: int
    domain: str
    tol: Optional[Tuple[float, float]]


def _rng(cid: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(cid.encode()))


def case(cid, op, feeds=None, inits=None, ins=None, opset=13, n_out=1,
         domain="", tol=F32, **attrs) -> Case:
    feeds = dict(feeds or {})
    inits = dict(inits or {})
    if ins is None:
        ins = list(feeds) + list(inits)
    return Case(cid, op, list(ins), feeds, inits, attrs, opset, n_out,
                domain, tol)


def _attr(io, name, value):
    a = io.Attribute(name=name)
    if isinstance(value, float):
        a.f = value
    elif isinstance(value, (bool, int)):
        a.i = int(value)
    elif isinstance(value, str):
        a.s = value.encode()
    elif isinstance(value, np.ndarray):
        a.t = io.TensorData(name="", array=value)
    elif all(isinstance(v, int) for v in value):
        a.ints = list(value)
    elif all(isinstance(v, float) for v in value):
        a.floats = list(value)
    else:
        a.strings = [v.encode() for v in value]
    return a


def model(c: Case, io):
    """The case as a ModelProto of `io` (either package's onnx_io)."""
    outs = [f"out{i}" for i in range(c.n_out)]
    n = io.NodeProto(op_type=c.op, input=list(c.ins), output=outs,
                     domain=c.domain,
                     attributes={k: _attr(io, k, v)
                                 for k, v in c.attrs.items()})
    g = io.GraphProto(name="t")
    g.nodes = [n]
    g.initializers = dict(c.inits)
    for name, arr in c.feeds.items():
        g.inputs.append(io.ValueInfo(
            name=name, elem_type=io.NUMPY_TO_DTYPE[arr.dtype],
            shape=list(arr.shape)))
    for name in outs:
        g.outputs.append(io.ValueInfo(name=name))
    return io.ModelProto(graph=g, opset_version=c.opset)


def _f(r, *shape, lo=None, hi=None, scale=1.0):
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _i64(*v):
    return np.array(v, np.int64)


# ---------------------------------------------------------------------------
# ops/standard.py
# ---------------------------------------------------------------------------
def _standard() -> List[Case]:
    out = []
    r = _rng("standard")
    x = _f(r, 2, 3, 4)
    pos = _f(r, 2, 3, 4, lo=0.1, hi=3.0)
    for op, inp in (("Ceil", x), ("Cos", x), ("Sin", x), ("Exp", x),
                    ("Log", pos), ("Sqrt", pos), ("Reciprocal", pos),
                    ("Sign", np.round(x)), ("Erf", x), ("Softplus", x * 4),
                    ("Softsign", x), ("HardSwish", x * 4), ("Mish", x * 3)):
        out.append(case(op, op, {"x": inp}))
    special = np.array([1.0, np.nan, np.inf, -np.inf, -2.0, 0.0], np.float32)
    out.append(case("IsNaN", "IsNaN", {"x": special}, tol=None))
    for pos_, neg_ in ((1, 1), (1, 0), (0, 1), (0, 0)):
        out.append(case(f"IsInf_p{pos_}n{neg_}", "IsInf", {"x": special},
                        opset=20, tol=None, detect_positive=pos_,
                        detect_negative=neg_))
    out.append(case("Not", "Not", {"x": r.random((3, 4)) > 0.5}, tol=None))
    out.append(case("LeakyRelu", "LeakyRelu", {"x": x}, alpha=0.3))
    out.append(case("Elu", "Elu", {"x": x}, alpha=0.7))
    out.append(case("Selu", "Selu", {"x": x}))
    out.append(case("HardSigmoid", "HardSigmoid", {"x": x * 3}, alpha=0.3,
                    beta=0.4))
    out.append(case("Celu", "Celu", {"x": x}, opset=12, alpha=1.5))
    out.append(case("ThresholdedRelu", "ThresholdedRelu", {"x": x},
                    alpha=0.4))
    out.append(case("Shrink", "Shrink", {"x": x}, lambd=0.3, bias=0.1))
    out.append(case("PRelu", "PRelu", {"x": _f(r, 2, 3, 4, 5)},
                    {"slope": _f(r, 3, 1, 1, lo=0.1, hi=0.5)}))
    a = r.integers(-20, 20, (3, 5)).astype(np.int32)
    b = r.integers(1, 7, (3, 5)).astype(np.int32) * np.where(
        r.random((3, 5)) > 0.5, 1, -1).astype(np.int32)
    out.append(case("Mod_int", "Mod", {"a": a, "b": b}, tol=None))
    out.append(case("Mod_int_fmod", "Mod", {"a": a, "b": b}, tol=None,
                    fmod=1))
    out.append(case("Mod_float_fmod", "Mod", {"a": x * 5, "b": pos},
                    fmod=1))
    u8 = r.integers(0, 256, (3, 4)).astype(np.uint8)
    sh = r.integers(0, 8, (3, 4)).astype(np.uint8)
    out.append(case("BitShift_left", "BitShift", {"x": u8, "y": sh},
                    opset=11, tol=None, direction="LEFT"))
    out.append(case("BitShift_right", "BitShift", {"x": u8, "y": sh},
                    opset=11, tol=None, direction="RIGHT"))
    three = {"a": x, "b": _f(r, 3, 4), "c": _f(r, 1, 4)}
    out.append(case("Sum", "Sum", three))
    out.append(case("Max", "Max", three))
    out.append(case("Min", "Min", three))
    out.append(case("Mean", "Mean", three))
    out.append(case("CastLike", "CastLike",
                    {"a": x * 10, "b": np.zeros((1,), np.int32)},
                    opset=15, tol=None))
    out.append(case("LogSoftmax", "LogSoftmax", {"x": x}, axis=1))
    out.append(case("LogSoftmax_opset11", "LogSoftmax", {"x": x},
                    opset=11, axis=1))
    out.append(case("Hardmax", "Hardmax", {"x": np.round(x * 2)},
                    tol=None))

    # reductions: axes as the attribute, as an input, and none
    xr = _f(r, 3, 4, 5, lo=0.5, hi=1.5)
    for op in ("ReduceMean", "ReduceSum", "ReduceMin", "ReduceProd",
               "ReduceL1", "ReduceL2", "ReduceLogSum", "ReduceLogSumExp",
               "ReduceSumSquare"):
        tol = F32_SUM
        if op == "ReduceSum":
            out.append(case(f"{op}_attr", op, {"x": xr}, opset=11,
                            tol=tol, axes=[1]))
        else:
            out.append(case(f"{op}_attr", op, {"x": xr}, tol=tol,
                            axes=[0, 2], keepdims=0))
        out.append(case(f"{op}_input", op, {"x": xr},
                        {"axes": _i64(-1)}, opset=18, tol=tol))
        out.append(case(f"{op}_all", op, {"x": xr}, opset=18, tol=tol,
                        keepdims=0))
    out.append(case("ReduceMean_noop", "ReduceMean", {"x": xr}, opset=18,
                    tol=None, noop_with_empty_axes=1))
    ties = np.array([[3, 1, 3, 0], [2, 2, 1, 2], [0, 5, 5, 5]], np.float32)
    for op in ("ArgMax", "ArgMin"):
        for last in (0, 1):
            for keep in (0, 1):
                out.append(case(f"{op}_last{last}_keep{keep}", op,
                                {"x": ties}, tol=None, axis=1,
                                keepdims=keep, select_last_index=last))
    out.append(case("ArgMax_axis0", "ArgMax", {"x": ties}, tol=None,
                    axis=0))
    tk = np.array([[1, 3, 3, 2, 3, 0], [5, 5, 4, 5, 4, 4]], np.float32)
    for largest in (1, 0):
        out.append(case(f"TopK_ties_largest{largest}", "TopK", {"x": tk},
                        {"k": _i64(3)}, n_out=2, tol=None, axis=1,
                        largest=largest))
    out.append(case("TopK_axis0", "TopK", {"x": _f(r, 5, 3)},
                    {"k": _i64(2)}, n_out=2, tol=None, axis=0))

    # shape ops
    x1 = _f(r, 1, 3, 1, 4)
    out.append(case("Squeeze_input", "Squeeze", {"x": x1},
                    {"axes": _i64(0, -2)}, tol=None))
    out.append(case("Squeeze_attr", "Squeeze", {"x": x1}, opset=11,
                    tol=None, axes=[2]))
    out.append(case("Squeeze_all", "Squeeze", {"x": x1}, tol=None))
    out.append(case("Shape", "Shape", {"x": x1}, tol=None))
    out.append(case("Shape_slice", "Shape", {"x": x1}, opset=15, tol=None,
                    start=1, end=-1))
    out.append(case("Size", "Size", {"x": x1}, tol=None))
    out.append(case("Constant", "Constant", tol=None,
                    value=_f(r, 2, 3)))
    out.append(case("ConstantOfShape", "ConstantOfShape", {},
                    {"shape": _i64(2, 3)}, tol=None,
                    value=np.array([7.5], np.float32)))
    out.append(case("Range", "Range", {}, {
        "start": np.array(2.0, np.float32),
        "limit": np.array(11.0, np.float32),
        "delta": np.array(3.0, np.float32)}, tol=None))
    out.append(case("Tile", "Tile", {"x": _f(r, 2, 3)},
                    {"repeats": _i64(2, 3)}, tol=None))
    out.append(case("EyeLike", "EyeLike", {"x": _f(r, 3, 5)}, tol=None,
                    k=1))
    out.append(case("EyeLike_dtype", "EyeLike", {"x": _f(r, 4, 4)},
                    tol=None, k=-1, dtype=6))
    out.append(case("Trilu_upper", "Trilu", {"x": _f(r, 2, 4, 5)},
                    opset=14, tol=None))
    out.append(case("Trilu_lower_k", "Trilu", {"x": _f(r, 4, 5)},
                    {"k": np.array(1, np.int64)}, opset=14, tol=None,
                    upper=0))
    idx = np.array([[0, 2], [1, 3]], np.int64)
    onv = np.array([0.5, 2.0], np.float32)
    out.append(case("OneHot", "OneHot", {"indices": idx},
                    {"depth": _i64(4), "values": onv}, tol=None, axis=-1))
    out.append(case("OneHot_axis0", "OneHot", {"indices": idx},
                    {"depth": _i64(4), "values": onv}, tol=None, axis=0))
    out.append(case("SpaceToDepth", "SpaceToDepth", {"x": _f(r, 2, 3, 4, 6)},
                    tol=None, blocksize=2))
    for mode in ("DCR", "CRD"):
        out.append(case(f"DepthToSpace_{mode}", "DepthToSpace",
                        {"x": _f(r, 2, 8, 3, 2)}, tol=None, blocksize=2,
                        mode=mode))

    # index ops
    xg = _f(r, 3, 4)
    out.append(case("GatherElements", "GatherElements", {"x": xg},
                    {"idx": np.array([[0, -1, 2, 1], [2, 0, -3, 1]],
                                     np.int64)}, tol=None, axis=0))
    out.append(case("GatherElements_axis1", "GatherElements", {"x": xg},
                    {"idx": r.integers(-4, 4, (3, 2)).astype(np.int64)},
                    tol=None, axis=1))
    d3 = _f(r, 2, 3, 4)
    out.append(case("GatherND", "GatherND", {"x": d3},
                    {"idx": np.array([[0, 1], [1, 2], [1, -1]], np.int64)},
                    tol=None))
    out.append(case("GatherND_batch1", "GatherND", {"x": d3},
                    {"idx": np.array([[[1], [2]], [[0], [-1]]], np.int64)},
                    opset=12, tol=None, batch_dims=1))
    data = _f(r, 4, 3)
    uniq = np.array([[2], [0]], np.int64)
    dup = np.array([[1], [3], [1]], np.int64)
    out.append(case("ScatterND", "ScatterND", {"data": data},
                    {"idx": uniq, "upd": _f(r, 2, 3)}, tol=None))
    for red in ("add", "mul", "max", "min"):
        out.append(case(f"ScatterND_{red}", "ScatterND", {"data": data},
                        {"idx": dup, "upd": _f(r, 3, 3)}, opset=18,
                        tol=F32, reduction=red))
    upd = _f(r, 3, 2)
    se_uniq = np.array([[1, 3], [0, 2], [3, -4]], np.int64)
    se_dup = np.array([[1, 1], [0, 0], [3, 3]], np.int64)
    data_t = data.T.copy()
    out.append(case("ScatterElements", "ScatterElements", {"data": data_t},
                    {"idx": se_uniq, "upd": upd}, tol=None, axis=1))
    for red in ("add", "mul", "max", "min"):
        out.append(case(f"ScatterElements_{red}", "ScatterElements",
                        {"data": data_t}, {"idx": se_dup, "upd": upd},
                        opset=18, tol=F32, axis=1, reduction=red))
    xc = _f(r, 3, 5)
    for exc in (0, 1):
        for rev in (0, 1):
            out.append(case(f"CumSum_e{exc}r{rev}", "CumSum", {"x": xc},
                            {"axis": np.array(1, np.int64)}, exclusive=exc,
                            reverse=rev))
    lens = np.array([3, 1, 4], np.int64)
    out.append(case("ReverseSequence", "ReverseSequence",
                    {"x": _f(r, 4, 3, 2)}, {"lens": lens}, tol=None,
                    batch_axis=1, time_axis=0))
    out.append(case("ReverseSequence_batch0", "ReverseSequence",
                    {"x": _f(r, 3, 4, 2)}, {"lens": lens}, tol=None,
                    batch_axis=0, time_axis=1))

    # Pad
    xp = _f(r, 2, 3, 4)
    pads = _i64(0, 1, 2, 0, 2, 1)
    out.append(case("Pad_constant", "Pad", {"x": xp},
                    {"pads": pads, "cval": np.array(1.5, np.float32)},
                    tol=None))
    for mode in ("reflect", "edge", "wrap"):
        out.append(case(f"Pad_{mode}", "Pad", {"x": xp},
                        {"pads": _i64(0, 2, 3, 0, 1, 3)}, opset=19,
                        tol=None, mode=mode))
    out.append(case("Pad_negative", "Pad", {"x": xp},
                    {"pads": _i64(0, -1, 2, 0, 1, -3)}, tol=None))
    out.append(case("Pad_opset2", "Pad", {"x": xp}, opset=2, tol=None,
                    pads=[0, 1, 1, 0, 0, 2], value=-2.0))

    # convs and pools
    out.append(case("ConvTranspose", "ConvTranspose", {"x": _f(r, 2, 4, 5, 5)},
                    {"w": _f(r, 4, 3, 3, 3), "b": _f(r, 3)}, tol=F32_SUM,
                    strides=[2, 2]))
    out.append(case("ConvTranspose_groups", "ConvTranspose",
                    {"x": _f(r, 1, 4, 4, 5)}, {"w": _f(r, 4, 3, 2, 3)},
                    tol=F32_SUM, group=2, pads=[1, 0, 0, 1]))
    out.append(case("ConvTranspose_dilated", "ConvTranspose",
                    {"x": _f(r, 1, 3, 4, 4)}, {"w": _f(r, 3, 2, 3, 3)},
                    tol=F32_SUM, dilations=[2, 1], strides=[1, 2]))
    out.append(case("ConvTranspose_output_padding", "ConvTranspose",
                    {"x": _f(r, 1, 2, 3, 4)}, {"w": _f(r, 2, 2, 3, 3)},
                    tol=F32_SUM, strides=[2, 3], output_padding=[1, 2],
                    pads=[1, 1, 1, 0]))
    out.append(case("ConvTranspose_1d", "ConvTranspose", {"x": _f(r, 2, 3, 7)},
                    {"w": _f(r, 3, 4, 4)}, tol=F32_SUM, strides=[3]))
    out.append(case("GlobalMaxPool", "GlobalMaxPool", {"x": _f(r, 2, 3, 5, 7)},
                    tol=None))
    vals = _f(r, 1, 2, 2, 2)
    uidx = np.array([[[[0, 3], [9, 14]], [[17, 18], [28, 31]]]], np.int64)
    out.append(case("MaxUnpool", "MaxUnpool", {"x": vals}, {"idx": uidx},
                    opset=11, tol=None, kernel_shape=[2, 2],
                    strides=[2, 2]))
    out.append(case("MaxUnpool_shape", "MaxUnpool", {"x": vals},
                    {"idx": uidx, "shape": _i64(1, 2, 5, 5)}, opset=11,
                    tol=None, kernel_shape=[2, 2], strides=[2, 2]))

    # norms
    xn = _f(r, 2, 4, 3, 5)
    out.append(case("InstanceNormalization", "InstanceNormalization",
                    {"x": xn}, {"s": _f(r, 4), "b": _f(r, 4)}, tol=F32_SUM,
                    epsilon=1e-3))
    out.append(case("LRN", "LRN", {"x": xn}, tol=F32_SUM, size=3))
    out.append(case("LRN_5", "LRN", {"x": _f(r, 1, 7, 2, 3)}, tol=F32_SUM,
                    size=5, alpha=0.01, beta=0.5, bias=2.0))
    out.append(case("MeanVarianceNormalization", "MeanVarianceNormalization",
                    {"x": xn}, tol=F32_SUM))
    out.append(case("MeanVarianceNormalization_axes",
                    "MeanVarianceNormalization", {"x": xn}, tol=F32_SUM,
                    axes=[2, 3]))
    xg6 = _f(r, 2, 6, 3, 4)
    out.append(case("GroupNormalization", "GroupNormalization", {"x": xg6},
                    {"s": _f(r, 6), "b": _f(r, 6)}, opset=21, tol=F32_SUM,
                    num_groups=3))
    out.append(case("GroupNormalization_per_group", "GroupNormalization",
                    {"x": xg6}, {"s": _f(r, 2), "b": _f(r, 2)}, opset=18,
                    tol=F32_SUM, num_groups=2, epsilon=1e-3))

    # Resize / Upsample
    img = _f(r, 1, 2, 3, 4)
    scales = np.array([1, 1, 2.0, 1.5], np.float32)
    for coord in ("half_pixel", "asymmetric", "align_corners",
                  "pytorch_half_pixel", "half_pixel_symmetric"):
        for nm in ("round_prefer_floor", "round_prefer_ceil", "floor",
                   "ceil"):
            out.append(case(f"Resize_nearest_{coord}_{nm}", "Resize",
                            {"x": img}, {"scales": scales},
                            ins=["x", "", "scales"], opset=19, tol=None,
                            mode="nearest",
                            coordinate_transformation_mode=coord,
                            nearest_mode=nm))
        out.append(case(f"Resize_linear_{coord}", "Resize", {"x": img},
                        {"scales": scales}, ins=["x", "", "scales"],
                        opset=19, mode="linear",
                        coordinate_transformation_mode=coord))
    out.append(case("Resize_linear_sizes_down", "Resize",
                    {"x": _f(r, 1, 1, 7, 9)}, {"sizes": _i64(1, 1, 4, 5)},
                    ins=["x", "", "", "sizes"], opset=13, mode="linear"))
    out.append(case("Resize_nearest_sizes", "Resize", {"x": img},
                    {"sizes": _i64(1, 2, 5, 7)},
                    ins=["x", "", "", "sizes"], opset=13, tol=None))
    out.append(case("Resize_cubic_keys", "Resize", {"x": _f(r, 1, 1, 5, 6)},
                    {"scales": np.array([1, 1, 2.0, 2.0], np.float32)},
                    ins=["x", "", "scales"], opset=13, tol=(1e-4, 1e-5),
                    mode="cubic", cubic_coeff_a=-0.5, exclude_outside=1))
    out.append(case("Upsample", "Upsample", {"x": img},
                    {"scales": np.array([1, 1, 2.0, 2.0], np.float32)},
                    opset=9, tol=None))
    out.append(case("Upsample_linear", "Upsample", {"x": img},
                    {"scales": np.array([1, 1, 2.0, 3.0], np.float32)},
                    opset=9, mode="linear"))

    # GridSample, Einsum
    gx = _f(r, 2, 3, 5, 6)
    grid = _f(r, 2, 4, 3, 2, lo=-1.2, hi=1.2)
    for mode, pad, align in (("bilinear", "zeros", 0),
                             ("bilinear", "zeros", 1),
                             ("bilinear", "border", 0),
                             ("nearest", "zeros", 0),
                             ("nearest", "border", 1)):
        out.append(case(f"GridSample_{mode}_{pad}_{align}", "GridSample",
                        {"x": gx, "grid": grid}, opset=16,
                        tol=None if mode == "nearest" else F32, mode=mode,
                        padding_mode=pad, align_corners=align))
    out.append(case("Einsum_bmm", "Einsum", {"a": _f(r, 2, 3, 4),
                                              "b": _f(r, 2, 4, 5)},
                    opset=12, tol=F32_SUM, equation="bij,bjk->bik"))
    out.append(case("Einsum_trace", "Einsum", {"a": _f(r, 4, 4)}, opset=12,
                    tol=F32_SUM, equation="ii->i"))
    return out


# ---------------------------------------------------------------------------
# ops/extra.py
# ---------------------------------------------------------------------------
def _extra() -> List[Case]:
    out = []
    r = _rng("extra")
    x = _f(r, 3, 4)
    unit = _f(r, 3, 4, lo=-0.9, hi=0.9)
    for op, inp in (("Tan", unit), ("Asin", unit), ("Acos", unit),
                    ("Atan", x), ("Sinh", x), ("Cosh", x), ("Asinh", x),
                    ("Acosh", _f(r, 3, 4, lo=1.1, hi=4.0)),
                    ("Atanh", unit)):
        out.append(case(op, op, {"x": inp}, opset=9))
    i32 = r.integers(-1000, 1000, (3, 4)).astype(np.int32)
    out.append(case("BitwiseNot", "BitwiseNot", {"x": i32}, opset=18,
                    tol=None))
    out.append(case("BitwiseXor", "BitwiseXor",
                    {"a": i32, "b": r.integers(-99, 99, (4,)).astype(
                        np.int32)}, opset=18, tol=None))
    m = _f(r, 2, 3, 3) + 2 * np.eye(3, dtype=np.float32)
    out.append(case("Det", "Det", {"x": m}, opset=11, tol=F32_SUM))
    sing = _f(r, 2, 2, 5, 5)
    sing[0, 1, 3] = sing[0, 1, 1]  # a singular matrix among them
    out.append(case("Det_batched", "Det", {"x": sing}, opset=11,
                    tol=(1e-4, 1e-5)))
    xn = _f(r, 2, 3, 4)
    for p in (1, 2):
        out.append(case(f"LpNormalization_p{p}", "LpNormalization",
                        {"x": xn}, tol=F32_SUM, axis=1, p=p))
    xi = _f(r, 2, 3, 4, 5)
    for p in (1, 2, 3):
        out.append(case(f"GlobalLpPool_p{p}", "GlobalLpPool", {"x": xi},
                        tol=F32_SUM, p=p))
    out.append(case("LpPool", "LpPool", {"x": xi}, opset=18, tol=F32_SUM,
                    kernel_shape=[2, 3], strides=[2, 1], pads=[0, 1, 1, 0],
                    p=2))
    out.append(case("LpPool_p1_dilated", "LpPool", {"x": _f(r, 1, 2, 6, 6)},
                    opset=18, tol=F32_SUM, kernel_shape=[2, 2],
                    dilations=[2, 2], p=1))
    out.append(case("CenterCropPad", "CenterCropPad", {"x": _f(r, 5, 4, 3)},
                    {"shape": _i64(3, 7)}, opset=18, tol=None, axes=[0, 1]))
    # Col2Im: [N, C*prod(block), L] for a 5x6 image, block 2x3, stride 1
    out.append(case("Col2Im", "Col2Im", {"x": _f(r, 2, 2 * 6, 4 * 4)},
                    {"img": _i64(5, 6), "blk": _i64(2, 3)}, opset=18,
                    tol=F32_SUM))
    out.append(case("Col2Im_strided", "Col2Im",
                    {"x": _f(r, 1, 1 * 4, 4 * 2)},
                    {"img": _i64(6, 5), "blk": _i64(2, 2)}, opset=18,
                    tol=F32_SUM, strides=[2, 2], pads=[1, 0, 1, 0],
                    dilations=[1, 2]))
    for op in ("HannWindow", "HammingWindow", "BlackmanWindow"):
        for per in (1, 0):
            out.append(case(f"{op}_periodic{per}", op, {},
                            {"size": np.array(10, np.int64)}, opset=17,
                            periodic=per))
    sig = _f(r, 2, 8, 1)
    cplx = _f(r, 2, 8, 2)
    out.append(case("DFT_real", "DFT", {"x": sig}, opset=17, tol=FFT))
    out.append(case("DFT_complex_inverse", "DFT", {"x": cplx}, opset=17,
                    tol=FFT, inverse=1))
    out.append(case("DFT_onesided_length", "DFT", {"x": sig},
                    {"n": np.array(10, np.int64)}, opset=17, tol=FFT,
                    onesided=1))
    out.append(case("DFT_axis_input", "DFT", {"x": _f(r, 3, 4, 6, 1)},
                    {"axis": np.array(2, np.int64)},
                    ins=["x", "", "axis"], opset=20, tol=FFT))
    wave = _f(r, 2, 64)
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(16) / 16)).astype(
        np.float32)
    out.append(case("STFT", "STFT", {"x": wave},
                    {"step": np.array(8, np.int64), "win": win}, opset=17,
                    tol=FFT))
    out.append(case("STFT_frame_length", "STFT", {"x": wave[..., None]},
                    {"step": np.array(6, np.int64),
                     "fl": np.array(12, np.int64)},
                    ins=["x", "step", "", "fl"], opset=17, tol=FFT,
                    onesided=0))
    out.append(case("MelWeightMatrix", "MelWeightMatrix", {}, {
        "n_mel": np.array(8, np.int32), "dft": np.array(64, np.int32),
        "sr": np.array(8000, np.int32), "lo": np.array(0.0, np.float32),
        "hi": np.array(4000.0, np.float32)}, opset=17))
    out.append(case("Scatter", "Scatter", {"data": _f(r, 3, 4)},
                    {"idx": np.array([[1, 0, 3, 2]], np.int64),
                     "upd": _f(r, 1, 4)}, opset=10, tol=None, axis=1))
    for align in (0, 1):
        out.append(case(f"AffineGrid_2d_align{align}", "AffineGrid",
                        {"theta": _f(r, 2, 2, 3)},
                        {"size": _i64(2, 3, 4, 5)}, opset=20,
                        align_corners=align))
    out.append(case("AffineGrid_3d", "AffineGrid", {"theta": _f(r, 2, 3, 4)},
                    {"size": _i64(2, 1, 3, 4, 2)}, opset=20))
    return out


# ---------------------------------------------------------------------------
# ops/contrib_transformers.py and ops/core_attention.py
# ---------------------------------------------------------------------------
MS = "com.microsoft"


def _rope_caches(r, max_pos, half):
    ang = r.uniform(0, 3, (max_pos, half)).astype(np.float32)
    return np.cos(ang), np.sin(ang)


# ---------------------------------------------------------------------------
# ops/bounded.py, ops/losses.py, ops/vision_roi.py, ops/ml.py
# ---------------------------------------------------------------------------
ROI = (1e-4, 1e-5)      # test_roi_ops.py's bounds
DEFORM = (1e-3, 1e-4)
ML = "ai.onnx.ml"


def forest_attrs(r: np.random.Generator, n_trees: int, depth: int,
                 n_feat: int, n_out: int, kind: str = "target",
                 weight_scale: float = 1.0) -> dict:
    """Random full binary trees of one depth in the ai.onnx.ml v3
    attribute form (`kind` "target" for the regressor, "class" for the
    classifier): nodes numbered breadth first per tree (node i's children
    2i + 1 and 2i + 2), every node BRANCH_LEQ on a random feature and
    threshold, missing values going either way; n_out leaf weights per
    leaf."""
    n_int, n_node = 2 ** depth - 1, 2 ** (depth + 1) - 1
    ids = np.arange(n_node)
    internal = ids < n_int
    feats = np.where(internal, r.integers(0, n_feat, (n_trees, n_node)), 0)
    values = np.where(internal, r.standard_normal((n_trees, n_node)), 0.0)
    miss = np.where(internal, r.integers(0, 2, (n_trees, n_node)), 0)
    leaves = ids[~internal]
    n_leaf = leaves.size
    attrs = {
        "nodes_treeids": np.repeat(np.arange(n_trees), n_node).tolist(),
        "nodes_nodeids": np.tile(ids, n_trees).tolist(),
        "nodes_featureids": feats.reshape(-1).tolist(),
        "nodes_modes": (["BRANCH_LEQ"] * n_int + ["LEAF"] * n_leaf)
        * n_trees,
        "nodes_values": values.astype(np.float32).reshape(-1).tolist(),
        "nodes_truenodeids": np.tile(np.where(internal, 2 * ids + 1, 0),
                                     n_trees).tolist(),
        "nodes_falsenodeids": np.tile(np.where(internal, 2 * ids + 2, 0),
                                      n_trees).tolist(),
        "nodes_missing_value_tracks_true": miss.reshape(-1).tolist(),
        f"{kind}_treeids": np.repeat(np.arange(n_trees),
                                     n_leaf * n_out).tolist(),
        f"{kind}_nodeids": np.tile(np.repeat(leaves, n_out),
                                   n_trees).tolist(),
        f"{kind}_ids": np.tile(np.arange(n_out),
                               n_trees * n_leaf).tolist(),
        f"{kind}_weights": (r.standard_normal(n_trees * n_leaf * n_out)
                            * weight_scale).astype(np.float32).tolist(),
    }
    return attrs


def _bounded_losses_roi() -> List[Case]:
    r = _rng("bounded")
    x = _f(r, 3, 4) * (r.random((3, 4)) > 0.5)
    out = [case("NonZero", "NonZero", {"x": x}, tol=None),
           case("NonZero_bool", "NonZero", {"x": r.random(7) > 0.5},
                tol=None)]
    xc = _f(r, 4, 5)
    out.append(case("Compress_axis1", "Compress", {"x": xc},
                    {"cond": r.random(5) > 0.5}, tol=None, axis=1))
    out.append(case("Compress_flat", "Compress", {"x": xc},
                    {"cond": r.random(20) > 0.5}, tol=None))
    xu = r.integers(0, 6, 16).astype(np.int64)
    for srt in (1, 0):
        out.append(case(f"Unique_sorted{srt}", "Unique", {"x": xu},
                        opset=11, n_out=4, tol=None, sorted=srt))
    boxes = (r.random((2, 20, 4)) * 10).astype(np.float32)
    scores = r.random((2, 3, 20)).astype(np.float32)
    nms = {"max_out": np.array(5, np.int64),
           "iou": np.array(0.5, np.float32),
           "score": np.array(0.2, np.float32)}
    out.append(case("NonMaxSuppression", "NonMaxSuppression",
                    {"boxes": boxes, "scores": scores}, nms, opset=11,
                    tol=None))
    centers = np.concatenate([boxes[..., :2], boxes[..., 2:] / 3], -1)
    out.append(case("NonMaxSuppression_center", "NonMaxSuppression",
                    {"boxes": centers, "scores": scores}, nms, opset=11,
                    tol=None, center_point_box=1))

    logp = np.log(r.dirichlet(np.ones(5), size=(4, 3))).astype(np.float32)
    logp = np.moveaxis(logp, -1, 1).copy()
    t = r.integers(0, 5, (4, 3)).astype(np.int64)
    out.append(case("NegativeLogLikelihoodLoss",
                    "NegativeLogLikelihoodLoss", {"logp": logp, "t": t},
                    {"w": _f(r, 5, lo=0.5, hi=2.0)}, tol=F32_SUM,
                    ignore_index=2))
    sc = _f(r, 6, 7, scale=3.0)
    ts = r.integers(0, 7, 6).astype(np.int64)
    ts[::3] = -100
    out.append(case("SoftmaxCrossEntropyLoss_none",
                    "SoftmaxCrossEntropyLoss", {"s": sc, "t": ts},
                    n_out=2, tol=F32_SUM, reduction="none",
                    ignore_index=-100))
    out.append(case("SoftmaxCrossEntropyLoss_mean",
                    "SoftmaxCrossEntropyLoss",
                    {"s": _f(r, 3, 6, 4), "t": r.integers(
                        0, 6, (3, 4)).astype(np.int64)},
                    {"w": _f(r, 6, lo=0.2, hi=1.5)}, tol=F32_SUM))

    xr = _f(r, 2, 3, 12, 10)
    rois = np.array([[0.4, 1.1, 7.2, 9.0], [2.0, 0.0, 9.5, 5.5],
                     [-1.0, 0.0, 9.9, 11.9]], np.float32)
    bidx = np.array([0, 1, 1], np.int64)
    out.append(case("RoiAlign_avg", "RoiAlign",
                    {"x": xr, "rois": rois, "b": bidx}, tol=ROI,
                    output_height=4, output_width=3, sampling_ratio=2,
                    spatial_scale=1.0))
    out.append(case("RoiAlign_max", "RoiAlign",
                    {"x": xr, "rois": rois, "b": bidx}, tol=ROI,
                    output_height=2, output_width=3, sampling_ratio=3,
                    spatial_scale=0.5, mode="max",
                    coordinate_transformation_mode="output_half_pixel"))
    out.append(case("RoiAlign_adaptive", "RoiAlign", {"x": xr},
                    {"rois": rois[:2], "b": bidx[:2]}, tol=ROI,
                    output_height=3, output_width=3, sampling_ratio=0))
    out.append(case("MaxRoiPool", "MaxRoiPool", {"x": _f(r, 2, 3, 9, 11)},
                    {"rois": np.array([[0, 1.0, 1.0, 8.0, 6.0],
                                       [1, 0.0, 0.0, 10.0, 8.0],
                                       [0, 4.0, 4.0, 4.0, 4.0]],
                                      np.float32)},
                    tol=F32, pooled_shape=[3, 4], spatial_scale=1.0))
    N, C, H, W, M = 1, 4, 9, 8, 4
    out.append(case("DeformConv", "DeformConv",
                    {"x": _f(r, N, C, H, W),
                     "off": _f(r, N, 2 * 2 * 3 * 2, 5, 10, scale=1.7)},
                    {"w": _f(r, M, C // 2, 2, 3), "b": _f(r, M),
                     "mask": _f(r, N, 2 * 2 * 3, 5, 10, lo=0.0, hi=1.0)},
                    ins=["x", "w", "off", "b", "mask"], opset=19,
                    tol=DEFORM, kernel_shape=[2, 3], strides=[2, 1],
                    pads=[1, 2, 1, 2], dilations=[2, 1], group=2,
                    offset_group=2))
    return out


def _ml() -> List[Case]:
    r = _rng("ml")
    x = _f(r, 6, 4)

    def ml(cid, op, feeds, inits=None, tol=F32, **kw):
        return case(cid, op, feeds, inits, domain=ML, tol=tol, **kw)

    xn = x.copy()
    xn[1, 2] = xn[4, 0] = np.nan
    coef = _f(r, 3, 4)
    sv = _f(r, 6, 4)
    pairs = 3
    out = [
        ml("Scaler", "Scaler", {"x": x}, offset=[0.5, -1.0, 0.0, 2.0],
           scale=[2.0, 1.0, 0.5, -1.0]),
        ml("Normalizer", "Normalizer", {"x": x}, norm="L2"),
        ml("Binarizer", "Binarizer", {"x": x}, threshold=0.3),
        ml("Imputer", "Imputer", {"x": xn},
           imputed_value_floats=[1.0, 2.0, 3.0, 4.0]),
        ml("ArrayFeatureExtractor", "ArrayFeatureExtractor", {"x": x},
           {"idx": np.array([3, 0, 2, 9], np.int64)}),
        ml("FeatureVectorizer", "FeatureVectorizer",
           {"a": x, "b": r.integers(0, 4, (6, 2)).astype(np.int64)},
           inputdimensions=[3, 3]),
        ml("OneHotEncoder", "OneHotEncoder",
           {"x": r.integers(0, 5, (6, 2)).astype(np.int64)},
           cats_int64s=[1, 2, 4]),
        ml("LabelEncoder", "LabelEncoder",
           {"x": r.integers(0, 5, (6, 2)).astype(np.int64)},
           keys_int64s=[1, 2, 4], values_floats=[0.5, -1.5, 2.5],
           default_float=9.0),
        ml("LinearRegressor", "LinearRegressor", {"x": x}, tol=F32_SUM,
           coefficients=coef[:2].reshape(-1).tolist(),
           intercepts=[0.5, -0.5], targets=2),
        ml("LinearClassifier", "LinearClassifier", {"x": x}, n_out=2,
           tol=F32_SUM, coefficients=coef.reshape(-1).tolist(),
           intercepts=[0.1, 0.0, -0.1], classlabels_int64s=[7, 8, 9],
           post_transform="SOFTMAX"),
        ml("SVMRegressor", "SVMRegressor", {"x": x}, tol=F32_SUM,
           coefficients=_f(r, 6).tolist(),
           support_vectors=sv.reshape(-1).tolist(), n_supports=6,
           rho=[0.05], kernel_type="RBF", kernel_params=[0.4, 0.0, 3.0]),
        ml("SVMClassifier_coupling", "SVMClassifier", {"x": x}, n_out=2,
           tol=F32_SUM, coefficients=_f(r, 12).tolist(),
           support_vectors=sv.reshape(-1).tolist(),
           vectors_per_class=[2, 2, 2], rho=[0.1, -0.2, 0.05],
           kernel_type="RBF", kernel_params=[0.5, 0.0, 3.0],
           prob_a=(-_f(r, pairs, lo=0.8, hi=1.6)).tolist(),
           prob_b=_f(r, pairs, scale=0.1).tolist(),
           classlabels_int64s=[0, 1, 2]),
        ml("SVMClassifier_votes", "SVMClassifier", {"x": x}, n_out=2,
           tol=F32_SUM, coefficients=_f(r, 12).tolist(),
           support_vectors=sv.reshape(-1).tolist(),
           vectors_per_class=[2, 2, 2], rho=[0.1, -0.2, 0.05],
           kernel_type="POLY", kernel_params=[0.5, 0.1, 2.0],
           classlabels_int64s=[10, 20, 30]),
        ml("TreeEnsembleRegressor", "TreeEnsembleRegressor", {"x": xn},
           tol=F32_SUM, n_targets=2, base_values=[0.25, -0.5],
           **forest_attrs(r, 4, 3, 4, 2)),
    ]
    binary = forest_attrs(r, 3, 3, 4, 1, kind="class")
    binary["class_ids"] = [1] * len(binary["class_ids"])
    out.append(ml("TreeEnsembleClassifier", "TreeEnsembleClassifier",
                  {"x": xn}, n_out=2, tol=F32_SUM,
                  classlabels_int64s=[0, 1], post_transform="LOGISTIC",
                  **binary))
    out.append(ml("TreeEnsemble", "TreeEnsemble", {"x": x[:, :2]},
                  tol=F32_SUM, nodes_featureids=[0, 0, 1],
                  nodes_splits=np.array([0.0, 0.5, -0.2], np.float32),
                  nodes_modes=np.array([0, 1, 2], np.uint8),
                  nodes_truenodeids=[0, 1, 3], nodes_falsenodeids=[1, 2, 4],
                  nodes_trueleafs=[1, 1, 1], nodes_falseleafs=[0, 1, 1],
                  tree_roots=[0, 2], leaf_targetids=[0, 1, 0, 1, 0],
                  leaf_weights=np.array([1.5, 2.5, 4.0, -1.0, 0.5],
                                        np.float32),
                  n_targets=2, aggregate_function=1))
    return out


def _attention() -> List[Case]:
    out = []
    r = _rng("attention")
    B, S, D, H = 2, 5, 16, 4
    x = _f(r, B, S, D)
    out.append(case("BiasGelu", "BiasGelu", {"x": x}, {"b": _f(r, D)},
                    domain=MS))
    out.append(case("FastGelu", "FastGelu", {"x": x}, {"b": _f(r, D)},
                    domain=MS))
    out.append(case("FastGelu_nobias", "FastGelu", {"x": x}, domain=MS))
    ln = {"g": _f(r, D, lo=0.5, hi=1.5), "beta": _f(r, D),
          "bias": _f(r, D)}
    out.append(case("SkipLayerNormalization", "SkipLayerNormalization",
                    {"x": x, "skip": _f(r, B, S, D)}, ln, n_out=4,
                    domain=MS, tol=F32_SUM, epsilon=1e-5))
    out.append(case("SkipLayerNormalization_noopt", "SkipLayerNormalization",
                    {"x": x, "skip": _f(r, B, S, D)},
                    {"g": ln["g"]}, domain=MS, tol=F32_SUM))
    ids = r.integers(0, 11, (B, S)).astype(np.int32)
    seg = r.integers(0, 2, (B, S)).astype(np.int32)
    mask = np.array([[1] * 5, [1, 1, 1, 0, 0]], np.int32)
    out.append(case("EmbedLayerNormalization", "EmbedLayerNormalization",
                    {"ids": ids, "seg": seg},
                    {"we": _f(r, 11, D), "pe": _f(r, 8, D),
                     "se": _f(r, 2, D), "g": ln["g"], "beta": ln["beta"],
                     "mask": mask}, n_out=3, domain=MS, tol=F32_SUM))
    out.append(case("EmbedLayerNormalization_nomask",
                    "EmbedLayerNormalization", {"ids": ids},
                    {"we": _f(r, 11, D), "pe": _f(r, 8, D), "g": ln["g"],
                     "beta": ln["beta"]},
                    ins=["ids", "", "we", "pe", "", "g", "beta"], n_out=2,
                    domain=MS, tol=F32_SUM))
    w, b = _f(r, D, 3 * D, scale=0.3), _f(r, 3 * D)
    out.append(case("Attention_lengths", "Attention", {"x": x},
                    {"w": w, "b": b, "m": np.array([5, 3], np.int32)},
                    domain=MS, tol=F32_SUM, num_heads=H))
    out.append(case("Attention_keymask_bias", "Attention", {"x": x},
                    {"w": w, "b": b, "m": mask,
                     "ab": _f(r, 1, H, S, S)},
                    ins=["x", "w", "b", "m", "", "ab"], domain=MS,
                    tol=F32_SUM, num_heads=H, scale=0.3))
    out.append(case("Attention_unidirectional", "Attention", {"x": x},
                    {"w": w}, domain=MS, tol=F32_SUM, num_heads=H,
                    unidirectional=1))
    out.append(case("Attention_qkv_sizes", "Attention", {"x": x},
                    {"w": _f(r, D, 16 + 16 + 8, scale=0.3)}, domain=MS,
                    tol=F32_SUM, num_heads=H, qkv_hidden_sizes=[16, 16, 8]))
    out.append(case("Attention_bare", "Attention", {"x": x}, {"w": w},
                    tol=F32_SUM, num_heads=H))
    Skv = 7
    out.append(case("MultiHeadAttention", "MultiHeadAttention",
                    {"q": x, "k": _f(r, B, Skv, D), "v": _f(r, B, Skv, D)},
                    {"b": _f(r, 3 * D), "kpm": np.array([[1] * 7,
                                                         [1] * 4 + [0] * 3],
                                                        np.int32)},
                    domain=MS, tol=F32_SUM, num_heads=H))
    out.append(case("MultiHeadAttention_causal", "MultiHeadAttention",
                    {"q": x, "k": _f(r, B, S, D), "v": _f(r, B, S, D)},
                    domain=MS, tol=F32_SUM, num_heads=H, unidirectional=1))
    hd = D // H
    cos, sin = _rope_caches(r, 16, hd // 2)
    pos = np.tile(np.arange(S, dtype=np.int64) + 2, (B, 1))
    for inter in (0, 1):
        out.append(case(f"RotaryEmbedding_ms_i{inter}", "RotaryEmbedding",
                        {"x": x}, {"pos": pos, "cos": cos, "sin": sin},
                        domain=MS, tol=F32, interleaved=inter,
                        num_heads=H))
    out.append(case("RotaryEmbedding_ms_offset", "RotaryEmbedding",
                    {"x": x}, {"pos": np.array([[3], [1]], np.int64),
                               "cos": cos, "sin": sin},
                    domain=MS, num_heads=H))
    out.append(case("RotaryEmbedding_ms_4d_infer", "RotaryEmbedding",
                    {"x": _f(r, B, H, S, hd)},
                    {"pos": pos[:1], "cos": cos, "sin": sin}, domain=MS))
    out.append(case("RotaryEmbedding_bare_contrib", "RotaryEmbedding",
                    {"x": x}, {"pos": pos, "cos": cos, "sin": sin},
                    num_heads=H))
    Hkv = 2
    kv = {"k": _f(r, B, S, Hkv * hd), "v": _f(r, B, S, Hkv * hd)}
    for inter in (0, 1):
        out.append(case(f"GroupQueryAttention_rope_i{inter}",
                        "GroupQueryAttention", dict(q=x, **kv),
                        {"sl": np.array([4, 2], np.int32),
                         "tot": np.array(S, np.int32), "cos": cos,
                         "sin": sin},
                        ins=["q", "k", "v", "", "", "sl", "tot", "cos",
                             "sin"], domain=MS, tol=F32_SUM, num_heads=H,
                        kv_num_heads=Hkv, do_rotary=1,
                        rotary_interleaved=inter))
    out.append(case("GroupQueryAttention_plain", "GroupQueryAttention",
                    dict(q=x, **kv), domain=MS, tol=F32_SUM, num_heads=H,
                    kv_num_heads=Hkv, scale=0.0))
    out.append(case("FusedMatMul", "FusedMatMul",
                    {"a": _f(r, 3, 4), "b": _f(r, 5, 4)}, domain=MS,
                    tol=F32_SUM, transB=1, alpha=0.5))
    out.append(case("FusedMatMul_batched", "FusedMatMul",
                    {"a": _f(r, 2, 4, 3), "b": _f(r, 2, 4, 5)}, domain=MS,
                    tol=F32_SUM, transA=1))

    # core (opset 23)
    L, Sk = 4, 6
    q4, k4, v4 = _f(r, B, H, L, hd), _f(r, B, H, Sk, hd), _f(r, B, H, Sk, hd)
    out.append(case("Attention_core_4d", "Attention",
                    {"q": q4, "k": k4, "v": v4}, opset=23, tol=F32_SUM))
    out.append(case("Attention_core_causal", "Attention",
                    {"q": q4, "k": k4, "v": v4}, opset=23, tol=F32_SUM,
                    is_causal=1))
    q3 = _f(r, B, L, H * hd)
    k3, v3 = _f(r, B, Sk, Hkv * hd), _f(r, B, Sk, Hkv * hd)
    out.append(case("Attention_core_gqa_3d", "Attention",
                    {"q": q3, "k": k3, "v": v3}, opset=23, tol=F32_SUM,
                    q_num_heads=H, kv_num_heads=Hkv))
    out.append(case("Attention_core_bool_mask", "Attention",
                    {"q": q4, "k": k4, "v": v4},
                    {"m": r.random((L, Sk)) > 0.3}, opset=23, tol=F32_SUM))
    out.append(case("Attention_core_float_mask_softcap", "Attention",
                    {"q": q4, "k": k4, "v": v4}, {"m": _f(r, B, 1, L, Sk)},
                    opset=23, tol=F32_SUM, softcap=2.0, scale=0.4))
    for mode in range(4):
        out.append(case(f"Attention_core_qk_mode{mode}", "Attention",
                        {"q": q4, "k": k4, "v": v4},
                        {"m": _f(r, L, Sk)},
                        ins=["q", "k", "v", "m"], opset=23, n_out=4,
                        tol=F32_SUM, softcap=3.0,
                        qk_matmul_output_mode=mode))
    out.append(case("Attention_core_past", "Attention",
                    {"q": _f(r, B, H, 1, hd), "k": _f(r, B, H, 1, hd),
                     "v": _f(r, B, H, 1, hd), "pk": _f(r, B, H, 3, hd),
                     "pv": _f(r, B, H, 3, hd)},
                    ins=["q", "k", "v", "", "pk", "pv"], opset=23, n_out=3,
                    tol=F32_SUM))
    cos_c, sin_c = _rope_caches(r, 12, hd // 2)
    for inter in (0, 1):
        out.append(case(f"RotaryEmbedding_core_4d_i{inter}",
                        "RotaryEmbedding", {"x": q4},
                        {"cos": cos_c, "sin": sin_c,
                         "pos": r.integers(0, 12, (B, L)).astype(np.int64)},
                        opset=23, interleaved=inter))
    out.append(case("RotaryEmbedding_core_3d_nopos", "RotaryEmbedding",
                    {"x": q3}, {"cos": _f(r, B, L, hd // 2),
                                "sin": _f(r, B, L, hd // 2)},
                    opset=23, num_heads=H))
    out.append(case("RotaryEmbedding_core_partial", "RotaryEmbedding",
                    {"x": q4}, {"cos": cos_c[:, :1], "sin": sin_c[:, :1],
                                "pos": np.arange(L, dtype=np.int64)},
                    opset=23, rotary_embedding_dim=2))
    return out


# ---------------------------------------------------------------------------
# where the JAX emitter breaks the spec, and the random ops
# ---------------------------------------------------------------------------
def _spec() -> List[Case]:
    r = _rng("spec")
    out = [
        case("Selu_attrs", "Selu", {"x": _f(r, 3, 4)}, alpha=2.0,
             gamma=0.5),
        case("OneHot_negative", "OneHot",
             {"indices": np.array([[-1, 2], [-4, 0]], np.int64)},
             {"depth": _i64(4), "values": np.array([0.0, 1.0], np.float32)},
             tol=None),
        case("Hardmax_opset11", "Hardmax", {"x": _f(r, 2, 3, 4)}, opset=11,
             tol=None, axis=1),
        case("Pad_axes", "Pad", {"x": _f(r, 2, 3, 4)},
             {"pads": _i64(1, 2, 0, 1), "axes": _i64(0, 2)},
             ins=["x", "pads", "", "axes"], opset=18, tol=None),
        case("DFT_negative_axis", "DFT", {"x": _f(r, 2, 8, 3, 1)},
             {"axis": np.array(-3, np.int64)}, ins=["x", "", "axis"],
             opset=20, tol=FFT),
        case("Resize_opset10", "Resize", {"x": _f(r, 1, 2, 3, 4)},
             {"scales": np.array([1, 1, 2.0, 1.5], np.float32)}, opset=10,
             tol=None),
        case("Resize_cubic_default", "Resize", {"x": _f(r, 1, 1, 4, 5)},
             {"scales": np.array([1, 1, 2.0, 2.0], np.float32)},
             ins=["x", "", "scales"], opset=13, tol=(1e-5, 1e-5),
             mode="cubic"),
        case("Resize_cubic_asymmetric", "Resize", {"x": _f(r, 1, 1, 4, 5)},
             {"scales": np.array([1, 1, 2.0, 1.5], np.float32)},
             ins=["x", "", "scales"], opset=13, tol=(1e-5, 1e-5),
             mode="cubic", coordinate_transformation_mode="asymmetric"),
    ]
    return out


def _cubic_1d(x, do, scale, a, coord, axis):
    """numpy's spec cubic along `axis` (edge-clamped taps)."""
    di = x.shape[axis]
    i = np.arange(do, dtype=np.float64)
    src = (i + 0.5) / scale - 0.5 if coord == "half_pixel" else i / scale
    base = np.floor(src)
    t = src - base
    d = np.stack([t + 1, t, 1 - t, 2 - t], -1)
    w = np.where(d <= 1, ((a + 2) * d - (a + 3)) * d * d + 1,
                 ((a * d - 5 * a) * d + 8 * a) * d - 4 * a)
    taps = np.clip(base[:, None].astype(int) + np.arange(-1, 3), 0, di - 1)
    xm = np.moveaxis(x, axis, -1)
    return np.moveaxis((xm[..., taps] * w).sum(-1), -1, axis)


def _spec_refs() -> dict:
    """case id -> numpy reference of the spec's output(s)."""
    s = {c.id: c for c in SPEC_CASES}
    refs = {}
    x = s["Selu_attrs"].feeds["x"]
    refs["Selu_attrs"] = [0.5 * np.where(x > 0, x, 2.0 * (np.exp(x) - 1))]
    idx = s["OneHot_negative"].feeds["indices"]
    refs["OneHot_negative"] = [np.eye(4, dtype=np.float32)[idx % 4]]
    x = s["Hardmax_opset11"].feeds["x"]
    flat = x.reshape(2, 12)
    refs["Hardmax_opset11"] = [np.eye(12, dtype=np.float32)[
        flat.argmax(1)].reshape(x.shape)]
    x = s["Pad_axes"].feeds["x"]
    refs["Pad_axes"] = [np.pad(x, [(1, 0), (0, 0), (2, 1)])]
    x = s["DFT_negative_axis"].feeds["x"]
    y = np.fft.fft(x[..., 0], axis=1)
    refs["DFT_negative_axis"] = [np.stack([y.real, y.imag], -1)]
    x = s["Resize_opset10"].feeds["x"]
    rows = np.floor(np.arange(6) / 2.0).astype(int)
    cols = np.floor(np.arange(6) / 1.5).astype(int)
    refs["Resize_opset10"] = [x[:, :, rows][:, :, :, cols]]
    for cid, coord in (("Resize_cubic_default", "half_pixel"),
                       ("Resize_cubic_asymmetric", "asymmetric")):
        x = s[cid].feeds["x"].astype(np.float64)
        sc = s[cid].inits["scales"]
        y = _cubic_1d(x, int(x.shape[2] * sc[2]), float(sc[2]), -0.75,
                      coord, 2)
        y = _cubic_1d(y, int(x.shape[3] * sc[3]), float(sc[3]), -0.75,
                      coord, 3)
        refs[cid] = [y.astype(np.float32)]
    return refs


def _random() -> List[Case]:
    r = _rng("random")
    p = r.uniform(0.1, 0.9, (64, 64)).astype(np.float32)
    logits = np.log(np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]],
                             np.float32))
    return [
        case("RandomNormal", "RandomNormal", tol=None, shape=[64, 64],
             mean=1.0, scale=2.0, seed=3.0),
        case("RandomNormalLike", "RandomNormalLike",
             {"x": np.zeros((64, 64), np.float32)}, tol=None),
        case("RandomUniform", "RandomUniform", tol=None, shape=[64, 64],
             low=-1.0, high=3.0, seed=5.0),
        case("RandomUniformLike", "RandomUniformLike",
             {"x": np.zeros((64, 64), np.float32)}, tol=None, dtype=1),
        case("Bernoulli", "Bernoulli", {"p": p}, opset=15, tol=None,
             seed=1.0),
        case("Multinomial", "Multinomial", {"x": logits}, opset=7,
             tol=None, sample_size=4096, seed=2.0),
    ]


CASES = _standard() + _extra() + _bounded_losses_roi() + _ml()
ATTENTION_CASES = _attention()
SPEC_CASES = _spec()
SPEC_REFS = _spec_refs()
RANDOM_CASES = _random()
ALL_CASES = CASES + ATTENTION_CASES + SPEC_CASES + RANDOM_CASES


def worst_error(got, want, tol) -> float:
    """Max |got - want| over the outputs after checking them: equal where
    exact (tol None, or integer / boolean outputs), else |got - want| <=
    atol + rtol * |want| elementwise (numpy's allclose, NaN equal to NaN);
    raises AssertionError naming the output otherwise."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"out{i}: {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if tol is None or w.dtype.kind in "biu":
            if not np.array_equal(g, w, equal_nan=w.dtype.kind == "f"):
                raise AssertionError(f"out{i}: not equal")
            continue
        if not np.allclose(g, w, rtol=tol[0], atol=tol[1], equal_nan=True):
            raise AssertionError(
                f"out{i}: max |d| {np.nanmax(np.abs(g - w))} beyond "
                f"rtol {tol[0]}, atol {tol[1]}")
        d = np.abs(g.astype(np.float64) - w)
        worst = max(worst, float(np.nanmax(d)) if d.size else 0.0)
    return worst


def card_vs_cpu(c: Case) -> tuple:
    """The case through the port on the card, eager (the Engine's first
    call, which then captures it) and replayed (its second call), each
    held against the port's CPU run of the same graph and inputs (exact,
    or at the case's tolerance); returns (the worst errors, the card's
    Engine). Imports the port (and torch) only when called."""
    from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
    from onnx_rusty_inference_engine_tpu_torch.engine import Engine
    from onnx_rusty_inference_engine_tpu_torch.graph import import_model

    graph = import_model(t_io.parse_model(t_io.serialize_model(
        model(c, t_io))))
    names = [f"out{i}" for i in range(c.n_out)]
    want = [np.asarray(Engine(graph, device="cpu").run(c.feeds).outputs[n])
            for n in names]
    eng = Engine(graph)
    errs = {}
    for label in ("eager", "replayed"):
        res = eng.run(c.feeds).outputs
        try:
            errs[label] = worst_error([np.asarray(res[n]) for n in names],
                                      want, c.tol)
        except AssertionError as e:
            raise AssertionError(f"{c.id} {label}: {e}") from None
    if len(eng._graphs) != 1:
        raise AssertionError(f"{c.id}: {len(eng._graphs)} captured graphs")
    return errs, eng

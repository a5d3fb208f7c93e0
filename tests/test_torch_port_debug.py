"""The port's debugging surface on the CPU (debug.py, utils/profiling.py,
the Engine's node ranges, the kernel build cache, the CLI's profile and
run --dump-stats / --dump-tensors) against the JAX package's.

- `dump_intermediates` on SqueezeNet 1.0 fp32 and INT8 (64x64, b2) against
  JAX's on the same graph and feed: the same tensor names, integer tensors
  exact, float ones at rtol 1e-4 with atol 1e-5 x max(1, max|ref|)
  (test_torch_port_vision.py's bounds); `tensor_stats` rows key for key
  and dtype for dtype, their numbers at the same bounds; `names=` and the
  truncation warning.
- `trace(dir)` writes a `*.pt.trace.json` holding one `<OpType>.<node>`
  range per emitted node, each `oriet::` kernel op inside a QLinearConv
  range; with no profiler active no range is entered.
- ORIET_COMPILE_CACHE moves the kernel build target, read at build time,
  and a library already in the cache is reused without nvcc.
- The CLI: `run --dump-stats --dump-tensors` and `profile` print the JAX
  CLI's rows and JSON keys (`profile` adds `forwards`: it traces eager
  forwards).
"""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import cli as j_cli
from onnx_rusty_inference_engine_tpu.debug import (
    dump_intermediates as j_dump, tensor_stats as j_stats)
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models.squeezenet import (
    build_squeezenet)
from onnx_rusty_inference_engine_tpu.quant import (
    calibrate as j_calibrate, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch import cli as t_cli
from onnx_rusty_inference_engine_tpu_torch.debug import (
    dump_intermediates, tensor_stats)
from onnx_rusty_inference_engine_tpu_torch.engine import Engine, node_label
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import _build
from onnx_rusty_inference_engine_tpu_torch.quant import quantize_graph
from onnx_rusty_inference_engine_tpu_torch.utils.profiling import trace
from torch_port_util import to_port


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph) of SqueezeNet 1.0 fp32 and INT8 (the same
    calibration ranges for both), and the feed."""
    m = build_squeezenet()
    jg, tg = j_import(m), to_port(m)
    x = np.random.default_rng(1).standard_normal((2, 3, 64, 64))
    feed = {"data_0": x.astype(np.float32)}
    ranges = j_calibrate(jg, [feed])
    return {"fp32": (jg, tg),
            "int8": (j_quantize(jg, ranges=ranges),
                     quantize_graph(tg, ranges=ranges))}, feed


def _close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=1e-4,
        atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_dump_intermediates_matches_jax(graphs, precision):
    (jg, tg), feed = graphs[0][precision], graphs[1]
    want = {k: np.asarray(v) for k, v in j_dump(jg, feed).items()}
    got = dump_intermediates(tg, feed, device="cpu")
    assert sorted(got) == sorted(want)
    n_int = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=name)
            n_int += 1
        else:
            _close(g, w)
    assert n_int == (0 if precision == "fp32" else 64)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_tensor_stats_rows_match_jax(graphs, precision):
    (jg, tg), feed = graphs[0][precision], graphs[1]
    want = {r["name"]: r for r in j_stats(
        {k: np.asarray(v) for k, v in j_dump(jg, feed).items()})}
    got = {r["name"]: r for r in tensor_stats(
        dump_intermediates(tg, feed, device="cpu"))}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert sorted(g) == sorted(w), name
        assert (g["shape"], g["dtype"]) == (w["shape"], w["dtype"]), name
        for key in ("min", "max", "mean"):
            _close(np.float64(g[key]), np.float64(w[key]))
        assert g.get("nonfinite") == w.get("nonfinite"), name


def test_dump_names_and_truncation(graphs, caplog):
    (_, tg), feed = graphs[0]["int8"], graphs[1]
    full = dump_intermediates(tg, feed, device="cpu")
    names = ["conv1_1", "softmaxout_1"]
    some = dump_intermediates(tg, feed, names, device="cpu")
    assert list(some) == names
    for k in names:
        np.testing.assert_array_equal(some[k], full[k])
    with caplog.at_level(logging.WARNING):
        first = dump_intermediates(tg, feed, device="cpu", max_tensors=3)
    assert list(first) == list(full)[:3]
    assert f"truncated to first 3 of {len(full)}" in caplog.text


def _trace_events(log_dir):
    (path,) = glob.glob(f"{log_dir}/*.pt.trace.json")
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_holds_a_range_per_node(graphs, tmp_path):
    (_, tg), feed = graphs[0]["int8"], graphs[1]
    eng = Engine(tg, device="cpu")
    dev = {"data_0": torch.from_numpy(feed["data_0"])}
    with torch.no_grad():
        eng.forward(dev)
        with trace(str(tmp_path)):
            eng.forward(dev)
    events = [e for e in _trace_events(tmp_path) if e.get("ph") == "X"]
    names = {e["name"] for e in events}
    emitted = [n for n in tg.nodes if n.op_type not in ("Shape", "Size")]
    for node in emitted:
        assert node_label(node) in names, node_label(node)
    qconv = [e for e in events if e["name"].startswith("QLinearConv.")]
    ops = [e for e in events if e["name"] == "oriet::qconv_int8_requant"]
    assert len(qconv) == len(ops) == 26
    for op in ops:  # each kernel op inside its node's range
        assert any(r["ts"] <= op["ts"]
                   and op["ts"] + op["dur"] <= r["ts"] + r["dur"]
                   and r["tid"] == op["tid"] for r in qconv), op


def test_no_range_without_a_profiler(graphs, monkeypatch):
    (_, tg), feed = graphs[0]["fp32"], graphs[1]
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = Engine(tg, device="cpu")
    eng(feed)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng(feed)
    assert entered == [node_label(n) for n in tg.nodes]


def test_compile_cache_moves_the_build_target(monkeypatch, tmp_path):
    monkeypatch.delenv(_build.CACHE_ENV, raising=False)
    default = _build._target("qconv_int8")
    assert default.startswith(_build.BUILD_DIR + "/qconv_int8-")
    monkeypatch.setenv(_build.CACHE_ENV, str(tmp_path))
    cached = _build._target("qconv_int8")
    assert cached == default.replace(_build.BUILD_DIR,
                                     str(tmp_path / "kernels"))
    # a library already in the cache is reused: no nvcc is asked for
    os.makedirs(os.path.dirname(cached))
    open(cached, "wb").close()
    monkeypatch.setattr(_build, "_BUILT", {})
    monkeypatch.setattr(_build, "nvcc", lambda: pytest.fail("nvcc called"))
    info = _build.build_all(["qconv_int8"])["qconv_int8"]
    assert info.path == cached and info.log == ""


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """SqueezeNet 1.0 written by the port's builder and a 64x64 input."""
    from onnx_rusty_inference_engine_tpu_torch import onnx_io
    from onnx_rusty_inference_engine_tpu_torch.models import (
        build_squeezenet as t_build)

    d = tmp_path_factory.mktemp("cli_debug")
    onnx_io.save_model(str(d / "sq.onnx"), t_build())
    x = np.random.default_rng(5).standard_normal((1, 3, 64, 64))
    onnx_io.write_tensor_file(str(d / "in.pb"), "data_0",
                              x.astype(np.float32))
    return d


def _main(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_run_dump_stats_and_tensors_match_jax(model_files, capsys,
                                                  tmp_path):
    d = model_files
    argv = ["run", "--model", str(d / "sq.onnx"), "--input",
            str(d / "in.pb"), "--dump-stats"]
    rc_j, _, err_j = _main(j_cli.main, argv + [
        "--dump-tensors", str(tmp_path / "j.npz")], capsys)
    rc_t, out_t, err_t = _main(t_cli.main, argv + [
        "--dump-tensors", str(tmp_path / "t.npz"), "--device", "cpu"],
        capsys)
    assert rc_j == rc_t == 0 and json.loads(out_t)["top1"]

    def rows(err):
        return {r["name"]: r for r in (json.loads(ln) for ln in
                                       err.splitlines()
                                       if ln.startswith("{"))}

    want, got = rows(err_j), rows(err_t)
    assert len(got) == 66 and sorted(got) == sorted(want)
    for name, w in want.items():
        assert sorted(got[name]) == sorted(w), name
        assert got[name]["dtype"] == w["dtype"], name
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for k in jz.files:
            _close(tz[k], jz[k])
    assert f"wrote 66 tensors to {tmp_path / 't.npz'}" in err_t


def test_cli_profile_keys_and_ranges(model_files, capsys, tmp_path):
    d = model_files
    argv = ["profile", "--model", str(d / "sq.onnx"), "--batch", "1",
            "--steps", "2", "--quantize", "int8", "--input",
            str(d / "in.pb")]
    rc_j, out_j, _ = _main(j_cli.main, argv + [
        "--trace-dir", str(tmp_path / "j")], capsys)
    rc_t, out_t, _ = _main(t_cli.main, argv + [
        "--trace-dir", str(tmp_path / "t"), "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    want, got = json.loads(out_j), json.loads(out_t)
    assert sorted(got) == sorted(set(want) | {"forwards"})
    assert got["steps"] == 2 and got["forwards"].startswith("eager")
    events = _trace_events(tmp_path / "t")
    qconv = [e for e in events if e.get("ph") == "X"
             and e["name"].startswith("QLinearConv.")]
    assert len(qconv) == 26 * 2

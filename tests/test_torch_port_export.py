"""The port's deployment surface on the CPU (export_aot.py, the kernel ops,
the CLI's export / run-exported), against its own Engine and against the
JAX package's export_aot.

- Every `oriet::` kernel op passes `torch.library.opcheck` (schema, fake
  implementation, dynamic-shape tracing) on its CPU implementation.
- Export -> load -> run for SqueezeNet 1.0 fp32 and INT8 (64x64, b2: the
  smallest input its three stride-2 pools leave a pixel of), BERT TINY
  INT8, GPT-2's INT4-planar, INT8-KV, fused-attention decode step (2
  layers, n_embd 256) and BERT TINY under the bf16 dtype policy: the
  port's artifact equals the port's Engine bit for bit, and JAX's
  export_engine -> load_exported -> run on the same graph and inputs at the
  port tests' own tolerances: int8 outputs exact, float outputs at rtol
  1e-4 with atol 1e-5 x max(1, max|ref|) as test_torch_port_vision.py
  holds them (SqueezeNet INT8's softmax within 1e-3 and BERT INT8's
  outputs within 1e-3 x max|ref|, as test_torch_port_squeezenet.py and
  test_torch_port_bert.py hold the INT8 graphs; GPT-2's int4 logits within
  1e-3, as test_torch_port_gpt2.py; bf16 within 1e-5 x max|ref|, as
  test_torch_port_precision.py). The JAX side runs its Pallas int4 kernel
  in interpret mode (ORIET_KERNELS=pallas), the form the port implements.
- The counterparts of JAX's test_missing_input_raises,
  test_bad_artifact_raises and test_meta_describes_interface; a JAX
  artifact is refused by name; platforms=["cuda"] and loading onto the
  card raise with no card; sharded and host-stage artifacts name their
  ROADMAP items.
- The load contract: with the ONNX parser, the emitter lookup and the
  weight packer patched to raise, an artifact loads and runs; a fresh
  process that loads and runs one imports neither the ONNX codec, the
  graph nor the op registry.
- The CLI: `export` then `run-exported --golden` MATCH on SqueezeNet's
  golden pair, both printing the JAX CLI's JSON keys.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import cli as j_cli
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.export_aot import (
    export_engine as j_export_engine, load_exported as j_load_exported)
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import gpt2 as j_gpt2
from onnx_rusty_inference_engine_tpu.models.bert import (
    TINY as J_BERT_TINY, build_bert as j_build_bert)
from onnx_rusty_inference_engine_tpu.models.squeezenet import (
    build_squeezenet)
from onnx_rusty_inference_engine_tpu.quant import (
    calibrate as j_calibrate, quantize_graph as j_quantize,
    quantize_weights_int4 as j_quantize_int4)
from onnx_rusty_inference_engine_tpu_torch import cli as t_cli
from onnx_rusty_inference_engine_tpu_torch import export_aot, onnx_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.export_aot import (
    ExportedModel, export_engine, export_graph, load_exported)
from onnx_rusty_inference_engine_tpu_torch.quant import (
    quantize_graph, quantize_weights_int4)
from torch_port_opcases import OPS, op_case
from torch_port_util import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "squeezenet.pb")


@pytest.mark.parametrize("name", OPS)
def test_op_passes_opcheck_on_the_cpu(name):
    op, args = op_case(name, "cpu")
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


# --------------------------------------------------------------------------
# the cases: (JAX graph, port graph, feed, dtype, how the JAX run is held)
# --------------------------------------------------------------------------
def _squeezenet(int8: bool):
    m = build_squeezenet()
    jg, tg = j_import(m), to_port(m)
    x = np.random.default_rng(1).standard_normal((2, 3, 64, 64))
    feed = {"data_0": x.astype(np.float32)}
    if int8:
        ranges = j_calibrate(jg, [feed])
        jg, tg = j_quantize(jg, ranges=ranges), quantize_graph(tg,
                                                               ranges=ranges)
    return jg, tg, feed


def _bert_feed(seed=0, B=2, T=12):
    rng = np.random.default_rng(seed)
    keep = rng.integers(4, T + 1, (B, 1))
    return {"input_ids": rng.integers(0, J_BERT_TINY.vocab_size, (B, T)),
            "token_type_ids": rng.integers(0, 2, (B, T)),
            "attention_mask": (np.arange(T)[None] < keep).astype(np.int64)}


def _bert(int8: bool):
    m = j_build_bert(J_BERT_TINY, batch=2, seq_len=12)
    jg, tg = j_import(m), to_port(m)
    if int8:
        ranges = j_calibrate(jg, [_bert_feed(1)])
        jg, tg = j_quantize(jg, ranges=ranges), quantize_graph(tg,
                                                               ranges=ranges)
    return jg, tg, _bert_feed(0)


def _gpt2_step():
    cfg = j_gpt2.GPT2Config(vocab_size=512, n_positions=64, n_embd=256,
                            n_layer=2, n_head=4)
    m = j_gpt2.build_gpt2_decode(cfg, batch=2, max_len=32, kv_dtype="int8",
                                 fused_attention=True)
    rng = np.random.default_rng(0)
    feed = {"input_ids": rng.integers(0, 512, (2, 1)),
            "pos": np.array([5, 9])}
    for i in range(2):
        for kind in ("key", "value"):
            feed[f"past_{kind}_{i}"] = rng.integers(
                -127, 128, (2, 4, 32, 64)).astype(np.int8)
            feed[f"kv_scale_{kind}_{i}"] = (
                rng.random(4) * 0.05 + 0.01).astype(np.float32)
    return (j_quantize_int4(j_import(m)), quantize_weights_int4(to_port(m)),
            feed)


def _float_close(got, want, scale_atol=1e-5):
    np.testing.assert_allclose(
        got, want, rtol=1e-4,
        atol=scale_atol * max(1.0, float(np.abs(want).max())))


def _int8_softmax_close(got, want):
    assert float(np.abs(got - want).max()) <= 1e-3
    assert np.array_equal(got.reshape(len(got), -1).argmax(1),
                          want.reshape(len(want), -1).argmax(1))


def _rel_close(bound):
    def check(got, want):
        err = float(np.abs(got.astype(np.float64) - want).max())
        assert err <= bound * float(np.abs(want).max()), err
    return check


def _abs_close(bound):
    def check(got, want):
        assert float(np.abs(got.astype(np.float64) - want).max()) <= bound
    return check


# case -> (builder, dtype, check of a float output against JAX's)
CASES = {
    "squeezenet_fp32": (lambda: _squeezenet(False), "float32",
                        _float_close),
    "squeezenet_int8": (lambda: _squeezenet(True), "float32",
                        _int8_softmax_close),
    "bert_int8": (lambda: _bert(True), "float32", _rel_close(1e-3)),
    "gpt2_int4_step": (_gpt2_step, "float32", _abs_close(1e-3)),
    "bert_bf16": (lambda: _bert(False), "bfloat16", _rel_close(1e-5)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case, built once: the port Engine's outputs, the port
    artifact's, the JAX artifact's, and the port artifact's path."""
    done = {}
    d = tmp_path_factory.mktemp("aot")

    def get(case):
        if case not in done:
            build, dtype, _ = CASES[case]
            mp = pytest.MonkeyPatch()
            if case == "gpt2_int4_step":  # JAX's int4 kernel, interpreted
                mp.setenv("ORIET_KERNELS", "pallas")
            try:
                jg, tg, feed = build()
                eng = Engine(tg, device="cpu", dtype=dtype)
                want = eng.run(feed).outputs
                path = str(d / f"{case}.oriet.npz")
                export_engine(eng, feed, path)
                got = load_exported(path, device="cpu").run(feed)
                jpath = str(d / f"{case}.jax.npz")
                j_export_engine(JEngine(jg, dtype=dtype), feed, jpath)
                jgot = {k: np.asarray(v).astype(
                    np.float32 if np.asarray(v).dtype.kind == "V"
                    else np.asarray(v).dtype)
                    for k, v in j_load_exported(jpath).run(feed).items()}
            finally:
                mp.undo()
            done[case] = (want, got, jgot, path)
        return done[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_equals_the_engine_bit_for_bit(case, runs):
    want, got, _, _ = runs(case)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v, equal_nan=True), k


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_matches_the_jax_artifact(case, runs):
    _, got, jgot, _ = runs(case)
    check = CASES[case][2]
    assert sorted(got) == sorted(jgot)
    for k, want in jgot.items():
        assert got[k].shape == want.shape, k
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            check(got[k], want)


def test_bf16_weights_ride_uint16(runs):
    path = runs("bert_bf16")[3]
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]))
        assert meta["bf16_params"]
        assert all(z[f"p:{k}"].dtype == np.uint16
                   for k in meta["bf16_params"])
    m = load_exported(path, device="cpu")
    assert any(v.dtype == torch.bfloat16 for v in m.params.values())


def test_weights_are_stored_once(runs):
    """Every weight is a `p:` entry and an input of the program; neither
    the program's example inputs (dropped before saving) nor a constant
    inside it holds a weight's value again."""
    path = runs("bert_int8")[3]
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]))
        weights = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
    assert sorted(weights) == meta["params"]
    m = load_exported(path, device="cpu")
    assert m.program.example_inputs is None
    user = [s for s in m.program.graph_signature.input_specs
            if s.kind.name == "USER_INPUT"]
    assert len(user) == (len(meta["params"]) + len(meta["packed"])
                         + len(meta["inputs"]))
    for name, c in m.program.constants.items():
        if not isinstance(c, torch.Tensor):
            continue
        c = c.numpy()
        for wname, w in weights.items():
            assert not (c.shape == w.shape and c.dtype == w.dtype
                        and np.array_equal(c, w)), (name, wname)


def test_missing_input_raises(runs):
    m = load_exported(runs("squeezenet_fp32")[3], device="cpu")
    with pytest.raises(ValueError, match="missing inputs"):
        m({})


def test_another_shape_than_exported_raises(runs):
    m = load_exported(runs("squeezenet_fp32")[3], device="cpu")
    x = np.zeros((1, 3, 64, 64), np.float32)
    with pytest.raises(ValueError, match="static"):
        m({"data_0": x})


def test_bad_artifact_raises(tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, __meta__=np.frombuffer(b'{"format": "nope"}',
                                          dtype=np.uint8))
    with pytest.raises(ValueError, match="not an oriet AOT artifact"):
        load_exported(path, device="cpu")
    np.savez(path, x=np.zeros(3))
    with pytest.raises(ValueError, match="not an oriet AOT artifact"):
        load_exported(path, device="cpu")


def test_jax_artifact_is_refused_by_name(runs):
    jpath = str(runs("squeezenet_fp32")[3]).replace(".oriet.", ".jax.")
    with pytest.raises(ValueError, match="oriet-aot-v1.*oriet-aot-torch-v1"):
        load_exported(jpath, device="cpu")


@pytest.mark.parametrize("meta,item", [({"nr_devices": 8}, "1.12"),
                                       ({"host_prolog": {}}, "1.7")],
                         ids=["meta0-1.12", "meta1-1.7"])
def test_unported_artifacts_name_their_roadmap_item(tmp_path, meta, item):
    """Sharded artifacts (ROADMAP 1.12) and host stages (1.7) are ported.
    An artifact exported for 8 devices needs a world of 8 ranks: in a
    world of one it is refused, as the JAX package refuses it (loaded on
    its mesh: test_torch_port_distributed.py). A host-prolog meta is read,
    and an artifact that names a prolog but lacks its stage is refused as
    malformed, naming the stage, not a roadmap item."""
    path = str(tmp_path / "a.npz")
    body = dict({"format": export_aot.FORMAT, "platforms": ["cpu"]}, **meta)
    np.savez(path, __meta__=np.frombuffer(json.dumps(body).encode(),
                                          dtype=np.uint8))
    if item == "1.7":
        with pytest.raises(ValueError, match="no __prolog__ stage"):
            load_exported(path, device="cpu")
        return
    with pytest.raises(ValueError,
                       match="exported for 8 devices; only 1 available"):
        load_exported(path, device="cpu")


def test_meta_describes_interface(runs):
    path = runs("squeezenet_fp32")[3]
    m = load_exported(path, device="cpu")
    (name,) = m.input_specs
    assert m.input_specs[name]["shape"] == [2, 3, 64, 64]
    assert m.input_specs[name]["dtype"] == "float32"
    assert m.outputs == ["softmaxout_1"]
    assert m.platforms == ["cpu"]
    assert m.meta["format"] == "oriet-aot-torch-v1"
    assert m.meta["graph_name"] == "squeezenet1.0"
    assert isinstance(m, ExportedModel)


def test_the_card_is_the_default_and_raises_without_one(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(runs("squeezenet_fp32")[3])
    jg, tg, feed = _squeezenet(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_engine(Engine(tg, device="cpu"), feed,
                      str(tmp_path / "c.npz"), platforms=["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_graph(tg, feed, str(tmp_path / "c.npz"))
    with pytest.raises(ValueError, match="platform 'tpu'"):
        export_engine(Engine(tg, device="cpu"), feed,
                      str(tmp_path / "c.npz"), platforms=["tpu"])


def test_load_runs_with_the_importer_patched_to_raise(runs, monkeypatch):
    from onnx_rusty_inference_engine_tpu_torch import weights
    from onnx_rusty_inference_engine_tpu_torch.ops import registry

    def boom(*a, **k):
        raise AssertionError("loading an artifact reached the importer")

    monkeypatch.setattr(onnx_io, "parse_model", boom)
    monkeypatch.setattr(registry, "get_emitter", boom)
    monkeypatch.setattr(weights, "prepack_int8_weights", boom)
    want, _, _, path = runs("squeezenet_int8")
    got = load_exported(path, device="cpu").run(
        {"data_0": np.random.default_rng(1).standard_normal(
            (2, 3, 64, 64)).astype(np.float32)})
    assert np.array_equal(got["softmaxout_1"], want["softmaxout_1"])


def test_a_fresh_process_loads_without_the_importer(runs, tmp_path):
    """The child loads and runs the INT8 artifact, then asserts from
    sys.modules that neither the ONNX codec, the graph nor the op registry
    was imported."""
    want, _, _, path = runs("squeezenet_int8")
    out = str(tmp_path / "out.npy")
    code = (
        "import sys, numpy as np\n"
        "from onnx_rusty_inference_engine_tpu_torch.export_aot import "
        "load_exported\n"
        f"m = load_exported({path!r}, device='cpu')\n"
        "x = np.random.default_rng(1).standard_normal((2, 3, 64, 64))\n"
        "y = m.run({'data_0': x.astype(np.float32)})['softmaxout_1']\n"
        f"np.save({out!r}, y)\n"
        "P = 'onnx_rusty_inference_engine_tpu_torch.'\n"
        "bad = [P + n for n in ('onnx_io', 'graph', 'ops.registry', "
        "'engine', 'weights') if P + n in sys.modules]\n"
        "assert not bad, bad\n"
        "assert not any(n.startswith('jax') for n in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert np.array_equal(np.load(out), want["softmaxout_1"])


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    """SqueezeNet 1.0 written by the port's builder, its golden input (as
    test_regression_goldens.py::_cases draws it) and output as .pb."""
    from onnx_rusty_inference_engine_tpu_torch.models import (
        build_squeezenet as t_build)

    d = tmp_path_factory.mktemp("cli_aot")
    onnx_io.save_model(str(d / "sq.onnx"), t_build())
    rng = np.random.default_rng(123)
    rng.standard_normal((1, 3, 64, 64))
    rng.standard_normal((1, 3, 96, 96))
    rng.integers(0, 128, (1, 8))
    x = rng.standard_normal((1, 3, 224, 224)).astype(np.float32)
    onnx_io.write_tensor_file(str(d / "in.pb"), "data_0", x)
    golden = onnx_io.read_tensor_file(GOLDEN)
    onnx_io.write_tensor_file(str(d / "out.pb"), golden.name, golden.array)
    return d


def _main(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_export_then_run_exported_golden(golden_files, capsys, tmp_path):
    """`export` then `run-exported --golden` MATCH; the JSON keys of both
    equal the JAX CLI's."""
    d = golden_files
    common = ["--model", str(d / "sq.onnx"), "--input", str(d / "in.pb")]
    rc_j, out_j, _ = _main(j_cli.main, ["export", *common, "--out",
                                        str(tmp_path / "j.npz")], capsys)
    rc_t, out_t, _ = _main(t_cli.main, ["export", *common, "--out",
                                        str(tmp_path / "t.npz"),
                                        "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    want, got = json.loads(out_j), json.loads(out_t)
    assert sorted(got) == sorted(want)
    assert got["inputs"] == want["inputs"] == {"data_0": [1, 3, 224, 224]}
    assert got["platforms"] == ["cpu"]
    run = ["--input", str(d / "in.pb"), "--golden", str(d / "out.pb"),
           "--rtol", "1e-3", "--atol", "1e-3"]
    rc_j, out_j, _ = _main(j_cli.main, ["run-exported", "--artifact",
                                        str(tmp_path / "j.npz"), *run],
                           capsys)
    rc_t, out_t, _ = _main(t_cli.main, ["run-exported", "--artifact",
                                        str(tmp_path / "t.npz"), *run,
                                        "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert out_t.strip().splitlines()[-1].startswith("golden: MATCH")
    want = json.loads(out_j[:out_j.rindex("golden:")])
    got = json.loads(out_t[:out_t.rindex("golden:")])
    assert sorted(got) == sorted(want)
    assert got["output_shapes"] == want["output_shapes"]


def test_cli_export_int8_for_the_cpu(golden_files, capsys, tmp_path):
    """`export --quantize int8` (calibrated on --input) writes int8
    weights and runs back through `run-exported`."""
    d = golden_files
    art = str(tmp_path / "q.npz")
    rc, out, _ = _main(t_cli.main, [
        "export", "--model", str(d / "sq.onnx"), "--input",
        str(d / "in.pb"), "--out", art, "--quantize", "int8",
        "--platforms", "cpu", "--device", "cpu"], capsys)
    assert rc == 0 and json.loads(out)["bytes"] == os.path.getsize(art)
    with np.load(art) as z:
        assert any(z[k].dtype == np.int8 for k in z.files
                   if k.startswith("p:"))
    rc, out, _ = _main(t_cli.main, ["run-exported", "--artifact", art,
                                    "--input", str(d / "in.pb"),
                                    "--device", "cpu"], capsys)
    assert rc == 0
    body = json.loads(out)
    golden = onnx_io.read_tensor_file(str(d / "out.pb")).array
    assert np.isfinite(body["outputs"]["softmaxout_1"]).all()
    assert body["output_shapes"] == {"softmaxout_1": list(golden.shape)}

"""The port's product surface on the CPU: `onnx_make_inference` (api.py),
the CLI (cli.py, `python -m onnx_rusty_inference_engine_tpu_torch.cli`) and
the HTTP front ends (http_serve.py), against the JAX package's.

- onnx_make_inference(device="cpu") on ResNet-50 (64x64) written to a file
  with its golden input and output (tests/goldens/resnet50.pb) as .pb
  files: golden_match at the golden test's tolerance (rtol = atol = 1e-3).
- Each ported subcommand with --device cpu: `run` prints the golden MATCH
  line and exits 0; `bench`, `inspect` and `quantize` print JSON with the
  JAX CLI's keys (and, for inspect and quantize, its values); `generate`
  prints the JAX CLI's tokens; `bench --batch N` feeds N examples a
  forward also where the file declares a static batch of 1 (the JAX CLI
  feeds 1 and reports N); the precision flags (--dtype bfloat16,
  --quantize w8a8, --prefill-dtype) give the JAX CLI's output (floats
  within 1e-5 x max under bf16, and `run --dtype bfloat16` parting from
  the port's fp32 `run` by at least half what JAX's bf16 run parts from
  its fp32 one; 1e-4 under W8A8's fp32 Engine; tokens
  equal; `serve` and `serve-llm` through the server each CLI builds, one
  request); every flag that exited 2 while the port lacked its machinery
  (the model families, the LoRA bank, beam search, speculative decoding
  and serving) gives the JAX CLI's output; without --device the CLI asks
  for the card,
  and raises where there is none.
- serve_http and serve_generate_http on port 0, one request each: the
  response equals the JAX server's on the same tiny model (ViT TINY logits
  within 1e-4, as tests/test_http_serve.py holds its MNIST; GPT-2 TINY
  greedy tokens equal), and a malformed request answers 400.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import cli as j_cli
from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.http_serve import (
    serve_generate_http as j_serve_generate_http, serve_http as j_serve_http)
from onnx_rusty_inference_engine_tpu.models.gpt2 import TINY as J_GPT_TINY
from onnx_rusty_inference_engine_tpu.models.vit import (
    TINY as J_VIT_TINY, build_vit)
from onnx_rusty_inference_engine_tpu.serve_llm import (
    DecodeServer as JDecodeServer)
from onnx_rusty_inference_engine_tpu_torch import cli as t_cli
from onnx_rusty_inference_engine_tpu_torch import onnx_make_inference
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.graph import import_onnx
from onnx_rusty_inference_engine_tpu_torch.http_serve import (
    serve_generate_http, serve_http)
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import TINY
from onnx_rusty_inference_engine_tpu_torch.models.resnet import (
    build_resnet50)
from onnx_rusty_inference_engine_tpu_torch.serving import DecodeServer
from torch_port_util import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "resnet50.pb")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """ResNet-50 and ViT TINY as .onnx files; ResNet-50's golden input (as
    test_regression_goldens.py::_cases draws it) and output as .pb."""
    d = tmp_path_factory.mktemp("cli")
    from onnx_rusty_inference_engine_tpu_torch import onnx_io

    onnx_io.save_model(str(d / "resnet50.onnx"), build_resnet50())
    j_io.save_model(str(d / "vit.onnx"), build_vit(J_VIT_TINY, batch=1))
    x = np.random.default_rng(123).standard_normal((1, 3, 64, 64))
    onnx_io.write_tensor_file(str(d / "in.pb"), "data", x.astype(np.float32))
    golden = onnx_io.read_tensor_file(GOLDEN)
    onnx_io.write_tensor_file(str(d / "out.pb"), golden.name, golden.array)
    return d


def test_onnx_make_inference_golden_on_cpu(files):
    rep = onnx_make_inference(str(files / "resnet50.onnx"),
                              str(files / "in.pb"), str(files / "out.pb"),
                              rtol=1e-3, atol=1e-3, device="cpu")
    assert rep["golden_match"] is True
    assert rep["max_abs_err"] < 1e-2
    assert rep["outputs"]["logits"].shape == (1, 1000)
    assert rep["top1"].shape == (1,)


def _main(main, argv, capsys):
    """(exit code, stdout, stderr) of one CLI call in this process."""
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_run_golden_match(files, capsys):
    rc, out, _ = _main(t_cli.main, [
        "run", "--model", str(files / "resnet50.onnx"), "--input",
        str(files / "in.pb"), "--golden", str(files / "out.pb"), "--rtol",
        "1e-3", "--atol", "1e-3", "--device", "cpu"], capsys)
    assert rc == 0
    assert out.strip().splitlines()[-1].startswith("golden: MATCH")
    body = json.loads(out[:out.rindex("golden:")])
    assert body["output_shapes"] == {"logits": [1, 1000]}


@pytest.mark.parametrize("cmd", ["inspect", "bench", "quantize"])
def test_cli_json_keys_match_jax(cmd, files, capsys, tmp_path):
    model = str(files / "vit.onnx")
    args = {"inspect": ["inspect", "--model", model],
            "bench": ["bench", "--model", model, "--batch", "1",
                      "--steps", "2"],
            "quantize": ["quantize", "--model", model, "--calib-input",
                         str(files / "vit_in.pb")]}[cmd]
    if cmd == "quantize":
        x = np.random.default_rng(2).standard_normal(
            (1, 3, J_VIT_TINY.image_size, J_VIT_TINY.image_size))
        j_io.write_tensor_file(str(files / "vit_in.pb"), "pixel_values",
                               x.astype(np.float32))
    j_args = args + (["--out", str(tmp_path / "j.onnx")]
                     if cmd == "quantize" else [])
    t_args = args + (["--out", str(tmp_path / "t.onnx")]
                     if cmd == "quantize" else [])
    t_args += [] if cmd == "inspect" else ["--device", "cpu"]
    rc_j, out_j, _ = _main(j_cli.main, j_args, capsys)
    rc_t, out_t, _ = _main(t_cli.main, t_args, capsys)
    assert rc_j == rc_t == 0
    want, got = json.loads(out_j), json.loads(out_t)
    assert sorted(got) == sorted(want)
    if cmd == "inspect":
        assert got == want
        assert got["unsupported_ops"] == []
    if cmd == "quantize":
        assert {k: v for k, v in got.items() if k != "out"} == \
            {k: v for k, v in want.items() if k != "out"}
    if cmd == "bench":
        assert got["device"] == "cpu" and got["images_per_sec"] > 0


@pytest.mark.parametrize("flags", [["--calibration", "mse"],
                                   ["--bias-correct"],
                                   ["--calibration", "mse", "--bias-correct"]],
                         ids=["mse", "bias_correct", "mse_bias_correct"])
def test_cli_quantize_mse_and_bias_correct_match_jax(flags, files, capsys,
                                                     tmp_path):
    """`quantize --calibration mse` and `--bias-correct`, once refused with
    exit 2 (ROADMAP 1.4), write the JAX CLI's graph: the same JSON, the
    same nodes, the int8 weights equal, the scales within 1e-5 (the two
    packages' f32 LayerNorms part by an ulp, and a range with them) and
    the int32 biases, corrected or not, within 1 of JAX's."""
    model = str(files / "vit.onnx")
    x = np.random.default_rng(3).standard_normal(
        (1, 3, J_VIT_TINY.image_size, J_VIT_TINY.image_size))
    j_io.write_tensor_file(str(tmp_path / "in.pb"), "pixel_values",
                           x.astype(np.float32))
    args = ["quantize", "--model", model, "--calib-input",
            str(tmp_path / "in.pb"), *flags]
    rc_j, out_j, _ = _main(j_cli.main, args + ["--out", str(tmp_path / "j")],
                           capsys)
    rc_t, out_t, _ = _main(t_cli.main, args + ["--out", str(tmp_path / "t"),
                                               "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    want, got = json.loads(out_j), json.loads(out_t)
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in want.items() if k != "out"}
    jg, tg = import_onnx(str(tmp_path / "j")), import_onnx(str(tmp_path / "t"))
    assert [(n.op_type, n.inputs) for n in tg.nodes] == \
        [(n.op_type, n.inputs) for n in jg.nodes]
    assert sorted(tg.constants) == sorted(jg.constants)
    for k, v in jg.constants.items():
        got_k = tg.constants[k]
        assert got_k.dtype == v.dtype and got_k.shape == v.shape, k
        if v.dtype == np.float32:
            np.testing.assert_allclose(got_k, v, rtol=1e-5, err_msg=k)
        elif v.dtype == np.int32:
            d = np.abs(got_k.astype(np.int64) - v.astype(np.int64))
            assert d.max(initial=0) <= 1, k
        else:
            np.testing.assert_array_equal(got_k, v, err_msg=k)


def test_cli_bench_runs_at_the_requested_batch(files, capsys, monkeypatch):
    """ResNet-50 declares a static batch of 1: `bench --batch 2` still
    feeds 2 images a forward (the JAX CLI feeds 1 and reports 2)."""
    seen = []

    def throughput(engine, feed, steps):
        seen.append(tuple(next(iter(feed.values())).shape))
        return 1.0, "cpu"

    monkeypatch.setattr(t_cli, "_throughput", throughput)
    rc, out, _ = _main(t_cli.main, [
        "bench", "--model", str(files / "resnet50.onnx"), "--batch", "2",
        "--steps", "1", "--device", "cpu"], capsys)
    assert rc == 0 and seen == [(2, 3, 224, 224)]
    assert json.loads(out)["batch"] == 2


def test_cli_bench_int8_on_cpu(files, capsys):
    rc, out, _ = _main(t_cli.main, [
        "bench", "--model", str(files / "vit.onnx"), "--batch", "1",
        "--steps", "2", "--quantize", "int8", "--device", "cpu"], capsys)
    assert rc == 0 and json.loads(out)["quantize"] == "int8"


def test_cli_generate_matches_jax(capsys):
    args = ["generate", "--new", "4"]
    rc_j, out_j, _ = _main(j_cli.main, args, capsys)
    rc_t, out_t, _ = _main(t_cli.main, args + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert json.loads(out_t) == json.loads(out_j)


# the flags that exited 2 until bf16 and W8A8 were ported: each now runs
# and gives the JAX CLI's output
PRECISION_FLAGS = [
    ["run", "--dtype", "bfloat16"],
    ["run", "--quantize", "w8a8"],
    ["bench", "--dtype", "bfloat16"],
    ["bench", "--quantize", "w8a8"],
    ["serve", "--quantize", "w8a8"],
    ["generate", "--prefill-dtype", "bfloat16"],
    ["serve-llm", "--prefill-dtype", "w8a8"],
]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got, want, tol) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= tol * float(
        np.abs(want).max())


def _served(main, argv, capsys, monkeypatch, module):
    """What the CLI's `serve` / `serve-llm` builds, handed to a stand-in
    for the blocking HTTP loop, which answers one request: ViT logits, or
    a GPT-2 greedy continuation."""
    got = {}

    def infer(engine, port=0, **kw):
        x = np.random.default_rng(4).standard_normal(
            (1, 3, J_VIT_TINY.image_size, J_VIT_TINY.image_size))
        got["y"] = np.asarray(next(iter(engine.run(
            {engine.graph.input_names[0]: x.astype(np.float32)}
        ).outputs.values())))

    def generate(srv, port=0, **kw):
        try:
            got["y"] = [int(t) for t in srv.submit(
                np.array([3, 1, 4, 1], np.int64), 4).result(timeout=300)]
        finally:
            srv.stop()

    monkeypatch.setattr(module, "serve_http", infer)
    monkeypatch.setattr(module, "serve_generate_http", generate)
    rc, _, _ = _main(main, argv, capsys)
    return rc, got["y"]


@pytest.mark.parametrize("argv", PRECISION_FLAGS,
                         ids=[" ".join(a) for a in PRECISION_FLAGS])
def test_cli_precision_flag_matches_jax(argv, files, capsys, monkeypatch):
    from onnx_rusty_inference_engine_tpu import http_serve as j_http
    from onnx_rusty_inference_engine_tpu_torch import http_serve as t_http

    cmd, rest = argv[0], argv[1:]
    model = str(files / "vit.onnx")
    x = np.random.default_rng(2).standard_normal(
        (1, 3, J_VIT_TINY.image_size, J_VIT_TINY.image_size))
    j_io.write_tensor_file(str(files / "vit_run.pb"), "pixel_values",
                           x.astype(np.float32))
    if cmd == "run":
        rest = ["--model", model, "--input", str(files / "vit_run.pb")] + rest
    elif cmd == "bench":
        rest = ["--model", model, "--batch", "1", "--steps", "2"] + rest
    elif cmd == "serve":
        rest = ["--model", model, "--port", "0"] + rest
    elif cmd == "serve-llm":
        rest = ["--port", "0", "--slots", "2", "--prompt-len", "8",
                "--max-len", "24"] + rest
    t_rest = rest + ["--device", "cpu"]
    tol = 1e-5 if "bfloat16" in argv else 1e-4
    if cmd in ("serve", "serve-llm"):
        rc_j, want = _served(j_cli.main, [cmd] + rest, capsys, monkeypatch,
                             j_http)
        rc_t, got = _served(t_cli.main, [cmd] + t_rest, capsys, monkeypatch,
                            t_http)
        assert rc_j == rc_t == 0
        assert (got == want) if cmd == "serve-llm" else _close(got, want,
                                                               tol)
        return
    rc_j, out_j, _ = _main(j_cli.main, [cmd] + rest, capsys)
    rc_t, out_t, _ = _main(t_cli.main, [cmd] + t_rest, capsys)
    assert rc_j == rc_t == 0
    want, got = json.loads(out_j), json.loads(out_t)
    assert sorted(got) == sorted(want)
    if cmd == "run":
        assert got["output_shapes"] == want["output_shapes"]
        assert got["top1"] == want["top1"]
        for k, v in want["outputs"].items():
            assert _close(got["outputs"][k], v, tol), k
        if "bfloat16" in argv:  # the policy moves the output as JAX's
            rest32 = [a for a in rest if a not in ("--dtype", "bfloat16")]
            _, j32, _ = _main(j_cli.main, [cmd] + rest32, capsys)
            _, t32, _ = _main(t_cli.main, [cmd] + rest32 + ["--device",
                                                            "cpu"], capsys)
            j32, t32 = json.loads(j32)["outputs"], json.loads(t32)["outputs"]
            for k, v in want["outputs"].items():
                moved = _rel(v, j32[k])
                assert moved > 1e-3, k
                assert _rel(got["outputs"][k], t32[k]) >= 0.5 * moved, k
    elif cmd == "bench":
        assert got["quantize"] == want["quantize"]
        assert got["device"] == "cpu" and got["images_per_sec"] > 0
    else:
        assert got == want


# the flags whose machinery the port lacked, with the ROADMAP item each
# named; None: the flags of the model families, the LoRA bank, the MoE
# server, beam search and speculative decoding and serving, which exited 2
# until those were ported and now run and give the JAX CLI's output
UNPORTED = [
    (["generate", "--draft-layers", "1"], None),
    (["generate", "--family", "moe"], None),
    (["generate", "--family", "t5"], None),
    (["generate", "--beam", "2"], None),
    (["generate", "--family", "t5", "--beam", "2"], None),
    (["generate", "--adapters", "2"], None),
    (["generate", "--adapter", "2"], None),
    (["generate", "--lora-rank", "4"], None),
    (["generate", "--spec-k", "2"], None),
    (["serve-llm", "--spec-k", "8"], None),
    (["serve-llm", "--draft-layers", "1"], None),
    (["serve-llm", "--family", "moe"], None),
]


def _ported_flag_matches_jax(argv, capsys, monkeypatch):
    """A flag that now runs: the port's CLI on the CPU prints the JAX
    CLI's JSON (`generate`), or serves the JAX server's greedy tokens
    (`serve-llm`)."""
    from onnx_rusty_inference_engine_tpu import http_serve as j_http
    from onnx_rusty_inference_engine_tpu_torch import http_serve as t_http

    if argv[0] == "serve-llm":
        rest = ["--port", "0", "--slots", "2", "--prompt-len", "8",
                "--max-len", "24"] + argv[1:]
        rc_j, want = _served(j_cli.main, ["serve-llm"] + rest, capsys,
                             monkeypatch, j_http)
        rc_t, got = _served(t_cli.main, ["serve-llm"] + rest
                            + ["--device", "cpu"], capsys, monkeypatch,
                            t_http)
        assert rc_j == rc_t == 0 and got == want
        return
    rc_j, out_j, _ = _main(j_cli.main, argv + ["--new", "5"], capsys)
    rc_t, out_t, _ = _main(t_cli.main, argv + ["--new", "5", "--device",
                                               "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert json.loads(out_t) == json.loads(out_j)


@pytest.mark.parametrize("argv,item", UNPORTED,
                         ids=[" ".join(a) for a in [a for a, _ in UNPORTED]])
def test_cli_unported_flag_exits_2(argv, item, capsys, monkeypatch):
    """Each flag that exited 2 while its machinery was missing now runs
    and gives the JAX CLI's output; no flag is left unported."""
    assert item is None
    _ported_flag_matches_jax(argv, capsys, monkeypatch)


FAMILY_FLAGS = [
    ["generate", "--family", "asr"],
    ["generate", "--family", "t5", "--kv-dtype", "int8", "--int4"],
    ["generate", "--family", "moe", "--kv-dtype", "int8", "--int4"],
    ["generate", "--adapters", "2", "--adapter", "1"],
    ["generate", "--adapters", "3", "--adapter", "2", "--lora-rank", "4",
     "--family", "moe"],
    ["generate", "--family", "llama", "--adapters", "2", "--adapter", "1"],
]


@pytest.mark.parametrize("argv", FAMILY_FLAGS,
                         ids=[" ".join(a) for a in FAMILY_FLAGS])
def test_cli_family_and_adapter_flags_match_jax(argv, capsys, monkeypatch):
    _ported_flag_matches_jax(argv, capsys, monkeypatch)


def test_cli_int4_kv_refused_beyond_gpt2_and_llama(capsys):
    for cli in (j_cli, t_cli):
        rc, out, err = _main(cli.main, ["generate", "--family", "moe",
                                        "--kv-dtype", "int4", "--device",
                                        "cpu"][: 5 if cli is j_cli else 7],
                             capsys)
        assert rc == 2 and out == "" and "nibble-packing" in err


def test_cli_speculative_serving_refuses_what_it_would_ignore(capsys):
    """serve-llm --draft-layers is fp32 with no prompt cache: both CLIs
    refuse the flags the SpeculativeServer would ignore, before building
    anything."""
    argv = ["serve-llm", "--port", "0", "--draft-layers", "1", "--int4",
            "--kv-dtype", "int8", "--prompt-cache", "2"]
    got = [_main(cli.main, argv + extra, capsys)
           for cli, extra in ((j_cli, []), (t_cli, ["--device", "cpu"]))]
    assert got[0] == got[1]
    rc, out, err = got[1]
    assert rc == 2 and out == ""
    assert "--kv-dtype, --int4, --prompt-cache not supported" in err


def test_cli_defaults_to_the_card(files):
    """Without --device the CLI runs on the card; where there is none it
    raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["run", "--model", str(files / "vit.onnx"), "--input",
                    str(files / "in.pb")])


def test_cli_module_entry_inspects(files):
    """`python -m onnx_rusty_inference_engine_tpu_torch.cli inspect`."""
    res = subprocess.run(
        [sys.executable, "-m", "onnx_rusty_inference_engine_tpu_torch.cli",
         "inspect", "--model", str(files / "resnet50.onnx")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    body = json.loads(res.stdout)
    assert body["op_histogram"]["Conv"] == 53
    assert body["unsupported_ops"] == []


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, json.loads(r.read())


def test_serve_http_matches_jax_server():
    m = build_vit(J_VIT_TINY, batch=1)
    x = np.random.default_rng(4).standard_normal(
        (1, 3, J_VIT_TINY.image_size, J_VIT_TINY.image_size)).astype(
            np.float32)
    resp = {}
    for name, engine, serve in (
            ("jax", JEngine(j_import(m)), j_serve_http),
            ("port", Engine(to_port(m), device="cpu"), serve_http)):
        httpd, batcher = serve(engine, port=0, block=False,
                               batch_buckets=(1,))
        try:
            port = httpd.server_address[1]
            assert _get(port, "/healthz") == (200, {"status": "ok"})
            resp[name] = _post(port, "/v1/infer", {"input": x.tolist()})
            status, err = _post(port, "/v1/infer", {"input": [[1, 2, 3]]})
            assert status == 400 and "error" in err
            status, stats = _get(port, "/v1/stats")
            assert status == 200 and stats["requests"] == 1
        finally:
            httpd.shutdown()
            batcher.stop()
    (sj, rj), (st, rt) = resp["jax"], resp["port"]
    assert sj == st == 200
    assert sorted(rt) == sorted(rj) and rt["top1"] == rj["top1"]
    np.testing.assert_allclose(np.asarray(rt["outputs"]["logits"]),
                               np.asarray(rj["outputs"]["logits"]),
                               rtol=1e-4, atol=1e-4)


def test_serve_generate_http_matches_jax_server():
    body = {"prompt_ids": [3, 1, 4, 1], "max_new_tokens": 4}
    resp = {}
    for name, srv, serve in (
            ("jax", JDecodeServer(J_GPT_TINY, slots=2, prompt_len=4,
                                  max_len=12), j_serve_generate_http),
            ("port", DecodeServer(TINY, slots=2, prompt_len=4, max_len=12,
                                  device="cpu"), serve_generate_http)):
        httpd = serve(srv, port=0, block=False)
        try:
            port = httpd.server_address[1]
            resp[name] = _post(port, "/v1/generate", body)
            status, err = _post(port, "/v1/generate", {"prompt_ids": "x"})
            assert status == 400 and "error" in err
            assert _get(port, "/v1/stats")[1]["requests"] == 1
        finally:
            httpd.shutdown()
            srv.stop()
    assert resp["port"] == resp["jax"]
    assert resp["port"][0] == 200 and len(resp["port"][1]["generated_ids"]) \
        == 4

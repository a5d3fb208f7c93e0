"""UNet and the Whisper-style audio encoder through the port on the CPU,
against the JAX package.

- The port's builders give the JAX builders' ONNX bytes, config for config
  and seed for seed (TINY and the full-width configs).
- The TINY forwards equal the JAX Engine's and the pinned goldens
  tests/goldens/unet.pb and audio.pb (rtol = atol = 1e-3, as
  test_regression_goldens.py holds the JAX package), on the goldens'
  inputs; the audio front end's log-mel against the JAX Engine's at
  rtol = 1e-4, atol = 1e-4.
- INT8 UNet through both packages' quantize_graph: the same QLinearConv
  count (2 * depth + 2 + depth), the ConvTransposes left fp32, and every
  int8 activation within 1 LSB of the JAX package's.
- The zoo's unet and audio_encoder entries are the JAX zoo's models.
"""

import os

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.debug import (
    dump_intermediates as j_dump)
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import audio as j_audio
from onnx_rusty_inference_engine_tpu.models import unet as j_unet
from onnx_rusty_inference_engine_tpu.quant import (
    quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.debug import dump_intermediates
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.models import audio, unet
from onnx_rusty_inference_engine_tpu_torch.quant import quantize_graph
from torch_port_util import assert_graphs_equal, to_port

import test_regression_goldens as goldens

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")


@pytest.mark.parametrize("kind,kw", [
    ("unet_tiny", dict(cfg=unet.TINY, batch=2, size=32)),
    ("unet_full", dict(cfg=unet.UNetConfig(), batch=1, size=64, seed=3)),
    ("audio_tiny", dict(cfg=audio.TINY, batch=2, n_samples=1024)),
    ("audio_full", dict(cfg=audio.AudioEncoderConfig(), batch=1,
                        n_samples=16000, seed=5)),
])
def test_builders_give_the_jax_bytes(kind, kw):
    kw = dict(kw)
    if kind.startswith("unet"):
        jkw = dict(kw, cfg=j_unet.UNetConfig(**vars(kw["cfg"])))
        ours, theirs = unet.build_unet(**kw), j_unet.build_unet(**jkw)
    else:
        jkw = dict(kw, cfg=j_audio.AudioEncoderConfig(**vars(kw["cfg"])))
        ours = audio.build_audio_encoder(**kw)
        theirs = j_audio.build_audio_encoder(**jkw)
    assert t_io.serialize_model(ours) == j_io.serialize_model(theirs)
    assert_graphs_equal(j_import(theirs), import_model(ours))


def test_sinusoids_equal():
    np.testing.assert_array_equal(audio._sinusoids(37, 16),
                                  j_audio._sinusoids(37, 16))


def _golden_case(name):
    (c,) = [c for c in goldens._cases() if c[0] == name]
    return c


@pytest.mark.parametrize("name", ["unet", "audio"])
def test_tiny_forward_matches_jax_and_golden(name):
    _, build, feed, out_name = _golden_case(name)
    m = build()
    got = Engine(to_port(m), device="cpu").run(feed).outputs[out_name]
    want = JEngine(j_import(m)).run(feed).outputs[out_name]
    golden = j_io.read_tensor_file(os.path.join(GOLDEN_DIR, f"{name}.pb"))
    assert got.shape == golden.array.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, golden.array, rtol=1e-3, atol=1e-3)


def test_audio_front_end_matches_jax():
    m = j_audio.build_audio_encoder(j_audio.TINY, batch=2, n_samples=1024)
    x = (np.random.default_rng(29).standard_normal((2, 1024)) * 0.1
         ).astype(np.float32)
    names = ["spec", "power", "mel_w", "logmel"]
    got = dump_intermediates(to_port(m), {"audio": x}, names, device="cpu")
    want = j_dump(j_import(m), {"audio": x}, names=names)
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)


def test_unet_int8_matches_jax():
    cfg = unet.TINY
    m = j_unet.build_unet(j_unet.TINY, batch=2, size=32)
    x = np.random.default_rng(131).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    jq = j_quantize(j_import(m), calibration_inputs=[{"image": x}])
    tq = quantize_graph(to_port(m), calibration_inputs=[{"image": x}],
                        device="cpu")
    n_qc = [sum(n.op_type == "QLinearConv" for n in g.nodes)
            for g in (jq, tq)]
    assert n_qc == [2 * cfg.depth + 2 + cfg.depth] * 2
    assert [n.op_type for n in tq.nodes] == [n.op_type for n in jq.nodes]
    assert sum(n.op_type == "ConvTranspose" for n in tq.nodes) == cfg.depth
    names = [o for n in tq.nodes for o in n.outputs
             if n.op_type in ("QuantizeLinear", "QLinearConv")]
    got = dump_intermediates(tq, {"image": x}, names, device="cpu")
    want = j_dump(jq, {"image": x}, names=names)
    for n in names:
        assert got[n].dtype == np.int8, n
        diff = np.abs(got[n].astype(np.int32) - want[n].astype(np.int32))
        assert diff.max() <= 1, (n, diff.max())
    ref = Engine(to_port(m), device="cpu").run({"image": x}).outputs[
        "mask_logits"]
    q = Engine(tq, device="cpu").run({"image": x}).outputs["mask_logits"]
    assert (ref.argmax(1) == q.argmax(1)).mean() > 0.95


def test_zoo_entries_are_the_jax_models(tmp_path, monkeypatch):
    from onnx_rusty_inference_engine_tpu.models import zoo as j_zoo
    from onnx_rusty_inference_engine_tpu_torch.models import zoo

    assert "unet" not in zoo.NOT_PORTED
    assert "audio_encoder" not in zoo.NOT_PORTED
    monkeypatch.setattr(zoo, "_ASSETS", str(tmp_path / "torch"))
    monkeypatch.setattr(j_zoo, "_ASSETS", str(tmp_path / "jax"),
                        raising=False)
    for name, want in (
            ("unet", j_unet.build_unet(j_unet.TINY)),
            ("audio_encoder", j_audio.build_audio_encoder(
                j_audio.TINY, batch=1, n_samples=1024))):
        path = zoo.get_model_path(name)
        assert os.path.dirname(path) == str(tmp_path / "torch")
        with open(path, "rb") as f:
            assert f.read() == j_io.serialize_model(want), name

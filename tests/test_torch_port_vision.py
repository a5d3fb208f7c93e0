"""The vision families through the PyTorch port (on the CPU) against the JAX
package: ResNet-50 at 64x64, MobileNetV2 at 96x96 and ViT TINY at 32x32,
batch 2, fp32 and INT8.

- Builders: the port's copies give the JAX package's model byte for byte
  for the same seed, and both packages import it to the same graph node
  for node (ResNet-50: 53 Conv, 1 Gemm, no BatchNormalization left after
  the import's BN fold).
- fp32: each model matches its golden in tests/goldens/ at the golden
  test's tolerance (rtol = atol = 1e-3), on the input
  test_regression_goldens.py::_cases draws. Every node, run by the port on
  the JAX Engine's values of its inputs, matches JAX's output at rtol =
  1e-4 and atol = 1e-5. The 24 ResNet-50 nodes named in SCALED_ATOL take
  atol = 1e-5 times the tensor's largest magnitude instead: their convs
  reach |values| of 55 to 1,234 and sum up to 4,608 products, so float32's
  rounding of the two frameworks' differently ordered sums reaches up to
  6.7e-4 in absolute terms where a sum cancels to near zero.
- INT8: given the same calibration ranges, both packages' quantize_graph
  build the same graph node for node, with the QLinear node counts of the
  JAX tests (ResNet-50: 53 QLinearConv, 16 QLinearAdd, 1 QLinearMatMul;
  MobileNetV2: 52 QLinearConv of which 17 grouped, 35 int8 Clips,
  1 QLinearMatMul; ViT: 1 QLinearConv and 6 QLinearMatMuls a layer plus the
  head). Each QLinearConv (grouped ones included), QLinearAdd and
  QLinearMatMul, run by the port on JAX's int8 inputs, equals JAX's output
  bit for bit: both sum int8 products exactly and apply the same f32
  epilogue. The whole INT8 model, run free, lies within the JAX tests'
  own bounds of JAX's INT8 output: top-1 equal or max |d| / max |ref| <
  0.1 (tests/test_resnet.py), top-1 equal or max |d| < 0.15
  (tests/test_mobilenet.py), correlation > 0.95 (tests/test_vit.py).
"""

import os

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.debug import dump_intermediates
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import (
    build_mobilenetv2 as j_mobilenet, build_resnet50 as j_resnet)
from onnx_rusty_inference_engine_tpu.models.vit import (
    TINY as J_VIT_TINY, build_vit as j_vit)
from onnx_rusty_inference_engine_tpu.quant import (
    calibrate as j_calibrate, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.models import (
    build_mobilenetv2 as t_mobilenet, build_resnet50 as t_resnet,
    build_vit as t_vit)
from onnx_rusty_inference_engine_tpu_torch.models.vit import (
    TINY as T_VIT_TINY)
from onnx_rusty_inference_engine_tpu_torch.quant import (
    quantize_graph as t_quantize)
from test_torch_port_squeezenet import _teacher_forced
from torch_port_util import assert_graphs_equal, to_port

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens")

# family -> (JAX builder, port builder, input name, image size, output)
FAMILIES = {
    "resnet50": (j_resnet, t_resnet, "data", 64, "logits"),
    "mobilenetv2": (j_mobilenet, t_mobilenet, "input", 96, "output"),
    "vit": (lambda: j_vit(J_VIT_TINY, batch=2),
            lambda: t_vit(T_VIT_TINY, batch=2), "pixel_values", 32,
            "logits"),
}
# the golden graphs: ViT bakes its batch into Reshape constants
GOLDEN_BUILD = {"resnet50": j_resnet, "mobilenetv2": j_mobilenet,
                "vit": lambda: j_vit(J_VIT_TINY, batch=1)}

# the fp32 nodes whose atol scales with their largest magnitude (see the
# module note): ResNet-50's deep conv outputs (BN folded in) and its head
SCALED_ATOL = {
    "resnet50": frozenset(
        ["s1b2_bn1_y", "s1b3_bn2_y", "s2b0_bn1_y", "s2b0_bn2_y",
         "s2b1_bn2_y", "s2b1_bn3_y", "s2b2_bn2_y", "s2b2_bn3_y"]
        + [f"s2b{b}_bn{i}_y" for b in (3, 4, 5) for i in (1, 2, 3)]
        + [f"s3b{b}_bn{i}_y" for b in (0, 1, 2) for i in (1, 2)]
        + ["logits"]),
}

# the QLinear node counts of the JAX tests, by family
INT8_COUNTS = {
    "resnet50": {"QLinearConv": 53, "QLinearAdd": 16, "QLinearMatMul": 1},
    "mobilenetv2": {"QLinearConv": 52, "QLinearAdd": 10,
                    "QLinearMatMul": 1},
    "vit": {"QLinearConv": 1,
            "QLinearMatMul": 6 * J_VIT_TINY.n_layer + 1},
}


def golden_input(name: str) -> np.ndarray:
    """The b1 input test_regression_goldens.py::_cases draws for `name`."""
    rng = np.random.default_rng(123)
    img64 = rng.standard_normal((1, 3, 64, 64)).astype(np.float32)
    img96 = rng.standard_normal((1, 3, 96, 96)).astype(np.float32)
    if name == "resnet50":
        return img64
    if name == "mobilenetv2":
        return img96
    rng.integers(0, 128, (1, 8))
    rng.standard_normal((1, 3, 224, 224))  # squeezenet's
    return rng.standard_normal(
        (1, 3, J_VIT_TINY.image_size, J_VIT_TINY.image_size)
    ).astype(np.float32)


class Family:
    """One family's JAX and port graphs, feed and INT8 graphs, made once."""

    def __init__(self, name: str):
        j_build, t_build, self.input, size, self.output = FAMILIES[name]
        self.name = name
        self.j_model, self.t_model = j_build(), t_build()
        buf = j_io.serialize_model(self.j_model)
        self.jg = j_import(j_io.parse_model(buf))
        self.tg = to_port(self.j_model)
        x = np.random.default_rng(1).standard_normal((2, 3, size, size))
        self.feed = {self.input: x.astype(np.float32)}
        self._int8 = None

    def int8(self):
        """(JAX INT8 graph, port INT8 graph, JAX's INT8 intermediates),
        both quantized with JAX's calibration ranges."""
        if self._int8 is None:
            ranges = j_calibrate(self.jg, [self.feed])
            jq = j_quantize(self.jg, ranges=ranges)
            tq = t_quantize(self.tg, ranges=ranges, device="cpu")
            self._int8 = (jq, tq, dump_intermediates(jq, self.feed))
        return self._int8


@pytest.fixture(scope="module", params=list(FAMILIES))
def fam(request) -> Family:
    return Family(request.param)


def test_builder_gives_jax_model_bit_for_bit(fam):
    assert (t_io.serialize_model(fam.t_model)
            == j_io.serialize_model(fam.j_model))
    assert_graphs_equal(fam.jg, fam.tg)
    ops = {}
    for n in fam.tg.nodes:
        ops[n.op_type] = ops.get(n.op_type, 0) + 1
    assert "BatchNormalization" not in ops
    if fam.name == "resnet50":
        assert ops["Conv"] == 53 and ops["Gemm"] == 1
    if fam.name == "mobilenetv2":
        assert ops["Conv"] == 52 and ops["Clip"] == 35
        assert sum(int(n.attr("group", 1)) > 1 for n in fam.tg.nodes) == 17


def test_fp32_matches_golden(fam):
    golden = j_io.read_tensor_file(
        os.path.join(GOLDENS, f"{fam.name}.pb")).array
    graph = to_port(GOLDEN_BUILD[fam.name]())
    got = Engine(graph, device="cpu").run(
        {fam.input: golden_input(fam.name)})[fam.output]
    assert got.shape == golden.shape
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-3)


def test_fp32_each_node_matches_jax(fam):
    want = dump_intermediates(fam.jg, fam.feed)
    got = _teacher_forced(fam.tg, want)
    assert sorted(got) == sorted(o for n in fam.tg.nodes for o in n.outputs
                                 if o)
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = 1.0
        if name in SCALED_ATOL.get(fam.name, ()):
            scale = float(np.abs(w).max())
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-5 * scale,
            err_msg=f"{name}: max abs err {float(np.abs(g - w).max())}")


def test_same_ranges_give_the_same_int8_graph(fam):
    jq, tq, _ = fam.int8()
    assert_graphs_equal(jq, tq)
    ops = {}
    for n in tq.nodes:
        ops[n.op_type] = ops.get(n.op_type, 0) + 1
    for op, n in INT8_COUNTS[fam.name].items():
        assert ops.get(op, 0) == n, (op, ops)
    if fam.name == "mobilenetv2":
        grouped = [n for n in tq.nodes if n.op_type == "QLinearConv"
                   and int(n.attr("group", 1)) > 1]
        assert len(grouped) == 17
        clips = [n for n in tq.nodes if n.op_type == "Clip"]
        assert len(clips) == 35
        assert all(tq.constants[n.inputs[1]].dtype == np.int8
                   and tq.constants[n.inputs[2]].dtype == np.int8
                   for n in clips)


def test_each_qlinear_node_equals_jax(fam):
    jq, tq, want = fam.int8()
    nodes = [n for n in tq.nodes if n.op_type in INT8_COUNTS[fam.name]]
    assert len(nodes) == sum(INT8_COUNTS[fam.name].values())
    got = _teacher_forced(tq, want)
    for n in nodes:
        g, w = got[n.outputs[0]], want[n.outputs[0]]
        assert g.dtype == w.dtype == np.int8 and g.shape == w.shape
        assert np.array_equal(g, w), (
            f"{n.name}: {int((g != w).sum())} of {g.size} differ, max "
            f"|diff| {int(np.abs(g.astype(int) - w.astype(int)).max())}")


def test_int8_model_within_jax_tests_bounds(fam):
    jq, tq, want = fam.int8()
    ref = want[fam.output]
    got = Engine(tq, device="cpu").run(fam.feed)[fam.output]
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    jax_out = JEngine(jq).run(fam.feed)[fam.output]
    np.testing.assert_array_equal(jax_out, ref)
    top1 = bool((got.argmax(1) == ref.argmax(1)).all())
    if fam.name == "resnet50":
        assert top1 or np.abs(got - ref).max() / np.abs(ref).max() < 0.1
    elif fam.name == "mobilenetv2":
        assert top1 or np.abs(got - ref).max() < 0.15
    else:
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.95


def test_zoo_names_the_port_families(tmp_path, monkeypatch):
    """The port's zoo has the JAX zoo's names; a ported family is
    synthesized under the port's own assets directory, byte for byte the
    JAX builder's model; SqueezeNet is always synthesized there too, and
    the models the repository does not ship raise rather than being looked
    for outside the checkout; no family of the JAX zoo is left unported."""
    from onnx_rusty_inference_engine_tpu.models import zoo as j_zoo
    from onnx_rusty_inference_engine_tpu_torch.models import zoo

    assert sorted(zoo.MODELS) == sorted(j_zoo.MODELS)
    monkeypatch.setattr(zoo, "_ASSETS", str(tmp_path / "torch"))
    path = zoo.get_model_path("vit")
    assert os.path.dirname(path) == str(tmp_path / "torch")
    with open(path, "rb") as f:
        assert f.read() == j_io.serialize_model(j_vit(J_VIT_TINY))
    assert zoo.get_model_path("squeezenet") == str(
        tmp_path / "torch" / "squeezenet1.0-8.synth.onnx")
    for name in zoo.NOT_SHIPPED:
        with pytest.raises(FileNotFoundError, match="not in the repository"):
            zoo.get_model_path(name)
    # t5_encoder, moe and asr_encoder were the families the port lacked:
    # NOT_PORTED is empty, and each synthesizes the JAX builder's bytes
    assert zoo.NOT_PORTED == ()
    from onnx_rusty_inference_engine_tpu.models import asr as j_asr
    from onnx_rusty_inference_engine_tpu.models import moe as j_moe
    from onnx_rusty_inference_engine_tpu.models import t5 as j_t5

    for name, want in (
            ("t5_encoder", j_t5.build_t5_encoder(j_t5.TINY, batch=1,
                                                 src_len=16)),
            ("moe", j_moe.build_moe(j_moe.TINY, batch=1, seq_len=16)),
            ("asr_encoder", j_asr.build_asr_encoder(j_asr.TINY, batch=1,
                                                    n_samples=512))):
        with open(zoo.get_model_path(name), "rb") as f:
            assert f.read() == j_io.serialize_model(want), name
    with pytest.raises(KeyError):
        zoo.get_model_path("no_such_model")

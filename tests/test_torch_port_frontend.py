"""The PyTorch port's front end against the JAX package's: the same ONNX
bytes parse into equal protos and import (topo sort, folding, identity and
dead-code elimination, the optimize passes) into equal graphs; the port's
builders write the same bytes; and importing the port loads no JAX."""

import dataclasses
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models._builder import (
    GraphBuilder as JBuilder)
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.graph import (
    import_model as t_import, import_onnx as t_import_onnx)
from onnx_rusty_inference_engine_tpu_torch.models._builder import (
    GraphBuilder as TBuilder)
from onnx_rusty_inference_engine_tpu_torch.utils.protowire import WireWriter
from torch_port_util import assert_graphs_equal, values_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_model(builder_cls):
    """A few of everything the importer and its passes rewrite: Conv + bias
    Add (fused), Conv -> BatchNormalization (folded), a Shape/Gather/
    Unsqueeze/Concat -> Reshape chain (folded at import), Constant and
    Identity nodes, Dropout (elided), duplicate subexpressions (CSE), an
    unused branch (pruned), and int / float / string / ints / tensor
    attributes."""
    b = builder_cls("small", opset=13, seed=3)
    x = b.input("x", ["N", 4, 8, 8])
    w = b.he("w", (8, 4, 3, 3))
    bias = b.init("bias", b.rng.standard_normal((8, 1, 1)).astype(np.float32))
    c = b.op("Conv", x, w, kernel_shape=[3, 3], pads=[1, 1, 1, 1])
    y = b.op("Add", c, bias)
    w2 = b.he("w2", (8, 8, 1, 1))
    c2 = b.op("Conv", y, w2, kernel_shape=[1, 1])
    bn = [b.init(f"bn_{k}", (b.rng.random(8) + 0.5).astype(np.float32))
          for k in ("gamma", "beta", "mean", "var")]
    y = b.op("BatchNormalization", c2, *bn, epsilon=1e-5)
    r1 = b.op("Relu", y)
    r2 = b.op("Relu", y)
    y = b.op("Add", r1, r2)
    y = b.op("Dropout", y, ratio=0.25)
    y = b.op("MaxPool", y, kernel_shape=[2, 2], strides=[2, 2],
             auto_pad="SAME_UPPER")
    y = b.op("LeakyRelu", y, alpha=0.1)
    shp = b.op("Constant", value=np.array([1, 8, 16], np.int64))
    y = b.op("Reshape", y, shp)
    y = b.op("Identity", y)
    b.op("Sigmoid", y)  # dead branch
    b.output(b.node("Softmax", [y], ["out"], axis=-1)[0])
    return b.model()


def _models():
    from onnx_rusty_inference_engine_tpu.models.bert import TINY as BERT_TINY
    from onnx_rusty_inference_engine_tpu.models.bert import build_bert
    from onnx_rusty_inference_engine_tpu.models.gpt2 import TINY as GPT_TINY
    from onnx_rusty_inference_engine_tpu.models.gpt2 import build_gpt2
    from onnx_rusty_inference_engine_tpu.models.squeezenet import (
        build_squeezenet)

    return {
        "squeezenet": build_squeezenet,
        "small": lambda: _small_model(JBuilder),
        # exporter-shaped graphs: LayerNorm / GELU fusion, CSE, shape chains
        "bert_tiny": lambda: build_bert(BERT_TINY, batch=1, seq_len=8),
        "gpt2_tiny": lambda: build_gpt2(GPT_TINY, batch=1, seq_len=8),
    }


def _assert_protos_equal(a, b, path="model"):
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b) and type(a).__name__ == \
            type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_protos_equal(getattr(a, f.name), getattr(b, f.name),
                                 f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_protos_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list) and a and dataclasses.is_dataclass(a[0]):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_protos_equal(x, y, f"{path}[{i}]")
    else:
        assert values_equal(a, b), path


@pytest.mark.parametrize("name", list(_models()))
def test_same_bytes_parse_to_equal_protos(name):
    buf = j_io.serialize_model(_models()[name]())
    _assert_protos_equal(j_io.parse_model(buf), t_io.parse_model(buf))


@pytest.mark.parametrize("name", list(_models()))
def test_same_bytes_import_to_equal_graphs(name):
    buf = j_io.serialize_model(_models()[name]())
    jg = j_import(j_io.parse_model(buf))
    tg = t_import(t_io.parse_model(buf))
    assert_graphs_equal(jg, tg)


def test_small_model_passes_fired():
    """The small model really exercises the rewrites it is meant to."""
    tg = t_import(t_io.parse_model(j_io.serialize_model(
        _small_model(JBuilder))))
    ops = [n.op_type for n in tg.nodes]
    assert ops.count("Conv") == 2 and "Add" in ops  # bias Add fused, Relu-Add kept
    assert "BatchNormalization" not in ops and "Dropout" not in ops
    assert "Identity" not in ops and "Sigmoid" not in ops
    assert "Constant" not in ops and ops.count("Relu") == 1  # CSE


def test_builders_write_the_same_bytes():
    from onnx_rusty_inference_engine_tpu.models.squeezenet import (
        build_squeezenet as j_build)
    from onnx_rusty_inference_engine_tpu_torch.models import (
        build_squeezenet as t_build)

    assert t_io.serialize_model(t_build()) == j_io.serialize_model(j_build())
    assert t_io.serialize_model(_small_model(TBuilder)) == \
        j_io.serialize_model(_small_model(JBuilder))


def test_import_onnx_reads_a_file(tmp_path):
    from onnx_rusty_inference_engine_tpu.models.squeezenet import (
        build_squeezenet)

    path = tmp_path / "squeezenet.onnx"
    j_io.save_model(str(path), build_squeezenet())
    assert_graphs_equal(j_import(j_io.load_model(str(path))),
                        t_import_onnx(str(path)))


def test_truncated_bytes_raise_parse_error():
    buf = j_io.serialize_model(_small_model(JBuilder))
    with pytest.raises(t_io.ModelParseError):
        t_io.parse_model(buf[: len(buf) // 2])


def test_bfloat16_tensors_without_ml_dtypes():
    vals = np.array([[1.5, -2.25, 3.0], [1e-3, 0.0, -7.0]], np.float32)
    jbuf = j_io.encode_tensor_proto("t", vals.astype(ml_dtypes.bfloat16))
    got = t_io.parse_tensor_proto(jbuf).array
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    want = vals.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # and back: the port's encoding is what the JAX package reads
    back = j_io.parse_tensor_proto(t_io.encode_tensor_proto("t", got)).array
    np.testing.assert_array_equal(back.astype(np.float32), want)


@pytest.mark.parametrize("dtype,code", [(np.float16, 10),
                                        (ml_dtypes.bfloat16, 16)])
def test_typed_half_values_are_bit_patterns(dtype, code):
    """ONNX stores fp16 / bf16 values in int32_data as uint16 bit patterns
    (onnx.proto, TensorProto.int32_data)."""
    vals = np.array([1.5, -2.0, 0.25], np.float32).astype(dtype)
    w = WireWriter()
    w.packed_varints(1, [3])
    w.varint(2, code)
    w.packed_varints(5, vals.view(np.uint16).astype(np.int64).tolist())
    got = t_io.parse_tensor_proto(w.getvalue()).array
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  vals.astype(np.float32))


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import onnx_rusty_inference_engine_tpu_torch\n"
        "import onnx_rusty_inference_engine_tpu_torch.quant\n"
        "import onnx_rusty_inference_engine_tpu_torch.weights\n"
        "import onnx_rusty_inference_engine_tpu_torch.debug\n"
        "import onnx_rusty_inference_engine_tpu_torch.utils.timing\n"
        "import onnx_rusty_inference_engine_tpu_torch.ops.kernels._build\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes',\n"
        "                                   'onnx_rusty_inference_engine_tpu'))\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"

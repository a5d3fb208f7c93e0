"""The port's host prolog and epilog (host.py) and their wiring into the
Engine and the AOT artifact, against the JAX package on the CPU: every
case of tests/test_host_ops.py on the same inputs, the hybrid host ->
device graph, a graph with no device part, string outputs, the ml
encoders' string twins and ZipMap (test_torch_port_ml.py), and an export
round trip of a graph with a prolog and an epilog (JAX
test_export_aot.py::test_host_stages_survive_export). String and integer
outputs are held equal, float outputs within rtol 1e-5. ImageDecoder needs
PIL; its cases skip without it.
"""

import io

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu_torch import host
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.export_aot import (
    export_engine, load_exported)
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from torch_port_util import run_op_port, to_port
from util import make_model, node, run_op


def _s(*vals, shape=None):
    a = np.empty(len(vals), dtype=object)
    a[:] = list(vals)
    return a.reshape(shape) if shape else a


def _d(v):
    a = np.empty((), dtype=object)
    a[()] = v
    return a


def same(got, want):
    """Host values of both packages equal: strings and integers exactly,
    floats within rtol 1e-5."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        assert [str(v) for v in got.ravel()] == \
            [str(v) for v in want.ravel()]


def both(op, feeds, inits=None, **kw):
    want = run_op(op, feeds, inits, **kw)
    got = run_op_port(op, feeds, inits, **kw)
    for g, w in zip(got, want):
        same(g, w)
    return got


def engines(m):
    """The model through both packages' Engines (the port's on the CPU)."""
    return (Engine(to_port(m), device="cpu"),
            JEngine(j_import(j_io.parse_model(j_io.serialize_model(m)))))


def test_string_tensor_codec_roundtrip():
    arr = _s("hello", "wörld", "", "a,b,c", shape=(2, 2))
    back = t_io.parse_tensor_proto(t_io.encode_tensor_proto("t", arr))
    assert back.array.shape == (2, 2) and back.array.dtype == object
    assert list(back.array.ravel()) == ["hello", "wörld", "", "a,b,c"]
    theirs = j_io.parse_tensor_proto(t_io.encode_tensor_proto("t", arr))
    assert list(theirs.array.ravel()) == list(arr.ravel())


def test_string_concat_broadcast():
    (got,) = both("StringConcat", {"x": _s("ab", "cd", shape=(2, 1)),
                                   "y": _s("X", "Y", "Z", shape=(1, 3))})
    assert got[0, 1] == "abY" and got[1, 2] == "cdZ"


@pytest.mark.parametrize("pattern", [r"cat|.*g", r"[A-Z]\w+", r"(a"])
def test_regex_full_match(pattern):
    x = _s("cat", "catalog", "concat", "Cat")
    if pattern == "(a":
        with pytest.raises(UnsupportedOpError, match="bad pattern"):
            run_op_port("RegexFullMatch", {"x": x}, pattern=pattern)
        return
    both("RegexFullMatch", {"x": x}, pattern=pattern)


@pytest.mark.parametrize("x,kw", [
    (_s("a,b,,c", "", "x,y"), dict(delimiter=",")),
    (_s("  hello   world ", "one"), {}),
    (_s("a-b-c-d"), dict(delimiter="-", maxsplit=2)),
    (_s("a b", "c d e", "f", shape=(3, 1)), dict(delimiter=" ")),
])
def test_string_split(x, kw):
    both("StringSplit", {"x": x}, n_outputs=2, **kw)


@pytest.mark.parametrize("x,kw", [
    (_s("The", "cat", "AND", "dog", shape=(1, 4)),
     dict(case_change_action="LOWER", stopwords=["the", "and"],
          is_case_sensitive=0)),
    (_s("The", "the", "cat"), dict(case_change_action="UPPER",
                                   stopwords=["the"], is_case_sensitive=1)),
    (_s("a", "a"), dict(stopwords=["a"], is_case_sensitive=1)),
    (_s("MiXed", "CaSe"), {}),
])
def test_string_normalizer(x, kw):
    both("StringNormalizer", {"x": x}, **kw)


def test_string_normalizer_rejects_a_batch():
    with pytest.raises(UnsupportedOpError, match=r"\[C\] or \[1,C\]"):
        run_op_port("StringNormalizer", {"x": _s("a", "b", "c", "d",
                                                 shape=(2, 2))})


def test_image_decoder_formats():
    Image = pytest.importorskip("PIL.Image")
    img = Image.fromarray(np.random.default_rng(1).integers(
        0, 255, (5, 7, 3), dtype=np.uint8), "RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    enc = np.frombuffer(buf.getvalue(), dtype=np.uint8).copy()
    want = np.asarray(img, dtype=np.uint8)
    (rgb,) = both("ImageDecoder", {"x": enc}, pixel_format="RGB")
    np.testing.assert_array_equal(rgb, want)
    (bgr,) = both("ImageDecoder", {"x": enc}, pixel_format="BGR")
    np.testing.assert_array_equal(bgr, want[..., ::-1])
    (grey,) = both("ImageDecoder", {"x": enc}, pixel_format="Grayscale")
    assert grey.shape == (5, 7, 1)


def test_image_decoder_feeds_device_graph():
    """ImageDecoder (host) -> Cast -> ReduceMean (device)."""
    Image = pytest.importorskip("PIL.Image")
    img = Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (6, 4, 3), dtype=np.uint8), "RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    enc = np.frombuffer(buf.getvalue(), dtype=np.uint8).copy()
    m = make_model([node("ImageDecoder", ["x"], ["img"]),
                    node("Cast", ["img"], ["f"], to=1),
                    node("ReduceMean", ["f"], ["y"], axes=[0, 1],
                         keepdims=0)], {"x": enc}, ["y"])
    ours, theirs = engines(m)
    same(ours.run({"x": enc})["y"], theirs.run({"x": enc})["y"])


def test_image_decoder_bad_bytes_raise():
    pytest.importorskip("PIL.Image")
    with pytest.raises(UnsupportedOpError, match="cannot decode"):
        run_op_port("ImageDecoder", {"x": np.arange(12, dtype=np.uint8)})


def _tfidf_attrs(**over):
    base = dict(min_gram_length=1, max_gram_length=2, max_skip_count=0,
                ngram_counts=[0, 2], ngram_indexes=[0, 1, 2],
                pool_strings=["a", "b", "a", "c"])
    base.update(over)
    return base


@pytest.mark.parametrize("mode,over", [
    ("TF", {}), ("TF", dict(max_skip_count=1)),
    ("IDF", dict(weights=[0.5, 2.0, 3.0])),
    ("TFIDF", dict(weights=[0.5, 2.0, 3.0])),
    ("TF", dict(min_gram_length=2)),
])
def test_tfidf_strings(mode, over):
    x = _s("a", "b", "a", "c", "a", "c", shape=(2, 3))
    both("TfIdfVectorizer", {"x": x}, mode=mode, **_tfidf_attrs(**over))


def test_tfidf_int64_pool_1d():
    x = np.array([3, 5, 3, 9], dtype=np.int64)
    (got,) = both("TfIdfVectorizer", {"x": x}, mode="TF",
                  min_gram_length=1, max_gram_length=2, max_skip_count=0,
                  ngram_counts=[0, 2], ngram_indexes=[0, 1, 2],
                  pool_int64s=[3, 5, 3, 9])
    np.testing.assert_allclose(got, [2.0, 1.0, 1.0])


def test_hybrid_host_to_device():
    """strings -> TfIdf (host) -> MatMul (device): the boundary tensor
    feeds the device graph; a second call with other strings reuses it."""
    x = _s("a", "b", "a", "c", shape=(1, 4))
    w = np.random.default_rng(3).standard_normal((3, 2)).astype(np.float32)
    m = make_model([node("TfIdfVectorizer", ["x"], ["feats"], mode="TF",
                         **_tfidf_attrs()),
                    node("MatMul", ["feats", "w"], ["out"])],
                   {"x": x}, ["out"], {"w": w})
    ours, theirs = engines(m)
    assert ours._host.boundary == ["feats"]
    assert ours.graph.input_names == ["feats"]
    for feed in (x, _s("b", "b", "b", "q", shape=(1, 4))):
        got = ours.run({"x": feed}).outputs["out"]
        same(got, theirs.run({"x": feed}).outputs["out"])
    np.testing.assert_allclose(got, np.array([[0.0, 3.0, 0.0]]) @ w,
                               rtol=1e-5)
    # a list feed names the graph's original inputs
    same(ours.run([x]).outputs["out"], theirs.run([x]).outputs["out"])


def test_pure_host_pipeline_and_string_output():
    """StringNormalizer -> StringConcat: no device node at all, so no
    device graph runs; a string graph output."""
    x = _s("The", "Cat")
    m = make_model(
        [node("StringNormalizer", ["x"], ["norm"],
              case_change_action="UPPER"),
         node("StringConcat", ["norm", "suffix"], ["out"])],
        {"x": x}, ["out"], {"suffix": _s("!", "!")})
    ours, theirs = engines(m)
    assert not ours.graph.nodes and not ours.graph.outputs
    got = ours.run({"x": x}).outputs["out"]
    assert list(got) == ["THE!", "CAT!"]
    same(got, theirs.run({"x": x}).outputs["out"])


def test_mixed_host_and_device_outputs():
    """A host output (the split's counts) beside a device output that
    reads a host product, and a device output that reads a plain input."""
    x = _s("a b", "c d e", "f")
    y = np.arange(3, dtype=np.float32)
    m = make_model([node("StringSplit", ["x"], ["tok", "n"], delimiter=" "),
                    node("Cast", ["n"], ["nf"], to=1),
                    node("Add", ["nf", "y"], ["s"]),
                    node("Relu", ["y"], ["r"])],
                   {"x": x, "y": y}, ["tok", "s", "r"])
    ours, theirs = engines(m)
    got, want = ours.run({"x": x, "y": y}), theirs.run({"x": x, "y": y})
    assert sorted(got.outputs) == sorted(want.outputs)
    for k in want.outputs:
        same(got[k], want[k])
    assert isinstance(ours({"x": x, "y": y})["tok"], np.ndarray)


def test_string_into_device_op_rejected():
    x = _s("a", "b")
    m = make_model([node("Relu", ["x"], ["out"])], {"x": x}, ["out"])
    with pytest.raises(UnsupportedOpError, match="no host"):
        Engine(to_port(m), device="cpu").run({"x": x})


def test_string_boundary_into_device_op_rejected():
    """A host product that is a string, read by a device op."""
    x = _s("a", "b")
    m = make_model([node("StringConcat", ["x", "x"], ["xx"]),
                    node("RegexFullMatch", ["xx"], ["ok"], pattern="aa"),
                    node("Not", ["ok"], ["out"])], {"x": x}, ["out"])
    ours, theirs = engines(m)
    same(ours.run({"x": x})["out"], theirs.run({"x": x})["out"])


def test_host_op_reading_a_device_value_raises():
    x = np.array([[1.0, 2.0]], np.float32)
    m = make_model([node("Relu", ["x"], ["r"]),
                    node("TfIdfVectorizer", ["r"], ["t"], mode="TF",
                         **_tfidf_attrs())], {"x": x}, ["t"])
    with pytest.raises(UnsupportedOpError, match="device-computed"):
        Engine(to_port(m), device="cpu").run({"x": x})


def test_epilog_op_without_epilog_form_raises():
    x = np.array([[0.2, 0.8]], np.float32)
    m = make_model([node("ZipMap", ["x"], ["maps"], domain="ai.onnx.ml",
                         classlabels_int64s=[0, 1]),
                    node("Identity", ["maps"], ["out"])], {"x": x}, ["out"])
    with pytest.raises(UnsupportedOpError, match="no epilog"):
        Engine(to_port(m), device="cpu")


# ---------------------------------------------------------------------------
# DictVectorizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x,kw", [
    (_d({"cat": 2.5, "dog": 1.0, "ignored": 9.0}),
     dict(string_vocabulary=["ant", "cat", "dog"])),
    (_d({7: 3, 5: 1}), dict(int64_vocabulary=[5, 6, 7])),
], ids=["string_vocab", "int_vocab"])
def test_dict_vectorizer(x, kw):
    (got,) = both("DictVectorizer", {"x": x}, domain="ai.onnx.ml", **kw)
    assert got.dtype == (np.float32 if "string_vocabulary" in kw
                         else np.int64)


def test_dict_vectorizer_batch_of_maps():
    a = np.empty(2, dtype=object)
    a[0] = {"a": 1.0}
    a[1] = {"b": 2.0, "a": 3.0}
    (got,) = both("DictVectorizer", {"x": a}, domain="ai.onnx.ml",
                  string_vocabulary=["a", "b"])
    np.testing.assert_allclose(got, [[1.0, 0.0], [3.0, 2.0]])


def test_dict_vectorizer_feeds_device_graph():
    d = _d({"x1": 4.0, "x2": 8.0})
    m = make_model([
        node("DictVectorizer", ["m"], ["feat"], domain="ai.onnx.ml",
             string_vocabulary=["x1", "x2"]),
        node("Scaler", ["feat"], ["y"], domain="ai.onnx.ml",
             offset=[1.0, 2.0], scale=[0.5, 0.25])], {"m": d}, ["y"])
    ours, theirs = engines(m)
    y = ours.run({"m": d}).outputs["y"]
    same(y, theirs.run({"m": d}).outputs["y"])
    np.testing.assert_allclose(y.ravel(), [1.5, 1.5], rtol=1e-6)


def test_dict_vectorizer_needs_a_map_and_a_vocabulary():
    with pytest.raises(UnsupportedOpError, match="expected map"):
        run_op_port("DictVectorizer", {"x": _s("a")}, domain="ai.onnx.ml",
                    string_vocabulary=["a"])
    with pytest.raises(UnsupportedOpError, match="vocabulary"):
        run_op_port("DictVectorizer", {"x": _d({"a": 1.0})},
                    domain="ai.onnx.ml")


def test_host_tables_match_jax():
    """The port's host op tables are the JAX module's, op for op."""
    from onnx_rusty_inference_engine_tpu import host as j_host

    assert set(host._HOST_EMITTERS) == set(j_host._HOST_EMITTERS)
    assert set(host._HOST_FALLBACK) == set(j_host._HOST_FALLBACK)
    assert set(host._EPILOG_EMITTERS) == set(j_host._EPILOG_EMITTERS)


# ---------------------------------------------------------------------------
# export: the host stages bundled beside the program
# ---------------------------------------------------------------------------
CKW = dict(
    nodes_treeids=[0, 0, 0], nodes_nodeids=[0, 1, 2],
    nodes_featureids=[0, 0, 0],
    nodes_modes=["BRANCH_LEQ", "LEAF", "LEAF"],
    nodes_values=[0.5, 0.0, 0.0],
    nodes_truenodeids=[1, 0, 0], nodes_falsenodeids=[2, 0, 0],
    class_treeids=[0, 0, 0, 0], class_nodeids=[1, 1, 2, 2],
    class_ids=[0, 1, 0, 1], class_weights=[0.9, 0.1, 0.2, 0.8],
    classlabels_strings=["no", "yes"], post_transform="NONE")


def _pipeline():
    """A string prolog (LabelEncoder over a string column), a device tree
    classifier with string labels, and a ZipMap epilog."""
    nodes = [
        node("LabelEncoder", ["cat"], ["cat_id"], domain="ai.onnx.ml",
             keys_strings=["a", "b"], values_floats=[0.0, 1.0],
             default_float=-1.0),
        node("Unsqueeze", ["cat_id", "ax"], ["feats"]),
        node("TreeEnsembleClassifier", ["feats"], ["label", "scores"],
             domain="ai.onnx.ml", **CKW),
        node("ZipMap", ["scores"], ["probs"], domain="ai.onnx.ml",
             classlabels_strings=["no", "yes"]),
    ]
    cat = np.array(["a", "b", "zz"], dtype=object)
    return make_model(nodes, {"cat": cat}, ["label", "probs"],
                      initializers={"ax": np.array([1], np.int64)}), cat


def test_pipeline_matches_jax():
    m, cat = _pipeline()
    ours, theirs = engines(m)
    got, want = ours.run({"cat": cat}), theirs.run({"cat": cat})
    same(got["label"], want["label"])
    assert got["probs"] == want["probs"]
    assert "scores" not in got.outputs  # the epilog's helper stripped


def test_host_stages_survive_export(tmp_path):
    """The pipeline exports and reloads: the program holds the device part
    only, the host stages are bundled as small serialized graphs, and the
    artifact's outputs equal the Engine's."""
    m, cat = _pipeline()
    eng = Engine(to_port(m), device="cpu")
    want = eng.run({"cat": cat})
    path = str(tmp_path / "pipe.npz")
    export_engine(eng, {"cat": cat}, path)
    art = load_exported(path, device="cpu")
    assert set(art.meta) >= {"host_prolog", "host_epilog"}
    assert art.outputs == ["label", "probs"]
    got = art.run({"cat": cat})
    assert [str(v) for v in got["label"]] == \
        [str(v) for v in want["label"]]
    assert got["probs"] == want["probs"]
    assert "scores" not in got
    # another column of the same length runs through the same program
    other = np.array(["b", "b", "a"], dtype=object)
    assert art.run([other])["probs"] == eng.run([other])["probs"]

"""Host prolog and epilog: string, map and image ops run in numpy on the
host, before and after the device graph.

The port's counterpart of onnx_rusty_inference_engine_tpu/host.py, with
its every host, fallback and epilog op: StringConcat, RegexFullMatch,
StringSplit, StringNormalizer, ImageDecoder (needs PIL), TfIdfVectorizer,
DictVectorizer, the ai.onnx.ml encoders' string twins (OneHotEncoder,
LabelEncoder, CategoryMapper) and ZipMap.

A tensor of strings has no device form, so a graph that begins with
string ops (sklearn text pipelines, tokenizer front ends) or ends in maps
and strings (ZipMap, string labels) is split: `split_host_prolog` takes
the prefix of every host-only op and every node that reads a string, and
runs it eagerly in numpy at call time; its numeric products feed the
device graph as extra inputs. `split_host_epilog` takes the suffix that
makes maps or strings from device outputs, and the index -> label mapping
of string-labelled classifiers (their products stay on the device,
ops/ml.py). The device part is still one captured graph per input
signature (engine.py).

Boundary rules:
  * host -> device tensors must be numeric (a string flowing into a
    device op is a model error, reported as UnsupportedOpError);
  * host prolog ops read graph inputs and constants only; a host op that
    reads a device-computed value raises.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .graph import Graph, InputSpec, Node
from .ops.registry import UnsupportedOpError

# ops that can ONLY run on host (string semantics or byte-stream decode)
_HOST_EMITTERS: Dict[str, Callable] = {}

# ops with BOTH a device lowering (numeric data) and a numpy twin used
# when their inputs are strings (prolog) or their outputs are strings
# (epilog) — e.g. the ai.onnx.ml encoders. Unlike _HOST_EMITTERS these
# do NOT force hosting by op name alone.
_HOST_FALLBACK: Dict[str, Callable] = {}

# ops that can only run AFTER the device graph (map/sequence outputs or
# numeric→string mapping): the host epilog
_EPILOG_EMITTERS: Dict[str, Callable] = {}


def host_op(*names):
    def deco(fn):
        for n in names:
            _HOST_EMITTERS[n] = fn
        return fn
    return deco


def fallback_op(*names):
    def deco(fn):
        for n in names:
            _HOST_FALLBACK[n] = fn
        return fn
    return deco


def epilog_op(*names):
    def deco(fn):
        for n in names:
            _EPILOG_EMITTERS[n] = fn
        return fn
    return deco


def is_string_array(v) -> bool:
    return isinstance(v, np.ndarray) and (v.dtype == object
                                          or v.dtype.kind == "U")


# --------------------------------------------------------------------------
# emitters (numpy, eager)
# --------------------------------------------------------------------------
@host_op("StringConcat")
def _string_concat(node: Node, ins):
    concat = np.frompyfunc(lambda a, b: str(a) + str(b), 2, 1)
    return [concat(ins[0], ins[1])]


@host_op("RegexFullMatch")
def _regex_full_match(node: Node, ins):
    pattern = node.attr("pattern")
    if pattern is None:
        raise UnsupportedOpError("RegexFullMatch: pattern attribute required")
    try:
        rx = re.compile(pattern)
    except re.error as e:
        raise UnsupportedOpError(f"RegexFullMatch: bad pattern: {e}") from e
    x = np.asarray(ins[0])
    out = np.array([rx.fullmatch(str(s)) is not None for s in x.ravel()],
                   dtype=np.bool_)
    return [out.reshape(x.shape)]


@host_op("StringSplit")
def _string_split(node: Node, ins):
    delim = node.attr("delimiter")
    maxsplit = node.attr("maxsplit")
    x = np.asarray(ins[0])
    ms = -1 if maxsplit is None else int(maxsplit)
    # empty/absent delimiter = whitespace mode: runs collapse, blanks give
    # no tokens (str.split(None) semantics, which is what the spec asks)
    parts: List[List[str]] = [
        str(s).split(delim if delim else None, ms) for s in x.ravel()
    ]
    width = max((len(p) for p in parts), default=0)
    y = np.empty((len(parts), width), dtype=object)
    y[:] = ""
    for i, p in enumerate(parts):
        y[i, :len(p)] = p
    z = np.array([len(p) for p in parts], dtype=np.int64)
    return [y.reshape(x.shape + (width,)), z.reshape(x.shape)]


@host_op("StringNormalizer")
def _string_normalizer(node: Node, ins):
    action = node.attr("case_change_action", "NONE")
    case_sensitive = bool(node.attr("is_case_sensitive", 0))
    stopwords = node.attr("stopwords") or []
    x = np.asarray(ins[0])
    if x.ndim not in (1, 2) or (x.ndim == 2 and x.shape[0] != 1):
        raise UnsupportedOpError(
            f"StringNormalizer: input must be [C] or [1,C], got {x.shape}")
    row = [str(s) for s in x.ravel()]
    if stopwords:
        if case_sensitive:
            drop = set(stopwords)
            row = [s for s in row if s not in drop]
        else:
            drop = {w.lower() for w in stopwords}
            row = [s for s in row if s.lower() not in drop]
    if action == "LOWER":
        row = [s.lower() for s in row]
    elif action == "UPPER":
        row = [s.upper() for s in row]
    if not row:
        row = [""]  # spec: empty result collapses to a single empty string
    out = np.array(row, dtype=object)
    return [out.reshape((1, -1)) if x.ndim == 2 else out]


@host_op("ImageDecoder")
def _image_decoder(node: Node, ins):
    import io

    try:
        from PIL import Image
    except ImportError as e:
        raise UnsupportedOpError("ImageDecoder requires PIL") from e
    fmt = node.attr("pixel_format", "RGB")
    data = np.asarray(ins[0], dtype=np.uint8).tobytes()
    try:
        img = Image.open(io.BytesIO(data))
        img = img.convert("L" if fmt == "Grayscale" else "RGB")
    except Exception as e:
        raise UnsupportedOpError(f"ImageDecoder: cannot decode: {e}") from e
    arr = np.asarray(img, dtype=np.uint8)
    if fmt == "Grayscale":
        return [arr[..., None]]
    if fmt == "BGR":
        return [arr[..., ::-1]]
    return [arr]


@host_op("TfIdfVectorizer")
def _tfidf_vectorizer(node: Node, ins):
    mode = node.attr("mode", "TF")
    min_n = int(node.attr("min_gram_length", 1))
    max_n = int(node.attr("max_gram_length", 1))
    max_skip = int(node.attr("max_skip_count", 0))
    ngram_counts = [int(v) for v in node.attr("ngram_counts", [])]
    ngram_indexes = [int(v) for v in node.attr("ngram_indexes", [])]
    weights = node.attr("weights")
    pool = node.attr("pool_strings")
    if pool is None:
        pool = [int(v) for v in node.attr("pool_int64s", [])]
    else:
        pool = [str(s) for s in pool]

    # pool layout: ngram_counts[i] = offset of the (i+1)-gram block; the
    # k-th ngram overall maps to output column ngram_indexes[k]
    gram_to_col: Dict[Tuple, int] = {}
    k = 0
    for i, start in enumerate(ngram_counts):
        n = i + 1
        end = ngram_counts[i + 1] if i + 1 < len(ngram_counts) else len(pool)
        for j in range((end - start) // max(n, 1)):
            gram = tuple(pool[start + j * n: start + (j + 1) * n])
            gram_to_col[gram] = ngram_indexes[k]
            k += 1
    n_cols = max(ngram_indexes) + 1 if ngram_indexes else 0

    x = np.asarray(ins[0])
    rows = x.reshape(1, -1) if x.ndim <= 1 else x
    if x.ndim > 2:
        raise UnsupportedOpError(
            f"TfIdfVectorizer: rank-{x.ndim} input not in spec")
    counts = np.zeros((rows.shape[0], n_cols), dtype=np.float32)
    for b in range(rows.shape[0]):
        row = [str(t) if is_string_array(x) else int(t) for t in rows[b]]
        for n in range(min_n, max_n + 1):
            # skip-grams: uniform stride s+1 between items (1-grams never skip)
            for s in range(0, (max_skip if n > 1 else 0) + 1):
                stride = s + 1
                span = (n - 1) * stride
                for i0 in range(0, len(row) - span):
                    gram = tuple(row[i0 + t * stride] for t in range(n))
                    col = gram_to_col.get(gram)
                    if col is not None:
                        counts[b, col] += 1.0
    if mode in ("IDF", "TFIDF"):
        w = np.ones(n_cols, dtype=np.float32)
        if weights is not None:
            for kk, col in enumerate(ngram_indexes):
                w[col] = weights[kk]
        counts = (counts > 0).astype(np.float32) * w if mode == "IDF" \
            else counts * w
    out = counts if x.ndim == 2 else counts.reshape(-1)
    return [out]


# --------------------------------------------------------------------------
# ai.onnx.ml string twins (prolog fallbacks) and epilog ops
# --------------------------------------------------------------------------
@fallback_op("OneHotEncoder")
def _one_hot_encoder_host(node: Node, ins):
    cats = node.attr("cats_strings")
    if cats is None:
        cats = [int(v) for v in node.attr("cats_int64s", [])]
        x = np.asarray(ins[0]).astype(np.int64)
        eq = x[..., None] == np.asarray(cats, np.int64)
    else:
        x = np.asarray(ins[0])
        eq = np.array([[str(v) == c for c in cats] for v in x.ravel()],
                      np.bool_).reshape(x.shape + (len(cats),))
    return [eq.astype(np.float32)]


@fallback_op("LabelEncoder")
@epilog_op("LabelEncoder")
def _label_encoder_host(node: Node, ins):
    from .ops.ml import _label_encoder_table

    keys, kstr = _label_encoder_table(node, "keys")
    vals, vstr = _label_encoder_table(node, "values")
    default = node.attr("default_string")
    if default is None:
        t = node.attr("default_tensor")
        if t is not None:
            default = np.asarray(t).reshape(-1)[0]
    if default is None:
        default = node.attr("default_float")
    if default is None:
        default = node.attr("default_int64", -1)
    if vstr and not isinstance(default, str):
        default = "_Unused" if node.attr("default_string") is None \
            else default
    table = {(str(k) if kstr else k.item()): v
             for k, v in zip(keys, vals)}
    x = np.asarray(ins[0])
    get = ((lambda v: table.get(str(v), default)) if kstr
           else (lambda v: table.get(np.asarray(v).item(), default)))
    out = np.array([get(v) for v in x.ravel()],
                   dtype=object if vstr else vals.dtype)
    return [out.reshape(x.shape)]


@fallback_op("CategoryMapper")
@epilog_op("CategoryMapper")
def _category_mapper_host(node: Node, ins):
    cats_s = [str(s) for s in node.attr("cats_strings", [])]
    cats_i = [int(v) for v in node.attr("cats_int64s", [])]
    x = np.asarray(ins[0])
    if is_string_array(x):  # string → int64
        table = dict(zip(cats_s, cats_i))
        d = int(node.attr("default_int64", -1))
        out = np.array([table.get(str(v), d) for v in x.ravel()], np.int64)
    else:                   # int64 → string
        table = dict(zip(cats_i, cats_s))
        d = str(node.attr("default_string", "_Unused"))
        out = np.array([table.get(int(v), d) for v in x.ravel()],
                       dtype=object)
    return [out.reshape(x.shape)]


@host_op("DictVectorizer")
def _dict_vectorizer(node: Node, ins):
    """ai.onnx.ml DictVectorizer: {key: value} map(s) -> dense feature
    vector over the vocabulary (the head of sklearn DictVectorizer
    pipelines). A single dict feeds as a 0-d object array -> [C]; a
    list/array of dicts -> [N, C] (the onnx reference semantics).
    Keys absent from the vocabulary are dropped; vocabulary entries
    absent from the dict are 0."""
    svoc = node.attr("string_vocabulary")
    if svoc is not None:
        keys = [str(s) for s in svoc]
        norm = str
    else:
        ivoc = node.attr("int64_vocabulary")
        if ivoc is None:
            raise UnsupportedOpError(
                "DictVectorizer: string_vocabulary or int64_vocabulary "
                "attribute required")
        keys = [int(v) for v in ivoc]
        norm = lambda k: int(k)  # noqa: E731
    x = np.asarray(ins[0])
    dicts = [x.item()] if x.ndim == 0 else [d for d in x.ravel()]
    for d in dicts:
        if not isinstance(d, dict):
            raise UnsupportedOpError(
                f"DictVectorizer: expected map input, got {type(d).__name__}")
    rows = [[d.get(norm(k), 0) for k in keys]
            for d in ({norm(k): v for k, v in d.items()} for d in dicts)]
    flat = [v for r in rows for v in r]
    if any(isinstance(v, str) for v in flat):
        out = np.array(rows, dtype=object)
    elif all(isinstance(v, (int, np.integer)) for v in flat):
        out = np.array(rows, dtype=np.int64)
    else:
        out = np.array(rows, dtype=np.float32)
    return [out[0] if x.ndim == 0 else out]


@epilog_op("ZipMap")
def _zip_map(node: Node, ins):
    """[N, C] scores -> a sequence of N {label: score} maps (the tail of
    every sklearn classifier export). Runs after the device graph; the
    scores tensor stays a device output where the graph names it."""
    labels = node.attr("classlabels_strings")
    if labels is None:
        labels = [int(v) for v in node.attr("classlabels_int64s", [])]
    else:
        labels = [str(s) for s in labels]
    x = np.asarray(ins[0], np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.shape[-1] != len(labels):
        raise UnsupportedOpError(
            f"ZipMap: {x.shape[-1]} scores for {len(labels)} labels")
    return [[{lab: float(row[i]) for i, lab in enumerate(labels)}
             for row in x]]


def _produces_strings(node: Node) -> bool:
    """True when an ml mapping node's value table is strings (its output
    can never live on the device, whatever its input)."""
    if node.op_type == "LabelEncoder":
        if node.attr("values_strings") is not None:
            return True
        t = node.attr("values_tensor")
        return t is not None and np.asarray(t).dtype.kind in ("U", "S", "O")
    if node.op_type == "CategoryMapper":
        # direction decided by input dtype; resolved during partition
        return False
    return False


# --------------------------------------------------------------------------
# partition + execution
# --------------------------------------------------------------------------
class HostProlog:
    """The host-executable prefix of a graph: nodes run eagerly in numpy."""

    def __init__(self, nodes: List[Node], constants: Dict[str, np.ndarray],
                 boundary: List[str], host_outputs: List[str],
                 consumed_inputs: List[str], orig_input_names: List[str]):
        self.nodes = nodes
        self.constants = constants
        self.boundary = boundary          # host-produced, device-consumed
        self.host_outputs = host_outputs  # graph outputs produced on host
        self.consumed_inputs = consumed_inputs  # graph inputs host consumes
        self.orig_input_names = orig_input_names  # pre-split feed order

    def run(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.constants)
        env.update({k: np.asarray(v) for k, v in feeds.items()})
        for node in self.nodes:
            fn = _HOST_EMITTERS.get(node.op_type) \
                or _HOST_FALLBACK.get(node.op_type)
            if fn is None:
                raise UnsupportedOpError(
                    f"op '{node.op_type}' consumes a string value but has "
                    f"no host (numpy) implementation")
            missing = [i for i in node.inputs if i and i not in env]
            if missing:
                raise UnsupportedOpError(
                    f"host op '{node.op_type}' reads device-computed "
                    f"tensors {missing}; device→host edges are not "
                    f"supported (host ops must form a graph prefix)")
            outs = fn(node, [env[i] if i else None for i in node.inputs])
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        out = {}
        for name in self.boundary + self.host_outputs:
            v = env[name]
            if name in self.boundary and is_string_array(v):
                raise UnsupportedOpError(
                    f"tensor {name!r} is a string value consumed by a "
                    f"device op; strings have no device form")
            out[name] = v
        return out

    def split_feed(self, feed: Dict[str, object], device_inputs,
                   host_value: Callable) -> Tuple[dict, dict]:
        """Run on a call's feed (name -> value; `host_value` brings a
        tensor to numpy): (the device graph's feed, its inputs among
        `feed` and the prolog's products; the graph outputs the prolog
        makes)."""
        made = self.run({k: host_value(v) for k, v in feed.items()
                         if k in self.consumed_inputs})
        dev = {k: v for k, v in feed.items() if k in device_inputs}
        dev.update({b: made[b] for b in self.boundary})
        return dev, {o: made[o] for o in self.host_outputs}


def split_host_prolog(graph: Graph) -> Tuple[Optional[HostProlog], Graph]:
    """Partition `graph` into (host prolog, device graph).

    A node is hosted iff its op is host-only (string / byte semantics) or
    it reads a hosted value, a string constant or a string graph input.
    Host products that device nodes read become extra device inputs (a new
    shape of one gives a new input signature, and so a new captured
    graph)."""
    string_vals = {k for k, v in graph.constants.items()
                   if is_string_array(v)}
    string_vals |= {s.name for s in graph.inputs if s.dtype == object}
    if not string_vals and not any(n.op_type in _HOST_EMITTERS
                                   for n in graph.nodes):
        return None, graph

    # which host-op outputs are string-valued (and so recruit their
    # consumers onto the host); numeric host products instead become
    # boundary tensors feeding the device graph
    string_outs = {
        "StringConcat": (True,), "StringNormalizer": (True,),
        "StringSplit": (True, False), "RegexFullMatch": (False,),
        "ImageDecoder": (False,), "TfIdfVectorizer": (False,),
        "DictVectorizer": (False,),
        # ml encoders hosted because their INPUT is a string; output is
        # numeric unless the value table itself is strings
        "OneHotEncoder": (False,), "CategoryMapper": (False,),
        "LabelEncoder": lambda n: (_produces_strings(n),),
    }

    hosted_vals = set(string_vals)
    host_nodes: List[Node] = []
    device_nodes: List[Node] = []
    for node in graph.nodes:
        if node.op_type in _HOST_EMITTERS or any(
                i in hosted_vals for i in node.inputs if i):
            host_nodes.append(node)
            flags = string_outs.get(node.op_type)
            if callable(flags):
                flags = flags(node)
            for idx, o in enumerate(node.outputs):
                # unknown op hosting a string (will error in run()) marks
                # all outputs string so the poisoning is visible downstream
                if o and (flags is None or (idx < len(flags)
                                            and flags[idx])):
                    hosted_vals.add(o)
        else:
            device_nodes.append(node)
    if not host_nodes:
        return None, graph

    produced = {o for n in host_nodes for o in n.outputs if o}
    boundary = sorted({
        i for n in device_nodes for i in n.inputs if i and i in produced})
    host_outputs = [o for o in graph.outputs if o in produced]
    device_outputs = [o for o in graph.outputs if o not in produced]

    host_consts = {k: v for k, v in graph.constants.items()
                   if any(k in n.inputs for n in host_nodes)}
    consumed = [s.name for s in graph.inputs
                if any(s.name in n.inputs for n in host_nodes)]
    # inputs consumed ONLY by host nodes leave the device signature
    device_needed = {i for n in device_nodes for i in n.inputs if i}
    device_inputs = [s for s in graph.inputs
                     if s.name in device_needed or s.name not in set(consumed)]
    device_inputs = device_inputs + [
        InputSpec(name=b, shape=(), dtype=np.dtype(np.float32))
        for b in boundary]

    dev_graph = dataclasses.replace(
        graph,
        nodes=device_nodes,
        inputs=device_inputs,
        outputs=device_outputs,
        constants={k: v for k, v in graph.constants.items()
                   if not is_string_array(v)},
        weight_names=[w for w in graph.weight_names
                      if not is_string_array(graph.constants[w])],
    )
    prolog = HostProlog(host_nodes, host_consts, boundary, host_outputs,
                        consumed, list(graph.input_names))
    return prolog, dev_graph


# --------------------------------------------------------------------------
# host epilog: map / string tails run after the device graph
# --------------------------------------------------------------------------
class HostEpilog:
    """The host-executable suffix of a graph (the mirror of HostProlog):
    ZipMap (a sequence-of-maps output), numeric -> string LabelEncoder /
    CategoryMapper tails, and the index -> string mapping of
    string-labelled ml classifiers (whose products stay on the device and
    emit the argmax index; see ops/ml.py). Runs eagerly in numpy on the
    device outputs, copied to the host."""

    def __init__(self, nodes: List[Node], constants: Dict[str, np.ndarray],
                 transforms: Dict[str, np.ndarray], boundary: List[str],
                 consumed_inputs: List[str], outputs: List[str],
                 extra_boundary: List[str]):
        self.nodes = nodes
        self.constants = constants
        self.transforms = transforms  # device output -> label table
        self.boundary = boundary      # device-produced values epilog reads
        self.consumed_inputs = consumed_inputs
        self.outputs = outputs        # graph outputs the epilog produces
        self.extra_boundary = extra_boundary  # boundary ∖ graph outputs

    def run(self, device_out: Dict[str, np.ndarray],
            feeds: Dict[str, np.ndarray]) -> Dict[str, object]:
        env: Dict[str, object] = dict(self.constants)
        env.update({k: np.asarray(v) for k, v in feeds.items()
                    if k in self.consumed_inputs})
        env.update({k: np.asarray(v) for k, v in device_out.items()})
        out: Dict[str, object] = {}
        for name, labels in self.transforms.items():
            idx = np.asarray(env[name]).astype(np.int64)
            env[name] = labels[idx]
            out[name] = env[name]
        for node in self.nodes:
            fn = _EPILOG_EMITTERS.get(node.op_type)
            outs = fn(node, [env[i] if i else None for i in node.inputs])
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        out.update({o: env[o] for o in self.outputs})
        return out

    def apply(self, out: Dict[str, object], feed: Dict[str, object],
              host_value: Callable) -> Dict[str, object]:
        """A call's outputs with the epilog run on them (`host_value`
        brings a tensor to numpy): its outputs added, the device values it
        alone read dropped."""
        made = self.run({k: host_value(out[k]) for k in set(self.boundary)
                         | set(self.transforms) if k in out},
                        {k: host_value(v) for k, v in feed.items()
                         if k in self.consumed_inputs})
        out = {k: v for k, v in out.items() if k not in self.extra_boundary}
        out.update(made)
        return out


def named_feed(inputs, names: List[str]) -> Dict[str, object]:
    """A call's inputs as name -> value: a mapping as it is, a list or
    tuple in the order of `names`, anything else the first input."""
    if isinstance(inputs, (list, tuple)):
        return dict(zip(names, inputs))
    if not isinstance(inputs, Mapping):
        return {names[0]: inputs}
    return dict(inputs)


def split_host_epilog(graph: Graph):
    """Partition `graph` into (device graph, host epilog).

    A node moves to the epilog iff it is epilog-only (ZipMap), its value
    table makes its output strings (numeric→string LabelEncoder /
    CategoryMapper fed numeric data), or it consumes an epilog product.
    A consumer of an epilog product without an epilog form is a model
    error. Classifier nodes with string classlabels stay on the device
    (their products are the hot path); the epilog maps their index
    output."""
    from .ops.ml import classifier_string_labels

    def forced(node: Node) -> bool:
        if node.op_type == "ZipMap":
            return True
        if node.op_type == "CategoryMapper":
            # numeric input → string output; string inputs were already
            # claimed by the prolog split, so anything left is int→str
            return True
        return _produces_strings(node)

    epilogged: set = set()
    ep_nodes: List[Node] = []
    dev_nodes: List[Node] = []
    transforms: Dict[str, np.ndarray] = {}
    for node in graph.nodes:
        consumes = any(i in epilogged for i in node.inputs if i)
        if forced(node) or consumes:
            if node.op_type not in _EPILOG_EMITTERS:
                raise UnsupportedOpError(
                    f"op '{node.op_type}' consumes a host-epilog value "
                    f"(map/string) but has no epilog implementation")
            ep_nodes.append(node)
            epilogged.update(o for o in node.outputs if o)
        else:
            dev_nodes.append(node)
            labels = classifier_string_labels(node)
            if labels is not None and node.outputs and node.outputs[0]:
                transforms[node.outputs[0]] = labels
    if not ep_nodes and not transforms:
        return graph, None

    dev_produced = {o for n in dev_nodes for o in n.outputs if o}
    input_names = {s.name for s in graph.inputs}
    boundary: List[str] = []
    consumed_inputs: List[str] = []
    consts: Dict[str, np.ndarray] = {}
    for n in ep_nodes:
        for i in n.inputs:
            if not i:
                continue
            if i in dev_produced and i not in boundary:
                boundary.append(i)
            elif i in graph.constants:
                consts[i] = graph.constants[i]
            elif i in input_names and i not in consumed_inputs:
                consumed_inputs.append(i)

    # label transforms only apply to values leaving the device graph
    transforms = {k: v for k, v in transforms.items()
                  if k in graph.outputs or any(
                      k in n.inputs for n in ep_nodes)}
    for k in transforms:
        if k in dev_produced and k not in boundary \
                and k not in graph.outputs:
            boundary.append(k)
    if not ep_nodes and not transforms:
        return graph, None

    ep_outputs = [o for o in graph.outputs if o in epilogged]
    dev_outputs = [o for o in graph.outputs if o not in epilogged]
    extra = [b for b in boundary if b not in dev_outputs]
    dev_graph = dataclasses.replace(graph, nodes=dev_nodes,
                                    outputs=dev_outputs + extra)
    epilog = HostEpilog(ep_nodes, consts, transforms, boundary,
                        consumed_inputs, ep_outputs, extra)
    return dev_graph, epilog

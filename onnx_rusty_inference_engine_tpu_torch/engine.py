"""Inference engine: run a Graph node by node with PyTorch on one device.

The port's counterpart of onnx_rusty_inference_engine_tpu/engine.py. Where
the JAX package lowers the graph into one function and jit-compiles it, this
engine runs the same emitters eagerly under `torch.no_grad()`, in
topological order, on the device the caller names. Values known before the
run (Shape/Size of a tensor, and foldable arithmetic on such values) are
propagated statically, as the JAX lowering does at trace time.

On the card, `Engine.__call__` takes the place of JAX's `jax.jit`: the
first call for an input signature (names, shapes, dtypes, and the
ORIET_ATTN_I8 switch the attention emitter reads) runs eagerly, which
builds the kernels and fixes every static value, and then captures the
whole graph into one CUDA graph over static input and output buffers;
later calls copy the feed in, replay, and return copies the caller owns.
One Engine's graphs share one memory pool. On the CPU every call runs
eagerly.

`Engine(graph)` runs on the card; only an explicit `device="cpu"` runs on
the CPU. `dtype="bfloat16"` is the JAX Engine's policy: the graph's f32
weights go to the device as bf16, its other constants stay f32, f32 inputs
are cast to bf16 on the way in and bf16 outputs back to f32 on the way out;
mixed operands promote as in JAX (ops/standard.py::promote).

A graph that begins with string or image ops, or ends in maps and strings,
is split as in the JAX Engine (host.py): the host prolog runs in numpy
before the device graph and its numeric products join the feed (a new
product shape is a new signature, and so a new captured graph); the host
epilog runs after it on the device outputs it reads. Their outputs are
host values (numpy arrays, ZipMap's list of dicts) beside the device
tensors. A graph with no device outputs runs no device graph at all.

`Engine(mesh=, param_sharding_fn=, input_sharding_fn=)` is the JAX
Engine's sharded form on torch.distributed (parallel/spmd.py): every rank
of the mesh builds it and makes the same calls, holds only its shards of
the sharded weights, runs each node on its shards with the collectives
that make the outputs whole, and is captured and replayed as above, its
collectives inside the graph.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .graph import Graph, _node_from_proto
from .host import named_feed, split_host_epilog, split_host_prolog
from .ops.registry import (STATIC_OPS, LoweringContext, get_emitter,
                           node_label, prepare_subgraphs, subgraphs_of)
from .runtime import (Replay, capture, captures, collector_held,
                      resolve_device, side_stream, signature)
from .weights import as_device_tensor, params_from_numpy, prepack_int8_weights

__all__ = ["lower", "lower_packed", "node_label", "Engine",
           "InferenceResult", "resolve_device", "captures", "capture",
           "collector_held", "Replay", "signature", "side_stream",
           "run_captured"]


def lower(graph: Graph, device, packed: Optional[Dict[str, torch.Tensor]]
          = None, spmd=None):
    """Build `f(params: dict[str, Tensor], inputs: dict[str, Tensor]) ->
    dict[str, Tensor]` that runs the graph on `device`.

    `params` carries the graph's weights; the other constants (scales, zero
    points, folded values) are moved to the device here, once. `packed`
    holds the pre-packed QLinearConv and QLinearMatMul weights the kernels
    read on the card (`weights.prepack_int8_weights`; `Engine` makes
    them). `spmd`, for a sharded Engine, runs the nodes on this rank's
    shards with the mesh's collectives (parallel/spmd.py)."""
    fn = lower_packed(graph, device, spmd)
    packed = {} if packed is None else packed

    def bound(params, inputs, statics=None):
        return fn(params, packed, inputs, statics)

    return bound


def lower_packed(graph: Graph, device, spmd=None):
    """`lower`'s function with the packed weights an argument:
    `f(params, packed, inputs, statics=None)`. torch.export traces it
    (export_aot.py), so that the weights and the packed weights are inputs
    of the program, stored once beside it, and not constants inside it.

    Each emitter call runs inside a profiler range named
    `<OpType>.<node name>` (the node's first output where it has no name),
    the label of the JAX lowering's `jax.named_scope`, while a profiler is
    active; with none active no range is entered."""
    device = resolve_device(device)
    consts = params_from_numpy(
        {k: v for k, v in graph.constants.items()
         if k not in graph.weight_names
         and not (isinstance(v, np.ndarray) and v.dtype == object)},
        device)

    subgraphs = prepare_subgraphs(graph, device)

    def fn(params: Mapping[str, torch.Tensor],
           packed: Mapping[str, torch.Tensor],
           inputs: Mapping[str, torch.Tensor],
           statics: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """`statics`, where given, keeps the static values (numpy, and on
        the device) of one input signature: computed on the first call,
        reused after, so that a later call copies nothing from the host
        and may be captured into a CUDA graph."""
        env: Dict[str, torch.Tensor] = dict(consts)
        env.update(params)
        env.update(inputs)
        ctx = LoweringContext(graph, env, packed, device=device,
                              statics=statics, subgraphs=subgraphs)
        ctx.batch_polymorphic = _batch_polymorphic(graph, inputs)
        if spmd is not None:
            return spmd.run(ctx, graph, inputs)
        ctx.run_nodes(graph.nodes)
        return {o: env[o] for o in graph.outputs}

    return fn


def _batch_polymorphic(graph: Graph, inputs: Mapping[str, torch.Tensor]
                       ) -> bool:
    """Whether a run is batch-polymorphic, as the JAX lowering decides per
    trace: some input arrives at another leading dim than declared, or its
    declared leading dim is symbolic."""
    for s in graph.inputs:
        v = inputs.get(s.name)
        if v is None or not s.shape:
            continue
        d0 = s.shape[0]
        if isinstance(d0, str) or (v.dim() >= 1 and v.shape[0] != d0):
            return True
    return False


# the compute dtype policies Engine takes, by name
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _policy_dtype(dtype) -> torch.dtype:
    """`Engine(dtype=...)` as a torch dtype: "float32" or "bfloat16" (or
    those dtypes given as numpy or torch dtypes)."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    else:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise NotImplementedError(
            f"Engine dtype {dtype!r}: the policies are {sorted(_DTYPES)}")
    return _DTYPES[name]


def _with_policy(fn: Callable, dtype: torch.dtype) -> Callable:
    """fn with the JAX Engine's cast-in / cast-out around it: f32 inputs
    to `dtype`, `dtype` outputs back to f32 (engine.py:216-235 in the JAX
    package)."""
    if dtype == torch.float32:
        return fn

    def cast(params, inputs, statics=None):
        inputs = {k: v.to(dtype) if v.dtype == torch.float32 else v
                  for k, v in inputs.items()}
        out = fn(params, inputs, statics)
        return {k: _each(v, lambda t: t.to(torch.float32)
                         if t.dtype == dtype else t)
                for k, v in out.items()}

    return cast


def _each(v, fn):
    """fn of a tensor, or of each tensor of a sequence value (a list)."""
    return [fn(t) for t in v] if isinstance(v, list) else fn(v)


def _same_value(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


class _Captured:
    """One input signature's graph: static inputs, static outputs, the
    replay."""

    def __init__(self, inputs, outputs, replay):
        self.inputs = inputs
        self.outputs = outputs
        self.replay = replay


class InferenceResult:
    """Structured results: output name -> numpy array, plus wall latency."""

    def __init__(self, outputs: Dict[str, np.ndarray], latency_s: float):
        self.outputs = outputs
        self.latency_s = latency_s

    def __getitem__(self, name: str) -> np.ndarray:
        return self.outputs[name]

    def top_k(self, k: int = 1, output: Optional[str] = None) -> np.ndarray:
        name = output or next(iter(self.outputs))
        arr = self.outputs[name]
        flat = arr.reshape(arr.shape[0], -1)
        return np.argsort(flat, axis=-1)[:, ::-1][:, :k]

    def top1(self, output: Optional[str] = None) -> np.ndarray:
        return self.top_k(1, output)[:, 0]


class Engine:
    """Executor for one ONNX graph on one device.

    Parameters
    ----------
    graph: imported Graph.
    device: where it runs; "cuda" (the default) raises when no card is
        present, only an explicit "cpu" runs on the CPU.
    dtype: compute dtype policy for float tensors, "float32" or
        "bfloat16" (the graph's f32 weights held in bf16, f32 inputs cast
        in and bf16 outputs cast out).
    mesh / param_sharding_fn / input_sharding_fn: a DeviceMesh
        (parallel/mesh.py) and the rules (parallel/sharding.py) that place
        the weights and the inputs on it. Every rank of the mesh builds the
        Engine and makes the same calls; each holds only its shards of the
        sharded weights (`params`), runs each node on its shards and
        returns the whole outputs (parallel/spmd.py). `shard_routes` counts
        the last eager run's nodes by route. With mesh=None nothing
        changes.
    share_params_with: an Engine whose device weights this one reuses
        where a weight of the same name has the same value and the same
        dtype on the device under this Engine's policy (the decode graphs
        of one server's cache lengths share every weight and differ in
        their length-dependent tables; a bf16 prefill Engine shares no
        float weight with an f32 decode Engine).
    """

    def __init__(self, graph: Graph, *, device="cuda",
                 dtype: str = "float32",
                 mesh=None, param_sharding_fn=None, input_sharding_fn=None,
                 share_params_with: Optional["Engine"] = None):
        self.dtype = _policy_dtype(dtype)
        self.device = resolve_device(device)
        self.mesh = mesh
        # string / image front-end ops run on the host before the device
        # graph, map / string tails after it (host.py); a call takes the
        # graph's inputs and returns its outputs, wherever they are made
        self.input_names = list(graph.input_names)
        self.output_names = list(graph.outputs)
        self._host, graph = split_host_prolog(graph)
        graph, self._epilog = split_host_epilog(graph)
        # an op the port lacks fails here, not mid-run (subgraphs' too)
        for node in graph.nodes + [
                _node_from_proto(n) for g in subgraphs_of(graph.nodes)
                for n in g.nodes]:
            if node.op_type not in STATIC_OPS:
                get_emitter(node.op_type, node.domain)
        self._spmd = None
        if mesh is not None:
            from .parallel.spmd import SpmdRun, shard_graph

            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for an Engine "
                                 f"on {self.device}")
            graph, specs, routes = shard_graph(graph, mesh,
                                               param_sharding_fn)
            self._spmd = SpmdRun(mesh, specs, routes, input_sharding_fn)
        elif param_sharding_fn is not None or input_sharding_fn is not None:
            raise ValueError("param_sharding_fn / input_sharding_fn need a "
                             "mesh")
        self.graph = graph
        donor = share_params_with
        if donor is not None and set(donor.params) != set(graph.weight_names):
            raise ValueError("share_params_with: weight sets differ")
        shared = {} if donor is None else {
            k: donor.params[k] for k in graph.weight_names
            if donor.device == self.device
            and donor.params[k].dtype == self._held_dtype(graph.constants[k])
            and _same_value(graph.constants[k], donor.graph.constants[k])}
        self.params = {**shared, **params_from_numpy(
            {k: graph.constants[k] for k in graph.weight_names
             if k not in shared}, self.device, float32_as=self.dtype)}
        self.packed = prepack_int8_weights(graph, self.params)
        self._fn = _with_policy(lower(graph, self.device, self.packed,
                                      self._spmd), self.dtype)
        self._statics: Dict[tuple, dict] = {}    # signature -> static values
        self._graphs: Dict[tuple, _Captured] = {}  # signature -> its graph
        self._pool = None     # one memory pool for all of them
        self._stream = None   # the side stream they are captured on
        if self._spmd is not None and captures(self.device):
            # the communicators exist before the first capture
            from .parallel.collectives import all_reduce

            with torch.no_grad(), side_stream(self.side_stream()):
                for key in self._spmd.group_keys():
                    all_reduce(torch.zeros(1, device=self.device), key)

    @property
    def shard_routes(self) -> Optional[Dict[str, int]]:
        """A sharded Engine's nodes by route in its last eager run
        (parallel/spmd.py: the weight routes a-d, nodes run on local
        activation shards or on whole tensors, and the activation and
        output gathers); None without a mesh."""
        return None if self._spmd is None else dict(self._spmd.counts)

    def _held_dtype(self, value) -> torch.dtype:
        """The dtype a weight of this value has on the device under this
        Engine's policy."""
        if isinstance(value, torch.Tensor):
            dt = value.dtype
        else:
            dt = torch.from_numpy(np.zeros(0, np.asarray(value).dtype)).dtype
        return self.dtype if dt == torch.float32 else dt

    def _canon_inputs(self, inputs, device) -> Dict[str, torch.Tensor]:
        """The feed as name -> tensor on `device`; device None keeps a
        tensor where it is and puts an array on the CPU."""
        names = self.graph.input_names
        if isinstance(inputs, (list, tuple)):
            inputs = dict(zip(names, inputs))
        elif not isinstance(inputs, Mapping):
            inputs = {names[0]: inputs}
        return {k: v if device is None and isinstance(v, torch.Tensor)
                else as_device_tensor(v, device or "cpu")
                for k, v in inputs.items()}

    def side_stream(self):
        """The stream this Engine warms up and captures on, made once."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def graph_pool(self):
        """The memory pool this Engine's CUDA graphs share, made once."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    # -- API -----------------------------------------------------------
    def forward(self, feed: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Run the graph's function once, eagerly, on device tensors. The
        static values of the feed's signature are made on its first call
        and reused, so that a later call may be captured (the K-step
        decode graphs call this inside their capture)."""
        statics = self._statics.setdefault(signature(feed), {})
        return self._fn(self.params, feed, statics)

    def __call__(self, inputs) -> Dict[str, object]:
        """Run once; device outputs stay on the device and belong to the
        caller. On the card the first call of a signature runs eagerly and
        captures the graph; later calls replay it. The host prolog runs
        before, the host epilog after, where the graph has them."""
        if self._host is None and self._epilog is None:
            return self._device_call(inputs)
        feed = named_feed(inputs, self.input_names)
        host_out: Dict[str, object] = {}
        if self._host is not None:
            feed, host_out = self._host.split_feed(
                feed, self.graph.input_names, _numpy)
        out = self._device_call(feed) if self.graph.outputs else {}
        out.update(host_out)
        if self._epilog is not None:
            out = self._epilog.apply(out, feed, _numpy)
        return out

    def _device_call(self, inputs) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            if not captures(self.device):
                return self._fn(self.params,
                                self._canon_inputs(inputs, self.device))
            host = self._canon_inputs(inputs, None)
            key = signature(host)
            cap = self._graphs.get(key)
            if cap is None:
                feed = {k: v.to(self.device) for k, v in host.items()}
                return self._first_call(key, feed)
            for k, v in host.items():
                cap.inputs[k].copy_(v, non_blocking=v.device.type == "cuda")
            cap.replay()
            return {k: _each(v, torch.Tensor.clone)
                    for k, v in cap.outputs.items()}

    def _first_call(self, key: tuple, feed: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Run eagerly (the call's result), then capture the signature's
        graph over copies of the feed."""
        with side_stream(self.side_stream()) as s:
            out = self.forward(feed)
            static_in = {k: v.clone() for k, v in feed.items()}
            static_out, replay = capture(lambda: self.forward(static_in),
                                         stream=s, pool=self.graph_pool())
        self._graphs[key] = _Captured(static_in, static_out, replay)
        return out

    def run(self, inputs) -> InferenceResult:
        t0 = time.perf_counter()
        out = {k: to_host(v) for k, v in self(inputs).items()}
        return InferenceResult(out, time.perf_counter() - t0)


def run_captured(graphs: dict, key, body: Callable[[], None], eng: Engine,
                 generators=()) -> None:
    """Run `body()`, which reads and writes only tensors made before its
    first run (buffers the caller keeps), on `eng`'s device: on the CPU
    eagerly; on the card the first run for `key` is eager (it builds the
    kernels and fixes the static values) and is then captured into
    `graphs[key]` on `eng`'s side stream and memory pool; later runs replay
    that graph. `generators`: the torch.Generators body draws from. A
    capture that fails raises."""
    if not captures(eng.device):
        body()
        return
    replay = graphs.get(key)
    if replay is not None:
        replay()
        return
    with side_stream(eng.side_stream()) as s:
        body()
        _, graphs[key] = capture(body, stream=s, pool=eng.graph_pool(),
                                 generators=generators)


def _fetch(x: torch.Tensor) -> np.ndarray:
    """Device -> host for the generators' and servers' bookkeeping: a
    numpy copy (a CPU tensor's own memory would change under in-place
    cache writes)."""
    return x.detach().to("cpu", copy=True).numpy()


def _numpy(v):
    """A feed or output value on the host: a tensor as numpy, anything
    else as it is (numpy arrays, strings, ZipMap's maps)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def to_host(v):
    """An output as the caller gets it from `run`: numpy arrays; a
    sequence output a list of them; ZipMap's list of dicts as it is."""
    if isinstance(v, list):
        return [e if isinstance(e, dict) else np.asarray(_numpy(e))
                for e in v]
    return np.asarray(_numpy(v))

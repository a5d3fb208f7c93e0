"""Ahead-of-time export: an Engine's program and its weights as one file.

The port's counterpart of onnx_rusty_inference_engine_tpu/export_aot.py.
Where the JAX package serializes its jitted `f(params, inputs)` as
StableHLO with `jax.export`, this one traces the Engine's lowered function
`f(params, packed, inputs)` (engine.lower_packed, under the Engine's dtype
policy) with `torch.export.export` at the example inputs' static shapes
and bundles the serialized program with the weights into one `.npz`:

    p:{name}                weights (a bf16 one as its uint16 bits, listed
                            in the meta's `bf16_params`)
    k:{name}                the int8 kernels' pre-packed weights, so that
                            loading packs nothing
    __exported__:{platform} `torch.export.save` bytes, one program per
                            platform ("cpu", "cuda")
    __prolog__, __epilog__  the host stages (host.py), where the graph has
                            them: their nodes and constants as a small
                            serialized ONNX graph, as the JAX exporter
                            bundles them
    __meta__                JSON: format "oriet-aot-torch-v1", platforms,
                            inputs (shape, dtype), outputs, graph_name;
                            host_prolog / host_epilog where present

The weights are inputs of the program, stored once beside it, never
constants inside it. The hand kernels are `torch.library` ops
(`oriet::...`, ops/kernels/), which torch.export records as they are: a
loaded program runs the same kernels in the same order as the Engine, and
its outputs equal the Engine's bit for bit.

Loading (`load_exported`) parses no ONNX, builds no graph, looks up no
emitter and packs no weight: it imports the kernel modules (which register
the ops), deserializes the program for its device and places the weights
there. On the card the first call runs eagerly and captures a CUDA graph
(engine.capture, as `Engine.__call__` does: the same counters, the same
collector hold); later calls replay it. An exported program runs its convs
and matrix products under the caller's TF32 flags, so every call runs
under `utils.fp32.fp32_exact`, as the emitters do. Only an artifact with
host stages parses ONNX on load: its stages' small graphs, which run in
numpy before and after the program, as in the Engine.

A sharded Engine (parallel/spmd.py) exports as one program for every
rank: its collectives are `oriet::dist_*` ops that name their mesh dim's
group by key, and its input blocks are cut inside it at run time, so the
program holds no rank. Every rank calls `export_engine` (it gathers each
rank's shards to rank 0, which writes the file): the meta records
`nr_devices` and the mesh's shape, the replicated weights are stored once
(`p:{name}`) and each rank's shards and packed weights under its rank
(`p{r}:{name}`, `k{r}:{name}`). `load_exported(mesh=...)` on a world of at
least `nr_devices` ranks (it makes the mesh from the meta where none is
given) registers the mesh under the program's key and places this rank's
shards; a smaller world raises, as in the JAX package. A JAX artifact
(format "oriet-aot-v1", StableHLO) is refused by name; so is any other
file.
"""

from __future__ import annotations

import importlib
import io
import json
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .runtime import capture, captures, resolve_device, side_stream
from .utils.fp32 import fp32_exact

__all__ = ["export_engine", "export_graph", "ExportedModel",
           "load_exported", "FORMAT", "PLATFORMS"]

FORMAT = "oriet-aot-torch-v1"
JAX_FORMAT = "oriet-aot-v1"  # the JAX package's artifacts (StableHLO)
PLATFORMS = ("cpu", "cuda")


def _register_kernel_ops() -> None:
    """Import every kernel module: each registers its `oriet::` ops, which
    a serialized program names."""
    from .ops.kernels import (decode_attn, qconv_grouped_int8,  # noqa: F401
                              qconv_int8, qmatmul_int4, qmatmul_int8)


class _Program(torch.nn.Module):
    """The lowered function as the module torch.export traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, params, packed, inputs):
        return self.fn(params, packed, inputs)


def _on(tensors: Mapping[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """name -> tensor on `device`, names sorted (a program's pytree fixes
    the order of its dict inputs)."""
    return {k: tensors[k].to(device) for k in sorted(tensors)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's host value; bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    if bf16:
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def _stage_blob(nodes, constants: Mapping[str, np.ndarray]) -> np.ndarray:
    """A host stage's nodes and constants as a serialized ONNX graph (the
    JAX exporter's form), as uint8 for the npz."""
    from . import onnx_io
    from .models._builder import _attr

    gp = onnx_io.GraphProto(name="host_stage")
    for n in nodes:
        proto = onnx_io.NodeProto(op_type=n.op_type, input=list(n.inputs),
                                  output=list(n.outputs), name=n.name,
                                  domain=n.domain)
        for k, v in n.attrs.items():
            if not k.startswith("__"):
                proto.attributes[k] = _attr(k, v)
        gp.nodes.append(proto)
    gp.initializers = dict(constants)
    blob = onnx_io.serialize_model(
        onnx_io.ModelProto(graph=gp, opset_version=13))
    return np.frombuffer(blob, dtype=np.uint8)


def _stage_nodes(blob: np.ndarray):
    """(nodes, constants) of a `_stage_blob`."""
    from . import onnx_io
    from .graph import _node_from_proto

    m = onnx_io.parse_model(bytes(blob))
    return ([_node_from_proto(n) for n in m.graph.nodes],
            dict(m.graph.initializers))


def _platforms(engine, platforms: Optional[Sequence[str]]) -> List[str]:
    out = list(platforms) if platforms else [engine.device.type]
    for p in out:
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r}: the port exports for "
                             f"{list(PLATFORMS)}")
        resolve_device(p)  # "cuda" without a card raises
    return out


def export_engine(engine, example_inputs: Mapping[str, np.ndarray],
                  out_path: str,
                  platforms: Optional[Sequence[str]] = None) -> None:
    """Write `engine`'s program and weights to `out_path`.

    `example_inputs` fixes the (static) input shapes and dtypes the
    artifact accepts, as in the JAX package. `platforms` ("cpu", "cuda")
    defaults to the Engine's device; one program is traced per platform,
    each on that platform's device, over one copy of the weights. The
    int8 kernels' packed weights are the Engine's, or, for a CUDA program
    of a CPU Engine, packed here. A host prolog and epilog (host.py) are
    bundled beside the program, which holds the device graph only; the
    example inputs go through the prolog to give the device feed."""
    from .engine import _with_policy, lower_packed
    from .host import named_feed
    from .weights import prepack_int8_weights

    graph = engine.graph
    spmd = engine._spmd
    host, epilog = engine._host, engine._epilog
    platforms = _platforms(engine, platforms)
    if host is not None:
        example_inputs, _ = host.split_feed(
            named_feed(example_inputs, engine.input_names),
            graph.input_names, _host)
    feed = engine._canon_inputs(example_inputs, None)
    feed = {s.name: feed[s.name] for s in graph.inputs if s.name in feed}
    packed = engine.packed
    if not packed and "cuda" in platforms:
        packed = prepack_int8_weights(graph, _on(engine.params, "cuda"))
    programs = {}
    for p in platforms:
        dev = engine.device if engine.device.type == p else torch.device(p)
        fn = lower_packed(graph, dev, spmd)

        def program(params, packed, inputs, fn=fn):
            # a fresh set of static values, under the Engine's dtype policy
            return _with_policy(
                lambda prm, inp, st: fn(prm, packed, inp, st),
                engine.dtype)(params, inputs, {})

        module = _Program(program)
        args = (_on(engine.params, dev), _on(packed, dev),
                {k: v.to(dev) for k, v in feed.items()})
        with torch.no_grad():
            ep = torch.export.export(module, args)
        # torch.export.save would store the example inputs, and with them
        # every weight, a second time
        ep.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        programs[p] = buf.getvalue()
    bf16_params = sorted(k for k, v in engine.params.items()
                         if v.dtype == torch.bfloat16)
    meta = {
        "format": FORMAT,
        "platforms": platforms,
        "inputs": {k: {"shape": list(v.shape),
                       "dtype": str(v.dtype).split(".")[-1]}
                   for k, v in feed.items()},
        "outputs": list(engine.output_names),
        "graph_name": graph.name,
        "bf16_params": bf16_params,
        "params": sorted(engine.params),
        "packed": sorted(packed),
    }
    payload = {f"p:{k}": _to_numpy(v) for k, v in engine.params.items()}
    payload.update({f"k:{k}": _to_numpy(v) for k, v in packed.items()})
    if host is not None:
        meta["host_prolog"] = {
            "boundary": list(host.boundary),
            "host_outputs": list(host.host_outputs),
            "consumed_inputs": list(host.consumed_inputs),
            "orig_input_names": list(host.orig_input_names),
        }
        payload["__prolog__"] = _stage_blob(host.nodes, host.constants)
    if epilog is not None:
        meta["host_epilog"] = {
            "boundary": list(epilog.boundary),
            "consumed_inputs": list(epilog.consumed_inputs),
            "outputs": list(epilog.outputs),
            "extra_boundary": list(epilog.extra_boundary),
            "transforms": sorted(epilog.transforms),
        }
        consts = dict(epilog.constants)
        consts.update({f"__xform__:{k}": np.asarray(v, dtype=object)
                       for k, v in epilog.transforms.items()})
        payload["__epilog__"] = _stage_blob(epilog.nodes, consts)
    for p, blob in programs.items():
        payload[f"__exported__:{p}"] = np.frombuffer(blob, dtype=np.uint8)
    if spmd is not None:
        if not _rank_payload(engine, packed, meta, payload):
            return
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                        dtype=np.uint8)
    with open(out_path, "wb") as f:
        np.savez(f, **payload)
    if spmd is not None:
        import torch.distributed as dist

        dist.barrier()


def _rank_names(engine) -> List[str]:
    """A sharded Engine's weights that differ between ranks: the sharded
    ones and the per-output vectors cut for them."""
    return sorted(k for k in engine.params
                  if k in engine._spmd.specs or "@shard:" in k)


def _rank_payload(engine, packed, meta: dict, payload: dict) -> bool:
    """Gather every rank's shards and packed weights to rank 0 and put
    them in the payload under their ranks, with the mesh in the meta.
    True on rank 0 (which writes the file); the other ranks wait at the
    barrier (export_engine's last step)."""
    import torch.distributed as dist

    from .parallel.collectives import mesh_key
    from .parallel.mesh import axis_size

    mesh = engine.mesh
    own = _rank_names(engine)
    local = {f"p:{k}": _to_numpy(engine.params[k]) for k in own}
    local.update({f"k:{k}": _to_numpy(v) for k, v in packed.items()})
    world = dist.get_world_size()
    every = [None] * world if dist.get_rank() == 0 else None
    dist.gather_object(local, every, dst=0)
    if dist.get_rank() != 0:
        dist.barrier()
        return False
    for k in own:
        payload.pop(f"p:{k}")
    for k in packed:
        payload.pop(f"k:{k}")
    for r, part in enumerate(every):
        for k, v in part.items():
            payload[f"{k[0]}{r}:{k[2:]}"] = v
    meta.update(nr_devices=world,
                mesh={a: axis_size(mesh, a) for a in mesh.mesh_dim_names},
                mesh_key=mesh_key(mesh), rank_params=own)
    return True


def export_graph(graph, example_inputs: Mapping[str, np.ndarray],
                 out_path: str, *, dtype: str = "float32",
                 platforms: Optional[Sequence[str]] = None,
                 device="cuda") -> None:
    """Build an Engine on `device` (the card unless told "cpu") and export
    it."""
    from .engine import Engine

    export_engine(Engine(graph, dtype=dtype, device=device), example_inputs,
                  out_path, platforms=platforms)


class ExportedModel:
    """A loaded artifact on one device: callable like an Engine, with no
    ONNX importer, graph or op registry behind it.

    `__call__` returns the outputs as tensors on the device (the caller's
    own), and the host stages' outputs as host values; `run` all of them
    on the host. On the card the first call runs eagerly and captures the
    program into a CUDA graph over static input and output buffers; later
    calls copy the feed in and replay it, adding the launches the capture
    recorded to the kernel wrappers' counters. A host prolog runs before
    the program and an epilog after it, as in the Engine."""

    def __init__(self, program, params: Dict[str, torch.Tensor],
                 packed: Dict[str, torch.Tensor], meta: dict, device,
                 host=None, epilog=None):
        self.program = program
        t0 = time.perf_counter()
        self._module = program.module()
        # where loading went, seconds: load_exported's steps and this one
        self.load_split_s = {"module": time.perf_counter() - t0}
        self.params = params
        self.packed = packed
        self.meta = meta
        self.device = device
        self.input_specs: Dict[str, dict] = meta["inputs"]
        self.outputs: List[str] = meta["outputs"]
        self.platforms: List[str] = meta["platforms"]
        self._captured = None  # (static inputs, static outputs, replay)
        self._stream = None
        self._pool = None
        self._host = host      # host.HostProlog, or None
        self._epilog = epilog  # host.HostEpilog, or None

    def _feed(self, inputs) -> Dict[str, torch.Tensor]:
        """The feed as name -> tensor (on the CPU or where it lies), in
        the artifact's input order; a missing input or another shape or
        dtype than exported raises."""
        names = list(self.input_specs)
        if isinstance(inputs, (list, tuple)):
            inputs = dict(zip(names, inputs))
        elif not isinstance(inputs, Mapping):
            inputs = {names[0]: inputs}
        missing = set(names) - set(inputs)
        if missing:
            raise ValueError(f"missing inputs: {sorted(missing)}")
        feed = {}
        for name in names:
            v = inputs[name]
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v, copy=True))
            spec = self.input_specs[name]
            if (list(t.shape) != spec["shape"]
                    or str(t.dtype).split(".")[-1] != spec["dtype"]):
                raise ValueError(
                    f"input {name!r}: {str(t.dtype).split('.')[-1]} "
                    f"{list(t.shape)}, the artifact takes {spec['dtype']} "
                    f"{spec['shape']} (its shapes are static)")
            feed[name] = t
        return feed

    def forward(self, feed: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """One eager run of the program on device tensors."""
        with torch.no_grad(), fp32_exact():
            return dict(self._module(self.params, self.packed, feed))

    def __call__(self, inputs) -> Dict[str, object]:
        if self._host is None and self._epilog is None:
            return self._device_call(inputs)
        from .host import named_feed

        feed = named_feed(inputs, self._host.orig_input_names
                          if self._host is not None
                          else list(self.input_specs))
        host_out: Dict[str, object] = {}
        if self._host is not None:
            feed, host_out = self._host.split_feed(feed, self.input_specs,
                                                   _host)
        out = self._device_call(feed)
        out.update(host_out)
        if self._epilog is not None:
            out = self._epilog.apply(out, feed, _host)
        return out

    def _device_call(self, inputs) -> Dict[str, torch.Tensor]:
        host = self._feed(inputs)
        if not captures(self.device):
            return self.forward({k: v.to(self.device)
                                 for k, v in host.items()})
        if self._captured is None:
            return self._first_call({k: v.to(self.device)
                                     for k, v in host.items()})
        static_in, static_out, replay = self._captured
        for k, v in host.items():
            static_in[k].copy_(v, non_blocking=v.device.type == "cuda")
        replay()
        return {k: v.clone() for k, v in static_out.items()}

    def _first_call(self, feed: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Run eagerly (the call's result), then capture the program over
        copies of the feed."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        with side_stream(self._stream) as s:
            out = self.forward(feed)
            static_in = {k: v.clone() for k, v in feed.items()}
            static_out, replay = capture(lambda: self.forward(static_in),
                                         stream=s, pool=self._pool)
        self._captured = (static_in, static_out, replay)
        return out

    def run(self, inputs) -> Dict[str, np.ndarray]:
        return {k: _host(v) for k, v in self(inputs).items()}


def _host(v):
    """An output on the host: a tensor as numpy, bf16 as f32 (numpy has
    no bf16); a list element by element, ZipMap's maps as they are; a host
    value as it is."""
    if isinstance(v, list):
        return [_host(e) for e in v]
    if not isinstance(v, torch.Tensor):
        return v
    t = v.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _host_stages(z, meta: dict) -> tuple:
    """The artifact's host prolog and epilog (host.py), or None each."""
    host = epilog = None
    if "host_prolog" in meta:
        from .host import HostProlog

        nodes, consts = _stage_nodes(z["__prolog__"])
        hp = meta["host_prolog"]
        host = HostProlog(nodes, consts, hp["boundary"], hp["host_outputs"],
                          hp["consumed_inputs"], hp["orig_input_names"])
    if "host_epilog" in meta:
        from .host import HostEpilog

        nodes, consts = _stage_nodes(z["__epilog__"])
        he = meta["host_epilog"]
        xform = "__xform__:"
        transforms = {k[len(xform):]: v for k, v in consts.items()
                      if k.startswith(xform)}
        consts = {k: v for k, v in consts.items() if not k.startswith(xform)}
        epilog = HostEpilog(nodes, consts, transforms, he["boundary"],
                            he["consumed_inputs"], he["outputs"],
                            he["extra_boundary"])
    return host, epilog


def _mesh_for(path: str, meta: dict, mesh, dev):
    """The mesh a sharded artifact runs on, registered under the key its
    program names; raises where the world is smaller than the artifact's
    or the mesh has another shape."""
    import torch.distributed as dist

    from .parallel import collectives as C
    from .parallel.mesh import axis_size, make_mesh

    nr = int(meta.get("nr_devices", 1))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < nr:
        raise ValueError(f"{path}: artifact was exported for {nr} devices; "
                         f"only {world} available")
    if "mesh" not in meta:
        raise ValueError(f"{path}: a sharded artifact ({nr} devices) "
                         f"without its mesh in the meta")
    if mesh is None:
        mesh = make_mesh(meta["mesh"], device=dev)
    have = {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}
    if have != meta["mesh"]:
        raise ValueError(f"{path}: exported on the mesh {meta['mesh']}, "
                         f"given {have}")
    C.register_mesh(mesh)
    if C.mesh_key(mesh) != meta["mesh_key"]:
        raise ValueError(f"{path}: the program's mesh {meta['mesh_key']!r} "
                         f"is not {C.mesh_key(mesh)!r}")
    return mesh


def load_exported(path: str, device="cuda", mesh=None) -> ExportedModel:
    """Load an artifact written by `export_engine` onto `device` (the card
    unless told "cpu"). No graph, no op registry, no weight packing: the
    kernel modules register their ops, the program for the device is
    deserialized and the weights are placed there. ONNX is parsed only
    for an artifact's host stages. A sharded artifact runs on `mesh` (or
    one made from its meta) and needs a world of at least its
    `nr_devices` ranks; each rank places its own shards."""
    t0 = time.perf_counter()
    with np.load(path) as z:
        if "__meta__" not in z.files:
            raise ValueError(f"{path}: not an oriet AOT artifact (no meta)")
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        fmt = meta.get("format")
        if fmt == JAX_FORMAT:
            raise ValueError(
                f"{path}: not an oriet AOT artifact of this package: its "
                f"format {JAX_FORMAT!r} is the JAX package's (StableHLO); "
                f"the PyTorch port reads {FORMAT!r}")
        if fmt != FORMAT:
            raise ValueError(f"{path}: not an oriet AOT artifact (format="
                             f"{fmt!r}; the PyTorch port reads {FORMAT!r})")
        sharded = int(meta.get("nr_devices", 1)) > 1 or "mesh" in meta
        for stage, blob in (("host_prolog", "__prolog__"),
                            ("host_epilog", "__epilog__")):
            if stage in meta and blob not in z.files:
                raise ValueError(f"{path}: the meta names a {stage} but "
                                 f"the artifact has no {blob} stage")
        dev = resolve_device(device)
        if dev.type not in meta["platforms"]:
            raise ValueError(f"{path}: no program for {dev.type!r}; the "
                             f"artifact holds {meta['platforms']}")
        rank = ""
        if sharded:
            import torch.distributed as dist

            mesh = _mesh_for(path, meta, mesh, dev)
            rank = str(dist.get_rank())
        _register_kernel_ops()
        t1 = time.perf_counter()
        # torch.export.load imports torch._dynamo (and sympy): timed apart
        importlib.import_module("torch._dynamo")
        t2 = time.perf_counter()
        program = torch.export.load(
            io.BytesIO(bytes(z[f"__exported__:{dev.type}"])))
        t3 = time.perf_counter()
        bf16 = set(meta.get("bf16_params", ()))
        own = set(meta.get("rank_params", ()))
        params = {k: _from_numpy(z[f"p{rank if k in own else ''}:{k}"],
                                 k in bf16, dev)
                  for k in meta["params"]}
        packed = {k: _from_numpy(z[f"k{rank}:{k}"], False, dev)
                  for k in meta["packed"]}
        host, epilog = _host_stages(z, meta)
        t4 = time.perf_counter()
    model = ExportedModel(program, params, packed, meta, dev, host, epilog)
    model.load_split_s.update(meta_and_ops=t1 - t0, import_dynamo=t2 - t1,
                              deserialize=t3 - t2, weights=t4 - t3)
    return model

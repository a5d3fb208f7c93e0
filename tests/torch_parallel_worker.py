"""One rank of the PyTorch port's multi-process tests (gloo on the CPU).

    python tests/torch_parallel_worker.py RANK WORLD PORT JOB.json

JOB.json: {"dir": <work dir>, "timeout": <seconds a collective may take>,
"cases": [{"name": ..., "kind": ..., ...}, ...]}. Every rank runs every
case in order, making the same calls (SPMD); rank 0 writes each case's
outputs to <dir>/<name>.npz, and every rank writes what only it can show
(the local shapes of its shards) to <dir>/<name>.rank<R>.npz. A case that
raises writes <dir>/<name>.err.rank<R> and the worker goes on with the
next case. Models come from the port's seeded `models/` functions, or
as ONNX bytes and inputs that the test wrote (<dir>/<file>). It imports
only the port, never JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np
import torch

import onnx_rusty_inference_engine_tpu_torch as oriet
from onnx_rusty_inference_engine_tpu_torch.parallel import (
    Replicate, Shard, cnn_param_sharding, data_input_sharding,
    initialize_distributed, make_mesh, seq_input_sharding)

DEV = "cpu"


def north_star_rule(mesh):
    """tests/test_gpt2.py's rule on the port's placements: the packed int4
    weights [N, K/2] on N, their scales [2 nbh, N] on N, other 2-D
    weights whose last dim divides by 4 on it."""
    names = list(mesh.mesh_dim_names)
    i = names.index("model")

    def on(d):
        return tuple(Shard(d) if j == i else Replicate()
                     for j in range(len(names)))

    def rule(name, arr):
        if name.endswith("__w4") and arr.ndim == 2:
            return on(0)
        if name.endswith("__w4s"):
            return on(1)
        if arr.ndim == 2 and arr.shape[-1] % 4 == 0:
            return on(1)
        return tuple(Replicate() for _ in names)

    return rule


def row_rule(mesh):
    """Every weight on its contraction dim where it divides over "model":
    a conv's I, a 2-D MatMul weight's K, a planar int4 weight's packed
    K/2 (its scales replicated): the row-parallel route."""
    names = list(mesh.mesh_dim_names)
    i = names.index("model")
    n = int(mesh.shape[i])

    def on(d):
        return tuple(Shard(d) if j == i else Replicate()
                     for j in range(len(names)))

    def rule(name, arr):
        if arr.ndim == 4 and arr.shape[1] % n == 0:
            return on(1)
        if name.endswith("__w4") and arr.shape[1] % n == 0:
            return on(1)
        if arr.ndim == 2 and not name.endswith("__w4s") \
                and arr.shape[0] % n == 0:
            return on(0)
        return tuple(Replicate() for _ in names)

    return rule


def param_rule(name, mesh):
    if name is None:
        return None
    if name == "row":
        return row_rule(mesh)
    if name == "cnn":
        return cnn_param_sharding(mesh)
    if name == "north_star":
        return north_star_rule(mesh)
    if name == "moe":
        from onnx_rusty_inference_engine_tpu_torch.models.moe import \
            moe_param_sharding

        return moe_param_sharding(mesh, int(mesh.shape[
            list(mesh.mesh_dim_names).index("model")]))
    raise ValueError(name)


def input_rule(name, mesh):
    if name is None:
        return None
    return {"data": data_input_sharding, "seq": seq_input_sharding}[name](mesh)


def cfg_of(family: str, name: str = "TINY"):
    from onnx_rusty_inference_engine_tpu_torch import models

    mod = {"gpt2": models.gpt2, "llama": models.llama, "moe": models.moe,
           "t5": models.t5}[family]
    return getattr(mod, name)


def read_graph(d: str, c: dict):
    from onnx_rusty_inference_engine_tpu_torch.graph import import_onnx

    g = import_onnx(os.path.join(d, c["model"]))
    if c.get("quantize"):
        from onnx_rusty_inference_engine_tpu_torch.quant import quantize_graph

        calib = dict(np.load(os.path.join(d, c["calib"])))
        g = quantize_graph(g, calibration_inputs=[calib], device=DEV)
    if c.get("int4"):
        from onnx_rusty_inference_engine_tpu_torch.quant import \
            quantize_weights_int4

        g = quantize_weights_int4(g)
    return g


def npz(d: str, name: str) -> dict:
    return dict(np.load(os.path.join(d, name)))


def lora_bank(d: str, c: dict):
    """The adapter bank the test wrote: name -> (A, B), as A:<name> and
    B:<name> in an npz."""
    if not c.get("lora"):
        return None
    z = npz(d, c["lora"])
    return {k[2:]: (z[k], z["B:" + k[2:]]) for k in z if k.startswith("A:")}


# --------------------------------------------------------------------------
# cases: each returns (rank 0's outputs, this rank's own)
# --------------------------------------------------------------------------
def case_engine(d, c, mesh):
    g = read_graph(d, c)
    eng = oriet.Engine(g, device=DEV, mesh=mesh,
                       param_sharding_fn=param_rule(c.get("params"), mesh),
                       input_sharding_fn=input_rule(c.get("inputs"), mesh),
                       dtype=c.get("dtype", "float32"))
    out = eng(npz(d, c["feed"]))
    res = {k: v.numpy() for k, v in out.items()}
    res["__routes__"] = np.frombuffer(
        json.dumps(eng.shard_routes).encode(), np.uint8)
    own = {f"shape:{k}": np.asarray(v.shape) for k, v in eng.params.items()}
    return res, own


def case_mesh(d, c, mesh):
    names = list(mesh.mesh_dim_names)
    own = {f"local:{a}": np.asarray(mesh.get_local_rank(a)) for a in names}
    return {"names": np.asarray(names), "shape": np.asarray(mesh.shape)}, own


def case_pipeline(d, c, mesh):
    from onnx_rusty_inference_engine_tpu_torch.parallel import \
        PipelinedDecoder

    g = read_graph(d, c)
    pd = PipelinedDecoder(g, mesh, axis="pipe",
                          microbatches=c.get("microbatches"),
                          batch_inputs=c.get("batch_inputs"),
                          device=DEV)
    feed = npz(d, c["feed"])
    out = pd(dict(feed))
    res = {k: v.numpy() for k, v in out.items()}
    own = {f"shape:{k}": np.asarray(v.shape)
           for k, v in pd.params["layers"].items()}
    own["rows"] = np.asarray(pd.stage_rows)
    if c.get("roundtrip"):
        # two steps through stacked_call: the second from the first's
        # presents, which never leave their stage
        lo, hi = pd.stage_rows
        base = {"input_ids": feed["input_ids"], "pos": feed["pos"]}
        stacked = {f"past_{k}_0": torch.from_numpy(np.stack(
            [feed[f"past_{k}_{i}"] for i in range(lo, hi)]))
            for k in ("key", "value")}
        _, ext1 = pd.stacked_call(base, stacked)
        out2, ext2 = pd.stacked_call(
            {"input_ids": feed["input_ids"] + 1, "pos": feed["pos"] + 1},
            {f"past_{k}_0": ext1[f"present_{k}_0"] for k in ("key", "value")})
        res["step2:logits"] = out2["logits"].numpy()
        for k in ("key", "value"):
            own[f"step2:present_{k}"] = ext2[f"present_{k}_0"].numpy()
    return res, own


def case_generator(d, c, mesh):
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator

    kw = dict(c.get("kw", {}))
    gen = Generator(cfg_of(c.get("family", "gpt2")), device=DEV, mesh=mesh,
                    param_sharding_fn=param_rule(c.get("params"), mesh),
                    lora_bank=lora_bank(d, c), **kw)
    ids = npz(d, c["feed"])["input_ids"]
    toks, logits = gen.generate(ids, c["n_new"], return_logits=bool(
        c.get("return_logits")), **c.get("gen", {}))
    res = {"tokens": toks}
    if logits is not None:
        res["logits0"] = logits[0]
    own = {}
    if getattr(gen.decode, "params", None) is not None and \
            isinstance(gen.decode.params, dict) and "layers" in \
            gen.decode.params:
        own = {f"shape:{k}": np.asarray(v.shape)
               for k, v in gen.decode.params["layers"].items()}
    return res, own


def _serve(server, reqs):
    """Pre-queue every (prompt, n_new) in order, then start the server (the
    same admissions in the same order on every rank), collect the tokens
    and stop it."""
    futs = [server.submit(np.asarray(p, np.int64), int(n)) for p, n in reqs]
    server.start()
    out = [np.asarray(f.result(timeout=120)) for f in futs]
    server.stop()
    return {f"tokens{i}": t for i, t in enumerate(out)}, {}


def case_decode_server(d, c, mesh):
    from onnx_rusty_inference_engine_tpu_torch.serving import DecodeServer

    return _serve(DecodeServer(
        cfg_of(c.get("family", "gpt2")), device=DEV, mesh=mesh,
        autostart=False, param_sharding_fn=param_rule(c.get("params"), mesh),
        **c.get("kw", {})), c["reqs"])


def case_spec_server(d, c, mesh):
    import dataclasses

    from onnx_rusty_inference_engine_tpu_torch.serving import \
        SpeculativeServer

    tiny = cfg_of("gpt2")
    draft = dataclasses.replace(tiny, n_layer=c["draft_layers"])
    return _serve(SpeculativeServer(
        tiny, draft, device=DEV, mesh=mesh, autostart=False,
        param_sharding_fn=param_rule(c.get("params"), mesh),
        **c.get("kw", {})), c["reqs"])


def case_seq2seq_server(d, c, mesh):
    from onnx_rusty_inference_engine_tpu_torch.serving import Seq2SeqServer

    return _serve(Seq2SeqServer(
        cfg_of("t5"), device=DEV, mesh=mesh, autostart=False,
        param_sharding_fn=param_rule(c.get("params"), mesh),
        **c.get("kw", {})), c["reqs"])


def case_inference_server(d, c, mesh):
    from onnx_rusty_inference_engine_tpu_torch.serve import InferenceServer

    g = read_graph(d, c)
    eng = oriet.Engine(g, device=DEV, mesh=mesh,
                       param_sharding_fn=param_rule(c.get("params"), mesh),
                       input_sharding_fn=input_rule(c.get("inputs"), mesh))
    xs = npz(d, c["feed"])["x"]
    srv = InferenceServer(eng, batch_buckets=tuple(c["buckets"]),
                          autostart=False)
    futs = [srv.submit(xs[i:i + 1]) for i in range(len(xs))]
    srv.start()
    outs = [f.result(timeout=120) for f in futs]
    srv.stop()
    name = next(iter(outs[0]))
    return {"y": np.concatenate([np.asarray(o[name]) for o in outs])}, {}


def case_export(d, c, mesh):
    from onnx_rusty_inference_engine_tpu_torch.export_aot import (
        export_engine, load_exported)

    g = read_graph(d, c)
    eng = oriet.Engine(g, device=DEV, mesh=mesh,
                       param_sharding_fn=param_rule(c.get("params"), mesh),
                       input_sharding_fn=input_rule(c.get("inputs"), mesh))
    feed = npz(d, c["feed"])
    want = eng(feed)
    path = os.path.join(d, c["name"] + ".artifact.npz")
    export_engine(eng, feed, path, platforms=("cpu",))
    torch.distributed.barrier()
    model = load_exported(path, device=DEV, mesh=mesh)
    got = model(feed)
    res = {f"engine:{k}": v.numpy() for k, v in want.items()}
    res.update({f"loaded:{k}": np.asarray(v) for k, v in got.items()})
    res["nr_devices"] = np.asarray(model.meta["nr_devices"])
    return res, {}


def case_die(d, c, mesh):
    """Peer death while serving: rank `victim` exits once the decode loop
    has emitted tokens; every future pending on the other ranks must fail
    (the process group's timeout, gloo's peer error or the step_timeout
    watchdog), none may hang. Written by every survivor."""
    from concurrent.futures import TimeoutError as FutureTimeout

    from onnx_rusty_inference_engine_tpu_torch.serving import DecodeServer

    rank = torch.distributed.get_rank()
    srv = DecodeServer(cfg_of("gpt2"), device=DEV, mesh=mesh,
                       autostart=False,
                       param_sharding_fn=param_rule("cnn", mesh),
                       **c.get("kw", {}))
    seen = []

    def on_tok(_t):
        seen.append(1)
        if rank == c["victim"] and len(seen) >= 3:
            os._exit(3)

    srv.step_timeout = float(c["step_timeout"])
    futs = [srv.submit(np.asarray(p, np.int64), c["n_new"], on_token=on_tok)
            for p in c["prompts"]]
    srv.start()
    failed = hung = 0
    t0 = time.perf_counter()
    for f in futs:
        try:
            f.result(timeout=c["result_timeout"])
        except FutureTimeout:
            hung += 1
        except Exception:
            failed += 1
    own = {"failed": np.asarray(failed), "hung": np.asarray(hung),
           "n": np.asarray(len(futs)),
           "seconds": np.asarray(time.perf_counter() - t0)}
    np.savez(os.path.join(d, f"{c['name']}.rank{rank}.npz"), **own)
    # the dispatcher may still sit in a collective with the dead peer
    os._exit(0)


CASES = {k[5:]: v for k, v in globals().items() if k.startswith("case_")}


def main() -> int:
    rank, world, port, job = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    with open(job) as f:
        spec = json.load(f)
    d = spec["dir"]
    torch.manual_seed(0)
    initialize_distributed(f"localhost:{port}", world, rank, device=DEV,
                           timeout=float(spec.get("timeout", 60)))
    meshes = {}
    for c in spec["cases"]:
        t0 = time.perf_counter()
        try:
            axes = {k: int(v) for k, v in c["mesh"].items()}
            key = tuple(axes.items())
            if key not in meshes:
                meshes[key] = make_mesh(axes, device=DEV)
            res, own = CASES[c["kind"]](d, c, meshes[key])
            own["seconds"] = np.asarray(time.perf_counter() - t0)
            if rank == 0:
                np.savez(os.path.join(d, f"{c['name']}.npz"), **res)
            np.savez(os.path.join(d, f"{c['name']}.rank{rank}.npz"), **own)
        except Exception:
            with open(os.path.join(d, f"{c['name']}.err.rank{rank}"),
                      "w") as f:
                f.write(traceback.format_exc())
    torch.distributed.destroy_process_group()
    return 0


def run_ranks(world: int, cases: list, workdir: str, timeout: float = 240,
              collective_timeout: float = 60) -> list:
    """Run `cases` on `world` worker processes over gloo: [(rank, return
    code, stderr tail)]. Every process gets `timeout` seconds; on expiry
    all are killed (no test can hang on them)."""
    import socket
    import subprocess

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    job = os.path.join(workdir, f"job{port}.json")
    with open(job, "w") as f:
        json.dump({"dir": workdir, "timeout": collective_timeout,
                   "cases": cases}, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), job], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(world)]
    out = []
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                _, err = p.communicate()
                out.append((r, "timeout", err.decode()[-4000:]))
                continue
            out.append((r, p.returncode, err.decode()[-4000:]))
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()
    return out


def result(workdir: str, name: str, rank=None) -> dict:
    """A case's outputs (rank 0's), or one rank's own; a case that raised
    on any rank fails here with its traceback."""
    errs = sorted(f for f in os.listdir(workdir)
                  if f.startswith(f"{name}.err.rank"))
    if errs:
        with open(os.path.join(workdir, errs[0])) as f:
            raise AssertionError(f"{name} failed on {errs[0]}:\n{f.read()}")
    fn = f"{name}.npz" if rank is None else f"{name}.rank{rank}.npz"
    path = os.path.join(workdir, fn)
    if not os.path.exists(path):
        raise AssertionError(f"{name}: no {fn} (the workers did not finish)")
    return dict(np.load(path))


if __name__ == "__main__":
    sys.exit(main())

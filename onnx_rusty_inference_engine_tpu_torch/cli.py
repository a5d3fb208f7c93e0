"""Command-line interface: the port's copy of
onnx_rusty_inference_engine_tpu/cli.py.

    python -m onnx_rusty_inference_engine_tpu_torch.cli run --model m.onnx
        --input in.pb [--golden out.pb] [--batch N] [--quantize int8|w8a8]
        [--dtype float32|bfloat16] [--dump-stats] [--dump-tensors out.npz]
    ... bench --model m.onnx [--batch 64] [--steps 100] [--quantize ...]
    ... inspect --model m.onnx
    ... profile --model m.onnx [--trace-dir DIR] [--batch 8] [--steps 10]
    ... export --model m.onnx --out m.oriet.npz [--input in.pb]
        [--platforms cpu,cuda] [--quantize ...] [--dtype ...]
    ... run-exported --artifact m.oriet.npz --input in.pb [--golden out.pb]
    ... quantize --model m.onnx --out q.onnx [--calib-input in.pb]
        [--calibration minmax|percentile|mse] [--bias-correct]
    ... generate [--family gpt2|llama|moe|t5|asr] [--int4] [--kv-dtype int8]
        [--prefill-dtype float32|bfloat16|w8a8] [--adapters N --adapter K
        --lora-rank R] [--beam K] [--draft-layers N --spec-k k] ...
    ... serve --model m.onnx [--port 8000]          (POST /v1/infer)
    ... serve-llm [--family gpt2|llama|moe] [--draft-layers N --spec-k k]
        [--port 8001]                               (POST /v1/generate)

The subcommands take the JAX CLI's flags and print its JSON. The port adds
`--device` (default "cuda": the card, which raises where there is none;
"cpu" runs on the CPU): the JAX package picks its platform from the
environment, the port is told. `bench` reports the device by name
(`torch.cuda.get_device_name()`, or "cpu").
`profile` traces eager forwards (a replayed CUDA graph runs no Python, so
it would carry no node ranges) and says so in its JSON (`forwards`);
`export` writes the port's artifact (export_aot.py), which `run-exported`
runs with no ONNX importer behind it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np


def _split_input_spec(spec: str):
    """--input accepts "path.pb" or "name=path.pb". A plain path may itself
    contain '=' (runs/lr=0.1/x.pb), so only split when the whole string is
    not an existing file."""
    if "=" in spec and not os.path.exists(spec):
        name, _, path = spec.partition("=")
        return name, path
    return "", spec


def _read_feed(specs, graph) -> dict:
    from . import onnx_io

    feed = {}
    for spec_str in specs:
        name, path = _split_input_spec(spec_str)
        t = onnx_io.read_tensor_file(path)
        feed[name or t.name or graph.input_names[len(feed)]] = t.array
    return feed


def _build_engine(args, graph=None):
    from .engine import Engine
    from .graph import import_onnx

    graph = graph or import_onnx(args.model)
    if getattr(args, "quantize", None) == "int8":
        from .quant import quantize_graph

        calib = None
        inp = getattr(args, "input", None)
        if inp:
            calib = [_read_feed(inp if isinstance(inp, list) else [inp],
                                graph)]
        graph = quantize_graph(graph, calibration_inputs=calib,
                               device=args.device)
    elif getattr(args, "quantize", None) == "w8a8":
        # calibration-free dynamic W8A8: per-row activation scales in the
        # graph, the int8 x int8 products on the int8 kernel
        from .quant import quantize_matmuls_w8a8

        graph = quantize_matmuls_w8a8(graph)
    return Engine(graph, dtype=getattr(args, "dtype", "float32"),
                  device=args.device)


def cmd_run(args) -> int:
    from . import onnx_io
    from .graph import import_onnx

    graph = import_onnx(args.model)
    engine = _build_engine(args, graph)
    feed = {}
    for spec_str in args.input:
        name, path = _split_input_spec(spec_str)
        t = onnx_io.read_tensor_file(path)
        key = name or args.input_name or t.name or graph.input_names[
            len(feed)]
        x = t.array
        if args.batch and args.batch > 1:
            x = (x.repeat_interleave(args.batch, dim=0)
                 if not isinstance(x, np.ndarray)
                 else np.repeat(x, args.batch, axis=0))
        feed[key] = x

    if args.log_ops:
        for i, n in enumerate(graph.nodes):
            print(f"[node {i:3d}] {n.op_type:20s} {n.name} "
                  f"{n.inputs} -> {n.outputs}", file=sys.stderr)

    if args.dump_stats or args.dump_tensors:
        # every intermediate tensor from ONE eager probe-graph run
        # (debug.py), as the JAX CLI surfaces them
        from .debug import dump_intermediates, tensor_stats

        vals = dump_intermediates(graph, feed, device=args.device)
        if args.dump_tensors:
            np.savez(args.dump_tensors, **vals)
            print(f"wrote {len(vals)} tensors to {args.dump_tensors}",
                  file=sys.stderr)
        if args.dump_stats:
            for row in tensor_stats(vals):
                print(json.dumps(row), file=sys.stderr)

    res = engine.run(feed)
    print(json.dumps({
        "outputs": {k: v.reshape(v.shape[0], -1)[:, :16].tolist()
                    for k, v in res.outputs.items()},
        "output_shapes": {k: list(v.shape) for k, v in res.outputs.items()},
        "top1": res.top1().tolist(),
        "latency_s": res.latency_s,
    }, indent=2))

    if args.golden:
        g = onnx_io.read_tensor_file(args.golden)
        out_name = g.name if g.name in res.outputs else next(iter(res.outputs))
        got = res.outputs[out_name][:1].reshape(g.array.shape)
        ok = np.allclose(got, g.array, rtol=args.rtol, atol=args.atol)
        err = float(np.max(np.abs(got - g.array)))
        print(f"golden: {'MATCH' if ok else 'MISMATCH'} "
              f"(max_abs_err={err:.3e})")
        return 0 if ok else 1
    return 0


def _throughput(engine, feed: dict, steps: int) -> Tuple[float, str]:
    """(examples/s, device name): on the card from CUDA events over warmed,
    device-resident forwards; on the CPU, when asked for, by the host
    clock."""
    import torch

    if engine.device.type == "cuda":
        from .utils.timing import engine_throughput

        return (engine_throughput(engine, feed, iters=steps),
                torch.cuda.get_device_name(engine.device))
    engine(feed)  # warm up
    t0 = time.perf_counter()
    for _ in range(steps):
        engine(feed)
    sec = (time.perf_counter() - t0) / steps
    return int(next(iter(feed.values())).shape[0]) / sec, "cpu"


def cmd_bench(args) -> int:
    from .graph import import_onnx

    graph = import_onnx(args.model)
    engine = _build_engine(args, graph)
    spec = graph.inputs[0]
    shape = list(spec.concrete_shape(batch=args.batch))
    # the leading dim is the batch even where the file declares a static 1
    # (the JAX CLI keeps the 1 and reports --batch: cli.py:127-142)
    shape[0] = args.batch
    x = _standard_normal(np.random.default_rng(0), shape, spec.dtype)
    ips, device = _throughput(engine, {spec.name: x}, args.steps)
    print(json.dumps({
        "model": args.model,
        "batch": args.batch,
        "quantize": args.quantize,
        "images_per_sec": round(ips, 2),
        "latency_s_per_batch": round(args.batch / ips, 6),
        "steps": args.steps,
        "device": device,
    }))
    return 0


def cmd_inspect(args) -> int:
    from .graph import import_onnx
    from .ops.registry import supported_ops

    graph = import_onnx(args.model)
    counts = {}
    for n in graph.nodes:
        counts[n.op_type] = counts.get(n.op_type, 0) + 1
    have = set(supported_ops())
    print(json.dumps({
        "name": graph.name,
        "opset": graph.opset,
        "n_nodes": len(graph.nodes),
        "op_histogram": counts,
        "inputs": [{"name": i.name, "shape": list(i.shape),
                    "dtype": str(i.dtype).replace("torch.", "")}
                   for i in graph.inputs],
        "outputs": graph.outputs,
        "n_weights": len(graph.weight_names),
        "weight_bytes": int(sum(graph.constants[w].nbytes
                                for w in graph.weight_names)),
        "unsupported_ops": sorted(set(counts) - have),
    }, indent=2))
    return 0


def cmd_serve(args) -> int:
    from .http_serve import serve_http

    engine = _build_engine(args)
    print(f"serving on :{args.port} (POST /v1/infer)", file=sys.stderr)
    serve_http(engine, port=args.port)
    return 0


def cmd_quantize(args) -> int:
    from . import onnx_io
    from .graph import import_onnx, save_graph
    from .quant import QuantConfig, quantize_graph

    graph = import_onnx(args.model)
    calib = None
    if args.calib_input:
        t = onnx_io.read_tensor_file(args.calib_input)
        calib = [{t.name or graph.input_names[0]: t.array}]
    qgraph = quantize_graph(
        graph, calibration_inputs=calib,
        config=QuantConfig(calibration=args.calibration,
                           percentile=args.percentile),
        device=args.device)
    if args.bias_correct and calib:
        from .quant import bias_correct

        qgraph = bias_correct(qgraph, graph, calib, device=args.device)
    save_graph(args.out, qgraph)
    n_q = sum(1 for n in qgraph.nodes if n.op_type.startswith("QLinear"))
    print(json.dumps({"out": args.out, "qlinear_nodes": n_q,
                      "total_nodes": len(qgraph.nodes)}))
    return 0


def _standard_normal(rng, shape, dtype):
    """Standard-normal values of `shape` in an input's dtype: numpy, or a
    torch.bfloat16 tensor for a BFLOAT16 input (numpy has none here)."""
    import torch

    x = rng.standard_normal(shape)
    if dtype == torch.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return x.astype(dtype)


def _synthetic_feed(graph, batch: int) -> dict:
    """Every input at `batch`, standard-normal values in its dtype (the
    JAX CLI's synthetic feed)."""
    rng = np.random.default_rng(0)
    return {s.name: _standard_normal(rng, s.concrete_shape(batch=batch),
                                     s.dtype) for s in graph.inputs}


def cmd_profile(args) -> int:
    """Trace `--steps` eager forwards after a warm-up (utils/profiling.py):
    each node's kernels under a `<OpType>.<node name>` range, each hand
    kernel under its `oriet::` op."""
    import torch

    from .graph import import_onnx
    from .utils.profiling import trace

    graph = import_onnx(args.model)
    engine = _build_engine(args, graph)
    spec = graph.inputs[0]
    shape = list(spec.concrete_shape(batch=args.batch))
    shape[0] = args.batch  # as `bench`: the batch even over a static 1
    x = _standard_normal(np.random.default_rng(0), shape, spec.dtype)
    feed = {spec.name: torch.as_tensor(x, device=engine.device)}
    with torch.no_grad():
        engine.forward(feed)  # builds the kernels outside the trace
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        with trace(args.trace_dir):
            for _ in range(args.steps):
                engine.forward(feed)
    print(json.dumps({"trace_dir": args.trace_dir, "steps": args.steps,
                      "view": f"tensorboard --logdir {args.trace_dir}",
                      "forwards": "eager: a replayed CUDA graph runs no "
                                  "Python and carries no node ranges"}))
    return 0


def cmd_export(args) -> int:
    """Write the port's artifact (export_aot.py): the Engine's program and
    weights, optionally quantized first, for one or both platforms."""
    from .export_aot import export_engine
    from .graph import import_onnx

    graph = import_onnx(args.model)
    engine = _build_engine(args, graph)
    feed = (_read_feed(args.input, graph) if args.input
            else _synthetic_feed(graph, args.batch))
    platforms = args.platforms.split(",") if args.platforms else None
    export_engine(engine, feed, args.out, platforms=platforms)
    print(json.dumps({
        "artifact": args.out,
        "bytes": os.path.getsize(args.out),
        "platforms": platforms or [engine.device.type],
        "inputs": {k: list(np.shape(v)) for k, v in feed.items()},
    }))
    return 0


def cmd_run_exported(args) -> int:
    """Run an artifact: no ONNX importer, graph or op registry in the
    path (the .pb inputs are read with the tensor codec)."""
    from . import onnx_io
    from .export_aot import load_exported

    m = load_exported(args.artifact, device=args.device)
    feed = {}
    for spec_str in args.input:
        name, path = _split_input_spec(spec_str)
        t = onnx_io.read_tensor_file(path)
        feed[name or t.name or list(m.input_specs)[len(feed)]] = t.array
    t0 = time.perf_counter()
    out = m.run(feed)
    latency = time.perf_counter() - t0
    print(json.dumps({
        "outputs": {k: v.reshape(v.shape[0], -1)[:, :16].tolist()
                    for k, v in out.items()},
        "output_shapes": {k: list(v.shape) for k, v in out.items()},
        "latency_s": latency,
        "platforms": m.platforms,
    }, indent=2))
    if args.golden:
        g = onnx_io.read_tensor_file(args.golden)
        out_name = g.name if g.name in out else next(iter(out))
        got = out[out_name][:1].reshape(g.array.shape)
        ok = np.allclose(got, g.array, rtol=args.rtol, atol=args.atol)
        err = float(np.max(np.abs(got - g.array)))
        print(f"golden: {'MATCH' if ok else 'MISMATCH'} "
              f"(max_abs_err={err:.3e})")
        return 0 if ok else 1
    return 0


def _decoder_config(args):
    if args.family == "gpt2":
        from .models.gpt2 import GPT2Config

        return GPT2Config(vocab_size=args.vocab, n_positions=args.max_len,
                          n_embd=args.d, n_layer=args.layers,
                          n_head=args.heads)
    if args.family == "moe":
        from .models.moe import MoEConfig

        return MoEConfig(vocab_size=args.vocab, n_positions=args.max_len,
                         n_embd=args.d, n_layer=args.layers,
                         n_head=args.heads)
    from .models.llama import LlamaConfig

    return LlamaConfig(vocab_size=args.vocab, max_positions=args.max_len,
                       dim=args.d, n_layer=args.layers, n_head=args.heads,
                       n_kv_head=max(1, args.heads // 2))


def _generate_seq2seq(args) -> int:
    """generate --family t5|asr: a Seq2SeqGenerator over a TINY-sized
    model (t5 at the flags' widths, or a Seq2SeqBeamGenerator with --beam;
    asr at its TINY config on a 200 Hz tone of 512 samples)."""
    from .generate import Seq2SeqGenerator

    if args.family == "t5":
        from .models.t5 import T5Config

        cfg = T5Config(vocab_size=args.vocab, d_model=args.d,
                       n_layer=args.layers, n_head=args.heads,
                       d_ff=4 * args.d)
        src = np.asarray([int(t) for t in args.prompt_ids.split(",")],
                         dtype=np.int64)[None]
        if args.beam > 1:
            from .generate import Seq2SeqBeamGenerator

            bg = Seq2SeqBeamGenerator(cfg, batch=1, beam=args.beam,
                                      src_len=src.shape[1],
                                      max_len=args.max_len,
                                      device_loop=bool(args.device_loop),
                                      device=args.device)
            toks, scores = bg.generate(src, args.new)
            print(json.dumps({"family": "t5", "src": src[0].tolist(),
                              "generated": toks[0].tolist(),
                              "beam": args.beam,
                              "score": round(float(scores[0]), 4)}))
            return 0
        gen = Seq2SeqGenerator(cfg, batch=1, src_len=src.shape[1],
                               max_len=args.max_len,
                               kv_dtype=args.kv_dtype,
                               int4_weights=args.int4, device=args.device)
        toks, _ = gen.generate(src, args.new)
        print(json.dumps({"family": "t5", "src": src[0].tolist(),
                          "generated": toks[0].tolist(),
                          "kv_dtype": args.kv_dtype, "int4": args.int4}))
        return 0
    from .models.asr import TINY as ASR_TINY

    n = 512
    t = np.arange(n) / ASR_TINY.sample_rate
    audio = np.sin(2 * np.pi * 200 * t)[None].astype(np.float32)
    gen = Seq2SeqGenerator(ASR_TINY, batch=1, src_len=n,
                           max_len=min(args.max_len, ASR_TINY.n_positions),
                           family="asr", kv_dtype=args.kv_dtype,
                           device=args.device)
    toks, _ = gen.generate(audio, args.new)
    print(json.dumps({"family": "asr", "n_samples": n,
                      "generated": toks[0].tolist(),
                      "kv_dtype": args.kv_dtype}))
    return 0


def cmd_generate(args) -> int:
    from .generate import Generator

    if args.kv_dtype == "int4" and args.family not in ("gpt2", "llama"):
        print("error: --kv-dtype int4 needs a nibble-packing decode graph "
              "(gpt2/llama families)", file=sys.stderr)
        return 2
    if args.family in ("t5", "asr"):
        return _generate_seq2seq(args)
    cfg = _decoder_config(args)
    ids = np.asarray([int(t) for t in args.prompt_ids.split(",")],
                     dtype=np.int64)[None]
    if args.beam > 1:
        from .generate import BeamGenerator

        bg = BeamGenerator(cfg, batch=1, beam=args.beam,
                           prompt_len=ids.shape[1], max_len=args.max_len,
                           family=args.family, int4_weights=args.int4,
                           device_loop=bool(args.device_loop),
                           device=args.device)
        toks, scores = bg.generate(ids, args.new)
        print(json.dumps({"family": args.family, "prompt": ids[0].tolist(),
                          "generated": toks[0].tolist(), "beam": args.beam,
                          "score": round(float(scores[0]), 4)}))
        return 0
    if args.draft_layers:
        # lossless speculative decoding: a smaller same-vocab draft
        # proposes, the target verifies each chunk in one call
        import dataclasses

        from .generate import SpeculativeGenerator

        dcfg = dataclasses.replace(cfg, n_layer=args.draft_layers)
        gen = SpeculativeGenerator(
            cfg, dcfg, batch=1, prompt_len=ids.shape[1],
            max_len=args.max_len, k=args.spec_k, family=args.family,
            draft_seed=1, device=args.device)
        toks, _ = gen.generate(ids, args.new)
        print(json.dumps({"family": args.family, "prompt": ids[0].tolist(),
                          "generated": [int(t) for t in toks[0]],
                          "speculative": True,
                          "draft_layers": args.draft_layers,
                          "acceptance_rate": round(gen.acceptance_rate, 3)}))
        return 0
    lkw = {}
    if args.adapters:
        # a seeded bank over the attention and MLP projections; --adapter
        # selects the row's adapter (0 = the base model)
        from .graph import import_model
        from .lora import make_adapter_stack
        from .models import decoder_family

        build_prefill = decoder_family(args.family)[0]
        pg = import_model(build_prefill(cfg, batch=1,
                                        seq_len=ids.shape[1]))
        pats = (("attn", "mlp") if args.family in ("gpt2", "moe")
                else ("_wq", "_wk", "_wv", "_wo"))
        lkw = {"lora_bank": make_adapter_stack(
                   pg, n_adapters=args.adapters, rank=args.lora_rank,
                   targets=pats),
               "adapter": args.adapter}
    gen = Generator(cfg, batch=1, prompt_len=ids.shape[1],
                    max_len=args.max_len, kv_dtype=args.kv_dtype,
                    int4_weights=args.int4, family=args.family,
                    prefill_dtype=args.prefill_dtype,
                    device_loop=args.device_loop, device=args.device, **lkw)
    toks, _ = gen.generate(ids, args.new)
    out = {"family": args.family, "prompt": ids[0].tolist(),
           "generated": toks[0].tolist(),
           "kv_dtype": args.kv_dtype, "int4": args.int4}
    if args.adapters:
        out["adapter"] = args.adapter
    print(json.dumps(out))
    return 0


def cmd_serve_llm(args) -> int:
    from .http_serve import serve_generate_http
    from .serving import DecodeServer

    cfg = _decoder_config(args)
    if args.draft_layers:
        # lossless speculative serving: served tokens == target greedy.
        # SpeculativeServer runs fp32 weights and KV with no prompt cache:
        # refuse the flags it would silently ignore
        bad = [flag for flag, on in (
            ("--kv-dtype", args.kv_dtype != "float32"),
            ("--int4", args.int4),
            ("--len-buckets", bool(args.len_buckets)),
            ("--prefill-dtype", args.prefill_dtype != "float32"),
            ("--prompt-cache", args.prompt_cache)) if on]
        if bad:
            print(f"error: {', '.join(bad)} not supported with "
                  "--draft-layers (SpeculativeServer is fp32, no prompt "
                  "cache)", file=sys.stderr)
            return 2
        import dataclasses

        from .serving import SpeculativeServer

        dcfg = dataclasses.replace(cfg, n_layer=args.draft_layers)
        srv = SpeculativeServer(cfg, dcfg, slots=args.slots,
                                prompt_len=args.prompt_len,
                                max_len=args.max_len, k=args.spec_k,
                                family=args.family, draft_seed=1,
                                multi_step=args.multi_step,
                                device=args.device)
    else:
        lb = ([int(x) for x in args.len_buckets.split(",")]
              if args.len_buckets else None)
        srv = DecodeServer(cfg, slots=args.slots, prompt_len=args.prompt_len,
                           max_len=args.max_len, kv_dtype=args.kv_dtype,
                           int4_weights=args.int4, family=args.family,
                           multi_step=args.multi_step,
                           prompt_cache=args.prompt_cache,
                           prefill_dtype=args.prefill_dtype, len_buckets=lb,
                           device=args.device)
    if args.step_timeout > 0:
        srv.step_timeout = args.step_timeout   # armed by the dispatcher
    print(f"serving on :{args.port} (POST /v1/generate)", file=sys.stderr)
    serve_generate_http(srv, port=args.port)
    return 0


def _device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help='where to run: "cuda" (default; raises without a '
                        'CUDA device) or "cpu"')


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m onnx_rusty_inference_engine_tpu_torch.cli",
        description="ONNX inference in PyTorch on an NVIDIA H100 (the "
                    "PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a model on a TensorProto input")
    pr.add_argument("--model", required=True)
    pr.add_argument("--input", required=True, action="append",
                    help="TensorProto .pb; repeatable, optionally name=path")
    pr.add_argument("--golden")
    pr.add_argument("--input-name", dest="input_name")
    pr.add_argument("--batch", type=int, default=1)
    pr.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pr.add_argument("--quantize", choices=["int8", "w8a8"])
    pr.add_argument("--rtol", type=float, default=1e-4)
    pr.add_argument("--atol", type=float, default=1e-3)
    pr.add_argument("--log-ops", action="store_true",
                    help="per-node log (parity with reference debug_prints)")
    pr.add_argument("--dump-stats", action="store_true",
                    help="print per-intermediate-tensor min/max/mean/shape "
                         "JSON rows to stderr (probe-graph run)")
    pr.add_argument("--dump-tensors", metavar="OUT.npz",
                    help="save every intermediate tensor to a .npz")
    _device_flag(pr)
    pr.set_defaults(fn=cmd_run)

    pb = sub.add_parser("bench", help="throughput benchmark")
    pb.add_argument("--model", required=True)
    pb.add_argument("--batch", type=int, default=64)
    pb.add_argument("--steps", type=int, default=100)
    pb.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pb.add_argument("--quantize", choices=["int8", "w8a8"])
    pb.add_argument("--input")
    _device_flag(pb)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("inspect", help="print graph summary")
    pi.add_argument("--model", required=True)
    pi.set_defaults(fn=cmd_inspect)

    pp = sub.add_parser("profile", help="capture a torch.profiler trace "
                                        "with ONNX-node-name ranges")
    pp.add_argument("--model", required=True)
    pp.add_argument("--trace-dir", dest="trace_dir", default="/tmp/oriet_tb")
    pp.add_argument("--batch", type=int, default=8)
    pp.add_argument("--steps", type=int, default=10)
    pp.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pp.add_argument("--quantize", choices=["int8", "w8a8"])
    pp.add_argument("--input")
    _device_flag(pp)
    pp.set_defaults(fn=cmd_profile)

    pe = sub.add_parser("export",
                        help="AOT-export: the Engine's program (torch.export)"
                             " + weights as one artifact (load with "
                             "run-exported; no ONNX importer needed at serve "
                             "time)")
    pe.add_argument("--model", required=True)
    pe.add_argument("--out", required=True, help="artifact path (.npz)")
    pe.add_argument("--batch", type=int, default=1)
    pe.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pe.add_argument("--quantize", choices=["int8", "w8a8"])
    pe.add_argument("--input", action="append",
                    help="TensorProto .pb fixing input shapes (and int8 "
                         "calibration); default: synthetic at --batch")
    pe.add_argument("--platforms",
                    help='comma-separated targets, "cpu", "cuda" or '
                         '"cpu,cuda" (default: --device)')
    _device_flag(pe)
    pe.set_defaults(fn=cmd_export)

    pre = sub.add_parser("run-exported",
                         help="run an AOT artifact on a TensorProto input")
    pre.add_argument("--artifact", required=True)
    pre.add_argument("--input", required=True, action="append",
                     help="TensorProto .pb; repeatable, optionally name=path")
    pre.add_argument("--golden")
    pre.add_argument("--rtol", type=float, default=1e-4)
    pre.add_argument("--atol", type=float, default=1e-3)
    _device_flag(pre)
    pre.set_defaults(fn=cmd_run_exported)

    ps = sub.add_parser("serve", help="HTTP inference server "
                                      "(continuous batching)")
    ps.add_argument("--model", required=True)
    ps.add_argument("--port", type=int, default=8000)
    ps.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ps.add_argument("--quantize", choices=["int8", "w8a8"])
    ps.add_argument("--input")
    _device_flag(ps)
    ps.set_defaults(fn=cmd_serve)

    pg = sub.add_parser("generate",
                        help="greedy decode with a decoder family "
                             "(seeded weights; fixed-cache decode graph)")
    pg.add_argument("--prompt-ids", default="1,2,3,4",
                    help="comma-separated token ids")
    pg.add_argument("--new", type=int, default=8)
    pg.add_argument("--layers", type=int, default=2)
    pg.add_argument("--d", type=int, default=64)
    pg.add_argument("--heads", type=int, default=4)
    pg.add_argument("--vocab", type=int, default=256)
    pg.add_argument("--max-len", dest="max_len", type=int, default=64)
    pg.add_argument("--kv-dtype", dest="kv_dtype", default="float32",
                    choices=["float32", "int8", "int4"],
                    help="KV cache dtype: int8 = in-graph QDQ; int4 = "
                         "nibble-packed [B,H,L,hd/2] cache")
    pg.add_argument("--int4", action="store_true",
                    help="INT4 weight-only quantization")
    pg.add_argument("--prefill-dtype", dest="prefill_dtype",
                    default="float32",
                    choices=["float32", "bfloat16", "w8a8"],
                    help="prefill compute scheme: w8a8 = dynamic int8 x "
                         "int8 MatMuls in a bf16 prefill")
    pg.add_argument("--family", default="gpt2",
                    choices=["gpt2", "llama", "moe", "t5", "asr"])
    pg.add_argument("--draft-layers", dest="draft_layers", type=int,
                    default=0,
                    help="enable lossless speculative decoding with an "
                         "N-layer draft of the same family/vocab")
    pg.add_argument("--device-loop", dest="device_loop", type=int,
                    default=0, metavar="K",
                    help="run K decode steps per dispatch as one replayed "
                         "CUDA graph, sampling on the device; with --beam, "
                         "any nonzero value runs every beam step as one "
                         "graph")
    pg.add_argument("--spec-k", dest="spec_k", type=int, default=4,
                    help="speculation chunk size (draft proposes k-1)")
    pg.add_argument("--beam", type=int, default=1, metavar="K",
                    help="beam search with K beams (decoder families and "
                         "t5)")
    pg.add_argument("--adapters", type=int, default=0, metavar="N",
                    help="attach a seeded N-adapter LoRA bank (multi-LoRA "
                         "in one graph)")
    pg.add_argument("--adapter", type=int, default=0,
                    help="adapter index for the generation (0 = base)")
    pg.add_argument("--lora-rank", dest="lora_rank", type=int, default=8)
    _device_flag(pg)
    pg.set_defaults(fn=cmd_generate)

    psl = sub.add_parser("serve-llm",
                         help="HTTP generation server over the "
                              "continuous-batching slot pool")
    psl.add_argument("--port", type=int, default=8001)
    psl.add_argument("--slots", type=int, default=4)
    psl.add_argument("--prompt-len", dest="prompt_len", type=int, default=32)
    psl.add_argument("--layers", type=int, default=2)
    psl.add_argument("--d", type=int, default=64)
    psl.add_argument("--heads", type=int, default=4)
    psl.add_argument("--vocab", type=int, default=256)
    psl.add_argument("--max-len", dest="max_len", type=int, default=128)
    psl.add_argument("--kv-dtype", dest="kv_dtype", default="float32",
                     choices=["float32", "int8", "int4"])
    psl.add_argument("--int4", action="store_true")
    psl.add_argument("--prefill-dtype", dest="prefill_dtype",
                     default="float32",
                     choices=["float32", "bfloat16", "w8a8"],
                     help="bucketed-prefill compute scheme")
    psl.add_argument("--family", default="gpt2",
                     choices=["gpt2", "llama", "moe"])
    psl.add_argument("--multi-step", dest="multi_step", type=int, default=0,
                     metavar="K",
                     help="K decode steps per dispatch (greedy or sampled)")
    psl.add_argument("--len-buckets", dest="len_buckets", default="",
                     metavar="L1,L2,...",
                     help="KV cache length buckets (ascending, ending at "
                          "max-len): the pool runs at the smallest bucket "
                          "covering live requests")
    psl.add_argument("--draft-layers", dest="draft_layers", type=int,
                     default=0, metavar="N",
                     help="serve with lossless speculative decoding: an "
                          "N-layer same-vocab draft proposes, the target "
                          "verifies each chunk (SpeculativeServer)")
    psl.add_argument("--spec-k", dest="spec_k", type=int, default=4,
                     help="speculation chunk size (draft proposes k-1)")
    psl.add_argument("--prompt-cache", dest="prompt_cache", type=int,
                     default=0, metavar="N",
                     help="cache up to N prompts' KV (LRU): exact-match "
                          "replay skips the prefill; with chunked prefill, "
                          "shared prefixes stream only their suffix")
    psl.add_argument("--step-timeout", dest="step_timeout", type=float,
                     default=0.0, metavar="SECS",
                     help="failure-detection watchdog: a decode step stuck "
                          "past SECS fails pending requests with a clean "
                          "error instead of hanging clients")
    _device_flag(psl)
    psl.set_defaults(fn=cmd_serve_llm)

    pq = sub.add_parser("quantize",
                        help="offline INT8 PTQ: write a QLinear ONNX file")
    pq.add_argument("--model", required=True)
    pq.add_argument("--out", required=True)
    pq.add_argument("--calib-input", dest="calib_input",
                    help="TensorProto .pb used for range calibration")
    pq.add_argument("--calibration", default="minmax",
                    choices=["minmax", "percentile", "mse"],
                    help="activation-range calibration method")
    pq.add_argument("--percentile", type=float, default=99.99)
    pq.add_argument("--bias-correct", dest="bias_correct",
                    action="store_true",
                    help="post-quantization bias correction on the "
                         "--calib-input batch")
    _device_flag(pq)
    pq.set_defaults(fn=cmd_quantize)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

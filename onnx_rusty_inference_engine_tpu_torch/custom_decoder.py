"""Bring-your-own ONNX decoder: serve externally-produced decode graphs.
The port's copy of onnx_rusty_inference_engine_tpu/custom_decoder.py.

The built-in decoder families (models.decoder_family: gpt2, llama)
synthesize their graphs; this module lets a user plug ONNX files from
ANY exporter into the same drivers (generate.Generator,
serve_llm.DecodeServer), provided the pair follows the driver contract:

    prefill: input_ids [B, T]        -> logits [B, T, V] + present_*_i
    decode:  input_ids [B, 1], pos [B], past_key_i/past_value_i
             -> logits [B, 1, V] + present_key_i/present_value_i

Exports that use foreign tensor names (e.g. HF-style
"past_key_values.0.key") adapt via `rename` — a {foreign: contract}
mapping applied to the imported graph, weights included. Shapes are
validated against what the driver asks for, with a clear error instead
of a shape failure deep inside the engine.

    fam = onnx_decoder_family("prefill.onnx", "decode.onnx",
                              rename={"past_key_values.0.key": "past_key_0",
                                      ...})
    register_decoder_family("mymodel", *fam)
    DecodeServer(cfg, family="mymodel", ...)   # all serving features

`cfg` still describes the model (n_layer/n_head/head_dim/vocab_size) so
the drivers know the cache layout; any config object with those
attributes works (models.gpt2.GPT2Config is a convenient container).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .graph import Graph, InputSpec, Node, import_onnx

__all__ = ["rename_tensors", "onnx_decoder_family"]


def rename_tensors(graph: Graph, mapping: Dict[str, str]) -> Graph:
    """Rename tensors (graph inputs/outputs, node wires, constants)
    throughout `graph`. Control-flow subgraphs close over outer names;
    renaming across that boundary is not supported."""
    if not mapping:
        return graph
    for n in graph.nodes:
        if "__captures__" in n.attrs or any(
                hasattr(v, "nodes") for v in n.attrs.values()):
            if any(k in mapping for k in
                   list(n.attrs.get("__captures__", []))
                   + list(n.inputs) + list(n.outputs)):
                raise ValueError(
                    "rename_tensors: cannot rename across a control-flow "
                    f"subgraph boundary ({n.op_type})")

    def rn(name: str) -> str:
        return mapping.get(name, name)

    nodes = [Node(n.op_type, [rn(i) for i in n.inputs],
                  [rn(o) for o in n.outputs], n.name, dict(n.attrs),
                  n.domain) for n in graph.nodes]
    return Graph(
        name=graph.name,
        nodes=nodes,
        constants={rn(k): v for k, v in graph.constants.items()},
        inputs=[InputSpec(rn(i.name), i.shape, i.dtype)
                for i in graph.inputs],
        outputs=[rn(o) for o in graph.outputs],
        opset=graph.opset,
        opsets=dict(graph.opsets),
        weight_names=[rn(w) for w in graph.weight_names],
    )


def _check_input(graph: Graph, name: str, want, batch: int,
                 role: str) -> None:
    spec = next((s for s in graph.inputs if s.name == name), None)
    if spec is None:
        raise ValueError(
            f"{role} graph has no input '{name}' (inputs: "
            f"{[s.name for s in graph.inputs]}); pass rename= to map "
            "foreign names onto the driver contract")
    got = spec.concrete_shape(batch=batch)
    if want is not None and tuple(got) != tuple(want):
        raise ValueError(
            f"{role} graph input '{name}' is {tuple(got)}; the driver "
            f"needs {tuple(want)} — re-export the graph at that shape "
            "(static shapes are the contract; one graph per shape)")


def onnx_decoder_family(prefill_path: str, decode_path: str, *,
                        rename: Optional[Dict[str, str]] = None,
                        int8_kv_ok: bool = False):
    """(build_prefill, build_decode, int8_kv_ok) for
    models.register_decoder_family, backed by ONNX files.

    The files' shapes are fixed at export; the returned builders validate
    them against what the driver requests and raise a targeted error on
    mismatch instead of letting the engine fail on shapes."""

    def _load(path):
        g = import_onnx(path)
        return rename_tensors(g, rename) if rename else g

    def build_prefill(cfg, batch=1, seq_len=8, seed=0,
                      with_presents=True, **_):
        g = _load(prefill_path)
        _check_input(g, "input_ids", (batch, seq_len), batch, "prefill")
        if with_presents and "present_key_0" not in g.outputs:
            raise ValueError(
                "prefill graph does not emit present_key_0/... presents "
                "(needed to seed the decode cache)")
        return g

    def build_decode(cfg, batch=1, max_len=32, seed=0, **_):
        g = _load(decode_path)
        _check_input(g, "input_ids", (batch, 1), batch, "decode")
        _check_input(g, "pos", (batch,), batch, "decode")
        H = getattr(cfg, "n_kv_head", None) or cfg.n_head
        _check_input(g, "past_key_0",
                     (batch, H, max_len, cfg.head_dim), batch, "decode")
        for i in range(cfg.n_layer):
            for kind in ("key", "value"):
                _check_input(g, f"past_{kind}_{i}", None, batch, "decode")
                if f"present_{kind}_{i}" not in g.outputs:
                    raise ValueError(
                        f"decode graph missing output present_{kind}_{i}")
        return g

    return build_prefill, build_decode, int8_kv_ok

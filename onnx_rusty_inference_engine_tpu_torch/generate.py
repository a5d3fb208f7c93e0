"""Autoregressive generation for the ONNX decoder families (gpt2, llama,
and families registered with models.register_decoder_family), on one device.

The port's counterpart of onnx_rusty_inference_engine_tpu/generate.py::
Generator, with its host loop: a prefill graph runs the prompt at once and
returns the presents; a fixed-cache decode graph then runs one token per
step, and the KV cache stays on the device between steps (fp32; INT8; or
INT4 nibble-packed, two values a byte, for gpt2 and llama), the quantized
caches with per-(layer, kind, head) scales amax / 127 (INT4: amax / 7)
calibrated from the prefill presents. `cfg` is any config with `n_layer`
and `vocab_size`; the cache's shapes come from the graphs (GQA families
carry n_kv_head heads).
Token selection -- greedy, or temperature / top-k / top-p / min-p sampling
with a repetition penalty -- runs on the device, with a `torch.Generator`
seeded by `sample_seed`. Per step, only the eos check (and return_logits)
reads anything back to the host. Each step is one replay of the decode
Engine's captured graph.

`device_loop=K` runs K decode steps as one block, the counterpart of the
JAX Generator's `lax.scan` over time: the token, the position, the cache,
`done` and `seen` live in buffers on the device that the block advances in
place, and the host reads the block's [B, K] tokens and `done` once. On
the card the block's first run is eager and then the K steps (decode,
selection, the eos freeze, the position's +1) are captured into one CUDA
graph per sampling configuration, which later blocks replay; the sampling
`torch.Generator` is registered with the graph, so a replay draws what the
host loop draws. `return_logits=True` runs the host loop, as in JAX.

`prefill_dtype` sets the prefill Engine's scheme, as in JAX: "float32",
"bfloat16" (the bf16 dtype policy, engine.py), or "w8a8": a bf16 prefill
Engine on the graph quant.quantize_matmuls_w8a8 rewrote, whose MatMuls run
as int8 x int8 MatMulIntegers on the int8 kernel. With int4_weights the
"bfloat16" prefill runs the int4 graph (bf16 activations into the int4
kernels) and the "w8a8" rewrite takes the place of the prefill's int4
quantization; decode keeps its own scheme either way.

`Generator(...)` runs on the card; only an explicit `device="cpu"` runs on
the CPU, where every kernel is its plain version and a block is a Python
loop.

`scan_layers=True` decodes with the scan-over-layers graph (one Scan over
stacked per-layer weights): the cache is stacked, past_key / past_value
[n_layer, B, H, max_len, hd], the INT8 scales [n_layer, H], seeded from
the prefill's per-layer presents; the host loop, device_loop=K (K steps
replayed as one CUDA graph over the stacked cache) and the plain versions
on the CPU all take it.

`lora_bank` attaches a multi-LoRA bank (lora.py) to both graphs after the
int4 rewrite (the base trunk quantizes, the adapters stay fp32; the bank's
keys match through the `__w4` rename) and before the W8A8 one; `adapter`
(one index, or one per row) rides every prefill, step and block as the
`lora_idx` input, a device tensor that the captured graphs read by
address.

`mesh` / `param_sharding_fn` shard both Engines (parallel/spmd.py: each
rank holds its shards, the outputs are whole on every rank, so every rank
selects the same tokens). `pipeline_axis` runs both graphs as GPipe
pipelines over that mesh dim, one process a stage (parallel/pipeline.py):
each stage keeps its own layers' cache rows between steps and across the
K steps of a `device_loop` block, and a LoRA bank's per-layer matrices
stack per stage like any per-layer constant. It refuses scan_layers,
fused_attention and the w8a8 prefill, as in JAX.

`Seq2SeqGenerator` drives the encoder-decoder families (t5, asr): the
encoder Engine once per request, then a host loop over the captured
decode step (see its docstring).

Beyond greedy: `SpeculativeGenerator` (a draft proposes k - 1 tokens, the
target verifies k in one chunk call; greedy verification or host rejection
sampling), `BeamGenerator` over the decoder families and
`Seq2SeqBeamGenerator` over the encoder-decoder ones. Beams are batch
rows of one decode graph at batch B * K; the host keeps the scores and the
token history (`_beam_loop`, `_beam_finalize`, `_beam_backtrack`, numpy as
in the JAX package), and `device_loop=True` runs every beam step as one
CUDA graph (see `_BeamSteps`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .engine import Engine, _fetch, captures, resolve_device, run_captured
from .graph import Graph, import_model
from .ops.standard import _torch_dtype

__all__ = ["Generator", "Seq2SeqGenerator", "SpeculativeGenerator",
           "BeamGenerator", "Seq2SeqBeamGenerator"]


def _clone(v):
    """A tensor, a dict of tensors, or None, cloned."""
    if isinstance(v, dict):
        return {k: t.clone() for k, t in v.items()}
    return None if v is None else v.clone()


def _copy_into(dst, src) -> None:
    """Copy a tensor or a dict of tensors into buffers of the same form."""
    if isinstance(src, dict):
        for k, t in src.items():
            dst[k].copy_(t)
    elif src is not None:
        dst.copy_(src)


class Generator:
    def __init__(
        self,
        cfg,
        *,
        batch: int = 1,
        prompt_len: int = 8,
        max_len: int = 32,
        seed: int = 0,
        mesh=None,
        param_sharding_fn=None,
        kv_dtype: str = "float32",
        int4_weights: bool = False,
        family: str = "gpt2",
        scan_layers: bool = False,
        fused_attention: bool = False,
        prefill_dtype: str = "float32",
        device_loop: int = 0,
        pipeline_axis: Optional[str] = None,
        lora_bank=None,
        lora_alpha: float = 16.0,
        adapter=0,
        device="cuda",
    ):
        assert max_len >= prompt_len
        self.device = resolve_device(device)
        self.mesh = mesh
        self._param_sharding_fn = param_sharding_fn
        # pipeline parallelism: prefill AND decode trunks GPipe-staged over
        # mesh[pipeline_axis], one process a stage (parallel/pipeline.py);
        # the KV cache stays stacked [lps, B, H, max_len, hd] on its stage
        self.pipeline_axis = pipeline_axis
        self._pipelined = pipeline_axis is not None
        if self._pipelined:
            if mesh is None:
                raise ValueError("pipeline_axis requires a mesh")
            if scan_layers or fused_attention:
                raise NotImplementedError(
                    "pipeline_axis is incompatible with scan_layers/"
                    "fused_attention")
            if prefill_dtype == "w8a8":
                raise NotImplementedError(
                    "pipelined prefill supports float32/bfloat16; the "
                    "w8a8 dynamic-quant rewrite is not pipelined")
        self.cfg = cfg
        self.batch = batch
        self.prompt_len = prompt_len
        self.max_len = max_len
        # int4: the nibble-packed [B,H,L,hd/2] int8 cache; it takes every
        # int8 path, only the packing and the amax/7 scales differ
        self._int4_kv = kv_dtype == "int4"
        self.kv_dtype = np.dtype(np.int8 if self._int4_kv else kv_dtype)
        self._kv_q = self.kv_dtype == np.int8
        self._kv_qmax = 7.0 if self._int4_kv else 127.0

        from .models import decoder_family

        build_prefill, build_decode, int8_kv_ok = decoder_family(family)
        if self._int4_kv and family not in ("gpt2", "llama", "moe"):
            raise NotImplementedError(
                f"{family}: the int4 KV cache needs a nibble-packing decode "
                f"graph (gpt2 and llama, and moe)")
        if self._kv_q and not int8_kv_ok:
            raise NotImplementedError(
                f"{family}: in-graph quantized KV cache not implemented")
        dkw = {"kv_dtype": kv_dtype} if int8_kv_ok else {}
        # scan-over-layers decode graph: ONE Scan over stacked weights;
        # the cache I/O becomes stacked, past_key/past_value
        # [n_layer, B, H, max_len, hd] with kv_scale_key/_value [n_layer, H]
        self._stacked = bool(scan_layers)
        if scan_layers:
            dkw["scan_layers"] = True
        if fused_attention:
            # one kernel per layer over the int8 cache (ops/fused.py)
            dkw["fused_attention"] = True
        pkw = ({"past_len": 0, "with_presents": True} if family == "gpt2"
               else {"with_presents": True})
        prefill_graph = import_model(
            build_prefill(cfg, batch=batch, seq_len=prompt_len, seed=seed,
                          **pkw))
        decode_graph = import_model(
            build_decode(cfg, batch=batch, max_len=max_len, seed=seed,
                         **dkw))
        # w8a8: dynamic W8A8 MatMuls in a bf16 prefill Engine, in place of
        # the prefill's int4 quantization; decode keeps its own scheme
        w8a8_prefill = prefill_dtype == "w8a8"
        self.prefill_dtype = "bfloat16" if w8a8_prefill else prefill_dtype
        if int4_weights:
            from .quant import quantize_weights_int4

            if not w8a8_prefill:
                prefill_graph = quantize_weights_int4(prefill_graph)
            decode_graph = quantize_weights_int4(decode_graph)
        # multi-LoRA after int4 (the adapters stay fp32) and before W8A8
        # (whose rewrite then takes the base MatMuls and leaves the small
        # bank products floating)
        self._lora_idx: Optional[torch.Tensor] = None
        if lora_bank is not None:
            from .lora import attach_lora

            prefill_graph = attach_lora(prefill_graph, lora_bank,
                                        alpha=lora_alpha)
            decode_graph = attach_lora(decode_graph, lora_bank,
                                       alpha=lora_alpha)
            self._lora_idx = torch.as_tensor(np.broadcast_to(
                np.asarray(adapter, np.int64), (batch,)).copy(),
                device=self.device)
        if w8a8_prefill:
            from .quant import quantize_matmuls_w8a8

            prefill_graph = quantize_matmuls_w8a8(prefill_graph)
        self._engines(prefill_graph, decode_graph)
        # per-(layer, kind, head) scales, calibrated from the prefill (and
        # a pipelined decoder's stage rows of them)
        self._kv_scales: Optional[Dict[str, torch.Tensor]] = None
        self._pipe_scales: Optional[Dict[str, torch.Tensor]] = None
        self.device_loop = int(device_loop)

    def _engines(self, prefill_graph: Graph, decode_graph: Graph) -> None:
        if self._pipelined:
            from .parallel.pipeline import PipelinedDecoder

            # the decoder graphs carry the batch at dim 0 on every input
            # but the per-head kv_scale_* scales: declared, so that the
            # microbatching never relies on a dim == B coincidence
            def pipe(g, **kw):
                return PipelinedDecoder(
                    g, self.mesh, axis=self.pipeline_axis,
                    batch_inputs=[sp.name for sp in g.inputs
                                  if not sp.name.startswith("kv_scale_")],
                    device=self.device, **kw)

            self.prefill = pipe(prefill_graph, dtype=self.prefill_dtype)
            self.decode = pipe(decode_graph)
        else:
            ekw = dict(device=self.device, mesh=self.mesh,
                       param_sharding_fn=self._param_sharding_fn)
            self.prefill = Engine(prefill_graph, dtype=self.prefill_dtype,
                                  **ekw)
            self.decode = Engine(decode_graph, **ekw)
        self._gen: Optional[torch.Generator] = None
        # sampling configuration -> its K-step block (state and graph)
        self._blocks: Dict[tuple, dict] = {}

    def to(self, device) -> "Generator":
        """The same graphs and weights on another device (the KV scales
        calibrated so far come along)."""
        if self.mesh is not None:
            raise ValueError("Generator.to: a Generator on a mesh stays on "
                             "its mesh's devices")
        other = object.__new__(Generator)
        other.__dict__.update(self.__dict__)
        other.device = resolve_device(device)
        other._engines(self.prefill.graph, self.decode.graph)
        if self._kv_scales is not None:
            other._kv_scales = {k: v.to(other.device)
                                for k, v in self._kv_scales.items()}
        if self._lora_idx is not None:
            other._lora_idx = self._lora_idx.to(other.device)
        return other

    def _lora_feed(self, feed: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """The feed with the per-row adapter indices, where a bank is
        attached."""
        if self._lora_idx is not None:
            feed["lora_idx"] = self._lora_idx
        return feed

    # -- cache quantization (INT8 / INT4 KV; the decode GRAPH carries the
    # QDQ) -------------------------------------------------------------------
    def _store(self, kv: torch.Tensor, scale_name: str,
               layer: Optional[int] = None) -> torch.Tensor:
        """kv [B,H,L,hd] in the cache's form: quantized with the scales of
        `scale_name` (row `layer` of the stacked [L, H] scales)."""
        if self._int4_kv:
            from .quant import pack_int4_kv

            return pack_int4_kv(
                kv, self._kv_scales[scale_name].reshape(1, -1, 1, 1))
        if self._kv_q:
            s = self._kv_scales[scale_name]
            s = (s if layer is None else s[layer]).reshape(1, -1, 1, 1)
            return torch.clamp(torch.round(kv / s), -127, 127).to(torch.int8)
        return kv.to(torch.float32)

    def calibrate_kv(self, prefill_out: Dict[str, torch.Tensor]) -> None:
        """Per-(layer, kind, head) KV scales amax / 127 (INT4: amax / 7)
        from the prefill presents (kept once set, as in the JAX
        Generator)."""
        if not self._kv_q or self._kv_scales is not None:
            return
        # a division by a tensor on the device: a true division on the card
        # too (a CPU scalar divisor becomes a multiply by its reciprocal)
        qmax = torch.tensor(self._kv_qmax, dtype=torch.float32,
                            device=self.device)
        self._kv_scales = {}
        for i in range(self.cfg.n_layer):
            for kind in ("key", "value"):
                kv = prefill_out[f"present_{kind}_{i}"]
                amax = kv.abs().amax(dim=(0, 2, 3)).clamp_min(1e-6)
                self._kv_scales[f"kv_scale_{kind}_{i}"] = amax / qmax
        if self._stacked:  # the stacked graph takes kv_scale_key [L, H]
            self._kv_scales = {
                f"kv_scale_{kind}": torch.stack(
                    [self._kv_scales[f"kv_scale_{kind}_{i}"]
                     for i in range(self.cfg.n_layer)])
                for kind in ("key", "value")}

    # -- prefill and one decode step ---------------------------------------
    def start(self, input_ids) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run the prompt [B, prompt_len]: (logits [B, P, V], the fixed-size
        cache seeded with the prefill presents, padded to max_len)."""
        ids = torch.as_tensor(input_ids, dtype=torch.int64,
                              device=self.device)
        out = self.prefill(self._lora_feed({"input_ids": ids}))
        self.calibrate_kv(out)
        cache: Dict[str, torch.Tensor] = {}
        for kind in ("key", "value"):
            full = []
            for i in range(self.cfg.n_layer):
                kv = out[f"present_{kind}_{i}"]  # [B,H,P,hd]
                kv_full = F.pad(kv, (0, 0, 0, self.max_len - kv.shape[2]))
                if self._stacked:
                    full.append(self._store(kv_full, f"kv_scale_{kind}", i))
                else:
                    cache[f"past_{kind}_{i}"] = self._store(
                        kv_full, f"kv_scale_{kind}_{i}")
            if self._stacked:  # [L, B, H, max_len, hd]
                cache[f"past_{kind}"] = torch.stack(full)
        if self._pipelined:
            cache = self._stage_cache(cache)
        return out["logits"], cache

    def _stage_cache(self, cache: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """A pipelined decoder's cache: this stage's layers' rows of the
        per-layer cache stacked [lps, ...] under the canonical (layer 0)
        names, and their KV scales likewise (`_pipe_scales`)."""
        lo, hi = self.decode.stage_rows
        out = {f"past_{kind}_0": torch.stack(
            [cache[f"past_{kind}_{i}"] for i in range(lo, hi)])
            for kind in ("key", "value")}
        if self._pipe_scales is None:
            # made once, as the scales are: the K-step graphs read them
            # by address
            self._pipe_scales = {} if not self._kv_q else {
                f"kv_scale_{kind}_0": torch.stack(
                    [self._kv_scales[f"kv_scale_{kind}_{i}"]
                     for i in range(lo, hi)])
                for kind in ("key", "value")}
        return out

    def _decode(self, feed: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor], eager: bool
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One decode step from `feed` (tokens, positions, lora_idx) and the
        cache: (logits [B, 1, V], the updated cache). `eager` runs the
        decode graph's function itself (inside a K-step block), else its
        captured call. A pipelined decoder takes this stage's stacked
        cache and scales and returns this stage's presents."""
        if self._pipelined:
            stacked = {**cache, **self._pipe_scales}
            out, ext = self.decode.stacked_call(feed, stacked, eager=eager)
        else:
            feed.update(cache)  # int8 pasts flow straight back in
            if self._kv_q:
                feed.update(self._kv_scales)
            out = ext = (self.decode.forward if eager else self.decode)(feed)
        return out["logits"], {name: ext[name.replace("past_", "present_",
                                                      1)]
                               for name in cache}

    def step(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
             pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One decode step: tokens [B] at position `pos` -> (logits
        [B, 1, V], the updated cache)."""
        B = self.batch
        feed = {"input_ids": tokens.reshape(B, 1).to(torch.int64),
                "pos": torch.full((B,), pos, dtype=torch.int64,
                                  device=self.device)}
        return self._decode(self._lora_feed(feed), cache, eager=False)

    # -- token selection -----------------------------------------------------
    def _sampling_consts(self, temperature: float,
                         repetition_penalty: float) -> Dict[str, torch.Tensor]:
        """The device scalars `_select` divides and fills by, made once per
        generate call, outside any captured graph (a tensor made from a
        Python number is a copy from the host)."""
        dev = self.device
        return {"pen": torch.tensor(repetition_penalty, dtype=torch.float32,
                                    device=dev),
                "temp": torch.tensor(temperature, dtype=torch.float32,
                                     device=dev),
                "neg_inf": torch.tensor(-float("inf"), device=dev)}

    def _select(self, logits: torch.Tensor, gen: torch.Generator,
                consts: Dict[str, torch.Tensor],
                temperature: float, top_k: Optional[int],
                top_p: Optional[float], seen: Optional[torch.Tensor] = None,
                repetition_penalty: float = 1.0,
                min_p: Optional[float] = None) -> torch.Tensor:
        """logits [B, V] -> token ids [B]. temperature == 0 is greedy;
        otherwise categorical sampling (Gumbel-max, as
        jax.random.categorical) with optional top-k / nucleus / min-p
        filtering, all on the device. min_p keeps tokens with prob >=
        min_p * p_max. repetition_penalty > 1 applies the CTRL scheme to
        tokens already in the sequence (`seen` [B, V] bool): positive
        logits divided by the penalty, negative multiplied. Nothing here
        reads the device or copies from the host, so it may be captured."""
        if seen is not None and repetition_penalty != 1.0:
            p = consts["pen"]
            logits = torch.where(seen, torch.where(logits > 0, logits / p,
                                                   logits * p), logits)
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        neg_inf = consts["neg_inf"]
        l = logits / consts["temp"]
        if top_k is not None:
            kth = torch.sort(l, dim=-1).values[:, -int(top_k)][:, None]
            l = torch.where(l >= kth, l, neg_inf)
        if top_p is not None:
            sl = torch.sort(l, dim=-1, descending=True).values
            probs = torch.softmax(sl, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            # smallest set whose mass >= top_p: keep while cum - p < p_i
            keep = cum - probs < top_p
            thresh = torch.where(keep, sl, -neg_inf).amin(dim=-1,
                                                          keepdim=True)
            l = torch.where(l >= thresh, l, neg_inf)
        if min_p is not None:
            # scale-invariant tail cutoff: keep p >= min_p * p_max
            top = torch.where(torch.isfinite(l), l, neg_inf).amax(
                dim=-1, keepdim=True)
            l = torch.where(torch.exp(l - top) >= min_p, l, neg_inf)
        u = torch.rand(l.shape, generator=gen, device=l.device)
        return torch.argmax(l - torch.log(-torch.log(u)), dim=-1)

    def _generator(self, sample_seed: int) -> torch.Generator:
        """The sampling generator, seeded: one object per Generator, since
        the K-step graphs are registered with it."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(sample_seed))
        return self._gen

    # -- the K-step block (device_loop) -----------------------------------
    def _block_body(self, st: dict, sel: dict) -> None:
        """K decode steps on the block state `st`, in place: per step the
        decode graph, the penalty's `seen`, selection, the eos freeze; the
        tokens go to st["toks"] [B, K]. The same operations as the host
        loop's steps, and nothing reads the device: one CUDA graph."""
        tok, pos, cache, done, seen = (st["tok"], st["pos"], st["cache"],
                                       st["done"], st["seen"])
        eos_id = sel["eos_id"]
        for j in range(self.device_loop):
            feed = {"input_ids": tok.reshape(self.batch, 1), "pos": pos}
            logits, cache = self._decode(self._lora_feed(feed), cache,
                                         eager=True)
            if seen is not None:
                seen.scatter_(1, tok[:, None], True)
            tok = self._select(logits[:, -1, :], st["gen"],
                               st["consts"], sel["temperature"],
                               sel["top_k"], sel["top_p"], seen,
                               sel["repetition_penalty"], sel["min_p"])
            if eos_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_id), tok)
                done |= tok == eos_id
            st["toks"][:, j].copy_(tok)
            pos = pos + 1
        st["tok"].copy_(tok)
        st["pos"].copy_(pos)
        for name, v in cache.items():
            st["cache"][name].copy_(v)

    def _run_blocks(self, sel: dict, gen: torch.Generator, consts: dict,
                    next_tok: torch.Tensor, cache: Dict[str, torch.Tensor],
                    done: torch.Tensor, seen: Optional[torch.Tensor],
                    n_steps: int) -> List[np.ndarray]:
        """Decode `n_steps` tokens after `next_tok` in K-step blocks, with
        one read of the block's tokens and `done` each. Rows frozen on eos
        end the loop early, between blocks, as in JAX."""
        B, K = self.batch, self.device_loop
        fresh = {"tok": next_tok.to(torch.int64),
                 "pos": torch.full((B,), self.prompt_len, dtype=torch.int64,
                                   device=self.device),
                 "cache": cache, "done": done, "seen": seen}
        on_card = captures(self.device)
        key = tuple(sorted(sel.items())) + (bool(os.environ.get(
            "ORIET_ATTN_I8")),)
        blk = self._blocks.get(key) if on_card else None
        if blk is None:
            # the state the block advances, with the generator and the
            # device scalars it reads; on the card all of it stays with
            # the graph, which reads and writes it by address
            st = {k: _clone(v) for k, v in fresh.items()}
            st.update(toks=torch.zeros((B, K), dtype=torch.int64,
                                       device=self.device),
                      gen=gen, consts=consts)
            blk = {"st": st, "replay": None}
            if on_card:
                self._blocks[key] = blk
        else:
            for k, v in fresh.items():
                _copy_into(blk["st"][k], v)
        st = blk["st"]

        out: List[np.ndarray] = []
        while len(out) < n_steps:
            if sel["eos_id"] is not None and bool(st["done"].all()):
                break
            run_captured(blk, "replay", lambda: self._block_body(st, sel),
                         self.decode,
                         generators=(gen,) if sel["temperature"] else ())
            toks = st["toks"].cpu().numpy().copy()  # the CPU shares memory
            out.extend(toks[:, j] for j in range(min(K, n_steps - len(out))))
        return out

    # -- generation ------------------------------------------------------
    def generate(self, input_ids: np.ndarray, n_new: int,
                 return_logits: bool = False,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 sample_seed: int = 0,
                 eos_id: Optional[int] = None,
                 repetition_penalty: float = 1.0,
                 min_p: Optional[float] = None,
                 ) -> Tuple[np.ndarray, Optional[List[np.ndarray]]]:
        """Decode n_new tokens. Greedy by default; temperature > 0 samples
        (optionally top-k / top-p / min-p filtered). input_ids: [B,
        prompt_len]. Returns (tokens [B, n_new], the logits of the prefill
        and of every step as numpy arrays when return_logits, else None).

        eos_id: rows that emit it are frozen (keep emitting eos_id) and
        generation stops early once every row has finished.
        repetition_penalty: CTRL-style penalty on already-seen tokens
        (prompt + generated), applied on the device. With device_loop = K
        the steps run in K-step blocks (return_logits runs the host
        loop)."""
        B, P = tuple(input_ids.shape)
        assert (B, P) == (self.batch, self.prompt_len)
        assert P + n_new <= self.max_len
        dev = self.device
        use_pen = repetition_penalty != 1.0
        ids = torch.as_tensor(input_ids, dtype=torch.int64, device=dev)
        rows = torch.arange(B, device=dev)
        seen = None
        if use_pen:
            seen = torch.zeros((B, self.cfg.vocab_size), dtype=torch.bool,
                               device=dev)
            seen[rows[:, None], ids] = True
        gen = self._generator(sample_seed)
        consts = self._sampling_consts(temperature, repetition_penalty)
        sel = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                   repetition_penalty=repetition_penalty, min_p=min_p,
                   eos_id=eos_id)

        logits, cache = self.start(ids)
        next_tok = self._select(logits[:, -1, :], gen, consts, temperature,
                                top_k, top_p, seen, repetition_penalty,
                                min_p)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        if eos_id is not None:
            done |= next_tok == eos_id

        if self.device_loop > 0 and not return_logits:
            tokens = [next_tok.cpu().numpy()] + self._run_blocks(
                sel, gen, consts, next_tok, cache, done, seen, n_new - 1)
            out_toks = np.stack(tokens, axis=1)
        else:
            out_toks = self._host_loop(sel, gen, consts, next_tok, logits,
                                       cache, done, seen, n_new,
                                       return_logits)
        all_logits = None
        if return_logits:
            out_toks, all_logits = out_toks
        if eos_id is not None and out_toks.shape[1] < n_new:
            pad = np.full((B, n_new - out_toks.shape[1]), eos_id,
                          out_toks.dtype)
            out_toks = np.concatenate([out_toks, pad], axis=1)
        return out_toks, all_logits

    def _host_loop(self, sel, gen, consts, next_tok, logits, cache, done,
                   seen, n_new, return_logits):
        """One step per call: the decode graph's replay, then selection;
        `done` read after every step when eos_id is set."""
        P, eos_id = self.prompt_len, sel["eos_id"]
        tokens = [next_tok]
        all_logits = [logits.cpu().numpy()] if return_logits else None
        for t in range(n_new - 1):
            if eos_id is not None and not return_logits \
                    and bool(done.all()):
                break  # every row frozen; remaining output is eos padding
            step_logits, cache = self.step(cache, next_tok, P + t)
            if seen is not None:
                seen.scatter_(1, next_tok[:, None], True)
            next_tok = self._select(step_logits[:, -1, :], gen, consts,
                                    sel["temperature"], sel["top_k"],
                                    sel["top_p"], seen,
                                    sel["repetition_penalty"], sel["min_p"])
            if eos_id is not None:
                # frozen rows keep emitting eos
                next_tok = torch.where(done, torch.full_like(next_tok,
                                                             eos_id),
                                       next_tok)
                done |= next_tok == eos_id
            tokens.append(next_tok)
            if return_logits:
                all_logits.append(step_logits.cpu().numpy())
        out_toks = torch.stack(tokens, dim=1).cpu().numpy()
        return (out_toks, all_logits) if return_logits else out_toks


class Seq2SeqGenerator:
    """Encoder-decoder generation (models.seq2seq_family: "t5" tokens ->
    tokens, "asr" waveform -> tokens): encode once, then greedy or sampled
    decode over a fixed self-attention KV cache and the static cross K/V.
    The port's counterpart of the JAX package's Seq2SeqGenerator, with its
    host loop.

    The encoder (with the cross-KV projection) is one Engine call per
    request, a captured graph on the card. The decode step is one captured
    graph per decode Engine, replayed once per token: it reads the token,
    the position, the cache, the cross K/V (and `src_len`) from buffers
    made once, writes the presents back into the cache buffers and the
    logits into a buffer. The cross K/V are copied into their buffers once
    per request. The cache, the calibration's amax and the tokens stay on
    the device; the tokens are read once at the end (the logits once per
    step, where the caller asks for them).

    kv_dtype="int8": the decoder has no prefill to calibrate from, so the
    first `calib_steps` tokens run a shadow fp32 decode graph and collect
    the per-(layer, kind, head) amax over its cache; the fp32 cache is then
    quantized once (`quantize_cache`: scales max(amax, 1e-6) / 127, round
    half to even, both divisions true ones on the device) and generation
    goes on in the int8-QDQ graph.

    Sampling keeps Generator's seed contract: a torch.Generator seeded
    with `sample_seed` (reproducible, not JAX's PRNG values); greedy is
    argmax. Runs on the card unless `device="cpu"`.
    """

    # the device selection of Generator, with its sampling scalars and its
    # seeded torch.Generator
    _select = Generator._select
    _sampling_consts = Generator._sampling_consts
    _generator = Generator._generator

    def __init__(
        self,
        cfg,
        *,
        batch: int = 1,
        src_len: int = 16,
        max_len: int = 32,
        seed: int = 0,
        mesh=None,
        param_sharding_fn=None,
        kv_dtype: str = "float32",
        int4_weights: bool = False,
        calib_steps: int = 4,
        family: str = "t5",
        device="cuda",
    ):
        from .models import seq2seq_family

        self.device = resolve_device(device)
        self.fam = seq2seq_family(family)
        self.cfg = cfg
        self.batch = batch
        self.src_len = src_len
        self.enc_len = self.fam.enc_len(cfg, src_len)
        self.max_len = max_len
        self.kv_dtype = np.dtype(kv_dtype)
        self._int8 = self.kv_dtype == np.int8
        if self._int8 and calib_steps < 1:
            raise ValueError("int8 KV needs calib_steps >= 1 (the shadow "
                             "fp32 steps that set the scales)")
        self.calib_steps = calib_steps

        def decode_graph(**kw):
            return import_model(self.fam.build_decode(
                cfg, batch=batch, max_len=max_len, src_len=self.enc_len,
                seed=seed, **kw))

        graphs = [import_model(self.fam.build_encoder(
            cfg, batch=batch, src_len=src_len, seed=seed)),
            decode_graph(kv_dtype=kv_dtype)]
        if self._int8:
            graphs.append(decode_graph())
        if int4_weights:
            from .quant import quantize_weights_int4

            graphs = [quantize_weights_int4(g) for g in graphs]
        ekw = dict(device=self.device, mesh=mesh,
                   param_sharding_fn=param_sharding_fn)
        self.encoder = Engine(graphs[0], **ekw)
        self.decode = Engine(graphs[1], **ekw)
        self.decode_fp32 = Engine(graphs[2], **ekw) if self._int8 else None
        self._gen: Optional[torch.Generator] = None
        self._bufs: Optional[dict] = None
        self._steps: Dict[str, object] = {}   # engine -> its step's Replay
        self._t = 0

    # -- the step's buffers and graph ----------------------------------------
    def _buffers(self) -> dict:
        """Every tensor the captured steps read or write, made once."""
        if self._bufs is None:
            dev, B = self.device, self.batch
            specs = {s.name: s for s in self.decode.graph.inputs}

            def zeros(name, dtype):
                return torch.zeros(specs[name].concrete_shape(batch=B),
                                   dtype=dtype, device=dev)

            past = [n for n in specs if n.startswith("past_")]
            bufs = {
                "tok": torch.zeros((B,), dtype=torch.int64, device=dev),
                "pos": torch.zeros((B,), dtype=torch.int64, device=dev),
                "cross": {n: zeros(n, torch.float32) for n in specs
                          if n.startswith("cross_")},
                "cache32": {n: zeros(n, torch.float32) for n in past},
                "logits": torch.zeros(
                    (B, 1, self.cfg.vocab_size), dtype=torch.float32,
                    device=dev)}
            if self.fam.src_mask:
                bufs["cross"]["src_len"] = zeros("src_len", torch.int64)
            if self._int8:
                bufs["cache8"] = {n: zeros(n, torch.int8) for n in past}
                bufs["scales"] = {n: zeros(n, torch.float32) for n in specs
                                  if n.startswith("kv_scale_")}
            self._bufs = bufs
        return self._bufs

    def _step_body(self, eng: Engine, cache: dict, scales: dict) -> None:
        """One decode step on the buffers, in place: nothing here reads
        the device or copies from the host, so it may be captured."""
        b = self._bufs
        feed = {"input_ids": b["tok"].reshape(self.batch, 1),
                "pos": b["pos"]}
        feed.update(b["cross"])
        feed.update(cache)
        feed.update(scales)
        out = eng.forward(feed)
        for name, buf in cache.items():
            buf.copy_(out[name.replace("past_", "present_", 1)])
        b["logits"].copy_(out["logits"])

    def _run_step(self, calibrating: bool) -> None:
        """The step on the shadow fp32 graph (calibrating, or the fp32 KV
        path) or on the int8 graph: its replay, captured after an eager
        first run on the card."""
        b = self._bufs
        if self._int8 and not calibrating:
            eng, cache, scales = self.decode, b["cache8"], b["scales"]
        else:
            eng, cache, scales = (self.decode_fp32 or self.decode,
                                  b["cache32"], {})
        run_captured(self._steps, "int8" if scales else "fp32",
                     lambda: self._step_body(eng, cache, scales), eng)

    # -- encode, step, quantize ----------------------------------------------
    def start(self, src_ids: np.ndarray,
              src_lengths: Optional[np.ndarray] = None
              ) -> Dict[str, torch.Tensor]:
        """Encode the source [B, src_len] (tokens or waveform, per family)
        and reset the decode state: the cross K/V (and `src_len`) go into
        the step's buffers, the cache is zeroed. Returns the encoder's
        outputs (enc_out and the cross K/V) on the device."""
        B, S = tuple(src_ids.shape)
        assert (B, S) == (self.batch, self.src_len)
        b = self._buffers()
        if src_lengths is None:
            src_lengths = np.full((B,), S, np.int64)
        feed = {self.fam.enc_input: np.asarray(src_ids).astype(
            self.fam.prompt_dtype)}
        if self.fam.src_mask:
            feed["src_len"] = np.asarray(src_lengths).astype(np.int64)
            b["cross"]["src_len"].copy_(torch.from_numpy(feed["src_len"]))
        enc = self.encoder(feed)
        for name, buf in b["cross"].items():
            if name.startswith("cross_"):
                buf.copy_(enc[name])
        for cache in (b["cache32"], b.get("cache8", {})):
            for buf in cache.values():
                buf.zero_()
        self._amax: Dict[str, torch.Tensor] = {}
        self._t = 0
        return enc

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step at the next position: tokens [B] -> logits
        [B, 1, V] (a fresh tensor on the device). With an int8 cache, the
        first calib_steps steps run the shadow fp32 graph and collect the
        amax; the last of them quantizes the cache."""
        b, t = self._bufs, self._t
        b["tok"].copy_(tokens.reshape(-1))
        b["pos"].fill_(t)
        calibrating = self._int8 and t < self.calib_steps
        self._run_step(calibrating)
        if calibrating:
            for name, kv in b["cache32"].items():
                a = kv.abs().amax(dim=(0, 2, 3))
                prev = self._amax.get(name)
                self._amax[name] = a if prev is None else torch.maximum(
                    prev, a)
            if t == self.calib_steps - 1:
                scales, cache8 = self.quantize_cache(self._amax,
                                                     b["cache32"])
                for name, v in scales.items():
                    b["scales"][name].copy_(v)
                for name, v in cache8.items():
                    b["cache8"][name].copy_(v)
        self._t = t + 1
        return b["logits"].clone()

    def quantize_cache(self, amax: Dict[str, torch.Tensor],
                       cache: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
        """The switch to int8: per-(layer, kind, head) scales
        max(amax, 1e-6) / 127 (kv_scale_{kind}_{i}) and the fp32 cache
        quantized with them (past_{kind}_{i}, int8). Both divisions are by
        a device tensor: a true division on the card too, as the JAX
        package's numpy and jnp divisions are."""
        qmax = torch.tensor(127.0, dtype=torch.float32, device=self.device)
        scales, q = {}, {}
        for name, kv in cache.items():
            kind, i = name.split("_")[1], name.rsplit("_", 1)[1]
            s = amax[name].clamp_min(1e-6) / qmax
            scales[f"kv_scale_{kind}_{i}"] = s
            q[name] = torch.clamp(torch.round(kv / s.reshape(1, -1, 1, 1)),
                                  -127, 127).to(torch.int8)
        return scales, q

    # -- generation ------------------------------------------------------
    def generate(self, src_ids: np.ndarray, n_new: int,
                 start_token: int = 0,
                 return_logits: bool = False,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 sample_seed: int = 0,
                 src_lengths: Optional[np.ndarray] = None):
        """Encode the source [B, src_len] (tokens or waveform, per
        family); decode n_new tokens. src_lengths [B]: true per-row
        source lengths for padding-masked families (default: full).
        Returns (tokens [B, n_new], every step's logits as numpy arrays
        when return_logits, else None)."""
        assert n_new <= self.max_len
        if self._int8 and n_new <= self.calib_steps:
            import logging
            logging.getLogger(__name__).warning(
                "n_new=%d <= calib_steps=%d: every step runs the shadow "
                "fp32 graph; the int8 cache never engages", n_new,
                self.calib_steps)
        self.start(src_ids, src_lengths)
        gen = self._generator(sample_seed)
        consts = self._sampling_consts(temperature, 1.0)
        next_tok = torch.full((self.batch,), start_token, dtype=torch.int64,
                              device=self.device)
        tokens, all_logits = [], [] if return_logits else None
        for _ in range(n_new):
            logits = self.step(next_tok)
            next_tok = self._select(logits[:, -1, :], gen, consts,
                                    temperature, top_k, top_p)
            tokens.append(next_tok)
            if return_logits:
                all_logits.append(logits.cpu().numpy())
        return torch.stack(tokens, dim=1).cpu().numpy(), all_logits


def _pad_len(kv: torch.Tensor, max_len: int) -> torch.Tensor:
    """Prefill presents [B, H, P, hd] padded with zeros to [B, H, max_len,
    hd]."""
    return F.pad(kv, (0, 0, 0, max_len - kv.shape[2]))


class SpeculativeGenerator:
    """Greedy speculative decoding: a small DRAFT model proposes k - 1
    tokens autoregressively; the TARGET model verifies the chunk of k
    (the current token and the k - 1 proposals) in ONE chunk-decode call
    (build_decode(chunk=k)) and emits the accepted prefix plus one
    corrected or bonus token. Greedy verification is lossless: the output
    equals the target's own greedy decode, whatever the draft proposes.
    The port's counterpart of the JAX package's SpeculativeGenerator.

    Four Engines: the target prefill, the target chunk-verify, the draft
    prefill and the draft decode, each call a replayed CUDA graph on the
    card. Per-slot positions let every row accept a different prefix
    length; cache rows past a row's position are never attended and are
    overwritten as the position advances. The last draft token's KV row is
    written too (its logits unused): a full-acceptance round moves the
    position past it, and an unwritten row would be attended by every
    later draft step and degrade acceptance.

    temperature > 0: speculative rejection sampling on the host (Leviathan
    et al.) from `np.random.default_rng(sample_seed)`, the JAX package's
    numpy stream: a draft token x ~ q is accepted with probability
    min(1, p(x) / q(x)); on rejection the emitted token is drawn from
    normalize(max(p - q, 0)); after k - 1 acceptances a bonus token is
    drawn from the last p. Runs on the card unless `device="cpu"`.
    """

    def __init__(
        self,
        target_cfg,
        draft_cfg=None,
        *,
        batch: int = 1,
        prompt_len: int = 8,
        max_len: int = 64,
        k: int = 4,
        target_seed: int = 0,
        draft_seed: int = 1,
        family: str = "gpt2",
        mesh=None,
        param_sharding_fn=None,
        device="cuda",
    ):
        from .models import decoder_family

        build_prefill, build_decode, _ = decoder_family(family)
        self.device = resolve_device(device)
        self.k = k
        self.batch = batch
        self.prompt_len = prompt_len
        self.max_len = max_len
        self.tcfg = target_cfg
        dcfg = draft_cfg if draft_cfg is not None else target_cfg
        self.dcfg = dcfg
        assert dcfg.vocab_size == target_cfg.vocab_size

        pkw = ({"past_len": 0, "with_presents": True} if family == "gpt2"
               else {"with_presents": True})

        def engine(build, cfg, seed, **kw):
            return Engine(import_model(build(cfg, batch=batch, seed=seed,
                                             **kw)), device=self.device,
                          mesh=mesh, param_sharding_fn=param_sharding_fn)

        self.t_prefill = engine(build_prefill, target_cfg, target_seed,
                                seq_len=prompt_len, **pkw)
        self.t_verify = engine(build_decode, target_cfg, target_seed,
                               max_len=max_len, chunk=k)
        self.d_prefill = engine(build_prefill, dcfg, draft_seed,
                                seq_len=prompt_len, **pkw)
        self.d_decode = engine(build_decode, dcfg, draft_seed,
                               max_len=max_len)
        self.accepted_total = 0
        self.proposed_total = 0

    def _seed_cache(self, out: dict, cfg) -> Dict[str, torch.Tensor]:
        return {f"past_{kind}_{i}": _pad_len(out[f"present_{kind}_{i}"],
                                             self.max_len)
                for i in range(cfg.n_layer) for kind in ("key", "value")}

    @staticmethod
    def _call(eng: Engine, cache: Dict[str, torch.Tensor], ids: np.ndarray,
              pos: np.ndarray) -> torch.Tensor:
        """One decode or verify call: the cache updated in place (its dict
        entries now the presents), the logits returned."""
        out = eng({"input_ids": ids, "pos": pos, **cache})
        for name in cache:
            cache[name] = out[name.replace("past_", "present_", 1)]
        return out["logits"]

    def generate(self, input_ids: np.ndarray, n_new: int,
                 temperature: float = 0.0, sample_seed: int = 0):
        """Decode n_new tokens per row: (tokens [B, n_new], None).
        temperature == 0: greedy verification, the output identical to the
        target's own greedy decode. temperature > 0: rejection sampling,
        the output distributed as plain sampling from the target at that
        temperature."""
        B, P = input_ids.shape
        assert (B, P) == (self.batch, self.prompt_len)
        assert P + n_new + self.k <= self.max_len, "raise max_len"
        k = self.k
        sampling = temperature > 0.0
        host_rng = np.random.default_rng(sample_seed)

        def soft(logits2d):
            z = np.asarray(logits2d, np.float64) / temperature
            z -= z.max(axis=-1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=-1, keepdims=True)

        ids = np.asarray(input_ids).astype(np.int64)
        t_out = self.t_prefill({"input_ids": ids})
        t_cache = self._seed_cache(t_out, self.tcfg)
        d_cache = self._seed_cache(self.d_prefill({"input_ids": ids}),
                                   self.dcfg)

        first_logits = _fetch(t_out["logits"][:, -1, :])
        if sampling:
            pf = soft(first_logits)
            cur = np.array([host_rng.choice(pf.shape[-1], p=pf[b])
                            for b in range(B)], dtype=np.int64)
        else:
            cur = first_logits.argmax(-1).astype(np.int64)       # [B]
        pos = np.full((B,), P, dtype=np.int64)
        emitted = [[int(c)] for c in cur]

        while min(len(e) for e in emitted) < n_new:
            # 1) the draft proposes k-1 continuations of cur (so the verify
            #    chunk holds exactly k tokens: cur, d1..d_{k-1})
            drafts = [cur]
            d_tok = cur
            q_dists = []       # q_j [B, V]: the dist draft token j+1 came from
            for j in range(k - 1):
                dl = _fetch(self._call(self.d_decode, d_cache,
                                      d_tok[:, None], pos + j)[:, -1, :])
                if sampling:
                    q = soft(dl)
                    q_dists.append(q)
                    d_tok = np.array([host_rng.choice(q.shape[-1], p=q[b])
                                      for b in range(B)], dtype=np.int64)
                else:
                    d_tok = dl.argmax(-1).astype(np.int64)
                drafts.append(d_tok)
            # the LAST draft token's KV row too (logits unused)
            self._call(self.d_decode, d_cache, d_tok[:, None], pos + k - 1)
            chunk = np.stack(drafts, axis=1)                     # [B, k]

            # 2) one target call verifies the whole chunk
            t_logits = _fetch(self._call(self.t_verify, t_cache, chunk, pos))
            tpred = t_logits.argmax(-1).astype(np.int64)         # [B, k]

            # 3) per-row acceptance: greedy prefix match, or rejection
            #    sampling when temperature > 0
            new_cur = np.empty_like(cur)
            for b in range(B):
                if len(emitted[b]) >= n_new:
                    # row already done: advance by 1 real token to keep
                    # positions consistent (its row still decoded)
                    new_cur[b] = tpred[b, 0]
                    pos[b] += 1
                    continue
                if sampling:
                    p_dists = soft(t_logits[b])                  # [k, V]
                    out_toks = []
                    m = 0
                    for j in range(k - 1):
                        x = int(chunk[b, j + 1])
                        qx = q_dists[j][b, x]
                        px = p_dists[j, x]
                        if host_rng.random() < min(1.0, px / max(qx, 1e-30)):
                            out_toks.append(x)
                            m += 1
                            continue
                        res = np.maximum(p_dists[j] - q_dists[j][b], 0.0)
                        tot = res.sum()
                        if tot <= 0:  # q covers p exactly; resample p
                            res, tot = p_dists[j], 1.0
                        out_toks.append(int(host_rng.choice(
                            res.shape[-1], p=res / tot)))
                        break
                    else:
                        # every draft accepted: bonus token from p_{k-1}
                        out_toks.append(int(host_rng.choice(
                            p_dists[k - 1].shape[-1], p=p_dists[k - 1])))
                    emitted[b].extend(out_toks)
                    new_cur[b] = out_toks[-1]
                    pos[b] += len(out_toks)
                    self.accepted_total += m
                    self.proposed_total += k - 1
                    continue
                m = 0
                while m < k - 1 and chunk[b, m + 1] == tpred[b, m]:
                    m += 1
                emitted[b].extend(int(t) for t in tpred[b, :m + 1])
                new_cur[b] = tpred[b, m]
                pos[b] += m + 1
                self.accepted_total += m
                self.proposed_total += k - 1
            cur = new_cur
            # draft cache rows past each row's pos are stale and masked;
            # feeding `cur` at `pos` re-syncs the draft to the accepted
            # stream

        toks = np.stack([np.asarray(e[:n_new]) for e in emitted])
        return toks, None

    @property
    def acceptance_rate(self) -> float:
        return (self.accepted_total / self.proposed_total
                if self.proposed_total else 0.0)


# -- beam search -------------------------------------------------------------
def _beam_loop(step_logp, reorder, tokens, scores, finished, *,
               B: int, K: int, V: int, n_new: int,
               eos_id: Optional[int], length_penalty: float,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Shared beam bookkeeping for steps 1..n_new-1 (step 0 seeded the
    K beams). step_logp(last [B*K], t) -> log-probs [B*K, V] (and must
    stage its presents); reorder(rows [B*K]) commits the device cache
    for the chosen beams. Returns (best tokens [B, n_new], scores [B])."""
    last = tokens[:, :, -1].reshape(B * K)
    for t in range(1, n_new):
        if finished.all():
            break
        lp = step_logp(last, t).reshape(B, K, V)
        if eos_id is not None:
            # frozen beams: single eos continuation at 0 extra cost
            frozen = np.full((V,), -np.inf)
            frozen[eos_id] = 0.0
            lp = np.where(finished[:, :, None], frozen, lp)
        total = scores[:, :, None] + lp                 # [B, K, V]
        flat = total.reshape(B, K * V)
        sel = np.argsort(flat, axis=-1)[:, ::-1][:, :K]  # [B, K]
        scores = np.take_along_axis(flat, sel, axis=-1)
        src_beam = sel // V                             # [B, K]
        tok = sel % V

        tokens = np.concatenate(
            [np.take_along_axis(tokens, src_beam[:, :, None], axis=1),
             tok[:, :, None]], axis=2)
        finished = np.take_along_axis(finished, src_beam, axis=1)
        if eos_id is not None:
            finished = finished | (tok == eos_id)

        # reorder the device cache by global beam row (batch-dim take)
        reorder((np.arange(B)[:, None] * K + src_beam).reshape(-1))
        last = tok.reshape(B * K)

    return _beam_finalize(tokens, scores, n_new=n_new, eos_id=eos_id,
                          length_penalty=length_penalty)


def _beam_finalize(tokens: np.ndarray, scores: np.ndarray, *, n_new: int,
                   eos_id: Optional[int], length_penalty: float,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Final best-beam selection shared by the host loop and the device
    loop: GNMT length penalty, argmax over beams, eos-padding to n_new."""
    B = tokens.shape[0]
    if length_penalty:
        lens = tokens.shape[2] - (0 if eos_id is None
                                  else (tokens == eos_id).sum(2))
        final = scores / np.maximum(lens, 1) ** length_penalty
    else:
        final = scores
    best = final.argmax(axis=1)                         # [B]
    out_toks = tokens[np.arange(B), best]               # [B, <=n_new]
    if out_toks.shape[1] < n_new:
        pad_tok = eos_id if eos_id is not None else 0
        out_toks = np.concatenate(
            [out_toks, np.full((B, n_new - out_toks.shape[1]),
                               pad_tok, out_toks.dtype)], axis=1)
    return out_toks, scores[np.arange(B), best]


def _beam_backtrack(top0: np.ndarray, parents: np.ndarray,
                    toks: np.ndarray) -> np.ndarray:
    """Reconstruct [B, K, T+1] beam histories from per-step parent
    pointers: the host-side half of the device beam loop (which records
    (src_beam, token) per step instead of reordering a token buffer on
    the device)."""
    T, B, K = parents.shape
    seq = np.zeros((B, K, T + 1), np.int64)
    bi = np.arange(B)[:, None]
    cur = np.tile(np.arange(K), (B, 1))
    for t in range(T - 1, -1, -1):
        seq[:, :, t + 1] = toks[t][bi, cur]
        cur = parents[t][bi, cur]
    seq[:, :, 0] = np.take_along_axis(top0, cur, axis=1)
    return seq


class _BeamSteps:
    """The decode Engine of a beam search at batch B * K and the buffers
    its graphs read and write by address: the step's token and position,
    the KV cache, the constant inputs (a seq2seq family's cross K/V and
    `src_len`), the staged presents and the log-probs.

    - `step(last, pos)`: one decode step (captured on the card after an
      eager first run, then replayed): the presents go to the staging
      buffers, log_softmax(logits) in f32 to `logp`, read by the host.
    - `reorder(rows)`: the cache becomes the staged presents' rows `rows`
      (index_select on dim 0, written into the cache buffers in place);
      `commit()` takes the staged presents as they are.
    - `run_device(...)`: every beam step 1..n_new-1 as one graph per
      (n_new, eos_id): the decode forward, log_softmax in f32, the frozen
      beams' mask (a finished beam's only continuation is eos at 0),
      torch.topk over [B, K*V], each beam's parent and token written at
      its static step into [T, B, K] buffers, and the cache gathered by
      global beam row. The host then backtracks and finalizes.
    """

    def __init__(self, decode: Engine, B: int, K: int, V: int):
        self.eng, self.B, self.K, self.V = decode, B, K, V
        dev = decode.device
        BK = B * K
        specs = {s.name: s for s in decode.graph.inputs}

        def zeros(name, dtype=None):
            spec = specs[name]
            return torch.zeros(spec.concrete_shape(batch=BK),
                               dtype=dtype or _torch_dtype(spec.dtype),
                               device=dev)

        self.past = [n for n in specs if n.startswith("past_")]
        self.cache = {n: zeros(n, torch.float32) for n in self.past}
        self.stage = {n: torch.empty_like(v) for n, v in self.cache.items()}
        self.const = {n: zeros(n) for n in specs
                      if n.startswith("cross_") or n == "src_len"}
        i64 = dict(dtype=torch.int64, device=dev)
        self.tok = torch.zeros((BK,), **i64)
        self.pos = torch.zeros((BK,), **i64)
        self.rows = torch.zeros((BK,), **i64)
        self.base = (torch.arange(B, **i64) * K)[:, None]   # [B, 1]
        self.logp = torch.zeros((BK, V), dtype=torch.float32, device=dev)
        self._graphs: Dict[object, object] = {}
        self._dev: Dict[tuple, dict] = {}

    def _forward(self, tok, pos, cache) -> Dict[str, torch.Tensor]:
        feed = {"input_ids": tok.reshape(-1, 1), "pos": pos}
        feed.update(cache)
        feed.update(self.const)
        return self.eng.forward(feed)

    @staticmethod
    def _logp(out) -> torch.Tensor:
        return torch.log_softmax(out["logits"][:, -1, :].to(torch.float32),
                                 dim=-1)

    def _step_body(self) -> None:
        out = self._forward(self.tok, self.pos, self.cache)
        self.logp.copy_(self._logp(out))
        for n in self.past:
            self.stage[n].copy_(out[n.replace("past_", "present_", 1)])

    def step(self, last: np.ndarray, pos: int) -> np.ndarray:
        """Decode `last` [B*K] at position `pos`: log-probs [B*K, V]."""
        self.tok.copy_(torch.from_numpy(np.ascontiguousarray(last, np.int64)))
        self.pos.fill_(pos)
        run_captured(self._graphs, "step", self._step_body, self.eng)
        return _fetch(self.logp)

    def commit(self) -> None:
        for n in self.past:
            self.cache[n].copy_(self.stage[n])

    def reorder(self, rows: np.ndarray) -> None:
        self.rows.copy_(torch.from_numpy(np.ascontiguousarray(rows,
                                                         np.int64)))
        for n in self.past:
            torch.index_select(self.stage[n], 0, self.rows, out=self.cache[n])

    def _device_body(self, st: dict, T: int, eos_id: Optional[int]) -> None:
        B, K, V = self.B, self.K, self.V
        last, scores, fin, pos = st["last"], st["scores"], st["fin"], \
            st["pos"]
        cache = self.cache
        for t in range(T):
            out = self._forward(last, pos, cache)
            lp = self._logp(out).reshape(B, K, V)
            if eos_id is not None:
                lp = torch.where(fin[:, :, None], st["frozen"], lp)
            flat = (scores[:, :, None] + lp).reshape(B, K * V)
            scores, idx = torch.topk(flat, K, dim=-1)
            src = idx // V                                  # [B, K]
            tok = idx % V
            fin = fin.gather(1, src)
            if eos_id is not None:
                fin = fin | (tok == eos_id)
            rows = (self.base + src).reshape(-1)
            cache = {n: out[n.replace("past_", "present_", 1)].index_select(
                0, rows) for n in self.past}
            st["parents"][t].copy_(src)
            st["toks"][t].copy_(tok)
            last, pos = tok.reshape(-1), pos + 1
        st["scores"].copy_(scores)
        st["fin"].copy_(fin)
        for n in self.past:
            self.cache[n].copy_(cache[n])

    def run_device(self, top: np.ndarray, scores: np.ndarray,
                   finished: np.ndarray, pos: int, n_new: int,
                   eos_id: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Beam steps 1..n_new-1 from the seeded beams (`top` [B, K], their
        scores and finished flags) over the cache as it stands, the first
        at position `pos`: (the histories [B, K, n_new], the scores)."""
        B, K, V = self.B, self.K, self.V
        T = n_new - 1
        dev = self.eng.device
        key = (n_new, eos_id)
        st = self._dev.get(key)
        if st is None:
            frozen = torch.full((V,), -float("inf"), device=dev)
            if eos_id is not None:
                frozen[eos_id] = 0.0
            st = self._dev[key] = {
                "last": torch.zeros((B * K,), dtype=torch.int64, device=dev),
                "pos": torch.zeros((B * K,), dtype=torch.int64, device=dev),
                "scores": torch.zeros((B, K), dtype=torch.float32,
                                      device=dev),
                "fin": torch.zeros((B, K), dtype=torch.bool, device=dev),
                "parents": torch.zeros((T, B, K), dtype=torch.int64,
                                       device=dev),
                "toks": torch.zeros((T, B, K), dtype=torch.int64,
                                    device=dev),
                "frozen": frozen}
        st["last"].copy_(torch.from_numpy(np.ascontiguousarray(
            top.reshape(-1), np.int64)))
        st["pos"].fill_(pos)
        st["scores"].copy_(torch.from_numpy(np.ascontiguousarray(
            scores, np.float32)))
        st["fin"].copy_(torch.from_numpy(np.ascontiguousarray(finished)))
        if T > 0:
            run_captured(self._graphs, ("beam",) + key,
                         lambda: self._device_body(st, T, eos_id), self.eng)
        seq = _beam_backtrack(top, _fetch(st["parents"]), _fetch(st["toks"]))
        return seq, _fetch(st["scores"])


class BeamGenerator:
    """Beam search over a decoder family (gpt2, llama, moe or a registered
    family). The port's counterpart of the JAX package's BeamGenerator.

    Beams are batch rows: the prefill graph runs at batch B, its presents
    are padded to max_len and tiled K x (row b*K + k) into a batch-B*K
    fixed-size cache, and every step is ONE decode graph over all B*K beams
    (per-slot `pos [B*K]`). Reordering the beams is an index_select on the
    cache's batch dim, written into the buffers the captured step reads
    (`_BeamSteps`). The host keeps the scores [B, K] and the token
    history. With int4_weights both graphs run the int4 kernel, the prefill
    at M = B*P and each step at M = B*K.

    eos_id: finished beams are frozen (their only continuation is eos at
    zero log-prob), so they compete on their final score while live beams
    keep expanding. Scores are summed token log-probs; length_penalty
    divides them by len**alpha at the final selection (GNMT; 0 = off).

    device_loop=True runs every step after the first as one CUDA graph per
    (n_new, eos_id): eager on its first call, captured after, replayed
    later; on the CPU the same body runs as a Python loop. The beams
    equal the host loop's (its scores within float rounding). Runs on the
    card unless `device="cpu"`.
    """

    def __init__(self, cfg, *, batch: int = 1, beam: int = 4,
                 prompt_len: int = 8, max_len: int = 32, seed: int = 0,
                 family: str = "gpt2", int4_weights: bool = False,
                 device_loop: bool = False, device="cuda"):
        from .models import decoder_family

        assert beam >= 1
        self.device = resolve_device(device)
        self.device_loop = bool(device_loop)
        self.cfg, self.B, self.K = cfg, batch, beam
        self.prompt_len, self.max_len = prompt_len, max_len
        build_prefill, build_decode, _ = decoder_family(family)
        pkw = ({"past_len": 0, "with_presents": True} if family == "gpt2"
               else {"with_presents": True})
        pg = import_model(build_prefill(cfg, batch=batch,
                                        seq_len=prompt_len, seed=seed,
                                        **pkw))
        dg = import_model(build_decode(cfg, batch=batch * beam,
                                       max_len=max_len, seed=seed))
        if int4_weights:
            from .quant import quantize_weights_int4

            pg = quantize_weights_int4(pg)
            dg = quantize_weights_int4(dg)
        self.prefill = Engine(pg, device=self.device)
        self.decode = Engine(dg, device=self.device)
        self.steps = _BeamSteps(self.decode, batch, beam, cfg.vocab_size)

    def generate(self, input_ids: np.ndarray, n_new: int,
                 eos_id: Optional[int] = None,
                 length_penalty: float = 0.0,
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (tokens [B, n_new], scores [B]) of each row's best beam."""
        B, K, P = self.B, self.K, self.prompt_len
        assert input_ids.shape == (B, P)
        assert P + n_new <= self.max_len
        V = self.cfg.vocab_size
        st = self.steps

        out = self.prefill({"input_ids": np.asarray(input_ids).astype(
            np.int64)})
        logp = _fetch(_BeamSteps._logp(out))                 # [B, V]
        top = np.argsort(logp, axis=-1)[:, ::-1][:, :K]     # [B, K]
        scores = np.take_along_axis(logp, top, axis=-1)     # [B, K]
        tokens = top[:, :, None]                            # [B, K, 1]
        finished = np.zeros((B, K), bool)
        if eos_id is not None:
            finished |= top == eos_id

        # tile the presents K x along the batch: beam rows are b*K + k
        for name in st.past:
            kv = out[name.replace("past_", "present_", 1)]  # [B, H, P, hd]
            st.cache[name].copy_(torch.repeat_interleave(
                _pad_len(kv, self.max_len), K, dim=0))

        if self.device_loop:
            seq, fscores = st.run_device(top, scores, finished, P, n_new,
                                         eos_id)
            return _beam_finalize(seq, fscores, n_new=n_new, eos_id=eos_id,
                                  length_penalty=length_penalty)
        return _beam_loop(lambda last, t: st.step(last, P + t - 1),
                          st.reorder, tokens, scores, finished,
                          B=B, K=K, V=V, n_new=n_new, eos_id=eos_id,
                          length_penalty=length_penalty)


class Seq2SeqBeamGenerator:
    """Beam search for the encoder-decoder families (models.seq2seq_family:
    "t5" tokens -> tokens, "asr" waveform -> tokens). The port's
    counterpart of the JAX package's Seq2SeqBeamGenerator.

    The encoder runs once at batch B; its cross K/V (and, for t5, the
    source lengths) are tiled K x once into the buffers the decode graph
    reads at batch B*K. Step 0 feeds start_token on every row, so all
    beams are equal and its presents commit as they are; `_beam_loop` (or,
    with device_loop=True, one CUDA graph for every later step) then
    expands and reorders exactly as BeamGenerator does. fp32 KV, as in
    JAX. Runs on the card unless `device="cpu"`.
    """

    def __init__(self, cfg, *, batch: int = 1, beam: int = 4,
                 src_len: int = 16, max_len: int = 32, seed: int = 0,
                 family: str = "t5", device_loop: bool = False,
                 device="cuda"):
        from .models import seq2seq_family

        assert beam >= 1
        self.device = resolve_device(device)
        self.device_loop = bool(device_loop)
        self.fam = seq2seq_family(family)
        self.cfg, self.B, self.K = cfg, batch, beam
        self.src_len = src_len
        self.enc_len = self.fam.enc_len(cfg, src_len)
        self.max_len = max_len
        self.encoder = Engine(import_model(self.fam.build_encoder(
            cfg, batch=batch, src_len=src_len, seed=seed)),
            device=self.device)
        self.decode = Engine(import_model(self.fam.build_decode(
            cfg, batch=batch * beam, max_len=max_len, src_len=self.enc_len,
            seed=seed)), device=self.device)
        self.steps = _BeamSteps(self.decode, batch, beam, cfg.vocab_size)

    def generate(self, src_ids: np.ndarray, n_new: int,
                 start_token: int = 0,
                 eos_id: Optional[int] = None,
                 length_penalty: float = 0.0,
                 src_lengths: Optional[np.ndarray] = None,
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (tokens [B, n_new], scores [B]) of each row's best beam."""
        B, K = self.B, self.K
        assert src_ids.shape == (B, self.src_len)
        assert n_new <= self.max_len
        V = self.cfg.vocab_size
        st = self.steps

        if src_lengths is None:
            src_lengths = np.full((B,), self.src_len, np.int64)
        lens = np.asarray(src_lengths).astype(np.int64)
        enc_feed = {self.fam.enc_input: np.asarray(src_ids).astype(
            self.fam.prompt_dtype)}
        if self.fam.src_mask:
            enc_feed["src_len"] = lens
            st.const["src_len"].copy_(torch.from_numpy(np.repeat(lens, K)))
        enc = self.encoder(enc_feed)
        for name, buf in st.const.items():
            if name.startswith("cross_"):
                buf.copy_(torch.repeat_interleave(enc[name], K, dim=0))
        for buf in st.cache.values():
            buf.zero_()

        # step 0: every beam row feeds start_token; the rows are equal, so
        # the presents commit as they are (no tiling)
        lp0 = st.step(np.full((B * K,), start_token, np.int64), 0)
        st.commit()
        lp0 = lp0.reshape(B, K, V)[:, 0]                # [B, V]
        top = np.argsort(lp0, axis=-1)[:, ::-1][:, :K]  # [B, K]
        scores = np.take_along_axis(lp0, top, axis=-1)
        tokens = top[:, :, None]
        finished = np.zeros((B, K), bool)
        if eos_id is not None:
            finished |= top == eos_id

        if self.device_loop:
            seq, fscores = st.run_device(top, scores, finished, 1, n_new,
                                         eos_id)
            return _beam_finalize(seq, fscores, n_new=n_new, eos_id=eos_id,
                                  length_penalty=length_penalty)
        return _beam_loop(st.step, st.reorder, tokens, scores, finished,
                          B=B, K=K, V=V, n_new=n_new, eos_id=eos_id,
                          length_penalty=length_penalty)

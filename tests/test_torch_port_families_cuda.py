"""Multi-LoRA, the MoE server and Seq2SeqGenerator on the card (marker
`cuda`; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package. Run it on a card,
without the suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_families_cuda.py -q

- `lora_idx` is read at replay: one captured graph serves every adapter
  assignment, each replay equal to the eager forward of its feed, and
  within 1e-5 x max|ref| of the CPU.
- A LoRA Generator's device loop (K steps as one replayed graph) gives
  the host loop's tokens; a LoRA MoE server's K-step blocks give its
  single-step tokens, per adapter.
- Seq2SeqGenerator's captured step: teacher-forced logits within 1e-4 x
  max|ref| of the CPU, and the int8 switch byte for byte numpy's
  quantization of the card's own fp32 cache.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch import Engine, import_model
from onnx_rusty_inference_engine_tpu_torch.generate import (
    Generator, Seq2SeqGenerator)
from onnx_rusty_inference_engine_tpu_torch.lora import (
    attach_lora, make_adapter_stack)
from onnx_rusty_inference_engine_tpu_torch.models import asr, gpt2, moe, t5
from onnx_rusty_inference_engine_tpu_torch.serving import DecodeServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bank(cfg, build, n=3, seed=0):
    g = import_model(build(cfg, batch=1, seq_len=8))
    return make_adapter_stack(g, n_adapters=n, rank=4,
                              targets=("attn", "mlp"), seed=seed,
                              scale=0.1)


def test_lora_idx_is_read_at_replay(cuda):
    g = import_model(gpt2.build_gpt2(gpt2.TINY, batch=3, seq_len=8,
                                     with_presents=False))
    bank = _bank(gpt2.TINY, gpt2.build_gpt2)
    lg = attach_lora(g, bank, alpha=8.0)
    card, cpu = Engine(lg, device=cuda), Engine(lg, device="cpu")
    ids = np.random.default_rng(1).integers(0, gpt2.TINY.vocab_size,
                                            (3, 8))
    seen = []
    for idx in ([0, 1, 2], [2, 2, 0], [1, 0, 1]):
        feed = {"input_ids": ids, "lora_idx": np.asarray(idx, np.int64)}
        got = card(feed)["logits"]
        with torch.no_grad():
            eager = card.forward({k: torch.as_tensor(v, device=cuda)
                                  for k, v in feed.items()})["logits"]
        assert torch.equal(got, eager)
        want = cpu.run(feed).outputs["logits"]
        err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (idx, err)
        seen.append(got.cpu().numpy())
    assert len(card._graphs) == 1          # one capture served all three
    assert not np.array_equal(seen[0][0], seen[1][0])   # adapters differ


def test_lora_generator_device_loop_equals_host_loop(cuda):
    bank = _bank(gpt2.TINY, gpt2.build_gpt2)
    kw = dict(batch=2, prompt_len=4, max_len=24, lora_bank=bank,
              lora_alpha=8.0, adapter=[1, 2], kv_dtype="int8",
              int4_weights=True, device=cuda)
    ids = np.random.default_rng(2).integers(0, gpt2.TINY.vocab_size, (2, 4))
    host, _ = Generator(gpt2.TINY, **kw).generate(ids, 12)
    loop = Generator(gpt2.TINY, device_loop=4, **kw)
    for _ in range(2):                      # eager + capture, then replays
        got, _ = loop.generate(ids, 12)
        np.testing.assert_array_equal(got, host)


def test_lora_moe_server_blocks_equal_single_steps(cuda):
    bank = _bank(moe.TINY, moe.build_moe)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, moe.TINY.vocab_size, (int(n),)), k % 3)
            for k, n in enumerate(rng.integers(2, 7, 5))]
    outs = []
    for K in (0, 3):
        srv = DecodeServer(moe.TINY, family="moe", slots=2, prompt_len=6,
                           max_len=24, lora_bank=bank, lora_alpha=8.0,
                           multi_step=K, device=cuda)
        try:
            outs.append([f.result(timeout=300) for f in [
                srv.submit(p, 6, adapter=a) for p, a in reqs]])
        finally:
            srv.stop()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("family", ["t5", "asr"])
def test_seq2seq_captured_step_against_the_cpu(cuda, family):
    cfg = t5.TINY if family == "t5" else asr.TINY
    r = np.random.default_rng(4)
    src = (r.integers(0, cfg.vocab_size, (2, 12)) if family == "t5"
           else (r.standard_normal((2, 512)) * 0.1).astype(np.float32))
    kw = dict(family=family, batch=2, src_len=src.shape[1], max_len=16,
              kv_dtype="int8", calib_steps=3)
    card = Seq2SeqGenerator(cfg, device=cuda, **kw)
    cpu = Seq2SeqGenerator(cfg, device="cpu", **kw)
    seen = {}
    real = card.quantize_cache

    def spy(amax, cache):
        scales, q = real(amax, cache)
        seen.update(fp32={k: v.cpu().numpy() for k, v in cache.items()},
                    scales={k: v.cpu().numpy() for k, v in scales.items()},
                    q={k: v.cpu().numpy() for k, v in q.items()})
        return scales, q

    card.quantize_cache = spy
    for gen in (card, cpu):
        gen.start(src)
    tok = np.zeros((2,), np.int64)
    for _ in range(8):                      # 3 shadow fp32 steps, then int8
        got = card.step(torch.as_tensor(tok, device=cuda))[:, 0]
        want = cpu.step(torch.as_tensor(tok))[:, 0]
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, err
        tok = want.argmax(-1).numpy()
    assert len(card._steps) == 2            # the fp32 and the int8 graph
    for name, kv in seen["fp32"].items():
        _, kind, i = name.split("_")
        s = (np.maximum(np.abs(kv).max(axis=(0, 2, 3)), 1e-6)
             / 127.0).astype(np.float32)
        assert seen["scales"][f"kv_scale_{kind}_{i}"].tobytes() == \
            s.tobytes()
        q = np.clip(np.round(kv / s.reshape(1, -1, 1, 1)), -127,
                    127).astype(np.int8)
        assert seen["q"][name].tobytes() == q.tobytes()

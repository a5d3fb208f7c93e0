"""The port's bring-your-own ONNX decoder (custom_decoder.py): the twins of
tests/test_custom_decoder.py on the CPU. Prefill/decode ONNX files written
by the port plug into its Generator and DecodeServer through
register_decoder_family, with tensor renaming for exports that use foreign
I/O names, and give the built-in family's tokens (and the JAX package's
for the same files)."""

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import custom_decoder as j_custom
from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.models import (
    register_decoder_family as j_register)
from onnx_rusty_inference_engine_tpu.models.gpt2 import TINY as J_TINY
from onnx_rusty_inference_engine_tpu_torch import onnx_io
from onnx_rusty_inference_engine_tpu_torch.custom_decoder import (
    onnx_decoder_family, rename_tensors)
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.graph import (
    export_model, import_model)
from onnx_rusty_inference_engine_tpu_torch.models import (
    build_gpt2, build_gpt2_decode, build_llama, build_llama_decode,
    decoder_family, register_decoder_family)
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import TINY
from onnx_rusty_inference_engine_tpu_torch.models.llama import (
    TINY as L_TINY)
from onnx_rusty_inference_engine_tpu_torch.serve_llm import DecodeServer

rng = np.random.default_rng(17)


def _save(tmp_path, pg, dg, tag=""):
    pp = str(tmp_path / f"prefill{tag}.onnx")
    dp = str(tmp_path / f"decode{tag}.onnx")
    onnx_io.save_model(pp, export_model(pg))
    onnx_io.save_model(dp, export_model(dg))
    return pp, dp


def _write(tmp_path, batch, prompt_len, max_len, rename=None):
    """The gpt2 builders' graphs written as ONNX files (what any exporter
    produces, in the same wire format)."""
    pg = import_model(build_gpt2(TINY, batch=batch, seq_len=prompt_len,
                                 past_len=0, with_presents=True))
    dg = import_model(build_gpt2_decode(TINY, batch=batch, max_len=max_len))
    if rename:
        pg, dg = rename_tensors(pg, rename), rename_tensors(dg, rename)
    return _save(tmp_path, pg, dg)


def _gen(cfg, **kw):
    return Generator(cfg, device="cpu", **kw)


def test_custom_family_matches_native_and_jax(tmp_path):
    pp, dp = _write(tmp_path, batch=2, prompt_len=4, max_len=12)
    register_decoder_family("port-ext-gpt2", *onnx_decoder_family(pp, dp))
    ids = rng.integers(0, TINY.vocab_size, (2, 4)).astype(np.int64)
    want, _ = _gen(TINY, batch=2, prompt_len=4, max_len=12).generate(ids, 6)
    got, _ = _gen(TINY, batch=2, prompt_len=4, max_len=12,
                  family="port-ext-gpt2").generate(ids, 6)
    np.testing.assert_array_equal(got, want)
    # the JAX package serves the port's files the same way
    j_register("port-files", *j_custom.onnx_decoder_family(pp, dp))
    jt, _ = JGenerator(J_TINY, batch=2, prompt_len=4, max_len=12,
                       family="port-files").generate(ids, 6)
    np.testing.assert_array_equal(got, np.asarray(jt))


def test_custom_llama_family_matches_native(tmp_path):
    """A GQA family from files: the decode check takes n_kv_head heads."""
    pg = import_model(build_llama(L_TINY, batch=2, seq_len=4))
    dg = import_model(build_llama_decode(L_TINY, batch=2, max_len=12))
    pp, dp = _save(tmp_path, pg, dg, "_llama")
    register_decoder_family("port-ext-llama", *onnx_decoder_family(pp, dp))
    ids = rng.integers(0, L_TINY.vocab_size, (2, 4)).astype(np.int64)
    want, _ = _gen(L_TINY, batch=2, prompt_len=4, max_len=12,
                   family="llama").generate(ids, 6)
    got, _ = _gen(L_TINY, batch=2, prompt_len=4, max_len=12,
                  family="port-ext-llama").generate(ids, 6)
    np.testing.assert_array_equal(got, want)


def test_foreign_names_remap(tmp_path):
    """Files exported with HF-style cache names serve after rename=."""
    fwd = {}
    for i in range(TINY.n_layer):
        for kind in ("key", "value"):
            fwd[f"past_{kind}_{i}"] = f"past_key_values.{i}.{kind}"
            fwd[f"present_{kind}_{i}"] = f"present.{i}.{kind}"
    fwd["pos"] = "position_ids"
    pp, dp = _write(tmp_path, batch=1, prompt_len=4, max_len=12,
                    rename=fwd)
    assert "past_key_values.0.key" in [
        s.name for s in import_model(onnx_io.load_model(dp)).inputs]
    back = {v: k for k, v in fwd.items()}
    register_decoder_family(
        "port-hf-ish", *onnx_decoder_family(pp, dp, rename=back))
    ids = rng.integers(0, TINY.vocab_size, (1, 4)).astype(np.int64)
    want, _ = _gen(TINY, batch=1, prompt_len=4, max_len=12).generate(ids, 5)
    got, _ = _gen(TINY, batch=1, prompt_len=4, max_len=12,
                  family="port-hf-ish").generate(ids, 5)
    np.testing.assert_array_equal(got, want)


def test_custom_family_serves(tmp_path):
    """DecodeServer drives a file-backed family: batch-1 prefill file +
    batch-slots decode file, served == isolated."""
    slots, plen, mlen = 2, 4, 16
    pg = import_model(build_gpt2(TINY, batch=1, seq_len=plen, past_len=0,
                                 with_presents=True))
    dg = import_model(build_gpt2_decode(TINY, batch=slots, max_len=mlen))
    pp, dp = _save(tmp_path, pg, dg, "_served")
    register_decoder_family("port-ext-served", *onnx_decoder_family(pp, dp))
    srv = DecodeServer(TINY, slots=slots, prompt_len=plen, max_len=mlen,
                       family="port-ext-served", device="cpu")
    try:
        p = rng.integers(0, TINY.vocab_size, (4,)).astype(np.int64)
        got = srv.submit(p, 5).result(timeout=300)
    finally:
        srv.stop()
    want, _ = _gen(TINY, batch=1, prompt_len=4, max_len=mlen).generate(
        p[None], 5)
    assert got == list(want[0])


def test_shape_mismatch_raises(tmp_path):
    pp, dp = _write(tmp_path, batch=2, prompt_len=4, max_len=12)
    register_decoder_family("port-ext-shape", *onnx_decoder_family(pp, dp))
    with pytest.raises(ValueError, match="re-export"):
        _gen(TINY, batch=4, prompt_len=4, max_len=12,
             family="port-ext-shape")


def test_missing_contract_input_raises(tmp_path):
    pp, dp = _write(tmp_path, batch=1, prompt_len=4, max_len=12,
                    rename={"pos": "position_ids"})
    register_decoder_family("port-ext-noctr", *onnx_decoder_family(pp, dp))
    with pytest.raises(ValueError, match="no input 'pos'"):
        _gen(TINY, batch=1, prompt_len=4, max_len=12,
             family="port-ext-noctr")


@pytest.mark.parametrize("name", ["gpt2", "llama", "moe"])
def test_builtin_families_not_overridable(name):
    with pytest.raises(ValueError, match="built-in"):
        register_decoder_family(name, None, None)


def test_unknown_family_lists_custom():
    register_decoder_family("port-listed", None, None)
    with pytest.raises(KeyError, match="port-listed") as e:
        decoder_family("definitely-not-registered")
    assert "gpt2, llama" in str(e.value)

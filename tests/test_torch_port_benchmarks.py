"""The port's benchmarks (onnx_rusty_inference_engine_tpu_torch.benchmarks)
run end to end on the CPU at tiny widths with `--cpu --iters 2`, and print
the JAX package's metric names (benchmarks/gpt2_decode.py, llama_decode.py,
prefill.py, serve_latency.py), the scan_* rows included, each with a
positive finite number. Without `--cpu` they need a card and raise here.
"""

import json
import math

import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch.benchmarks import (
    gpt2_decode, llama_decode, prefill, serve_latency)

GPT2_TINY = ["--layers", "2", "--d", "64", "--heads", "4", "--vocab", "256",
             "--batch", "2", "--max-len", "16"]
LLAMA_TINY = ["--layers", "2", "--dim", "64", "--heads", "4", "--kv-heads",
              "2", "--vocab", "256", "--batch", "2", "--max-len", "16"]


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _positive(v):
    return isinstance(v, float) and math.isfinite(v) and v > 0


def test_gpt2_decode_metric_names(capsys):
    gpt2_decode.main(["--cpu", "--iters", "2"] + GPT2_TINY)
    lines = _lines(capsys)
    rows = ["fp32", "int4_weights", "int4_weights_int8_kv",
            "int4_weights_int8_kv_fusedattn", "int4_weights_int4_kv",
            "scan_fp32", "scan_int4_weights_int8_kv"]
    ratios = ["int4_speedup", "int4_int8kv_speedup", "int4_int4kv_speedup",
              "fusedattn_speedup", "scan_speedup_vs_fp32",
              "scan_int4_int8kv_speedup"]
    assert [ln["metric"] for ln in lines] == \
        [f"gpt2_decode_{r}" for r in rows + ratios]
    for ln in lines[:len(rows)]:
        assert (ln["layers"], ln["d_model"], ln["batch"],
                ln["cache_len"]) == (2, 64, 2, 16)
        assert _positive(ln["step_ms"]) and _positive(ln["tokens_per_sec"])
        assert ln["clock"] == "host (cpu)"
    assert all(_positive(ln["value"]) for ln in lines[len(rows):])


def test_llama_decode_metric_names(capsys):
    llama_decode.main(["--cpu", "--iters", "2"] + LLAMA_TINY)
    lines = _lines(capsys)
    rows = ["fp32", "int4_weights_int8_kv", "int4_weights_int4_kv",
            "int4_weights_int8_kv_fusedattn", "scan_int4_weights_int8_kv"]
    ratios = ["int4_int8kv_speedup", "fusedattn_speedup",
              "scan_int4_int8kv_speedup"]
    assert [ln["metric"] for ln in lines] == \
        [f"llama_decode_{r}" for r in rows + ratios]
    for ln in lines[:len(rows)]:
        assert (ln["layers"], ln["dim"], ln["heads"], ln["kv_heads"],
                ln["batch"], ln["cache_len"]) == (2, 64, 4, 2, 2, 16)
        assert _positive(ln["step_ms"]) and _positive(ln["tokens_per_sec"])


def test_prefill_metric_names(capsys):
    prefill.main(["--cpu", "--iters", "2", "--layers", "2", "--d", "64",
                  "--heads", "4", "--vocab", "256", "--batch", "2",
                  "--prompt", "16"])
    lines = _lines(capsys)
    rows = ["fp32", "bf16", "int4_weights", "w8a8", "w8a8_bf16"]
    assert [ln["metric"] for ln in lines] == \
        [f"gpt2_prefill_{r}" for r in rows] + \
        ["gpt2_prefill_bf16_speedup", "gpt2_prefill_w8a8_vs_bf16"]
    assert all(_positive(ln["tokens_per_sec"]) for ln in lines[:5])
    assert all(ln["prompt_len"] == 16 for ln in lines[:5])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_serve_latency_lines(capsys, family):
    serve_latency.main(["--cpu", "--repeats", "1", "--layers", "2", "--d",
                        "128", "--batch", "2", "--new", "6", "--max-len",
                        "32", "--loops", "0,4", "--family", family])
    lines = _lines(capsys)
    assert [(ln["bench"], ln["device_loop"]) for ln in lines] == [
        ("served_decode", 0), ("served_decode", 4), ("served_speedup", 4)]
    for ln in lines[:2]:
        assert ln["family"] == family and ln["new_tokens"] == 6
        assert _positive(ln["wall_s"]) and _positive(ln["tokens_per_s"])
    assert _positive(lines[2]["vs_host_loop"])


def test_serve_latency_unported_options_raise(capsys):
    """--family moe and --adapters raised until the MoE family and the
    LoRA bank were ported: each now runs and prints its lines."""
    for extra in (["--family", "moe"], ["--adapters", "2"]):
        serve_latency.main(["--cpu", "--repeats", "1", "--layers", "1",
                            "--d", "64", "--new", "2", "--loops", "0",
                            "--max-len", "16"] + extra)
        (line,) = _lines(capsys)
        assert line["bench"] == "served_decode"
        assert line["family"] == extra[1] if extra[0] == "--family" \
            else line["adapters"] == 2
        assert _positive(line["tokens_per_s"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_benchmarks_need_a_card_without_cpu_flag():
    with pytest.raises(RuntimeError):
        gpt2_decode.main(["--iters", "2"] + GPT2_TINY)

"""Benchmarks of the port, each a module with `main(argv)`: the
counterparts of the JAX package's benchmarks/gpt2_decode.py,
llama_decode.py, prefill.py, serve_latency.py and accuracy.py, with the
same flags and the same metric names in their JSON lines.

    python -m onnx_rusty_inference_engine_tpu_torch.benchmarks.gpt2_decode

They run on the card and time with CUDA events (utils/timing.py); `--cpu`
runs them on the CPU, timed by the host clock, for a check that they run.
"""

"""ONNX op emitters (standard.py, extra.py, contrib_transformers.py,
core_attention.py, quantized.py, fused.py, control_flow.py, sequences.py,
rnn.py, bounded.py, losses.py, vision_roi.py, ml.py) and the kernels they
call (kernels/). The registry (registry.py) imports the emitter modules on
its first lookup, so importing a kernel module alone (as a loaded artifact
does) imports neither the emitters nor the registry."""

"""Parallelism on torch.distributed: meshes, sharding rules, the sharded
Engine's program and the GPipe pipeline.

The port's counterpart of onnx_rusty_inference_engine_tpu/parallel/. A
mesh is a `DeviceMesh` with named dims ("data" batch, "model" tensor,
"seq" sequence-parallel prefill, "pipe" pipeline stages), one rank a
device; a placement is a tuple of `Shard(d)` / `Replicate()` per mesh dim.
Where XLA inserts the collectives from annotations in the JAX package,
here each rank runs its shards and the collectives are explicit (spmd.py,
pipeline.py), with the same outputs: NCCL on the card, gloo on the CPU.
"""

from .mesh import initialize_distributed, local_mesh, make_mesh  # noqa: F401
from .pipeline import (  # noqa: F401
    PipelineError,
    PipelinedDecoder,
    align_blocks,
    infer_boundaries,
    split_stages,
)
from .sharding import (  # noqa: F401
    Replicate,
    Shard,
    cnn_param_sharding,
    data_input_sharding,
    replicated,
    seq_input_sharding,
    shard_params,
)

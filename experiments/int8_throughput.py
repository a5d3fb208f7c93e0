#!/usr/bin/env python3
"""INT8 and fp32 throughput of the port's SqueezeNet and BERT-base paths on
one CUDA card, for the package under a given root, so that two versions of
the port can be compared in one call on one card:

    python3 experiments/int8_throughput.py --root DIR [--root DIR2 ...]

Each --root is a checkout holding onnx_rusty_inference_engine_tpu_torch/;
each is run in its own process, in the order given (give parent, change,
change, parent to see the spread). Per root it prints one JSON line:
SqueezeNet 1.0 b256 images/s and BERT-base (B = 32, T = 128) sequences/s,
fp32 and INT8, from the package's own `utils.timing.engine_throughput`
(CUDA events over warmed, device-resident runs), with the card's name and
power limit. Weights from seed 0, as chip_smoke.py builds them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import onnx_rusty_inference_engine_tpu_torch as P
from onnx_rusty_inference_engine_tpu_torch.models.bert import BASE, build_bert
from onnx_rusty_inference_engine_tpu_torch.utils.timing import engine_throughput

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {"root": sys.argv[1]}
g = P.import_model(P.build_squeezenet())
x = np.random.default_rng(0).standard_normal((256, 3, 224, 224)).astype(np.float32)
feed = {"data_0": x}
q = P.quantize_graph(g, ranges=P.calibrate(g, [{"data_0": x[:8]}]))
out["squeezenet_fp32_images_per_s"] = engine_throughput(P.Engine(g), feed, iters=20, warmup=3)
out["squeezenet_int8_images_per_s"] = engine_throughput(P.Engine(q), feed, iters=20, warmup=3)
rng = np.random.default_rng(0)
ids = rng.integers(0, BASE.vocab_size, (32, 128))
seg = rng.integers(0, 2, (32, 128))
keep = rng.integers(32, 129, (32, 1))
feed = {"input_ids": ids, "token_type_ids": seg,
        "attention_mask": (np.arange(128)[None] < keep).astype(np.int64)}
gb = P.import_model(build_bert(BASE, batch=32, seq_len=128, seed=0))
gc = P.import_model(build_bert(BASE, batch=8, seq_len=128, seed=0))
ranges = P.calibrate(gc, [{k: v[:8] for k, v in feed.items()}], method="minmax")
qb = P.quantize_graph(gb, ranges=ranges)
out["bert_fp32_sequences_per_s"] = engine_throughput(P.Engine(gb), feed, iters=20, warmup=3)
out["bert_int8_sequences_per_s"] = engine_throughput(P.Engine(qb), feed, iters=20, warmup=3)
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", required=True)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    for root in args.root:
        proc = subprocess.run([sys.executable, "-c", CHILD,
                               os.path.abspath(root)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["card"] = smi
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

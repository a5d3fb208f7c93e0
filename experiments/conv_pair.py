#!/usr/bin/env python3
"""The int8 conv kernel's time at every SqueezeNet 1.0 b256 conv shape, for
the port under each given root, so that two versions of the kernel can be
compared in one call on one card:

    python3 experiments/conv_pair.py --root A --root B --root B --root A

Each --root is a checkout holding chip_smoke.py and
onnx_rusty_inference_engine_tpu_torch/ (give parent, change, change,
parent to see the spread). Each runs in its own process: chip_smoke.py's
device, build, slice and kernel phases (every QLinearConv of the INT8
forward bit-equal to its plain version, then timed from a replayed CUDA
graph). Per root it prints one JSON line: the kernel's ms per shape and
their sums per A producer (TMA, gather), with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import contextlib, io, json, os, sys
import torch
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as s
lines = []
s.emit = lambda obj: lines.append(obj)
torch.backends.cuda.matmul.allow_tf32 = False
with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                deterministic=False, allow_tf32=False):
    smi = s.phase_device()
    s.phase_build()
    eng, qgraph, eng8, card, launches, feed = s.phase_slice()
    s.phase_kernels(qgraph, eng8, card, launches, smi)
conv = [d for d in lines if d.get("phase") == "kernel"
        and d.get("kernel") == "qconv_int8_requant"]
sums = {}
for d in conv:
    sums[d["producer"]] = sums.get(d["producer"], 0.0) + d["ms"] * d.get(
        "count_per_forward", 1)
print(json.dumps({"root": root, "card": smi, "ms_by_producer": sums,
                  "shapes": [[d.get("x"), d.get("w"), d.get("stride"),
                              d["producer"], d["ms"]] for d in conv]}),
      flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", required=True)
    args = ap.parse_args()
    rc = 0
    for root in args.root:
        p = subprocess.run([sys.executable, "-c", CHILD,
                            os.path.abspath(root)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            print(json.dumps({"root": root, "exit": p.returncode,
                              "stderr": p.stderr[-3000:]}), flush=True)
            rc = 1
            continue
        print(p.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

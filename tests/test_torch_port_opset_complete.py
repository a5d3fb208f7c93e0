"""The port's opset completeness, as tests/test_opset_complete.py checks
the JAX package's: the port's op registry (with the ops it runs only as
static values, registry.STATIC_OPS) and host.py's host, fallback and
epilog tables against the checked-in spec lists docs/spec_ops_ai_onnx.txt
and docs/spec_ops_ai_onnx_ml.txt, in both directions, with the same
exclusions (CastMap only). The lists are read, never written."""

import pathlib

import pytest

from onnx_rusty_inference_engine_tpu_torch import host
from onnx_rusty_inference_engine_tpu_torch.ops import registry

DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"


def _read(name):
    wanted, excluded = set(), set()
    for line in (DOCS / name).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("!"):
            excluded.add(line[1:].split("#")[0].strip())
        else:
            wanted.add(line.split("#")[0].strip())
    return wanted, excluded


def _implemented():
    registry.supported_ops()  # loads the emitter modules
    dev = set(registry._REGISTRY) | {("", op) for op in registry.STATIC_OPS}
    host_ops = (set(host._HOST_EMITTERS) | set(host._EPILOG_EMITTERS)
                | set(host._HOST_FALLBACK))
    return dev, host_ops


@pytest.mark.parametrize("spec,domain,exclusions", [
    ("spec_ops_ai_onnx.txt", "", set()),
    ("spec_ops_ai_onnx_ml.txt", "ai.onnx.ml", {"CastMap"}),
], ids=["ai.onnx", "ai.onnx.ml"])
def test_port_opset_complete(spec, domain, exclusions):
    wanted, excluded = _read(spec)
    assert excluded == exclusions, excluded
    dev, host_ops = _implemented()
    have = {op for (d, op) in dev if d == domain} | host_ops
    missing = sorted(wanted - have)
    assert not missing, f"{domain or 'ai.onnx'} spec ops the port lacks: " \
                        f"{missing}"


def test_spec_list_covers_the_port_registry():
    """Every default-domain entry of the port's registry is a spec op or
    the bare contrib alias the JAX package also serves."""
    wanted, _ = _read("spec_ops_ai_onnx.txt")
    dev, _ = _implemented()
    extra = {op for (d, op) in dev if d == ""} - wanted \
        - {"SimplifiedLayerNormalization"}
    assert not extra, sorted(extra)


def test_ml_registry_is_the_spec_list():
    """The port's ai.onnx.ml device ops and host ops are the ml spec list
    less its exclusion, and no more."""
    wanted, _ = _read("spec_ops_ai_onnx_ml.txt")
    dev, host_ops = _implemented()
    ml_dev = {op for (d, op) in dev if d == "ai.onnx.ml"}
    assert ml_dev <= wanted
    assert wanted <= ml_dev | host_ops

"""Every public class, function and method of each module of qradiolink_tpu
has a twin of the same name in the port's module of the same path
(qradiolink_tpu_torch/...), inherited methods included, so that the port
cannot fall behind the reference unnoticed.

The reference's names are read from its source (ast): its modules import
JAX, and only their names are wanted. The port's module is imported, so
that a method it inherits counts. The exceptions, each with its reason, are
EXCEPTIONS below, and nothing else.
"""

import ast
import importlib
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "qradiolink_tpu"

# module path (relative to the package) or "module:name" -> reason
EXCEPTIONS = {
    "ops/pallas_fir.py": "Pallas TPU kernels (K1, K2, K4): their Hopper "
                         "kernels are ops/cuda_fir.py, ops/cuda_resample.py "
                         "and ops/cuda_depthwise.py",
    "ops/pallas_pfb.py": "the Pallas TPU kernel K5: its Hopper kernels are "
                         "ops/cuda_pfb.py",
    "fec/viterbi_pallas.py": "the Pallas TPU kernel K3: its Hopper kernels "
                             "are fec/viterbi_cuda.py",
    "utils/profiling.py:PallasPathRecorder": "its twin is "
                                             "KernelPathRecorder",
}


def public_names(path: pathlib.Path) -> list:
    """Public top-level classes and functions of a source file, and each
    public class's public methods as "Class.method"."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    names = []
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, defs + (ast.ClassDef,)) \
                or node.name.startswith("_"):
            continue
        names.append(node.name)
        if isinstance(node, ast.ClassDef):
            names += [f"{node.name}.{m.name}" for m in node.body
                      if isinstance(m, defs) and not m.name.startswith("_")]
    return names


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_the_exceptions_name_only_existing_parts():
    for key in EXCEPTIONS:
        rel, _, name = key.partition(":")
        assert rel in MODULES, key
        assert not name or name in public_names(REF / rel), key


@pytest.mark.parametrize("rel", [m for m in MODULES
                                 if m not in EXCEPTIONS])
def test_every_public_name_has_a_twin(rel):
    assert (ROOT / "qradiolink_tpu_torch" / rel).exists(), \
        f"no qradiolink_tpu_torch/{rel}"
    skip = {k.partition(":")[2] for k in EXCEPTIONS
            if k.startswith(rel + ":")}
    names = [n for n in public_names(REF / rel)
             if n.split(".")[0] not in skip]
    if not names:
        return
    mod = importlib.import_module(
        "qradiolink_tpu_torch." + rel[:-3].replace("/", ".")
        .removesuffix(".__init__"))
    missing = []
    for name in names:
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    assert not missing, f"qradiolink_tpu_torch/{rel} lacks {missing}"

"""The port stands alone: qradiolink_tpu_torch and chip_smoke.py import
neither jax nor qradiolink_tpu, and the port's entry points run on CUDA
unless the caller names another device."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
# a few intra-op threads only: the suite runs in several workers at once
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "qradiolink_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "qradiolink_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_imports_with_jax_and_reference_blocked():
    """Every module of the package imports in a fresh interpreter whose
    import system refuses jax and qradiolink_tpu."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        FORBIDDEN = {FORBIDDEN!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == f or name.startswith(f + ".")
                       for f in FORBIDDEN):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import qradiolink_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert not [m for m in sys.modules
                    if any(m == f or m.startswith(f + ".")
                           for f in FORBIDDEN)]
        print(len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_point_needs_cuda_or_an_explicit_device(monkeypatch):
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Fsk4DemodFF()
    assert Fsk4DemodFF(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda():
    """Without a card chip_smoke.py exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_scale_out_entry_points_need_cuda_or_a_device(monkeypatch):
    """A rank runs on the card unless the caller names its device: with no
    card and no device, init_process raises before it joins a group, and
    so do the mesh's device and a MultichannelRx."""
    from qradiolink_tpu_torch.parallel import multihost, sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.init_process("127.0.0.1:1", 2, 0, backend="gloo")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.rank_device()
    assert sharding.rank_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.MultichannelRx(8, [])
    with pytest.raises(RuntimeError, match="init_process"):
        sharding.make_mesh(device="cpu")

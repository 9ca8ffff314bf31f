"""Build and load the hand-written CUDA kernels of `qradiolink_tpu_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc alone
(no PyTorch headers, so a build takes seconds) into a shared library that
ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [per-source flags] -o lib<name>.so <name>.cu

Libraries go to `build/kernels/<hash>/` at the repository root, keyed by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is not. Nothing is built when a module is imported: the first
CUDA call of a wrapper builds its library, and `build_all()` builds every
source at once, one nvcc process each, started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]
# per-source flags: the Viterbi kernels and the per-row loops (the AGC, the
# Costas loop, the symbol sync, the FLL) must round every f32 operation on
# its own (see the notes in csrc/viterbi.cu and csrc/agc2.cu)
_EXTRA = {name: ["--fmad=false"] for name in (
    "viterbi", "viterbi_bfly", "viterbi_stream", "viterbi_stream_warp",
    "viterbi_stream_redux", "agc2", "costas", "symbol_sync",
    "fll_band_edge")}

# shared memory one block may use on Hopper (227 KB), in bytes
SMEM_MAX = 232_448

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return str(path)


def _cmd(name: str, out: pathlib.Path) -> list[str]:
    return [_nvcc(), *_ARCH, *_FLAGS, *_EXTRA.get(name, []),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(_ARCH + _FLAGS + _EXTRA.get(name, [])).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (name, final path, temporary path, process or None)."""
    lib = _lib_path(name)
    if lib.exists():
        return name, lib, None, None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(_cmd(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, lib, tmp, proc


def _finish(name, lib, tmp, proc) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    (lib.parent / f"{name}.log").write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return log


def build_all() -> dict[str, str]:
    """Build every kernel source, all nvcc processes in parallel; returns
    each source's compiler log (ptxas register and shared-memory use), ""
    for a library that was already built."""
    jobs = [_start(name) for name in sources()]
    logs = {}
    try:
        for job in jobs:
            logs[job[0]] = _finish(*job)
    finally:
        for _, _, _, proc in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(*_start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


"""resample_up_f32 built with other constants, timed in turns on one card.

    python scripts/resample_up_variants.py SPEC [SPEC ...]

Each SPEC is a comma-separated list NAME=VALUE of the `constexpr int NAME =
...;` lines of qradiolink_tpu_torch/csrc/resample_up.cu to change (the
empty SPEC "-" is the source as it stands), for example

    python scripts/resample_up_variants.py - kR1=32,kMinBlocks=4

Every variant is built with nvcc for sm_90a (all at once) into
build/resample_up_variants/. At the TX interpolators' shapes (2048 rows,
default taps) each variant's outputs and new state must equal
resample_poly_f32's bit for bit; the variants are then timed in turns (a,
b, ..., b, a; device times by CUDA events, chip_smoke.py's timer) while
nvidia-smi samples the SM clock and the power draw. Prints the card's name
and power limit first, each variant's ptxas lines, each median, and the
clock and power over the timed calls. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import turns_ms  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_resample  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402
from scripts.resample_route_sweep import ROWS, tx_shapes  # noqa: E402


def start_build(spec: str, kernel: str = "resample_up", patches=None):
    """nvcc for one variant of csrc/<kernel>.cu, started; returns (spec,
    .so path, process). An item of `spec` is NAME=VALUE or a key of
    `patches`, a list of (text, replacement) pairs that must each match
    the source once."""
    src = (kernels.CSRC / f"{kernel}.cu").read_text()
    for item in filter(None, spec.strip("-").split(",")):
        if "=" not in item:
            for old, new in (patches or {})[item]:
                if src.count(old) != 1:
                    raise RuntimeError(f"csrc/{kernel}.cu: {item} matches "
                                       f"{src.count(old)} times")
                src = src.replace(old, new)
            continue
        name, value = item.split("=")
        line = re.compile(rf"constexpr int {name} = -?\d+;")
        if len(line.findall(src)) != 1:
            raise RuntimeError(f"csrc/{kernel}.cu has no single {name}")
        src = line.sub(f"constexpr int {name} = {int(value)};", src)
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec) or "base"
    out = ROOT / "build" / f"{kernel}_variants" / tag
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{kernel}.cu").write_text(src)
    so = out / f"lib{kernel}.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels._ARCH,
                             *kernels._FLAGS, "-o", str(so),
                             str(out / f"{kernel}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return spec, so, proc


def bind(so, op: str = "resample_up_f32"):
    """A variant's library, its kernel `op` bound (resample_poly's C
    arguments) as lib.fn."""
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fn = getattr(lib, op)
    lib.fn.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.fn.restype = ctypes.c_int
    return lib


def call(lib, xs, taps, L, M, tails):
    """One launch of a variant (bind's lib): resample_poly's arguments and
    result."""
    C, T = xs[0].shape
    K = taps.shape[1]
    ys = tuple(torch.empty((C, T // M * L), device=xs[0].device)
               for _ in xs)
    state = torch.empty((C, 2, K - 1), device=xs[0].device)
    two = len(xs) == 2
    err = lib.fn(
        tails[0].data_ptr(), tails[1].data_ptr() if two else None,
        tails[0].stride(0), xs[0].data_ptr(),
        xs[1].data_ptr() if two else None, taps.data_ptr(),
        ys[0].data_ptr(), ys[1].data_ptr() if two else None,
        state.data_ptr(), C, T, K, L, M, len(xs),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: error {err}")
    return state, ys


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("resample_up_variants: CUDA is not available", file=sys.stderr)
        return 1
    specs = argv[1:] or ["-"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    jobs = [start_build(s) for s in specs]
    libs = {}
    for spec, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {spec}: {line.strip()}", flush=True)
        libs[spec] = bind(so)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, (rs, planes, T) in tx_shapes(dev).items():
        L, M, taps = rs.L, rs.M, rs.poly_taps
        xs = tuple(torch.randn((ROWS, T), generator=gen, device=dev)
                   for _ in range(planes))
        st = torch.randn((ROWS, 2, rs.kp - 1), generator=gen, device=dev)
        tails = (st[:, 0], st[:, 1])[:planes]
        w_state, w_ys = cuda_resample.launch(cuda_resample.OP, xs, taps, L,
                                             M, tails)
        fns = {}
        for spec, lib in libs.items():
            state, ys = call(lib, xs, taps, L, M, tails)
            if not (torch.equal(state, w_state) and all(
                    torch.equal(a, b) for a, b in zip(ys, w_ys))):
                raise RuntimeError(f"{spec} at {name}: differs from "
                                   f"resample_poly_f32")
            fns[spec] = (lambda lib=lib: call(lib, xs, taps, L, M, tails))
        del w_ys
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, text=True)
        try:
            ms, _ = turns_ms(fns)
        finally:
            smi.terminate()
            out, _ = smi.communicate()
        samples = [tuple(float(v) for v in line.split(","))
                   for line in out.splitlines() if line.count(",") == 1]
        busy = [s for s in samples if s[1] > 150.0] or samples
        print(f"{name} L{L} M{M} {planes}x{ROWS}x{T}: " + ", ".join(
            f"[{spec}] {t:.4f} ms" for spec, t in ms.items())
            + (f"; SM clock {statistics.median(s[0] for s in busy):.0f} MHz,"
               f" power {statistics.median(s[1] for s in busy):.1f} W "
               f"(median of {len(busy)} samples above 150 W)"
               if busy else ""), flush=True)
        del xs, st, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

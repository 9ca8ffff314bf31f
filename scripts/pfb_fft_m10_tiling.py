"""pfb_fft_f32's M 10, kp 56 instance (MMDVMmulti's channelizer) at other
tilings, timed in turns on one card.

    python scripts/pfb_fft_m10_tiling.py [NAME ...]   (default: every one)

Builds qradiolink_tpu_torch/csrc/pfb_fft.cu once for each tiling in
TILINGS, its `struct Shape<10, 56>` line replaced (TT rows a tile, FR rows
a FIR job, NT threads), with nvcc for sm_90a into
build/pfb_fft_m10/. At MMDVMmulti's one site (250,000 IqPair samples), a
headless block (30,000) and a farm of 64 sites it holds each build against
the plain version (1e-5 of the output's peak) and times the builds in turns
a, b, ..., b, a with chip_smoke.py's timer (device times, CUDA events),
beside an empty kernel's launch floor. Prints each build's ptxas line and
the card's name and power limit first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import cuda_ms, turns_ms  # noqa: E402
from qradiolink_tpu_torch.chains import mmdvm  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_pfb, cuda_resample  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_pfb import channelize_plain  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402

LINE = re.compile(r"template <> struct Shape<10, 56> \{\n.*?\n\};", re.S)
# name: (TT, FR, NT); "source" is the line as committed (128, 8, 320)
TILINGS = {
    "source": None,
    "tt64_fr8": (64, 8, 320),
    "tt64_fr4": (64, 4, 320),
    "tt32_fr4": (32, 4, 160),
}
SHAPES = {"one site": (1, 250_000), "headless block": (1, 30_000),
          "farm of 64": (64, 250_000)}


def build(name: str):
    """(library, ptxas line) of pfb_fft.cu with the tiling `name`."""
    src = (kernels.CSRC / "pfb_fft.cu").read_text()
    if len(LINE.findall(src)) != 1:
        raise RuntimeError("csrc/pfb_fft.cu has no single Shape<10, 56>")
    t = TILINGS[name]
    if t is not None:
        src = LINE.sub(
            "template <> struct Shape<10, 56> {\n    static constexpr int "
            "TT = %d, FR = %d, NT = %d;\n};" % t,
            src)
    out = ROOT / "build" / "pfb_fft_m10" / name
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "pfb_fft.cu"
    cu.write_text(src)
    so = out / "libpfb_fft.so"
    done = subprocess.run([kernels._nvcc(), *kernels._ARCH, *kernels._FLAGS,
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}"
                           f"{done.stderr}")
    lines = (done.stdout + done.stderr).splitlines()
    ptxas = "not found"
    for n, line in enumerate(lines):
        if "pfb_fft_kernelILi10ELi56E" in line and "Compiling" in line:
            ptxas = " ".join(s.strip() for s in lines[n + 1:n + 5]
                             if "spill" in s or "registers" in s)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfb_fft_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.pfb_fft_f32.restype = ctypes.c_int
    return lib, ptxas


def launcher(lib, xs, hist, ct, tw, ys, B, Tm):
    def run():
        err = lib.pfb_fft_f32(*(t.data_ptr() for t in (*xs, hist, ct, tw,
                                                        *ys)), B, Tm, 10, 56,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pfb_fft_f32 launch failed: {err}")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("pfb_fft_m10_tiling: CUDA is not available", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(TILINGS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ch = mmdvm.MmdvmMultiRx(device=dev).channelizer
    assert (ch.M, ch.kp) == (10, 56)
    libs = {}
    for name in names:
        libs[name], ptxas = build(name)
        print(f"  {name} {TILINGS[name] or 'as committed'}: {ptxas}",
              flush=True)
    tw = cuda_pfb._twiddles(10, dev)
    for shape, (B, T) in SHAPES.items():
        lead = (B,) if B > 1 else ()
        xs = tuple(torch.randn(lead + (T,), generator=gen, device=dev) * 0.1
                   for _ in range(2))
        hist = torch.randn(lead + (2, 560), generator=gen, device=dev) * 0.1
        plain = channelize_plain(xs, hist, ch._ct)
        peak = max(float(p.abs().max()) for p in plain)
        fns = {}
        for name, lib in libs.items():
            ys = tuple(torch.empty_like(p) for p in plain)
            fns[name] = launcher(lib, xs, hist, ch._ct, tw, ys, B, T // 10)
            fns[name]()
            torch.cuda.synchronize()
            err = max(float((y - p).abs().max()) for y, p in zip(ys, plain))
            if not err <= 1e-5 * peak:
                raise RuntimeError(f"{name} at {shape}: max |diff| {err:.3e}"
                                   f", peak {peak:.3e}")
        ms, turns = turns_ms(fns)
        floor = cuda_ms(lambda: cuda_resample.empty_launch(dev))
        print(f"  {shape} ({B} x {T}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in ms.items()) + f" ms (medians); turns "
            + ", ".join(f"{k} {t:.4f}" for k, t in turns)
            + f"; launch floor {floor:.4f} ms", flush=True)
        del xs, hist, plain, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""pfb_fft_f32 at two depths of its staging ring, timed in turns on one card.

    python scripts/pfb_fft_ring.py [STAGES_A STAGES_B]   (default 2 3)

Builds qradiolink_tpu_torch/csrc/pfb_fft.cu twice with nvcc for sm_90a, its
line `constexpr int kStages = ...;` set to each depth (the copy-ahead
distance follows it), into build/pfb_fft_ring/. At the mixed path's shape
(B 1, M 64, kp 24, Tm 100,000) it prints each build's ptxas lines, holds
each against the plain version (1e-5 of the output's peak), and times the
two in turns a, b, b, a with chip_smoke.py's timer (device times, CUDA
events). Prints the card's name and power limit first. Needs one CUDA
card and nvcc.
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

from chip_smoke import MIX_M, MIX_T, turns_ms  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_pfb  # noqa: E402
from qradiolink_tpu_torch.ops.channelizer import PfbChannelizer  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402

LINE = re.compile(r"constexpr int kStages = \d+;")


def build(stages: int):
    """(library, ptxas log) of pfb_fft.cu with a ring of `stages`."""
    src = (kernels.CSRC / "pfb_fft.cu").read_text()
    if len(LINE.findall(src)) != 1:
        raise RuntimeError("csrc/pfb_fft.cu has no single kStages line")
    out = ROOT / "build" / "pfb_fft_ring" / f"s{stages}"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "pfb_fft.cu"
    cu.write_text(LINE.sub(f"constexpr int kStages = {stages};", src))
    so = out / "libpfb_fft.so"
    done = subprocess.run([kernels._nvcc(), *kernels._ARCH, *kernels._FLAGS,
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed at {stages} stages:\n{done.stdout}"
                           f"{done.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfb_fft_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.pfb_fft_f32.restype = ctypes.c_int
    return lib, done.stdout + done.stderr


def ptxas_line(log: str, M: int, kp: int) -> str:
    """The register and spill lines of the (M, kp) instance."""
    lines = log.splitlines()
    for n, line in enumerate(lines):
        if f"pfb_fft_kernelILi{M}ELi{kp}E" in line and "Compiling" in line:
            return " ".join(s.strip() for s in lines[n + 2:n + 4])
    return "not found"


def main() -> int:
    if not torch.cuda.is_available():
        print("pfb_fft_ring: CUDA is not available", file=sys.stderr)
        return 1
    depths = [int(a) for a in sys.argv[1:]] or [2, 3]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ch = PfbChannelizer(MIX_M, device=dev)
    M, kp, Tm = MIX_M, ch.kp, MIX_T
    xs = tuple(torch.randn((Tm * M,), generator=gen, device=dev) * 0.05
               for _ in range(2))
    hist = torch.randn((2, kp * M), generator=gen, device=dev) * 0.05
    tw = cuda_pfb._twiddles(M, dev)
    ref = cuda_pfb.channelize_plain(xs, hist, ch._ct)
    peak = max(float(r.abs().max()) for r in ref)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {}
    for s in depths:
        lib, log = build(s)
        ys = tuple(torch.empty((M, Tm), device=dev) for _ in range(2))
        ptrs = [t.data_ptr() for t in (*xs, hist, ch._ct, tw, *ys)]

        def fn(lib=lib, ptrs=ptrs):
            err = lib.pfb_fft_f32(*ptrs, 1, Tm, M, kp, stream)
            if err:
                raise RuntimeError(f"launch failed: error {err}")
        fn()
        torch.cuda.synchronize()
        err = max(float((y - r).abs().max()) for y, r in zip(ys, ref))
        if err > 1e-5 * peak:
            raise RuntimeError(f"{s} stages: max |diff| {err:.3e} above "
                               f"1e-5 of the peak {peak:.3e}")
        print(f"{s} stages: {ptxas_line(log, M, kp)}; max |diff| "
              f"{err:.3e} of a {peak:.3e} peak", flush=True)
        fns[f"{s} stages"] = fn
    ms, turns = turns_ms(fns)
    print(f"M{M} kp{kp} Tm{Tm} in turns: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in turns), flush=True)
    print("medians: " + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""resample_rat_f32 built with other constants or with a part of its
design taken out, timed in turns on one card.

    python scripts/resample_rat_variants.py SPEC [SPEC ...]

Each SPEC is a comma-separated list of items, each either NAME=VALUE, a
`constexpr int NAME = ...;` line of qradiolink_tpu_torch/csrc/resample_rat.cu
to change, or the name of a part to take out (PATCHES):

    copy-after   stage chunk k + 1 after chunk k is computed, not during
    step-test    run a group's iterations alone, with a test a step, not
                 whole unrolled steps

The empty SPEC "-" is the source as it stands, for example

    python scripts/resample_rat_variants.py - copy-after kRuleBlocks=2

Every variant is built with nvcc for sm_90a (all at once) into
build/resample_rat_variants/. At the kernel's nine shapes (SHAPES: the
paths' blocks and MMDVMmulti's farm of 64 sites, 2 planes, the chains'
taps) each variant's outputs and new state must equal resample_poly_f32's
bit for bit; the variants are then timed in turns (a, b, ..., b, a; device
times by CUDA events, chip_smoke.py's timer). Prints the card's name and
power limit first, each variant's ptxas lines and each median. chip_smoke.py
times the source against resample_poly_f32, F.conv1d, the launch floor and
the bound at the same shapes. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import turns_ms  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_resample  # noqa: E402
from scripts.resample_up_variants import bind, call, start_build  # noqa: E402

# name: ((L, M), rows, input samples a row)
SHAPES = {
    "MMDVM TX, sweep (256 rows)": ((125, 12), 256, 24_000),
    "MMDVM TX, headless block": ((125, 12), 1, 2880),
    "DSSS TX, sweep (256 rows)": ((50, 13), 256, 5200),
    "MMDVMmulti TX, one site": ((25, 24), 7, 24_000),
    "MMDVMmulti TX, headless block": ((25, 24), 7, 2880),
    "MMDVMmulti TX, farm of 64 sites": ((25, 24), 448, 24_000),
    "MMDVMmulti RX, one site": ((24, 25), 7, 25_000),
    "MMDVMmulti RX, headless block": ((24, 25), 7, 3000),
    "MMDVMmulti RX, farm of 64 sites": ((24, 25), 448, 25_000),
}

_STORE = "ys[a * L] = acc[(a + 1) % A];\n            }\n        }\n"
PATCHES = {
    "copy-after": [
        ("        if (k + 1 < n_ch) stage(k + 1);\n", ""),
        (_STORE, _STORE + "        if (k + 1 < n_ch) {\n"
                          "            stage(k + 1);\n"
                          "            cp_async_commit();\n"
                          "        }\n")],
    "step-test": [
        ("const int n_it = (times + A - 1 + UA - 1) / UA * UA;",
         "const int n_it = times + A - 1;"),
        ("for (int a = 0; a < UA; ++a) {\n",
         "for (int a = 0; a < UA; ++a) {\n"
         "                if (c0 + a >= n_itk) break;\n")],
}


def rat_resampler(L, M, dev):
    """The chain's resampler at a resample_rat_f32 shape: MmdvmMod's up
    (125/12), DsssBpskMod's up_if (50/13), MmdvmMultiTx's (25/24) and
    MmdvmMultiRx's (24/25) resamp."""
    from qradiolink_tpu_torch.chains.dsss import DsssBpskMod
    from qradiolink_tpu_torch.chains.mmdvm import (
        MmdvmMod, MmdvmMultiRx, MmdvmMultiTx)

    return {(125, 12): lambda: MmdvmMod(device=dev).up,
            (50, 13): lambda: DsssBpskMod(device=dev).up_if,
            (25, 24): lambda: MmdvmMultiTx(device=dev).resamp,
            (24, 25): lambda: MmdvmMultiRx(device=dev).resamp}[(L, M)]()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("resample_rat_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    specs = argv[1:] or ["-"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    jobs = [start_build(s, "resample_rat", PATCHES) for s in specs]
    libs = {}
    for spec, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {spec}: {line.strip()}", flush=True)
        libs[spec] = bind(so, cuda_resample.RAT_OP)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, ((L, M), C, T) in SHAPES.items():
        rs = rat_resampler(L, M, dev)
        taps = rs.poly_taps
        xs = tuple(torch.randn((C, T), generator=gen, device=dev)
                   for _ in range(2))
        st = torch.randn((C, 2, rs.kp - 1), generator=gen, device=dev)
        tails = (st[:, 0], st[:, 1])
        w_state, w_ys = cuda_resample.launch(cuda_resample.OP, xs, taps, L,
                                             M, tails)
        fns = {}
        for spec, lib in libs.items():
            state, ys = call(lib, xs, taps, L, M, tails)
            if not (torch.equal(state, w_state) and all(
                    torch.equal(a, b) for a, b in zip(ys, w_ys))):
                raise RuntimeError(f"{spec} at {name}: differs from "
                                   f"{cuda_resample.OP}")
            fns[spec] = (lambda lib=lib: call(lib, xs, taps, L, M, tails))
        del w_ys
        ms, _ = turns_ms(fns)
        print(f"{name} L{L} M{M} K{rs.kp} 2x{C}x{T}: " + ", ".join(
            f"[{spec}] {t:.4f} ms" for spec, t in ms.items()), flush=True)
        del xs, st, tails, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

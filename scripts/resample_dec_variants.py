"""resample_dec_f32 built with other constants, instance parameters or a
part of its design undone, timed in turns on one card.

    python scripts/resample_dec_variants.py SPEC [SPEC ...]

Each SPEC is a comma-separated list of items:

    NAME=VALUE          a `constexpr int NAME = ...;` line of
                        qradiolink_tpu_torch/csrc/resample_dec.cu
    L/M/K:AS/CW/R/B     the instance X(L, M, K, ...) of QRL_DEC_INSTANCES
                        with AS tap rows a segment, CW columns a lane, R
                        chunk buffers and B blocks an SM for its launch
                        bounds
    full-rows           every warp runs AS rows, none the short body

The empty SPEC "-" is the source as it stands, for example

    python scripts/resample_dec_variants.py - 3/125/2091:9/2/3/1 full-rows

Every variant is built with nvcc for sm_90a (all at once) into
build/resample_dec_variants/. At the kernel's path shapes (SHAPES, 2
planes, the chains' taps) each variant's outputs must lie within the FIR's
bound of resample_poly_plain (chip_smoke.check_fir) and its state equal
it; the variants are then timed in turns (a, b, ..., b, a; device times by
CUDA events, chip_smoke.py's timer). Prints the card's name and power
limit first, each variant's ptxas lines and each median. Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import check_fir, turns_ms  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_resample  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402
from scripts.resample_dec_shapes import head_taps  # noqa: E402
from scripts.resample_up_variants import bind, call  # noqa: E402

# name: ((L, M, K), rows, input samples a row)
SHAPES = {
    "DMR head": ((3, 125, 2091), 2048, 200_000),
    "M17 head": ((3, 125, 349), 2048, 200_000),
    "MMDVM RX, sweep (256 rows)": ((12, 125, 523), 256, 250_000),
    "MMDVM RX, headless block": ((12, 125, 523), 1, 30_000),
    "4FSK10KFM head (256 rows)": ((2, 25, 105), 256, 200_000),
    "2FSK10K head (256 rows)": ((2, 25, 561), 256, 200_000),
    "GMSK2K head (L 1)": ((1, 50, 2239), 2048, 200_000),
}

_SHORTEN = ("constexpr bool shorten = tap_rows(M, K) - (S - 1) * AS < AS "
            "&& S <= 2;")
PATCHES = {
    "full-rows": [(_SHORTEN, "constexpr bool shorten = false;")],
}


def variant_source(spec: str) -> str:
    src = (kernels.CSRC / "resample_dec.cu").read_text()
    for item in filter(None, spec.strip("-").split(",")):
        if ":" in item:
            lmk, params = item.split(":")
            L, M, K = lmk.split("/")
            pat = re.compile(rf"X\({L}, {M}, {K}(, \d+){{4}}\)")
            if len(pat.findall(src)) != 1:
                raise RuntimeError(f"no single instance {lmk}")
            src = pat.sub(f"X({L}, {M}, {K}, " + ", ".join(
                params.split("/")) + ")", src)
        elif "=" in item:
            name, value = item.split("=")
            line = re.compile(rf"constexpr int {name} = -?\d+;")
            if len(line.findall(src)) != 1:
                raise RuntimeError(f"no single {name}")
            src = line.sub(f"constexpr int {name} = {int(value)};", src)
        else:
            for old, new in PATCHES[item]:
                if src.count(old) != 1:
                    raise RuntimeError(f"{item} matches {src.count(old)} "
                                       f"times")
                src = src.replace(old, new)
    return src


def start_build(spec: str):
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec) or "base"
    out = ROOT / "build" / "resample_dec_variants" / tag
    out.mkdir(parents=True, exist_ok=True)
    (out / "resample_dec.cu").write_text(variant_source(spec))
    so = out / "libresample_dec.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels._ARCH,
                             *kernels._FLAGS, "-o", str(so),
                             str(out / "resample_dec.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return spec, so, proc


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("resample_dec_variants: CUDA is not available",
              file=sys.stderr)
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
        libs[spec] = bind(so, cuda_resample.DEC_OP)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, ((L, M, K), C, T) in SHAPES.items():
        taps = head_taps((L, M, K), dev)
        xs = tuple(torch.randn((C, T), generator=gen, device=dev)
                   for _ in range(2))
        st = torch.randn((C, 2, K - 1), generator=gen, device=dev)
        tails = (st[:, 0], st[:, 1])
        p_state, p_ys = cuda_resample.resample_poly_plain(xs, taps, L, M,
                                                          tails)
        fns = {}
        for spec, lib in libs.items():
            state, ys = call(lib, xs, taps, L, M, tails)
            check_fir(f"{spec} at {name}", ys, p_ys)
            if not torch.equal(state, p_state):
                raise RuntimeError(f"{spec} at {name}: state differs")
            fns[spec] = (lambda lib=lib: call(lib, xs, taps, L, M, tails))
        del p_ys, p_state, ys, state
        ms, _ = turns_ms(fns)
        print(f"{name} L{L} M{M} K{K} 2x{C}x{T}: " + ", ".join(
            f"[{spec}] {t:.4f} ms" for spec, t in ms.items()), flush=True)
        del xs, st, tails, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

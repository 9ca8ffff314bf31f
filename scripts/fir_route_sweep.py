"""The strided FIR's polyphase kernels against fir_stream_f32, in turns,
at the shapes ops/cuda_fir.fir_route() gives them. One card.

    python scripts/fir_route_sweep.py

For each shape (taps K, stride D, planes, rows, samples a row, the tails
read in place from a (C, 2, K-1) state) it runs the routed kernel
(fir_long_f32 at D >= 32, fir_cols_f32 at D 2-31) and fir_stream_f32 on the
same inputs, holds both against the plain version (1e-5 of the output's
peak, and elementwise 1e-5 + 1e-5 |plain|), then times them in turns (old,
new, new, old; device time by CUDA events) and prints each median and
their ratio. The shapes: the three main-path shapes with 45 taps a phase
(the SSB head K5597 D125, the WBFM head K225 D5, the WBFM audio resampler
K1121 D25 on one plane) and the NBFM head (K2239 D50), then the edges of
the route's gate (A 17 and 64 at D 2, 5, 31, 32, 65, 128 and 256). The
card's name and power limit come first.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import bound, check_fir, turns_ms  # noqa: E402
from qradiolink_tpu_torch.chains.nbfm import NbfmDemod  # noqa: E402
from qradiolink_tpu_torch.chains.ssb import SsbDemod  # noqa: E402
from qradiolink_tpu_torch.chains.wbfm import WbfmDemod  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_fir  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402

# name: (K, D, planes, rows, outputs a row); taps from the chain where the
# name says so, seeded random taps elsewhere
SHAPES = {
    "ssb_head": (5597, 125, 2, 2048, 1600),
    "wbfm_head": (225, 5, 2, 2048, 40_000),
    "wbfm_audio_resamp": (1121, 25, 1, 2048, 1600),
    "nbfm_head": (2239, 50, 2, 32, 2000),
    "a17_d2": (34, 2, 2, 512, 50_000),
    "a64_d2": (128, 2, 2, 512, 50_000),
    "a17_d5": (85, 5, 2, 512, 20_000),
    "a64_d5": (320, 5, 2, 512, 20_000),
    "a17_d31": (527, 31, 2, 512, 3_200),
    "a64_d31": (1984, 31, 2, 512, 3_200),
    "a17_d32": (544, 32, 2, 512, 3_200),
    "a64_d32": (2048, 32, 2, 512, 3_200),
    "a17_d65": (1105, 65, 2, 512, 1_600),
    "a64_d65": (4160, 65, 2, 512, 1_600),
    "a64_d128": (8192, 128, 2, 512, 800),
    "a17_d256": (4352, 256, 2, 512, 400),
    "a32_d256": (8192, 256, 2, 512, 400),
}


def taps(name, K, dev, gen):
    chain = {"ssb_head": lambda: SsbDemod(device=dev).resamp,
             "wbfm_head": lambda: WbfmDemod(device=dev).resamp,
             "wbfm_audio_resamp": lambda: WbfmDemod(device=dev).audio_resamp,
             "nbfm_head": lambda: NbfmDemod(device=dev).resamp}.get(name)
    if chain is not None:
        tf = chain().phase_taps[0]
        assert tf.shape == (K,)
        return tf
    return torch.randn((K,), generator=gen, device=dev) / K ** 0.5


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    logs = kernels.build_all()
    for name in ("fir_long", "fir_cols"):
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, (K, D, planes, C, n_out) in SHAPES.items():
        op = cuda_fir.fir_route(K, D)
        assert op in (cuda_fir.LONG_OP, cuda_fir.COLS_OP), (name, op)
        T = n_out * D
        xs = [torch.randn((C, T), generator=gen, device=dev)
              for _ in range(planes)]
        st = torch.randn((C, 2, K - 1), generator=gen, device=dev)
        tails = (st[:, 0], st[:, 1])[:planes]
        tf = taps(name, K, dev, gen)
        fns = {cuda_fir.OP: lambda: cuda_fir._launch_stream(
                   xs, tf, D, n_out, tails),
               op: (lambda: cuda_fir.fir_long(xs, tf, D, n_out, tails))
               if op == cuda_fir.LONG_OP else
               (lambda: cuda_fir.fir_stream(xs, tf, D, n_out, tails=tails))}
        plain = cuda_fir.fir_stream_plain(xs, tf, D, n_out, tails=tails)
        errs = {k: check_fir(f"{k}/{name}", fn(), plain)
                for k, fn in fns.items()}
        del plain
        torch.cuda.synchronize()
        ms, _ = turns_ms(fns)
        n_bytes = 4 * (planes * C * (T + K - 1 + n_out) + K)
        b, by = bound(n_bytes, 2 * K * planes * C * n_out)
        print(f"{name} K{K} D{D} A{-(-K // D)} {planes}x{C}x{n_out}: "
              f"{op} err {errs[op]:.2e}, {cuda_fir.OP} err "
              f"{errs[cuda_fir.OP]:.2e}; in turns {cuda_fir.OP} "
              f"{ms[cuda_fir.OP]:.4f} ms, {op} {ms[op]:.4f} ms "
              f"({ms[cuda_fir.OP] / ms[op]:.2f}x), bound {b:.4f} ms ({by})",
              flush=True)
        del xs, st, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

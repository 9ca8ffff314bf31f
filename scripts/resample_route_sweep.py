"""The rational resampler's kernels, resample_poly_f32 and resample_up_f32
(and resample_x2_f32 where the route names it), in turns at each shape,
beside the route's choice. One card.

    python scripts/resample_route_sweep.py          # the whole sweep
    python scripts/resample_route_sweep.py tx       # the TX shapes only

For each shape (phases L, decimation M, taps a phase K, planes, 2048 rows,
the tails read in place from a (C, 2, K-1) state) it runs the kernels on
the same inputs, holds each against the plain version (1e-5 of the
output's peak, and elementwise 1e-5 + 1e-5 |plain|), checks that their
outputs and new states are equal bit for bit (and the state equal to the
plain version's), then times them in turns (a, b, b, a; device time by CUDA
events) and prints each median, resample_poly_f32's over each other's, the
bound on this card and the kernel ops/cuda_resample.route() names; a route
that names a slower kernel is marked. The shapes: the TX interpolators with
their default taps (SsbMod's L 125 M 1, 2 planes, 1,600 -> 200,000 a row;
AmMod's, one plane; NbfmMod's L 25 M 4, real, 1,600 -> 10,000, and L 20 M
1, 2 planes, 10,000 -> 200,000; QpskMod(125_000)'s x2, L 2 M 1 K 46, 2
planes, 100,000 -> 200,000, where resample_up_f32 runs below the L 3 its
route starts at), the NBFM audio resampler of the mixed path (L 2 M 5,
K 113, real, 32 rows x 2,000 -> 800; the route keeps it on
resample_poly_f32), then L in {3, 4, 5, 8, 20, 25, 125} x M in {1, 2, 4,
5} with gcd(L, M) = 1, K 45 and 113, one and two planes, seeded random
taps, about 40,000 outputs a row. The card's name and power limit come
first.
"""

import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import bound, check_fir, turns_ms  # noqa: E402
from qradiolink_tpu_torch.chains.am import AmMod  # noqa: E402
from qradiolink_tpu_torch.chains.nbfm import NbfmDemod, NbfmMod  # noqa: E402
from qradiolink_tpu_torch.chains.psk import QpskMod  # noqa: E402
from qradiolink_tpu_torch.chains.ssb import SsbMod  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_resample  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402

ROWS = 2048
OUT_A_ROW = 40_000
SWEEP_L = (3, 4, 5, 8, 20, 25, 125)
SWEEP_M = (1, 2, 4, 5)
SWEEP_K = (45, 113)


def tx_shapes(dev):
    """name: (resampler, planes, input samples a row) of the TX side."""
    ssbm = SsbMod(device=dev)
    nbm = NbfmMod(device=dev)
    return {"ssb_tx_up": (ssbm.up, 2, 1600),
            "am_tx_up": (AmMod(device=dev).up, 1, 1600),
            "nbfm_tx_up1": (nbm.up1, 1, 1600),
            "nbfm_tx_up2": (nbm.up2, 2, 10_000),
            "qpsk_tx_x2": (QpskMod(125_000, device=dev).up, 2, 100_000)}


def measure(name, L, M, taps, planes, T, gen, dev, rows=ROWS):
    """The kernels at one shape: checked, then timed in turns. Returns
    {kernel: ms}."""
    K = taps.shape[1]
    xs = tuple(torch.randn((rows, T), generator=gen, device=dev)
               for _ in range(planes))
    st = torch.randn((rows, 2, K - 1), generator=gen, device=dev)
    tails = (st[:, 0], st[:, 1])[:planes]
    want = cuda_resample.route(L, M, K)
    ops = (cuda_resample.OP, cuda_resample.UP_OP)
    ops += (want,) if want not in ops else ()
    fns = {op: (lambda op=op: cuda_resample.launch(op, xs, taps, L, M,
                                                   tails)) for op in ops}
    p_state, p_ys = cuda_resample.resample_poly_plain(xs, taps, L, M, tails)
    got = {op: fns[op]() for op in ops}
    for op in ops:
        check_fir(f"{op}/{name}", got[op][1], p_ys)
    s0, y0 = got[ops[0]]
    for op in ops[1:]:
        s1, y1 = got[op]
        if not (torch.equal(s0, s1) and torch.equal(s0, p_state)
                and all(torch.equal(a, b) for a, b in zip(y0, y1))):
            raise RuntimeError(f"{name}: {op}'s outputs or state differ "
                               f"from {ops[0]}'s")
    del got, p_ys, p_state, s0, y0
    torch.cuda.synchronize()
    ms, _ = turns_ms(fns)
    n_out = T // M * L
    b, by = bound(4 * (planes * rows * (K - 1 + T + n_out) + L * K
                       + 2 * rows * (K - 1)), 2 * K * planes * rows * n_out)
    fast = min(ms, key=ms.get)
    times = ", ".join(f"{op} {ms[op]:.4f} ms"
                      + ("" if op == ops[0] else
                         f" ({ms[ops[0]] / ms[op]:.2f}x)") for op in ops)
    print(f"{name} L{L} M{M} K{K} {planes}x{rows}x{T}->{n_out}: in turns "
          f"{times}, bound {b:.4f} ms ({by}); route {want}"
          f"{'' if want == fast else ' (SLOWER)'}", flush=True)
    return ms


def main(argv):
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    logs = kernels.build_all()
    for name in ("resample_poly", "resample_up", "resample_x2"):
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, (rs, planes, T) in tx_shapes(dev).items():
        measure(name, rs.L, rs.M, rs.poly_taps, planes, T, gen, dev)
        torch.cuda.empty_cache()
    ar = NbfmDemod(device=dev).audio_resamp
    measure("nbfm_audio_resamp", ar.L, ar.M, ar.poly_taps, 1, 2000, gen, dev,
            rows=32)
    if argv[1:] == ["tx"]:
        return 0
    for L in SWEEP_L:
        for M in SWEEP_M:
            if math.gcd(L, M) != 1:
                continue
            T = max(1, OUT_A_ROW // L) * M
            for K in SWEEP_K:
                taps = torch.randn((L, K), generator=gen, device=dev) / K
                for planes in (1, 2):
                    measure("grid", L, M, taps, planes, T, gen, dev)
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

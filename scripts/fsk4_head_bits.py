"""The M17 and DMR RX chains on the card against the port's CPU path with
each kernel that can serve their 3/125 head, on one card.

    python scripts/fsk4_head_bits.py

The input is chip_smoke.py's (fsk4_rx_input: each row's own transmission
at 10 dB, 2048 rows); the check is chip_smoke.fsk4_card_vs_cpu's, on its
CVC_ROWS rows x 2 blocks: the card chain's bits against the CPU chain's,
and each output's and state leaf's max |diff| over its peak. The head
runs on resample_dec_f32 (the route's kernel), resample_poly_f32 and the
per-phase route (cuda_resample.resample_phases: the strided FIR's kernel
once a phase); for each the bits that differ, the head's own max |diff|
against the CPU's head on the same input, and the symbols' are printed.
Then each head kernel on integer taps and samples, whose sums are exact
in f32: its outputs must equal the plain version's bit for bit. The
card's name and power limit come first.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_resample  # noqa: E402
from qradiolink_tpu_torch.ops import resample as resample_mod  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402

HEADS = ("resample_dec_f32", "resample_poly_f32", "per-phase")


def head_call(head):
    """resample_poly's signature on the named head kernel (CUDA planes)."""
    def call(xs, taps, L, M, tails):
        if head == "per-phase":
            return cuda_resample.resample_phases(xs, taps, L, M, tails)
        return cuda_resample.launch(head, xs, taps, L, M, tails)
    return call


def bits_against_cpu(kind, iqs, dev, head):
    Demod = chip_smoke.fsk4_chains(kind)[1]
    cpu = torch.device("cpu")
    chains = {d.type: Demod(lead_shape=(chip_smoke.CVC_ROWS,), device=d)
              for d in (dev, cpu)}
    states = {k: c.init_state() for k, c in chains.items()}
    orig = resample_mod.resample_poly
    n_bits, sym, head_d = [], 0.0, 0.0
    rs = chains["cpu"].resamp

    def dispatch(xs, taps, L, M, tails):
        if xs[0].device.type == "cuda":
            return head_call(head)(xs, taps, L, M, tails)
        return orig(xs, taps, L, M, tails)

    resample_mod.resample_poly = dispatch
    try:
        for blk in range(2):
            outs = {}
            for d in (dev, cpu):
                iq = IqPair(iqs[blk].re[:chip_smoke.CVC_ROWS].to(d)
                            .contiguous(),
                            iqs[blk].im[:chip_smoke.CVC_ROWS].to(d)
                            .contiguous())
                states[d.type], outs[d.type] = chains[d.type](
                    states[d.type], iq)
            card, host = outs["cuda"], outs["cpu"]
            n_bits.append(int((card["bits"].cpu() != host["bits"]).sum()))
            a, b = card["symbols"].cpu().double(), host["symbols"].double()
            sym = max(sym, float((a - b).abs().max()) / max(
                float(b.abs().max()), 1.0))
        # the head alone on the last block's input, card against CPU
        xs = tuple(p[:chip_smoke.CVC_ROWS].contiguous() for p in
                   (iqs[1].re, iqs[1].im))
        st = torch.randn((chip_smoke.CVC_ROWS, 2, rs.kp - 1),
                         generator=torch.Generator().manual_seed(3)) * 0.1
        tails = (st[:, 0], st[:, 1])
        _, want = cuda_resample.resample_poly_plain(
            tuple(x.cpu() for x in xs), rs.poly_taps, rs.L, rs.M, tails)
        _, got = head_call(head)(xs, chains["cuda"].resamp.poly_taps, rs.L,
                                 rs.M, tuple(t.to(dev) for t in tails))
        head_d = max(float((g.cpu() - w).abs().max())
                     for g, w in zip(got, want))
    finally:
        resample_mod.resample_poly = orig
    print(f"{kind} head on {head}: bits differing a block {n_bits}, "
          f"symbols max |diff| / peak {sym:.3e}, the head's max |diff| "
          f"against the CPU {head_d:.3e}", flush=True)


def integer_exact(kind, dev):
    rs = chip_smoke.fsk4_chains(kind)[1](device=dev).resamp
    L, M, K = rs.L, rs.M, rs.kp
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    taps = torch.randint(-3, 4, (L, K), generator=g, device=dev).float()
    xs = tuple(torch.randint(-3, 4, (5, 125 * 67), generator=g,
                             device=dev).float() for _ in range(2))
    st = torch.randint(-3, 4, (5, 2, K - 1), generator=g, device=dev).float()
    tails = (st[:, 0], st[:, 1])
    w_state, want = cuda_resample.resample_poly_plain(
        tuple(x.cpu() for x in xs), taps.cpu(), L, M,
        tuple(t.cpu() for t in tails))
    for head in HEADS:
        state, got = head_call(head)(xs, taps, L, M, tails)
        same = torch.equal(state.cpu(), w_state) and all(
            torch.equal(a.cpu(), b) for a, b in zip(got, want))
        print(f"{kind} K{K} integer taps and samples on {head}: "
              f"{'equal' if same else 'NOT equal'} to the plain version",
              flush=True)
        if not same:
            raise RuntimeError(f"{kind} {head}: integer sums differ")


def main() -> int:
    if not torch.cuda.is_available():
        print("fsk4_head_bits: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernels.build_all()
    dev = torch.device("cuda")
    for kind in ("m17", "dmr"):
        integer_exact(kind, dev)
        iqs, _ = chip_smoke.fsk4_rx_input(kind, dev)
        for head in HEADS:
            bits_against_cpu(kind, iqs, dev, head)
        del iqs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

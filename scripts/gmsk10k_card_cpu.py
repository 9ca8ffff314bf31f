"""GMSK10K's RX chain, card against CPU, stage by stage, on the input of
tests/test_torch_cuda.py::test_new_mode_on_card_matches_cpu[GMSK10K].

    python scripts/gmsk10k_card_cpu.py [--root DIR] [stages] [swaps]
        [heads] [time]

--root DIR imports qradiolink_tpu_torch from DIR (an earlier tree unpacked
there with git archive) in place of this checkout's; `time` needs this
checkout. With no part named, `stages` alone.

The input is the test's: a generator on the card seeded 0, two rows of 30
random bytes through the mode's TX chain on the card, the first 20,000
samples plus complex noise at 0.05 a plane, then two blocks of 10,000
through the RX chain on the card and on the CPU.

`stages`: the chain's stages as `_BinaryFskDemodBase.__call__` runs them
(resamp, chan_filter, quad, shaping, symbol_sync, the soft mapping,
fec_tail), each block's output and new state on both devices: max |card -
CPU| against the CPU's peak, chained (each device on its own upstream),
and each stage's own (the card's stage on the CPU's input and state); then
every state leaf of the chain against the test's bound, 2e-5 of its peak.

`swaps`: the card chain with one stage's output and state replaced by the
CPU's (each block), the leaves' distances to the CPU's then: which stage's
difference the later stages carry to the Viterbi's path metrics.

`heads`: the card chain with its 2/25 K561 head on each kernel that can
compute it (cuda_resample.launch; the route patched in this process only)
and the per-phase route, the leaves against the CPU's.

`time`: those head kernels at the head's shape (2 planes; 2 rows x 10,000,
the test's, and 256 x 200,000, the sweep's), each within the FIR's bound
of the plain version, in turns (chip_smoke.turns_ms).

Prints the card's name and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

MODE, T, N_BYTES, ROWS = "GMSK10K", 10_000, 30, 2
STAGES = ("resamp", "chan_filter", "quad", "shaping", "symbol_sync", "soft",
          "fec_tail")
LEAF_TOL = 2e-5


def to(obj, dev):
    """A tensor, IqPair or nested tuple of them on `dev`."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, IqPair):
        return IqPair(obj.re.to(dev), obj.im.to(dev))
    return tuple(to(o, dev) for o in obj)


def leaves(obj):
    return [t for t in _flatten(obj, []) if isinstance(t, torch.Tensor)]


def rel_diff(a, b):
    """(max |a - b|, peak |b|) over the leaves of a and b (b the CPU's);
    integers as the count of unequal elements, peak None; the carried
    phases as distances on the circle."""
    worst, peak, unequal = 0.0, 0.0, 0
    for x, y in zip(leaves(a), leaves(b)):
        x = x.cpu()
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        if not x.is_floating_point():
            unequal += int((x != y).sum())
            continue
        if not x.numel():
            continue
        d = (x.double() - y.double()).abs()
        worst = max(worst, float(d.max()))
        peak = max(peak, float(y.abs().max()))
    return worst, peak, unequal


def test_input(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randint(0, 256, (ROWS, N_BYTES), generator=gen, device=cuda,
                      dtype=torch.int64).to(torch.uint8)
    tx = registry.tx_chain(MODE, device=cuda, lead_shape=(ROWS,))
    iq = tx(tx.init_state(), x)[1]["iq"]
    iq = iq.to_complex() if isinstance(iq, IqPair) else iq
    iq = iq[..., :2 * T]
    iq = iq + 0.05 * torch.randn(iq.shape, generator=gen, device=cuda,
                                 dtype=torch.complex64)
    return [IqPair(iq[..., b * T:(b + 1) * T].real.contiguous(),
                   iq[..., b * T:(b + 1) * T].imag.contiguous())
            for b in range(2)]


def run_stages(chain, state, iq, swap=None, own=None):
    """One block through the chain's stages as its __call__ runs them:
    (new state, {stage: (state, output)}). swap: {stage: (state, output)}
    put in place of the stage's own (the CPU's, moved here); own: {stage:
    (state in, input)} from the CPU, each stage also run on them (its own
    error, kept under "own <stage>")."""
    from qradiolink_tpu_torch.chains.fsk import _delay_diversity

    it = iter(state)
    new, outs = [], {}
    dev = chain.device

    def stage(name, block, x):
        s_in = next(it)
        s, y = block(s_in, x)
        if own is not None:
            o_s, o_x = own[name]
            outs["own " + name] = block(to(o_s, dev), to(o_x, dev))
        outs["in " + name] = (s_in, x)
        if swap and name in swap:
            s, y = to(swap[name], dev)
        new.append(s)
        outs[name] = (s, y)
        return y

    x = stage("resamp", chain.resamp, iq)
    x = stage("chan_filter", chain.chan_filter, x)
    x = stage("quad", chain.quad, x)
    x = stage("shaping", chain.shaping, x)
    syms = stage("symbol_sync", chain.symbol_sync, x)
    soft = torch.clamp(syms * 128.0 + 128.0, 0.0, 255.0)
    if own is not None:
        o_syms = to(own["soft"][1], dev)
        outs["own soft"] = (None, torch.clamp(o_syms * 128.0 + 128.0, 0.0,
                                              255.0))
    outs["in soft"] = (None, syms)
    if swap and "soft" in swap:
        soft = to(swap["soft"][1], dev)
    outs["soft"] = (None, soft)
    stage("fec_tail", chain.fec_tail, _delay_diversity(soft))
    return tuple(new), outs


def chains(cuda):
    cpu = torch.device("cpu")
    return {d.type: registry.rx_chain(MODE, device=d, lead_shape=(ROWS,))
            for d in (cuda, cpu)}


def cpu_run(blocks):
    chain = chains(torch.device("cuda"))["cpu"]
    st, runs = chain.init_state(), []
    for xb in blocks:
        st, outs = run_stages(chain, st, to(xb, torch.device("cpu")))
        runs.append((st, outs))
    return runs


def leaf_report(tag, st_card, st_cpu):
    """Each float leaf's distance to the CPU's against LEAF_TOL of its
    peak; returns the indices out of bound."""
    out = []
    parts = []
    for i, (a, b) in enumerate(zip(leaves(st_card), leaves(st_cpu))):
        a = a.cpu()
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        if not a.is_floating_point():
            if not torch.equal(a, b):
                out.append(i)
                parts.append(f"{i}: unequal")
            continue
        d = (a.double() - b.double()).abs()
        d = torch.minimum(d, (d - 2 * np.pi).abs())
        peak = max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
        dm = float(d.max()) if d.numel() else 0.0
        lim = LEAF_TOL * max(peak, 1.0)
        if dm > lim:
            out.append(i)
        parts.append(f"{i}: {dm:.4g}/{lim:.4g}" + (" OUT" if dm > lim
                                                    else ""))
    print(f"  {tag} leaves (max |diff| / bound): " + ", ".join(parts),
          flush=True)
    return out


def stages_part(cuda, blocks, cpu_runs):
    chain = chains(cuda)["cuda"]
    st = chain.init_state()
    for b, xb in enumerate(blocks):
        own = {}
        _, cpu_outs = cpu_runs[b]
        for name in STAGES:
            if name == "soft":
                own[name] = (None, cpu_outs["in soft"][1])
            else:
                own[name] = cpu_outs["in " + name]
        st, outs = run_stages(chain, st, xb, own=own)
        for name in STAGES:
            for kind in ("", "own "):
                s, y = outs[kind + name]
                cs, cy = cpu_outs[name]
                wy, py, uy = rel_diff(y, cy)
                ws, ps, us = rel_diff(s, cs) if s is not None else (0, 0, 0)
                print(f"  block {b} {kind or 'chained '}{name}: output "
                      f"{wy:.4g} of peak {py:.4g} ({wy / max(py, 1e-30):.3g})"
                      + (f", {uy} unequal" if uy else "")
                      + (f"; state {ws:.4g} of peak {ps:.4g} "
                         f"({ws / max(ps, 1e-30):.3g})" if s is not None
                         else "")
                      + (f", {us} unequal" if us else ""), flush=True)
        leaf_report(f"block {b}", st, cpu_runs[b][0])


def swaps_part(cuda, blocks, cpu_runs):
    for name in STAGES:
        chain = chains(cuda)["cuda"]
        st, bad = chain.init_state(), []
        for b, xb in enumerate(blocks):
            swap = {name: cpu_runs[b][1][name]}
            st, _ = run_stages(chain, st, xb, swap=swap)
            bad += [(b, i) for i in leaf_report(
                f"CPU's {name} on the card, block {b}", st, cpu_runs[b][0])]
        print(f"  swap {name}: (block, leaf) out of bound {bad}", flush=True)


def head_ops():
    """name: a function of (xs, taps, L, M, tails) -> (state, ys) on CUDA
    planes for the 2/25 head."""
    ops = {op: (lambda op: lambda *a: cuda_resample.launch(op, *a))(op)
           for op in (cuda_resample.DEC_OP, cuda_resample.OP)}
    ops["per-phase"] = cuda_resample.resample_phases
    return ops


def heads_part(cuda, blocks, cpu_runs):
    from qradiolink_tpu_torch.ops import resample as resample_mod

    real = resample_mod.resample_poly
    for name, fn in head_ops().items():
        def patched(xs, taps, L, M, tails, fn=fn):
            if (L, M, taps.shape[1]) == (2, 25, 561):
                return fn(xs, taps, L, M, tails)
            return real(xs, taps, L, M, tails)
        resample_mod.resample_poly = patched
        try:
            chain = chains(cuda)["cuda"]
            st, bad = chain.init_state(), []
            for b, xb in enumerate(blocks):
                st, _ = run_stages(chain, st, xb)
                bad += [(b, i) for i in leaf_report(
                    f"head on {name}, block {b}", st, cpu_runs[b][0])]
        finally:
            resample_mod.resample_poly = real
        print(f"  head {name}: (block, leaf) out of bound {bad}", flush=True)


def time_part(cuda):
    from chip_smoke import check_fir, turns_ms

    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    rs = registry.rx_chain(MODE, device=cuda).resamp
    L, M, K = rs.L, rs.M, rs.kp
    taps = rs.poly_taps
    for C, Tr in ((ROWS, T), (256, 200_000)):
        xs = tuple(torch.randn((C, Tr), generator=gen, device=cuda)
                   for _ in range(2))
        st = torch.randn((C, 2, K - 1), generator=gen, device=cuda)
        tails = (st[:, 0], st[:, 1])
        p_state, p_ys = cuda_resample.resample_poly_plain(xs, taps, L, M,
                                                          tails)
        fns = {}
        for name, fn in head_ops().items():
            state, ys = fn(xs, taps, L, M, tails)
            err = check_fir(f"{name} L{L} M{M} K{K}", ys, p_ys)
            if not torch.equal(state, p_state):
                raise RuntimeError(f"{name}: state differs")
            print(f"  head {name} 2x{C}x{Tr}: max_abs_err {err:.3e}",
                  flush=True)
            fns[name] = (lambda fn=fn: fn(xs, taps, L, M, tails))
        ms, _ = turns_ms(fns)
        print(f"time L{L} M{M} K{K} 2x{C}x{Tr}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
        del xs, st, tails, p_ys, p_state, fns
        torch.cuda.empty_cache()


def main(argv):
    global torch, np, registry, cuda_resample, IqPair, _flatten
    args = list(argv[1:])
    root = ROOT
    if "--root" in args:
        i = args.index("--root")
        root = pathlib.Path(args[i + 1]).resolve()
        del args[i:i + 2]
    sys.path.insert(0, str(root))
    if root != ROOT:
        sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    from qradiolink_tpu_torch.core import IqPair, _flatten
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.ops import cuda_resample
    from qradiolink_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    import qradiolink_tpu_torch
    print(f"package {qradiolink_tpu_torch.__file__}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    cuda = torch.device("cuda")
    parts = [a for a in args if a in ("stages", "swaps", "heads", "time")]
    parts = parts or ["stages"]
    blocks = test_input(cuda)
    cpu_runs = cpu_run(blocks)
    if "stages" in parts:
        stages_part(cuda, blocks, cpu_runs)
    if "swaps" in parts:
        swaps_part(cuda, blocks, cpu_runs)
    if "heads" in parts:
        heads_part(cuda, blocks, cpu_runs)
    if "time" in parts:
        time_part(cuda)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""resample_dec_f32 at its instances, and the interpolators' row rule, on
one card: each kernel against the plain version, the rows in turns.
chip_smoke.py times resample_dec_f32 at the paths' shapes.

    python scripts/resample_dec_shapes.py            # check, rows, head
    python scripts/resample_dec_shapes.py check      # the checks alone
    python scripts/resample_dec_shapes.py head       # the head's rows alone
    python scripts/resample_dec_shapes.py order      # the in-order rows

`check`: ptxas's registers and spills for csrc/resample_dec.cu's
instances, then each instance with its chain's taps (the RX heads of
DMR, M17, MMDVM, 4FSK10KFM, 2FSK10K and GMSK2K, built through the
registry) over two chained blocks at 3 rows, one plane and two, on
16-byte aligned input and on input one word off it (the 4-byte copies),
and with a block shorter than the state: outputs within the FIR's bound of
resample_poly_plain (chip_smoke.check_fir), the new state equal.

`rows`: the interpolators that run at one row on a path (the net path's
QpskMod L4 K12 and L2 K46, the mixer's L6 K45, FreeDvMod's L125 K17, the
5/1 shapers of Fsk4Mod and M17Mod), and resample_dec_f32's 12/125, at 1, 7
and 256 rows, in turns on resample_poly_f32 and the kernel the route gives
many rows, with F.conv1d and an empty launch beside: the turns that set
cuda_resample.FEW_ROWS_MAX and FEW_ROWS_MAX_L.

`head`: the L 1 heads on fir_long_f32 and resample_dec_f32, bit-equal,
in turns, 2 planes: K2239 D50 (GMSK2K's taps, 100,000 samples a row) at
1, 2, 4, 8, 16, 32 and 64 rows; K5597 D125 (SSB's, 200,000 samples a
row) at 2048 rows (the SSB path), 256 (the sweep's USB and LSB), 16 and
1 (one radio's block): the turns behind cuda_fir.route giving those
heads resample_dec_f32 at every row count.

`order`: the taps-in-order instances (cuda_resample.DEC_IN_ORDER, the
2/25 K561 head of 2FSK10K and GMSK10K) at 1 to 256 rows on
resample_dec_f32 and resample_poly_f32, bit-equal, in turns: the turns
behind cuda_resample.route's row rule there.

The card's name and power limit come first.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import (check_fir, cuda_ms, launch_floor,  # noqa: E402
                        turns_ms)
from qradiolink_tpu_torch.models import registry  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_resample  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_fir import no_tf32  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402

DEC = cuda_resample.DEC_OP
HEADS = {(3, 125, 2091): "DMR", (3, 125, 349): "M17",
         (12, 125, 523): "MMDVM", (2, 25, 105): "4FSK10KFM",
         (2, 25, 561): "2FSK10K", (1, 50, 2239): "GMSK2K",
         (1, 125, 5597): "USB"}


def head_taps(shape, dev):
    rs = registry.rx_chain(HEADS[shape], device=dev).resamp
    assert (rs.L, rs.M, rs.kp) == shape
    return rs.poly_taps


def planes_of(C, T, planes, gen, dev, offset=0):
    """`planes` contiguous (C, T) planes, their data `offset` words past
    an allocation's start."""
    out = []
    for _ in range(planes):
        buf = torch.randn((C * T + offset,), generator=gen, device=dev)
        out.append(buf[offset:].view(C, T))
    return tuple(out)


def check(dev, gen):
    for shape in sorted(HEADS):
        L, M, K = shape
        taps = head_taps(shape, dev)
        for planes in (1, 2):
            for offset, n_pp in ((0, 101), (1, 75), (0, 3)):
                st = torch.randn((3, 2, K - 1), generator=gen, device=dev)
                for blk in range(2):
                    xs = planes_of(3, n_pp * M, planes, gen, dev, offset)
                    tails = (st[:, 0], st[:, 1])[:planes]
                    state, ys = cuda_resample.launch(DEC, xs, taps, L, M,
                                                     tails)
                    p_state, p_ys = cuda_resample.resample_poly_plain(
                        xs, taps, L, M, tails)
                    err = check_fir(f"{DEC} L{L} M{M} K{K}", ys, p_ys)
                    if not torch.equal(state, p_state):
                        raise RuntimeError(f"L{L} M{M} K{K}: state differs")
                    st = state
                print(f"  check L{L} M{M} K{K} planes {planes} offset "
                      f"{offset} n_pp {n_pp}: max_abs_err {err:.3e}, state "
                      f"equal over two blocks", flush=True)
    torch.cuda.synchronize()


def conv_lib(xs, tails, taps, L, M):
    """One F.conv1d with L output channels over [tail | x]: a timed call."""
    offs = cuda_resample.phase_offsets(L, M)
    K = taps.shape[1]
    w = torch.zeros((L, 1, K + offs[-1]), device=taps.device)
    for r, q in enumerate(offs):
        w[r, 0, q:q + K] = taps[r]
    lib_in = torch.stack([torch.cat([t, x], -1) for t, x in zip(tails, xs)]
                         ).reshape(len(xs) * xs[0].shape[0], 1, -1)

    def call():
        with no_tf32():
            return F.conv1d(lib_in, w, stride=M)
    return call


def row_shapes(dev):
    """name: (resampler, planes, input samples a row at one row)."""
    from qradiolink_tpu_torch.chains.freedv import FreeDvMod
    from qradiolink_tpu_torch.chains.fsk import Fsk4Mod
    from qradiolink_tpu_torch.chains.m17 import M17Mod
    from qradiolink_tpu_torch.ops.resample import RationalResampler

    qm = registry.tx_chain("QPSK250K", device=dev)
    return {"net qpsk_shaper": (qm.shaper, 2, 12_500),
            "net qpsk_x2": (qm.up, 2, 50_000),
            "mixer 8k->48k": (RationalResampler(6, 1, device=dev), 1, 800),
            "freedv_mod x125": (FreeDvMod(device=dev).up, 2, 24_000),
            "fsk4 shaper": (Fsk4Mod(device=dev).shaper, 1, 1_000),
            "m17 shaper": (M17Mod(device=dev).shaper, 1, 960)}


def rows_sweep(dev, gen):
    floor = launch_floor(dev)
    print(f"empty launch {floor:.4f} ms", flush=True)
    shapes = {k: (rs.L, rs.M, rs.poly_taps, planes, T)
              for k, (rs, planes, T) in row_shapes(dev).items()}
    shapes["mmdvm_rx"] = (12, 125, head_taps((12, 125, 523), dev), 2,
                          30_000)
    for name, (L, M, taps, planes, T) in shapes.items():
        K = taps.shape[1]
        many = cuda_resample.route(L, M, K)
        for rows in (1, 7, 256):
            Tr = T if rows * T * L <= 300_000_000 else T // 10 // M * M
            xs = planes_of(rows, Tr, planes, gen, dev)
            st = torch.randn((rows, 2, K - 1), generator=gen, device=dev)
            tails = (st[:, 0], st[:, 1])[:planes]
            ops = [cuda_resample.OP] + ([many] if many != cuda_resample.OP
                                        else [])
            fns = {op: (lambda op=op: cuda_resample.launch(op, xs, taps, L, M,
                                                           tails))
                   for op in ops}
            p_state, p_ys = cuda_resample.resample_poly_plain(xs, taps, L, M,
                                                              tails)
            for op, fn in fns.items():
                state, ys = fn()
                check_fir(f"{op}/{name}", ys, p_ys)
                if not torch.equal(state, p_state):
                    raise RuntimeError(f"{op}/{name}: state differs")
            ms, _ = turns_ms(fns)
            lib_ms = cuda_ms(conv_lib(xs, tails, taps, L, M))
            win = min(ms, key=ms.get)
            print(f"rows {name} L{L} M{M} K{K} {planes}x{rows}x{Tr}: "
                  + ", ".join(f"{op} {ms[op]:.4f}" for op in ops)
                  + f", F.conv1d {lib_ms:.4f}; faster: {win}; route("
                  f"rows={rows}) {cuda_resample.route(L, M, K, rows)}",
                  flush=True)
            del xs, st, tails, p_ys, p_state
            torch.cuda.empty_cache()


# the L 1 heads' row counts: (K, M): (input samples a row, rows)
HEAD_ROWS = {(2239, 50): (100_000, (1, 2, 4, 8, 16, 32, 64)),
             (5597, 125): (200_000, (2048, 256, 16, 1))}


def head_rows(dev, gen):
    for (K, M), (T, counts) in HEAD_ROWS.items():
        head_rows_of(K, M, T, counts, dev, gen)


def head_rows_of(K, M, T, counts, dev, gen):
    from qradiolink_tpu_torch.ops import cuda_fir

    tf = head_taps((1, M, K), dev)[0]
    for rows in counts:
        xs = planes_of(rows, T, 2, gen, dev)
        st = torch.randn((rows, 2, K - 1), generator=gen, device=dev)
        tails = (st[:, 0], st[:, 1])
        fns = {cuda_fir.LONG_OP: lambda: cuda_fir.fir_long(
                   xs, tf, M, T // M, tails),
               DEC: lambda: cuda_fir._launch_dec(xs, tf, M, tails)}
        outs = {op: fn() for op, fn in fns.items()}
        if not all(torch.equal(a, b) for a, b in
                   zip(outs[DEC], outs[cuda_fir.LONG_OP])):
            raise RuntimeError(f"head at {rows} rows: {DEC} is not "
                               f"bit-equal to {cuda_fir.LONG_OP}")
        ms, _ = turns_ms(fns)
        win = min(ms, key=ms.get)
        print(f"head K{K} D{M} 2x{rows}x{T}: " + ", ".join(
            f"{op} {t:.4f}" for op, t in ms.items()) + f"; faster: {win}; "
            f"route {cuda_fir.route(K, M)}", flush=True)
        del xs, st, tails, outs
        torch.cuda.empty_cache()


def in_order_rows(dev, gen):
    """The taps-in-order instances (cuda_resample.DEC_IN_ORDER: the 2/25
    K561 head) at 1 to 256 rows, 2 planes, on resample_dec_f32 and
    resample_poly_f32, bit-equal, in turns: the turns behind
    cuda_resample.route's row rule there."""
    for L, M, K in cuda_resample.DEC_IN_ORDER:
        taps = head_taps((L, M, K), dev)
        for rows in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            T = 125_000 if rows <= 64 else 200_000
            xs = planes_of(rows, T, 2, gen, dev)
            st = torch.randn((rows, 2, K - 1), generator=gen, device=dev)
            tails = (st[:, 0], st[:, 1])
            fns = {op: (lambda op=op: cuda_resample.launch(op, xs, taps, L,
                                                           M, tails))
                   for op in (cuda_resample.OP, DEC)}
            outs = {op: fn() for op, fn in fns.items()}
            a, b = outs[DEC], outs[cuda_resample.OP]
            if not (torch.equal(a[0], b[0]) and all(
                    torch.equal(u, v) for u, v in zip(a[1], b[1]))):
                raise RuntimeError(f"L{L} M{M} K{K} at {rows} rows: {DEC} "
                                   f"is not bit-equal to {cuda_resample.OP}")
            ms, _ = turns_ms(fns)
            win = min(ms, key=ms.get)
            print(f"in order L{L} M{M} K{K} 2x{rows}x{T}: " + ", ".join(
                f"{op} {t:.4f}" for op, t in ms.items()) + f"; faster: "
                f"{win}; route {cuda_resample.route(L, M, K, rows)}",
                flush=True)
            del xs, st, tails, outs, a, b
            torch.cuda.empty_cache()


def main(argv):
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    logs = kernels.build_all()
    for line in logs.get("resample_dec", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  resample_dec: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if argv[1:] not in (["head"], ["order"]):
        check(dev, gen)
    if argv[1:] in ([], ["rows"]):
        rows_sweep(dev, gen)
    if argv[1:] in ([], ["head"]):
        head_rows(dev, gen)
    if argv[1:] in ([], ["order"]):
        in_order_rows(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

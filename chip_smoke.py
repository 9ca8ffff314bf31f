#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (qradiolink_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card and the repository around this file; it builds the
kernels from qradiolink_tpu_torch/csrc, so nvcc must be on PATH or under
/usr/local/cuda. It exits nonzero, printing no result, when CUDA is missing,
when the package cannot be imported, and when any phase fails:

 1. the card's name and power limit (nvidia-smi);
 2. build every kernel, all nvcc processes at once;
 3. each kernel against its plain PyTorch version on the card, at the shapes
    the 4FSK main path gives it with 2048 channels x 200,000 samples a step:
    the FIR at the resampler head (two chained blocks), the channel
    low-pass and the RRC within 1e-5 (relative to the output's peak, and
    elementwise |k - p| <= 1e-5 + 1e-5 |p|); the Viterbi bit-exact on
    integer soft, on non-integer chain-like soft, and decoding real CCSDS
    codewords; with each one's time, its plain version's, F.conv1d's as
    the library yardstick for the FIR, and its bound on this card;
 4. the main path: Fsk4DemodFF(lead_shape=(2048,)) for 3 steps of 200,000
    samples with state carried, launch counters zeroed just before and read
    just after (every FIR stage and the Viterbi must have launched their
    kernels on every step); then one more step timed stage by stage;
 5. the frozen capture tests/fixtures/iq_4fsk2k_-6db.npz streamed in two
    blocks on the card and on the CPU: the bits must be equal and the BER
    against the payload below 0.01.

The second-to-last line is a JSON object with one entry per kernel and
stage; the last line is {"ok": true, "device": {...}}.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
FIXTURE = HERE / "tests" / "fixtures" / "iq_4fsk2k_-6db.npz"

N_CH = 2048
T_STEP = 200_000
N_STEPS = 3
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
FIR_TOL = 1e-5


def cuda_ms(fn, iters=10, warmup=2):
    """Median time of fn() in ms, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate."""
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def best_ber(decoded, sent, max_offset=400):
    """Min BER over bit alignments on the steady-state segment [n/2, 7n/8)
    (a copy of tests/test_chains_digital.best_ber)."""
    n = len(sent)
    lo, hi = n // 2, (7 * n) // 8
    seg_sent = sent[lo:hi]
    best = 1.0
    for off in range(max_offset):
        seg_dec = decoded[off + lo: off + hi]
        if len(seg_dec) < len(seg_sent):
            break
        best = min(best, float(np.mean(seg_dec != seg_sent)))
    return best


def check_fir(name, kern, plain):
    """Compare kernel planes with plain planes; returns max_abs_err."""
    err = 0.0
    for k, p in zip(kern, plain):
        diff = (k - p).abs()
        err = max(err, float(diff.max()))
        rel = float(diff.max() / p.abs().max())
        bad = int((diff > FIR_TOL + FIR_TOL * p.abs()).sum())
        if not (rel <= FIR_TOL and bad == 0 and torch.isfinite(k).all()):
            raise RuntimeError(f"{name}: kernel disagrees with plain "
                               f"(max rel {rel:.3e}, {bad} elements out)")
    return err


def fir_phase(chain, dev, gen):
    from qradiolink_tpu_torch.ops.cuda_fir import fir_stream, fir_stream_plain
    import torch.nn.functional as F

    rows = []

    def measure(name, replaces, xs, tf, D, n_out, tails, shape, timing=True):
        kern = fir_stream(xs, tf, D, n_out, tails=tails)
        plain = fir_stream_plain(xs, tf, D, n_out, tails=tails)
        torch.cuda.synchronize()
        err = check_fir(name, kern, plain)
        if not timing:
            print(f"  {name}: max_abs_err {err:.3e}", flush=True)
            return
        K = tf.shape[0]
        xcat = [x if tails is None else torch.cat([t, x], -1)
                for x, t in zip(xs, tails or [None] * len(xs))]
        lib_in = torch.stack(xcat).reshape(-1, 1, xcat[0].shape[-1])
        w = tf.reshape(1, 1, K)
        ms = cuda_ms(lambda: fir_stream(xs, tf, D, n_out, tails=tails))
        plain_ms = cuda_ms(lambda: fir_stream_plain(xs, tf, D, n_out,
                                                    tails=tails))
        lib_ms = cuda_ms(lambda: F.conv1d(lib_in, w, stride=D))
        n_in = sum(x.numel() for x in xs) + (
            0 if tails is None else sum(t.numel() for t in tails))
        n_bytes = 4 * (n_in + len(xs) * N_CH * n_out + K)
        b_ms, b_by = bound(n_bytes, 2 * K * len(xs) * N_CH * n_out)
        print(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  F.conv1d {lib_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        rows.append({"name": f"fir_stream_f32/{name}", "route": "cuda",
                     "source": "qradiolink_tpu_torch/csrc/fir.cu",
                     "replaces": replaces, "shape": shape,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # resampler head: two chained blocks, the tails read through strided
    # views of a (C, 2, K-1) state as the chain reads them; the second
    # (carried-tail) block is timed
    rs = chain.resamp
    k1 = rs.kp - 1
    state = torch.zeros((N_CH, 2, k1), device=dev)
    for blk in range(2):
        x = (randn(N_CH, T_STEP), randn(N_CH, T_STEP))
        tails = (state[:, 0, :], state[:, 1, :])
        measure("head", "qradiolink_tpu/ops/pallas_fir.py:218", x,
                rs.phase_taps[0], rs.M, T_STEP // rs.M, tails,
                f"K{rs.kp} D{rs.M} tail", timing=blk == 1)
        state = torch.stack([x[0][:, -k1:], x[1][:, -k1:]], dim=-2)
        del x
    n_lo = T_STEP // rs.M
    cf = chain.chan_filter
    st = randn(N_CH, 2, cf.ntaps - 1)
    measure("chan_lp", "qradiolink_tpu/ops/pallas_fir.py:218",
            (randn(N_CH, n_lo), randn(N_CH, n_lo)), cf.taps_flipped, 1, n_lo,
            (st[:, 0, :], st[:, 1, :]), f"K{cf.ntaps} D1 tail")
    sh = chain.shaping
    measure("rrc", "qradiolink_tpu/ops/pallas_fir.py:111",
            (randn(N_CH, n_lo + sh.ntaps - 1),), sh.taps_flipped, 1, n_lo,
            None, f"K{sh.ntaps} D1")
    return rows


def viterbi_phase(dev, gen):
    from qradiolink_tpu_torch.fec.conv import CCSDS_K7, conv_encode
    from qradiolink_tpu_torch.fec.conv_ff import viterbi_decode_tiled
    from qradiolink_tpu_torch.fec.viterbi_cuda import (decode_windows,
                                                       decode_windows_plain)

    W, S = 32, 192
    R = N_CH * 4  # 400 pairs + 32 overlap, padded to 4 chunks of 128
    soft_int = torch.randint(0, 256, (R, S, 2), generator=gen, device=dev)
    soft_int = soft_int.float()
    syms = torch.randn((R, S), generator=gen, device=dev) * 1.5
    ph = float(np.pi / 2) * syms
    soft_chain = torch.clamp(
        torch.stack([torch.sin(ph), torch.cos(ph)], -1) * 128.0 + 128.0,
        0.0, 255.0)
    if bool((soft_chain == soft_chain.round()).all()):
        raise RuntimeError("chain-like soft came out integer")
    for label, soft in (("integer", soft_int), ("chain-like", soft_chain)):
        k = decode_windows(CCSDS_K7, soft, W)
        p = decode_windows_plain(CCSDS_K7, soft, W)
        n_diff = int((k != p).sum())
        print(f"  viterbi {label} soft R{R} S{S}: {n_diff} bits differ",
              flush=True)
        if n_diff:
            raise RuntimeError(f"viterbi kernel not bit-exact ({label})")
    # real CCSDS codewords, noisy soft: the interior must decode exactly
    bits = torch.randint(0, 2, (64, 600), generator=gen, device=dev)
    coded = conv_encode(CCSDS_K7, bits.to(torch.uint8)).reshape(64, 600, 2)
    soft = coded.float() * 255.0 + torch.randn(
        (64, 600, 2), generator=gen, device=dev) * 40.0
    soft = torch.nn.functional.pad(soft.clamp(0.0, 255.0), (0, 0, 0, 40),
                                   value=128.0)
    dec = viterbi_decode_tiled(CCSDS_K7, soft)
    if not torch.equal(dec[:, 32:568], bits[:, 32:568].to(torch.uint8)):
        raise RuntimeError("viterbi kernel failed to decode codewords")
    print("  viterbi decodes 64 noisy CCSDS codewords exactly", flush=True)

    ms = cuda_ms(lambda: decode_windows(CCSDS_K7, soft_chain, W))
    plain_ms = cuda_ms(lambda: decode_windows_plain(CCSDS_K7, soft_chain, W),
                       iters=3, warmup=1)
    # per state-step: 2 mul + 4 add/sub + compare + select
    b_ms, b_by = bound(R * S * 2 * 4 + R * (S - W), R * S * 64 * 8)
    print(f"  viterbi: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return [{"name": "viterbi_tiled_k7", "route": "cuda",
             "source": "qradiolink_tpu_torch/csrc/viterbi.cu",
             "replaces": "qradiolink_tpu/fec/viterbi_pallas.py:83",
             "shape": f"S{S}", "max_abs_err": 0.0, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None}]


def main_path(chain, dev, gen):
    from qradiolink_tpu_torch.core import IqPair
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    iq = IqPair(torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1,
                torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1)
    state = chain.init_state()
    torch.cuda.synchronize()
    step_s = []
    kernel_paths.reset()
    for _ in range(N_STEPS):
        t0 = time.perf_counter()
        state, out = chain(state, iq)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    report = kernel_paths.report()
    print(f"  kernel paths over {N_STEPS} steps: {json.dumps(report)}",
          flush=True)
    if not kernel_paths.served_only():
        raise RuntimeError("a stage took the plain path on the card")
    n_sym = T_STEP // chain.resamp.M // chain.sps
    checks = {"bits": (N_CH, n_sym), "symbols": (N_CH, n_sym),
              "rssi": (N_CH,)}
    for key, shape in checks.items():
        if tuple(out[key].shape) != shape:
            raise RuntimeError(f"{key} shape {tuple(out[key].shape)}")
    if out["bits"].dtype != torch.uint8 or int(out["bits"].max()) > 1:
        raise RuntimeError("bits are not 0/1 uint8")
    for v in (out["symbols"], out["rssi"], out["constellation"].re,
              out["constellation"].im):
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError("non-finite chain output")
    ms = [s * 1e3 for s in step_s]
    med = statistics.median(ms[1:])
    print(f"  step ms {[round(m, 3) for m in ms]}  (median of steps 2-3 "
          f"{med:.3f} ms, {N_CH * T_STEP / med / 1e3:.1f} Msamples/s, "
          f"{N_CH * T_STEP / med / 1e3 / N_CH:.2f} Msamples/s per channel)",
          flush=True)

    # one more step, stage by stage (after the counters were read)
    from qradiolink_tpu_torch.core import Sequencer
    from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
    seq = Sequencer(state)
    stages = {}

    def timed(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn()
        end.record()
        end.synchronize()
        stages[name] = round(start.elapsed_time(end), 4)
        return y

    x = timed("resampler (fir head)", lambda: seq(chain.resamp, iq))
    x = timed("channel LP (fir)", lambda: seq(chain.chan_filter, x))
    timed("rssi", lambda: rssi_dbm(x))
    x = timed("quadrature demod", lambda: seq(chain.quad, x))
    x = timed("RRC (fir)", lambda: seq(chain.shaping, x))
    syms = timed("feedforward sync", lambda: seq(chain.symbol_sync, x))

    def soft_map():
        ph = float(np.pi / 2) * syms
        s = torch.stack([torch.sin(ph), torch.cos(ph)], -1)
        return torch.clamp(s.reshape(N_CH, -1) * 128.0 + 128.0, 0.0, 255.0)

    soft = timed("soft mapping", soft_map)
    timed("FEC tail (viterbi + descrambler)", lambda: seq(chain.fec_tail,
                                                          soft))
    print(f"  stage ms (one step, CUDA events): {json.dumps(stages)}",
          flush=True)
    return report


def fixture_phase(dev):
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits
    from qradiolink_tpu_torch.core import IqPair

    data = np.load(FIXTURE)
    re = data["iq_re"].astype(np.float32)
    im = data["iq_im"].astype(np.float32)
    half = len(re) // 2
    outs = {}
    for d in (dev, torch.device("cpu")):
        chain = Fsk4DemodFF(device=d)
        state = chain.init_state()
        bits, syms = [], []
        for sl in (slice(0, half), slice(half, 2 * half)):
            iq = IqPair(torch.from_numpy(re[sl].copy()).to(d),
                        torch.from_numpy(im[sl].copy()).to(d))
            state, out = chain(state, iq)
            bits.append(out["bits"].cpu().numpy())
            syms.append(out["symbols"].cpu().numpy())
        outs[d.type] = (np.concatenate(bits), np.concatenate(syms))
    (gb, gs), (cb, cs) = outs["cuda"], outs["cpu"]
    sent = bytes_to_bits(torch.from_numpy(data["payload"])).numpy()
    ber = best_ber(gb, sent)
    n_diff = int((gb != cb).sum())
    print(f"  fixture: {n_diff} of {gb.size} bits differ card vs CPU, "
          f"symbols max |diff| {float(np.abs(gs - cs).max()):.3e}, "
          f"BER {ber:.4f}", flush=True)
    if n_diff:
        raise RuntimeError("card bits differ from CPU bits on the fixture")
    if not ber < 0.01:
        raise RuntimeError(f"fixture BER {ber}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.utils import kernels

    # the reference computes in full f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(kernels.sources())}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    chain = Fsk4DemodFF(lead_shape=(N_CH,), device=dev)

    print("kernels against their plain versions:", flush=True)
    rows = fir_phase(chain, dev, gen) + viterbi_phase(dev, gen)
    torch.cuda.empty_cache()

    print(f"main path: Fsk4DemodFF {N_CH} ch x {T_STEP} samples, "
          f"{N_STEPS} steps", flush=True)
    report = main_path(chain, dev, gen)
    for row in rows:
        op = row["name"].split("/")[0]
        row["launches"] = report.get(op, {}).get("shapes", {}).get(
            f"cuda {row.pop('shape')}", 0)
        if row["launches"] < N_STEPS:
            raise RuntimeError(f"{row['name']} launched {row['launches']} "
                               f"times in {N_STEPS} steps")

    print("frozen capture:", flush=True)
    fixture_phase(dev)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The PSK loop kernels' dependent chains timed alone, on one card.

    python scripts/loop_chain_floor.py [--old DIR] [--sass DIR] [--trig]

`costas_loop_f32` and `symbol_sync_mm_f32` run one serial recurrence a row,
32 rows a warp, 64 warps at 2048 rows: less than one warp an SM, so nothing
hides a step's latency and a kernel takes about T x (its chain's latency) /
clock. This script measures that floor with chain-only variants of both
loops (COSTAS_SRC and SYNC_SRC below), built with --fmad=false as the
kernels are. Each includes its kernel's source and runs the kernel's own
step functions, the input taken from a ring of 8 samples held in registers
(read from memory once, so nothing is constant-folded), no loads or stores
in the loop, the outputs folded into a checksum so that nothing is dead:

  costas  "cosf_sinf": the kernel's first step (cosf and sinf apart,
          sign() times a value, fmodf); "sincosf": the same with one
          sincosf; "kernel": csrc/costas.cu's step<4, true> (the later
          tiles' step)
  sync    csrc/symbol_sync.cu's coeffs and update<0> with the samples from
          the register ring ("regs": the arithmetic alone) or from a ring
          of 64 samples a lane in shared memory at the position reached, by
          4 8-byte loads as the kernel reads its ring ("ring": the kernel's
          chain without its fills and stores)

each timed at QPSK250K's shapes (the carrier PLL 2048 x 100,000 and the
symbol-rate loop 2048 x 25,000, order 4; the sync 2048 x 100,000 -> 25,000
symbols), beside the kernels of csrc/ (through their wrappers) on a QPSK
signal at the same shapes, while nvidia-smi samples the SM clock: ms, ns
and cycles a step at the sampled clock.

--old DIR   also builds DIR/costas.cu and DIR/symbol_sync.cu (an earlier
            design, whose symbol_sync_mm_f32 took no ld, S, R or reach),
            holds each to the kernel of csrc/ bit for bit at the shapes
            above, and times the two in turns (old, new, new, old).
--sass DIR  writes cuobjdump -sass of the kernels' and the variants'
            libraries to DIR.
--ablate    also builds each kernel with one part of its I/O taken away or
            changed (ABLATIONS below: the Costas input tiles not staged
            after the first two; no output stores; the sync's ring filled
            once; its fills through L1) and times each build in turns with
            the kernel at the shapes above: what each part still costs the
            chain's warp (the builds' outputs are not checked).
--trig      checks over all 2^32 float bit patterns that `sincosf`, and
            `sinf` and `cosf` apart, give torch.sin's and torch.cos's bits
            on this card (NaN against NaN counts as equal), printing the
            count of patterns that differ for each.

Prints the card's name and power limit first and one JSON line last.
Needs one CUDA card and nvcc; builds into build/loop_chain_floor/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import N_CH, QPSK_SYMS, T_STEP, cuda_ms, loop_signal  # noqa: E402
from chip_smoke import turns_ms  # noqa: E402
from qradiolink_tpu_torch.sync import cuda_costas as cc  # noqa: E402
from qradiolink_tpu_torch.sync import cuda_symbol_sync as css  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402

OUT = ROOT / "build" / "loop_chain_floor"
RING = 8  # register ring of the chain variants

# The chain variants. Each source includes the kernel's own file (nvcc -I
# csrc/), so the variants run the kernel's step functions themselves:
# costas.cu's step<4, true> (the later tiles' step) and symbol_sync.cu's
# coeffs and update<0> (MODE 0, the QPSK path's).
COSTAS_SRC = r"""
#include "costas.cu"

namespace {

constexpr int kRing = 8;

// the kernel's first step: cosf and sinf apart, sign() times a value,
// fmodf
__device__ __forceinline__ float old_sgn(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

template <bool SINCOS>
__device__ __forceinline__ void old_step(float xr, float xi, float& ph,
                                         float& fr, float& yr, float& yi,
                                         float alpha, float beta,
                                         float max_freq, float pi,
                                         float two_pi) {
    float c, s;
    if (SINCOS) {
        sincosf(ph, &s, &c);
        s = -s;
    } else {
        c = cosf(ph);
        s = -sinf(ph);
    }
    yr = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, s));
    yi = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, c));
    float e = __fsub_rn(__fmul_rn(old_sgn(yr), yi), __fmul_rn(old_sgn(yi), yr));
    e = fminf(fmaxf(e, -1.0f), 1.0f);
    fr = fminf(fmaxf(__fadd_rn(fr, __fmul_rn(beta, e)), -max_freq), max_freq);
    ph = __fadd_rn(__fadd_rn(ph, fr), __fmul_rn(alpha, e));
    float r = fmodf(__fadd_rn(ph, pi), two_pi);
    if (r < 0.0f) r = __fadd_rn(r, two_pi);
    ph = __fsub_rn(r, pi);
}

// VARIANT 0: the first step; 1: the same with sincosf; 2: costas.cu's
template <int VARIANT>
__global__ void __launch_bounds__(32)
costas_chain(const float2* __restrict__ seed, float* __restrict__ ph_out,
             float* __restrict__ fr_out, unsigned* __restrict__ sink, int C,
             int T, float alpha, float beta, float max_freq, float pi,
             float two_pi) {
    const int row = blockIdx.x * 32 + threadIdx.x;
    if (row >= C) return;
    float2 ring[kRing];
#pragma unroll
    for (int k = 0; k < kRing; ++k) ring[k] = seed[row * kRing + k];
    float ph = 0.0f, fr = 0.0f;
    unsigned acc = 0u;
    for (int t = 0; t < T; t += kRing) {
#pragma unroll
        for (int k = 0; k < kRing; ++k) {
            float yr, yi;
            if (VARIANT == 2)
                step<4, true>(ring[k].x, ring[k].y, ph, fr, yr, yi, alpha,
                              beta, max_freq, pi, two_pi);
            else
                old_step<VARIANT == 1>(ring[k].x, ring[k].y, ph, fr, yr, yi,
                                       alpha, beta, max_freq, pi, two_pi);
            acc ^= __float_as_uint(yr) ^ (__float_as_uint(yi) << 1);
        }
    }
    ph_out[row] = ph;
    fr_out[row] = fr;
    sink[row] = acc;
}

__global__ void fill_bits(float* __restrict__ x, unsigned base, long long n) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) x[i] = __uint_as_float(base + (unsigned)i);
}

__device__ __forceinline__ bool same(float a, float b) {
    return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}

// bad[0..3]: patterns where sincosf's sine, its cosine, sinf, cosf differ
// from ts, tc (torch.sin, torch.cos of x)
__global__ void trig_check(const float* __restrict__ x,
                           const float* __restrict__ ts,
                           const float* __restrict__ tc,
                           unsigned long long* __restrict__ bad, long long n) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    unsigned b0 = 0, b1 = 0, b2 = 0, b3 = 0;
    if (i < n) {
        float s, c;
        sincosf(x[i], &s, &c);
        b0 = !same(s, ts[i]);
        b1 = !same(c, tc[i]);
        b2 = !same(sinf(x[i]), ts[i]);
        b3 = !same(cosf(x[i]), tc[i]);
    }
    b0 = __reduce_add_sync(0xffffffffu, b0);
    b1 = __reduce_add_sync(0xffffffffu, b1);
    b2 = __reduce_add_sync(0xffffffffu, b2);
    b3 = __reduce_add_sync(0xffffffffu, b3);
    if ((threadIdx.x & 31) == 0 && (b0 | b1 | b2 | b3)) {
        atomicAdd(bad + 0, (unsigned long long)b0);
        atomicAdd(bad + 1, (unsigned long long)b1);
        atomicAdd(bad + 2, (unsigned long long)b2);
        atomicAdd(bad + 3, (unsigned long long)b3);
    }
}

}  // namespace

extern "C" {

int costas_chain_f32(const void* seed, void* ph_out, void* fr_out, void* sink,
                     int C, int T, int variant, float alpha, float beta,
                     float max_freq, float pi, float two_pi, void* stream) {
    if (C < 1 || T < 0 || T % kRing || variant < 0 || variant > 2)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((C + 31) / 32);
    cudaStream_t st = (cudaStream_t)stream;
#define QRL_CHAIN(V)                                                         \
    costas_chain<V><<<grid, 32, 0, st>>>(                                    \
        (const float2*)seed, (float*)ph_out, (float*)fr_out,                 \
        (unsigned*)sink, C, T, alpha, beta, max_freq, pi, two_pi)
    if (variant == 0) QRL_CHAIN(0);
    else if (variant == 1) QRL_CHAIN(1);
    else QRL_CHAIN(2);
#undef QRL_CHAIN
    return (int)cudaGetLastError();
}

int trig_bits_f32(void* x, void* ts, void* tc, void* bad, unsigned base,
                  long long n, int check, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((n + 255) / 256);
    if (check)
        trig_check<<<blocks, 256, 0, st>>>((const float*)x, (const float*)ts,
                                           (const float*)tc,
                                           (unsigned long long*)bad, n);
    else
        fill_bits<<<blocks, 256, 0, st>>>((float*)x, base, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
"""

SYNC_SRC = r"""
#include "symbol_sync.cu"

namespace {

constexpr int kRing = 8;

// SRC 0 takes the samples from the register ring (the arithmetic alone),
// 1 from a shared ring of 64 samples a lane at the position reached, by 4
// 8-byte loads as symbol_sync.cu reads its ring
template <int SRC>
__global__ void __launch_bounds__(32)
sync_chain(const float2* __restrict__ seed, float* __restrict__ pos_out,
           float* __restrict__ om_out, unsigned* __restrict__ sink, int rows,
           int n_out, float omin, float omax, float alpha, float beta,
           float inv_norm, float max_pos, float sps) {
    constexpr int kLen = 64, kStride = kLen + 2;  // symbol_sync.cu's stride
    __shared__ __align__(16) float2 s_ring[32 * kStride];
    const int lane = threadIdx.x;
    const int row = blockIdx.x * 32 + lane;
    float2 ring[kRing];
#pragma unroll
    for (int k = 0; k < kRing; ++k)
        ring[k] = row < rows ? seed[row * kLen + k] : make_float2(0.f, 0.f);
    for (int k = 0; k < kLen; ++k)
        s_ring[lane * kStride + k] =
            row < rows ? seed[row * kLen + k] : make_float2(0.f, 0.f);
    __syncwarp();
    const float2* mine = s_ring + lane * kStride;
    float lv[kMaxLevels] = {};
    float pos = 16.0f, om = sps;
    float2 yp = make_float2(0.f, 0.f), dp = make_float2(0.f, 0.f);
    unsigned acc = 0u;
    for (int m0 = 0; m0 < n_out; m0 += kRing) {
#pragma unroll
        for (int q = 0; q < kRing; ++q) {
            float c[4];
            const int j0 = coeffs(pos, max_pos, c);
            float2 w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
                w[k] = SRC == 0 ? ring[(q + k) % kRing]
                                : mine[(j0 + k) & (kLen - 1)];
            float yr, yi, dr, di;
            update<0>(w, c, lv, 0, omin, omax, alpha, beta, inv_norm, yr, yi,
                      dr, di, pos, om, yp, dp);
            acc ^= __float_as_uint(yr) ^ (__float_as_uint(yi) << 1);
        }
    }
    if (row < rows) {
        pos_out[row] = pos;
        om_out[row] = om;
        sink[row] = acc;
    }
}

}  // namespace

extern "C" {

int sync_chain_f32(const void* seed, void* pos_out, void* om_out, void* sink,
                   int rows, int n_out, int src, float omin, float omax,
                   float alpha, float beta, float inv_norm, float max_pos,
                   float sps, void* stream) {
    if (rows < 1 || n_out % kRing || src < 0 || src > 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((rows + 31) / 32);
    cudaStream_t st = (cudaStream_t)stream;
    if (src == 0)
        sync_chain<0><<<grid, 32, 0, st>>>(
            (const float2*)seed, (float*)pos_out, (float*)om_out,
            (unsigned*)sink, rows, n_out, omin, omax, alpha, beta, inv_norm,
            max_pos, sps);
    else
        sync_chain<1><<<grid, 32, 0, st>>>(
            (const float2*)seed, (float*)pos_out, (float*)om_out,
            (unsigned*)sink, rows, n_out, omin, omax, alpha, beta, inv_norm,
            max_pos, sps);
    return (int)cudaGetLastError();
}

}  // extern "C"
"""


def nvcc(cu: pathlib.Path, so: pathlib.Path) -> subprocess.Popen:
    """nvcc for one source with the loop kernels' flags (--fmad=false),
    csrc/ on the include path."""
    so.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([kernels._nvcc(), *kernels._ARCH, *kernels._FLAGS,
                             "--fmad=false", "-I", str(kernels.CSRC), "-o",
                             str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def finish(name: str, proc: subprocess.Popen, so: pathlib.Path):
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {name}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def bind_chains(costas, sync):
    p, i, f, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong, ctypes.c_uint)
    costas.costas_chain_f32.argtypes = [p, p, p, p, i, i, i, f, f, f, f, f, p]
    costas.trig_bits_f32.argtypes = [p, p, p, p, u, ll, i, p]
    sync.sync_chain_f32.argtypes = [p, p, p, p, i, i, i, f, f, f, f, f, f, f,
                                    p]
    for fn in (costas.costas_chain_f32, costas.trig_bits_f32,
               sync.sync_chain_f32):
        fn.restype = ctypes.c_int


def bind_old(costas, sync):
    """The C entry points of the earlier costas_loop_f32 and
    symbol_sync_mm_f32 (before the ring's ld, S, R and reach)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    costas.costas_loop_f32.argtypes = [p, p, p, p, p, p, i, i, i, f, f, f, f,
                                       f, p]
    sync.symbol_sync_mm_f32.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i,
                                        i, i, i, i, p, i, f, f, f, f, f, f, p]
    for fn in (costas.costas_loop_f32, sync.symbol_sync_mm_f32):
        fn.restype = ctypes.c_int


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: launch failed, CUDA error {err}")


def sampled(fn):
    """fn() while nvidia-smi samples the SM clock every 50 ms; returns
    (fn's result, median MHz of the samples above 150 W or all)."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        smi.terminate()
        text, _ = smi.communicate()
    rows = [tuple(float(v) for v in line.split(","))
            for line in text.splitlines() if line.count(",") == 1]
    busy = [r for r in rows if r[1] > 150.0] or rows
    return out, (statistics.median(r[0] for r in busy) if busy else None)


def per_step(ms: float, steps: int, mhz) -> dict:
    d = {"ms": ms, "ns_a_step": ms * 1e6 / steps}
    if mhz:
        d["mhz"] = mhz
        d["cycles_a_step"] = ms * 1e-3 * mhz * 1e6 / steps
    return d


def old_costas(lib, x, ph, fr, a):
    C, T = x.shape
    y = torch.empty_like(x)
    ph_o, fr_o = torch.empty_like(ph), torch.empty_like(fr)
    check(lib.costas_loop_f32(x.data_ptr(), ph.data_ptr(), fr.data_ptr(),
                              y.data_ptr(), ph_o.data_ptr(), fr_o.data_ptr(),
                              C, T, *a, cc.PI, cc.TWO_PI, stream()),
          "old costas_loop_f32")
    return y, ph_o, fr_o


def old_sync(lib, tail, x, s, n_out, ss):
    rows, L = tail.shape
    T = x.shape[1]
    pos, om, yp, dp = s
    y = torch.empty((rows, n_out), dtype=torch.complex64, device=x.device)
    outs = [torch.empty_like(pos), torch.empty_like(om),
            torch.empty_like(yp), torch.empty_like(dp)]
    check(lib.symbol_sync_mm_f32(
        tail.data_ptr(), x.data_ptr(), pos.data_ptr(), om.data_ptr(),
        yp.data_ptr(), dp.data_ptr(), y.data_ptr(),
        *(o.data_ptr() for o in outs), rows, L, T, n_out, 1, css.MODE_CONJ,
        pos.data_ptr(), 0, ss.sps - ss.omega_limit, ss.sps + ss.omega_limit,
        ss.alpha, ss.beta, css.recip(ss.ted_norm), float(L + T - 3),
        stream()), "old symbol_sync_mm_f32")
    return (y, *outs)


def trig_all(lib, dev) -> list[int]:
    """Patterns of all 2^32 where sincosf's sine, cosine, sinf, cosf differ
    from torch.sin, torch.cos, in chunks of 2^28."""
    n = 1 << 28
    x = torch.empty(n, device=dev)
    bad = torch.zeros(4, dtype=torch.int64, device=dev)
    for k in range(1 << 4):
        check(lib.trig_bits_f32(x.data_ptr(), None, None, None, k * n, n, 0,
                                stream()), "fill_bits")
        ts, tc = torch.sin(x), torch.cos(x)
        check(lib.trig_bits_f32(x.data_ptr(), ts.data_ptr(), tc.data_ptr(),
                                bad.data_ptr(), 0, n, 1, stream()),
              "trig_check")
        del ts, tc
    return [int(v) for v in bad.tolist()]


# (kernel source, name, line, replacement): builds for --ablate, each
# with one part of the kernel's I/O taken away or changed (timing only)
ABLATIONS = (
    ("costas", "no_staging",
     "stage(s_x[b], x, row0, n_rows, T, t0 + 2 * kTile, lane);", ""),
    ("costas", "no_stores",
     "y[(size_t)(row0 + r) * T + t0 + lane] = s_y[b][r][lane];", ";"),
    ("symbol_sync", "fills_once",
     "fill<XC>(my_re, my_im, g_lo, g_hi, R, trow, xrow, L);",
     "if (m0 == 0) fill<XC>(my_re, my_im, g_lo, g_hi, R, trow, xrow, L);"),
    ("symbol_sync", "no_stores",
     "y[(size_t)(row0 + r) * n_out + t0 + lane] = s_y[r][lane];", ";"),
    ("symbol_sync", "fills_ca",
     "cp.async.cg.shared.global [%0], [%1], 16;",
     "cp.async.ca.shared.global [%0], [%1], 16;"),
)
COSTAS_VARIANTS = ("cosf_sinf", "sincosf", "kernel")
SYNC_VARIANTS = ("regs", "ring")


def with_lib(name, lib, fn):
    """fn, its wrapper's kernel library swapped for lib (the same C entry
    points) while it runs: a closure for the timers."""
    def run():
        keep = kernels._loaded.get(name)
        kernels._loaded[name] = lib
        try:
            return fn()
        finally:
            kernels._loaded[name] = keep
    return run


def ablate(libs, x, ph0, q, s0, sync_args):
    """Each ABLATIONS build timed in turns with the kernel (kernel, build,
    build, kernel) at the PLL's, the symbol-rate loop's and the sync's
    QPSK250K shapes."""
    T_in = x.shape[1]
    shapes = {"costas": [("qpsk_pll", q.costas_pll, T_in),
                         ("qpsk_symbols", q.costas, QPSK_SYMS)],
              "symbol_sync": [("qpsk", None, None)]}
    out = {}
    for name, tag, _, _ in ABLATIONS:
        lib = libs[f"{name} {tag}"]
        for shape, loop, T in shapes[name]:
            if name == "costas":
                xs = x[:, :T].contiguous()
                a = (4, loop.alpha, loop.beta, loop.max_freq)
                fn = (lambda xs=xs, a=a: cc.costas_loop(xs, ph0, ph0, *a))
            else:
                fn = (lambda: css.symbol_sync(s0[4], x, *sync_args(s0)))
            (ms, seq), mhz = sampled(lambda: turns_ms({
                "kernel": fn, tag: with_lib(name, lib, fn)}))
            key = f"{name}/{shape}/{tag}"
            out[key] = {"ms": ms, "turns": seq, "mhz": mhz}
            print(f"ablate {key}: {json.dumps(out[key])}", flush=True)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("loop_chain_floor: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path)
    ap.add_argument("--sass", type=pathlib.Path)
    ap.add_argument("--trig", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in (("chain_costas", COSTAS_SRC), ("chain_sync", SYNC_SRC)):
        (OUT / f"{name}.cu").write_text(src)
        so = OUT / f"lib{name}.so"
        jobs[name] = (nvcc(OUT / f"{name}.cu", so), so)
    if args.old:
        for name in ("costas", "symbol_sync"):
            so = OUT / "old" / f"lib{name}.so"
            jobs[f"old {name}"] = (nvcc(args.old / f"{name}.cu", so), so)
    if args.ablate:
        for name, tag, line, repl in ABLATIONS:
            src = (kernels.CSRC / f"{name}.cu").read_text()
            if src.count(line) != 1:
                raise RuntimeError(f"csrc/{name}.cu has no single `{line}`")
            d = OUT / "ablate" / f"{name}_{tag}"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{name}.cu").write_text(src.replace(line, repl))
            so = d / f"lib{name}.so"
            jobs[f"{name} {tag}"] = (nvcc(d / f"{name}.cu", so), so)
    kjobs = [kernels._start(name) for name in ("costas", "symbol_sync")]
    logs = {job[0]: kernels._finish(*job) for job in kjobs}
    for name in ("costas", "symbol_sync"):
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    libs = {k: finish(k, *v) for k, v in jobs.items()}
    bind_chains(libs["chain_costas"], libs["chain_sync"])
    chain, schain = libs["chain_costas"], libs["chain_sync"]
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
        cuobjdump = pathlib.Path(kernels._nvcc()).with_name("cuobjdump")
        for name, so in [("chain_costas", jobs["chain_costas"][1]),
                         ("chain_sync", jobs["chain_sync"][1]),
                         ("costas", kernels._lib_path("costas")),
                         ("symbol_sync", kernels._lib_path("symbol_sync"))]:
            sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            (args.sass / f"{name}.sass").write_text(sass)
        print(f"SASS written to {args.sass}", flush=True)

    from qradiolink_tpu_torch.chains.psk import QpskDemod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q = QpskDemod(125_000, 500_000, lead_shape=(N_CH,), device=dev)
    result = {"device": torch.cuda.get_device_name(0)}
    if args.trig:
        bad = trig_all(chain, dev)
        result["trig_mismatches"] = dict(zip(
            ("sincosf_sin", "sincosf_cos", "sinf", "cosf"), bad))
        print(f"all 2^32 patterns against torch.sin / torch.cos: "
              f"{json.dumps(result['trig_mismatches'])}", flush=True)

    T_in = T_STEP // q.resamp.M
    x = loop_signal(dev, gen, N_CH, T_in)
    seed = x[:, 1000:1000 + 64].contiguous()  # past the ~1e-20 samples
    ph0 = torch.zeros(N_CH, device=dev)
    sink = torch.empty(N_CH, dtype=torch.int32, device=dev)
    ph_o, fr_o = torch.empty_like(ph0), torch.empty_like(ph0)
    floors = {}
    for name, loop, T in (("qpsk_pll", q.costas_pll, T_in),
                          ("qpsk_symbols", q.costas, QPSK_SYMS)):
        a = (loop.alpha, loop.beta, loop.max_freq, cc.PI, cc.TWO_PI)
        seed8 = seed[:, :RING].contiguous()
        fns = {}
        for v, tag in enumerate(COSTAS_VARIANTS):
            fns[tag] = (lambda v=v: check(chain.costas_chain_f32(
                seed8.data_ptr(), ph_o.data_ptr(), fr_o.data_ptr(),
                sink.data_ptr(), N_CH, T, v, *a, stream()), "costas_chain"))
        xs = x[:, :T].contiguous()
        fns["costas_loop_f32"] = lambda xs=xs, loop=loop: cc.costas_loop(
            xs, ph0, ph0, 4, loop.alpha, loop.beta, loop.max_freq)
        for k, fn in fns.items():
            ms, mhz = sampled(lambda fn=fn: cuda_ms(fn, iters=5, warmup=1))
            floors[f"costas/{name}/{k}"] = per_step(ms, T, mhz)
            print(f"costas {name} {N_CH} x {T} {k}: "
                  f"{json.dumps(floors[f'costas/{name}/{k}'])}", flush=True)
        del xs
    ss = q.symbol_sync
    sargs = (ss.sps - ss.omega_limit, ss.sps + ss.omega_limit, ss.alpha,
             ss.beta, css.recip(ss.ted_norm), float(ss.tail_len + T_in - 3),
             ss.sps)
    pos_o, om_o = torch.empty_like(ph0), torch.empty_like(ph0)
    fns = {}
    for src, tag in enumerate(SYNC_VARIANTS):
        fns[tag] = (lambda src=src: check(schain.sync_chain_f32(
            seed.data_ptr(), pos_o.data_ptr(), om_o.data_ptr(),
            sink.data_ptr(), N_CH, QPSK_SYMS, src, *sargs, stream()),
            "sync_chain"))
    s0 = ss.init_state()

    def sync_args(s):
        return (s[0], s[1], s[2], s[3], QPSK_SYMS, css.MODE_CONJ, None,
                ss.sps, ss.alpha, ss.beta, ss.omega_limit, ss.ted_norm)

    fns["symbol_sync_mm_f32"] = lambda: css.symbol_sync(s0[4], x,
                                                        *sync_args(s0))
    for k, fn in fns.items():
        ms, mhz = sampled(lambda fn=fn: cuda_ms(fn, iters=5, warmup=1))
        floors[f"sync/qpsk/{k}"] = per_step(ms, QPSK_SYMS, mhz)
        print(f"sync {N_CH} x {T_in} -> {QPSK_SYMS} {k}: "
              f"{json.dumps(floors[f'sync/qpsk/{k}'])}", flush=True)
    result["floors"] = floors

    if args.ablate:
        result["ablate"] = ablate(libs, x, ph0, q, s0, sync_args)
    if args.old:
        bind_old(libs["old costas"], libs["old symbol_sync"])
        turns = {}
        for name, loop, T in (("qpsk_pll", q.costas_pll, T_in),
                              ("qpsk_symbols", q.costas, QPSK_SYMS)):
            xs = x[:, :T].contiguous()
            a = (4, loop.alpha, loop.beta, loop.max_freq)
            new = cc.costas_loop(xs, ph0, ph0, *a)
            old = old_costas(libs["old costas"], xs, ph0, ph0, a)
            if not all(torch.equal(u, v) for u, v in zip(new, old)):
                raise RuntimeError(f"costas {name}: old and new differ")
            (ms, seq), mhz = sampled(lambda: turns_ms({
                "old": lambda: old_costas(libs["old costas"], xs, ph0, ph0,
                                          a),
                "new": lambda: cc.costas_loop(xs, ph0, ph0, *a)}))
            turns[f"costas/{name}"] = {"ms": ms, "turns": seq, "mhz": mhz}
            print(f"costas {name} in turns: "
                  f"{json.dumps(turns[f'costas/{name}'])}", flush=True)
            del xs
        new = css.symbol_sync(s0[4], x, *sync_args(s0))
        old = old_sync(libs["old symbol_sync"], s0[4], x, s0[:4], QPSK_SYMS,
                       ss)
        if not all(torch.equal(u, v) for u, v in zip(new, old)):
            raise RuntimeError("sync: old and new differ")
        (ms, seq), mhz = sampled(lambda: turns_ms({
            "old": lambda: old_sync(libs["old symbol_sync"], s0[4], x,
                                    s0[:4], QPSK_SYMS, ss),
            "new": lambda: css.symbol_sync(s0[4], x, *sync_args(s0))}))
        turns["sync/qpsk"] = {"ms": ms, "turns": seq, "mhz": mhz}
        print(f"sync in turns: {json.dumps(turns['sync/qpsk'])}", flush=True)
        result["turns"] = turns
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""The loop kernels' dependent chains timed alone, on one card.

    python scripts/loop_chain_floor.py [--loops costas,sync,agc,viterbi]
        [--old DIR] [--sass DIR] [--trig] [--ablate]

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
          chain without its fills and stores); and the levels mode on real
          input at 4 levels (M17's loop) and 2 (GMSK2K's), 2048 x 100,000,
          its chain from a real ring in two planes read as the kernel reads
          it: "hypotf", the kernel's update<1> (its hypotf levels code);
          "no_decision", the decision taken away; "fabsf", fabsf in place
          of hypotf; "tree", the kernel's real-levels update<3, NL>, which
          reads the real plane alone; and the kernel in turns with its
          hypotf levels code (symbol_sync_levels_v0), bit-equal

  agc     csrc/agc2.cu's step(), the gain recurrence, on a register ring
          of magnitudes ("chain")
  viterbi csrc/viterbi_stream_warp.cu's acs_step and its two ballots, a
          warp a row, the soft pairs from a register ring ("warp_acs":
          the one-warp design's add-compare-select alone, without its
          soft-pair shuffles, decision stores and traceback)

each timed at QPSK250K's shapes (the carrier PLL 2048 x 100,000 and the
symbol-rate loop 2048 x 25,000, order 4; the sync 2048 x 100,000 -> 25,000
symbols; the AGC 2048 x 100,000; the Viterbi 2048 rows x 25,064 steps,
25,000 pairs after a lag of 64), beside the kernels of csrc/ (through their
wrappers) on a QPSK signal at the same shapes (the Viterbi on noisy soft
pairs), while nvidia-smi samples the SM clock: ms, ns and cycles a step at
the sampled clock. --loops picks the loops (all four by default).

--old DIR   also builds DIR/costas.cu and DIR/symbol_sync.cu (an earlier
            design, whose symbol_sync_mm_f32 took no ld, S, R or reach),
            holds each to the kernel of csrc/ bit for bit at the shapes
            above, and times the two in turns (old, new, new, old).
--sass DIR  writes cuobjdump -sass of the kernels' and the variants'
            libraries to DIR.
--ablate    also builds each kernel with one part of its I/O taken away or
            changed (ABLATIONS below: the Costas input tiles not staged
            after the first two; no output stores; the sync's ring filled
            once; its fills through L1; agc2_gain_f32's tiles not loaded
            after the first, its gains not stored; viterbi_stream_warp_k7
            without its soft-pair loads after the first chunk, its
            decision-word stores or its traceback) and times each build in
            turns with the kernel at the shapes above: what each part still
            costs the chain's warp (the builds' outputs are not checked).
--trig      checks over all 2^32 float bit patterns that `sincosf`, and
            `sinf` and `cosf` apart, give torch.sin's and torch.cos's bits
            on this card (NaN against NaN counts as equal), printing the
            count of patterns that differ for each.

Prints the card's name and power limit first and one JSON line last.
Needs one CUDA card and nvcc; builds into build/loop_chain_floor/.
`agc_chain_ms` times the AGC's chain for chip_smoke.py's AGC rows.
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
from qradiolink_tpu_torch.ops import cuda_agc  # noqa: E402
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
            update<0, kMaxLevels>(w, c, lv, 0, omin, omax, alpha, beta,
                                  inv_norm, yr, yi, dr, di, pos, om, yp, dp);
            acc ^= __float_as_uint(yr) ^ (__float_as_uint(yi) << 1);
        }
    }
    if (row < rows) {
        pos_out[row] = pos;
        om_out[row] = om;
        sink[row] = acc;
    }
}

// The levels mode's step on real input with its decision DEC: 0 the
// kernel's MODE 1 decision (a hypotf a level, a chain of selects), 1 none
// (d = the first level), 2 fabsf in place of hypotf (the same chain of
// selects); the rest is update<1>'s; 3 the kernel's real-levels step,
// update<3, NL> (|yr - l| of NL levels reduced by a tree, yi +0)
template <int DEC, int NL>
__device__ __forceinline__ void levels_step(const float2 (&w)[4],
                                            const float (&c)[4],
                                            const float (&lv)[kMaxLevels],
                                            int n_lv, float omin, float omax,
                                            float alpha, float beta,
                                            float inv_norm, float& yr,
                                            float& yi, float& pos, float& om,
                                            float2& yp, float2& dp) {
    if (DEC == 0 || DEC == 3) {
        float dr, di;
        update<DEC == 0 ? 1 : 3, NL>(w, c, lv, n_lv, omin, omax, alpha, beta,
                                     inv_norm, yr, yi, dr, di, pos, om, yp,
                                     dp);
        return;
    }
    yr = __fmul_rn(w[0].x, c[0]);
    yi = __fmul_rn(w[0].y, c[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
        yr = __fadd_rn(yr, __fmul_rn(w[k].x, c[k]));
        yi = __fadd_rn(yi, __fmul_rn(w[k].y, c[k]));
    }
    float dr = lv[0];
    if (DEC == 2) {
        float best = fabsf(__fsub_rn(yr, lv[0]));
#pragma unroll
        for (int k = 1; k < kMaxLevels; ++k) {
            if (k < n_lv) {
                const float dist = fabsf(__fsub_rn(yr, lv[k]));
                if (dist < best) {
                    best = dist;
                    dr = lv[k];
                }
            }
        }
    }
    const float di = 0.0f;
    const float dyr = __fmul_rn(dr, yp.x), dyi = __fmul_rn(di, yp.y);
    float e = __fsub_rn(__fsub_rn(__fmul_rn(dp.x, yr), __fmul_rn(dp.y, yi)),
                        __fsub_rn(dyr, dyi));
    e = fminf(fmaxf(__fmul_rn(e, inv_norm), -1.0f), 1.0f);
    om = fminf(fmaxf(__fadd_rn(om, __fmul_rn(beta, e)), omin), omax);
    pos = __fadd_rn(__fadd_rn(pos, om), __fmul_rn(alpha, e));
    yp = make_float2(yr, yi);
    dp = make_float2(dr, di);
}

// The levels mode's chain on real samples: a shared ring of 64 samples a
// lane in two planes (the imaginary one zeros), read as the kernel reads
// its real ring (4 samples, two 4-byte loads each; DEC 3 one, the real
// plane's), the step DEC
template <int DEC, int NL>
__global__ void __launch_bounds__(32)
sync_levels_chain(const float* __restrict__ seed, const float* __restrict__ levels,
                  int n_lv, float* __restrict__ pos_out,
                  float* __restrict__ om_out, unsigned* __restrict__ sink,
                  int rows, int n_out, float omin, float omax, float alpha,
                  float beta, float inv_norm, float max_pos, float sps) {
    constexpr int kLen = 64, kStride = kLen + 4;  // symbol_sync.cu's stride
    __shared__ __align__(16) float s_re[32 * kStride];
    __shared__ __align__(16) float s_im[32 * kStride];
    const int lane = threadIdx.x;
    const int row = blockIdx.x * 32 + lane;
    for (int k = 0; k < kLen; ++k) {
        s_re[lane * kStride + k] = row < rows ? seed[row * kLen + k] : 0.0f;
        s_im[lane * kStride + k] = 0.0f;
    }
    __syncwarp();
    const float* re = s_re + lane * kStride;
    const float* im = s_im + lane * kStride;
    float lv[kMaxLevels];
#pragma unroll
    for (int k = 0; k < kMaxLevels; ++k)
        lv[k] = k < n_lv ? levels[k]
                         : (DEC == 3 ? __int_as_float(0x7fc00000) : 0.0f);
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
            for (int k = 0; k < 4; ++k) {
                const int s = (j0 + k) & (kLen - 1);
                w[k] = make_float2(re[s], DEC == 3 ? 0.0f : im[s]);
            }
            float yr, yi;
            levels_step<DEC, NL>(w, c, lv, n_lv, omin, omax, alpha, beta,
                                 inv_norm, yr, yi, pos, om, yp, dp);
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

int sync_levels_chain_f32(const void* seed, const void* levels, int n_lv,
                          void* pos_out, void* om_out, void* sink, int rows,
                          int n_out, int dec, float omin, float omax,
                          float alpha, float beta, float inv_norm,
                          float max_pos, float sps, void* stream) {
    if (rows < 1 || n_out % kRing || dec < 0 || dec > 3 || n_lv < 1 ||
        n_lv > 4)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((rows + 31) / 32);
    cudaStream_t st = (cudaStream_t)stream;
#define QRL_LEVELS(D, N)                                                     \
    sync_levels_chain<D, N><<<grid, 32, 0, st>>>(                            \
        (const float*)seed, (const float*)levels, n_lv, (float*)pos_out,     \
        (float*)om_out, (unsigned*)sink, rows, n_out, omin, omax, alpha,     \
        beta, inv_norm, max_pos, sps)
    if (dec == 0) QRL_LEVELS(0, 4);
    else if (dec == 1) QRL_LEVELS(1, 4);
    else if (dec == 2) QRL_LEVELS(2, 4);
    else if (n_lv <= 2) QRL_LEVELS(3, 2);
    else QRL_LEVELS(3, 4);
#undef QRL_LEVELS
    return (int)cudaGetLastError();
}

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

AGC_SRC = r"""
#include "agc2.cu"

namespace {

constexpr int kRing = 8;

// agc2.cu's step() on a ring of kRing magnitudes a row in registers; the
// gain before each update is folded into a checksum, as the kernels store
// it
__global__ void __launch_bounds__(32)
agc_chain(const float* __restrict__ seed, float* __restrict__ g_out,
          unsigned* __restrict__ sink, int C, int T, float ref,
          float attack, float decay, float lo, float hi) {
    const int row = blockIdx.x * 32 + threadIdx.x;
    if (row >= C) return;
    float ring[kRing];
#pragma unroll
    for (int k = 0; k < kRing; ++k) ring[k] = seed[row * kRing + k];
    float g = 1.0f;
    unsigned acc = 0u;
    for (int t = 0; t < T; t += kRing) {
#pragma unroll
        for (int k = 0; k < kRing; ++k) {
            acc ^= __float_as_uint(g) << (k & 7);
            g = step(g, ring[k], ref, attack, decay, lo, hi);
        }
    }
    g_out[row] = g;
    sink[row] = acc;
}

}  // namespace

extern "C" int agc_chain_f32(const void* seed, void* g_out, void* sink,
                             int C, int T, float ref, float attack,
                             float decay, float lo, float hi,
                             void* stream) {
    if (C < 1 || T < 0 || T % kRing) return (int)cudaErrorInvalidValue;
    agc_chain<<<(C + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        (const float*)seed, (float*)g_out, (unsigned*)sink, C, T, ref,
        attack, decay, lo, hi);
    return (int)cudaGetLastError();
}
"""

VITERBI_SRC = r"""
#include "viterbi_stream_warp.cu"

namespace {

constexpr int kRing = 8;

// viterbi_stream_warp.cu's acs_step and the step's two ballots, a warp a
// row as in that kernel (kWarps rows a block), the soft pair of each step
// from a ring of kRing pairs in registers (the same in every lane); the
// ballots folded into a checksum
__global__ void __launch_bounds__(kWarps * 32)
viterbi_chain(const float2* __restrict__ seed, float* __restrict__ pm_out,
              unsigned* __restrict__ sink, int B, int S, unsigned poly0,
              unsigned poly1) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= B) return;
    int pat[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const unsigned w = ((unsigned)(lane | (hi << 5)) << 1) | j;
            pat[j][hi] = 2 * parity(w & poly0) + parity(w & poly1);
        }
    float2 ring[kRing];
#pragma unroll
    for (int k = 0; k < kRing; ++k) ring[k] = seed[row * kRing + k];
    const int srcLo = lane >> 1, srcHi = 16 + (lane >> 1);
    const bool odd = lane & 1;
    float pmA = 0.0f, pmB = 0.0f;
    unsigned acc = 0u;
    for (int t = 0; t < S; t += kRing) {
#pragma unroll
        for (int k = 0; k < kRing; ++k) {
            bool dA, dB;
            acs_step(ring[k].x, ring[k].y, pat, srcLo, srcHi, odd, pmA, pmB,
                     dA, dB);
            acc ^= __ballot_sync(kFull, dA) ^ (__ballot_sync(kFull, dB) << 1);
        }
    }
    pm_out[(size_t)row * 64 + 2 * lane] = pmA;
    pm_out[(size_t)row * 64 + 2 * lane + 1] = pmB;
    sink[(size_t)row * 32 + lane] = acc;
}

}  // namespace

extern "C" int viterbi_chain_f32(const void* seed, void* pm_out, void* sink,
                                 int B, int S, int poly0, int poly1,
                                 void* stream) {
    if (B < 1 || S < 0 || S % kRing) return (int)cudaErrorInvalidValue;
    viterbi_chain<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
                    (cudaStream_t)stream>>>(
        (const float2*)seed, (float*)pm_out, (unsigned*)sink, B, S,
        (unsigned)poly0, (unsigned)poly1);
    return (int)cudaGetLastError();
}
"""
# the variants' sources, by loop: (library name, source, kernel sources of
# csrc/ that the loop times)
VARIANTS = {"costas": ("chain_costas", COSTAS_SRC, ("costas",)),
            "sync": ("chain_sync", SYNC_SRC, ("symbol_sync",)),
            "agc": ("chain_agc", AGC_SRC, ("agc2",)),
            "viterbi": ("chain_viterbi", VITERBI_SRC,
                        ("viterbi_stream_warp", "viterbi_stream_redux",
                         "viterbi_stream"))}


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


def bind_chain(name, lib):
    """The C entry points of one chain variant's library."""
    p, i, f, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong, ctypes.c_uint)
    entries = {
        "chain_costas": {"costas_chain_f32": [p, p, p, p, i, i, i, f, f, f,
                                              f, f, p],
                         "trig_bits_f32": [p, p, p, p, u, ll, i, p]},
        "chain_sync": {"sync_chain_f32": [p, p, p, p, i, i, i, f, f, f, f, f,
                                          f, f, p],
                       "sync_levels_chain_f32": [p, p, i, p, p, p, i, i, i, f,
                                                 f, f, f, f, f, f, p]},
        "chain_agc": {"agc_chain_f32": [p, p, p, i, i, f, f, f, f, f, p]},
        "chain_viterbi": {"viterbi_chain_f32": [p, p, p, i, i, i, i, p]}}
    for entry, types in entries[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = types
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
     "fill<XC, MODE != 3>(my_re, my_im, g_lo, g_hi, R, trow, xrow, L);",
     "if (m0 == 0) fill<XC, MODE != 3>(my_re, my_im, g_lo, g_hi, R, trow, "
     "xrow, L);"),
    ("symbol_sync", "no_stores",
     "y[(size_t)(row0 + r) * n_out + t0 + lane] = s_y[r][lane];", ";"),
    ("symbol_sync", "fills_ca",
     "cp.async.cg.shared.global [%0], [%1], 16;",
     "cp.async.ca.shared.global [%0], [%1], 16;"),
    ("agc2", "no_staging",
     "load_tile(v, m, row0, n_rows, T, t0 + kTile + lane);", ""),
    ("agc2", "no_stores",
     "gains[(size_t)(row0 + r) * T + t0 + lane] = s_g[r][lane];", ";"),
    ("viterbi_stream_warp", "no_loads",
     "nxt = load_pair(tail, soft, row, T, lag, t0 + kChunk + lane);", ""),
    # the word is still formed (a store that never happens keeps it live)
    ("viterbi_stream_warp", "no_stores",
     "if (lane < n) dec_row[t0 + lane] = word;",
     "if (lane < n && word == 0x5a5a5a5a5a5a5a5aull) "
     "dec_row[t0 + lane] = word;"),
    ("viterbi_stream_warp", "no_traceback",
     "while (t_hi > 0) {", "while (t_hi < 0) {"),
    # agc2_f32 with other counts of memory warps (16 rows each, 11 and a
    # padded row, 4 rows)
    ("agc2", "helpers2", "constexpr int kHelpers = 4;",
     "constexpr int kHelpers = 2;"),
    ("agc2", "helpers3", "constexpr int kHelpers = 4;",
     "constexpr int kHelpers = 3;"),
    ("agc2", "helpers8", "constexpr int kHelpers = 4;",
     "constexpr int kHelpers = 8;"),
    # and with tiles of 32 samples, a hand-over each 32 steps
    ("agc2", "tile32", "constexpr int kFTile = 64;",
     "constexpr int kFTile = 32;"),
    ("viterbi_stream", "no_traceback",
     "for (int ch = n_chunks - 1; ch >= 0; --ch) {",
     "for (int ch = n_chunks - 1; ch < 0; --ch) {"),
    ("viterbi_stream", "no_exchange",
     "const float recv = __shfl_xor_sync(kFull, send, 1 << SJ);",
     "const float recv = send;"),
    ("viterbi_stream", "no_row_min",
     "m = fminf(m, __shfl_xor_sync(kFull, m, o));", "m = fminf(m, m);"),
    ("viterbi_stream", "no_dec_stores", "c.dec[j * kG] = (uint8_t)d;",
     "if (d > 255u) c.dec[j * kG] = (uint8_t)d;"),
    ("viterbi_stream_redux", "no_traceback",
     "for (; t0 >= 0; t0 -= kChunk) {", "for (; t0 < 0; t0 -= kChunk) {"),
)
# the calls an ablation is timed on (all of its kernel's by default)
ABLATION_SHAPES = {"helpers2": ("qpsk_fused",), "helpers3": ("qpsk_fused",),
                   "helpers8": ("qpsk_fused",), "tile32": ("qpsk_fused",),
                   "no_staging": ("qpsk",), "no_stores": ("qpsk",)}
# the loop each ablated kernel belongs to
ABLATION_LOOP = {"costas": "costas", "symbol_sync": "sync", "agc2": "agc",
                 "viterbi_stream_warp": "viterbi",
                 "viterbi_stream_redux": "viterbi",
                 "viterbi_stream": "viterbi"}
COSTAS_VARIANTS = ("cosf_sinf", "sincosf", "kernel")
SYNC_VARIANTS = ("regs", "ring")
# the levels mode's chain variants (sync_levels_chain's DEC): the kernel's
# hypotf decision (MODE 1), none, fabsf in place of hypotf, the
# kernel's real-levels step (MODE 3)
LEVELS_VARIANTS = ("hypotf", "no_decision", "fabsf", "tree")
# the levels-mode loops timed: name: (registry mode, samples a row); 2048
# rows of real input, its levels held sps samples (levels_signal)
LEVELS_LOOPS = {"m17_4lv": ("M17", 100_000), "gmsk2k_2lv": ("GMSK2K",
                                                           100_000)}


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


def ablate(libs, calls):
    """Each ABLATIONS build whose kernel has calls timed in turns with the
    kernel (kernel, build, build, kernel); calls: kernel source -> [(shape,
    a call of the kernel's wrapper at that shape)]."""
    out = {}
    for name, tag, _, _ in ABLATIONS:
        if name not in calls:
            continue
        lib = libs[f"{name} {tag}"]
        for shape, fn in calls[name]:
            if name == "agc2" and shape not in ABLATION_SHAPES.get(tag, ()):
                continue
            (ms, seq), mhz = sampled(lambda: turns_ms({
                "kernel": fn, tag: with_lib(name, lib, fn)}))
            key = f"{name}/{shape}/{tag}"
            out[key] = {"ms": ms, "turns": seq, "mhz": mhz}
            print(f"ablate {key}: {json.dumps(out[key])}", flush=True)
    return out


def build(loops, args):
    """Start every nvcc at once: the chain variants of `loops`, the earlier
    design (--old), the ablated kernels (--ablate) and the kernels of csrc/
    the loops time; returns (the variants' and builds' libraries, the
    variants' library paths)."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for loop in loops:
        name, src, _ = VARIANTS[loop]
        (OUT / f"{name}.cu").write_text(src)
        so = OUT / f"lib{name}.so"
        jobs[name] = (nvcc(OUT / f"{name}.cu", so), so)
    if args.old:
        for name in ("costas", "symbol_sync"):
            so = OUT / "old" / f"lib{name}.so"
            jobs[f"old {name}"] = (nvcc(args.old / f"{name}.cu", so), so)
    if args.ablate:
        for name, tag, line, repl in ABLATIONS:
            if ABLATION_LOOP[name] not in loops:
                continue
            src = (kernels.CSRC / f"{name}.cu").read_text()
            if src.count(line) != 1:
                raise RuntimeError(f"csrc/{name}.cu has no single `{line}`")
            d = OUT / "ablate" / f"{name}_{tag}"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{name}.cu").write_text(src.replace(line, repl))
            so = d / f"lib{name}.so"
            jobs[f"{name} {tag}"] = (nvcc(d / f"{name}.cu", so), so)
    names = [k for loop in loops for k in VARIANTS[loop][2]]
    kjobs = [kernels._start(name) for name in names]
    logs = {job[0]: kernels._finish(*job) for job in kjobs}
    for name in names:
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    libs = {k: finish(k, *v) for k, v in jobs.items()}
    for loop in loops:
        bind_chain(VARIANTS[loop][0], libs[VARIANTS[loop][0]])
    return libs, {k: v[1] for k, v in jobs.items()}


def write_sass(loops, paths, out):
    out.mkdir(parents=True, exist_ok=True)
    cuobjdump = pathlib.Path(kernels._nvcc()).with_name("cuobjdump")
    libs = [(VARIANTS[loop][0], paths[VARIANTS[loop][0]]) for loop in loops]
    libs += [(k, kernels._lib_path(k)) for loop in loops
             for k in VARIANTS[loop][2]]
    for name, so in libs:
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                              capture_output=True, text=True,
                              check=True).stdout
        (out / f"{name}.sass").write_text(sass)
    print(f"SASS written to {out}", flush=True)


def timed_floor(floors, key, fn, steps):
    ms, mhz = sampled(lambda: cuda_ms(fn, iters=5, warmup=1))
    floors[key] = per_step(ms, steps, mhz)
    print(f"{key}: {json.dumps(floors[key])}", flush=True)


def agc_args(agc):
    """The chain variant's parameters of an Agc2."""
    return (agc.reference, agc.attack, agc.decay, cuda_agc.MIN_GAIN,
            agc.max_gain)


def agc_chain_ms(lib, m, agc, iters=5):
    """The AGC chain variant over m's rows (magnitudes (C, T), T a multiple
    of RING; the ring from samples 1,000-1,007, past the ~1e-20 ones), its
    median ms over iters calls."""
    C, T = m.shape
    seed = m[:, 1000:1000 + RING].contiguous()
    g_o = torch.empty(C, device=m.device)
    sink = torch.empty(C, dtype=torch.int32, device=m.device)
    return cuda_ms(lambda: check(lib.agc_chain_f32(
        seed.data_ptr(), g_o.data_ptr(), sink.data_ptr(), C, T,
        *agc_args(agc), stream()), "agc_chain"), iters=iters, warmup=1)


def agc_stage_before(x, g0, attack, decay, reference, max_gain):
    """The Agc2 stage on the card as it ran before agc2_f32: torch.abs,
    agc2_gain_f32, the products plane by plane, torch.complex."""
    gains, g_last = cuda_agc.agc2_gain(torch.abs(x).float(), g0, attack,
                                       decay, reference, max_gain)
    if torch.is_complex(x):
        return torch.complex(x.real * gains, x.imag * gains), g_last
    return x * gains, g_last


def build_agc_chain():
    """The AGC chain variant's library alone (for chip_smoke.py)."""
    name, src, _ = VARIANTS["agc"]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(src)
    so = OUT / f"lib{name}.so"
    lib = finish(name, nvcc(OUT / f"{name}.cu", so), so)
    bind_chain(name, lib)
    return lib


def levels_signal(dev, gen, C, T, levels, sps):
    """(C, T) f32: random levels held sps samples, smoothed by an sps-tap
    moving average, noise at 0.05."""
    idx = torch.randint(0, levels.numel(), (C, -(-T // sps) + 1),
                        generator=gen, device=dev)
    x = torch.repeat_interleave(levels[idx], sps, dim=-1)
    x = torch.nn.functional.avg_pool1d(x[:, None], sps, 1)[:, 0, :T]
    return (x + 0.05 * torch.randn(x.shape, generator=gen, device=dev)
            ).contiguous()


def levels_floors(floors, name, mode, T, schain, dev, gen, pos_o, om_o,
                  sink):
    """The levels mode of registry mode `mode`'s SymbolSync on N_CH rows of
    T real samples: each LEVELS_VARIANTS chain and the kernel through its
    wrapper, timed into floors; returns the kernel's call."""
    from qradiolink_tpu_torch.models import registry

    ss = registry.rx_chain(mode, lead_shape=(N_CH,), device=dev).symbol_sync
    n_sym = int(round(T / ss.sps))
    x = levels_signal(dev, gen, N_CH, T, ss.levels, int(ss.sps))
    seed = x[:, 1000:1064].contiguous()
    args = (ss.sps - ss.omega_limit, ss.sps + ss.omega_limit, ss.alpha,
            ss.beta, css.recip(ss.ted_norm), float(ss.tail_len + T - 3),
            ss.sps)
    n_chain = n_sym - n_sym % RING
    for dec, tag in enumerate(LEVELS_VARIANTS):
        timed_floor(floors, f"sync/{name}/{tag}", (
            lambda dec=dec: check(schain.sync_levels_chain_f32(
                seed.data_ptr(), ss.levels.data_ptr(), ss.levels.numel(),
                pos_o.data_ptr(), om_o.data_ptr(), sink.data_ptr(), N_CH,
                n_chain, dec, *args, stream()), "sync_levels_chain")),
            n_chain)
    pos, om, yp, dp, tail = ss.init_state()
    args = (tail, x, pos, om, yp, dp, n_sym)
    kw = (ss.levels, ss.sps, ss.alpha, ss.beta, ss.omega_limit, ss.ted_norm)
    fn = (lambda: css.symbol_sync(*args, css.MODE_LEVELS, *kw))
    v0 = (lambda: css.symbol_sync_levels_v0(*args, *kw))
    timed_floor(floors, f"sync/{name}/symbol_sync_mm_f32", fn, n_sym)
    timed_floor(floors, f"sync/{name}/{css.V0_OP}", v0, n_sym)
    if not all(torch.equal(a, b) for a, b in zip(fn(), v0())):
        raise RuntimeError(f"sync {name}: the real-levels path and the hypotf "
                           f"levels code differ")
    (ms, seq), mhz = sampled(lambda: turns_ms({css.V0_OP: v0, "kernel": fn}))
    floors[f"sync/{name}/turns"] = {"ms": ms, "turns": seq, "mhz": mhz}
    print(f"sync/{name} in turns (bit-equal): "
          f"{json.dumps(floors[f'sync/{name}/turns'])}", flush=True)
    return fn


def vit_soft(dev, gen, C, T):
    """Noisy soft pairs (C, T, 2) in [0, 255], as chip_smoke.py's Viterbi
    row makes them."""
    return torch.clamp(128.0 + 48.0 * torch.randn(
        (C, T, 2), generator=gen, device=dev) * 2.0, 0.0, 255.0)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("loop_chain_floor: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--loops", default="costas,sync,agc,viterbi")
    ap.add_argument("--old", type=pathlib.Path)
    ap.add_argument("--sass", type=pathlib.Path)
    ap.add_argument("--trig", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv[1:])
    loops = [k for k in args.loops.split(",") if k]
    if not loops or set(loops) - set(VARIANTS):
        ap.error(f"--loops takes some of {', '.join(VARIANTS)}")
    if (args.old or args.trig) and not {"costas", "sync"} <= set(loops):
        ap.error("--old and --trig need the costas and sync loops")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs, paths = build(loops, args)
    if args.sass:
        write_sass(loops, paths, args.sass)

    from qradiolink_tpu_torch.chains.psk import QpskDemod
    from qradiolink_tpu_torch.fec import viterbi_stream_cuda as vsc
    from qradiolink_tpu_torch.fec.conv import CCSDS_K7

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q = QpskDemod(125_000, 500_000, lead_shape=(N_CH,), device=dev)
    result = {"device": torch.cuda.get_device_name(0)}
    if args.trig:
        bad = trig_all(libs["chain_costas"], dev)
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
    floors, calls = {}, {}
    if "costas" in loops:
        chain = libs["chain_costas"]
        calls["costas"] = []
        for name, loop, T in (("qpsk_pll", q.costas_pll, T_in),
                              ("qpsk_symbols", q.costas, QPSK_SYMS)):
            a = (loop.alpha, loop.beta, loop.max_freq, cc.PI, cc.TWO_PI)
            seed8 = seed[:, :RING].contiguous()
            for v, tag in enumerate(COSTAS_VARIANTS):
                timed_floor(floors, f"costas/{name}/{tag}", (
                    lambda v=v, a=a, T=T, seed8=seed8: check(
                        chain.costas_chain_f32(
                            seed8.data_ptr(), ph_o.data_ptr(),
                            fr_o.data_ptr(), sink.data_ptr(), N_CH, T, v,
                            *a, stream()), "costas_chain")), T)
            xs = x[:, :T].contiguous()
            ka = (4, loop.alpha, loop.beta, loop.max_freq)
            fn = (lambda xs=xs, ka=ka: cc.costas_loop(xs, ph0, ph0, *ka))
            timed_floor(floors, f"costas/{name}/costas_loop_f32", fn, T)
            calls["costas"].append((name, fn))
    ss = q.symbol_sync
    s0 = ss.init_state()

    def sync_args(s):
        return (s[0], s[1], s[2], s[3], QPSK_SYMS, css.MODE_CONJ, None,
                ss.sps, ss.alpha, ss.beta, ss.omega_limit, ss.ted_norm)

    if "sync" in loops:
        schain = libs["chain_sync"]
        sargs = (ss.sps - ss.omega_limit, ss.sps + ss.omega_limit, ss.alpha,
                 ss.beta, css.recip(ss.ted_norm),
                 float(ss.tail_len + T_in - 3), ss.sps)
        pos_o, om_o = torch.empty_like(ph0), torch.empty_like(ph0)
        for src, tag in enumerate(SYNC_VARIANTS):
            timed_floor(floors, f"sync/qpsk/{tag}", (
                lambda src=src: check(schain.sync_chain_f32(
                    seed.data_ptr(), pos_o.data_ptr(), om_o.data_ptr(),
                    sink.data_ptr(), N_CH, QPSK_SYMS, src, *sargs,
                    stream()), "sync_chain")), QPSK_SYMS)
        fn = (lambda: css.symbol_sync(s0[4], x, *sync_args(s0)))
        timed_floor(floors, "sync/qpsk/symbol_sync_mm_f32", fn, QPSK_SYMS)
        calls["symbol_sync"] = [("qpsk", fn)]
        for name, (mode, T_lv) in LEVELS_LOOPS.items():
            calls["symbol_sync"].append(
                (name, levels_floors(floors, name, mode, T_lv, schain, dev,
                                     gen, pos_o, om_o, sink)))
    if "agc" in loops:
        m = torch.abs(x)
        g0 = torch.ones(N_CH, device=dev)
        a = q.agc
        kargs = (m, g0, a.attack, a.decay, a.reference, a.max_gain)
        ms, mhz = sampled(lambda: agc_chain_ms(libs["chain_agc"], m, a))
        floors["agc/qpsk/chain"] = per_step(ms, T_in, mhz)
        print(f"agc/qpsk/chain: {json.dumps(floors['agc/qpsk/chain'])}",
              flush=True)
        fn = (lambda: cuda_agc.agc2_gain(*kargs))
        timed_floor(floors, "agc/qpsk/agc2_gain_f32", fn, T_in)
        calls["agc2"] = [("qpsk", fn)]
        sargs = (x, g0, a.attack, a.decay, a.reference, a.max_gain)
        fused = (lambda: cuda_agc.agc2(*sargs))
        timed_floor(floors, f"agc/qpsk/{cuda_agc.OP_FUSED}", fused, T_in)
        calls["agc2"].append(("qpsk_fused", fused))
        timed_floor(floors, "agc/qpsk/stage_before",
                    lambda: agc_stage_before(*sargs), T_in)
    if "viterbi" in loops:
        lag = q.fec_tail.viterbi.lag
        S = QPSK_SYMS + lag
        soft = vit_soft(dev, gen, N_CH, QPSK_SYMS)
        pm0 = torch.zeros((N_CH, 64), device=dev)
        tail = torch.full((N_CH, lag, 2), 128.0, device=dev)
        vseed = soft[:, 1000:1000 + RING].contiguous()
        pm_o = torch.empty((N_CH, 64), device=dev)
        vsink = torch.empty((N_CH, 32), dtype=torch.int32, device=dev)
        vchain = libs["chain_viterbi"]
        timed_floor(floors, "viterbi/qpsk/warp_acs", (
            lambda: check(vchain.viterbi_chain_f32(
                vseed.data_ptr(), pm_o.data_ptr(), vsink.data_ptr(), N_CH,
                S - S % RING, *CCSDS_K7.polys, stream()), "viterbi_chain")),
            S - S % RING)
        fn = (lambda: vsc.viterbi_stream_warp(CCSDS_K7, pm0, tail, soft))
        timed_floor(floors, f"viterbi/qpsk/{vsc.OP_WARP}", fn, S)
        calls["viterbi_stream_warp"] = [("qpsk", fn)]
        fn = (lambda: vsc.viterbi_stream_redux(CCSDS_K7, pm0, tail, soft))
        timed_floor(floors, f"viterbi/qpsk/{vsc.OP_REDUX}", fn, S)
        calls["viterbi_stream_redux"] = [("qpsk", fn)]
        fn = (lambda: vsc.viterbi_stream(CCSDS_K7, pm0, tail, soft))
        timed_floor(floors, f"viterbi/qpsk/{vsc.OP}", fn, S)
        calls["viterbi_stream"] = [("qpsk", fn)]
    result["floors"] = floors

    if args.ablate:
        result["ablate"] = ablate(libs, calls)
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

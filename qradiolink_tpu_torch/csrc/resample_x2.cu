// resample_x2_f32: the streaming polyphase interpolator by 2 (L 2, M 1),
// both phases of one or two f32 planes in one launch, register-blocked over
// output times, outputs interleaved and the new tail state written by the
// same launch.
//
// Replaces, at L 2 M 1 (ops/cuda_resample.route), the Pallas TPU kernel of
// qradiolink_tpu/ops/pallas_fir.py `banded_fir` -> `_banded_call`
// (pallas_fir.py:111), which the JAX package's RationalResampler
// (qradiolink_tpu/ops/resample.py `_phases`) runs once per phase. The shape
// on the paths is QpskMod's x2 at 125,000 symbols/s: 46 taps a phase, 2
// planes, 2048 rows x 100,000 -> 200,000 samples. csrc/resample_poly.cu
// (resample_poly_f32) computes the same function at every shape, and served
// this one before.
//
// Function, over the virtual stream xc = [tail (K-1) | x (T)] of each row,
// with tf_r the flipped taps of phase r (row r of `taps`); at M 1 both
// phases start at q_r = 0:
//     y[2t + r] = sum_{j<K} tf_r[j] * xc[t + j],   t in [0, T), r in {0, 1}
//     state[plane][j] = xc[T + j], j in [0, K-1)
// The state is written as a (C, 2, K-1) block; with one plane (real input)
// its second plane is zeros. Each output sums j = 0 .. K-1 in order with
// fmaf from 0.0f, as resample_poly_f32 does, so the two kernels' outputs
// are equal bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores) at QpskMod's x2: 1.64 GB read and 3.28 GB written, 1.468 ms;
// 37.7 G FMAs, 1.125 ms. Bytes bind, and the FMA pipe nearly does.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, device time in
// turns): 2.787 ms, 52.7% of the bound, against resample_poly_f32's 20.69,
// resample_up_f32's 5.67 and one F.conv1d with 2 output channels 20.57;
// ptxas 80 registers, no spill.
//
// What held the other two kernels back at L 2, and what this one does:
//   1. resample_poly_f32 gives each 128-thread block 64 output times and a
//      lane one output (two shared loads an FMA): 6.4 M blocks at this
//      shape, each staging the taps and a span. 20.8 ms, slower than one
//      F.conv1d with 2 output channels (PERF.md).
//   2. resample_up_f32 puts lanes over phases; at L 2 a warp spans 16 time
//      blocks 16 floats apart, two banks: an 8-way conflict on every sample
//      load.
// Here a thread's job is kR = 16 consecutive output times of BOTH phases:
// at M 1 the two phases read the same window of samples, so a ring of kR
// registers feeds 2 kR accumulators. Step j loads one new sample and the
// two phases' taps at j (one float2 broadcast) and issues 2 kR FMAs: 2
// shared loads for 32 FMAs. The tap loop runs in groups of kR unrolled
// steps (every ring index a compile-time constant), the last K mod kR taps
// under a uniform `u < rem` test. Lanes run over jobs (consecutive output
// times), and the staged span keeps one pad word after every kR words, so
// lane l's window starts at word (kR + 1) l: 32 distinct banks.
// A block of kThreads = 256 owns a tile of tt output times of one (row,
// plane), about kRounds rounds of kRound = 4,096 times (a job a thread a
// round): tt = 20,000 at this shape, 40,000 outputs a block. It stages the
// taps once, then each round's span (the round's times + K - 1 samples,
// zeros past the stream's end), kStage loads in flight a thread, the
// tail/x seam resolved per element and the tail read in place from the
// state's strided view; the row's first tile copies the new state.
// Stores: a thread's 32 outputs are consecutive in y, so a warp's 1,024
// outputs of a round are one run. Each lane writes its outputs to the
// warp's buffer in shared memory (rows kOutLd = 33 floats apart: distinct
// banks), and the warp stores the run back as 32 coalesced 128-byte rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // threads a block
constexpr int kWarps = kThreads / 32;  // warps a block
constexpr int kR = 16;                 // consecutive output times a job
constexpr int kRound = kThreads * kR;  // output times a round
constexpr int kRounds = 6;             // rounds a full tile, at most
constexpr int kStage = 8;              // staging loads in flight a thread
constexpr int kOutLd = 2 * kR + 1;     // floats a lane's row of outputs
constexpr int kMinBlocks = 3;          // blocks an SM the registers allow

// padded shared-memory index of logical span word i
__host__ __device__ constexpr int padded(int i) { return i + i / kR; }

// span words a round of nj jobs stages
__host__ __device__ constexpr int span_words(int nj, int K) {
    return nj * kR + K - 1;
}

// floats of the padded span buffer
__host__ __device__ constexpr int span_buf(int K) {
    return padded(span_words(kThreads, K) - 1) + 1;
}

// shared memory one launch needs, in bytes: the two phases' taps as
// float2, the span, the warps' output buffers
constexpr long long smem_bytes(int K) {
    return ((long long)2 * K + span_buf(K) + kWarps * 32 * kOutLd) *
           (long long)sizeof(float);
}

// output times a tile: at most kRounds rounds, whole jobs, equal tiles
// across the row
int tile_times(int n_pp) {
    if (n_pp <= 0) return 0;
    const long long tt_max = (long long)kRounds * kRound;
    const long long tiles = (n_pp + tt_max - 1) / tt_max;
    const long long per = (n_pp + tiles - 1) / tiles;
    return (int)((per + kR - 1) / kR * kR);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
resample_x2_kernel(const float* __restrict__ tail0,
                   const float* __restrict__ tail1, int tail_ld,
                   const float* __restrict__ x0, const float* __restrict__ x1,
                   const float* __restrict__ taps, float* __restrict__ y0,
                   float* __restrict__ y1, float* __restrict__ state, int C,
                   int T, int K, int tt, int n_tiles, int planes) {
    extern __shared__ float4 smem4[];
    float2* s_tap = reinterpret_cast<float2*>(smem4);     // K of (tf0, tf1)
    float* s_x = reinterpret_cast<float*>(smem4) + 2 * K;  // the span
    float* s_out = s_x + span_buf(K);                      // kWarps buffers

    const int tile = (int)(blockIdx.x % (unsigned)n_tiles);
    const int rp = (int)(blockIdx.x / (unsigned)n_tiles);
    const int plane = rp / C;
    const int row = rp - plane * C;
    const int k1 = K - 1;
    const float* tail = (plane ? tail1 : tail0) + (size_t)row * tail_ld;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;
    const long long n_in = (long long)k1 + T;

    // the row's first tile copies xc[T .. T+K-2] into the new state
    if (tile == 0) {
        float* st = state + ((size_t)row * 2 + plane) * k1;
        for (int j = threadIdx.x; j < k1; j += kThreads) {
            const long long v = (long long)T + j;
            st[j] = v < k1 ? tail[v] : x[v - k1];
            if (planes == 1) st[k1 + j] = 0.0f;
        }
    }
    const int t0 = tile * tt;
    const int nt = max(0, min(tt, T - t0));
    if (nt == 0) return;  // T == 0: only the state; no barrier follows
    for (int j = threadIdx.x; j < K; j += kThreads)
        s_tap[j] = make_float2(taps[j], taps[K + j]);

    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    float* s_o = s_out + warp * 32 * kOutLd;
    float* y = (plane ? y1 : y0) + (size_t)row * 2 * T;
    for (int r0 = 0; r0 < nt; r0 += kRound) {
        const int n_here = min(kRound, nt - r0);
        const int nj = (n_here + kR - 1) / kR;
        const int span = span_words(nj, K);
        const long long base = (long long)t0 + r0;  // xc index of word 0
        if (r0 > 0) __syncthreads();  // every job has read the last span
        for (int w0 = threadIdx.x; w0 < span; w0 += kThreads * kStage) {
            float val[kStage];
#pragma unroll
            for (int k = 0; k < kStage; ++k) {
                const int w = w0 + k * kThreads;
                const long long v = base + w;
                val[k] = 0.0f;
                if (w < span && v < n_in)
                    val[k] = v < k1 ? tail[v] : x[v - k1];
            }
#pragma unroll
            for (int k = 0; k < kStage; ++k) {
                const int w = w0 + k * kThreads;
                if (w < span) s_x[padded(w)] = val[k];
            }
        }
        __syncthreads();

        const int g = threadIdx.x;  // the thread's job: times g kR + u
        if (g < nj) {
            // logical word g kR + c sits at p[c + c / kR] for c < 2 kR;
            // after b groups of kR taps, word g kR + b kR + c at
            // q[c + c / kR] with q = p + b (kR + 1)
            const float* q = s_x + g * (kR + 1);
            float a0[kR], a1[kR], w[kR];
#pragma unroll
            for (int u = 0; u < kR; ++u) {
                a0[u] = 0.0f;
                a1[u] = 0.0f;
            }
#pragma unroll
            for (int s = 0; s < kR - 1; ++s) w[s] = q[s];
            const int n_grp = K / kR;
            const float2* h = s_tap;
            for (int b = 0; b < n_grp; ++b, q += kR + 1, h += kR) {
#pragma unroll
                for (int u = 0; u < kR; ++u) {
                    constexpr int kLast = kR - 1;
                    const int c = u + kLast;  // the sample that enters
                    w[(u + kLast) % kR] = q[c + c / kR];
                    const float2 tap = h[u];
#pragma unroll
                    for (int v = 0; v < kR; ++v) {
                        a0[v] = fmaf(tap.x, w[(u + v) % kR], a0[v]);
                        a1[v] = fmaf(tap.y, w[(u + v) % kR], a1[v]);
                    }
                }
            }
            // the last K mod kR taps: the same body, ring indices constant
            const int rem = K - n_grp * kR;
#pragma unroll
            for (int u = 0; u < kR - 1; ++u) {
                if (u < rem) {
                    constexpr int kLast = kR - 1;
                    const int c = u + kLast;
                    w[(u + kLast) % kR] = q[c + c / kR];
                    const float2 tap = h[u];
#pragma unroll
                    for (int v = 0; v < kR; ++v) {
                        a0[v] = fmaf(tap.x, w[(u + v) % kR], a0[v]);
                        a1[v] = fmaf(tap.y, w[(u + v) % kR], a1[v]);
                    }
                }
            }
            // outputs 2 (g kR + u) + r of the round: the lane's row of the
            // warp's buffer, 2 u + r
#pragma unroll
            for (int u = 0; u < kR; ++u) {
                s_o[lane * kOutLd + 2 * u] = a0[u];
                s_o[lane * kOutLd + 2 * u + 1] = a1[u];
            }
        }
        if (warp * 32 < nj) {
            __syncwarp();
            // the warp's 1,024 outputs, from round output warp * 1,024:
            // output e at row e / 32, column e % 32 of the buffer
            float* yo = y + 2 * (t0 + r0) + warp * 32 * 2 * kR;
            const int n_out = 2 * (n_here - warp * 32 * kR);
#pragma unroll 8
            for (int k = 0; k < 32; ++k) {
                const int e = k * 32 + lane;
                if (e < n_out) yo[e] = s_o[k * kOutLd + lane];
            }
            __syncwarp();
        }
    }
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes.
long long resample_x2_smem_bytes(int L, int M, int K) {
    if (L != 2 || M != 1 || K < 1) return -1;
    return smem_bytes(K);
}

// Same arguments as resample_poly_f32 (csrc/resample_poly.cu), at L 2 and
// M 1 only: tail0/tail1: (C, tail_ld)-strided rows of K-1 floats; x0/x1:
// contiguous (C, T); taps: contiguous (2, K), phase r's flipped taps in row
// r; y0/y1: contiguous (C, 2T); state: contiguous (C, 2, K-1), written
// whole. planes 1 or 2 (the *1 pointers are read only for 2). Returns a
// CUDA error code, 0 after a clean launch.
int resample_x2_f32(const void* tail0, const void* tail1, int tail_ld,
                    const void* x0, const void* x1, const void* taps,
                    void* y0, void* y1, void* state, int C, int T, int K,
                    int L, int M, int planes, void* stream) {
    if (C < 1 || T < 0 || K < 1 || L != 2 || M != 1 || planes < 1 ||
        planes > 2)
        return (int)cudaErrorInvalidValue;
    const long long smem = smem_bytes(K);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            resample_x2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int tt = tile_times(T);
    const int n_tiles = T > 0 ? (T + tt - 1) / tt : 1;
    const long long blocks = (long long)n_tiles * C * planes;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    resample_x2_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                         (cudaStream_t)stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, (const float*)x0,
        (const float*)x1, (const float*)taps, (float*)y0, (float*)y1,
        (float*)state, C, T, K, tt, n_tiles, planes);
    return (int)cudaGetLastError();
}

const char* resample_x2_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// resample_poly_f32: the streaming polyphase rational resampler at L > 1,
// every phase of one or two f32 planes in one launch, outputs interleaved
// and the new tail state written by the same launch.
//
// Replaces the Pallas TPU kernel of qradiolink_tpu/ops/pallas_fir.py
// `banded_fir` -> `_banded_call` (pallas_fir.py:111), which the JAX
// package's RationalResampler (qradiolink_tpu/ops/resample.py `_phases`)
// runs once per phase on real input. Before this kernel the port ran each
// phase as its own fir_stream_f32 launch (csrc/fir.cu) over a contiguous
// copy of [tail | x], then interleaved the phases and built the state in
// PyTorch: eight device operations a call at the NBFM audio resampler.
//
// Function, over the virtual stream xc = [tail (K-1) | x (T)] of each row,
// T = n_pp * M, with tf_r the flipped taps of phase r (row r of `taps`, the
// phase taps h[(r*M mod L)::L] reversed) and q_r = floor(r*M/L):
//     y[t*L + r] = sum_{j<K} tf_r[j] * xc[t*M + q_r + j],
//         t in [0, n_pp), r in [0, L)
//     state[plane][j] = xc[T + j], j in [0, K-1)
// The state is written as a (C, 2, K-1) block; with one plane (real input)
// its second plane is zeros, as the JAX package keeps it.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores) at the NBFM audio resampler of the mixed path (L 2, M 5, K 113,
// one plane, 32 rows x 2,000 samples -> 800): 0.40 MB, 0.12 us; 5.8 MFLOP,
// 0.09 us. Nothing of the card's rates binds at this size: the launch and
// one block's chain of K dependent FMAs do. So the design spends one launch
// on the whole call and keeps each block's serial part short.
//
// Design: block (tile, row, plane) of 128 threads owns kTB(L) consecutive
// output times t of one row (64 at L 2: 128 outputs, one a thread), every
// phase of them. The grid at the mixed path's shape is 7 x 32 blocks, one
// wave. The block stages
//   * the taps of all L phases, rows kTapStride(K) floats apart (odd, so
//     the phases a warp may mix start in distinct banks), and
//   * its span of xc once for all L phases, the tail/x seam resolved per
//     element: the tail is read in place from the state's strided views,
//     and [tail | x] is never built.
// The row's first block also copies the last K-1 samples of xc into the
// new state. Taps, span and state are one run of words, loaded with
// coalesced 4-byte loads, kStage in flight a thread before any is stored:
// one round of load latency a block (the first design took one round for
// the state, two for the taps and one for the span). One barrier, then
// each warp takes jobs (phase r, 32 consecutive t): lane i computes
// y[(t0 + i)*L + r] as K FMAs from 0.0f, j = 0 .. K-1 in order, its
// samples 32 * M floats apart across the warp (no bank conflict for odd M)
// and its tap a broadcast. That sum order is fir_stream_f32's,
// so the outputs and the state equal the two-launch route's bit for bit;
// splitting the K-tap chain into partial sums would break that.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kWarp = 32;      // output times a job: the lanes of a warp
constexpr int kStage = 8;      // staging loads in flight a thread

// output times a block: 4 warps over L phases, at least one job each up to
// L = 4 (128 at L 1, 64 at L 2, 32 from L 3)
__host__ __device__ constexpr int kTB(int L) {
    return kWarp * (L >= 4 ? 1 : 4 / L);
}

// floats between two phases' taps in shared memory: odd
__host__ __device__ constexpr int kTapStride(int K) { return K | 1; }

// largest phase offset q_r = floor(r*M/L), r < L
__host__ __device__ constexpr int q_max(int L, int M) {
    return (L - 1) * M / L;
}

// span of xc a full block stages
__host__ __device__ constexpr long long span_max(int L, int M, int K) {
    return (long long)(kTB(L) - 1) * M + q_max(L, M) + K;
}

// a minimum of 1 block an SM: without it ptxas spilled at 64 registers
__global__ void __launch_bounds__(kThreads, 1)
resample_poly_kernel(const float* __restrict__ tail0,
                     const float* __restrict__ tail1, int tail_ld,
                     const float* __restrict__ x0,
                     const float* __restrict__ x1,
                     const float* __restrict__ taps,
                     float* __restrict__ y0, float* __restrict__ y1,
                     float* __restrict__ state, int T, int K, int L, int M,
                     int n_pp, int planes) {
    extern __shared__ float smem[];
    const int ks = kTapStride(K);
    float* s_tap = smem;          // L rows of ks
    float* s_x = smem + L * ks;   // the span

    const int row = blockIdx.y;
    const int plane = blockIdx.z;
    const int k1 = K - 1;
    const float* tail = (plane ? tail1 : tail0) + (size_t)row * tail_ld;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;

    const int tb = kTB(L);
    const int t0 = blockIdx.x * tb;
    const int nt = max(0, min(tb, n_pp - t0));
    // staging, as one run of words: the taps of all L phases, the span of
    // xc, and (the row's first block) xc[T .. T+K-2], the new state; each
    // thread issues kStage loads before it stores any, so a block waits
    // for one round of loads
    const int n_tap = nt ? L * K : 0;
    const int span = nt ? (nt - 1) * M + q_max(L, M) + K : 0;
    const int n_words = n_tap + span + (blockIdx.x == 0 ? k1 : 0);
    const long long base = (long long)t0 * M;
    float* st = state + ((size_t)row * 2 + plane) * k1;
    for (int w0 = threadIdx.x; w0 < n_words; w0 += kThreads * kStage) {
        float val[kStage];
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
            const int w = w0 + k * kThreads;
            val[k] = 0.0f;
            if (w < n_tap) {
                val[k] = taps[w];
            } else if (w < n_words) {
                const long long v = w < n_tap + span
                                        ? base + (w - n_tap)
                                        : (long long)T + (w - n_tap - span);
                val[k] = v < k1 ? tail[v] : x[v - k1];
            }
        }
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
            const int w = w0 + k * kThreads;
            if (w < n_tap) {
                const int r = w / K;
                s_tap[r * ks + (w - r * K)] = val[k];
            } else if (w < n_tap + span) {
                s_x[w - n_tap] = val[k];
            } else if (w < n_words) {
                const int j = w - n_tap - span;
                st[j] = val[k];
                if (planes == 1) st[k1 + j] = 0.0f;
            }
        }
    }
    if (nt == 0) return;  // n_pp == 0: only the state; no barrier follows
    __syncthreads();

    const int lane = threadIdx.x % kWarp;
    float* y = (plane ? y1 : y0) + (size_t)row * n_pp * L;
    const int jobs = L * (tb / kWarp);
    for (int w = threadIdx.x / kWarp; w < jobs; w += kThreads / kWarp) {
        const int r = w % L;
        const int i = (w / L) * kWarp + lane;
        if (i >= nt) continue;
        const float* p = s_x + i * M + r * M / L;
        const float* h = s_tap + r * ks;
        float acc = 0.0f;
#pragma unroll 8
        for (int j = 0; j < K; ++j) acc = fmaf(h[j], p[j], acc);
        y[(size_t)(t0 + i) * L + r] = acc;
    }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes.
long long resample_poly_smem_bytes(int L, int M, int K) {
    return ((long long)L * kTapStride(K) + span_max(L, M, K)) *
           (long long)sizeof(float);
}

// tail0/tail1: (C, tail_ld)-strided rows of K-1 floats; x0/x1: contiguous
// (C, T) with T % M == 0; taps: contiguous (L, K), phase r's flipped taps
// in row r; y0/y1: contiguous (C, T/M*L); state: contiguous (C, 2, K-1),
// written whole. planes 1 or 2 (the *1 pointers are read only for 2).
// Returns a CUDA error code, 0 after a clean launch.
int resample_poly_f32(const void* tail0, const void* tail1, int tail_ld,
                      const void* x0, const void* x1, const void* taps,
                      void* y0, void* y1, void* state, int C, int T, int K,
                      int L, int M, int planes, void* stream) {
    if (C < 1 || T < 0 || K < 1 || L < 1 || M < 1 || T % M ||
        planes < 1 || planes > 2)
        return (int)cudaErrorInvalidValue;
    const long long smem = resample_poly_smem_bytes(L, M, K);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            resample_poly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int n_pp = T / M;
    const int tb = kTB(L);
    dim3 grid(n_pp > 0 ? (n_pp + tb - 1) / tb : 1, C, planes);
    resample_poly_kernel<<<grid, kThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, (const float*)x0,
        (const float*)x1, (const float*)taps, (float*)y0, (float*)y1,
        (float*)state, T, K, L, M, n_pp, planes);
    return (int)cudaGetLastError();
}

// An empty kernel on `stream`: the launch floor that a timing harness
// holds a short kernel against.
int resample_poly_empty(void* stream) {
    empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

const char* resample_poly_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// resample_up_f32: the streaming polyphase rational resampler at L >= 3
// phases and decimation M <= 5 (ops/cuda_resample.route), every
// phase of one or two f32 planes in one launch, register-blocked over
// output times, outputs interleaved and the new tail state written by the
// same launch.
//
// Replaces, at those shapes, the Pallas TPU kernel of
// qradiolink_tpu/ops/pallas_fir.py `banded_fir` -> `_banded_call`
// (pallas_fir.py:111), which the JAX package's RationalResampler
// (qradiolink_tpu/ops/resample.py `_phases`) runs once per phase. The
// shapes are the TX interpolators, 45 taps a phase, 2048 rows: SsbMod's and
// AmMod's L 125 M 1 (1,600 -> 200,000 a row), NbfmMod's L 25 M 4 (real,
// 1,600 -> 10,000) and L 20 M 1 (10,000 -> 200,000). csrc/resample_poly.cu
// (resample_poly_f32) computes the same function at every shape and keeps
// the others (the NBFM audio resampler L 2 M 5, M17's L 3 M 125).
//
// Function, over the virtual stream xc = [tail (K-1) | x (T)] of each row,
// T = n_pp * M, with tf_r the flipped taps of phase r (row r of `taps`) and
// q_r = floor(r*M/L):
//     y[t*L + r] = sum_{j<K} tf_r[j] * xc[t*M + q_r + j],
//         t in [0, n_pp), r in [0, L)
//     state[plane][j] = xc[T + j], j in [0, K-1)
// The state is written as a (C, 2, K-1) block; with one plane (real input)
// its second plane is zeros. Each output sums j = 0 .. K-1 in order with
// fmaf from 0.0f, as resample_poly_f32 does, so the two kernels' outputs
// are equal bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores) at L 125 M 1 and L 20 M 1, 2 planes, 2048 rows x 200,000 outputs:
// 36.9 G FMAs, 1.100 ms; 3.3 GB written, 0.98 ms. Both rates nearly bind:
// the FMA pipe must stay busy while the stores stream out.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, device time in
// turns with resample_poly_f32): L 125 M 1 2.020 ms against 13.856 (54.5%
// of the bound; one F.conv1d with L output channels 4.382), L 20 M 1 1.986
// against 11.880 (55.4%; 9.733), L 25 M 4 0.1006 against 0.5860 (28.5% of
// its bound of bytes; 0.2045).
//
// What held resample_poly_f32 back at these shapes, and what this kernel
// does about each:
//   1. Two shared loads an FMA (a tap and a sample, one output a lane).
//      Here a thread computes kR(M) consecutive output times of one phase
//      (a job): 16 at M <= 2, 8 above. The samples that the job's outputs
//      read at tap j, xc[(t + u) M + q_r + j] for u < kR, lie in a window
//      of N = (kR - 1) M + 1 samples, kept in a ring of N registers. Step
//      j loads one new sample into the slot the oldest one left and issues
//      kR FMAs, acc[u] += tf_r[j] * w[(j + u M) mod N]. The tap loop runs
//      in groups of N unrolled steps, so every ring index is a compile-time
//      constant (M is a template parameter, 1 .. 5); the last K mod N taps
//      take the same body under a uniform `s < rem` test. A step issues two
//      shared loads for kR FMAs: 2/kR loads an FMA.
//   2. Taps staged for 4,000 outputs a block (22.5 KB at L 125). A block
//      here owns a tile of tt output times of one (row, plane), every phase
//      of them: about kRounds jobs a thread, at most kMaxSpan samples of
//      span; a row's tiles are of equal width. tt = 544 at L 125 M 1
//      (68,000 outputs a block), 3,344 at L 20 M 1 (66,880), 400 at L 25
//      M 4 (10,000). Lanes run over phases (job g: phase r = g mod L, time
//      block g / L, stepped by kThreads without a division), so a warp's
//      tap loads are 32 distinct rows kTapStride(K) = K | 1 floats apart,
//      an odd stride and no bank conflict, and its sample loads at most
//      two words (two time blocks), a broadcast each.
//   3. Stores with stride L across a warp. With lanes over phases, a
//      warp's store of output u covers y[t L + r] for its 32 consecutive
//      (time block, phase) jobs: one or two contiguous runs of floats,
//      whole sectors between the warps of a block. No store has a stride
//      across lanes; a job that ends inside the tile stores without tests.
//   4. __launch_bounds__(128, 1), set for the L 2 shape. Here blocks are of
//      kThreads = 256 and the minimum is kMinBlocks = 3 an SM, at most 85
//      registers: ptxas gives 56-80, no spill, so the ring and the
//      accumulators stay in registers and each SM keeps 24 warps.
// Staging is resample_poly_f32's: the taps of all L phases, the tile's span
// of xc and (the row's first tile) the new state as one run of words, each
// thread issuing kStage loads before it stores any, the tail/x seam
// resolved per element and the tails read in place from the state's
// strided views. The span covers whole jobs, zeros past the stream's end,
// so a ragged last job reads staged words; its outputs past n_pp are not
// stored.
//
// Tuning: scripts/resample_up_variants.py builds this file with other
// values of its constants and times the builds in turns at the TX shapes
// (NVIDIA H100 80GB HBM3 at 700 W). At L 125 M 1, against 2.02 ms as
// written: kR1 8 or 32 (2 blocks an SM) 16-18% slower; 128-thread blocks,
// 6 an SM, 6.5%; kRounds 12, 16, 32 or 48 2-8% (at L 20 M 1, 128-thread
// blocks and kRounds 32-48 were up to 2.4% faster). Tried and dropped, in
// exploratory builds timed in turns: an instance for K = 45 with every
// step unrolled (faster at L 20, slower at L 125), streaming stores, 16
// staging loads in flight. The SM clock stays at its 1,980 MHz maximum and
// the card draws 220-520 W, so the pipes idle part of the time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kStage = 8;       // staging loads in flight a thread
constexpr int kRounds = 24;     // jobs a thread in a full tile, about
constexpr int kMaxSpan = 8192;  // samples of xc a tile stages, at most
constexpr int kMaxM = 5;        // decimations with a ring instance
constexpr int kMinBlocks = 3;   // blocks an SM the registers must allow
constexpr int kR1 = 16;         // consecutive output times a job, M <= 2
constexpr int kR3 = 8;          // and M >= 3

// consecutive output times a job
__host__ __device__ constexpr int kR(int M) { return M <= 2 ? kR1 : kR3; }

// the ring: samples a job's outputs read at one tap
__host__ __device__ constexpr int kRing(int M) { return (kR(M) - 1) * M + 1; }

// floats between two phases' taps in shared memory: odd
__host__ __device__ constexpr int kTapStride(int K) { return K | 1; }

// largest phase offset q_r = floor(r*M/L), r < L
__host__ __device__ constexpr int q_max(int L, int M) {
    return (L - 1) * M / L;
}

// span of xc a tile of nt output times stages: whole jobs
__host__ __device__ constexpr long long span_words(int nt, int L, int M,
                                                   int K) {
    return nt > 0 ? (long long)(((nt + kR(M) - 1) / kR(M)) * kR(M) - 1) * M +
                        q_max(L, M) + K
                  : 0;
}

// output times a tile: about kRounds jobs a thread, at most kMaxSpan
// samples of span, whole jobs, and equal tiles across the row
int tile_times(int L, int M, int n_pp) {
    if (n_pp <= 0) return 0;
    const int r = kR(M);
    long long tb = (long long)kRounds * kThreads / L;  // jobs' time blocks
    if (tb * r * M > kMaxSpan) tb = kMaxSpan / (r * M);
    if (tb < 1) tb = 1;
    const long long tt_max = tb * r;
    const long long tiles = (n_pp + tt_max - 1) / tt_max;
    const long long per = (n_pp + tiles - 1) / tiles;
    return (int)((per + r - 1) / r * r);
}

template <int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
resample_up_kernel(const float* __restrict__ tail0,
                   const float* __restrict__ tail1, int tail_ld,
                   const float* __restrict__ x0, const float* __restrict__ x1,
                   const float* __restrict__ taps, float* __restrict__ y0,
                   float* __restrict__ y1, float* __restrict__ state, int C,
                   int T, int K, int L, int n_pp, int tt, int n_tiles,
                   int planes) {
    constexpr int R = kR(M);
    constexpr int N = kRing(M);
    extern __shared__ float smem[];
    const int ks = kTapStride(K);
    float* s_tap = smem;         // L rows of ks
    float* s_x = smem + L * ks;  // the span

    const int tile = (int)(blockIdx.x % (unsigned)n_tiles);
    const int rp = (int)(blockIdx.x / (unsigned)n_tiles);
    const int plane = rp / C;
    const int row = rp - plane * C;
    const int k1 = K - 1;
    const float* tail = (plane ? tail1 : tail0) + (size_t)row * tail_ld;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;

    const int t0 = tile * tt;
    const int nt = max(0, min(tt, n_pp - t0));
    // staging, as one run of words: the taps of all L phases, the span of
    // xc (zeros past its end), and (the row's first tile) xc[T .. T+K-2],
    // the new state; each thread issues kStage loads before it stores any
    const int n_tap = nt ? L * K : 0;
    const int span = (int)span_words(nt, L, M, K);
    const int n_words = n_tap + span + (tile == 0 ? k1 : 0);
    const long long base = (long long)t0 * M;
    const long long n_in = (long long)k1 + T;
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
                if (v < n_in) val[k] = v < k1 ? tail[v] : x[v - k1];
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

    float* y = (plane ? y1 : y0) + (size_t)row * n_pp * L;
    const int n_tb = (nt + R - 1) / R;
    // job g = threadIdx.x + k kThreads is (time block tb, phase r) with
    // g = tb L + r, stepped without a division a job
    const int dtb = kThreads / L;
    const int dr = kThreads - dtb * L;
    for (int tb = threadIdx.x / L, r = threadIdx.x % L; tb < n_tb;) {
        const int i0 = tb * R;  // the job's first output time, from t0
        // sample c of the job's window, xc[(t0 + i0) M + q_r + c], at p[c]
        const float* p = s_x + i0 * M + (M == 1 ? 0 : r * M / L);
        const float* h = s_tap + r * ks;
        float acc[R], w[N];
#pragma unroll
        for (int u = 0; u < R; ++u) acc[u] = 0.0f;
#pragma unroll
        for (int s = 0; s < N - 1; ++s) w[s] = p[s];
        // step j (a compile-time constant wherever it is called): sample
        // j + N - 1 enters slot (j + N - 1) mod N, and output u adds tap j
        // times sample j + u M, from slot (j + u M) mod N
        const auto step = [&](const int j) {
            w[(j + N - 1) % N] = p[j + N - 1];
            const float tap = h[j];
#pragma unroll
            for (int u = 0; u < R; ++u)
                acc[u] = fmaf(tap, w[(j + u * M) % N], acc[u]);
        };
        // groups of N steps, p and h advanced by N a group (the slots of
        // step b N + s are those of step s), then the last K mod N taps
        // under a uniform test
        const int n_grp = K / N;
        const int rem = K - n_grp * N;
        for (int b = 0; b < n_grp; ++b, p += N, h += N) {
#pragma unroll
            for (int s = 0; s < N; ++s) step(s);
        }
#pragma unroll
        for (int s = 0; s < N - 1; ++s)
            if (s < rem) step(s);
        float* yo = y + (size_t)(t0 + i0) * L + r;
        if (i0 + R <= nt) {
#pragma unroll
            for (int u = 0; u < R; ++u) yo[(size_t)u * L] = acc[u];
        } else {  // the tile's ragged last job
#pragma unroll
            for (int u = 0; u < R; ++u)
                if (i0 + u < nt) yo[(size_t)u * L] = acc[u];
        }
        tb += dtb;
        r += dr;
        if (r >= L) {
            r -= L;
            ++tb;
        }
    }
}

template <int M>
int launch(const void* tail0, const void* tail1, int tail_ld, const void* x0,
           const void* x1, const void* taps, void* y0, void* y1, void* state,
           int C, int T, int K, int L, int planes, cudaStream_t stream) {
    const int n_pp = T / M;
    const int tt = tile_times(L, M, n_pp);
    const int n_tiles = n_pp > 0 ? (n_pp + tt - 1) / tt : 1;
    const long long smem =
        ((long long)L * kTapStride(K) + span_words(tt, L, M, K)) *
        (long long)sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            resample_up_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long blocks = (long long)n_tiles * C * planes;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    resample_up_kernel<M><<<(unsigned)blocks, kThreads, (size_t)smem,
                            stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, (const float*)x0,
        (const float*)x1, (const float*)taps, (float*)y0, (float*)y1,
        (float*)state, C, T, K, L, n_pp, tt, n_tiles, planes);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes (the tile width depends on T).
long long resample_up_smem_bytes(int L, int M, int K, int T) {
    if (L < 1 || M < 1 || M > kMaxM || K < 1) return -1;
    return ((long long)L * kTapStride(K) +
            span_words(tile_times(L, M, T / M), L, M, K)) *
           (long long)sizeof(float);
}

// Same arguments as resample_poly_f32 (csrc/resample_poly.cu):
// tail0/tail1: (C, tail_ld)-strided rows of K-1 floats; x0/x1: contiguous
// (C, T) with T % M == 0; taps: contiguous (L, K), phase r's flipped taps
// in row r; y0/y1: contiguous (C, T/M*L); state: contiguous (C, 2, K-1),
// written whole. planes 1 or 2 (the *1 pointers are read only for 2); M 1
// to 5. Returns a CUDA error code, 0 after a clean launch.
int resample_up_f32(const void* tail0, const void* tail1, int tail_ld,
                    const void* x0, const void* x1, const void* taps,
                    void* y0, void* y1, void* state, int C, int T, int K,
                    int L, int M, int planes, void* stream) {
    if (C < 1 || T < 0 || K < 1 || L < 1 || M < 1 || M > kMaxM || T % M ||
        planes < 1 || planes > 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (M) {
        case 1: return launch<1>(tail0, tail1, tail_ld, x0, x1, taps, y0, y1,
                                 state, C, T, K, L, planes, s);
        case 2: return launch<2>(tail0, tail1, tail_ld, x0, x1, taps, y0, y1,
                                 state, C, T, K, L, planes, s);
        case 3: return launch<3>(tail0, tail1, tail_ld, x0, x1, taps, y0, y1,
                                 state, C, T, K, L, planes, s);
        case 4: return launch<4>(tail0, tail1, tail_ld, x0, x1, taps, y0, y1,
                                 state, C, T, K, L, planes, s);
        default: return launch<5>(tail0, tail1, tail_ld, x0, x1, taps, y0,
                                  y1, state, C, T, K, L, planes, s);
    }
}

const char* resample_up_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

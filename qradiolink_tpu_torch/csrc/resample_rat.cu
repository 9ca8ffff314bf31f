// resample_rat_f32: the streaming polyphase rational resampler at its wide
// rational shapes, L >= 24 phases and decimation M > 5 (ops/cuda_resample
// .route: MMDVM's TX 125/12 and MMDVMmulti's 25/24 at 51 taps a phase,
// MMDVMmulti's RX 24/25 at 53, DSSS's TX 50/13 at 2), every phase of one or
// two f32 planes in one launch, outputs interleaved and the new tail state
// written by the same launch.
//
// Replaces, at those shapes, the Pallas TPU kernel of
// qradiolink_tpu/ops/pallas_fir.py `banded_fir` -> `_banded_call`
// (pallas_fir.py:111), which the JAX package's RationalResampler
// (qradiolink_tpu/ops/resample.py `_phases`) runs once per phase.
// csrc/resample_poly.cu (resample_poly_f32) computes the same function at
// every shape; it served these four before this kernel and lost to one
// F.conv1d there (4.0457 ms against 0.8986 at 125/12 x 256 rows).
//
// Function, over the virtual stream xc = [tail (K-1) | x (T)] of each row,
// T = n_pp * M, with tf_r the flipped taps of phase r (row r of `taps`) and
// q_r = floor(r*M/L):
//     y[t*L + r] = sum_{j<K} tf_r[j] * xc[t*M + q_r + j],
//         t in [0, n_pp), r in [0, L)
//     state[plane][j] = xc[T + j], j in [0, K-1)
// The state is written as a (C, 2, K-1) block; with one plane (real input)
// its second plane is zeros. Each output sums j = 0 .. K-1 in order with
// fmaf from 0.0f, as resample_poly_f32 and resample_up_f32 do, so the
// three kernels' outputs are equal bit for bit. No chain is split into
// partial sums and no tensor core is used.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): at 125/12, K 51, 2 planes, 256 rows x 24,000 -> 250,000, 6.5 G
// FMAs, 0.195 ms (operations); at 50/13, K 2, 256 x 5,200 -> 20,000, 52 MB,
// 0.0154 ms (bytes); MMDVMmulti's 25/24 and 24/25 at a farm of 448 rows x
// 24,000 <-> 25,000, 176 MB, 0.0525 ms (bytes). At one row or seven only
// the launch and one block's serial part bind.
//
// What held resample_poly_f32 back at these shapes, and what this kernel
// does about each:
//   1. Bank conflicts on the samples: its lane i read s_x[i*M + ...], M
//      floats apart across the warp (4-way at M 12, 8-way at M 24), one such
//      load and one tap load for every FMA. Here consecutive lanes take
//      consecutive phases r of one output time, so a warp's sample loads
//      are xc[t*M + q_r + i] for q_r within 24 consecutive words: a
//      broadcast of 1-4 words at 125/12, 24-32 distinct banks at 25/24 and
//      24/25. A block holds G = kThreads / L groups of L threads (thread k:
//      phase k mod L, group k / L); each group's samples lie in a region of
//      sp words with sp = q_max + 1 (mod 32), so a warp that spans two or
//      three groups still reads one run of at most 32 consecutive banks.
//   2. Each tap was a shared load. Here a thread keeps its phase's K taps
//      in registers (K a template parameter) and streams its samples: a
//      sample read once serves the ceil(K/M) = A outputs whose windows hold
//      it, output t - b taking tap i + b*M of sample i of iteration t. The
//      outputs ride in A accumulators used as a ring (iteration t starts
//      output t in slot t mod A from 0.0f and stores output t - A + 1, whose
//      last tap it has just added); the loop is unrolled over UA iterations
//      (UA a multiple of A), so every slot and tap index is a compile-time
//      constant, and a group runs whole unrolled steps (the extra
//      iterations read staged words and store nothing) with no test a step.
//      Loads an FMA: M/K, 0.24 at 125/12 (resample_poly_f32: 2), and no tap
//      load. The first A - 1 iterations of a group fill slots of outputs
//      before the group's first, which are never stored.
//   3. Stores with stride L across a warp: here a warp stores the phases of
//      one output time (two or three times where it spans groups), one to
//      three contiguous runs of y, through a pointer that steps L a
//      iteration.
//   4. Taps staged for 32 output times a block (25.5 KB at 125/12 for 4,000
//      outputs). Here a block stages its L*K taps once and reads them into
//      registers; its groups then stream their tile in chunks of CC
//      iterations (about kChunkWords samples a group), double-buffered:
//      cp.async stages chunk k + 1 while chunk k is computed,
//      zeros past the stream's end, the tail/x seam resolved per word and
//      the tails read in place from the state's strided views.
//   5. Few lanes at 1 and 7 rows: there the tile follows the rows. A group
//      takes `times` consecutive output times of one row-plane, a block G
//      groups; `times` is the least that gives kRuleBlocks blocks an SM over
//      the card (at least 1; at most kTimesA * A, so large shapes keep wide
//      tiles), then evened over the row's tiles (tile_times). Grids on 132
//      SMs (times a group, tiles x row-planes): 125/12 at 256 rows 286,
//      7 x 512, at one row 1, 240 x 2; 50/13 at 256 rows 50, 4 x 512; 25/24
//      and 24/25 at 7 rows 6, 34 x 14 (one site) and 1, 24 x 14 (a headless
//      block), at 448 rows 100, 2 x 896.
// Registers: K taps, A accumulators, the staging's and the stores'
// pointers: 96 for the K 51 and 53 instances under kMinBlocks = 5, no
// spill (chip_smoke.py prints ptxas's count for each instance and fails on
// a spill). Shared memory: L*(K|1) taps and two buffers of G regions of sp
// words, 13-37 KB a block.
//
// Measured on the way (NVIDIA H100 80GB HBM3 at 700 W, device ms in turns;
// 125/12 at 256 rows / the 25/24 farm of 448 rows unless named), with
// builds of earlier states of this source. The first build, 256-thread
// blocks and 3 an SM (80 registers), spilled 20-28 bytes in the K 51 and
// 53 instances; at 2 an SM it ran 0.503 / 0.185. 8-byte loads from a
// second copy of each region one word on (half the load instructions)
// were slower, 0.538 / 0.266 against 0.5105 / 0.185, so the loads' count
// is not what binds; it was dropped. The store pointer that steps L took
// 0.508 to 0.465; whole steps gave 0.4648 against 0.4587 with a test a
// step, and 0.0273 against 0.0295 at 50/13 (kept). 128-thread blocks, 4
// an SM, with chunks of 768 samples: 0.4335 / 0.1405 against 0.4648 /
// 0.1767. Then kTimesA 64 and 5 blocks an SM: 0.4254 / 0.1335 against
// 0.4349 / 0.1412. The prefetch (against the copy after the compute) gave
// 0-1% at 125/12 and the farms and 3% at 50/13: the blocks resident on an
// SM hide each other's copies. A rule aiming at 2 blocks an SM: 0.0116
// against 0.0102 at 7 rows, 0.0077 against 0.0084 at MMDVM's headless
// block (4 kept). scripts/resample_rat_variants.py builds this source
// with the prefetch, the whole steps or a constant undone (copy-after,
// step-test, NAME=VALUE) and times the builds in turns at the nine shapes.
// At 125/12 the instruction slots are the limit in sight: 12 loads, 51
// FMAs and a store an output time of a warp, about 2.6 instructions a
// clock of the SM's 4; at the farms about 1.7 (not measured further: no
// profiler could read the card's stalls).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // threads a block
constexpr int kMinBlocks = 5;     // blocks an SM the registers must allow
constexpr int kRuleBlocks = 4;    // blocks an SM the tile rule aims at
constexpr int kChunkWords = 768;  // samples a group stages a chunk, about
constexpr int kTimesA = 64;       // output times a group, at most, per A
constexpr int kMaxDev = 64;       // devices whose SM count is kept

// accumulators: the outputs whose windows hold one sample
__host__ __device__ constexpr int ring_len(int M, int K) {
    return (K + M - 1) / M;
}

// iterations an unrolled step: a multiple of A, at least 3
__host__ __device__ constexpr int unroll_len(int M, int K) {
    return ring_len(M, K) >= 3 ? ring_len(M, K) : 4;
}

// iterations a chunk: whole unrolled steps, about kChunkWords samples
__host__ __device__ constexpr int chunk_iters(int M, int K) {
    return unroll_len(M, K) * (kChunkWords / (M * unroll_len(M, K)) > 0
                                   ? kChunkWords / (M * unroll_len(M, K))
                                   : 1);
}

// floats between two phases' taps in shared memory: odd
__host__ __device__ constexpr int kTapStride(int K) { return K | 1; }

// largest phase offset q_r = floor(r*M/L), r < L
__host__ __device__ constexpr int q_max(int L, int M) {
    return (L - 1) * M / L;
}

// n rounded up to t (mod 32)
__host__ __device__ constexpr int pad_to(int n, int t) {
    return n + ((t - n) % 32 + 32) % 32;
}

// words a group's region of a chunk buffer: the chunk's samples, padded to
// q_max + 1 (mod 32) so that consecutive groups' loads fall on one run of
// banks
__host__ __device__ constexpr int region_words(int L, int M, int K) {
    return pad_to(chunk_iters(M, K) * M + q_max(L, M), q_max(L, M) + 1);
}

__host__ __device__ constexpr long long smem_words(int L, int M, int K) {
    return (long long)L * kTapStride(K) +
           2LL * (kThreads / L) * region_words(L, M, K);
}

// an element from global to shared memory, or zeros where !valid
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// output times a group: the least giving kRuleBlocks blocks an SM over
// n_sm SMs (at least 1, at most kTimesA * A), evened over the row's tiles
int tile_times(int L, int M, int K, long long row_planes, int n_pp,
               int n_sm) {
    if (n_pp <= 0) return 0;
    const long long G = kThreads / L;
    const long long want = G * n_sm * kRuleBlocks;
    long long per = (row_planes * n_pp + want - 1) / want;
    const long long most = (long long)kTimesA * ring_len(M, K);
    if (per > most) per = most;
    if (per < 1) per = 1;
    const long long tiles = (n_pp + G * per - 1) / (G * per);
    return (int)((n_pp + tiles * G - 1) / (tiles * G));
}

template <int M, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
resample_rat_kernel(const float* __restrict__ tail0,
                    const float* __restrict__ tail1, int tail_ld,
                    const float* __restrict__ x0,
                    const float* __restrict__ x1,
                    const float* __restrict__ taps, float* __restrict__ y0,
                    float* __restrict__ y1, float* __restrict__ state, int C,
                    int T, int L, int n_pp, int times, int n_tiles,
                    int planes) {
    constexpr int A = ring_len(M, K);
    constexpr int UA = unroll_len(M, K);
    constexpr int CC = chunk_iters(M, K);
    constexpr int ks = kTapStride(K);
    constexpr int k1 = K - 1;
    extern __shared__ float smem[];
    const int G = kThreads / L;
    const int qm = q_max(L, M);
    const int sp = region_words(L, M, K);
    float* s_tap = smem;          // L rows of ks
    float* s_buf = smem + L * ks; // 2 buffers of G regions of sp

    const int tile = (int)(blockIdx.x % (unsigned)n_tiles);
    const int rp = (int)(blockIdx.x / (unsigned)n_tiles);
    const int plane = rp / C;
    const int row = rp - plane * C;
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
    const int t0 = tile * G * times;
    if (n_pp - t0 <= 0) return;  // n_pp == 0: only the state

    // chunk k of every group into buffer k & 1: group g's iterations
    // [k CC, k CC + n_it_k) read xc from (t0 + g times + k CC) M on
    // a group's iterations: times + A - 1 rounded up to whole unrolled
    // steps (the extra ones read staged words and store nothing)
    const int n_it = (times + A - 1 + UA - 1) / UA * UA;
    const int n_ch = (n_it + CC - 1) / CC;
    const auto stage = [&](int k) {
        const int n_w = min(CC, n_it - k * CC) * M + qm;
        float* dst = s_buf + (k & 1) * G * sp;
        for (int g = 0; g < G; ++g) {
            const long long v0 = ((long long)t0 + (long long)g * times +
                                  (long long)k * CC) * M;
            for (int w = threadIdx.x; w < n_w; w += kThreads) {
                const long long v = v0 + w;
                const bool ok = v < n_in;
                cp_async(dst + g * sp + w,
                         v < k1 ? tail + v : x + (ok ? v - k1 : 0), ok);
            }
        }
    };
    for (int w = threadIdx.x; w < L * K; w += kThreads) {
        const int r = w / K;
        cp_async(s_tap + r * ks + (w - r * K), taps + w, true);
    }
    stage(0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    const int r = threadIdx.x % L;
    const int g = threadIdx.x / L;
    const bool active = g < G;
    float h[K];
#pragma unroll
    for (int j = 0; j < K; ++j) h[j] = active ? s_tap[r * ks + j] : 0.0f;
    float acc[A];
#pragma unroll
    for (int s = 0; s < A; ++s) acc[s] = 0.0f;
    const long long tg = (long long)t0 + (long long)g * times;
    const int n_g = active ? (int)max(0LL, min((long long)times, n_pp - tg))
                           : 0;
    float* yo = (plane ? y1 : y0) + (size_t)row * n_pp * L +
                (size_t)tg * L + r;
    const int q_r = r * M / L;

    for (int k = 0; k < n_ch; ++k) {
        if (k > 0) {
            cp_async_wait_all();  // chunk k landed
            __syncthreads();      // and chunk k - 1's buffer is free
        }
        if (k + 1 < n_ch) stage(k + 1);
        cp_async_commit();
        const int n_itk = active ? min(CC, n_it - k * CC) : 0;
        const float* p = s_buf + (k & 1) * G * sp + g * sp + q_r;
        // iteration c = k CC + c0 + a of the group: slot c mod A = a mod A
        for (int c0 = 0; c0 < n_itk; c0 += UA, p += UA * M) {
            // iteration c stores output o0 + a = c - (A - 1)
            const int o0 = k * CC + c0 - (A - 1);
            float* ys = yo + (long long)o0 * L;
#pragma unroll
            for (int a = 0; a < UA; ++a) {
                acc[a % A] = 0.0f;  // output c starts
#pragma unroll
                for (int i = 0; i < M && i < K; ++i) {
                    const float v = p[a * M + i];
                    // sample i serves output c - b at tap i + b M
#pragma unroll
                    for (int b = 0; b < A; ++b) {
                        if (i + b * M < K) {
                            const int s = (a - b + UA * A) % A;
                            acc[s] = fmaf(h[i + b * M], v, acc[s]);
                        }
                    }
                }
                // output c - (A - 1) has its last tap
                if ((unsigned)(o0 + a) < (unsigned)n_g)
                    ys[a * L] = acc[(a + 1) % A];
            }
        }
    }
}

// the current device's SM count, read on its first launch
cudaError_t sm_count(int* n_sm) {
    static int sms[kMaxDev];  // 0 until read
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDev) return cudaErrorInvalidDevice;
    if (sms[dev] == 0 &&
        (e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
        return e;
    *n_sm = sms[dev];
    return cudaSuccess;
}

template <int M, int K>
int launch(const void* tail0, const void* tail1, int tail_ld, const void* x0,
           const void* x1, const void* taps, void* y0, void* y1, void* state,
           int C, int T, int L, int planes, cudaStream_t stream) {
    const int n_pp = T / M;
    int n_sm = 0;
    cudaError_t e = sm_count(&n_sm);
    if (e != cudaSuccess) return (int)e;
    const int times = tile_times(L, M, K, (long long)C * planes, n_pp, n_sm);
    const long long per_tile = (long long)(kThreads / L) * times;
    const long long n_tiles = n_pp > 0 ? (n_pp + per_tile - 1) / per_tile : 1;
    const long long smem = smem_words(L, M, K) * (long long)sizeof(float);
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(resample_rat_kernel<M, K>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
        return (int)e;
    const long long blocks = n_tiles * C * planes;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    resample_rat_kernel<M, K><<<(unsigned)blocks, kThreads, (size_t)smem,
                                stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, (const float*)x0,
        (const float*)x1, (const float*)taps, (float*)y0, (float*)y1,
        (float*)state, C, T, L, n_pp, times > 0 ? times : 1, (int)n_tiles,
        planes);
    return (int)cudaGetLastError();
}

// the (M, K) instances: MMDVM TX 125/12 and MMDVMmulti TX 25/24 (K 51),
// DSSS TX 50/13 (K 2), MMDVMmulti RX 24/25 (K 53)
bool has_instance(int M, int K) {
    return (M == 12 && K == 51) || (M == 13 && K == 2) ||
           (M == 24 && K == 51) || (M == 25 && K == 53);
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes; -1 where no instance takes
// (L, M, K) (L at most 128, kThreads, and (M, K) an instance).
long long resample_rat_smem_bytes(int L, int M, int K) {
    if (L < 1 || L > kThreads || !has_instance(M, K)) return -1;
    switch (M) {
        case 12: return smem_words(L, 12, 51) * (long long)sizeof(float);
        case 13: return smem_words(L, 13, 2) * (long long)sizeof(float);
        case 24: return smem_words(L, 24, 51) * (long long)sizeof(float);
        default: return smem_words(L, 25, 53) * (long long)sizeof(float);
    }
}

// Same arguments as resample_poly_f32 (csrc/resample_poly.cu). tail0/tail1:
// (C, tail_ld)-strided rows of K-1 floats; x0/x1: contiguous (C, T) with
// T % M == 0; taps: contiguous (L, K), phase r's flipped taps in row r;
// y0/y1: contiguous (C, T/M*L); state: contiguous (C, 2, K-1), written
// whole. planes 1 or 2 (the *1 pointers are read only for 2); (M, K) an
// instance, L at most 128 (kThreads). Returns a CUDA error code, 0 after a clean
// launch.
int resample_rat_f32(const void* tail0, const void* tail1, int tail_ld,
                     const void* x0, const void* x1, const void* taps,
                     void* y0, void* y1, void* state, int C, int T, int K,
                     int L, int M, int planes, void* stream) {
    if (C < 1 || T < 0 || L < 1 || L > kThreads || M < 1 || T % M ||
        planes < 1 || planes > 2 || !has_instance(M, K))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (M) {
        case 12: return launch<12, 51>(tail0, tail1, tail_ld, x0, x1, taps,
                                       y0, y1, state, C, T, L, planes, s);
        case 13: return launch<13, 2>(tail0, tail1, tail_ld, x0, x1, taps,
                                      y0, y1, state, C, T, L, planes, s);
        case 24: return launch<24, 51>(tail0, tail1, tail_ld, x0, x1, taps,
                                       y0, y1, state, C, T, L, planes, s);
        default: return launch<25, 53>(tail0, tail1, tail_ld, x0, x1, taps,
                                       y0, y1, state, C, T, L, planes, s);
    }
}

const char* resample_rat_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

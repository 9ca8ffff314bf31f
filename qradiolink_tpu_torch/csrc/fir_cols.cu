// fir_cols_f32: decimating FIR with 17-64 taps a phase at a small stride
// (D 2-31), over one or two f32 planes, as D stride-1 FIRs over the phase
// columns, each register-blocked over outputs.
//
// Replaces, at its small-stride shapes, the two Pallas TPU kernels of
// qradiolink_tpu/ops/pallas_fir.py that compute the strided FIR:
//   * banded_fir_stream -> _stream_call (pallas_fir.py:218): the WBFM
//     chain's head, K = 225, D = 5 (the default 1/5 taps, A = 45),
//     2 planes x 2048 rows x 200,000 samples with a carried tail;
//   * banded_fir -> _banded_call (pallas_fir.py:111): the WBFM audio
//     resampler, K = 1,121, D = 25 (the default 1/25 taps, A = 45), real,
//     2048 rows x 40,000 samples -> 1,600, its tail read in place.
// csrc/fir_long.cu (fir_long_f32) computes the same function at D >= 32
// and csrc/fir.cu (fir_stream_f32) at every shape; ops/cuda_fir.route()
// says which kernel takes a call.
//
// Why a source of its own: fir_long_f32 gives each lane a phase column
// and walks the phase rows, so at D 5 it would leave 27 of 32 lanes idle
// (7 at D 25). Here the loop runs the other way, over the taps of one
// phase column, with a run of consecutive outputs a thread: the loop of
// csrc/fir_s1.cu, once a column, over a staged transpose of the input.
//
// Function, over the virtual stream xc = [tail (tail_len) | x (T)] of each
// row, with tf the flipped taps (tf[j] = h[K-1-j]):
//     y[m] = sum_{j<K} tf[j] * xc[m*D + shift + j],   m in [0, n_out)
// In polyphase form, with A = ceil(K/D), the taps padded with zeros to A*D
// and X[r][b] = xc[r*D + shift + b] for b < D:
//     y[m] = sum_{b<D} sum_{a<A} c_b[a] * X[m + a][b],   c_b[a] = tf[a*D + b]
// For each column b, the inner sum is a stride-1 FIR of A taps along the
// column X[.][b].
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores):
//   WBFM head, 2 x 2048 x 200,000 -> 40,000: 3.28 GB of input, 3.7 MB of
//     tails, 655 MB of output, >= 1.175 ms; 73.7 GFLOP, >= 1.100 ms.
//     Bound by bytes, with the operations at 94% of it: no room for an
//     instruction that is not an FMA or a load.
//   WBFM audio resampler, 2048 x (1,120 + 40,000) -> 1,600, real: 337 MB
//     in, 13 MB out, >= 0.104 ms; 7.35 GFLOP, >= 0.110 ms. Bound by
//     operations.
// fir_stream_f32 issues two shared loads (a tap and a sample) for every
// FMA, so it is held by the load pipe: 7.1 ms and 0.73 ms at the two
// shapes. Here a group of kR taps costs kR sample loads and kR/4 float4
// tap broadcasts for kR^2 FMAs.
//
// Design: a block owns a tile of kTile = 1,024 consecutive outputs of one
// (plane, row); the three are flattened into blockIdx.x. It has H column
// parts of kThreads = 128 threads: H = 1 where the block's shared memory
// fits in 48 KB (D 2-9, 14-18), else H = kParts = 2 (the audio resampler).
// Thread t of part h computes the kR = 8 outputs m0 + t*kR + r over part
// h's columns.
//   * The taps, once a block, by column: s_tap[b][a] = c_b[a], rows of
//     kTapRow = 64 floats (zero past the column's last tap), so a group of
//     kR taps is two float4 broadcasts.
//   * The columns go in slabs of at most kSlab = 13 (D 5: one slab of 5;
//     D 25: 13 and 12). For each slab the block stages the phase rows its
//     threads read, rows 0 .. ceil8(n_here) + A - 2 of the tile, as a
//     transpose: column c of the slab is a run of kColWords floats, row r at
//     word padded(r) = r + r/kR. Staging thread i < P*nb (P = H kThreads /
//     nb rows a pass) copies column i mod nb of rows i / nb, i / nb + P, ...,
//     so consecutive threads copy consecutive samples of xc (coalesced),
//     with 4-byte cp.async: every copy of the slab is in flight at once and
//     none passes through registers. The tail/x seam is resolved per
//     element (the concatenation is never built) unless the tile's span
//     lies inside x; copies past tail_len + T fill 0.
//   * Part h takes the slab's columns h*nb/H .. (h+1)*nb/H - 1. For each,
//     fir_s1_f32's loop: the window of kR samples that the thread's
//     outputs need at tap a lives in a ring of kR registers; step a loads
//     one new sample (lane stride kR + 1 words, so the 32 lanes hit 32
//     banks) and issues kR FMAs,
//     acc[r] += c_b[a] * w[(a + r) % kR]. The loop is unrolled kR times,
//     so every ring index is a compile-time constant; the last A mod kR
//     taps take the same body under a uniform `u < rem` test, their
//     samples and taps loaded ahead of it. The kR sums stay in registers
//     across columns and slabs.
//   * Two barriers a slab (the slab is staged; the last slab is read).
//     With two parts, part 1 hands its sums to part 0 through the staging
//     buffer (two more barriers), and part 0 adds them. Each thread of
//     part 0 stores its kR outputs, skipping those past n_out.
// Shared memory: 64 D + nb * 1,222 floats, 25 KB at D 5 (8 blocks an SM)
// and 70 KB at D 25 (3 blocks an SM, above the 48 KB a launch gets
// without opting in). The parts are there for the blocks that few of fit
// an SM: at D 25, one part leaves 12 warps an SM, and a block waits for
// each slab's copies with only its own 4 warps; two parts give 24 warps,
// and each column's FIR runs on half the block. Three and four parts were
// slower (fewer columns a part, more sums handed over), and so were two
// parts at D 5, where 8 blocks already fit an SM.
// What the slabs cost, at the audio resampler (D 25): a slab's rows are
// runs of nb of the row's 25 floats, so its copies fetch about twice the
// bytes they keep from L2, and a block waits for each slab's copies.
// Fewer, wider slabs won while three blocks fit an SM: two slabs (13 and
// 12) beat three of 9, 8 and 8 (four blocks an SM, with one to three
// parts), four double-buffered slabs of 7 (the next copied while this one
// computes, at two blocks fewer an SM) and five of 5. Tried and dropped as
// slower at both shapes: 16 outputs a thread (two warp pairs taking half
// the taps each, or 64-thread blocks), two columns' rings interleaved,
// blocks that walk several tiles and copy the next tile's first slab under
// the last slab's compute, taps read from global memory, and taps and
// windows loaded a group ahead by hand, tiles of equal length, and an L2
// prefetch of the tile's span at the block's start. Staging through
// registers, eight loads a thread in flight, left five to seven dependent
// rounds of loads a slab; cp.async puts them all in flight.

// Sum order: each part accumulates its columns in order, and within a
// column taps a = 0 .. A-1, with fmaf from 0.0f; part 0's sum then adds
// parts 1 .. H-1 in order. It differs from F.conv1d's and fir_stream_f32's
// (taps j = 0 .. K-1) by rounding, so it is held to the FIR's bound of the
// plain version, not to equal bits; the order is fixed, so every run gives
// the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // threads a block
constexpr int kR = 8;                  // consecutive outputs a thread
constexpr int kTile = kThreads * kR;   // outputs a block
constexpr int kMinD = 2;               // D 1 is fir_s1_f32's
constexpr int kMaxD = 31;              // fir_long_f32 from 32
constexpr int kMinA = 17;              // taps a phase
constexpr int kMaxA = 64;
constexpr int kSlab = 13;              // most phase columns staged at once
constexpr int kTapRow = kMaxA;         // shared floats of a column's taps
constexpr int kParts = 2;              // column parts above 48 KB a block
static_assert(kR % 4 == 0, "float4 tap loads; an even kR for the banks");

// padded shared-memory index of phase row r within a staged column
__host__ __device__ constexpr int padded(int r) { return r + r / kR; }

// shared floats of one staged column: rows 0 .. kTile + kMaxA - 2
constexpr int kColWords = padded(kTile + kMaxA - 2) + 1;

// columns a slab: the D columns cut into ceil(D / kSlab) slabs of nearly
// equal size
__host__ __device__ constexpr int slab_cols(int D) {
    return (D + (D + kSlab - 1) / kSlab - 1) / ((D + kSlab - 1) / kSlab);
}

// shared memory one launch needs at stride D, in bytes
constexpr long long smem_bytes(int D) {
    return (long long)(D * kTapRow + slab_cols(D) * kColWords) *
           (long long)sizeof(float);
}

// 4-byte asynchronous copy to shared memory; 0 where !full (no byte read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(full ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// kR taps of a column's row from shared memory, kR / 4 float4 broadcasts
__device__ __forceinline__ void load_taps(const float4* tq, float (&tv)[kR]) {
#pragma unroll
    for (int k = 0; k < kR / 4; ++k) {
        const float4 f = tq[k];
        tv[4 * k] = f.x;
        tv[4 * k + 1] = f.y;
        tv[4 * k + 2] = f.z;
        tv[4 * k + 3] = f.w;
    }
}

// One column's stride-1 FIR over its A taps, for the kR outputs
// g0 = t*kR .. g0 + kR - 1 of the tile: their window of kR rows at tap a is
// rows g0 + a .. g0 + a + kR - 1, a ring of kR registers. Row g0 + s of the
// column sits at q[s + s / kR] with q = col + (kR + 1) t: compile-time
// offsets for compile-time s, and each group of kR taps moves q by kR + 1.
__device__ __forceinline__ void column_fir(const float* col,
                                           const float* taps, int A, int t,
                                           float (&acc)[kR]) {
    constexpr int kLast = kR - 1;
    const float* q = col + (kR + 1) * t;
    const float4* tq = reinterpret_cast<const float4*>(taps);
    float w[kR];
#pragma unroll
    for (int s = 0; s < kLast; ++s) w[s] = q[s];
    const int n_grp = A / kR;
    for (int g = 0; g < n_grp; ++g, q += kR + 1, tq += kR / 4) {
        float tv[kR];
        load_taps(tq, tv);
#pragma unroll
        for (int v = 0; v < kR; ++v) {
            const int s = v + kLast;  // the row that enters
            w[(v + kLast) % kR] = q[s + s / kR];
#pragma unroll
            for (int o = 0; o < kR; ++o)
                acc[o] = fmaf(tv[v], w[(v + o) % kR], acc[o]);
        }
    }
    // the last A mod kR taps: samples and taps loaded first (zero past A
    // in the tap row), then the same body under a uniform `v < rem` test,
    // ring indices still constant
    const int rem = A - n_grp * kR;
    if (rem > 0) {
        float tv[kR], nw[kLast];
        load_taps(tq, tv);
#pragma unroll
        for (int v = 0; v < kLast; ++v) {
            const int s = v + kLast;
            nw[v] = v < rem ? q[s + s / kR] : 0.0f;
        }
#pragma unroll
        for (int v = 0; v < kLast; ++v) {
            if (v < rem) {
                w[(v + kLast) % kR] = nw[v];
#pragma unroll
                for (int o = 0; o < kR; ++o)
                    acc[o] = fmaf(tv[v], w[(v + o) % kR], acc[o]);
            }
        }
    }
}

template <int H>
__global__ void __launch_bounds__(kThreads * H)
fir_cols_kernel(const float* __restrict__ tail0,
                const float* __restrict__ tail1, int tail_ld, int tail_len,
                const float* __restrict__ x0, const float* __restrict__ x1,
                const float* __restrict__ tf, float* __restrict__ y0,
                float* __restrict__ y1, int C, int T, int K, int D, int A,
                int shift, int n_out, int n_tiles) {
    extern __shared__ float4 smem4[];
    float* s_tap = reinterpret_cast<float*>(smem4);  // [D][kTapRow]
    float* s_x = s_tap + D * kTapRow;                 // [nb][kColWords]

    const int tile = (int)(blockIdx.x % (unsigned)n_tiles);
    const int rp = (int)(blockIdx.x / (unsigned)n_tiles);
    const int plane = rp / C;
    const int row = rp - plane * C;
    const float* tail = plane ? tail1 : tail0;
    if (tail != nullptr) tail += (size_t)row * tail_ld;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;
    float* y = (plane ? y1 : y0) + (size_t)row * n_out;

    constexpr int kAll = kThreads * H;
    const int tid = threadIdx.x;
    const int h = H == 1 ? 0 : tid / kThreads;  // the thread's column part
    const int t = tid - h * kThreads;           // and its outputs
    // the taps by column, zero past each column's last tap (copied with
    // the first slab)
    for (int i = tid; i < D * kTapRow; i += kAll) {
        const int b = i / kTapRow;
        const int j = (i - b * kTapRow) * D + b;
        cp_async4(s_tap + i, tf + (j < K ? j : 0), j < K);
    }

    const int m0 = tile * kTile;
    const int n_here = min(kTile, n_out - m0);
    // the phase rows that the threads with an output read
    const int n_rows = (n_here + kR - 1) / kR * kR + A - 1;
    const int n_in = tail_len + T;
    const int g0 = t * kR;  // the thread's first output, from m0
    const int nb_max = slab_cols(D);

    // copy the slab of columns b0 .. b0 + nb - 1, one commit group:
    // staging thread tid takes column c = tid mod nb of rows tid / nb + k*P,
    // the samples v = v_base + r*D + c of xc
    auto stage = [&](int b0) {
        const int nb = min(nb_max, D - b0);
        const int v_base = m0 * D + shift + b0;
        const bool inside = v_base >= tail_len &&
                            v_base + (n_rows - 1) * D + nb <= n_in;
        const int P = kAll / nb;
        if (tid < P * nb) {
            const int c = tid % nb;
            float* dst = s_x + c * kColWords;
            int r = tid / nb;
            int v = v_base + r * D + c;
            if (inside) {
                const float* src = x + (v - tail_len);
#pragma unroll 4
                for (; r < n_rows; r += P, src += P * D)
                    cp_async4(dst + padded(r), src, true);
            } else {
#pragma unroll 4
                for (; r < n_rows; r += P, v += P * D) {
                    const float* src = v < tail_len ? tail + v
                                                    : x + (v - tail_len);
                    cp_async4(dst + padded(r), v < n_in ? src : x,
                              v < n_in);
                }
            }
        }
        cp_async_commit();
    };

    float acc[kR];
#pragma unroll
    for (int o = 0; o < kR; ++o) acc[o] = 0.0f;

    for (int b0 = 0; b0 < D; b0 += nb_max) {
        const int nb = min(nb_max, D - b0);
        if (b0 > 0) __syncthreads();  // the last slab is read
        stage(b0);  // the first with the taps
        cp_async_wait_all();
        __syncthreads();
        if (g0 >= n_here) continue;  // no output: only the barriers
        for (int cb = h * nb / H; cb < (h + 1) * nb / H; ++cb)
            column_fir(s_x + cb * kColWords, s_tap + (b0 + cb) * kTapRow, A,
                       t, acc);
    }

    if constexpr (H > 1) {
        // parts 1 .. H-1 hand their sums to part 0 through the staging
        // buffer, (H-1) kR kThreads floats
        __syncthreads();  // the last slab is read
        if (h > 0 && g0 < n_here) {
#pragma unroll
            for (int o = 0; o < kR; ++o)
                s_x[((h - 1) * kR + o) * kThreads + t] = acc[o];
        }
        __syncthreads();
        if (h > 0 || g0 >= n_here) return;
#pragma unroll
        for (int k = 1; k < H; ++k) {
#pragma unroll
            for (int o = 0; o < kR; ++o)
                acc[o] += s_x[((k - 1) * kR + o) * kThreads + t];
        }
    }
    if (g0 >= n_here) return;
    float* yo = y + m0 + g0;
    const int n_mine = n_here - g0;
#pragma unroll
    for (int o = 0; o < kR; ++o)
        if (o < n_mine) yo[o] = acc[o];
}

}  // namespace

extern "C" {

// Same arguments as fir_stream_f32 (csrc/fir.cu). tail0/tail1: (C,
// tail_ld)-strided rows of K-1 floats, or null (no tail); x0/x1, y0/y1:
// contiguous (C, T) and (C, n_out); planes 1 or 2 (the *1 pointers are read
// only for 2). Takes 2 <= D <= 31 and 17 <= ceil(K/D) <= 64, and returns
// cudaErrorInvalidValue for any other shape; otherwise cudaGetLastError()
// after the launch.
int fir_cols_f32(const void* tail0, const void* tail1, int tail_ld,
                 const void* x0, const void* x1, const void* taps_flipped,
                 void* y0, void* y1, int C, int T, int K, int D, int shift,
                 int n_out, int planes, void* stream) {
    if (D < kMinD || D > kMaxD || K < 1 || C < 1 || planes < 1 ||
        planes > 2)
        return (int)cudaErrorInvalidValue;
    const int A = (K + D - 1) / D;
    if (A < kMinA || A > kMaxA) return (int)cudaErrorInvalidValue;
    const int tail_len = tail0 ? K - 1 : 0;
    // 25 KB at D 5, 70 KB at D 25 and at most (D 26): above 48 KB the
    // launch opts in, and its block runs in kParts column parts
    const long long smem = smem_bytes(D);
    const int n_tiles = (n_out + kTile - 1) / kTile;
    const long long blocks = (long long)n_tiles * C * planes;
    if (blocks == 0) return (int)cudaSuccess;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const float *t0 = (const float*)tail0, *t1 = (const float*)tail1;
    const float *xa = (const float*)x0, *xb = (const float*)x1;
    const float* tf = (const float*)taps_flipped;
    float *ya = (float*)y0, *yb = (float*)y1;
    const cudaStream_t s = (cudaStream_t)stream;
    if (smem <= 48 * 1024) {
        fir_cols_kernel<1><<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(
            t0, t1, tail_ld, tail_len, xa, xb, tf, ya, yb, C, T, K, D, A,
            shift, n_out, n_tiles);
    } else {
        const cudaError_t e = cudaFuncSetAttribute(
            fir_cols_kernel<kParts>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        fir_cols_kernel<kParts>
            <<<(unsigned)blocks, kThreads * kParts, (size_t)smem, s>>>(
                t0, t1, tail_ld, tail_len, xa, xb, tf, ya, yb, C, T, K, D, A,
                shift, n_out, n_tiles);
    }
    return (int)cudaGetLastError();
}

const char* fir_cols_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// fir_s1_f32: stride-1 streaming FIR over one or two f32 planes, register-
// blocked over outputs.
//
// Replaces, at their stride-1 shapes, the two Pallas TPU kernels of
// qradiolink_tpu/ops/pallas_fir.py that compute the strided FIR:
//   * banded_fir -> _banded_call (pallas_fir.py:111): the 251-tap RRC of the
//     4FSK chain (real input);
//   * banded_fir_stream -> _stream_call (pallas_fir.py:218): the 4FSK
//     channel low-pass (K 55) and the NBFM chain's channel (K 133) and audio
//     (K 55) low-passes.
// csrc/fir.cu (fir_stream_f32) computes the same function at every shape,
// csrc/fir_decim.cu (fir_decim_f32) at the decimating head;
// ops/cuda_fir.route() says which kernel takes a call.
//
// Function, over the virtual stream xc = [tail (tail_len) | x (T)] of each
// row, with tf the flipped taps (tf[j] = h[K-1-j]):
//     y[m] = sum_{j<K} tf[j] * xc[m + shift + j],   m in [0, n_out)
// tail_len is K-1 with a tail and 0 without one.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), 2048 rows x 4,000 outputs:
//   RRC K 251, real: 4.11 GFLOP, >= 0.061 ms; ~67 MB, 0.020 ms. Bound by
//     the FMA rate, which is also the issue rate: every instruction that is
//     not an FMA costs an FMA.
//   channel LP K 55, 2 planes: ~133 MB, >= 0.039 ms; 1.80 GFLOP, 0.027 ms.
//     Bound by bytes, with little room for issue overhead.
// fir_stream_f32 computes one output a thread and issues two shared loads
// (a tap and a sample) for every FMA, so it is held by issue and the load
// pipe (0.43-0.47 ms at the RRC, 13% of the FMA peak).
//
// Design: a block of kThreads = 128 threads owns a tile of kTile = 128 * kR
// consecutive outputs of one (plane, row); the three are flattened into
// blockIdx.x. Thread t computes the kR consecutive outputs m0 + t*kR + r.
//   * Staging: the block copies the taps and its input span of kTile + K - 1
//     samples into shared memory with coalesced loads, the tail/x seam
//     resolved per element (the concatenation is never materialised) and 0
//     read past tail_len + T. Each thread issues kStage = 8 loads into
//     registers before it stores any of them to shared memory. The span is
//     stored with one pad word after every kR words: lane l of a warp reads
//     logical word l*kR + c, which sits at (kR+1)*l + const, 32 distinct
//     banks for even kR.
//   * The inner loop: the window of kR samples that the thread's kR outputs
//     need at tap j lives in a ring of kR registers. Step j loads one new
//     sample (logical word t*kR + j + kR - 1) into the slot that the oldest
//     one left and issues kR FMAs, acc[r] += tf[j] * w[(j + r) % kR]. The tap
//     loop is unrolled kR times, so every ring index is a compile-time
//     constant; the taps of a group of kR steps are read as kR/4 float4
//     broadcasts. Per group of kR steps: kR sample loads, kR/4 tap loads and
//     kR^2 FMAs (74 issue slots for 64 FMAs at kR = 8, against 3 slots a FMA
//     in fir_stream_f32). The last K mod kR taps take the same unrolled body
//     under a uniform `u < rem` test, so no tap is padded and no ring index
//     is known only at run time (that would put the ring in local memory).
//   * Writes: each thread stores its kR outputs directly, one 4-byte store
//     each, skipping those past n_out (the ragged last tile). A warp's 32
//     threads cover 1 KB, so the stores fill whole sectors between them.
// One barrier, after the staging; 47 registers and ~7 KB of shared memory
// at K 251, so 16 blocks an SM.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, device time in
// turns with fir_stream_f32): RRC 0.131-0.133 ms against 0.392-0.395, 46%
// of its bound; channel LP 0.108-0.113 ms against 0.201-0.203, 36%. Fitting
// time = blocks x (a + b K) to the two shapes puts ~60% of the channel LP's
// time in a fixed cost a block. Tried: the first design staged with one
// load in flight a thread; issuing kStage loads before the stores gained
// 4% at the channel LP and 1% at the RRC, so that fixed cost is not the
// staging's load latency (kept, as it costs nothing). The mixed path's
// 32-row calls last 6-10 us, mostly launch and one round of staging;
// fir_stream_f32's 8x more and shorter blocks tie there or finish up to
// 1.3 us sooner, which no step time shows, so route() sends them here too.
//
// Sum order: each output accumulates tf[0], tf[1], ..., tf[K-1] in order
// with fmaf, from 0.0f: the order of fir_stream_f32 (csrc/fir.cu), so the
// two kernels' outputs are equal bit for bit (chip_smoke.py checks this).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // threads a block
constexpr int kR = 8;                  // consecutive outputs a thread
constexpr int kTile = kThreads * kR;   // outputs a block
constexpr int kStage = 8;              // staging loads in flight a thread
static_assert(kR % 4 == 0, "float4 tap loads; an even kR for the banks");

// padded shared-memory index of logical span word i
__host__ __device__ constexpr int padded(int i) { return i + i / kR; }

// the taps' shared floats, rounded up so that the span starts 16-byte
// aligned
__host__ __device__ constexpr int tap_words(int K) { return (K + 3) & ~3; }

// shared memory one launch needs for K taps, in bytes
constexpr long long smem_bytes(int K) {
    return (long long)(tap_words(K) + padded(kTile + K - 2) + 1) *
           (long long)sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
fir_s1_kernel(const float* __restrict__ tail0,
              const float* __restrict__ tail1, int tail_ld, int tail_len,
              const float* __restrict__ x0, const float* __restrict__ x1,
              const float* __restrict__ tf, float* __restrict__ y0,
              float* __restrict__ y1, int C, int T, int K, int shift,
              int n_out, int n_tiles) {
    extern __shared__ float4 smem4[];
    float* s_tap = reinterpret_cast<float*>(smem4);
    float* s_x = s_tap + tap_words(K);

    const int tile = (int)(blockIdx.x % (unsigned)n_tiles);
    const int rp = (int)(blockIdx.x / (unsigned)n_tiles);
    const int plane = rp / C;
    const int row = rp - plane * C;
    const float* tail = plane ? tail1 : tail0;
    if (tail != nullptr) tail += (size_t)row * tail_ld;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;
    float* y = (plane ? y1 : y0) + (size_t)row * n_out;

    // staging: the taps, then the span, as one run of K + span words; each
    // thread loads kStage words into registers before it stores any
    const int m0 = tile * kTile;
    const long long base = (long long)m0 + shift - K;  // of word i >= K
    const long long n_in = (long long)tail_len + T;
    const int n_words = K + kTile + K - 1;
    for (int i0 = threadIdx.x; i0 < n_words; i0 += kThreads * kStage) {
        float val[kStage];
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
            const int i = i0 + k * kThreads;
            const long long v = base + i;
            val[k] = 0.0f;
            if (i < K) {
                val[k] = tf[i];
            } else if (i < n_words) {
                if (v < tail_len) {
                    val[k] = tail[v];
                } else if (v < n_in) {
                    val[k] = x[v - tail_len];
                }
            }
        }
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
            const int i = i0 + k * kThreads;
            if (i < K) {
                s_tap[i] = val[k];
            } else if (i < n_words) {
                s_x[padded(i - K)] = val[k];
            }
        }
    }
    __syncthreads();

    const int t = threadIdx.x;
    const int g0 = t * kR;  // the thread's first output, from m0
    if (m0 + g0 >= n_out) return;  // no barrier follows

    // logical word g0 + c of the span sits at p[c + c / kR] for c < kR;
    // after b groups of kR taps, word g0 + b*kR + c at q[c + c / kR] with
    // q = p + b*(kR + 1)
    const float* q = s_x + t * (kR + 1);
    float acc[kR], w[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int s = 0; s < kR - 1; ++s) w[s] = q[s];

    const int n_grp = K / kR;
    const float4* tq = reinterpret_cast<const float4*>(s_tap);
    for (int b = 0; b < n_grp; ++b, q += kR + 1) {
        float tv[kR];
#pragma unroll
        for (int k = 0; k < kR / 4; ++k) {
            const float4 f = tq[b * (kR / 4) + k];
            tv[4 * k] = f.x;
            tv[4 * k + 1] = f.y;
            tv[4 * k + 2] = f.z;
            tv[4 * k + 3] = f.w;
        }
#pragma unroll
        for (int u = 0; u < kR; ++u) {
            constexpr int kLast = kR - 1;
            const int c = u + kLast;  // the sample that enters the window
            w[(u + kLast) % kR] = q[c + c / kR];
#pragma unroll
            for (int r = 0; r < kR; ++r)
                acc[r] = fmaf(tv[u], w[(u + r) % kR], acc[r]);
        }
    }
    // the last K mod kR taps: the same body, ring indices still constant
    const int rem = K - n_grp * kR;
    const float* t_rem = s_tap + n_grp * kR;
#pragma unroll
    for (int u = 0; u < kR - 1; ++u) {
        if (u < rem) {
            constexpr int kLast = kR - 1;
            const int c = u + kLast;
            w[(u + kLast) % kR] = q[c + c / kR];
            const float tap = t_rem[u];
#pragma unroll
            for (int r = 0; r < kR; ++r)
                acc[r] = fmaf(tap, w[(u + r) % kR], acc[r]);
        }
    }

    float* yo = y + m0 + g0;
    const int n_here = n_out - m0 - g0;
#pragma unroll
    for (int r = 0; r < kR; ++r)
        if (r < n_here) yo[r] = acc[r];
}

}  // namespace

extern "C" {

// Same arguments as fir_stream_f32 (csrc/fir.cu). tail0/tail1: (C,
// tail_ld)-strided rows of K-1 floats, or null (no tail); x0/x1, y0/y1:
// contiguous (C, T) and (C, n_out); planes 1 or 2 (the *1 pointers are read
// only for 2). Takes D = 1 only, and returns cudaErrorInvalidValue for any
// other stride or a K whose span exceeds 48 KB of shared memory; otherwise
// cudaGetLastError() after the launch.
int fir_s1_f32(const void* tail0, const void* tail1, int tail_ld,
               const void* x0, const void* x1, const void* taps_flipped,
               void* y0, void* y1, int C, int T, int K, int D, int shift,
               int n_out, int planes, void* stream) {
    if (D != 1 || K < 1 || C < 1 || planes < 1 || planes > 2)
        return (int)cudaErrorInvalidValue;
    const int tail_len = tail0 ? K - 1 : 0;
    // K <= 2,048 (ops/cuda_fir.S1_MAX_K) takes at most 22 KB, within the
    // 48 KB a launch gets without opting in
    const long long smem = smem_bytes(K);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int n_tiles = (n_out + kTile - 1) / kTile;
    const long long blocks = (long long)n_tiles * C * planes;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    fir_s1_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                    (cudaStream_t)stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, tail_len,
        (const float*)x0, (const float*)x1, (const float*)taps_flipped,
        (float*)y0, (float*)y1, C, T, K, shift, n_out, n_tiles);
    return (int)cudaGetLastError();
}

const char* fir_s1_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

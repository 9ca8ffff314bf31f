// viterbi_stream_warp_k7: one streamed block of StreamingViterbi (and, with
// no lag, viterbi_decode) for K=7 rate-1/2 codes, one warp a row. The
// first design of the streaming decoder; csrc/viterbi_stream.cu
// (viterbi_stream_k7) replaced it on the CCSDS code, and the wrapper
// (fec/viterbi_stream_cuda.py) keeps it for the other K=7 codes and for
// timing the two in turns.
//
// Not a port of a Pallas kernel: the JAX package runs the streaming
// decoder as per-step lax.scans (qradiolink_tpu/fec/conv.py:132,151-163,
// 217), which XLA compiles into device loops. The plain PyTorch version
// (fec/viterbi_stream_cuda.viterbi_stream_plain) takes about 13 device ops
// a step, so at QPSK250K's 25,064 steps a block the port runs the loops
// here instead.
//
// Function, per row b, over the S = lag + T steps of x = [tail | soft]
// (tail (B, lag, 2) and soft (B, T, 2) f32, read in place), from the
// metrics pm0 (B, 64), each operation rounded on its own:
//     bm[p]    = v0 + v1, v_i = e_i ? 255 - x[t][i] : x[t][i], for the 4
//                patterns p = 2 e_0 + e_1 of expected bits
//     cand[hi] = pm[pred_hi(s')] + bm[p(hi, s')],  pred_hi(s') = (s' >> 1)
//                | (hi << 5)
//     dec      = cand[1] < cand[0]        (ties to hi = 0, as argmin)
//     pm[s']   = dec ? cand[1] : cand[0], then pm -= min over the states
// pm1 = pm after step T (pm0 when T = 0). The end state is the lowest-index
// minimum of pm after step S; the traceback walks the decisions back,
//     bit[t] = s & 1,  s = (s >> 1) | (dec[t][s] << 5),
// and writes the first T bits. The expected bits of edge (hi, s') are
// parity(w & poly_i) with w = (pred << 1) | (s' & 1), the code's polys
// given at launch. Adds and subtractions are __fadd_rn / __fsub_rn and the
// file is built with --fmad=false (utils/kernels._EXTRA): bits and path
// metrics equal the plain version's bit for bit, and the JAX package's,
// whose branch-metric rounding this is (the rule viterbi_bfly_k7 pins).
//
// Bound on an H100 SXM: at QPSK250K (2048 rows x 25,000 pairs, lag 64) the
// bytes are the soft pairs in (410 MB), the bits out (51 MB) and the
// decisions, one 8-byte word a step written and read back (2 x 411 MB):
// 1.28 GB, 0.38 ms at 3.35 TB/s. The operations (~10 a state a step,
// 33 GFLOP, 0.49 ms at 67 TFLOP/s) are of the same size. Latency binds:
// S dependent steps a row, each a chain of shuffles, adds, a compare and
// a warp-wide minimum, ~150-250 cycles estimated. Measured (chip_smoke.py,
// an H100 at 700 W): 6.18 ms at 2048 x 25,000 pairs, ~488 cycles a step
// at 1,980 MHz, the traceback included.
//
// Design: a warp a row, lane l owning states 2l and 2l+1. Both have the
// predecessors l and l + 32, so a step fetches pm[l] and pm[l + 32] with
// four shuffles from the lanes holding them. The minimum over the 64
// states is one redux.sync (__reduce_min_sync) over order-preserving
// integer keys of the floats. Every 32 steps each lane loads one soft pair
// (a coalesced 256-byte load, issued a chunk ahead) and the steps take
// them by shuffle; each step's decisions are two ballots, one 64-bit word
// (even states in the low half, odd in the high half) kept by the lane of
// that step and stored by the warp every 32 steps. The traceback reads the
// words back 32 steps at a time (the next chunk's load in flight while the
// current one is walked), walks them by shuffle, and stores each chunk's
// 32 bits with one coalesced store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // rows a block
constexpr int kChunk = 32;    // steps a chunk: one a lane
constexpr unsigned kFull = 0xffffffffu;

// an unsigned key whose order is the float's order (no NaNs)
__device__ __forceinline__ unsigned key_of(float f) {
    const unsigned u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ int parity(unsigned v) { return __popc(v) & 1; }

// bm[p] by selects, so the four metrics stay in registers
__device__ __forceinline__ float pick(const float (&bm)[4], int p) {
    const float lo = (p & 1) ? bm[1] : bm[0];
    const float hi = (p & 1) ? bm[3] : bm[2];
    return (p & 2) ? hi : lo;
}

// One add-compare-select step of a row held by a warp, lane l owning
// states 2l (pmA) and 2l + 1 (pmB): the four pattern metrics of the soft
// pair (s0, s1), pm[l] and pm[l + 32] by shuffle, the lane's four
// candidates, its two decisions (dA, dB) and new metrics less the minimum
// over the 64 states (redux.sync over order-keyed floats).
__device__ __forceinline__ void acs_step(float s0, float s1,
                                         const int (&pat)[2][2], int srcLo,
                                         int srcHi, bool odd, float& pmA,
                                         float& pmB, bool& dA, bool& dB) {
    const float f0 = __fsub_rn(255.0f, s0);
    const float f1 = __fsub_rn(255.0f, s1);
    float bm[4];
    bm[0] = __fadd_rn(s0, s1);
    bm[1] = __fadd_rn(s0, f1);
    bm[2] = __fadd_rn(f0, s1);
    bm[3] = __fadd_rn(f0, f1);
    const float a0 = __shfl_sync(kFull, pmA, srcLo);
    const float a1 = __shfl_sync(kFull, pmB, srcLo);
    const float b0 = __shfl_sync(kFull, pmA, srcHi);
    const float b1 = __shfl_sync(kFull, pmB, srcHi);
    const float pLo = odd ? a1 : a0;  // pm[l]
    const float pHi = odd ? b1 : b0;  // pm[l + 32]
    const float cA0 = __fadd_rn(pLo, pick(bm, pat[0][0]));
    const float cA1 = __fadd_rn(pHi, pick(bm, pat[0][1]));
    const float cB0 = __fadd_rn(pLo, pick(bm, pat[1][0]));
    const float cB1 = __fadd_rn(pHi, pick(bm, pat[1][1]));
    dA = cA1 < cA0;
    dB = cB1 < cB0;
    const float nA = dA ? cA1 : cA0, nB = dB ? cB1 : cB0;
    const unsigned kmin =
        __reduce_min_sync(kFull, min(key_of(nA), key_of(nB)));
    const float m = float_of(kmin);
    pmA = __fsub_rn(nA, m);
    pmB = __fsub_rn(nB, m);
}

// soft pair of step t of x = [tail | soft]; zeros past the end
__device__ __forceinline__ float2 load_pair(const float* __restrict__ tail,
                                            const float* __restrict__ soft,
                                            int row, int T, int lag, int t) {
    if (t >= lag + T) return make_float2(0.0f, 0.0f);
    const float* p = t < lag ? tail + ((size_t)row * lag + t) * 2
                             : soft + ((size_t)row * T + (t - lag)) * 2;
    return make_float2(p[0], p[1]);
}

__global__ void __launch_bounds__(kWarps * 32)
viterbi_stream_kernel(const float* __restrict__ tail,
                      const float* __restrict__ soft,
                      const float* __restrict__ pm0, float* __restrict__ pm1,
                      unsigned long long* __restrict__ decs,
                      uint8_t* __restrict__ bits, int B, int T, int lag,
                      unsigned poly0, unsigned poly1) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= B) return;  // the whole warp leaves together
    const int S = lag + T;

    // branch-metric pattern of each of the lane's four edges
    int pat[2][2];  // [state 2l + j][hi]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const unsigned w = ((unsigned)(lane | (hi << 5)) << 1) | j;
            pat[j][hi] = 2 * parity(w & poly0) + parity(w & poly1);
        }
    // the lane's two metrics; pm[q] is held by lane q >> 1, element q & 1
    float pmA = pm0[(size_t)row * 64 + 2 * lane];
    float pmB = pm0[(size_t)row * 64 + 2 * lane + 1];
    if (T == 0) {
        pm1[(size_t)row * 64 + 2 * lane] = pmA;
        pm1[(size_t)row * 64 + 2 * lane + 1] = pmB;
    }
    const int srcLo = lane >> 1, srcHi = 16 + (lane >> 1);
    const bool odd = lane & 1;
    unsigned long long* dec_row = decs + (size_t)row * S;

    float2 nxt = load_pair(tail, soft, row, T, lag, lane);
    for (int t0 = 0; t0 < S; t0 += kChunk) {
        const float2 cur = nxt;
        nxt = load_pair(tail, soft, row, T, lag, t0 + kChunk + lane);
        const int n = min(kChunk, S - t0);
        unsigned long long word = 0;
        for (int j = 0; j < n; ++j) {
            const float s0 = __shfl_sync(kFull, cur.x, j);
            const float s1 = __shfl_sync(kFull, cur.y, j);
            bool dA, dB;
            acs_step(s0, s1, pat, srcLo, srcHi, odd, pmA, pmB, dA, dB);
            const unsigned lo = __ballot_sync(kFull, dA);
            const unsigned hi = __ballot_sync(kFull, dB);
            if (lane == j)
                word = ((unsigned long long)hi << 32) | lo;
            if (t0 + j == T - 1) {
                pm1[(size_t)row * 64 + 2 * lane] = pmA;
                pm1[(size_t)row * 64 + 2 * lane + 1] = pmB;
            }
        }
        if (lane < n) dec_row[t0 + lane] = word;
    }

    // end state: the lowest-index minimum of the 64 metrics
    const unsigned kA = key_of(pmA), kB = key_of(pmB);
    const unsigned kmin = __reduce_min_sync(kFull, min(kA, kB));
    const unsigned mine = kA == kmin ? 2 * lane : (kB == kmin ? 2 * lane + 1
                                                              : 64u);
    unsigned s = __reduce_min_sync(kFull, mine);
    __syncwarp();  // the warp's decision stores are visible to its loads

    // traceback, 32 steps a chunk from the end
    uint8_t* bit_row = bits + (size_t)row * T;
    int t_hi = S;
    int t0 = max(0, t_hi - kChunk);
    unsigned long long w_next =
        (t0 + lane < t_hi) ? dec_row[t0 + lane] : 0ull;
    while (t_hi > 0) {
        const unsigned long long w = w_next;
        const int n = t_hi - t0;
        const int t0n = max(0, t0 - kChunk);
        w_next = (t0 > 0 && t0n + lane < t0) ? dec_row[t0n + lane] : 0ull;
        unsigned b = 0;
        for (int j = n - 1; j >= 0; --j) {
            if (lane == j) b = s & 1u;
            const unsigned long long wj = __shfl_sync(kFull, w, j);
            const unsigned half = (s & 1u) ? (unsigned)(wj >> 32)
                                           : (unsigned)wj;
            const unsigned d = (half >> (s >> 1)) & 1u;
            s = (s >> 1) | (d << 5);
        }
        if (lane < n && t0 + lane < T) bit_row[t0 + lane] = (uint8_t)b;
        t_hi = t0;
        t0 = t0n;
    }
}

}  // namespace

extern "C" {

// tail: contiguous (B, lag, 2) f32; soft: contiguous (B, T, 2) f32; pm0,
// pm1: (B, 64) f32; decs: (B, lag + T) 64-bit scratch; bits: (B, T) u8.
// Returns a CUDA error code, 0 after a clean launch.
int viterbi_stream_warp_k7(const void* tail, const void* soft,
                           const void* pm0, void* pm1, void* decs,
                           void* bits, int B, int T, int lag, int poly0,
                           int poly1, void* stream) {
    if (B < 1 || T < 0 || lag < 0 || lag + T < 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + kWarps - 1) / kWarps;
    viterbi_stream_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const float*)tail, (const float*)soft, (const float*)pm0,
        (float*)pm1, (unsigned long long*)decs, (uint8_t*)bits, B, T, lag,
        (unsigned)poly0, (unsigned)poly1);
    return (int)cudaGetLastError();
}

const char* viterbi_stream_warp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// viterbi_stream_redux_k7: one streamed block of StreamingViterbi (and,
// with no lag, viterbi_decode) for the CCSDS K=7 rate-1/2 code {109, 79},
// one warp a row, each step's minimum taken off the dependent chain. A
// design tried for the streaming decoder and kept for timing in turns:
// csrc/viterbi_stream.cu (viterbi_stream_k7) is the CCSDS code's route.
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
// and writes the first T bits. The pattern of edge (hi, s') is p(s') =
// 2 parity(s' & 109) + parity(s' & 79) for hi = 0 and p(s') ^ 3 for hi = 1
// (both polynomials have their first and last taps). Adds and
// subtractions are __fadd_rn / __fsub_rn and the file is built with
// --fmad=false (utils/kernels._EXTRA): bits and path metrics equal the
// plain version's bit for bit, and the JAX package's.
//
// Bound on an H100 SXM: at QPSK250K (2048 rows x 25,000 pairs, lag 64) the
// bytes are the soft pairs in (410 MB), the bits out (51 MB) and the
// decisions, 8 bytes a step written and read back (2 x 411 MB): 1.28 GB,
// 0.38 ms at 3.35 TB/s; the operations (~10 a state a step, 33 GFLOP) 0.49
// ms at 67 TFLOP/s. Latency binds: S dependent steps a row.
//
// Why this design was tried (scripts/loop_chain_floor.py on an H100 80GB
// HBM3 at 700 W, PERF.md). The first design, a warp a row and two states a
// lane (csrc/viterbi_stream_warp.cu), took 488 cycles a step: its
// add-compare-select alone, with its warp-wide minimum (a redux.sync) on
// the chain, took 236 at 3.9 warps a scheduler, issuing 126 of them; the
// soft pairs' shuffles, the decision word's selects and the per-step pm1
// test took ~190 more and its traceback 63. viterbi_bfly_k7's layout (8
// lanes a row, csrc/viterbi_stream.cu) leaves one warp a scheduler at
// 2048 rows. This kernel keeps a warp a row, so that 3.9 warps a
// scheduler hide each other's latency, and takes the rest off each warp's
// chain. Measured: 5.45 ms, 430 cycles a step, its traceback 0.82: the
// two redux.sync a step cost more than the chain they shorten, and the
// route stays on viterbi_stream_k7 (3.74 ms):
//   * a step's minimum comes from the step before. It equals min over the
//     two classes c of (M_c + min(bm[q], bm[q ^ 3])) rounded, M_c the least
//     metric of the predecessors in class c (rounding is monotone, and a
//     predecessor's two edges carry the patterns q and q ^ 3: {0, 3} is
//     class 0, {1, 2} class 1; the class of state j is the parity of bits
//     0 and 4 of j). And M_c = (N_c - m) rounded, N_c the class's least
//     metric before the step before subtracted its minimum m. So each step
//     reduces its new metrics' two class minima (two redux.sync over
//     order-keyed floats), and the next step's minimum waits on them, not
//     the add-compare-select that follows;
//   * the soft pair of a step is one broadcast load from shared memory,
//     where the warp stages 32 steps at a time (a coalesced load a chunk
//     ahead);
//   * the two pattern metrics a lane needs are picked by selects that
//     depend only on the lane (state 2l + 1's patterns are state 2l's xor
//     3, so two picks serve both);
//   * the step's two ballots go to shared memory (lane 0), and out as one
//     coalesced store of 32 8-byte words a chunk;
//   * pm1 is stored from the chunk that holds step T - 1; only that chunk
//     and the last test the step.
//
// Layout: lane l holds states 2l (pmA) and 2l + 1 (pmB); both have the
// predecessors l and l + 32, which four shuffles fetch. The decisions of a
// step are one 64-bit word, even states in the low half (bit l: state 2l),
// odd in the high half. The traceback stages a chunk of 32 words in shared
// memory (loaded a chunk ahead), and every lane walks the row's state in
// step, reading each word by a broadcast load; lane 0 keeps the bits in
// shared memory, and the warp stores a chunk's 32 bits coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // rows a block
constexpr int kChunk = 32;    // steps a chunk: one a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPoly0 = 109, kPoly1 = 79;

// an unsigned key whose order is the float's order (no NaNs)
__device__ __forceinline__ unsigned key_of(float f) {
    const unsigned u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ int parity(unsigned v) { return __popc(v) & 1; }

// the two class minima over the warp's 64 states of metrics a (state 2l)
// and b (state 2l + 1); lc: the class of state 2l (bit 3 of the lane)
__device__ __forceinline__ void class_minima(float a, float b, bool lc,
                                             float& n0, float& n1) {
    const float c0 = lc ? b : a, c1 = lc ? a : b;
    n0 = float_of(__reduce_min_sync(kFull, key_of(c0)));
    n1 = float_of(__reduce_min_sync(kFull, key_of(c1)));
}

// what a step needs besides the metrics
struct Lane {
    int srcLo, srcHi;   // the lanes holding pm[l] and pm[l + 32]
    bool odd;           // l odd: pm[l] is its source's pmB
    bool par, e0;       // state 2l's pattern p: its class, its bit 1
    bool lc;            // the class of state 2l
    bool zero;          // lane 0 (stores the chunk's words)
};

// the running minima: n0, n1 the class minima of the last step's new
// metrics, m the minimum it subtracted
struct Mins {
    float n0, n1, m;
};

// One step at step j of the chunk: the add-compare-select of the lane's
// two states, their decisions to the chunk's word j, the metrics less the
// step's minimum.
__device__ __forceinline__ void acs_step(const float2* s_soft,
                                         unsigned long long* s_w, int j,
                                         const Lane& L, float& pmA,
                                         float& pmB, Mins& mn) {
    const float2 v = s_soft[j];
    const float f0 = __fsub_rn(255.0f, v.x);
    const float f1 = __fsub_rn(255.0f, v.y);
    const float bm0 = __fadd_rn(v.x, v.y), bm1 = __fadd_rn(v.x, f1);
    const float bm2 = __fadd_rn(f0, v.y), bm3 = __fadd_rn(f0, f1);
    // this step's minimum, from the class minima of the step before
    const float m =
        fminf(__fadd_rn(__fsub_rn(mn.n0, mn.m), fminf(bm0, bm3)),
              __fadd_rn(__fsub_rn(mn.n1, mn.m), fminf(bm1, bm2)));
    // u = bm[p], w = bm[p ^ 3] for state 2l's pattern p
    const float P = L.par ? bm1 : bm0, Q = L.par ? bm2 : bm3;
    const float u = L.e0 ? Q : P, w = L.e0 ? P : Q;
    const float a0 = __shfl_sync(kFull, pmA, L.srcLo);
    const float a1 = __shfl_sync(kFull, pmB, L.srcLo);
    const float b0 = __shfl_sync(kFull, pmA, L.srcHi);
    const float b1 = __shfl_sync(kFull, pmB, L.srcHi);
    const float pLo = L.odd ? a1 : a0;  // pm[l]
    const float pHi = L.odd ? b1 : b0;  // pm[l + 32]
    const float cA0 = __fadd_rn(pLo, u), cA1 = __fadd_rn(pHi, w);
    const float cB0 = __fadd_rn(pLo, w), cB1 = __fadd_rn(pHi, u);
    const bool dA = cA1 < cA0, dB = cB1 < cB0;
    const float nA = dA ? cA1 : cA0, nB = dB ? cB1 : cB0;
    class_minima(nA, nB, L.lc, mn.n0, mn.n1);
    mn.m = m;
    pmA = __fsub_rn(nA, m);
    pmB = __fsub_rn(nB, m);
    const unsigned lo = __ballot_sync(kFull, dA);
    const unsigned hi = __ballot_sync(kFull, dB);
    if (L.zero) s_w[j] = ((unsigned long long)hi << 32) | lo;
}

// soft pair of step t of x = [tail | soft]; zeros past the end
__device__ __forceinline__ float2 load_pair(const float2* __restrict__ tail,
                                            const float2* __restrict__ soft,
                                            int row, int T, int lag, int t) {
    if (t >= lag + T) return make_float2(0.0f, 0.0f);
    return t < lag ? tail[(size_t)row * lag + t]
                   : soft[(size_t)row * T + (t - lag)];
}

// One traceback step at step j of the chunk: the state's bit to bit j of
// the chunk when keep, then its predecessor.
__device__ __forceinline__ void tb_step(unsigned& s, int j,
                                        const unsigned long long* s_w,
                                        uint8_t* s_bits, bool keep) {
    const unsigned long long wj = s_w[j];
    if (keep) s_bits[j] = (uint8_t)(s & 1u);
    const unsigned half = (s & 1u) ? (unsigned)(wj >> 32) : (unsigned)wj;
    s = (s >> 1) | (((half >> (s >> 1)) & 1u) << 5);
}

__global__ void __launch_bounds__(kWarps * 32)
viterbi_stream_kernel(const float2* __restrict__ tail,
                      const float2* __restrict__ soft,
                      const float* __restrict__ pm0, float* __restrict__ pm1,
                      unsigned long long* __restrict__ decs,
                      uint8_t* __restrict__ bits, int B, int T, int lag) {
    // per warp: a chunk of soft pairs, of decision words, of bits
    __shared__ float2 s_soft[kWarps][kChunk];
    __shared__ unsigned long long s_w[kWarps][kChunk];
    __shared__ uint8_t s_bits[kWarps][kChunk];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= B) return;  // the whole warp leaves together
    const int S = lag + T;

    Lane L;
    L.srcLo = lane >> 1;
    L.srcHi = 16 + (lane >> 1);
    L.odd = lane & 1;
    {
        const unsigned s = 2u * lane;  // state 2l, its hi = 0 edge
        const int e0 = parity(s & kPoly0), e1 = parity(s & kPoly1);
        L.par = e0 != e1;
        L.e0 = e0;
        L.lc = (lane >> 3) & 1;
    }
    L.zero = lane == 0;

    float pmA = pm0[(size_t)row * 64 + 2 * lane];
    float pmB = pm0[(size_t)row * 64 + 2 * lane + 1];
    if (T == 0) {
        pm1[(size_t)row * 64 + 2 * lane] = pmA;
        pm1[(size_t)row * 64 + 2 * lane + 1] = pmB;
    }
    // step 0's minimum from pm0's class minima (nothing to subtract)
    Mins mn;
    class_minima(pmA, pmB, L.lc, mn.n0, mn.n1);
    mn.m = 0.0f;
    unsigned long long* dec_row = decs + (size_t)row * S;

    float2 nxt = load_pair(tail, soft, row, T, lag, lane);
    for (int t0 = 0; t0 < S; t0 += kChunk) {
        __syncwarp();  // the chunk before is read
        s_soft[warp][lane] = nxt;
        __syncwarp();
        // the next chunk's pairs, in flight while this chunk runs
        nxt = load_pair(tail, soft, row, T, lag, t0 + kChunk + lane);
        const int n = min(kChunk, S - t0);
        const bool has_t1 = T >= 1 && T - 1 >= t0 && T - 1 < t0 + kChunk;
        if (n == kChunk && !has_t1) {
#pragma unroll 8
            for (int j = 0; j < kChunk; ++j)
                acs_step(s_soft[warp], s_w[warp], j, L, pmA, pmB, mn);
        } else {
            for (int j = 0; j < n; ++j) {
                acs_step(s_soft[warp], s_w[warp], j, L, pmA, pmB, mn);
                if (t0 + j == T - 1) {
                    pm1[(size_t)row * 64 + 2 * lane] = pmA;
                    pm1[(size_t)row * 64 + 2 * lane + 1] = pmB;
                }
            }
        }
        __syncwarp();
        if (lane < n) dec_row[t0 + lane] = s_w[warp][lane];
    }

    // end state: the lowest-index minimum of the 64 metrics
    const unsigned kA = key_of(pmA), kB = key_of(pmB);
    const unsigned kmin = __reduce_min_sync(kFull, min(kA, kB));
    const unsigned mine = kA == kmin ? 2 * lane : (kB == kmin ? 2 * lane + 1
                                                              : 64u);
    unsigned s = __reduce_min_sync(kFull, mine);
    __syncwarp();  // the warp's decision stores are visible to its loads

    // traceback, 32 steps a chunk from the end, every lane on the state
    uint8_t* bit_row = bits + (size_t)row * T;
    int t0 = (S - 1) / kChunk * kChunk;
    unsigned long long w_next = t0 + lane < S ? dec_row[t0 + lane] : 0ull;
    for (; t0 >= 0; t0 -= kChunk) {
        const int n = min(kChunk, S - t0);
        __syncwarp();  // the chunk before is read and stored
        s_w[warp][lane] = w_next;
        __syncwarp();
        if (t0 > 0) w_next = dec_row[t0 - kChunk + lane];
        if (n == kChunk && t0 + kChunk <= T) {
#pragma unroll 8
            for (int j = kChunk - 1; j >= 0; --j)
                tb_step(s, j, s_w[warp], s_bits[warp], L.zero);
        } else {
            for (int j = n - 1; j >= 0; --j)
                tb_step(s, j, s_w[warp], s_bits[warp],
                        L.zero && t0 + j < T);
        }
        __syncwarp();
        if (lane < n && t0 + lane < T)
            bit_row[t0 + lane] = s_bits[warp][lane];
    }
}

}  // namespace

extern "C" {

// tail: contiguous (B, lag, 2) f32; soft: contiguous (B, T, 2) f32; pm0,
// pm1: (B, 64) f32; decs: (B, lag + T) 64-bit scratch; bits: (B, T) u8.
// poly0, poly1 must be the CCSDS code's. Returns a CUDA error code, 0
// after a clean launch.
int viterbi_stream_redux_k7(const void* tail, const void* soft,
                            const void* pm0, void* pm1, void* decs,
                            void* bits, int B, int T, int lag, int poly0,
                            int poly1, void* stream) {
    if (B < 1 || T < 0 || lag < 0 || lag + T < 1 ||
        (unsigned)poly0 != kPoly0 || (unsigned)poly1 != kPoly1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + kWarps - 1) / kWarps;
    viterbi_stream_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const float2*)tail, (const float2*)soft, (const float*)pm0,
        (float*)pm1, (unsigned long long*)decs, (uint8_t*)bits, B, T, lag);
    return (int)cudaGetLastError();
}

const char* viterbi_stream_redux_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

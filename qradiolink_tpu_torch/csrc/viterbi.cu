// viterbi_tiled_k7: tiled soft-decision Viterbi for K=7 rate-1/2 codes
// (CCSDS {109, 79} on the 4FSK main path), one tile row per warp.
//
// Replaces the Pallas TPU kernel qradiolink_tpu/fec/viterbi_pallas.py
// decode_windows -> _kernel (viterbi_pallas.py:83, pallas_call :172).
//
// Function, for each row r of win (R, S, 2) soft values in [0, 255]:
//   * add-compare-select over S steps from all-zero path metrics, with no
//     normalisation (metrics grow by at most 510 a step; the wrapper refuses
//     S*510 >= 2^24, so integer metrics stay exact in f32);
//   * branch metric of the low-predecessor edge
//       bm0 = (c0 + a00*s0) + a01*s1,
//     of the high edge (hi - bm0) + 510 when the code's two edges are
//     complements (flip, true for CCSDS), else hi + ((c1 + a10*s0) + a11*s1);
//     decision = cand1 < cand0 (strict), metric = min(cand0, cand1);
//   * end state: the lowest state index among the minimal metrics;
//   * traceback from the end state, bits[r, t - keep_from] = state & 1 for
//     t = S-1 down to keep_from, predecessor (s >> 1) | (dec_t[s] << 5).
//
// Rounding: the soft values on the main path are not integers (they come
// out of clip(soft*128+128)), so bit-exactness with the reference needs the
// f32 adds in exactly the order above, each rounded on its own. Every
// add and multiply is written with __fadd_rn / __fsub_rn / __fmul_rn, which
// the compiler never contracts into FMAs, and the file is also built with
// --fmad=false.
//
// Design: lane l of a warp owns states l and l+32. Per step every lane
// reads its row's (s0, s1) from shared memory (a broadcast), fetches the
// predecessor metrics pm[s>>1] and pm[(s>>1)|32] of its two states with
// __shfl_sync, and two __ballot_sync calls produce the step's decisions as
// two 32-bit words, bit s%32 of word s/32: the same packing as the TPU
// kernel (viterbi_pallas.py:108-113). Lane 0 keeps them in shared memory
// (S x 8 bytes a row). A warp min-reduction with index tie-break gives the
// end state, and lane 0 walks the scalar state back.
//
// Bound on an H100 SXM: at the main path (R = 8,192 rows, S = 192 steps)
// 8,192 x 192 x 64 state-steps of about 8 f32 operations is 0.8 GFLOP
// (~0.012 ms at 67 TFLOP/s) against 12.6 MB read (~0.004 ms): both tiny.
// The kernel is latency-bound on the serial chain of S dependent steps;
// its rows, one warp each, fill the card in about one wave.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float branch(float c, float a0, float a1,
                                        float s0, float s1) {
    return __fadd_rn(__fadd_rn(c, __fmul_rn(a0, s0)), __fmul_rn(a1, s1));
}

// tab: (64, 6) f32 rows [a00 a01 a10 a11 c0 c1] per state
__global__ void viterbi_k7_kernel(const float* __restrict__ win,
                                  unsigned char* __restrict__ bits,
                                  const float* __restrict__ tab,
                                  int R, int S, int keep_from, int flip) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row = blockIdx.x * (blockDim.x >> 5) + warp;
    if (row >= R) return;  // the whole warp leaves together

    float* s_soft = smem + (size_t)warp * 4 * S;              // 2S floats
    unsigned* s_dec = reinterpret_cast<unsigned*>(s_soft + 2 * S);  // 2S

    const float* w = win + (size_t)row * 2 * S;
    for (int i = lane; i < 2 * S; i += 32) s_soft[i] = w[i];
    __syncwarp();

    const int sa = lane, sb = lane + 32;
    const float* ta = tab + sa * 6;
    const float* tb = tab + sb * 6;
    const float a00a = ta[0], a01a = ta[1], a10a = ta[2], a11a = ta[3],
                c0a = ta[4], c1a = ta[5];
    const float a00b = tb[0], a01b = tb[1], a10b = tb[2], a11b = tb[3],
                c0b = tb[4], c1b = tb[5];
    // predecessors of state s: s>>1 (low half) and (s>>1)|32 (high half);
    // state q < 32 lives in lane q as pm_a, state q + 32 in lane q as pm_b
    const int src_a = sa >> 1, src_b = sb >> 1;

    float pm_a = 0.0f, pm_b = 0.0f;
    for (int t = 0; t < S; ++t) {
        const float s0 = s_soft[2 * t], s1 = s_soft[2 * t + 1];
        const float lo_a = __shfl_sync(kFull, pm_a, src_a);
        const float hi_a = __shfl_sync(kFull, pm_b, src_a);
        const float lo_b = __shfl_sync(kFull, pm_a, src_b);
        const float hi_b = __shfl_sync(kFull, pm_b, src_b);
        const float bm0a = branch(c0a, a00a, a01a, s0, s1);
        const float bm0b = branch(c0b, a00b, a01b, s0, s1);
        const float c0a_ = __fadd_rn(lo_a, bm0a);
        const float c0b_ = __fadd_rn(lo_b, bm0b);
        float c1a_, c1b_;
        if (flip) {
            c1a_ = __fadd_rn(__fsub_rn(hi_a, bm0a), 510.0f);
            c1b_ = __fadd_rn(__fsub_rn(hi_b, bm0b), 510.0f);
        } else {
            c1a_ = __fadd_rn(hi_a, branch(c1a, a10a, a11a, s0, s1));
            c1b_ = __fadd_rn(hi_b, branch(c1b, a10b, a11b, s0, s1));
        }
        const bool da = c1a_ < c0a_, db = c1b_ < c0b_;
        pm_a = da ? c1a_ : c0a_;
        pm_b = db ? c1b_ : c0b_;
        const unsigned w0 = __ballot_sync(kFull, da);
        const unsigned w1 = __ballot_sync(kFull, db);
        if (lane == 0) {
            s_dec[2 * t] = w0;
            s_dec[2 * t + 1] = w1;
        }
    }

    // end state: lowest index among the minimal metrics
    float best = pm_a;
    int idx = sa;
    if (pm_b < best) { best = pm_b; idx = sb; }
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, idx, off);
        if (ov < best || (ov == best && oi < idx)) { best = ov; idx = oi; }
    }

    // only lane 0 wrote the decisions, and only lane 0 reads them back
    if (lane == 0) {
        unsigned char* out = bits + (size_t)row * (S - keep_from);
        int s = idx;
        for (int t = S - 1; t >= keep_from; --t) {
            out[t - keep_from] = (unsigned char)(s & 1);
            const unsigned word = s_dec[2 * t + (s >> 5)];
            const int d = (word >> (s & 31)) & 1;
            s = (s >> 1) | (d << 5);
        }
    }
}

}  // namespace

extern "C" {

// Shared memory per warp (one tile row), in bytes.
long long viterbi_smem_per_row(int S) {
    return 16LL * S;
}

// win: contiguous (R, S, 2) f32; bits: contiguous (R, S - keep_from) uint8;
// tab: contiguous (64, 6) f32. Returns cudaGetLastError() after launch.
int viterbi_tiled_k7(const void* win, void* bits, const void* tab, int R,
                     int S, int keep_from, int flip, void* stream) {
    int wpb = 4;  // warps (tile rows) per block
    while (wpb > 1 && viterbi_smem_per_row(S) * wpb > 48 * 1024) wpb >>= 1;
    const long long smem = viterbi_smem_per_row(S) * wpb;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            viterbi_k7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int grid = (R + wpb - 1) / wpb;
    viterbi_k7_kernel<<<grid, 32 * wpb, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)win, (unsigned char*)bits, (const float*)tab, R, S,
        keep_from, flip);
    return (int)cudaGetLastError();
}

const char* viterbi_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

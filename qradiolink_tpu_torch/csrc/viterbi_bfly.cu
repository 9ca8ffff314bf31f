// viterbi_bfly_k7: streamed soft-decision Viterbi for the CCSDS K=7 rate-1/2
// code {109, 79}, butterfly-local add-compare-select with several states a
// thread, the overlapped windows read in place.
//
// Replaces the Pallas TPU kernel qradiolink_tpu/fec/viterbi_pallas.py
// decode_windows -> _kernel (viterbi_pallas.py:83, pallas_call :172) on the
// path TiledViterbi gives it (fec/viterbi_cuda.decode_stream). csrc/viterbi.cu
// (viterbi_tiled_k7) decodes the same windows once they are built.
//
// Function. For each channel, the carried tail `state` (W, 2) and the block
// `soft` (T, 2), contiguous f32 soft values in [0, 255], make the virtual
// stream
//     x  = [state (W) | soft (T) | 128 x pad],  pad = (-(T + W)) mod L,
//     C  = (T + W + pad) / L chunks,   xp = [128 x W | x | 128 x W],
// and window c (0 <= c < C) is xp[c*L : c*L + S], S = L + 2W steps. xp
// index p reads 128 for p < W, state[p - W] for p < 2W, soft[p - 2W] for
// p < 2W + T, else 128 (this also covers T < W). Each window runs
// add-compare-select from zero metrics, takes the lowest natural state index
// among the minimal end metrics and traces back. The decision at step t,
// W <= t < W + L, is the bit of x index c*L + t - W, and goes to
// bits[ch, c*L + t - 2W] when that index lies in [0, T): exactly
// bits[..., W : W + T] of the window composition (fec/viterbi_cuda
// decode_stream_tiled), so no bit is computed and then thrown away by a
// copy. The kernel also writes the new carried tail, x[T : T + W].
//
// Bit-exactness with decode_windows_plain (and viterbi_tiled_k7), on
// non-integer soft values too. Every f32 add, subtract and multiply is
// __fadd_rn / __fsub_rn / __fmul_rn and the file is built with
// --fmad=false, so nothing is contracted. For new state s' the reference
// computes
//     bm0 = (c0 + a00*s0) + a01*s1,   a0i = 1 - 2 e_i,  c0 = 255 (e_0 + e_1),
// where e_i = parity(poly_i & s') is the code's output on the low edge. It
// depends on s' only through the pattern (e_0, e_1), so the kernel computes
// bm0 once a step for each of the 4 patterns, from the same constants and
// inputs in the same order: the value equals the per-state one bit for bit.
// Then cand0 = lo + bm0, cand1 = (hi - bm0) + 510 (each rounded on its own;
// not hi + (510 - bm0), which rounds differently), decision = cand1 < cand0
// (strict) and metric = min(cand0, cand1): the reference's torch.minimum,
// and the same value as `decision ? cand1 : cand0` (no NaN, no -0 arises).
// The end state is the lowest natural index among the minima, whatever
// layout slot it sits in.
//
// Layout. G = 8 threads decode one window row (32/G = 4 rows a warp); each
// holds 64/G = 8 path metrics in registers. A state's 6 bits are spread over
// 6 slots: log2(G) bits of the lane within the row and 6 - log2(G) bits of
// the register index. New states 2j and 2j+1 both come from j and j + 32, so
// a step is local to a thread when state bit 5 sits in a register slot: the
// pair of registers that differ in that slot holds j and j + 32, and the
// step writes 2j and 2j+1 back into the same two registers. The new bit 0
// takes that slot, and every other slot's bit moves up by one. When bit 5
// would sit in a lane slot, one exchange first swaps that lane slot with the
// register slot whose bit is lowest: each thread sends half its registers
// through __shfl_xor_sync (a select, a shuffle and two selects a pair). The
// schedule below repeats after P = 15 steps with 9 exchanges, 0.3 shuffles a
// state-step (viterbi_tiled_k7 needs 2). The step loop is unrolled over one
// period, so every register index is a compile-time constant (a run-time
// index would put the metrics in local memory); steps past S are skipped
// under a uniform test. The 4 branch metrics are permuted a step by the
// lane's share of the pattern (8 selects), and each register takes its
// metric by a compile-time index.
//
// Decisions: each thread packs its 8 decisions of a step into one byte, in
// register order; a warp stores the 32 bytes of a step at once, rows
// interleaved (S x 8 bytes a row). Soft pairs are staged once a row in
// shared memory through the index map above (S x 8 bytes a row), all 24
// loads of a lane issued before any store; a block of 4 warps takes 49 KB
// and 4 blocks fit an SM, so R = 8,192 rows run in one wave. Only the last,
// partial period of the step loop tests t < S. The end state is a
// min-reduction over the row's G lanes. One lane a row then walks the
// traceback, the rows of a warp together, over the period unrolled, so the
// (lane, register) slot of a natural state is a compile-time bit
// permutation and each step waits on one shared load; it stores the kept
// bits straight to bits (..., T).
//
// Bound on an H100 SXM, counted as chip_smoke.py counts it (8 f32
// operations a state-step, each window read once as (R, S, 2) f32 and its
// bits written): R = 8,192 rows x 192 steps (4FSK, 2048 channels x 400
// pairs) 0.81 GFLOP, 0.0120 ms at 67 TFLOP/s; R = 64 (the mixed path's 32
// channels x 200 pairs) 0.094 us. The add-compare-select needs at least 5
// unfused operations a state-step (two adds and a subtract, a compare, a
// min), ~17 us at the 4FSK shape at the card's issue rate; this kernel
// issues about 11 (a count of its operations: the ACS, the four branch
// metrics and their permutation, the exchanges, the decision byte).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, device time, in
// turns with viterbi_tiled_k7 on prebuilt windows): the first design, with
// a guard before every step, a staging loop of dependent loads and a table
// lookup a traceback step, took 0.082 ms at R 8,192 (a tie) and 0.040 ms
// at R 64 (0.018 for viterbi_tiled_k7); PERF.md gives the present one's.
// At R 64 each warp decodes alone on its SM, so the time is one warp's
// latency, and a thread-step here is about three times viterbi_tiled_k7's
// instructions. About half of them run on the half-rate integer/compare
// pipe (the compare, the min and the decision OR a state, the 8 selects of
// the branch-metric permutation, the exchanges' selects), which is what
// holds R 8,192 too. Tried: G = 4 (16 metrics a thread, 8 rows a warp, a
// 20-step schedule with 8 exchanges): slightly faster at R 8,192, much
// slower at R 64; dropped.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kG = 8;  // threads a window row

// The schedule, one row a step of the period: the lane slot and the
// register slot swapped before the step (-1, -1: none), then the natural
// state bit that each of the slots 0..5 holds after the step. Slots
// 0 .. log2(G)-1 are bits of the lane within the row, the rest bits of the
// register index. Before step 0 the slots hold the bits of the last row.
// tests/test_torch_fec.py (bfly_schedule) derives the same tables.
constexpr int kSched8[15][8] = {
    { 2,  0,  4,  5,  1,  0,  2,  3},
    { 1,  0,  5,  1,  2,  0,  3,  4},
    { 0,  0,  1,  2,  3,  0,  4,  5},
    {-1, -1,  2,  3,  4,  1,  5,  0},
    {-1, -1,  3,  4,  5,  2,  0,  1},
    { 2,  1,  4,  5,  1,  3,  0,  2},
    { 1,  1,  5,  1,  2,  4,  0,  3},
    { 0,  1,  1,  2,  3,  5,  0,  4},
    {-1, -1,  2,  3,  4,  0,  1,  5},
    {-1, -1,  3,  4,  5,  1,  2,  0},
    { 2,  2,  4,  5,  1,  2,  3,  0},
    { 1,  2,  5,  1,  2,  3,  4,  0},
    { 0,  2,  1,  2,  3,  4,  5,  0},
    {-1, -1,  2,  3,  4,  5,  0,  1},
    {-1, -1,  3,  4,  5,  0,  1,  2},
};

template <int G>
struct Sched;

template <>
struct Sched<8> {
    static constexpr int P = 15;   // steps a period
    static constexpr int LB = 3;   // lane slots
    __host__ __device__ static constexpr int at(int ph, int i) {
        return kSched8[ph][i];
    }
};

__host__ __device__ constexpr int parity6(int v) {
    v ^= v >> 4;
    v ^= v >> 2;
    v ^= v >> 1;
    return v & 1;
}

// branch-metric pattern of natural state s: bit i is the output of the
// code's polynomial i on the edge from the low predecessor
__host__ __device__ constexpr int pattern(int s) {
    return parity6(s & 109) | (parity6(s & 79) << 1);
}

// b with a 0 bit inserted at position i
__host__ __device__ constexpr int insert0(int b, int i) {
    return ((b >> i) << (i + 1)) | (b & ((1 << i) - 1));
}

// natural bits of the 6 slots after step ph, 3 bits each
template <int G>
__host__ __device__ constexpr unsigned slot_nats(int ph) {
    unsigned out = 0;
    for (int s = 0; s < 6; ++s) out |= unsigned(Sched<G>::at(ph, 2 + s)) << (3 * s);
    return out;
}

// the register slot that holds new bit 0 after step ph (bit 5 before it)
template <int G>
__host__ __device__ constexpr int bfly_reg(int ph) {
    int m = -1;
    for (int s = Sched<G>::LB; s < 6; ++s)
        if (Sched<G>::at(ph, 2 + s) == 0) m = s - Sched<G>::LB;
    return m;
}

// the register index's share of each register's pattern after step ph,
// 2 bits a register
template <int G>
__host__ __device__ constexpr unsigned reg_patterns(int ph) {
    constexpr int LB = Sched<G>::LB;
    unsigned out = 0;
    for (int r = 0; r < 64 / G; ++r) {
        int s = 0;
        for (int i = 0; i < 6 - LB; ++i)
            if ((r >> i) & 1) s |= 1 << Sched<G>::at(ph, 2 + LB + i);
        out |= unsigned(pattern(s)) << (2 * r);
    }
    return out;
}

// natural state of slot (lane g of the row, register r) after step PH
template <int G, int PH>
__device__ __forceinline__ int slot_natural(int g, int r) {
    constexpr unsigned N = slot_nats<G>(PH);
    constexpr int LB = Sched<G>::LB;
    int s = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const int bit = i < LB ? (g >> i) & 1 : (r >> (i - LB)) & 1;
        s |= bit << ((N >> (3 * i)) & 7);
    }
    return s;
}

// slot index g * (64/G) + r of natural state s after step PH: each natural
// bit moved to its slot's bit, all positions compile-time constants
template <int G, int PH>
__device__ __forceinline__ int slot_index(int s) {
    constexpr unsigned N = slot_nats<G>(PH);
    constexpr int LB = Sched<G>::LB;
    int idx = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        const int pos = k < LB ? 6 - LB + k : k - LB;
        idx |= ((s >> ((N >> (3 * k)) & 7)) & 1) << pos;
    }
    return idx;
}

template <int G>
using Dec = typename std::conditional<G == 8, uint8_t, uint16_t>::type;

// Per phase: the block's slot -> natural state table, and the lane's share
// of the pattern (2 bits a phase) in lpack.
template <int G, int PH>
__device__ __forceinline__ void build_phase(unsigned char* s_inv,
                                            uint64_t& lpack, int g) {
    constexpr int NR = 64 / G;
    for (int slot = threadIdx.x; slot < 64; slot += blockDim.x)
        s_inv[PH * 64 + slot] =
            (unsigned char)slot_natural<G, PH>(slot / NR, slot % NR);
    lpack |= uint64_t(pattern(slot_natural<G, PH>(g, 0))) << (2 * PH);
}

template <int G, int... PH>
__device__ __forceinline__ void build_tables(std::integer_sequence<int, PH...>,
                                             unsigned char* s_inv,
                                             uint64_t& lpack, int g) {
    (build_phase<G, PH>(s_inv, lpack, g), ...);
}

// One add-compare-select step t (phase PH of the schedule). Only the last,
// partial period tests t < S (a uniform branch); inside full periods the
// compiler may hoist the soft loads across steps.
template <int G, int PH, bool Tail>
__device__ __forceinline__ void acs_step(float (&pm)[64 / G], int t, int S,
                                         const float2* s_soft, uint64_t lpack,
                                         int g, int q, Dec<G>* s_dec,
                                         int lane) {
    constexpr int NR = 64 / G, RPW = 32 / G;
    if (Tail && t >= S) return;
    const float2 v = s_soft[t * RPW + q];
    float bm[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const int e0 = p & 1, e1 = p >> 1;
        bm[p] = __fadd_rn(__fadd_rn(255.0f * float(e0 + e1),
                                    __fmul_rn(1.0f - 2.0f * float(e0), v.x)),
                          __fmul_rn(1.0f - 2.0f * float(e1), v.y));
    }
    // X[p] = bm[p ^ l], l the lane's share of the pattern at this phase
    const int l = int(lpack >> (2 * PH)) & 3;
    const bool l0 = l & 1, l1 = (l >> 1) & 1;
    const float y0 = l0 ? bm[1] : bm[0], y1 = l0 ? bm[0] : bm[1];
    const float y2 = l0 ? bm[3] : bm[2], y3 = l0 ? bm[2] : bm[3];
    const float X[4] = {l1 ? y2 : y0, l1 ? y3 : y1, l1 ? y0 : y2,
                        l1 ? y1 : y3};

    constexpr int SJ = Sched<G>::at(PH, 0), SI = Sched<G>::at(PH, 1);
    if constexpr (SJ >= 0) {
        // swap lane slot SJ with register slot SI: the thread whose lane
        // bit is y keeps the registers whose slot-SI bit is y and trades
        // the others with its partner
        const bool y = (g >> SJ) & 1;
#pragma unroll
        for (int b = 0; b < NR / 2; ++b) {
            const int r0 = insert0(b, SI), r1 = r0 | (1 << SI);
            const float send = y ? pm[r0] : pm[r1];
            const float recv = __shfl_xor_sync(kFull, send, 1 << SJ);
            pm[r0] = y ? recv : pm[r0];
            pm[r1] = y ? pm[r1] : recv;
        }
    }

    constexpr int M = bfly_reg<G>(PH);
    constexpr unsigned PR = reg_patterns<G>(PH);
    static_assert(M >= 0, "state bit 5 must sit in a register slot");
    unsigned d = 0;
#pragma unroll
    for (int b = 0; b < NR / 2; ++b) {
        // r0 holds j before the step and 2j after it, r1 j + 32 and 2j + 1
        const int r0 = insert0(b, M), r1 = r0 | (1 << M);
        const float lo = pm[r0], hi = pm[r1];
        const float ba = X[(PR >> (2 * r0)) & 3];
        const float bb = X[(PR >> (2 * r1)) & 3];
        const float c0a = __fadd_rn(lo, ba);
        const float c1a = __fadd_rn(__fsub_rn(hi, ba), 510.0f);
        const float c0b = __fadd_rn(lo, bb);
        const float c1b = __fadd_rn(__fsub_rn(hi, bb), 510.0f);
        pm[r0] = fminf(c0a, c1a);
        pm[r1] = fminf(c0b, c1b);
        d |= (c1a < c0a ? 1u : 0u) << r0;
        d |= (c1b < c0b ? 1u : 0u) << r1;
    }
    s_dec[t * 32 + lane] = (Dec<G>)d;
}

template <int G, bool Tail, int... PH>
__device__ __forceinline__ void run_period(std::integer_sequence<int, PH...>,
                                           float (&pm)[64 / G], int base,
                                           int S, const float2* s_soft,
                                           uint64_t lpack, int g, int q,
                                           Dec<G>* s_dec, int lane) {
    (acs_step<G, PH, Tail>(pm, base + PH, S, s_soft, lpack, g, q, s_dec,
                           lane),
     ...);
}

// One traceback step t (phase PH): store the bit of state s when t is a
// kept step inside the block, then step to s's predecessor.
template <int G, int PH>
__device__ __forceinline__ void tb_step(int& s, int t, int S, int L, int W,
                                        int T, int o0, const Dec<G>* dec,
                                        unsigned char* out) {
    constexpr int NR = 64 / G;
    if (t >= S || t < W) return;
    const int o = o0 + t;
    if (t < W + L && o >= 0 && o < T) out[o] = (unsigned char)(s & 1);
    const int idx = slot_index<G, PH>(s);
    const unsigned w = dec[t * 32 + idx / NR];
    s = (s >> 1) | (int((w >> (idx % NR)) & 1u) << 5);
}

template <int G, int... PH>
__device__ __forceinline__ void tb_period(std::integer_sequence<int, PH...>,
                                          int& s, int base, int S, int L,
                                          int W, int T, int o0,
                                          const Dec<G>* dec,
                                          unsigned char* out) {
    constexpr int P = Sched<G>::P;
    (tb_step<G, P - 1 - PH>(s, base + P - 1 - PH, S, L, W, T, o0, dec, out),
     ...);
}

// shared memory: the P x 64 slot table, then per warp its rows' soft
// pairs (S float2 a row) and the decisions (S x 32 lanes x 64/G bits)
template <int G>
__host__ __device__ constexpr int table_bytes() {
    return Sched<G>::P * 64;
}

template <int G>
__host__ __device__ constexpr long long warp_bytes(int S) {
    return (long long)S * (8 * (32 / G) + 32 * (long long)sizeof(Dec<G>));
}

template <int G>
__global__ void __launch_bounds__(128)
viterbi_bfly_kernel(const float2* __restrict__ state,
                    const float2* __restrict__ soft,
                    unsigned char* __restrict__ bits,
                    float2* __restrict__ tail, int n_ch, int T, int L, int W,
                    int C) {
    constexpr int NR = 64 / G, RPW = 32 / G, P = Sched<G>::P;
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = L + 2 * W;
    const int R = n_ch * C;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane % G, q = lane / G;
    unsigned char* s_inv = smem;
    float2* s_soft = reinterpret_cast<float2*>(
        smem + table_bytes<G>() + warp * warp_bytes<G>(S));
    Dec<G>* s_dec = reinterpret_cast<Dec<G>*>(s_soft + RPW * S);

    uint64_t lpack = 0;
    build_tables<G>(std::make_integer_sequence<int, P>{}, s_inv, lpack, g);

    // the new carried tail x[T : T + W]
    const long long n_tail = (long long)n_ch * W;
    for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         k < n_tail; k += (long long)gridDim.x * blockDim.x) {
        const long long ch = k / W;
        const int j = T + int(k - ch * W);
        tail[k] = j < W ? state[ch * W + j] : soft[ch * T + (j - W)];
    }
    __syncthreads();

    const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * RPW;
    if (row0 >= R) return;  // the whole warp leaves together

    // stage the warp's windows through the index map (128 outside x): 32
    // loads a lane in flight, then the stores
    constexpr int kLoads = 32 / RPW;  // a row, a pass
    for (int t0 = 0; t0 < S; t0 += 32 * kLoads) {
        float2 v[RPW][kLoads];
#pragma unroll
        for (int qq = 0; qq < RPW; ++qq) {
            const int row = row0 + qq;
            const int ch = row / C;
            const int pbase = (row - ch * C) * L;
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
                const int t = t0 + u * 32 + lane;
                const int p = pbase + t;
                float2 val = make_float2(128.0f, 128.0f);
                if (row < R && t < S) {
                    if (p >= W && p < 2 * W)
                        val = state[(long long)ch * W + (p - W)];
                    else if (p >= 2 * W && p < 2 * W + T)
                        val = soft[(long long)ch * T + (p - 2 * W)];
                }
                v[qq][u] = val;
            }
        }
#pragma unroll
        for (int qq = 0; qq < RPW; ++qq)
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
                const int t = t0 + u * 32 + lane;
                if (t < S) s_soft[t * RPW + qq] = v[qq][u];
            }
    }
    __syncwarp();

    float pm[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) pm[r] = 0.0f;
    int base = 0;
    for (; base + P <= S; base += P)
        run_period<G, false>(std::make_integer_sequence<int, P>{}, pm, base,
                             S, s_soft, lpack, g, q, s_dec, lane);
    if (base < S)
        run_period<G, true>(std::make_integer_sequence<int, P>{}, pm, base, S,
                            s_soft, lpack, g, q, s_dec, lane);
    __syncwarp();

    // end state: the lowest natural index among the row's minimal metrics
    const int ph_end = (S - 1) % P;
    const unsigned char* inv = s_inv + ph_end * 64 + g * NR;
    float best = pm[0];
    int idx = inv[0];
#pragma unroll
    for (int r = 1; r < NR; ++r) {
        const int s = inv[r];
        if (pm[r] < best || (pm[r] == best && s < idx)) {
            best = pm[r];
            idx = s;
        }
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, idx, off);
        if (ov < best || (ov == best && oi < idx)) {
            best = ov;
            idx = oi;
        }
    }

    // traceback: one lane a row, the kept bits straight to bits (n_ch, T);
    // the period unrolled, so each step's slot map is compile-time
    const int row = row0 + q;
    if (g == 0 && row < R) {
        const int ch = row / C;
        const int o0 = (row - ch * C) * L - 2 * W;  // bits index of step 0
        unsigned char* out = bits + (long long)ch * T;
        int s = idx;
        for (int b = ((S - 1) / P) * P; b >= 0 && b + P > W; b -= P)
            tb_period<G>(std::make_integer_sequence<int, P>{}, s, b, S, L, W,
                         T, o0, s_dec + q * G, out);
    }
}

template <int G>
int launch(const void* state, const void* soft, void* bits, void* tail,
           int n_ch, int T, int L, int W, cudaStream_t stream) {
    constexpr int RPW = 32 / G;
    static int n_sm = 0;
    static long long smem_set = 48 * 1024;
    if (n_sm == 0) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return (int)e;
    }
    const int S = L + 2 * W;
    const int C = (T + W + L - 1) / L;
    const long long warps = ((long long)n_ch * C + RPW - 1) / RPW;
    // up to 4 warps a block, fewer when that leaves SMs without a block
    int wpb = 4;
    while (wpb > 1 && (warps + wpb - 1) / wpb < n_sm) wpb >>= 1;
    while (wpb > 1 && table_bytes<G>() + wpb * warp_bytes<G>(S) > 232448)
        wpb >>= 1;
    const long long smem = table_bytes<G>() + wpb * warp_bytes<G>(S);
    if (smem > smem_set) {
        cudaError_t e = cudaFuncSetAttribute(
            viterbi_bfly_kernel<G>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    const long long grid = (warps + wpb - 1) / wpb;
    viterbi_bfly_kernel<G><<<(unsigned)grid, 32 * wpb, (size_t)smem,
                             stream>>>(
        (const float2*)state, (const float2*)soft, (unsigned char*)bits,
        (float2*)tail, n_ch, T, L, W, C);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a block of one warp, in bytes.
long long viterbi_bfly_smem(int S) {
    return table_bytes<kG>() + warp_bytes<kG>(S);
}

// state: contiguous (n_ch, W, 2) f32; soft: contiguous (n_ch, T, 2) f32;
// bits: contiguous (n_ch, T) uint8; tail: contiguous (n_ch, W, 2) f32, the
// new carried tail. All 8-byte aligned. Returns cudaGetLastError() after
// launch.
int viterbi_bfly_k7(const void* state, const void* soft, void* bits,
                    void* tail, int n_ch, int T, int L, int W, void* stream) {
    if (L < W || W < 0 || T < 0) return (int)cudaErrorInvalidValue;
    return launch<kG>(state, soft, bits, tail, n_ch, T, L, W,
                      (cudaStream_t)stream);
}

const char* viterbi_bfly_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

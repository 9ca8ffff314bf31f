// viterbi_stream_k7: one streamed block of StreamingViterbi (and, with no
// lag, viterbi_decode) for the CCSDS K=7 rate-1/2 code {109, 79}, eight
// lanes a row, eight path metrics a lane in registers.
//
// Not a port of a Pallas kernel: the JAX package runs the streaming
// decoder as per-step lax.scans (qradiolink_tpu/fec/conv.py:132,151-163,
// 217), which XLA compiles into device loops. The plain PyTorch version
// (fec/viterbi_stream_cuda.viterbi_stream_plain) takes about 13 device ops
// a step, so at QPSK250K's 25,064 steps a block the port runs the loops
// here instead. csrc/viterbi_stream_warp.cu (viterbi_stream_warp_k7, one
// warp a row, the polynomials given at launch) decodes the other K=7 codes.
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
// parity(w & poly_i) with w = (pred << 1) | (s' & 1) = s' | (hi << 6): the
// pattern of the hi = 0 edge is linear in the bits of s' (each bit k adds
// contrib(k)), that of the hi = 1 edge is it xor kD. Adds and
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
// Why this design (scripts/loop_chain_floor.py and chip_smoke.py on an
// H100 80GB HBM3 at 700 W; PERF.md). The one-warp design (two states a
// lane, csrc/viterbi_stream_warp.cu) took 488 cycles a step at QPSK250K
// (6.18 ms): its add-compare-select alone, four metric shuffles, the
// select, the adds, a redux.sync minimum over order-keyed floats and two
// ballots, took 236 at 3.9 warps a scheduler, which issued only 126 of
// them (32 SASS instructions a step): the shuffles and the redux, not the
// issue rate, set the pace. The soft pairs' shuffles and the decision
// word's selects took ~190 more, the traceback 63. So this kernel runs
// viterbi_bfly_k7's layout (csrc/viterbi_bfly.cu), 0.3 shuffles a
// state-step for the metrics, with the streaming decoder's metric and
// minimum: 3.74 ms, 297 cycles a step, at one warp a scheduler (2048 rows,
// 4 a warp) and ~108 instructions a step. Its exchanges cost ~1.0 ms and
// its row minimum ~0.9 (--ablate), its traceback 0.35. Taking the minimum
// off the chain (from the class minima of the step before, as
// csrc/viterbi_stream_redux.cu does) doubled the minimum's shuffles and
// gained nothing here (4.31 ms); in the one-warp layout it took 5.45 ms:
// two redux.sync a step cost more than the chain they shorten.
//
// Layout. kG = 8 lanes decode one row (4 rows a warp); each holds 8 path
// metrics in registers. A state's 6 bits sit in 6 slots: 3 bits of the
// lane within the row and 3 of the register index. New states 2j and 2j+1
// both come from j and j + 32, so a step is local to a lane when state bit
// 5 sits in a register slot: the two registers that differ in that slot
// hold j and j + 32, and the step writes 2j and 2j+1 back into them. The
// new bit 0 takes that slot, and every other slot's bit moves up by one.
// When bit 5 would sit in a lane slot, one exchange first swaps that lane
// slot with a register slot: each lane sends half its registers through
// __shfl_xor_sync. kSched (viterbi_bfly_k7's schedule) repeats after kP =
// 15 steps with 9 exchanges: 0.3 shuffles a state-step, against 2 for the
// metrics and 0.03 for the soft pair in the one-warp design. The step loop
// is unrolled over one period, so every register index and slot map is a
// compile-time constant. The 4 branch metrics are computed by every lane
// and permuted by the lane's share of the pattern (lpack), and each
// register takes its two metrics by compile-time indices. The minimum over
// the 64 states is each lane's minimum of its 8 (a tree of depth 3) and
// then a xor-shuffle minimum over the row's 8 lanes.
//
// Memory. The steps run in chunks of kChunk = 60 (4 periods). A chunk's
// soft pairs are loaded into registers during the chunk before (lane g of
// row q takes steps g, g + 8, ...), stored to shared memory, and read by
// every lane of the row (one broadcast load a step). Each lane writes its
// decision byte (bit r for register r) to shared memory each step; after
// the chunk the warp copies the row's 60 8-byte words (byte g for lane g)
// to the scratch decs (B, S_pad) in 16-byte granules. pm1 is stored from
// the step T - 1, in natural order; only the periods that hold step T - 1
// or run past S test t.
//
// Traceback. The end state is each lane's lowest natural index among its
// minima, then a xor-shuffle over the row's lanes (lowest index on ties).
// One lane a row (g = 0) walks it back in slot coordinates: after step t
// the state's slot index is idx = g << 3 | r, its bit 0 sits in the
// register slot M the step wrote, and the predecessor's slot index is idx
// with bit M replaced by the decision bit (word_t >> idx) & 1 and, where
// step t began with an exchange, the two exchanged slots' bits swapped
// back: a few integer operations a step, no table. The words of a chunk
// are copied to shared memory by the whole warp one chunk ahead; the bits
// go to shared memory and then out, 60 bytes a row a chunk.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kG = 8;             // lanes a row
constexpr int kNR = 64 / kG;      // path metrics a lane
constexpr int kLB = 3;            // lane slots
constexpr int kRowsW = 32 / kG;   // rows a warp
constexpr int kP = 15;            // steps a period of the schedule
constexpr int kChunk = 4 * kP;    // steps a chunk
constexpr int kWarps = 4;         // warps a block
constexpr unsigned kPoly0 = 109, kPoly1 = 79;

// viterbi_bfly_k7's schedule, one row a step of the period: the lane slot
// and the register slot swapped before the step (-1, -1: none), then the
// natural state bit that each of the slots 0..5 holds after the step.
// Slots 0..2 are bits of the lane within the row, 3..5 bits of the
// register index. Before step 0 the slots hold the bits of the last row.
// tests/test_torch_fec.py (bfly_schedule) derives the same table.
constexpr int kSched[kP][8] = {
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

// what natural bit k of s' adds to the pattern 2 e_0 + e_1 of the hi = 0
// edge into s'
__host__ __device__ constexpr int contrib(int k) {
    return 2 * int((kPoly0 >> k) & 1u) + int((kPoly1 >> k) & 1u);
}
constexpr int kD = contrib(6);  // the hi = 1 edge's pattern: that xor kD

// the natural bits of the 6 slots after step ph, 3 bits each
__host__ __device__ constexpr unsigned slot_nats(int ph) {
    unsigned out = 0;
    for (int i = 0; i < 6; ++i) out |= unsigned(kSched[ph][2 + i]) << (3 * i);
    return out;
}

// the register slot that holds new bit 0 after step ph (bit 5 before it)
__host__ __device__ constexpr int bfly_reg(int ph) {
    int m = -1;
    for (int i = kLB; i < 6; ++i)
        if (kSched[ph][2 + i] == 0) m = i - kLB;
    return m;
}

// the register index's share of the hi = 0 pattern of each register after
// step ph, 2 bits a register
__host__ __device__ constexpr unsigned reg_patterns(int ph) {
    unsigned out = 0;
    for (int r = 0; r < kNR; ++r) {
        int p = 0;
        for (int i = 0; i < 6 - kLB; ++i)
            if ((r >> i) & 1) p ^= contrib(kSched[ph][2 + kLB + i]);
        out |= unsigned(p) << (2 * r);
    }
    return out;
}

// the compile-time tables of phase PH
template <int PH>
constexpr unsigned kNats = slot_nats(PH);
template <int PH>
constexpr unsigned kRegPat = reg_patterns(PH);
template <int PH>
constexpr int kM = bfly_reg(PH);

// the lane's share of the pattern after the step whose slots hold N
__device__ __forceinline__ int lane_pattern(unsigned N, int g) {
    int p = 0;
#pragma unroll
    for (int i = 0; i < kLB; ++i)
        if ((g >> i) & 1) p ^= contrib((N >> (3 * i)) & 7);
    return p;
}

// natural state of slot (lane g, register r) under the slots N
__device__ __forceinline__ int slot_natural(unsigned N, int g, int r) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const int bit = i < kLB ? (g >> i) & 1 : (r >> (i - kLB)) & 1;
        s |= bit << ((N >> (3 * i)) & 7);
    }
    return s;
}

// slot index g << 3 | r of natural state s under the slots N
__device__ __forceinline__ int slot_index(unsigned N, int s) {
    int idx = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const int pos = i < kLB ? 6 - kLB + i : i - kLB;
        idx |= ((s >> ((N >> (3 * i)) & 7)) & 1) << pos;
    }
    return idx;
}

// slot_nats(ph) for a run-time phase
template <int... PH>
__device__ __forceinline__ unsigned nats_of(std::integer_sequence<int, PH...>,
                                            int ph) {
    unsigned v = 0;
    ((v = ph == PH ? kNats<PH> : v), ...);
    return v;
}

__device__ __forceinline__ unsigned nats_at(int ph) {
    return nats_of(std::make_integer_sequence<int, kP>{}, ph);
}

// the lane's pattern share of every phase, 2 bits a phase
template <int... PH>
__device__ __forceinline__ unsigned lane_patterns(
        std::integer_sequence<int, PH...>, int g) {
    unsigned v = 0;
    ((v |= unsigned(lane_pattern(kNats<PH>, g)) << (2 * PH)), ...);
    return v;
}

__device__ __forceinline__ int insert0(int b, int i) {
    return ((b >> i) << (i + 1)) | (b & ((1 << i) - 1));
}

// what a step needs besides the metrics: the row's chunk of soft pairs and
// of decision bytes in shared memory (this lane's byte), the lane, its
// pattern shares, the block's steps and pm1's row (null off the block's
// rows)
struct Ctx {
    const float2* soft;   // s_soft row, step j of the chunk at [j]
    uint8_t* dec;         // s_dec row + g, step j at [j * kG]
    float* pm1;
    unsigned lpack;
    int g, S, Tm1;
};

// One add-compare-select step t (phase PH), step j of its chunk. Only the
// periods holding step T - 1 or running past S test t (Check).
template <int PH, bool Check>
__device__ __forceinline__ void acs_step(float (&pm)[kNR], int t, int j,
                                         const Ctx& c) {
    if (Check && t >= c.S) return;
    const float2 v = c.soft[j];
    const float f0 = __fsub_rn(255.0f, v.x);
    const float f1 = __fsub_rn(255.0f, v.y);
    // X[p] = bm[p ^ l], l the lane's share of the pattern at this phase,
    // bm[q] = (q & 2 ? f0 : x0) + (q & 1 ? f1 : x1): the terms chosen by
    // l's bits, then added as bm's are
    const int l = int(c.lpack >> (2 * PH)) & 3;
    const bool l0 = l & 1, l1 = (l >> 1) & 1;
    const float a0 = l1 ? f0 : v.x, a1 = l1 ? v.x : f0;
    const float b0 = l0 ? f1 : v.y, b1 = l0 ? v.y : f1;
    const float X[4] = {__fadd_rn(a0, b0), __fadd_rn(a0, b1),
                        __fadd_rn(a1, b0), __fadd_rn(a1, b1)};

    constexpr int SJ = kSched[PH][0], SI = kSched[PH][1];
    if constexpr (SJ >= 0) {
        // swap lane slot SJ with register slot SI: the lane whose slot-SJ
        // bit is y keeps the registers whose slot-SI bit is y and trades
        // the others with its partner
        const bool y = (c.g >> SJ) & 1;
#pragma unroll
        for (int b = 0; b < kNR / 2; ++b) {
            const int r0 = insert0(b, SI), r1 = r0 | (1 << SI);
            const float send = y ? pm[r0] : pm[r1];
            const float recv = __shfl_xor_sync(kFull, send, 1 << SJ);
            pm[r0] = y ? recv : pm[r0];
            pm[r1] = y ? pm[r1] : recv;
        }
    }

    constexpr int M = kM<PH>;
    constexpr unsigned PR = kRegPat<PH>;
    static_assert(M >= 0, "state bit 5 must sit in a register slot");
    unsigned d = 0;
#pragma unroll
    for (int b = 0; b < kNR / 2; ++b) {
        // r0 holds j before the step and 2j after it, r1 j + 32 and 2j + 1
        const int r0 = insert0(b, M), r1 = r0 | (1 << M);
        const float lo = pm[r0], hi = pm[r1];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int r = k ? r1 : r0;
            const int p = int(PR >> (2 * r)) & 3;
            const float c0 = __fadd_rn(lo, X[p]);
            const float c1 = __fadd_rn(hi, X[p ^ kD]);
            const bool dec = c1 < c0;
            pm[r] = dec ? c1 : c0;
            d |= (dec ? 1u : 0u) << r;
        }
    }
    c.dec[j * kG] = (uint8_t)d;
    // the minimum over the row's 64 states: the lane's 8 (a tree), then
    // its row's 8 lanes
    float m = fminf(fminf(fminf(pm[0], pm[1]), fminf(pm[2], pm[3])),
                    fminf(fminf(pm[4], pm[5]), fminf(pm[6], pm[7])));
#pragma unroll
    for (int o = 1; o < kG; o <<= 1)
        m = fminf(m, __shfl_xor_sync(kFull, m, o));
#pragma unroll
    for (int r = 0; r < kNR; ++r) pm[r] = __fsub_rn(pm[r], m);
    if (Check && t == c.Tm1 && c.pm1) {
        constexpr unsigned N = kNats<PH>;
#pragma unroll
        for (int r = 0; r < kNR; ++r) c.pm1[slot_natural(N, c.g, r)] = pm[r];
    }
}

template <bool Check, int... PH>
__device__ __forceinline__ void acs_period(std::integer_sequence<int, PH...>,
                                           float (&pm)[kNR], int t0, int j0,
                                           const Ctx& c) {
    (acs_step<PH, Check>(pm, t0 + PH, j0 + PH, c), ...);
}

// One traceback step t (phase PH), step j of its chunk: the bit of the
// state (slot index idx) to the row's bits in shared memory when t < T,
// then to the predecessor's slot index. Only the periods that reach T test
// t (Check).
template <int PH, bool Check>
__device__ __forceinline__ void tb_step(int& idx, int t, int j, int S, int T,
                                        const unsigned long long* words,
                                        uint8_t* out) {
    if (Check && t >= S) return;
    constexpr int M = kM<PH>;
    constexpr int SJ = kSched[PH][0], SI = kSched[PH][1];
    if (!Check || t < T) out[j] = (uint8_t)((idx >> M) & 1);
    // the decision bit in bit 0 of w
    const int w = int(words[j] >> idx);
    if constexpr (SJ >= 0) {
        // the step swapped lane slot SJ (index bit a) with register slot
        // SI = M, then wrote M: the predecessor's index has the decision
        // in bit a and index bit a in bit M, the rest as it is (the part
        // beside the decision computed off the chain)
        static_assert(SI == M, "an exchange moves bit 5 to the slot M");
        constexpr int a = 6 - kLB + SJ;
        const int rest = (idx & ~((1 << M) | (1 << a))) |
                         (((idx >> a) & 1) << M);
        idx = rest | ((w & 1) << a);
    } else {
        idx = (idx & ~(1 << M)) | ((w & 1) << M);
    }
}

template <bool Check, int... PH>
__device__ __forceinline__ void tb_period(std::integer_sequence<int, PH...>,
                                          int& idx, int t0, int j0, int S,
                                          int T,
                                          const unsigned long long* words,
                                          uint8_t* out) {
    (tb_step<kP - 1 - PH, Check>(idx, t0 + kP - 1 - PH, j0 + kP - 1 - PH, S,
                                 T, words, out),
     ...);
}

// lane g of row q loads steps g + 8u (u < 8, < kChunk) of its row's chunk
// c0 (zeros off x and off the block's rows)
__device__ __forceinline__ void load_soft(float2 (&v)[8],
                                          const float2* __restrict__ tail,
                                          const float2* __restrict__ soft,
                                          int row, bool valid, int T,
                                          int lag, int t0, int g) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int t = t0 + g + 8 * u;
        float2 x = make_float2(0.0f, 0.0f);
        if (valid && g + 8 * u < kChunk && t < lag + T)
            x = t < lag ? tail[(size_t)row * lag + t]
                        : soft[(size_t)row * T + (t - lag)];
        v[u] = x;
    }
}

// lane g of row q loads granules g + 8u (u < 4, < 30) of its row's chunk of
// decision words in the scratch
__device__ __forceinline__ void load_words(uint4 (&w)[4],
                                           const unsigned long long* row_decs,
                                           bool valid, int t0, int g) {
    const uint4* src = reinterpret_cast<const uint4*>(row_decs + t0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int o = g + 8 * u;
        w[u] = (valid && o < kChunk / 2) ? src[o] : make_uint4(0, 0, 0, 0);
    }
}

__global__ void __launch_bounds__(kWarps * 32)
viterbi_stream_kernel(const float2* __restrict__ tail,
                      const float2* __restrict__ soft,
                      const float* __restrict__ pm0, float* __restrict__ pm1,
                      unsigned long long* __restrict__ decs,
                      uint8_t* __restrict__ bits, int B, int T, int lag,
                      int S_pad) {
    // per warp and row: a chunk of soft pairs, of decision bytes (and, in
    // the traceback, of decision words), of bits
    __shared__ __align__(16) float2 s_soft[kWarps][kRowsW][kChunk];
    __shared__ __align__(16) uint8_t s_dec[kWarps][kRowsW][kChunk * kG];
    __shared__ uint8_t s_bits[kWarps][kRowsW][kChunk];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q = lane / kG, g = lane % kG;
    const int row0 = (blockIdx.x * kWarps + warp) * kRowsW;
    if (row0 >= B) return;  // the whole warp leaves together
    const int row = row0 + q;
    const bool valid = row < B;
    const int S = lag + T;
    const int n_chunks = (S + kChunk - 1) / kChunk;
    unsigned long long* row_decs = decs + (size_t)row * S_pad;

    Ctx c;
    c.soft = s_soft[warp][q];
    c.dec = s_dec[warp][q] + g;
    c.pm1 = valid ? pm1 + (size_t)row * 64 : nullptr;
    c.lpack = lane_patterns(std::make_integer_sequence<int, kP>{}, g);
    c.g = g;
    c.S = S;
    c.Tm1 = T - 1;

    // the metrics in the layout before step 0 (the period's last row)
    float pm[kNR];
    {
        constexpr unsigned N = kNats<kP - 1>;
#pragma unroll
        for (int r = 0; r < kNR; ++r) {
            const int s = slot_natural(N, g, r);
            pm[r] = valid ? pm0[(size_t)row * 64 + s] : 0.0f;
            if (T == 0 && valid) pm1[(size_t)row * 64 + s] = pm[r];
        }
    }

    float2 v[8];
    load_soft(v, tail, soft, row, valid, T, lag, 0, g);
    for (int ch = 0; ch < n_chunks; ++ch) {
        const int t0 = ch * kChunk;
        __syncwarp();  // the chunk before is read and flushed
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (g + 8 * u < kChunk) s_soft[warp][q][g + 8 * u] = v[u];
        __syncwarp();
        // the next chunk's pairs, in flight while this chunk runs
        load_soft(v, tail, soft, row, valid, T, lag, t0 + kChunk, g);
        for (int p = 0; p < kChunk / kP; ++p) {
            const int tp = t0 + p * kP;
            if (tp >= S) break;
            if (tp + kP <= S && (c.Tm1 < tp || c.Tm1 >= tp + kP))
                acs_period<false>(std::make_integer_sequence<int, kP>{}, pm,
                                  tp, p * kP, c);
            else
                acs_period<true>(std::make_integer_sequence<int, kP>{}, pm,
                                 tp, p * kP, c);
        }
        __syncwarp();
        // the chunk's decision words to the scratch, 16-byte granules
        if (valid) {
            uint4* dst = reinterpret_cast<uint4*>(row_decs + t0);
            const uint4* src = reinterpret_cast<const uint4*>(s_dec[warp][q]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int o = g + 8 * u;
                if (o < kChunk / 2) dst[o] = src[o];
            }
        }
    }

    // end state: the lowest natural index among the row's minimal metrics
    const unsigned NE = nats_at((S - 1) % kP);
    float best = pm[0];
    int s_end = slot_natural(NE, g, 0);
#pragma unroll
    for (int r = 1; r < kNR; ++r) {
        const int s = slot_natural(NE, g, r);
        if (pm[r] < best || (pm[r] == best && s < s_end)) {
            best = pm[r];
            s_end = s;
        }
    }
#pragma unroll
    for (int off = 1; off < kG; off <<= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int os = __shfl_xor_sync(kFull, s_end, off);
        if (ob < best || (ob == best && os < s_end)) {
            best = ob;
            s_end = os;
        }
    }
    __syncwarp();  // the warp's scratch stores are visible to its loads

    // traceback, a chunk at a time from the last; lane g = 0 of a row walks
    int idx = slot_index(NE, s_end);
    const unsigned long long* words =
        reinterpret_cast<const unsigned long long*>(s_dec[warp][q]);
    uint8_t* out = s_bits[warp][q];
    uint4 w[4];
    load_words(w, row_decs, valid, (n_chunks - 1) * kChunk, g);
    for (int ch = n_chunks - 1; ch >= 0; --ch) {
        const int t0 = ch * kChunk;
        uint4* dst = reinterpret_cast<uint4*>(s_dec[warp][q]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (g + 8 * u < kChunk / 2) dst[g + 8 * u] = w[u];
        __syncwarp();
        if (ch > 0) load_words(w, row_decs, valid, t0 - kChunk, g);
        if (g == 0) {
            for (int p = kChunk / kP - 1; p >= 0; --p) {
                const int tp = t0 + p * kP;
                if (tp >= S) continue;
                if (tp + kP <= T)
                    tb_period<false>(std::make_integer_sequence<int, kP>{},
                                     idx, tp, p * kP, S, T, words, out);
                else
                    tb_period<true>(std::make_integer_sequence<int, kP>{},
                                    idx, tp, p * kP, S, T, words, out);
            }
        }
        __syncwarp();
        // the chunk's bits below T, coalesced a row
        if (valid) {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int j = g + 8 * u;
                if (j < kChunk && t0 + j < T)
                    bits[(size_t)row * T + t0 + j] = out[j];
            }
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" {

// Steps of scratch a row (a multiple of the chunk) for S = lag + T steps.
int viterbi_stream_scratch_steps(int S) {
    return (S + kChunk - 1) / kChunk * kChunk;
}

// tail: contiguous (B, lag, 2) f32; soft: contiguous (B, T, 2) f32; pm0,
// pm1: (B, 64) f32; decs: (B, viterbi_stream_scratch_steps(lag + T))
// 64-bit scratch, 16-byte aligned; bits: (B, T) u8. poly0, poly1 must be
// the CCSDS code's. Returns a CUDA error code, 0 after a clean launch.
int viterbi_stream_k7(const void* tail, const void* soft, const void* pm0,
                      void* pm1, void* decs, void* bits, int B, int T,
                      int lag, int poly0, int poly1, void* stream) {
    if (B < 1 || T < 0 || lag < 0 || lag + T < 1 ||
        (unsigned)poly0 != kPoly0 || (unsigned)poly1 != kPoly1)
        return (int)cudaErrorInvalidValue;
    const int warps = (B + kRowsW - 1) / kRowsW;
    const int blocks = (warps + kWarps - 1) / kWarps;
    viterbi_stream_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const float2*)tail, (const float2*)soft, (const float*)pm0,
        (float*)pm1, (unsigned long long*)decs, (uint8_t*)bits, B, T, lag,
        viterbi_stream_scratch_steps(lag + T));
    return (int)cudaGetLastError();
}

const char* viterbi_stream_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

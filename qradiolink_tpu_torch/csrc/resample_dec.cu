// resample_dec_f32: the streaming polyphase rational resampler at its
// decimating shapes (ops/cuda_resample.route: DMR's 3/125 head at 2,091
// taps a phase, M17's 3/125 at 349, MMDVM's RX 12/125 at 523, the 2/25
// heads at 105 and 561; and at L 1, through ops/cuda_fir.route, the
// K2239 D50 head of GMSK2K, 2FSK2K, AM and NBFM and SSB's K5597 D125
// head), every phase of one or two f32 planes in one launch, the outputs
// interleaved and the new tail state written by the same launch (or none:
// the strided FIR's call keeps its own). Two forms: the polyphase columns
// below (QRL_DEC_INSTANCES), and at the 2/25 K561 head the taps-in-order
// form further down (QRL_DEC_SEQ_INSTANCES), which keeps
// resample_poly_f32's bits.
//
// Replaces, at those shapes, the Pallas TPU kernel of
// qradiolink_tpu/ops/pallas_fir.py `banded_fir_stream` -> `_stream_call`
// (pallas_fir.py:218), which the JAX package's RationalResampler
// (qradiolink_tpu/ops/resample.py `_phases`) runs once a phase with its
// `extra_shift`. Before this kernel DMR's head ran fir_long_f32 once a
// phase, each launch over the whole input, then an interleave (four device
// operations), and the others resample_poly_f32 (csrc/resample_poly.cu),
// one output a lane with two shared loads for each FMA.
//
// Function, over the virtual stream xc = [tail (K-1) | x (T)] of each row,
// T = n_pp * M, with tf_r the flipped taps of phase r (row r of `taps`) and
// q_r = floor(r*M/L):
//     y[t*L + r] = sum_{j<K} tf_r[j] * xc[t*M + q_r + j],
//         t in [0, n_pp), r in [0, L)
//     state[plane][j] = xc[T + j], j in [0, K-1)
// With one plane (real input) the state's second plane is zeros.
//
// Polyphase-column form. Cut phase r's stream into rows of M samples from
// its offset, X_r[m][c] = xc[m*M + q_r + c], and its taps into A =
// ceil(K/M) rows, tap j at row j / M, column j % M. Then
//     y[t*L + r] = sum_{a<A} sum_{c<M} tf_r[a*M + c] * X_r[t + a][c]:
// each sample of a row meets tap row a of its column for output t = m - a.
// The phases' rows are one stream of rows of M read q_r samples on (their
// column rotation), so one staged copy of the row serves every phase.

// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), 2 planes: DMR's head, 2048 x 200,000 -> 4,800, 82.2 GFLOP,
// 1.227 ms (operations); M17's, the same rows, 3.37 GB, 1.005 ms (bytes);
// 12/125 K523 at 256 x 250,000 -> 24,000, 0.192 ms (operations).
//
// Design: block (piece, row, plane) owns `piece` consecutive output times
// [t_lo, t_hi) of one row-plane, every phase of them; its warps split the
// tap rows and columns: warp (r, g, s) = r*G*S + g*S + s holds rows
// [s*AS, s*AS + AS) of phase r (S = ceil(A/AS) segments) in column group
// g, lane l the columns c = 32*CW*g + l + 32k, k < CW (G = ceil(M/(32 CW))
// groups), its taps tf_r[(s*AS + a)*M + c] in registers (AS and CW
// template parameters, zero past K or M). No tap is loaded in the loop.
// At DMR's head (A 17: 2 segments of 9 rows, 2 groups of 64 columns),
// GMSK2K's (A 45: 3 of 15, one group) and SSB's (A 45: 3 of 15, 2 groups
// of 64) these are fir_long_f32's segments, groups and columns for the
// same FIR, and with its sum order the outputs equal that kernel's bit for
// bit: DMR's chain gives the bits it gave on
// the per-phase route, which its card-against-CPU gate holds. (The first
// design here, rows of the sample grid with each phase's taps shifted by
// q_r and 4 columns a lane, summed in another order: DMR's chain on 4
// rows then decided 27 bits of a block apart from its CPU path, on one
// symbol-timing slip; scripts/fsk4_head_bits.py.)
//   * The block streams its rows through a ring of R chunk buffers in
//     shared memory (R an instance parameter), kTile rows (kTile*M
//     samples, and the q_max + lane columns past M that the phases read of
//     the next row) a chunk, loaded with cp.async 16 bytes a copy where x
//     is 16-byte aligned (4 bytes at the tail/x seam and the stream's end,
//     zeros past it), a chunk staged R - 2 chunks ahead of the one
//     computed. Each sample of the block's span is read from device
//     memory once for all phases and rows (a chunk's last q_max +
//     over_cols words twice).
//   * Chunk j (rows R0 .. R0 + kTile - 1, R0 = t_lo + j*kTile): warp
//     (r, g, s) computes the kTile outputs t = R0 + o - s*AS, o < kTile,
//     of its segment, from rows R0 .. R0 + kTile + AS - 2 (the last AS - 1
//     from chunk j + 1's buffer), each read from q_r on: the row loop is
//     unrolled, so every output's accumulator (acc[o], kTile of them) and
//     tap index is a compile-time constant. A row's CW samples (one
//     shared load each, consecutive lanes on consecutive words; lanes past
//     M read the next row's samples against zero taps, no select) feed
//     AS*CW FMAs, the columns outer so that consecutive FMAs go to
//     distinct outputs. Where the last segment's last row holds no tap
//     (DMR's row 17, 2FSK10K's row 23) and the last segments are at least
//     half the warps, they run a body one row shorter.
//   * The lanes' partials leave through a transpose tile a warp (kTile rows
//     of kTileStride floats): lane l stores acc[o] at [o][l], then sums row
//     l, lanes 0 .. 31 in order, and writes the warp's partial of output
//     R0 + l - s*AS into its row of a ring of kOutRing outputs.
//   * One barrier a chunk. After it the block adds, for the window of
//     outputs every segment has finished (R0 - (S-1)*AS .. + kTile - 1 of
//     the chunk before), the G*S warps' partials of each (output, phase)
//     in order w = g*S + s and stores y with coalesced stores, t*L + r.
//   * Loads an FMA at DMR's head: 40 rows of 2 loads for 576 FMAs a warp's
//     chunk, 0.14 (resample_poly_f32: 2; fir_long_f32 loads its X rows
//     from L1/L2 a segment at a time, and each phase's launch reads all of
//     x).
// Sum order, per output: in each lane rows a ascending, a row's columns k
// ascending (fmaf from 0.0f), then lanes 0 .. 31 from 0.0f, then warps g*S
// + s ascending: fir_long_f32's. No atomics: every run gives the same
// bits. It is not resample_poly_f32's order (j = 0 .. K-1), so the outputs
// are held to the FIR's bound of the plain version (and at DMR's and
// GMSK2K's heads to fir_long_f32's bits); the state is copied and equal.
// Non-finite input reaches the outputs that a zero tap touches (0 * Inf),
// beyond the plain version's.
//
// What binds (NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.py and
// scripts/resample_dec_variants.py, ms in turns): instruction issue, not
// occupancy. DMR's head takes 3.01 ms, 40.7% of its bound: a warp's chunk
// is about 750 instructions for its 576 FMAs (80 loads, ~75 for the lane
// sums, the staging and the window's adds), and 1 of the 18 tap rows and
// 3 of the 128 lane columns are zero taps. Measured with earlier states of
// this source: the first layout, 6 warps of 4 columns a lane, 2.62 ms
// (it changed DMR's bits, above); there 18 warps an SM (96 registers)
// against 12 ran 2.67 against 2.62 ms, segments of 6 rows 3.09 and of 18
// 3.23, two passes of 16 outputs 2.80 against 2.61, a select for the
// lanes past M 4% slower. In this layout one block an SM (no register
// cap) 3.31 against 2.99, the full body on every warp 3.08; M17 with 3
// chunk buffers (3 blocks an SM) 1.30 against 1.40 with 4.
//
// The K2239 D50 head at L 1 (2048 x 200,000 and 256 x 1,000,000; 3 warps
// a block, segments of 15 rows, one group of 64 columns, as fir_long_f32,
// whose bits it keeps): 14 of the 64 lane columns hold zero taps (D 50),
// so 22% of its FMAs add nothing, and the layout that keeps the bits
// cannot drop them; from its first FFMA to its last the kernel is 1.09
// instructions an FFMA (scripts/resample_dec_variants.py --sass). In turns
// (that script, an H100 80GB HBM3 at 700 W, the SM at 1,980 MHz): the
// source before this route 2.62 / 1.83 ms; a row a block left 2FSK2K's 512 row-planes 1.55
// waves of 5 resident blocks an SM, so this instance's pieces come from
// piece_waves (waves x chunks a block, RULE 1); with L and S fixed at
// compile time (LC, SC: the window's divisions and loops fold away; the
// window's adds and the staging took 7.2% and 9.0% of GMSK2K's time,
// ablated, at run-time L and S) 2.48 / 1.54, at run-time L and S 2.60 /
// 1.62. Fixed for every instance they spilled DMR's and MMDVM's (12 warps,
// a cap of 80 registers). 5 blocks an SM, 3 or 6 chunk buffers and tiles
// of 64 outputs did not help (64: 3.79, the registers and tiles cut the
// blocks an SM to 2-3).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // output times a warp's tile (a multiple
                                 // of 32); rows a chunk
constexpr int kMaxWarps = 16;    // warps a block, at most
constexpr int kTileStride = 36;  // floats a transpose-tile row: 16-byte rows
constexpr int kOutRing = 128;    // outputs a warp's partials ring holds
constexpr int kRuleBlocks = 4;   // blocks an SM the piece rule aims at
constexpr int kMaxPieces = 64;   // pieces a row-plane the waves rule tries
constexpr int kMaxDev = 64;      // devices whose SM count is kept

// largest phase offset q_r = floor(r*M/L), r < L
__host__ __device__ constexpr int q_max(int L, int M) {
    return (L - 1) * M / L;
}

// rows of M samples a phase's taps span: A = ceil(K/M)
__host__ __device__ constexpr int tap_rows(int M, int K) {
    return (K + M - 1) / M;
}

// column groups of 32 CW columns (CW a lane) that cover a row of M
__host__ __device__ constexpr int col_groups(int M, int CW) {
    return (M + 32 * CW - 1) / (32 * CW);
}

// lane columns past a row's M: their taps are zero, their loads read the
// next row's first samples
__host__ __device__ constexpr int over_cols(int M, int CW) {
    return 32 * CW * col_groups(M, CW) - M;
}

// words a chunk stages past its lead: kTile rows, then what the phases'
// offsets and the lanes past M read of the next row
__host__ __device__ constexpr int stage_words(int L, int M, int CW) {
    return kTile * M + q_max(L, M) + over_cols(M, CW);
}

// floats a chunk buffer: a lead of up to 3 words (16-byte copies) and the
// staged words, in whole 16-byte groups
__host__ __device__ constexpr int buf_words(int L, int M, int CW) {
    return (stage_words(L, M, CW) + 6) / 4 * 4;
}

// warps a phase: column groups x segments of AS tap rows, w = g*S + s
__host__ __device__ constexpr int phase_warps(int M, int K, int AS,
                                              int CW) {
    return col_groups(M, CW) * ((tap_rows(M, K) + AS - 1) / AS);
}

// R chunk buffers, then each warp's transpose tile and partials ring
__host__ __device__ constexpr long long smem_words(int L, int M, int CW,
                                                  int W, int R) {
    return (long long)R * buf_words(L, M, CW) +
           (long long)W * (kTile * kTileStride + kOutRing);
}

// The instances: X(L, M, K, AS tap rows a segment, CW columns a lane, R
// chunk buffers, blocks an SM the registers must allow, piece rule: 0
// blocks an SM (piece_len), 1 whole waves (piece_waves)). DMR's, GMSK2K's
// and SSB's take fir_long_f32's segments, column groups of 64 and sum
// order, so their outputs equal that kernel's bit for bit. R 3 stages a
// chunk one ahead of the one computed, R 4 two. SSB's 6 warps stage 4,003
// words a chunk: 78,816 bytes a block at R 3, 2 blocks an SM.
#define QRL_DEC_INSTANCES(X)                                                \
    X(3, 125, 2091, 9, 2, 3, 2, 0)   /* DMR's head: 2 x 2 warps a phase */  \
    X(3, 125, 349, 3, 4, 3, 2, 0)    /* M17's head: a warp a phase */       \
    X(12, 125, 523, 5, 4, 3, 2, 0)   /* MMDVM's RX: a warp a phase */       \
    X(2, 25, 105, 5, 1, 4, 8, 0)     /* 4FSK10KFM's head: a warp a phase */ \
    X(1, 50, 2239, 15, 2, 4, 4, 1)   /* the K2239 D50 head (L 1) */    \
    X(1, 125, 5597, 15, 2, 3, 2, 1)  /* SSB's K5597 D125 head (L 1) */

// The taps-in-order instances: X(L, M, K, RPL rows a lane, CR rows of M a
// chunk, R chunk buffers, blocks an SM the registers must allow).
#define QRL_DEC_SEQ_INSTANCES(X)                                            \
    X(2, 25, 561, 1, 4, 2, 8)  /* the 2/25 heads of 2FSK10K, GMSK10K */

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest R - 3 has landed
template <int R>
__device__ __forceinline__ void cp_async_wait_chunks() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(R - 3) : "memory");
}

// One warp's sums of a chunk: kTile outputs o from 0.0f, row i (rows of pa,
// then pb's first) feeding output o = i - a at tap row a < NR; each output
// adds its rows in order and a row's columns in order. Lanes past a row's
// M load the next row's samples and multiply them by zero taps.
template <int CW, int AS, int NR, int M>
__device__ __forceinline__ void row_sums(const float* pa, const float* pb,
                                         const float (&h)[AS][CW],
                                         float (&acc)[kTile]) {
#pragma unroll
    for (int o = 0; o < kTile; ++o) acc[o] = 0.0f;
#pragma unroll
    for (int i = 0; i < kTile + NR - 1; ++i) {
        const float* p = i < kTile ? pa + i * M : pb + (i - kTile) * M;
        float xv[CW];
#pragma unroll
        for (int k = 0; k < CW; ++k) xv[k] = p[32 * k];
        // columns outer: consecutive FMAs go to distinct outputs
#pragma unroll
        for (int k = 0; k < CW; ++k) {
#pragma unroll
            for (int a = 0; a < NR; ++a) {
                const int o = i - a;
                if (o >= 0 && o < kTile)
                    acc[o] = fmaf(h[a][k], xv[k], acc[o]);
            }
        }
    }
}

// NT = 32 W threads a block (W = L phase_warps of the instance); MINB
// blocks an SM; LC, SC: L and S fixed at compile time where nonzero (the
// K2239 D50 head; the other instances take them at run time: DMR's
// spilled at its cap of 80 registers with them fixed)
template <int M, int AS, int CW, int R, int NT, int MINB, int LC, int SC>
__global__ void __launch_bounds__(NT, MINB)
resample_dec_kernel(const float* __restrict__ tail0,
                    const float* __restrict__ tail1, int tail_ld,
                    const float* __restrict__ x0,
                    const float* __restrict__ x1,
                    const float* __restrict__ taps, float* __restrict__ y0,
                    float* __restrict__ y1, float* __restrict__ state, int C,
                    int T, int K, int L_rt, int S_rt, int n_pp, int piece,
                    int n_pieces, int planes, int aligned, int shorten) {
    constexpr int G = col_groups(M, CW);
    constexpr int W = NT / 32;
    extern __shared__ __align__(16) float smem[];
    const int L = LC ? LC : L_rt;
    const int S = SC ? SC : S_rt;
    const int WP = G * S;  // warps a phase
    const int BW = buf_words(L, M, CW);
    float* s_buf = smem;                                  // R x BW
    float* s_tile = smem + R * BW;                        // W x kTile rows
    float* s_out = s_tile + W * kTile * kTileStride;      // W x kOutRing

    const int pc = (int)(blockIdx.x % (unsigned)n_pieces);
    const int rp = (int)(blockIdx.x / (unsigned)n_pieces);
    const int plane = rp / C;
    const int row = rp - plane * C;
    const float* tail = (plane ? tail1 : tail0) + (size_t)row * tail_ld;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;
    float* y = (plane ? y1 : y0) + (size_t)row * n_pp * L;
    const int k1 = K - 1;
    const long long n_in = (long long)k1 + T;

    // the row's first piece copies xc[T .. T+K-2] into the new state (none
    // where the caller keeps its own: state null)
    if (pc == 0 && state) {
        float* st = state + ((size_t)row * 2 + plane) * k1;
        for (int j = threadIdx.x; j < k1; j += NT) {
            const long long v = (long long)T + j;
            st[j] = v < k1 ? tail[v] : x[v - k1];
            if (planes == 1) st[k1 + j] = 0.0f;
        }
    }
    const int t_lo = pc * piece;
    if (t_lo >= n_pp) return;  // n_pp == 0: only the state
    const int t_hi = min(n_pp, t_lo + piece);
    const int a_last = (S - 1) * AS;  // the last segment's first row
    // chunks computed; chunk n_c is staged for its first AS - 1 rows
    const int n_c = (t_hi - t_lo + a_last + kTile - 1) / kTile;

    // chunk j: xc[vb + j kTile M - lead ..) into buffer j mod R, where the
    // lead puts x's words on 16-byte boundaries (the same for every chunk:
    // kTile M is a multiple of 4); a chunk inside x, 16 bytes a copy
    const long long vb = (long long)t_lo * M;
    const int lead = (int)(((vb - k1) % 4 + 4) % 4);
    const int n_g = (lead + stage_words(L, M, CW) + 3) / 4;
    const auto stage = [&](int j) {
        float* dst = s_buf + (j % R) * BW;
        const long long v0 = vb + (long long)j * kTile * M - lead;
        if (aligned && v0 >= k1 && v0 + 4LL * n_g <= n_in) {
            const float* src = x + (v0 - k1);
            for (int g = threadIdx.x; g < n_g; g += NT)
                cp_async16(dst + 4 * g, src + 4 * g);
            return;
        }
        for (int g = threadIdx.x; g < n_g; g += NT) {
            const long long v = v0 + 4LL * g;
            if (aligned && v >= k1 && v + 4 <= n_in) {
                cp_async16(dst + 4 * g, x + (v - k1));
            } else {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const long long vi = v + i;
                    const bool ok = vi >= 0 && vi < n_in;
                    cp_async4(dst + 4 * g + i,
                              !ok ? x : vi < k1 ? tail + vi : x + (vi - k1),
                              ok);
                }
            }
        }
    };
    for (int j = 0; j < R - 1; ++j) {
        if (j <= n_c) stage(j);
        cp_async_commit();
    }

    // warp (r, g, s) = r WP + g S + s: rows [s AS, s AS + AS) of phase r,
    // which start q_r samples into each row of M, lane l the columns
    // 32 CW g + l + 32k, k < CW
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int r = warp / WP;
    const int g = (warp - r * WP) / S;
    const int a0 = (warp - r * WP - g * S) * AS;
    const int c0 = 32 * CW * g + lane;
    const int q_r = r * M / L;
    // the short body where the segment's last row holds no tap
    const bool short_rows = shorten && tap_rows(M, K) - a0 < AS;
    float h[AS][CW];
#pragma unroll
    for (int a = 0; a < AS; ++a) {
#pragma unroll
        for (int k = 0; k < CW; ++k) {
            const int c = c0 + 32 * k;
            const int u = (a0 + a) * M + c;
            h[a][k] = c < M && u < K ? taps[(size_t)r * K + u] : 0.0f;
        }
    }
    float* tile = s_tile + warp * kTile * kTileStride;
    float* part = s_out + warp * kOutRing;

    // the WP warps' partials of each (output, phase) of chunk j's window,
    // in order w = g S + s
    const auto finish = [&](int j) {
        const int w0 = t_lo + j * kTile - a_last;
        for (int i = threadIdx.x; i < kTile * L; i += NT) {
            const int t = w0 + i / L;
            const int ph = i - (i / L) * L;
            if (t < t_lo || t >= t_hi) continue;
            const float* p =
                s_out + ph * WP * kOutRing + (t & (kOutRing - 1));
            float v = p[0];
            for (int w = 1; w < WP; ++w) v += p[w * kOutRing];
            y[(size_t)t * L + ph] = v;
        }
    };

    for (int j = 0; j < n_c; ++j) {
        cp_async_wait_chunks<R>();  // chunks j and j + 1 landed
        __syncthreads();            // for every thread; chunk j - 1 done
        if (j + R - 1 <= n_c) stage(j + R - 1);
        cp_async_commit();
        if (j > 0) finish(j - 1);

        const float* pa = s_buf + (j % R) * BW + lead + q_r + c0;
        const float* pb = s_buf + ((j + 1) % R) * BW + lead + q_r + c0;
        float acc[kTile];
        if (short_rows)
            row_sums<CW, AS, AS - 1, M>(pa, pb, h, acc);
        else
            row_sums<CW, AS, AS, M>(pa, pb, h, acc);
#pragma unroll
        for (int o = 0; o < kTile; ++o) tile[o * kTileStride + lane] = acc[o];
        // lane sums through the transpose tile: lane l sums output o0 + l
        // of each 32, lanes 0 .. 31 in order from 0.0f
        __syncwarp();
#pragma unroll
        for (int o0 = 0; o0 < kTile; o0 += 32) {
            const float4* tr = reinterpret_cast<const float4*>(
                tile + (o0 + lane) * kTileStride);
            float v = 0.0f;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const float4 q = tr[b];
                v += q.x;
                v += q.y;
                v += q.z;
                v += q.w;
            }
            part[(t_lo + j * kTile + o0 + lane - a0) & (kOutRing - 1)] = v;
        }
        __syncwarp();
    }
    __syncthreads();
    finish(n_c - 1);
}

// ---- the taps-in-order form ------------------------------------------
//
// Each output's K products summed from 0.0f in tap order, j = 0 .. K-1,
// one fmaf each: resample_poly_f32's order, so its bits (and, at the 2/25
// heads of 2FSK10K and GMSK10K, the CPU path's: there the column form's
// few-ulp differences reached the quadrature demod's near-zero first
// samples and the Viterbi's path metrics; scripts/gmsk10k_card_cpu.py).
//
// Design: lane = row. Block (piece, group of 32 RPL rows, plane) owns the
// output times [t_lo, t_hi) of its rows, warp r phase r, lane l the rows
// g 32 RPL + l + 32 q, q < RPL. Each lane walks its rows' input in rows
// of M samples, m = t_lo, t_lo + 1, ..., keeping the A = ceil(K/M) outputs
// the row meets in registers, slot a holding output t = m - a at its tap
// row a: sample c of row m (xc[m M + q_r + c]) meets tap tf_r[a M + c]
// of every slot (slot A - 1 only for c < K - (A - 1) M), so each output
// adds its taps in order; after the row slot A - 1 is output m - (A - 1),
// stored, and the slots move up one (slot 0 from 0.0f). The first A - 1
// rows of a piece fill the slots (their outputs, before t_lo, are not
// stored). The taps of a column sit in shared memory, transposed
// (s_taps[r][c][a]), read by all lanes at once (broadcast float4s): per
// column RPL sample loads and ceil(A/4) tap loads feed A RPL FMAs. The
// rows' samples are staged CR rows of M a chunk (and the q_max samples
// phase L-1 reads past them) into a ring of R buffers, row stride RS words
// (2 x odd: the lanes' loads of one column fall in 16 banks pairwise), 8
// bytes a cp.async where x allows (4 at the tail/x seam and the stream's
// end, zeros past it and past the last row).
//
// What binds (2FSK10K's sweep shape, 2 planes, 256 x 200,000 -> 16,000;
// scripts/resample_dec_variants.py, ms in turns on an H100 80GB HBM3 at
// 700 W): 0.589, 23% of its 0.137-ms bound; the column form 0.444 (its
// outputs off the CPU path's by a few ulp), resample_poly_f32 1.178.
// Taken away one at a time (timed, wrong outputs): the tap loads 0.462,
// the staging after the first chunks 0.467, the stores 0.554. A column's
// 23 taps reach every lane through shared memory, 23 words a lane for 23
// FMAs; two rows a lane (RPL 2, 132 registers) ran 0.662-0.82, the taps
// as constant operands (constant memory copied on the launch's stream,
// each FFMA's tap a compile-time offset) 2.70, the column loops unrolled
// whole spilled (8.19). At few rows the lanes' serial walk loses:
// cuda_resample.route gives calls of up to 64 rows resample_poly_f32 (the
// same bits; 1 to 64 rows x 125,000: 0.0147-0.1985 against 0.1208-0.2071;
// scripts/resample_dec_shapes.py order).
constexpr int kSeqMaxPieces = 256;  // pieces a row group the rule tries

// words a row of a chunk: CR rows of M and what phase L-1 reads past them
__host__ __device__ constexpr int seq_words(int L, int M, int CR) {
    return CR * M + q_max(L, M);
}

// row stride of a chunk buffer: the least 2 x odd >= seq_words
__host__ __device__ constexpr int seq_stride(int L, int M, int CR) {
    return ((seq_words(L, M, CR) + 1) / 2 | 1) * 2;
}

// tap rows padded to whole float4s
__host__ __device__ constexpr int seq_tap_pad(int M, int K) {
    return (tap_rows(M, K) + 3) / 4 * 4;
}

// the transposed taps, then R chunk buffers of 32 RPL rows
__host__ __device__ constexpr long long seq_smem_words(int L, int M, int K,
                                                      int RPL, int CR,
                                                      int R) {
    return (long long)L * M * seq_tap_pad(M, K) +
           (long long)R * 32 * RPL * seq_stride(L, M, CR);
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
}

// every group but the newest R - 2 has landed
template <int R>
__device__ __forceinline__ void cp_async_wait_seq() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(R - 2) : "memory");
}

// One column of a row: its samples x[q] (RPL rows) into the slots a < NA
// with taps tc[a] (the column's transposed taps).
template <int NA, int RPL, int AP>
__device__ __forceinline__ void seq_column(const float* tc,
                                           const float (&x)[RPL],
                                           float (&acc)[RPL][AP]) {
#pragma unroll
    for (int a4 = 0; a4 < (NA + 3) / 4; ++a4) {
        const float4 h = reinterpret_cast<const float4*>(tc)[a4];
        const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (4 * a4 + i < NA) {
#pragma unroll
                for (int q = 0; q < RPL; ++q)
                    acc[q][4 * a4 + i] = fmaf(hv[i], x[q], acc[q][4 * a4 + i]);
            }
        }
    }
}

template <int L, int M, int K, int RPL, int CR, int R, int MINB>
__global__ void __launch_bounds__(32 * L, MINB)
resample_seq_kernel(const float* __restrict__ tail0,
                    const float* __restrict__ tail1, int tail_ld,
                    const float* __restrict__ x0,
                    const float* __restrict__ x1,
                    const float* __restrict__ taps, float* __restrict__ y0,
                    float* __restrict__ y1, float* __restrict__ state, int C,
                    int T, int n_pp, int piece, int n_pieces, int n_groups,
                    int planes, int pairs) {
    constexpr int A = tap_rows(M, K);
    constexpr int KL = K - (A - 1) * M;  // columns of the last tap row
    constexpr int AP = seq_tap_pad(M, K);
    constexpr int W = seq_words(L, M, CR);
    constexpr int W2 = (W + 1) / 2;
    constexpr int RS = seq_stride(L, M, CR);
    constexpr int GR = 32 * RPL;
    constexpr int NT = 32 * L;
    extern __shared__ __align__(16) float smem[];
    float* s_taps = smem;              // L x M x AP
    float* s_buf = smem + L * M * AP;  // R x GR x RS

    const int pc = (int)(blockIdx.x % (unsigned)n_pieces);
    const int rest = (int)(blockIdx.x / (unsigned)n_pieces);
    const int grp = rest % n_groups;
    const int plane = rest / n_groups;
    const int row0 = grp * GR;
    const float* tail = plane ? tail1 : tail0;
    const float* x = plane ? x1 : x0;
    float* y = plane ? y1 : y0;
    const int k1 = K - 1;
    const long long n_in = (long long)k1 + T;

    // the group's first piece copies xc[T .. T+K-2] of its rows into the
    // new state
    if (pc == 0 && state) {
        for (int i = threadIdx.x; i < GR * k1; i += NT) {
            const int lr = i / k1;
            const int j = i - lr * k1;
            const int row = row0 + lr;
            if (row >= C) continue;
            float* st = state + ((size_t)row * 2 + plane) * k1;
            const long long v = (long long)T + j;
            st[j] = v < k1 ? tail[(size_t)row * tail_ld + v]
                           : x[(size_t)row * T + (v - k1)];
            if (planes == 1) st[k1 + j] = 0.0f;
        }
    }
    const int t_lo = pc * piece;
    if (t_lo >= n_pp) return;  // n_pp == 0: only the state
    const int t_hi = min(n_pp, t_lo + piece);
    const int n_c = (t_hi - t_lo + A - 1 + CR - 1) / CR;

    for (int i = threadIdx.x; i < L * M * AP; i += NT) {
        const int r = i / (M * AP);
        const int c = i / AP - r * M;
        const int a = i - (i / AP) * AP;
        const int u = a * M + c;
        s_taps[i] = a < A && u < K ? taps[(size_t)r * K + u] : 0.0f;
    }

    // chunk j: each row's stream words [vb + j CR M, + W) into buffer j
    // mod R, in pairs (8 bytes where the pair lies in x and x allows)
    const long long vb = (long long)t_lo * M;
    const auto stage = [&](int j) {
        float* dst = s_buf + (j % R) * (GR * RS);
        const long long v0 = vb + (long long)j * CR * M;
        for (int i = threadIdx.x; i < GR * W2; i += NT) {
            const int lr = i / W2;
            const int col = 2 * (i - lr * W2);
            const int row = row0 + lr;
            const long long v = v0 + col;
            float* d = dst + lr * RS + col;
            if (pairs && row < C && v >= k1 && v + 2 <= n_in &&
                col + 2 <= W) {
                cp_async8(d, x + (size_t)row * T + (v - k1));
            } else {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if (col + e >= W) break;
                    const long long ve = v + e;
                    const bool ok = row < C && ve < n_in;
                    cp_async4(d + e,
                              !ok ? x
                              : ve < k1 ? tail + (size_t)row * tail_ld + ve
                                        : x + (size_t)row * T + (ve - k1),
                              ok);
                }
            }
        }
    };
    for (int j = 0; j < R - 1; ++j) {
        if (j < n_c) stage(j);
        cp_async_commit();
    }

    const int r = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int q_r = r * M / L;
    const float* tp = s_taps + r * M * AP;
    float acc[RPL][AP];
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
#pragma unroll
        for (int a = 0; a < AP; ++a) acc[q][a] = 0.0f;
    }
    const size_t y_ld = (size_t)n_pp * L;

    for (int j = 0; j < n_c; ++j) {
        cp_async_wait_seq<R>();  // chunk j landed
        __syncthreads();         // for every thread; chunk j - 1 done
        if (j + R - 1 < n_c) stage(j + R - 1);
        cp_async_commit();
        const float* b = s_buf + (j % R) * (GR * RS) + lane * RS + q_r;
        for (int k = 0; k < CR; ++k) {
            const float* p = b + k * M;
            float xv[RPL];
#pragma unroll 5
            for (int c = 0; c < KL; ++c) {
#pragma unroll
                for (int q = 0; q < RPL; ++q) xv[q] = p[q * 32 * RS + c];
                seq_column<A, RPL, AP>(tp + c * AP, xv, acc);
            }
#pragma unroll 5
            for (int c = KL; c < M; ++c) {
#pragma unroll
                for (int q = 0; q < RPL; ++q) xv[q] = p[q * 32 * RS + c];
                seq_column<A - 1, RPL, AP>(tp + c * AP, xv, acc);
            }
            // slot A - 1 is output m - (A - 1), m = t_lo + j CR + k
            const int t = t_lo + j * CR + k - (A - 1);
            if (t >= t_lo && t < t_hi) {
#pragma unroll
                for (int q = 0; q < RPL; ++q) {
                    const int row = row0 + q * 32 + lane;
                    if (row < C)
                        y[(size_t)row * y_ld + (size_t)t * L + r] =
                            acc[q][A - 1];
                }
            }
#pragma unroll
            for (int q = 0; q < RPL; ++q) {
#pragma unroll
                for (int a = A - 1; a > 0; --a) acc[q][a] = acc[q][a - 1];
                acc[q][0] = 0.0f;
            }
        }
    }
}

// output times a block of the taps-in-order form: of the piece counts a
// row group, the one that least costs (waves of `slots` blocks) x (the
// rows a block walks: its piece and the a_last rows before it, in chunks
// of CR); pieces whole multiples of 2 (the pairs' parity); the fewest
// pieces on a tie
int seq_piece(long long units, int n_pp, int a_last, int CR, long long slots) {
    if (n_pp <= 0) return 1;
    long long best = -1;
    int best_piece = n_pp;
    const int max_p = n_pp < kSeqMaxPieces ? n_pp : kSeqMaxPieces;
    for (int p = 1; p <= max_p; ++p) {
        int piece = (n_pp + p - 1) / p;
        piece = (piece + 1) / 2 * 2;
        if (piece > n_pp) piece = n_pp;
        const long long pieces = (n_pp + piece - 1) / piece;
        const long long waves = (units * pieces + slots - 1) / slots;
        const long long cost = waves * ((piece + a_last + CR - 1) / CR);
        if (best < 0 || cost < best) {
            best = cost;
            best_piece = piece;
        }
    }
    return best_piece;
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

// output times a block: a whole row-plane, or pieces of whole chunks when
// the row-planes alone give fewer than kRuleBlocks blocks an SM
int piece_len(long long row_planes, int n_pp, int n_sm) {
    if (n_pp <= 0) return 1;
    const long long want = (long long)n_sm * kRuleBlocks;
    long long per = (row_planes * n_pp + want - 1) / want;
    per = (per + kTile - 1) / kTile * kTile;
    if (per >= n_pp) return n_pp;
    const long long pieces = (n_pp + per - 1) / per;
    const long long even = (n_pp + pieces - 1) / pieces;
    return (int)((even + kTile - 1) / kTile * kTile);
}

// output times a block by whole waves: of the pieces of whole chunks a
// row-plane, the count that least costs (waves of `slots` blocks, the
// blocks the card holds at once) x (chunks a block: its piece and the
// a_last rows before it); the fewest pieces on a tie
int piece_waves(long long row_planes, int n_pp, int a_last, long long slots) {
    if (n_pp <= 0) return 1;
    long long best = -1;
    int best_piece = n_pp;
    const int chunks = (n_pp + kTile - 1) / kTile;
    const int max_p = chunks < kMaxPieces ? chunks : kMaxPieces;
    for (int p = 1; p <= max_p; ++p) {
        int piece = (n_pp + p - 1) / p;
        piece = (piece + kTile - 1) / kTile * kTile;
        if (piece > n_pp) piece = n_pp;
        const long long pieces = (n_pp + piece - 1) / piece;
        const long long waves = (row_planes * pieces + slots - 1) / slots;
        const long long cost = waves * ((piece + a_last + kTile - 1) / kTile);
        if (best < 0 || cost < best) {
            best = cost;
            best_piece = piece;
        }
    }
    return best_piece;
}

template <int L, int M, int K, int AS, int CW, int R, int MINB, int RULE>
int launch(const void* tail0, const void* tail1, int tail_ld, const void* x0,
           const void* x1, const void* taps, void* y0, void* y1, void* state,
           int C, int T, int planes, cudaStream_t stream) {
    constexpr int S = (tap_rows(M, K) + AS - 1) / AS;
    constexpr int W = L * phase_warps(M, K, AS, CW);
    static_assert(W <= kMaxWarps && (S - 1) * AS + 2 * kTile <= kOutRing &&
                  R >= 3 && AS <= kTile, "instance");
    // the short body for the last segments where their last row is empty
    // and they are at least half the warps, S <= 2 (two bodies on a
    // block's warps ran DMR's head 28% slower than one in a build of 6
    // warps, 1 of them short)
    constexpr bool shorten = tap_rows(M, K) - (S - 1) * AS < AS && S <= 2;
    const int n_pp = T / M;
    int n_sm = 0;
    cudaError_t e = sm_count(&n_sm);
    if (e != cudaSuccess) return (int)e;
    const long long smem =
        smem_words(L, M, CW, W, R) * (long long)sizeof(float);
    auto* kernel = resample_dec_kernel<M, AS, CW, R, W * 32, MINB,
                                       L == 1 ? L : 0, L == 1 ? S : 0>;
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
        return (int)e;
    int piece;
    if (RULE == 1) {
        // the blocks an SM holds of this instance, read on its first launch
        static int per_sm[kMaxDev];
        int dev = 0;
        if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
        if (per_sm[dev] == 0 &&
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm[dev], kernel, W * 32, (size_t)smem)) != cudaSuccess)
            return (int)e;
        const int held = per_sm[dev] > 0 ? per_sm[dev] : 1;
        piece = piece_waves((long long)C * planes, n_pp, (S - 1) * AS,
                            (long long)n_sm * held);
    } else {
        piece = piece_len((long long)C * planes, n_pp, n_sm);
    }
    const long long n_pieces = n_pp > 0 ? (n_pp + piece - 1) / piece : 1;
    const long long blocks = n_pieces * C * planes;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const bool aligned =
        T % 4 == 0 && (size_t)x0 % 16 == 0 &&
        (planes == 1 || (size_t)x1 % 16 == 0);
    kernel<<<(unsigned)blocks, W * 32, (size_t)smem, stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, (const float*)x0,
        (const float*)x1, (const float*)taps, (float*)y0, (float*)y1,
        (float*)state, C, T, K, L, S, n_pp, piece, (int)n_pieces, planes,
        aligned ? 1 : 0, shorten ? 1 : 0);
    return (int)cudaGetLastError();
}

template <int L, int M, int K, int RPL, int CR, int R, int MINB>
int launch_seq(const void* tail0, const void* tail1, int tail_ld,
               const void* x0, const void* x1, const void* taps, void* y0,
               void* y1, void* state, int C, int T, int planes,
               cudaStream_t stream) {
    constexpr int A = tap_rows(M, K);
    static_assert(R >= 2 && CR >= 1 && RPL >= 1 && A >= 2, "instance");
    const int n_pp = T / M;
    int n_sm = 0;
    cudaError_t e = sm_count(&n_sm);
    if (e != cudaSuccess) return (int)e;
    const long long smem =
        seq_smem_words(L, M, K, RPL, CR, R) * (long long)sizeof(float);
    auto* kernel = resample_seq_kernel<L, M, K, RPL, CR, R, MINB>;
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
        return (int)e;
    // the blocks an SM holds of this instance, read on its first launch
    static int per_sm[kMaxDev];
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if (per_sm[dev] == 0 &&
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm[dev], kernel, 32 * L, (size_t)smem)) != cudaSuccess)
        return (int)e;
    const int held = per_sm[dev] > 0 ? per_sm[dev] : 1;
    const long long n_groups = (C + 32 * RPL - 1) / (32 * RPL);
    const int piece = seq_piece(n_groups * planes, n_pp, A - 1, CR,
                                (long long)n_sm * held);
    const long long n_pieces = n_pp > 0 ? (n_pp + piece - 1) / piece : 1;
    const long long blocks = n_pieces * n_groups * planes;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    // 8-byte copies: x's rows and every chunk's start on even words
    const bool pairs = T % 2 == 0 && (CR * M) % 2 == 0 &&
                       ((long long)piece * M) % 2 == 0 && (K - 1) % 2 == 0 &&
                       (size_t)x0 % 8 == 0 &&
                       (planes == 1 || (size_t)x1 % 8 == 0);
    kernel<<<(unsigned)blocks, 32 * L, (size_t)smem, stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, (const float*)x0,
        (const float*)x1, (const float*)taps, (float*)y0, (float*)y1,
        (float*)state, C, T, n_pp, piece, (int)n_pieces, (int)n_groups,
        planes, pairs ? 1 : 0);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes; -1 where no instance takes
// (L, M, K).
long long resample_dec_smem_bytes(int L, int M, int K) {
#define QRL_DEC_SMEM(LL, MM, KK, AA, CC, RR, BB, PP)                       \
    if (L == LL && M == MM && K == KK)                                      \
        return smem_words(LL, MM, CC, LL * phase_warps(MM, KK, AA, CC),     \
                          RR) *                                             \
               (long long)sizeof(float);
    QRL_DEC_INSTANCES(QRL_DEC_SMEM)
#undef QRL_DEC_SMEM
#define QRL_DEC_SEQ_SMEM(LL, MM, KK, QQ, CC, RR, BB)                       \
    if (L == LL && M == MM && K == KK)                                      \
        return seq_smem_words(LL, MM, KK, QQ, CC, RR) *                     \
               (long long)sizeof(float);
    QRL_DEC_SEQ_INSTANCES(QRL_DEC_SEQ_SMEM)
#undef QRL_DEC_SEQ_SMEM
    return -1;
}

// Same arguments as resample_poly_f32 (csrc/resample_poly.cu). tail0/tail1:
// (C, tail_ld)-strided rows of K-1 floats; x0/x1: contiguous (C, T) with
// T % M == 0; taps: contiguous (L, K), phase r's flipped taps in row r;
// y0/y1: contiguous (C, T/M*L); state: contiguous (C, 2, K-1), written
// whole, or null (no state written: the strided FIR's call at L 1). planes 1 or 2 (the *1 pointers are read only for 2); (L, M, K) an
// instance. Returns a CUDA error code, 0 after a clean launch.
int resample_dec_f32(const void* tail0, const void* tail1, int tail_ld,
                     const void* x0, const void* x1, const void* taps,
                     void* y0, void* y1, void* state, int C, int T, int K,
                     int L, int M, int planes, void* stream) {
    if (C < 1 || T < 0 || M < 1 || T % M || planes < 1 || planes > 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define QRL_DEC_LAUNCH(LL, MM, KK, AA, CC, RR, BB, PP)                     \
    if (L == LL && M == MM && K == KK)                                      \
        return launch<LL, MM, KK, AA, CC, RR, BB, PP>(                      \
            tail0, tail1, tail_ld, x0, x1, taps, y0, y1, state, C, T,       \
            planes, s);
    QRL_DEC_INSTANCES(QRL_DEC_LAUNCH)
#undef QRL_DEC_LAUNCH
#define QRL_DEC_SEQ_LAUNCH(LL, MM, KK, QQ, CC, RR, BB)                     \
    if (L == LL && M == MM && K == KK)                                      \
        return launch_seq<LL, MM, KK, QQ, CC, RR, BB>(                      \
            tail0, tail1, tail_ld, x0, x1, taps, y0, y1, state, C, T,       \
            planes, s);
    QRL_DEC_SEQ_INSTANCES(QRL_DEC_SEQ_LAUNCH)
#undef QRL_DEC_SEQ_LAUNCH
    return (int)cudaErrorInvalidValue;
}

const char* resample_dec_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

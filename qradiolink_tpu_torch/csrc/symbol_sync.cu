// symbol_sync_mm_f32: the M&M symbol sync's loop (SymbolSync, the
// gr::digital::symbol_sync / clock_recovery_mm equivalent), one lane a
// row, one iteration an output symbol, the row's samples read from a ring
// in shared memory that the warp fills ahead of the position.
//
// Not a port of a Pallas kernel: the JAX package runs the loop as a
// lax.scan over output symbols (qradiolink_tpu/sync/symbol_sync.py:
// 131-152), one device loop. Its plain PyTorch counterpart
// (sync/cuda_symbol_sync.symbol_sync_plain) takes about 45 small ops a
// symbol, 25,000 symbols a row a step at QPSK250K, so the port runs the
// loop here instead.
//
// Function, per row over xc = [tail | x] (tail (rows, L) complex64, x
// (rows, T) complex64 or, XC false, f32 with a zero imaginary part), from
// (pos, omega, y_prev, d_prev), for m = 0 .. n_out-1, each operation
// rounded on its own:
//     p  = min(max(pos, 2), total - 3);  b = floor(p);  mu = p - b
//     c0 = ((-mu (mu - 1)) (mu - 2)) r6,   c1 = (((mu + 1)(mu - 1))(mu - 2)) / 2,
//     c2 = ((-(mu + 1) mu)(mu - 2)) / 2,  c3 = (((mu + 1) mu)(mu - 1)) r6
//          (r6 = 1/6 rounded to f32: XLA folds the quotients by constants
//          into products with their reciprocals)
//     y  = ((w0 c0 + w1 c1) + w2 c2) + w3 c3, plane by plane, w_k =
//          xc[b - 1 + k]
//     d  = (sign(yr), sign(yi))                      MODE 0 and 2
//        = (the first level l minimizing hypot(yr - l, yi), 0)   MODE 1
//     e  = (dpr yr + dpi yi) - (dr ypr + di ypi)     MODE 0 (conj TED)
//        = (dpr yr - dpi yi) - (dr ypr - di ypi)     MODE 1 and 2
//     e  = min(max(e inv_norm, -1), 1)     (inv_norm = 1/ted_norm in f32)
//     omega = min(max(omega + beta e, omin), omax)
//     pos   = (pos + omega) + alpha e
// y[m] = y; y_prev = y, d_prev = d; the state after the last symbol goes
// out, pos not shifted (the wrapper shifts it and cuts the new tail, as the
// JAX block does). The TED's products are XLA's complex products written
// out. Every product and sum is __fmul_rn / __fadd_rn / __fsub_rn and the
// file is built with --fmad=false (utils/kernels._EXTRA), so the kernel
// equals the plain loop bit for bit.
//
// Bound on an H100 SXM: at QPSK250K (2048 rows x 100,000 samples -> 25,000
// symbols) the bytes are the block read once (1.64 GB) and the symbols
// written (0.41 GB): 0.61 ms at 3.35 TB/s; the ~60 operations a symbol
// (3 GFLOP) bind nothing. Latency does: n_out dependent iterations a row,
// 64 chains at 2048 rows, less than one an SM, so nothing hides the chain
// pos -> clip -> index -> samples -> y -> decision -> e -> omega -> pos.
// Its floor, measured with the kernel's own coeffs and update
// (scripts/loop_chain_floor.py, an H100 80GB HBM3 at 700 W, 1,980 MHz):
// 1.84 ms, 146 cycles a symbol, with the samples in registers; 2.54 ms, 201
// cycles, read from a ring in shared memory as this kernel reads them; this
// kernel 3.08 ms, 244 cycles. The symbol's SASS (cuobjdump of the sm_90a
// build): 23 instructions on the dependent chain (the clip 2, F2I.FLOOR,
// the slot's LOP3 and IMAD, LDS.64, the interpolator's FMUL and 3 FADD, the
// sign products' FSETP and FSEL, e 5, omega 4, pos 2), the coefficients'
// 6 levels beside the loads. With the samples read from global memory on
// that chain, as this kernel first did, a symbol took 786 cycles (9.94 ms).
//
// Design: two warps a block for 32 rows. In warp 0 lane i runs row row0 +
// i's chain; in warp 1 lane i fills that row's ring, a window of R samples
// of [tail | x] in shared memory (R a power of 2, at most kMaxRing), so the
// chain reads only registers and the ring. The symbols go in chunks of S
// (a power of 2, at most 16). At a chunk's start warp 0 posts its
// positions (named barrier 1); warp 1 computes how far each row's reads
// can reach over this chunk and the next (the wrapper's `reach`: (2S - 1)
// times the largest advance a symbol, omega at its limit and |e| = 1, plus
// the position's rounding), copies the row's samples between its fill
// pointer and that reach with 16-byte cp.async, waits for them and posts
// that they landed (barrier 2), which warp 0 waits for at the start of the
// chunk after next: the copies land while a chunk runs. Where a sample
// comes from (the tail or the block) is settled per 16-byte granule when
// it is copied, never on a read. The ring is large enough that a copy
// never overwrites a sample the running chunk can still read (the
// wrapper's plan, cuda_symbol_sync.ring_plan, which raises where kMaxRing
// cannot serve the parameters). Issued by the chain's own warp, the copies
// (~33 a lane a chunk at sps 4, 32 rows' 16-byte pieces an instruction)
// held it ~105 cycles a symbol on an H100; copied row by row by the whole
// warp, coalesced, with the rows' pointers broadcast by __shfl_sync, ~590
// (PERF.md; scripts/loop_chain_floor.py). Real input (XC false) keeps
// planar rings, the imaginary plane 0 past the tail. A symbol's four
// samples are four 8-byte (complex) or eight 4-byte loads from the ring
// (lanes whose rows sit at one position meet 2-way bank conflicts at most;
// 4 8-byte loads measured ~10 cycles a symbol cheaper than the 3 16-byte
// granules that hold them and a select). sign(yr) ypr and sign(yi) ypi are
// two selp each of the products' bits, not a sign() times a value. The
// symbols go through a shared tile of 32 a row, stored coalesced, a row at
// a time (one bulk copy a row, cp.async.bulk, measured slower on an H100).
// The levels (at most 8) sit in registers.
//
// Real input with levels (M17, DMR, the 2FSK/4FSK/GMSK chains; MODE 3):
// the decision was the symbol's cost. With a hypotf a level over a
// runtime count of levels, chained by selects, a symbol took 949 cycles at
// 4 levels and 681 at 2 (2048 x 100,000, M17's and GMSK2K's loops); the
// chain alone 996 / 788, 192 / 196 without its decision, 372 / 334 with
// fabsf in place of hypotf (scripts/loop_chain_floor.py, an H100 80GB
// HBM3 at 700 W, 1,980 MHz). So a block whose rows' tails hold +0 in
// every imaginary word (SymbolSync's state always does: zeros, then real
// samples) takes yi = +0 (update's proof), copies and reads no imaginary
// plane, and takes |yr - l| (hypot(d, +-0) = |d| for every f32, the card
// test) of NL = 2, 4 or 8 levels fixed at compile time (padded with NaN),
// reduced by a tree to the first minimum; 267 cycles a symbol at 4 levels
// and 248 at 2, 3.5x / 2.7x the MODE 1 code in turns, bit-equal (its chain
// alone 207 / 187). A block with any other tail word runs MODE 1.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // rows a block: the lanes of one warp
constexpr int kOutTile = 32;   // symbols a row in the output tile
constexpr int kMaxLevels = 8;
constexpr int kMaxRing = 512;  // samples a lane: 32 x 514 x 8 bytes
constexpr int kMaxChunk = 16;
constexpr float kInv6 = 1.0f / 6.0f;  // rounded to f32

__device__ __forceinline__ float sgn(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// sign(s) u, as __fmul_rn(sign(s), u) rounds it (sign(0) = 0): u, -u or
// 0 u chosen by two selp, so that nvcc emits no branch for it
__device__ __forceinline__ float sgn_mul(float s, float u) {
    const float z = __fmul_rn(0.0f, u);
    float r;
    asm("{\n\t.reg .pred gt, lt;\n\t"
        "setp.gt.f32 gt, %1, 0f00000000;\n\t"
        "setp.lt.f32 lt, %1, 0f00000000;\n\t"
        "selp.f32 %0, %3, %2, lt;\n\t"
        "selp.f32 %0, %4, %0, gt;\n\t}"
        : "=f"(r)
        : "f"(s), "f"(z), "f"(-u), "f"(u));
    return r;
}

// The step before the samples: p = clip(pos), b = floor(p), mu's four
// coefficients into c; returns b - 1, the first sample's index.
__device__ __forceinline__ int coeffs(float pos, float max_pos,
                                      float (&c)[4]) {
    const float p = fminf(fmaxf(pos, 2.0f), max_pos);
    const float b = floorf(p);
    const float mu = __fsub_rn(p, b);
    const float mm1 = __fsub_rn(mu, 1.0f), mm2 = __fsub_rn(mu, 2.0f);
    const float mp1 = __fadd_rn(mu, 1.0f);
    c[0] = __fmul_rn(__fmul_rn(__fmul_rn(-mu, mm1), mm2), kInv6);
    c[1] = __fmul_rn(__fmul_rn(__fmul_rn(mp1, mm1), mm2), 0.5f);
    c[2] = __fmul_rn(__fmul_rn(__fmul_rn(-mp1, mu), mm2), 0.5f);
    c[3] = __fmul_rn(__fmul_rn(__fmul_rn(mp1, mu), mm1), kInv6);
    return __float2int_rd(p) - 1;  // floor(p) - 1, beside b, not after it
}

// The first of the NL levels nearest to yr: the distances |yr - l| apart,
// reduced by a (distance, level) tree that keeps the left one unless the
// right one is smaller, which is the first minimum in any grouping. Levels
// past n_lv are NaN: their distances are never smaller, and a pair's left
// one is a pad only where its right one is too.
template <int NL>
__device__ __forceinline__ float nearest(float yr,
                                         const float (&lv)[kMaxLevels]) {
    float d[NL], l[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
        d[k] = fabsf(__fsub_rn(yr, lv[k]));
        l[k] = lv[k];
    }
#pragma unroll
    for (int w = 1; w < NL; w *= 2) {
#pragma unroll
        for (int k = 0; k + w < NL; k += 2 * w) {
            const bool right = d[k + w] < d[k];
            d[k] = right ? d[k + w] : d[k];
            l[k] = right ? l[k + w] : l[k];
        }
    }
    return l[0];
}

// The step after the samples w: y, the decision d, the TED's e and the loop
// update of omega and pos; y_prev and d_prev become y and d. MODE 3 (real
// input, its tail's imaginary plane +0) takes yi = +0 without reading it:
// every w_k.y is +0 and c1 > 0 (mu in [0, 1), so (mu + 1)(mu - 1)(mu - 2)
// is above 0 and above 2^-23 in f32), so w1.y c1 is +0, and +0 plus a
// zero of either sign is +0, whatever the signs of the other products.
template <int MODE, int NL>
__device__ __forceinline__ void update(const float2 (&w)[4],
                                       const float (&c)[4],
                                       const float (&lv)[kMaxLevels],
                                       int n_lv, float omin, float omax,
                                       float alpha, float beta,
                                       float inv_norm, float& yr, float& yi,
                                       float& dr, float& di, float& pos,
                                       float& om, float2& yp, float2& dp) {
    yr = __fmul_rn(w[0].x, c[0]);
    yi = MODE == 3 ? 0.0f : __fmul_rn(w[0].y, c[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
        yr = __fadd_rn(yr, __fmul_rn(w[k].x, c[k]));
        if (MODE != 3) yi = __fadd_rn(yi, __fmul_rn(w[k].y, c[k]));
    }
    if (MODE == 3) {
        // hypot(yr - l, +0) = |yr - l| bit for bit (the card test
        // test_sync_levels_fabs_equals_torch_abs, every f32)
        dr = nearest<NL>(yr, lv);
        di = 0.0f;
    } else if (MODE == 1) {
        dr = lv[0];
        float best = hypotf(__fsub_rn(yr, lv[0]), yi);
#pragma unroll
        for (int k = 1; k < kMaxLevels; ++k) {
            if (k < n_lv) {
                const float dist = hypotf(__fsub_rn(yr, lv[k]), yi);
                if (dist < best) {
                    best = dist;
                    dr = lv[k];
                }
            }
        }
        di = 0.0f;
    } else {
        dr = sgn(yr);
        di = sgn(yi);
    }
    // d y_prev's products: sign(yr) ypr as a select (sgn_mul)
    constexpr bool LV = MODE == 1 || MODE == 3;
    const float dyr = LV ? __fmul_rn(dr, yp.x) : sgn_mul(yr, yp.x);
    const float dyi = LV ? __fmul_rn(di, yp.y) : sgn_mul(yi, yp.y);
    float e;
    if (MODE == 0)
        e = __fsub_rn(__fadd_rn(__fmul_rn(dp.x, yr), __fmul_rn(dp.y, yi)),
                      __fadd_rn(dyr, dyi));
    else
        e = __fsub_rn(__fsub_rn(__fmul_rn(dp.x, yr), __fmul_rn(dp.y, yi)),
                      __fsub_rn(dyr, dyi));
    e = fminf(fmaxf(__fmul_rn(e, inv_norm), -1.0f), 1.0f);
    om = fminf(fmaxf(__fadd_rn(om, __fmul_rn(beta, e)), omin), omax);
    pos = __fadd_rn(__fadd_rn(pos, om), __fmul_rn(alpha, e));
    yp = make_float2(yr, yi);
    dp = make_float2(dr, di);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// named barriers 1-4 between the block's two warps (64 threads)
__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// The ring of a lane: complex input keeps float2 samples (a granule is 2
// samples), a lane's ring R + 2 slots apart (16-byte aligned, lane bases 4
// banks apart); real input keeps two planes (a granule is 4 samples),
// R + 4 apart.
template <bool XC>
struct Ring {
    static constexpr int G = XC ? 2 : 4;  // samples a 16-byte granule
    static __host__ __device__ int stride(int R) { return XC ? R + 2 : R + 4; }
    static __host__ __device__ size_t bytes(int R) {
        return (size_t)kRows * stride(R) * 8;
    }
};

// Copy granules [g_lo, g_hi) of this lane's row of xc = [tail | x] into
// its ring (granule g to slot g mod (R / G)); real input's imaginary plane
// only where IM (MODE 3 reads none).
template <bool XC, bool IM>
__device__ __forceinline__ void fill(float* re, float* im, int g_lo,
                                     int g_hi, int R,
                                     const float2* __restrict__ trow,
                                     const void* __restrict__ xrow, int L) {
    constexpr int G = Ring<XC>::G;
    const int Rg = R / G;
#pragma unroll 4
    for (int g = g_lo; g < g_hi; ++g) {
        const int j = g * G;
        const int slot = (g & (Rg - 1)) * G;
        if (XC) {
            cp_async16(reinterpret_cast<float2*>(re) + slot,
                       j < L ? (const void*)(trow + j)
                             : (const void*)((const float2*)xrow + (j - L)));
        } else if (j < L) {  // the tail is complex: split it into the planes
            const float4 a = *reinterpret_cast<const float4*>(trow + j);
            const float4 b = *reinterpret_cast<const float4*>(trow + j + 2);
            *reinterpret_cast<float4*>(re + slot) =
                make_float4(a.x, a.z, b.x, b.z);
            if (IM)
                *reinterpret_cast<float4*>(im + slot) =
                    make_float4(a.y, a.w, b.y, b.w);
        } else {
            cp_async16(re + slot, (const float*)xrow + (j - L));
            if (IM)
                *reinterpret_cast<float4*>(im + slot) =
                    make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
    }
}

// A block's 32 rows of the loop (the kernel's body below); s_y and s_pos
// are the block's shared output tile and posted positions.
template <bool XC, int MODE, int NL>
__device__ __forceinline__ void run(
    const float2* __restrict__ tail, const void* __restrict__ x,
    const float* __restrict__ pos0, const float* __restrict__ om0,
    const float2* __restrict__ yp0, const float2* __restrict__ dp0,
    float2* __restrict__ y, float* __restrict__ pos_out,
    float* __restrict__ om_out, float2* __restrict__ yp_out,
    float2* __restrict__ dp_out, int rows, int L, int n_out, int ld,
    const float* __restrict__ levels, int n_lv, float omin, float omax,
    float alpha, float beta, float inv_norm, float max_pos, int S, int R,
    float reach, float* ring, float2 (*s_y)[kOutTile + 1],
    float (*s_pos)[kRows]) {
    constexpr int G = Ring<XC>::G;
    const int Rg = R / G;
    const int st = Ring<XC>::stride(R);
    const int lane = threadIdx.x & (kRows - 1);
    const bool producer = threadIdx.x >= kRows;
    const int row0 = blockIdx.x * kRows;
    const int n_rows = min(kRows, rows - row0);
    const bool mine = lane < n_rows;
    const int row = row0 + (mine ? lane : 0);
    // MODE 3 pads the levels past n_lv with NaN (nearest's tree)
    float lv[kMaxLevels];
#pragma unroll
    for (int k = 0; k < kMaxLevels; ++k)
        lv[k] = (MODE == 1 || MODE == 3) && k < n_lv
                    ? levels[k]
                    : (MODE == 3 ? __int_as_float(0x7fc00000) : 0.0f);
    float pos = mine ? pos0[row] : 0.0f, om = mine ? om0[row] : 0.0f;
    float2 yp = mine ? yp0[row] : make_float2(0.0f, 0.0f);
    float2 dp = mine ? dp0[row] : make_float2(0.0f, 0.0f);
    float* my_re = ring + (XC ? 2 : 1) * lane * st;  // float2 slots if XC
    float* my_im = ring + (kRows + lane) * st;
    const float2* my_c = reinterpret_cast<const float2*>(my_re);
    const float2* trow = tail + (size_t)row * L;
    const void* xrow = XC ? (const void*)((const float2*)x + (size_t)row * ld)
                          : (const void*)((const float*)x + (size_t)row * ld);

    // Chunk j's positions go out on barrier 1 + j % 2, its copies' landing
    // on barrier 3 + j % 2: two posts in a row on one barrier are always a
    // whole exchange apart, so no barrier counts one warp's arrivals twice.
    if (producer) {
        // warp 1: at each chunk's start, from the positions warp 0 posts,
        // copy each row's samples out to the reach of this chunk and the
        // next (lane i for row i), wait for them, and post that they landed
        int filled = 0;  // granules of this lane's row copied so far
        for (int m0 = 0, j = 0; m0 < n_out; m0 += S, ++j) {
            bar_sync(1 + (j & 1));
            const float p = s_pos[j & 1][lane];
            const float t = fminf(fmaxf(__fadd_rn(p, reach), 2.0f), max_pos);
            const int g_hi = mine ? max(filled, ((int)t + 3 + G - 1) / G) : 0;
            const int g_lo = max(filled, g_hi - Rg);
            filled = g_hi;
            fill<XC, MODE != 3>(my_re, my_im, g_lo, g_hi, R, trow, xrow, L);
            cp_async_commit();
            cp_async_wait_all();
            bar_arrive(3 + (j & 1));
        }
        return;
    }
    for (int m0 = 0, j = 0; m0 < n_out; m0 += S, ++j) {
        s_pos[j & 1][lane] = pos;
        bar_arrive(1 + (j & 1));
        // this chunk's samples landed with the copies from chunk j - 1's
        // positions (chunks 0 and 1: from chunk 0's)
        if (j == 0)
            bar_sync(3);
        else if (j > 1)
            bar_sync(3 + ((j - 1) & 1));
        const int n = min(S, n_out - m0);
        for (int i = 0; i < n; ++i) {
            float c[4];
            const int j0 = coeffs(pos, max_pos, c);
            float2 w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int s = (j0 + k) & (R - 1);
                w[k] = XC ? my_c[s]
                          : make_float2(my_re[s],
                                        MODE == 3 ? 0.0f : my_im[s]);
            }
            float yr, yi, dr, di;
            update<MODE, NL>(w, c, lv, n_lv, omin, omax, alpha, beta,
                             inv_norm, yr, yi, dr, di, pos, om, yp, dp);
            s_y[lane][(m0 + i) & (kOutTile - 1)] = make_float2(yr, yi);
        }
        __syncwarp();
        const int m1 = m0 + n;
        if ((m1 & (kOutTile - 1)) == 0 || m1 == n_out) {
            // the output tile, a row at a time, coalesced
            const int t0 = (m1 - 1) & ~(kOutTile - 1);
            if (lane < m1 - t0) {
                for (int r = 0; r < n_rows; ++r)
                    y[(size_t)(row0 + r) * n_out + t0 + lane] = s_y[r][lane];
            }
            __syncwarp();
        }
    }
    if (mine) {
        pos_out[row] = pos;
        om_out[row] = om;
        yp_out[row] = yp;
        dp_out[row] = dp;
    }
}

// MODE 3 (real input with levels) first reads the imaginary plane of its
// rows' tails: where every word is +0 (as SymbolSync's state leaves it:
// zeros, then real samples), yi is +0 throughout and the rows run MODE 3;
// otherwise they run MODE 1, which interpolates the plane.
template <bool XC, int MODE, int NL>
__global__ void __launch_bounds__(2 * kRows)
sync_kernel(const float2* __restrict__ tail, const void* __restrict__ x,
            const float* __restrict__ pos0, const float* __restrict__ om0,
            const float2* __restrict__ yp0, const float2* __restrict__ dp0,
            float2* __restrict__ y, float* __restrict__ pos_out,
            float* __restrict__ om_out, float2* __restrict__ yp_out,
            float2* __restrict__ dp_out, int rows, int L, int n_out, int ld,
            const float* __restrict__ levels, int n_lv, float omin,
            float omax, float alpha, float beta, float inv_norm,
            float max_pos, int S, int R, float reach) {
    extern __shared__ __align__(16) float ring[];
    __shared__ float2 s_y[kRows][kOutTile + 1];
    __shared__ float s_pos[2][kRows];  // each chunk's starting positions
#define QRL_RUN_ARGS                                                         \
    tail, x, pos0, om0, yp0, dp0, y, pos_out, om_out, yp_out, dp_out, rows,  \
        L, n_out, ld, levels, n_lv, omin, omax, alpha, beta, inv_norm,       \
        max_pos, S, R, reach, ring, s_y, s_pos
    if constexpr (MODE == 3) {
        const int row0 = blockIdx.x * kRows;
        const int n = min(kRows, rows - row0) * L;
        const unsigned* im =
            reinterpret_cast<const unsigned*>(tail + (size_t)row0 * L) + 1;
        unsigned bits = 0u;
        for (int i = threadIdx.x; i < n; i += 2 * kRows) bits |= im[2 * i];
        if (__syncthreads_or(bits != 0u)) {
            run<false, 1, NL>(QRL_RUN_ARGS);
            return;
        }
    }
    run<XC, MODE, NL>(QRL_RUN_ARGS);
#undef QRL_RUN_ARGS
}

template <bool XC, int MODE, int NL>
int launch(const void* tail, const void* x, const void* pos0,
           const void* om0, const void* yp0, const void* dp0, void* y,
           void* pos_out, void* om_out, void* yp_out, void* dp_out, int rows,
           int L, int ld, int n_out, const void* levels, int n_lv,
           float omin, float omax, float alpha, float beta, float inv_norm,
           float max_pos, int S, int R, float reach, cudaStream_t st) {
    const size_t smem = Ring<XC>::bytes(R);
    cudaError_t e = cudaFuncSetAttribute(
        sync_kernel<XC, MODE, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    sync_kernel<XC, MODE, NL>
        <<<(rows + kRows - 1) / kRows, 2 * kRows, smem, st>>>(
            (const float2*)tail, x, (const float*)pos0, (const float*)om0,
            (const float2*)yp0, (const float2*)dp0, (float2*)y,
            (float*)pos_out, (float*)om_out, (float2*)yp_out,
            (float2*)dp_out, rows, L, n_out, ld, (const float*)levels, n_lv,
            omin, omax, alpha, beta, inv_norm, max_pos, S, R, reach);
    return (int)cudaGetLastError();
}

// out = fabsf(d), elementwise: the real-levels decision's distance, which
// the card test holds to torch.abs(torch.complex(d, +-0)) for every f32
__global__ void fabs_f32(const float* __restrict__ d, float* __restrict__ out,
                         long long n) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = fabsf(d[i]);
}

}  // namespace

extern "C" {

// tail: contiguous (rows, L) complex64; x: (rows, T) complex64 (x_complex
// 1) or f32 (0), rows ld elements apart; tail and x 16-byte aligned, L and
// ld multiples of the granule (2 complex, 4 real samples); pos0, om0,
// pos_out, om_out: (rows,) f32; yp0, dp0, yp_out, dp_out: (rows,)
// complex64; y: contiguous (rows, n_out) complex64; levels: n_lv f32
// (modes 1 and 3). mode: 0 complex input with sign decisions, 1 levels
// (real input: the nearest level by |yr - l| where the tails' imaginary
// planes are +0), 2 real input with sign decisions, 3 real input with
// levels as every row ran them before: the imaginary plane interpolated
// and a hypotf a level (on no route; timed in turns). S (chunk, a power of
// 2 up to 16), R (ring samples a lane, a power of 2 from 16 to 512) and
// reach come from the wrapper's plan (cuda_symbol_sync.ring_plan). Returns
// a CUDA error code, 0 after a clean launch.
int symbol_sync_mm_f32(const void* tail, const void* x, const void* pos0,
                       const void* om0, const void* yp0, const void* dp0,
                       void* y, void* pos_out, void* om_out, void* yp_out,
                       void* dp_out, int rows, int L, int T, int ld,
                       int n_out, int x_complex, int mode, const void* levels,
                       int n_lv, float omin, float omax, float alpha,
                       float beta, float inv_norm, float max_pos, int S,
                       int R, float reach, void* stream) {
    const int G = x_complex ? Ring<true>::G : Ring<false>::G;
    const bool lv = mode == 1 || mode == 3;
    if (rows < 1 || L < 4 || T < 0 || ld < T || n_out < 0 || mode < 0 ||
        mode > 3 || (lv && (n_lv < 1 || n_lv > kMaxLevels)) ||
        (mode == 0 && !x_complex) || (mode >= 2 && x_complex) ||
        L % G || ld % G || S < 1 || S > kMaxChunk || (S & (S - 1)) ||
        R < 16 || R > kMaxRing || (R & (R - 1)) ||
        ((size_t)tail | (size_t)x) % 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define QRL_SYNC_ARGS                                                      \
    tail, x, pos0, om0, yp0, dp0, y, pos_out, om_out, yp_out, dp_out, rows, \
        L, ld, n_out, levels, n_lv, omin, omax, alpha, beta, inv_norm,      \
        max_pos, S, R, reach, st
    int err;
    if (mode == 0)
        err = launch<true, 0, kMaxLevels>(QRL_SYNC_ARGS);
    else if (mode == 2)
        err = launch<false, 2, kMaxLevels>(QRL_SYNC_ARGS);
    else if (x_complex)
        err = launch<true, 1, kMaxLevels>(QRL_SYNC_ARGS);
    else if (mode == 3)
        err = launch<false, 1, kMaxLevels>(QRL_SYNC_ARGS);
    else if (n_lv <= 2)
        err = launch<false, 3, 2>(QRL_SYNC_ARGS);
    else if (n_lv <= 4)
        err = launch<false, 3, 4>(QRL_SYNC_ARGS);
    else
        err = launch<false, 3, kMaxLevels>(QRL_SYNC_ARGS);
#undef QRL_SYNC_ARGS
    return err;
}

// d, out: n f32 on the card; out = fabsf(d) as the real-levels path
// computes a level's distance
int symbol_sync_fabs_f32(const void* d, void* out, long long n,
                         void* stream) {
    if (n < 0 || n > (1LL << 32)) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    fabs_f32<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)d, (float*)out, n);
    return (int)cudaGetLastError();
}

const char* symbol_sync_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// symbol_sync_mm_f32: the M&M symbol sync's loop (SymbolSync, the
// gr::digital::symbol_sync / clock_recovery_mm equivalent), one thread a
// row, one iteration an output symbol.
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
//          xc[b - 1 + k] read straight from the tail or the block
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
// file is built with --fmad=false
// (utils/kernels._EXTRA), so the kernel equals the plain loop bit for bit.
//
// Bound on an H100 SXM: at QPSK250K (2048 rows x 100,000 samples -> 25,000
// symbols) the bytes are the block read once (1.64 GB) and the symbols
// written (0.41 GB): 0.61 ms at 3.35 TB/s; the ~60 operations a symbol
// (3 GFLOP) bind nothing. Latency does: n_out dependent iterations a row,
// each a chain through the position, the floor, the sample loads, the
// interpolation, the decision and the loop update, ~150-300 cycles
// estimated. Measured (chip_smoke.py, an H100 at 700 W): 9.92 ms at 2048 x
// 100,000 -> 25,000, ~786 cycles a symbol at 1,980 MHz.
//
// Design: one thread a row, 32-thread blocks (2048 rows make 64 blocks).
// The four samples are read from global memory at the position the loop
// has reached; a row's reads walk forward through it, 4 samples a symbol
// at sps 4, so each 128-byte line serves several symbols from L1, and a
// prefetch of the line kAhead samples ahead is issued every symbol, so
// the next line is on its way before the loop reaches it. The levels (at
// most 8) sit in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxLevels = 8;
constexpr int kAhead = 32;  // samples ahead of the position to prefetch
constexpr float kInv6 = 1.0f / 6.0f;  // rounded to f32

__device__ __forceinline__ float sgn(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

template <bool XC>
__device__ __forceinline__ float2 fetch(const float2* __restrict__ trow,
                                        const void* __restrict__ xrow,
                                        int L, int j) {
    if (j < L) return trow[j];
    if (XC) return ((const float2*)xrow)[j - L];
    return make_float2(((const float*)xrow)[j - L], 0.0f);
}

template <bool XC>
__device__ __forceinline__ void prefetch(const void* __restrict__ xrow,
                                         int L, int T, int j) {
    const int i = j - L;
    if (i >= 0 && i < T) {
        const void* a = XC ? (const void*)((const float2*)xrow + i)
                           : (const void*)((const float*)xrow + i);
        asm volatile("prefetch.global.L1 [%0];" ::"l"(a));
    }
}

template <bool XC, int MODE>
__global__ void __launch_bounds__(kThreads)
sync_kernel(const float2* __restrict__ tail, const void* __restrict__ x,
            const float* __restrict__ pos0, const float* __restrict__ om0,
            const float2* __restrict__ yp0, const float2* __restrict__ dp0,
            float2* __restrict__ y, float* __restrict__ pos_out,
            float* __restrict__ om_out, float2* __restrict__ yp_out,
            float2* __restrict__ dp_out, int rows, int L, int T, int n_out,
            const float* __restrict__ levels, int n_lv, float omin,
            float omax, float alpha, float beta, float inv_norm,
            float max_pos) {
    const int row = blockIdx.x * kThreads + threadIdx.x;
    if (row >= rows) return;
    float lv[kMaxLevels];
#pragma unroll
    for (int k = 0; k < kMaxLevels; ++k)
        lv[k] = (MODE == 1 && k < n_lv) ? levels[k] : 0.0f;
    const float2* trow = tail + (size_t)row * L;
    const void* xrow = XC ? (const void*)((const float2*)x + (size_t)row * T)
                          : (const void*)((const float*)x + (size_t)row * T);
    float2* yrow = y + (size_t)row * n_out;
    float pos = pos0[row], om = om0[row];
    float2 yp = yp0[row], dp = dp0[row];

    for (int m = 0; m < n_out; ++m) {
        const float p = fminf(fmaxf(pos, 2.0f), max_pos);
        const float b = floorf(p);
        const float mu = __fsub_rn(p, b);
        const int j0 = (int)b - 1;
        prefetch<XC>(xrow, L, T, j0 + kAhead);
        const float mm1 = __fsub_rn(mu, 1.0f), mm2 = __fsub_rn(mu, 2.0f);
        const float mp1 = __fadd_rn(mu, 1.0f);
        float c[4];
        c[0] = __fmul_rn(__fmul_rn(__fmul_rn(-mu, mm1), mm2), kInv6);
        c[1] = __fmul_rn(__fmul_rn(__fmul_rn(mp1, mm1), mm2), 0.5f);
        c[2] = __fmul_rn(__fmul_rn(__fmul_rn(-mp1, mu), mm2), 0.5f);
        c[3] = __fmul_rn(__fmul_rn(__fmul_rn(mp1, mu), mm1), kInv6);
        float2 w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = fetch<XC>(trow, xrow, L, j0 + k);
        float yr = __fmul_rn(w[0].x, c[0]), yi = __fmul_rn(w[0].y, c[0]);
#pragma unroll
        for (int k = 1; k < 4; ++k) {
            yr = __fadd_rn(yr, __fmul_rn(w[k].x, c[k]));
            yi = __fadd_rn(yi, __fmul_rn(w[k].y, c[k]));
        }
        float dr, di;
        if (MODE == 1) {
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
        float e;
        if (MODE == 0)
            e = __fsub_rn(__fadd_rn(__fmul_rn(dp.x, yr), __fmul_rn(dp.y, yi)),
                          __fadd_rn(__fmul_rn(dr, yp.x), __fmul_rn(di, yp.y)));
        else
            e = __fsub_rn(__fsub_rn(__fmul_rn(dp.x, yr), __fmul_rn(dp.y, yi)),
                          __fsub_rn(__fmul_rn(dr, yp.x), __fmul_rn(di, yp.y)));
        e = fminf(fmaxf(__fmul_rn(e, inv_norm), -1.0f), 1.0f);
        om = fminf(fmaxf(__fadd_rn(om, __fmul_rn(beta, e)), omin), omax);
        pos = __fadd_rn(__fadd_rn(pos, om), __fmul_rn(alpha, e));
        yrow[m] = make_float2(yr, yi);
        yp = make_float2(yr, yi);
        dp = make_float2(dr, di);
    }
    pos_out[row] = pos;
    om_out[row] = om;
    yp_out[row] = yp;
    dp_out[row] = dp;
}

template <bool XC, int MODE>
void launch(const void* tail, const void* x, const void* pos0,
            const void* om0, const void* yp0, const void* dp0, void* y,
            void* pos_out, void* om_out, void* yp_out, void* dp_out,
            int rows, int L, int T, int n_out, const void* levels, int n_lv,
            float omin, float omax, float alpha, float beta, float inv_norm,
            float max_pos, cudaStream_t st) {
    sync_kernel<XC, MODE><<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                            st>>>(
        (const float2*)tail, x, (const float*)pos0, (const float*)om0,
        (const float2*)yp0, (const float2*)dp0, (float2*)y, (float*)pos_out,
        (float*)om_out, (float2*)yp_out, (float2*)dp_out, rows, L, T, n_out,
        (const float*)levels, n_lv, omin, omax, alpha, beta, inv_norm,
        max_pos);
}

}  // namespace

extern "C" {

// tail: contiguous (rows, L) complex64; x: contiguous (rows, T) complex64
// (x_complex 1) or f32 (0); pos0, om0, pos_out, om_out: (rows,) f32; yp0,
// dp0, yp_out, dp_out: (rows,) complex64; y: contiguous (rows, n_out)
// complex64; levels: n_lv f32 (mode 1). mode: 0 complex input with sign
// decisions, 1 levels, 2 real input with sign decisions. Returns a CUDA
// error code, 0 after a clean launch.
int symbol_sync_mm_f32(const void* tail, const void* x, const void* pos0,
                       const void* om0, const void* yp0, const void* dp0,
                       void* y, void* pos_out, void* om_out, void* yp_out,
                       void* dp_out, int rows, int L, int T, int n_out,
                       int x_complex, int mode, const void* levels,
                       int n_lv, float omin, float omax, float alpha,
                       float beta, float inv_norm, float max_pos,
                       void* stream) {
    if (rows < 1 || L < 4 || T < 0 || n_out < 0 || mode < 0 || mode > 2 ||
        (mode == 1 && (n_lv < 1 || n_lv > kMaxLevels)) ||
        (mode == 0 && !x_complex) || (mode == 2 && x_complex))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define QRL_SYNC_ARGS                                                      \
    tail, x, pos0, om0, yp0, dp0, y, pos_out, om_out, yp_out, dp_out, rows, \
        L, T, n_out, levels, n_lv, omin, omax, alpha, beta, inv_norm,       \
        max_pos, st
    if (mode == 0)
        launch<true, 0>(QRL_SYNC_ARGS);
    else if (mode == 2)
        launch<false, 2>(QRL_SYNC_ARGS);
    else if (x_complex)
        launch<true, 1>(QRL_SYNC_ARGS);
    else
        launch<false, 1>(QRL_SYNC_ARGS);
#undef QRL_SYNC_ARGS
    return (int)cudaGetLastError();
}

const char* symbol_sync_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

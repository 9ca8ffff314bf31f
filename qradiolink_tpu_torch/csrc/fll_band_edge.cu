// fll_band_edge_f32: the FLL band-edge loop (gr::digital::fll_band_edge_cc
// in the JAX package's sub-block form) over the rows of a block, one warp a
// row, every sub-block of the block in one launch.
//
// Not the port of a Pallas kernel: the JAX package runs the loop as a
// lax.scan over the sub-blocks (qradiolink_tpu/sync/fll.py:78-93), whose
// band-edge filters are FIRs with complex taps (K1, the strided FIR,
// ops/pallas_fir.py `banded_fir_stream` at its stride-1 shape). Before
// this kernel the port ran the scan in PyTorch: at QPSK250K (2048 rows x
// 100,000 samples, 200 sub-blocks of 500) ~36 small device ops a sub-block,
// four of them fir_s1_f32 launches, 107-201 ms a step on the host's pace
// (PERF.md). Its plain version (sync/cuda_fll.fll_plain) is that loop.
//
// Function, per row, from (phase, freq, tail) = (ph0, fr0, tail0), for each
// sub-block k of sb samples a (n = 0 .. sb-1), in the plain loop's order,
// each operation rounded on its own:
//     p     = phase + freq n                   (product and add apart)
//     c, s  = cosf(p), -sinf(p)                (the NCO exp(-1j p))
//     y[n]  = (ar c - ai s, ar s + ai c)       (a = x[k sb + n])
//     U, L  = the upper and lower band-edge FIRs over [tail | y]:
//             (rr - ii, ri + ir), r? and i? the real FIRs of the two planes
//             with the real and imaginary flipped taps, each sum fmaf in
//             tap order from 0.0f (fir_s1_f32's order)
//     e[m]  = (Ur^2 + Ui^2) - (Lr^2 + Li^2)
//     err   = clip(sum_m e[m] * (1/sb), -1, 1)
//     freq' = clip(freq + beta err, -max_freq, max_freq)
//     phase = mod(phase + freq sb, 2 pi)       (fmodf, + 2 pi where < 0)
//     freq  = freq';  tail = the last K-1 samples of [tail | y]
// y is written as complex64, the state as (phase, freq, tail complex64).
// Products and sums are __fmul_rn / __fadd_rn / __fsub_rn and the file is
// built with --fmad=false (utils/kernels._EXTRA); cosf and sinf are CUDA's
// accurate versions, which give torch.cos's and torch.sin's bits on the
// card (csrc/costas.cu). Two kinds of sum leave the plain loop's order.
// The band-edge FIRs: the plain loop runs them as F.conv1d, in cuDNN's
// order on the card, not fmaf in tap order. And the sum over m, whose
// order the plain loop leaves to torch.mean: here each lane adds its
// outputs' e in output order from 0.0f, then the warp adds the lanes' sums
// in an xor butterfly of shuffles (offsets 16, 8, 4, 2, 1), which leaves
// the same bits in every lane; the mean is that sum times the f32 of 1/sb,
// as PyTorch's CUDA mean scales its sum. So the kernel is held to the
// plain loop within a bound (tests/test_torch_cuda.py, chip_smoke.py), not
// bit for bit, and a numpy model of this schedule
// (tests/test_torch_sync_loops.py fll_model) to the plain loop on the
// CPU.
//
// Bound on an H100 SXM at QPSK250K (2048 rows x 200 sub-blocks x 2 filters
// x 500 outputs x 32 taps x 4 real FMAs): 52.4 G FMAs, 1.57 ms at 33.5 T
// FMA/s; 1.64 GB read and 1.64 GB written, 0.98 ms. The FMAs bind; the
// sub-blocks form a serial chain a row, so rows and a sub-block's outputs
// are the parallel axes. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at
// 700 W): 4.317 ms at QPSK250K, 36% of the bound (the plain loop 165 ms);
// 0.201 ms at BPSK2K (2048 x 4,000); ptxas 80 registers, no spill.
//
// Design: one warp a row, kWarps rows a block (2048 rows: 512 blocks, ~15.5
// warps an SM, one wave). The warp keeps its row's [tail | y] planes in
// shared memory, one pad word after every kR words; the block shares the 4
// tap planes as K float4s (upper re, upper im, lower re, lower im at tap j:
// one broadcast load a tap). For each sub-block the warp
//   1. derotates the sub-block, lane l taking n = l, l + 32, ... (coalesced
//      loads; y stored coalesced as float2) into the buffer after the tail;
//   2. runs both FIRs in passes of kPass = 32 kR outputs: lane l computes
//      the kR consecutive outputs m0 = pass kPass + l kR .. m0 + kR - 1 from
//      a ring of kR registers a plane (8 kR accumulators); step j loads one
//      sample a plane and the tap float4 and issues 8 kR FMAs (3 loads for
//      32 FMAs at kR 4). Lane l's window starts at padded word (kR + 1)
//      (m0 / kR): 32 distinct banks. The tap loop runs in groups of kR
//      unrolled steps, the last K mod kR under a uniform `u < rem` test;
//   3. sums e, updates (phase, freq) in every lane, and moves the last K-1
//      samples of [tail | y] to the buffer's head (read into registers,
//      then written), the next sub-block's tail.
// Nothing crosses a row but the taps, so a warp synchronises only itself
// (__syncwarp) after the staging barrier.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;         // rows a block: one warp a row
constexpr int kR = 4;             // consecutive outputs a lane a pass
constexpr int kPass = 32 * kR;    // outputs a warp a pass
constexpr int kMaxK = 65;         // taps at most: a tail of two words a lane

// padded shared-memory index of logical word i of [tail | y]
__host__ __device__ constexpr int padded(int i) { return i + i / kR; }

// floats one plane of a warp's buffer takes: every word a pass's rings
// read, the passes rounded up to whole ones
__host__ __device__ constexpr int plane_words(int sb, int K) {
    return padded(((sb + kPass - 1) / kPass) * kPass + K - 2) + 1;
}

// shared memory one launch needs, in bytes: the taps, then kWarps buffers
// of two planes
constexpr long long smem_bytes(int sb, int K) {
    return (long long)K * 16 +
           (long long)kWarps * 2 * plane_words(sb, K) * sizeof(float);
}

__global__ void __launch_bounds__(kWarps * 32)
fll_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           const float2* __restrict__ tail0,
           const float* __restrict__ ph0, const float* __restrict__ fr0,
           const float* __restrict__ taps, float2* __restrict__ y,
           float2* __restrict__ tail_out, float* __restrict__ ph_out,
           float* __restrict__ fr_out, int C, int T, int sb, int K,
           float beta, float max_freq, float inv_sb, float sb_f,
           float two_pi) {
    extern __shared__ float4 smem4[];
    float4* s_tap = smem4;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int pw = plane_words(sb, K);
    float* s_r = reinterpret_cast<float*>(smem4 + K) + warp * 2 * pw;
    float* s_i = s_r + pw;
    for (int j = threadIdx.x; j < K; j += kWarps * 32)
        s_tap[j] = make_float4(taps[j], taps[K + j], taps[2 * K + j],
                               taps[3 * K + j]);
    // the words past the last sub-block sample, which ragged lanes' rings
    // read, hold zeros
    for (int i = lane; i < 2 * pw; i += 32) s_r[i] = 0.0f;
    __syncthreads();
    const int row = blockIdx.x * kWarps + warp;
    if (row >= C) return;  // no barrier follows

    const int k1 = K - 1;
    for (int i = lane; i < k1; i += 32) {
        const float2 v = tail0[(size_t)row * k1 + i];
        s_r[padded(i)] = v.x;
        s_i[padded(i)] = v.y;
    }
    float ph = ph0[row];
    float fr = fr0[row];
    const size_t x_row = (size_t)row * T;
    const int n_sub = T / sb;
    for (int k = 0; k < n_sub; ++k) {
        const size_t n0 = x_row + (size_t)k * sb;
        __syncwarp();  // the tail is in place
        // 1. derotate
        for (int n = lane; n < sb; n += 32) {
            const float ar = xr[n0 + n];
            const float ai = xi != nullptr ? xi[n0 + n] : 0.0f;
            const float p = __fadd_rn(ph, __fmul_rn(fr, (float)n));
            const float c = cosf(p);
            const float s = -sinf(p);
            const float yr = __fsub_rn(__fmul_rn(ar, c), __fmul_rn(ai, s));
            const float yi = __fadd_rn(__fmul_rn(ar, s), __fmul_rn(ai, c));
            s_r[padded(k1 + n)] = yr;
            s_i[padded(k1 + n)] = yi;
            y[n0 + n] = make_float2(yr, yi);
        }
        __syncwarp();
        // 2. both FIRs and the lane's share of the energy sum
        float e_sum = 0.0f;
        for (int m0 = lane * kR; m0 < sb; m0 += kPass) {
            // logical word m0 + c at q[c + c / kR] for c < 2 kR; after b
            // groups of kR taps, word m0 + b kR + c at q[c + c / kR] with
            // q = p + b (kR + 1)
            const int q0 = (m0 / kR) * (kR + 1);
            const float* qr = s_r + q0;
            const float* qi = s_i + q0;
            float urr[kR], uir[kR], uri[kR], uii[kR];
            float lrr[kR], lir[kR], lri[kR], lii[kR];
            float wr[kR], wi[kR];
#pragma unroll
            for (int v = 0; v < kR; ++v) {
                urr[v] = uir[v] = uri[v] = uii[v] = 0.0f;
                lrr[v] = lir[v] = lri[v] = lii[v] = 0.0f;
            }
#pragma unroll
            for (int s = 0; s < kR - 1; ++s) {
                wr[s] = qr[s];
                wi[s] = qi[s];
            }
            // step u of a group: sample u + kR - 1 enters slot
            // (u + kR - 1) mod kR, and output v adds tap j times sample
            // j + v, from slot (u + v) mod kR
            const auto step = [&](const int u, const float4 t) {
                constexpr int kLast = kR - 1;
                const int c = u + kLast;
                wr[(u + kLast) % kR] = qr[c + c / kR];
                wi[(u + kLast) % kR] = qi[c + c / kR];
#pragma unroll
                for (int v = 0; v < kR; ++v) {
                    const float sr = wr[(u + v) % kR];
                    const float si = wi[(u + v) % kR];
                    urr[v] = fmaf(t.x, sr, urr[v]);
                    uir[v] = fmaf(t.x, si, uir[v]);
                    uri[v] = fmaf(t.y, sr, uri[v]);
                    uii[v] = fmaf(t.y, si, uii[v]);
                    lrr[v] = fmaf(t.z, sr, lrr[v]);
                    lir[v] = fmaf(t.z, si, lir[v]);
                    lri[v] = fmaf(t.w, sr, lri[v]);
                    lii[v] = fmaf(t.w, si, lii[v]);
                }
            };
            const int n_grp = K / kR;
            const int rem = K - n_grp * kR;
            const float4* h = s_tap;
            for (int b = 0; b < n_grp; ++b, qr += kR + 1, qi += kR + 1,
                     h += kR) {
#pragma unroll
                for (int u = 0; u < kR; ++u) step(u, h[u]);
            }
#pragma unroll
            for (int u = 0; u < kR - 1; ++u)
                if (u < rem) step(u, h[u]);
#pragma unroll
            for (int v = 0; v < kR; ++v) {
                if (m0 + v < sb) {
                    const float ur = __fsub_rn(urr[v], uii[v]);
                    const float ui = __fadd_rn(uri[v], uir[v]);
                    const float lr = __fsub_rn(lrr[v], lii[v]);
                    const float li = __fadd_rn(lri[v], lir[v]);
                    const float e = __fsub_rn(
                        __fadd_rn(__fmul_rn(ur, ur), __fmul_rn(ui, ui)),
                        __fadd_rn(__fmul_rn(lr, lr), __fmul_rn(li, li)));
                    e_sum = __fadd_rn(e_sum, e);
                }
            }
        }
        // 3. the sum over the warp, the same bits in every lane; the update
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            e_sum = __fadd_rn(e_sum, __shfl_xor_sync(0xffffffffu, e_sum,
                                                     off));
        const float err = fminf(fmaxf(__fmul_rn(e_sum, inv_sb), -1.0f),
                                1.0f);
        const float fr_new = fminf(
            fmaxf(__fadd_rn(fr, __fmul_rn(beta, err)), -max_freq), max_freq);
        float r = fmodf(__fadd_rn(ph, __fmul_rn(fr, sb_f)), two_pi);
        if (r < 0.0f) r = __fadd_rn(r, two_pi);
        ph = r;
        fr = fr_new;
        // the next tail: words sb .. sb + K - 2 to the head
        float tr[2], ti[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int i = lane + 32 * h;
            if (i < k1) {
                tr[h] = s_r[padded(sb + i)];
                ti[h] = s_i[padded(sb + i)];
            }
        }
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int i = lane + 32 * h;
            if (i < k1) {
                s_r[padded(i)] = tr[h];
                s_i[padded(i)] = ti[h];
            }
        }
    }
    __syncwarp();
    for (int i = lane; i < k1; i += 32)
        tail_out[(size_t)row * k1 + i] =
            make_float2(s_r[padded(i)], s_i[padded(i)]);
    if (lane == 0) {
        ph_out[row] = ph;
        fr_out[row] = fr;
    }
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes; -1 for a K the kernel does
// not take.
long long fll_band_edge_smem_bytes(int sb, int K) {
    if (sb < 1 || K < 2 || K > kMaxK) return -1;
    return smem_bytes(sb, K);
}

// xr, xi: contiguous (C, T) f32, the input's planes; xi null for real
// input. tail0, tail_out: contiguous (C, K-1) complex64; ph0,
// fr0, ph_out, fr_out: (C,) f32; taps: contiguous (4, K), the flipped
// upper re, upper im, lower re and lower im taps; y: contiguous (C, T)
// complex64. T a multiple of sb. Returns a CUDA error code, 0 after a clean
// launch.
int fll_band_edge_f32(const void* xr, const void* xi, const void* tail0, const void* ph0, const void* fr0,
                      const void* taps, void* y, void* tail_out,
                      void* ph_out, void* fr_out, int C, int T, int sb,
                      int K, float beta, float max_freq, float inv_sb,
                      float sb_f, float two_pi, void* stream) {
    if (C < 1 || T < 0 || sb < 1 || T % sb || K < 2 || K > kMaxK)
        return (int)cudaErrorInvalidValue;
    const long long smem = smem_bytes(sb, K);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((C + kWarps - 1) / kWarps);
    fll_kernel<<<grid, kWarps * 32, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)xr, (const float*)xi, (const float2*)tail0,
        (const float*)ph0, (const float*)fr0, (const float*)taps, (float2*)y,
        (float2*)tail_out, (float*)ph_out, (float*)fr_out, C, T, sb, K, beta,
        max_freq, inv_sb, sb_f, two_pi);
    return (int)cudaGetLastError();
}

const char* fll_band_edge_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// pfb_channelize_f32: the whole polyphase filter-bank channelizer in one
// kernel (commutator, branch FIR and the M-point DFT across branches), for
// B streams of f32 (re, im) planes with a carried raw-history state.
//
// Replaces the Pallas TPU kernel of qradiolink_tpu/ops/pallas_pfb.py
// `channelize` -> `_fused_call` (pallas_pfb.py:186) at the shapes that
// csrc/pfb_fft.cu (pfb_fft_f32) has no instance for; ops/cuda_pfb.route()
// says which kernel takes a call. No registry path runs it: MMDVMmulti's
// channelizer (M 10, kp 56), its last path, went to pfb_fft_f32, and
// chip_smoke.py times the two there in turns. Its lane packing
// (`_pack`, the g_str/fold plan) exists only because Mosaic cannot copy
// windows narrower than 128 lanes; here rows of the input are contiguous
// memory and nothing is packed.
//
// Function (pallas_pfb.py:12-24). View each stream as x2d[t][c] =
// x[t*M + c], t in [0, Tm), with rows t in [-kp, 0) taken from the raw
// history: hist[(kp + t)*M + c] (its kp*M samples are those rows; element
// 0 is only ever multiplied by a zero tap). Then
//     v[t][c] = sum_{l=0..kp} ct[l][c] * x2d[t - l][c]
// (ct folds the commutator's one-row delay of columns c >= 1 and the
// branch order q = M-1-p into per-column taps), and with the columns taken
// in polyphase order, v'[t][p] = v[t][(M - p) mod M],
//     y[k][t] = sum_p exp(+2 pi i k p / M) * v'[t][p]
// (the TPU kernel's column-permuted inverse DFT matrix W). Output: y_re,
// y_im of shape (B, M, Tm), each channel's samples contiguous.
//
// The DFT is factored once, M = M1 * M2 (M1 the largest divisor with
// M1^2 <= M; M1 = 1 leaves one dense DFT): with p = p1 + M1 p2 and
// k = k2 + M2 k1,
//     z[k2][p1] = sum_p2 A[p1][p2][k2] v'[p1 + M1 p2],
//                 A[p1][p2][k2] = exp(2 pi i k2 (p1 + M1 p2) / M)
//     y[k2 + M2 k1] = sum_p1 Bt[p1][k1] z[k2][p1],
//                 Bt[p1][k1] = exp(2 pi i k1 p1 / M1)
// so a row costs M (M1 + M2) complex multiply-adds instead of M^2 (1,024
// against 4,096 at M = 64). The tables come from the caller (`pfb_tables`
// in ops/cuda_pfb.py), each k axis padded with zeros to a multiple of 8.
//
// Design: a persistent grid (as many blocks as fit on the card), each
// block looping over tiles of TT = 64 rows of one stream. Once per block,
// ct and the DFT tables are staged in shared memory. Per tile:
//   1. stage rows [t0 - kp, t0 + TT) of both planes as they lie in memory
//      (row-major, one contiguous span a plane; float4 copies when M is a
//      multiple of 4), rows before the block from the history;
//   2. column FIR: one thread per (column, 8 rows) slides an 8-row window
//      of both planes down l = 0 .. kp in registers (one shared load a
//      plane and one tap load per 16 FMAs), and stores v in polyphase
//      order, planes (plane, p, row) with an odd row stride;
//   3. DFT stage 1, one thread per (p1, row), into z over the staged rows'
//      space, and stage 2, one thread per (k2, row), straight to global
//      memory, a warp's 32 rows of a channel in one coalesced store.
// Every sum is f32 FMAs in a fixed order (no TF32, no tensor cores). The
// launcher reads the SM count once per device and the occupancy once per
// device and shared-memory size.
//
// What held it back at M 10, kp 56 (0.0183 ms for one site's 4 MB, 6.5%
// of the bound, on an H100): each 64-row tile's four phases run one after
// another behind barriers with no copy in flight during the compute; the
// kp = 56 halo rows are staged again every tile (120 rows read for 64); the
// column FIR has M x 64/8 = 80 jobs for 256 threads; and the launcher
// queried the CUDA runtime (device, SM count, occupancy) on every call.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at the main path's B = 1, M = 64, Tm = 100,000, kp = 24: the
// input, history and output move about 102 MB (>= 0.031 ms); the FIR is
// 0.64 GFLOP and an FFT-cost DFT about 0.2 GFLOP, so the kernel is
// bytes-bound. This kernel does 1.46 GFLOP (the factored DFT does 0.82),
// about 0.022 ms at the f32 rate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTT = 64;       // x2d rows (output samples per channel) per tile
constexpr int kVS = kTT + 1;  // row stride of the v and z planes, odd
constexpr int kR = 8;         // FIR rows per thread
constexpr int kKC = 8;        // DFT outputs per thread per pass
constexpr int kMaxDev = 64;
constexpr int kSlots = 8;     // shared-memory sizes remembered a device

__host__ __device__ inline int pad8(int n) { return (n + kKC - 1) / kKC * kKC; }
__host__ __device__ inline long long pad4(long long n) { return (n + 3) / 4 * 4; }

struct Layout {
    int M2, MP1, MP2;
    long long v, ct, tab, total;  // float offsets; the staged x is at 0
};

__host__ __device__ inline Layout layout(int M, int kp, int M1) {
    Layout L;
    L.M2 = M / M1;
    L.MP1 = pad8(M1);
    L.MP2 = pad8(L.M2);
    // the staged rows, later z (2 * M * kVS <= 2 * (kTT + kp) * M)
    L.v = pad4(2LL * (kTT + kp) * M);
    L.ct = L.v + pad4(2LL * M * kVS);
    L.tab = L.ct + pad4((long long)(kp + 1) * M);
    L.total = L.tab + 2LL * M1 * (L.M2 * L.MP2 + L.MP1);
    return L;
}

__device__ inline void load8(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__global__ void __launch_bounds__(kThreads, 2)
pfb_channelize_kernel(const float* __restrict__ x_re,
                      const float* __restrict__ x_im,
                      const float* __restrict__ hist,
                      const float* __restrict__ ct,
                      const float* __restrict__ dft,
                      float* __restrict__ y_re, float* __restrict__ y_im,
                      int B, int Tm, int M, int kp, int M1) {
    extern __shared__ __align__(16) float smem[];
    const Layout L = layout(M, kp, M1);
    const int M2 = L.M2, MP1 = L.MP1, MP2 = L.MP2;
    float* s_x = smem;           // [plane][staged row][c]
    float* s_z = smem;           // [plane][k2*M1 + p1][row], after the FIR
    float* s_v = smem + L.v;     // [plane][p][row], polyphase order
    float* s_ct = smem + L.ct;   // [l][c]
    float* s_ar = smem + L.tab;  // [p1][p2][k2], k2 padded to MP2
    float* s_ai = s_ar + M1 * M2 * MP2;
    float* s_br = s_ai + M1 * M2 * MP2;  // [p1][k1], k1 padded to MP1
    float* s_bi = s_br + M1 * MP1;
    const int tid = threadIdx.x;

    const int n_tab = 2 * M1 * (M2 * MP2 + MP1);
    for (int e = tid; e < n_tab; e += kThreads) s_ar[e] = dft[e];
    for (int e = tid; e < (kp + 1) * M; e += kThreads) s_ct[e] = ct[e];

    const int n_tiles = (Tm + kTT - 1) / kTT;
    const int n = (kTT + kp) * M;  // staged floats a plane
    const long long T = (long long)Tm * M;
    const bool vec = (M & 3) == 0;

    for (int tile = blockIdx.x; tile < n_tiles * B; tile += gridDim.x) {
        const int b = tile / n_tiles;
        const int t0 = (tile - b * n_tiles) * kTT;
        const long long f0 = (long long)(t0 - kp) * M;
        __syncthreads();  // the last tile's readers of s_x, s_z are done

        // 1. stage rows [t0 - kp, t0 + TT): flat f < 0 from the history
        //    (h[f], its last kp*M samples), f >= T zero
        for (int p = 0; p < 2; ++p) {
            const float* x = (p ? x_im : x_re) + (long long)b * T;
            const float* h = hist + ((long long)b * 2 + p + 1) * kp * M;
            float* dst = s_x + p * n;
            if (vec) {
#pragma unroll 4
                for (int e = tid * 4; e < n; e += kThreads * 4) {
                    const long long f = f0 + e;
                    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                    if (f < 0)
                        val = __ldg(reinterpret_cast<const float4*>(h + f));
                    else if (f < T)
                        val = __ldg(reinterpret_cast<const float4*>(x + f));
                    *reinterpret_cast<float4*>(dst + e) = val;
                }
            } else {
                for (int e = tid; e < n; e += kThreads) {
                    const long long f = f0 + e;
                    dst[e] = f < 0 ? __ldg(h + f) : (f < T ? __ldg(x + f)
                                                           : 0.0f);
                }
            }
        }
        __syncthreads();

        // 2. column FIR, both planes: v[m][c] = sum_l ct[l][c] x2d[m - l][c]
        //    over tile rows m0 .. m0+7 (staged row kp + m)
        for (int job = tid; job < M * (kTT / kR); job += kThreads) {
            const int c = job % M, m0 = job / M * kR;
            const float* xr = s_x + (kp + m0) * M + c;
            const float* xi = xr + n;
            float wr[kR], wi[kR], ar[kR], ai[kR];
            const float h0 = s_ct[c];
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                wr[j] = xr[j * M];
                wi[j] = xi[j * M];
                ar[j] = wr[j] * h0;
                ai[j] = wi[j] * h0;
            }
#pragma unroll 4
            for (int l = 1; l <= kp; ++l) {
#pragma unroll
                for (int j = kR - 1; j > 0; --j) {
                    wr[j] = wr[j - 1];
                    wi[j] = wi[j - 1];
                }
                wr[0] = xr[-l * M];
                wi[0] = xi[-l * M];
                const float h = s_ct[l * M + c];
#pragma unroll
                for (int j = 0; j < kR; ++j) {
                    ar[j] = fmaf(wr[j], h, ar[j]);
                    ai[j] = fmaf(wi[j], h, ai[j]);
                }
            }
            const int p = c ? M - c : 0;
            float* vr = s_v + p * kVS + m0;
            float* vi = vr + M * kVS;
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                vr[j] = ar[j];
                vi[j] = ai[j];
            }
        }
        __syncthreads();

        // 3. DFT stage 1: z[k2][p1] = sum_p2 A[p1][p2][k2] v'[p1 + M1 p2]
        for (int job = tid; job < M1 * kTT; job += kThreads) {
            const int m = job % kTT, p1 = job / kTT;
            for (int k0 = 0; k0 < M2; k0 += kKC) {
                float zr[kKC], zi[kKC];
#pragma unroll
                for (int i = 0; i < kKC; ++i) zr[i] = zi[i] = 0.0f;
                for (int p2 = 0; p2 < M2; ++p2) {
                    const int p = p1 + M1 * p2;
                    const float vr = s_v[p * kVS + m];
                    const float vi = s_v[(M + p) * kVS + m];
                    const int o = (p1 * M2 + p2) * MP2 + k0;
                    float wr[kKC], wi[kKC];
                    load8(s_ar + o, wr);
                    load8(s_ai + o, wi);
#pragma unroll
                    for (int i = 0; i < kKC; ++i) {
                        zr[i] = fmaf(wr[i], vr, zr[i]);
                        zr[i] = fmaf(-wi[i], vi, zr[i]);
                        zi[i] = fmaf(wr[i], vi, zi[i]);
                        zi[i] = fmaf(wi[i], vr, zi[i]);
                    }
                }
#pragma unroll
                for (int i = 0; i < kKC; ++i) {
                    const int k2 = k0 + i;
                    if (k2 < M2) {
                        s_z[(k2 * M1 + p1) * kVS + m] = zr[i];
                        s_z[(M + k2 * M1 + p1) * kVS + m] = zi[i];
                    }
                }
            }
        }
        __syncthreads();

        // 4. DFT stage 2: y[k2 + M2 k1] = sum_p1 Bt[p1][k1] z[k2][p1]
        for (int job = tid; job < M2 * kTT; job += kThreads) {
            const int m = job % kTT, k2 = job / kTT;
            const int t = t0 + m;
            for (int k0 = 0; k0 < M1; k0 += kKC) {
                float yr[kKC], yi[kKC];
#pragma unroll
                for (int i = 0; i < kKC; ++i) yr[i] = yi[i] = 0.0f;
                for (int p1 = 0; p1 < M1; ++p1) {
                    const float zr = s_z[(k2 * M1 + p1) * kVS + m];
                    const float zi = s_z[(M + k2 * M1 + p1) * kVS + m];
                    float wr[kKC], wi[kKC];
                    load8(s_br + p1 * MP1 + k0, wr);
                    load8(s_bi + p1 * MP1 + k0, wi);
#pragma unroll
                    for (int i = 0; i < kKC; ++i) {
                        yr[i] = fmaf(wr[i], zr, yr[i]);
                        yr[i] = fmaf(-wi[i], zi, yr[i]);
                        yi[i] = fmaf(wr[i], zi, yi[i]);
                        yi[i] = fmaf(wi[i], zr, yi[i]);
                    }
                }
                if (t < Tm) {
#pragma unroll
                    for (int i = 0; i < kKC; ++i) {
                        const int k1 = k0 + i;
                        if (k1 < M1) {
                            const long long o =
                                ((long long)b * M + k2 + M2 * k1) * Tm + t;
                            y_re[o] = yr[i];
                            y_im[o] = yi[i];
                        }
                    }
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
long long pfb_smem_bytes(int M, int kp, int M1) {
    return layout(M, kp, M1).total * (long long)sizeof(float);
}

// x_re/x_im: contiguous (B, Tm*M); hist: contiguous (B, 2, kp*M); ct:
// contiguous (kp+1, M); dft: the factored DFT tables, A re, A im
// (M1, M2, MP2 each), Bt re, Bt im (M1, MP1 each), contiguous; y_re/y_im:
// contiguous (B, M, Tm). M1 must divide M. Returns a CUDA error code, 0
// after a clean launch.
int pfb_channelize_f32(const void* x_re, const void* x_im, const void* hist,
                       const void* ct, const void* dft, void* y_re,
                       void* y_im, int B, int Tm, int M, int kp, int M1,
                       void* stream) {
    // per device: the SM count, the largest dynamic shared memory set so
    // far, and (shared bytes, blocks an SM) for the sizes launched
    static int sms[kMaxDev], smem_set[kMaxDev];
    static int occ_smem[kMaxDev][kSlots], occ_blocks[kMaxDev][kSlots];
    const int smem = (int)pfb_smem_bytes(M, kp, M1);
    cudaError_t e;
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if (dev >= kMaxDev) return (int)cudaErrorInvalidDevice;
    if (smem > 48 * 1024 && smem > smem_set[dev]) {
        e = cudaFuncSetAttribute(pfb_channelize_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        if (e != cudaSuccess) return (int)e;
        smem_set[dev] = smem;
    }
    if (sms[dev] == 0 &&
        (e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
        return (int)e;
    int per_sm = 0, slot = 0;
    while (slot < kSlots && occ_blocks[dev][slot] != 0 &&
           occ_smem[dev][slot] != smem)
        ++slot;
    if (slot < kSlots && occ_blocks[dev][slot] != 0) {
        per_sm = occ_blocks[dev][slot];
    } else {
        if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, pfb_channelize_kernel, kThreads, smem)) !=
            cudaSuccess)
            return (int)e;
        per_sm = per_sm > 0 ? per_sm : 1;
        if (slot < kSlots) {
            occ_smem[dev][slot] = smem;
            occ_blocks[dev][slot] = per_sm;
        }
    }
    const long long tiles = (long long)B * ((Tm + kTT - 1) / kTT);
    long long grid = (long long)sms[dev] * per_sm;
    if (grid > tiles) grid = tiles;
    pfb_channelize_kernel<<<(int)grid, kThreads, (size_t)smem,
                            (cudaStream_t)stream>>>(
        (const float*)x_re, (const float*)x_im, (const float*)hist,
        (const float*)ct, (const float*)dft, (float*)y_re, (float*)y_im, B,
        Tm, M, kp, M1);
    return (int)cudaGetLastError();
}

const char* pfb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// depthwise_run_f32: stride-1 FIR with its own taps on every row, over one
// or two f32 planes, each block walking a contiguous run of one row with
// the row's taps in registers and its samples staged asynchronously; for
// kp in {23, 24, 53} taps a row.
//
// Replaces the Pallas TPU kernel of qradiolink_tpu/ops/pallas_fir.py
// `depthwise_fir` -> `_depthwise_call` (pallas_fir.py:401) at those kp: the
// PFB synthesizer's branch filters (kp 23 at M 8-64 with default taps; kp
// 53 in MMDVMmulti's synthesizer, M 10) and the channelizer's on complex
// input (kp 24, rounded up to a multiple of 8). Every other kp stays on
// csrc/depthwise.cu (depthwise_fir_f32), and ops/cuda_depthwise.route()
// says which kernel takes a call.
//
// Function, for row r with tf the flipped taps of its filter c = r mod C
// (tf[c][j] = taps[c][kp-1-j]), over the virtual row xc = [halo (kp-1) |
// body (n_out)]:
//     y[r][m] = sum_{j<kp} tf[c][j] * xc[m + j],   m in [0, n_out)
// Two forms fill xc. The tail form: the halo is the carried tail, read in
// place from the (..., 2, C, kp-1) state, and the body the block x (the
// synthesizer: the concatenation is never built). The VALID form: xc is
// the input row itself, halo its first kp-1 samples (the channelizer's
// commutated rows). The kernel sees both as a halo pointer and a body
// pointer per row, each with an outer and an inner row stride.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores) at the synthesizer's shape (64 rows x 100,000 outputs, kp 23, two
// planes): 102.4 MB in and out, >= 0.031 ms; 0.59 GFLOP, 0.009 ms. Bytes-
// bound: a device copy of the same bytes took 0.043 ms on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py). csrc/depthwise.cu took 0.071 ms:
// 25,088 blocks, each staging its span with 4-byte loads behind one
// barrier (no overlap within a block), 5 shared loads and a bounds test
// for every 4 FMAs, 4-byte stores. At kp 53 (MMDVMmulti, 10 rows) one site
// moves 4 MB (0.0012 ms) and 64 sites 256 MB (0.076 ms) against 3.4 GFLOP
// (0.051 ms): still bytes-bound, but the FMAs are two thirds of it, so the
// inner loop must stay FMA-dense (4 kp FMAs to kp/4 + 1 shared loads).
//
// Design, after csrc/pfb_fft.cu: a grid of (plane, row, run) blocks of 128
// threads, each run a contiguous range of the row's outputs that starts at
// a multiple of 4. Runs: the blocks the card holds over planes x rows (at
// least 2 an SM; 128 row-planes alone would be under one), at most one a
// kSubTT = 512 outputs (one group of 4 a thread). A short row therefore
// still spreads over the card: 10 rows x 2 planes x 3,000 outputs (the
// headless MMDVMmulti block) run as 6 runs a row-plane, 120 blocks that
// cover the card once, where a cap of one run a tile gave 40. A block
// walks its run in tiles of kTT = 2048 outputs:
//   * Staging: a ring of 2 stages, each [halo room | tile body]. The next
//     tile's body is copied with 16-byte cp.async while this tile computes
//     (one tile ahead: in pfb_fft_f32 a ring of 2 stages measured faster
//     than 3, scripts/pfb_fft_ring.py). Body sample m0 + i sits at stage
//     word HB + mis + i, mis = the body pointer's float offset within 16
//     bytes (0 for the synthesizer's rows, any for the channelizer's
//     100,023-sample rows):
//     the chunks inside the body go as 16-byte copies, the samples of a
//     chunk that straddles the body's ends as 4-byte copies. When a tile
//     starts, its last kp-1 body samples are copied into the next stage's
//     halo; only a run's first tile reads its halo from device memory (the
//     tail, or the body before the run).
//   * Compute: thread t owns the kR = 4 consecutive outputs i0 = u*512 +
//     4t (u < kSub = 4) of a tile. It reads its window of kp + 3 samples
//     as aligned float4s (a warp's lanes on consecutive 16 bytes: no bank
//     conflict), at a word offset OFF = (mis + 1 - kp) mod 4 that is one
//     value a block, so the four OFF are four instances of the loop and
//     every register index is a compile-time constant. Sample s of the
//     window feeds output o with tap s - o: kp + 3 samples, 4 kp FMAs and
//     one 16-byte store for 4 outputs (4-byte stores on a row that is not
//     16-byte aligned).
//   * Registers: the kp taps and the window of kp + 3 samples stay in
//     registers (about 2 kp + 10). At kp <= 32 the block asks for 4 blocks
//     an SM (128 registers a thread); at kp 53 for 2 (up to 255), so that
//     ptxas does not spill, and the SM holds what the registers allow.
// Sum order: each output accumulates tf[0], tf[1], ..., tf[kp-1] in order
// with fmaf from 0.0f, depthwise_fir_f32's order, so the two kernels'
// outputs are equal bit for bit (chip_smoke.py checks this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 4;                        // outputs a thread at once
constexpr int kSub = 4;                      // groups of kR a thread a tile
constexpr int kSubTT = kThreads * kR;       // outputs of one group a thread
constexpr int kTT = kSubTT * kSub;           // outputs a tile
constexpr int kStages = 2;                   // staging ring
constexpr int kMaxDev = 64;

// words before the body in a stage: room for the halo, a multiple of 4
__host__ __device__ constexpr int halo_room(int KP) {
    return (KP - 1 + 3) & ~3;
}
// words a stage: halo room, mis <= 3, a tile, and the float4s that the
// last thread's window reads past it
__host__ __device__ constexpr int stage_words(int KP) {
    return halo_room(KP) + kTT + 8;
}
__host__ __device__ constexpr int smem_bytes(int KP) {
    return 4 * kStages * stage_words(KP);
}
// blocks an SM the instance asks registers for: 4 (128 registers a thread)
// while the taps and window fit, 2 (up to 255) above kp 32
__host__ __device__ constexpr int min_blocks(int KP) {
    return KP > 32 ? 2 : 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Body samples [m0, m0 + n) of a row into stage words HB + mis + i: the
// 16-byte chunks c (samples 4c - mis .. 4c - mis + 3 of the tile) that lie
// inside the body whole, and the body samples of the others one by one.
template <int KP>
__device__ __forceinline__ void stage_body(float* st, const float* bp,
                                           int m0, int n, int mis) {
    float* dst = st + halo_room(KP);
    const float* src = bp + m0 - mis;  // 16-byte aligned
    const int n_ch = (mis + n + 3) >> 2;
    for (int c = threadIdx.x; c < n_ch; c += kThreads) {
        const int i = 4 * c - mis;
        if (i >= 0 && i + 4 <= n) {
            cp_async16(dst + 4 * c, src + 4 * c);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (i + k >= 0 && i + k < n)
                    cp_async4(dst + 4 * c + k, src + 4 * c + k);
        }
    }
}

// One tile's outputs [m0, m0 + n) from the stage st; OFF is the window's
// word offset within its first float4.
template <int KP, int OFF>
__device__ __forceinline__ void compute_tile(const float* st,
                                             const float (&tap)[KP],
                                             float* y, int m0, int n,
                                             int mis, bool vec) {
    constexpr int NV = (OFF + KP + kR - 1 + 3) / 4;  // float4 a window
    // the first output's window starts at word HB + mis - (KP - 1)
    const float* w0 = st + halo_room(KP) + mis - (KP - 1) - OFF;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
        const int i0 = u * kThreads * kR + threadIdx.x * kR;
        if (i0 >= n) break;
        const float4* wp = reinterpret_cast<const float4*>(w0 + i0);
        float win[4 * NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
            const float4 f = wp[v];
            win[4 * v] = f.x;
            win[4 * v + 1] = f.y;
            win[4 * v + 2] = f.z;
            win[4 * v + 3] = f.w;
        }
        float acc[kR];
#pragma unroll
        for (int o = 0; o < kR; ++o) acc[o] = 0.0f;
#pragma unroll
        for (int s = 0; s < KP + kR - 1; ++s) {
#pragma unroll
            for (int o = 0; o < kR; ++o) {
                const int j = s - o;
                if (j >= 0 && j < KP)
                    acc[o] = fmaf(tap[j], win[OFF + s], acc[o]);
            }
        }
        float* yp = y + m0 + i0;
        if (vec && i0 + kR <= n) {
            *reinterpret_cast<float4*>(yp) =
                make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
            for (int o = 0; o < kR; ++o)
                if (i0 + o < n) yp[o] = acc[o];
        }
    }
}

struct Args {
    const float *h0, *h1;      // halo (xc[0 .. kp-2]) of row 0, per plane
    long long h_outer;         // row stride across the leading axes
    int h_inner;               // row stride across C
    const float *b0, *b1;      // body (xc[kp-1 ..]) of row 0, per plane
    long long b_outer;
    int b_inner;
    const float* tf;           // (C, kp) flipped taps
    float *y0, *y1;            // contiguous (rows, n_out)
    int rows, C, n_out, planes;
    cudaStream_t stream;
};

template <int KP>
__global__ void __launch_bounds__(kThreads, min_blocks(KP))
depthwise_run_kernel(const Args a, int runs) {
    constexpr int SW = stage_words(KP);
    constexpr int HB = halo_room(KP);
    extern __shared__ __align__(16) float smem[];

    const int run = blockIdx.x % runs;
    const int rp = blockIdx.x / runs;
    const int plane = rp / a.rows;
    const int row = rp - plane * a.rows;
    const int c = row % a.C;
    const long long outer = row / a.C;
    const float* hp = (plane ? a.h1 : a.h0) + outer * a.h_outer +
                      (long long)c * a.h_inner;
    const float* bp = (plane ? a.b1 : a.b0) + outer * a.b_outer +
                      (long long)c * a.b_inner;
    float* y = (plane ? a.y1 : a.y0) + (long long)row * a.n_out;

    // this run's outputs [s, e), s a multiple of 4
    const int n4 = (a.n_out + 3) >> 2;
    const int s = (int)((long long)run * n4 / runs) * 4;
    const int e = min((int)((long long)(run + 1) * n4 / runs) * 4, a.n_out);
    if (s >= e) return;  // the whole block; no barrier was passed

    float tap[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j) tap[j] = a.tf[c * KP + j];
    const int mis = (int)((reinterpret_cast<uintptr_t>(bp) >> 2) & 3);
    const int off = (mis + 1 - KP) & 3;
    const bool vec = (reinterpret_cast<uintptr_t>(y) & 15) == 0;

    // prologue: the first tile's halo (from the tail or the body before the
    // run) and body
    for (int h = threadIdx.x; h < KP - 1; h += kThreads) {
        const int g = s - (KP - 1) + h;  // body index
        cp_async4(smem + HB + mis - (KP - 1) + h,
                  g >= 0 ? bp + g : hp + (KP - 1) + g);
    }
    stage_body<KP>(smem, bp, s, min(kTT, e - s), mis);
    cp_async_commit();

    const int n_tiles = (e - s + kTT - 1) / kTT;
    for (int k = 0; k < n_tiles; ++k) {
        const int m0 = s + k * kTT;
        const int n = min(kTT, e - m0);
        const float* cur = smem + (k % kStages) * SW;
        // this thread's copies of tile k have landed, then everyone's; and
        // every thread is done with tile k-1, whose stage is next
        cp_async_wait_all();
        __syncthreads();
        if (k + 1 < n_tiles) {
            float* nxt = smem + ((k + 1) % kStages) * SW;
            const int m1 = m0 + kTT;
            stage_body<KP>(nxt, bp, m1, min(kTT, e - m1), mis);
            cp_async_commit();
            // tile k is whole: its last KP-1 samples are tile k+1's halo
            for (int h = threadIdx.x; h < KP - 1; h += kThreads)
                nxt[HB + mis - (KP - 1) + h] =
                    cur[HB + mis + kTT - (KP - 1) + h];
        }
        switch (off) {
            case 0: compute_tile<KP, 0>(cur, tap, y, m0, n, mis, vec); break;
            case 1: compute_tile<KP, 1>(cur, tap, y, m0, n, mis, vec); break;
            case 2: compute_tile<KP, 2>(cur, tap, y, m0, n, mis, vec); break;
            default: compute_tile<KP, 3>(cur, tap, y, m0, n, mis, vec);
        }
    }
}

// The run count on a device where an SM holds `held` blocks of the
// instance: the blocks the card holds over the lanes (row-planes), at least
// 1 and at most one a kSubTT outputs.
long long auto_runs(int held, int sms, long long lanes, int n_out) {
    const long long cap = (n_out + kSubTT - 1) / kSubTT;
    const long long runs = held * (long long)sms / lanes;
    return runs < 1 ? 1 : (runs > cap ? cap : runs);
}

// Launches the instance on `a` with `runs` runs a row-plane (0: auto_runs).
// The first call on a device sets the shared-memory attribute and reads
// the occupancy and the SM count; `plan_only` returns the run count that a
// launch would use and launches nothing.
template <int KP>
long long launch(const Args& a, int runs_asked, bool plan_only) {
    static int held[kMaxDev], sms[kMaxDev];  // 0 until read
    constexpr int smem = smem_bytes(KP);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return -(long long)e;
    if (dev >= kMaxDev) return -(long long)cudaErrorInvalidDevice;
    if (held[dev] == 0) {
        if (smem > 48 * 1024 &&
            (e = cudaFuncSetAttribute(
                 depthwise_run_kernel<KP>,
                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
                cudaSuccess)
            return -(long long)e;
        if ((e = cudaDeviceGetAttribute(&sms[dev],
                                        cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess)
            return -(long long)e;
        int n = 0;
        if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, depthwise_run_kernel<KP>, kThreads, smem)) !=
            cudaSuccess)
            return -(long long)e;
        held[dev] = n > 0 ? n : 1;
    }
    const long long lanes = (long long)a.rows * a.planes;
    const long long runs = runs_asked > 0
                               ? runs_asked
                               : auto_runs(held[dev], sms[dev], lanes,
                                           a.n_out);
    if (lanes * runs > 0x7fffffffLL) return -(long long)cudaErrorInvalidValue;
    if (plan_only) return runs;
    depthwise_run_kernel<KP><<<(unsigned)(lanes * runs), kThreads, smem,
                               a.stream>>>(a, (int)runs);
    return -(long long)cudaGetLastError();
}

using Launch = long long (*)(const Args&, int, bool);

// The instance for kp, null for a kp the kernel does not take.
Launch pick(int kp) {
    switch (kp) {
        case 23: return launch<23>;
        case 24: return launch<24>;
        case 53: return launch<53>;
    }
    return nullptr;
}

}  // namespace

extern "C" {

// h0/h1: the halo of row (outer o, c) at h + o*h_outer + c*h_inner, kp-1
// adjacent floats; b0/b1: the body, n_out adjacent floats, likewise; taps:
// contiguous (C, kp) flipped taps, row r using taps row r mod C; y0/y1:
// contiguous (rows, n_out). rows = (leading size) * C; planes 1 or 2 (the
// *1 pointers are read only for 2); runs: the runs a row-plane, 0 for the
// launcher's own choice (auto_runs). Returns a CUDA error code, 0 after a
// clean launch.
int depthwise_run_f32(const void* h0, const void* h1, long long h_outer,
                      int h_inner, const void* b0, const void* b1,
                      long long b_outer, int b_inner,
                      const void* taps_flipped, void* y0, void* y1, int rows,
                      int C, int kp, int n_out, int planes, int runs,
                      void* stream) {
    const Launch f = pick(kp);
    if (f == nullptr || rows < 1 || C < 1 || rows % C || n_out < 1 ||
        planes < 1 || planes > 2 || runs < 0)
        return (int)cudaErrorInvalidValue;
    const Args a = {(const float*)h0, (const float*)h1, h_outer, h_inner,
                    (const float*)b0, (const float*)b1, b_outer, b_inner,
                    (const float*)taps_flipped, (float*)y0, (float*)y1,
                    rows, C, n_out, planes, (cudaStream_t)stream};
    return (int)-f(a, runs, false);
}

// The runs a row-plane that depthwise_run_f32 chooses for this shape on
// the current device (reading the device as a first launch does), or minus
// a CUDA error code.
long long depthwise_run_runs(int rows, int kp, int n_out, int planes) {
    const Launch f = pick(kp);
    if (f == nullptr || rows < 1 || n_out < 1 || planes < 1 || planes > 2)
        return -(long long)cudaErrorInvalidValue;
    Args a = {};
    a.rows = rows;
    a.C = 1;
    a.n_out = n_out;
    a.planes = planes;
    return f(a, 0, true);
}

const char* depthwise_run_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// pfb_fft_f32: the polyphase filter-bank channelizer in one kernel (column
// FIR and the M-point inverse DFT across branches, the DFT as an FFT), for
// B streams of f32 (re, im) planes with a carried raw-history state, at
// M in {8, 16, 32, 64} channels with kp in {8, 16, 24, 32} taps a branch,
// and at M 10 with kp 56 (MMDVMmulti's channelizer).
//
// Replaces the Pallas TPU kernel of qradiolink_tpu/ops/pallas_pfb.py
// `channelize` -> `_fused_call` (pallas_pfb.py:186) at those shapes; every
// other shape stays on csrc/pfb.cu (pfb_channelize_f32), and
// ops/cuda_pfb.route() says which kernel takes a call.
//
// Function (the same as pfb_channelize_f32's). View each stream as
// x2d[t][c] = x[t*M + c], t in [0, Tm), with rows t in [-kp, 0) taken from
// the raw history hist[(kp + t)*M + c]. Then
//     v[t][c] = sum_{l=0..kp} ct[l][c] * x2d[t - l][c]
// (ct from pfb_tables: column 0 uses taps 0..kp-1, the others 1..kp; the
// unused tap is a zero in the table), and with v'[t][p] = v[t][(M - p) mod
// M], the columns in polyphase order,
//     y[k][t] = sum_p exp(+2 pi i k p / M) * v'[t][p].
// Output: y_re, y_im of shape (B, M, Tm), each channel's samples contiguous.
//
// The DFT as two butterfly stages, M = R1 * R2 (Radix<M> below; the same
// table is ops/cuda_pfb.FFT_RADICES), p = p1 + R1 p2, k = k2 + R2 k1:
//     z[k2][p1] = W^(k2 p1) * sum_p2 exp(2 pi i k2 p2 / R2) v'[p1 + R1 p2]
//     y[k2 + R2 k1] = sum_p1 exp(2 pi i k1 p1 / R1) z[k2][p1]
// with W = exp(2 pi i / M). The inner sums are hard-coded radix-2, -4, -5
// and -8 butterflies (constants +-1, +-i, (+-1 +- i)/sqrt 2, and cos and
// sin of 2 pi/5 and 4 pi/5 as f32 literals of their float64 values); the
// twiddles W^(k2 p1) come from an f32 table the caller makes in float64
// and rounds once (`fft_table`, laid out [p1][k2], real parts then
// imaginary). A row costs about 5 M log2 M flops instead of the factored
// DFT's 8 M (M1 + M2).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at the mixed path's B = 1, M = 64, Tm = 100,000, kp = 24: the
// input and output planes move 102.4 MB (plus 12 KB of history and 7 KB of
// taps), >= 0.031 ms; the column FIR is 0.64 GFLOP and the FFT 0.19 GFLOP,
// >= 0.012 ms. Bytes-bound. The kernel executes about 0.32 G FMAs of FIR
// and 0.1 G instructions of FFT, ~15 us at one warp-instruction a cycle a
// scheduler on 132 SMs, so what remains is hiding the memory: the staging
// is asynchronous. At M 10, kp 56 the FIR has 57 taps a column: one site
// (Tm 25,000) moves 4 MB (0.0012 ms), a farm of 64 sites 256 MB (0.076
// ms) against 3.7 GFLOP of FIR (0.055 ms), so there the FIR's FMAs and its
// shared loads are as close to the limit as the bytes.
//
// Design: a persistent grid of B * runs blocks of NT threads (runs = the
// blocks the card holds over B, at most a stream's tiles). Block (b, r)
// owns the contiguous run of tiles [r tiles / runs, (r+1) tiles / runs) of
// stream b, a tile being TT rows, and walks it in order. Shape<M, KP>
// holds each instance's tiling: TT = 32 rows, FIR jobs of FR = 16 rows and
// 256 threads at M 8-64; TT = 128, FR = 8 and 320 threads at M 10 (below).
//   * Staging: a ring of 2 stages, each both planes of [kp halo rows | TT
//     rows] as they lie in memory (each plane's span of TT*M floats is
//     contiguous). Tile j+1's rows (j + kStages -
//     1) are copied with cp.async, 16 bytes a copy (8 at M 10, whose rows
//     of 40 bytes start 8-byte aligned), while tile j computes (one commit
//     group a tile, cp.async.wait_group 1). A ring of 3, copying two tiles
//     ahead, took about 5% longer at the mixed path's shape on an H100 SXM
//     (scripts/pfb_fft_ring.py).
//     The halo is not read again: when tile j starts, the block copies its
//     stage rows [TT, TT + kp) (the last kp rows before tile j+1, from the
//     tile and, where kp > TT, from its halo) into the halo rows of tile
//     j+1's stage. Only a run's first tile stages its halo from global
//     memory (the history for t < 0). Rows past Tm in the last tile are
//     never staged; the FIR reads whatever is there, and no output of such
//     a row is stored.
//   * Column FIR: thread (plane, column c, FR-row chunk) holds its column's
//     kp+1 taps in registers for the whole run. It reads its kp+FR input
//     rows from the stage once each and adds each into the FR sums it
//     feeds, every index a compile-time constant: kp+1 FMAs a row and one
//     shared load. The sums go to V, planes (plane, p, row) in polyphase
//     order with an odd row stride (TT + 1). At M 8-64 a warp's lanes are
//     consecutive columns of one row (4M jobs, one a thread at M = 64).
//   * FFT stage 1: thread (row, p1), a warp's lanes consecutive rows, its
//     R2 twiddles in registers: loads v'[p1 + R1 p2], runs the radix-R2
//     butterfly, multiplies by the twiddles and writes z[k2][p1] in place,
//     to slot p1 + R1 k2 (the slots it read).
//   * FFT stage 2: job (row, k2), NT at a time: loads z[k2][p1] from slots
//     p1 + R1 k2, runs the radix-R1 butterfly and stores channels k2 + R2 k1
//     to global memory, a warp's 32 rows of a channel in one 128-byte store.
// Shared memory a block: 2 stages of 2 (kp + TT) M floats and V, 2 M
// (TT + 1) floats: 72.5 KB at M = 64, kp = 24. The registers (__launch_bounds__
// (NT, 2)) hold an SM to 2 blocks. Every sum is f32 (FMAs and adds, no
// TF32, no tensor cores). The launcher sets the shared-memory attribute
// and reads the occupancy once per instance and device.
//
// M 10, kp 56. The M 8-64 tiling fails here two ways: the 56 halo rows
// outnumber a tile of 32 (so most of each stage would be halo), and 4 M =
// 40 FIR jobs would leave 216 of 256 threads idle. So: TT = 128 rows (184
// staged for 128), FIR jobs of FR = 8 rows, 2 planes x 10 columns x 16
// chunks = 320 jobs on NT = 320 threads, one each (57 taps and 8 sums in
// registers: 96 a thread, 2 blocks an SM); the FFT's stage 1 is 2 x 128
// threads (radix 5), stage 2 5 x 128 jobs (radix 2), two a thread. A job
// reads 64 words for 456 FMAs. A warp's 32 lanes span 3.2 rows of 10
// columns, 2 to a bank; a layout of the jobs on 32 banks was within 1% of
// this one at every shape, and is not kept. scripts/pfb_fft_m10_tiling.py
// times this tiling in turns with others on the card (tiles of 32 and 64
// rows, jobs of 4 rows).
#include <cuda_runtime.h>

namespace {

constexpr int kTT = 32;       // rows a tile at M 8-64: the lanes of a warp
constexpr int kRows = 16;     // FIR rows a job at M 8-64
constexpr int kStages = 2;    // staging ring
constexpr int kAhead = kStages - 1;  // tiles staged ahead of the one computed
constexpr int kMaxDev = 64;

template <int M> struct Radix;
template <> struct Radix<8>  { static constexpr int R1 = 2, R2 = 4; };
template <> struct Radix<10> { static constexpr int R1 = 2, R2 = 5; };
template <> struct Radix<16> { static constexpr int R1 = 4, R2 = 4; };
template <> struct Radix<32> { static constexpr int R1 = 4, R2 = 8; };
template <> struct Radix<64> { static constexpr int R1 = 8, R2 = 8; };

// An instance's tiling: TT rows a tile, FIR jobs of FR rows, NT threads.
template <int M, int KP> struct Shape {
    static constexpr int TT = kTT, FR = kRows, NT = 256;
};
template <> struct Shape<10, 56> {
    static constexpr int TT = 128, FR = 8, NT = 320;
};
// floats a cp.async: 16 bytes where rows of M floats keep copies aligned,
// else 8 (M 10's rows of 40 bytes)
template <int M>
__host__ __device__ constexpr int copy_floats() {
    static_assert(M % 2 == 0, "rows of an even number of floats");
    return M % 4 == 0 ? 4 : 2;
}

// floats from one plane of a stage to the next
template <int M, int KP>
__host__ __device__ constexpr int plane_stride() {
    return (KP + Shape<M, KP>::TT) * M;
}
template <int M, int KP>
__host__ __device__ constexpr int smem_bytes() {
    return 4 * (kStages * 2 * plane_stride<M, KP>() +
                2 * M * (Shape<M, KP>::TT + 1));
}

// V floats from global to shared memory, asynchronously: 16 bytes through
// L2 only (cg), 8 bytes through L1 (ca: cg takes 16 only)
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (V == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                     "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                     "l"(src)
                     : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Inverse DFT of R points in place: X[k] = sum_n x[n] exp(+2 pi i k n / R).
template <int R> struct Bfly;
template <> struct Bfly<2> {
    __device__ static void run(float* r, float* i) {
        const float ar = r[0] - r[1], ai = i[0] - i[1];
        r[0] += r[1]; i[0] += i[1];
        r[1] = ar; i[1] = ai;
    }
};
template <> struct Bfly<4> {
    __device__ static void run(float* r, float* i) {
        const float s0r = r[0] + r[2], s0i = i[0] + i[2];
        const float d0r = r[0] - r[2], d0i = i[0] - i[2];
        const float s1r = r[1] + r[3], s1i = i[1] + i[3];
        const float d1r = r[1] - r[3], d1i = i[1] - i[3];
        r[0] = s0r + s1r; i[0] = s0i + s1i;
        r[2] = s0r - s1r; i[2] = s0i - s1i;
        r[1] = d0r - d1i; i[1] = d0i + d1r;  // d0 + i d1
        r[3] = d0r + d1i; i[3] = d0i - d1r;  // d0 - i d1
    }
};
template <> struct Bfly<8> {
    __device__ static void run(float* r, float* i) {
        constexpr float h = 0.70710678118654752440f;
        float er[4] = {r[0], r[2], r[4], r[6]};
        float ei[4] = {i[0], i[2], i[4], i[6]};
        float orr[4] = {r[1], r[3], r[5], r[7]};
        float oi[4] = {i[1], i[3], i[5], i[7]};
        Bfly<4>::run(er, ei);
        Bfly<4>::run(orr, oi);
        // O[k] *= exp(2 pi i k / 8): (1 + i)/sqrt 2, i, (-1 + i)/sqrt 2
        float a = orr[1], b = oi[1];
        orr[1] = (a - b) * h; oi[1] = (a + b) * h;
        a = orr[2]; b = oi[2];
        orr[2] = -b; oi[2] = a;
        a = orr[3]; b = oi[3];
        orr[3] = -(a + b) * h; oi[3] = (a - b) * h;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            r[k] = er[k] + orr[k]; i[k] = ei[k] + oi[k];
            r[k + 4] = er[k] - orr[k]; i[k + 4] = ei[k] - oi[k];
        }
    }
};

template <> struct Bfly<5> {
    __device__ static void run(float* r, float* i) {
        // cos and sin of 2 pi/5 and 4 pi/5, float64 values rounded to f32
        constexpr float c1 = 0.30901699437494742410f;
        constexpr float s1 = 0.95105651629515357212f;
        constexpr float c2 = -0.80901699437494742410f;
        constexpr float s2 = 0.58778525229247312917f;
        const float a1r = r[1] + r[4], a1i = i[1] + i[4];
        const float b1r = r[1] - r[4], b1i = i[1] - i[4];
        const float a2r = r[2] + r[3], a2i = i[2] + i[3];
        const float b2r = r[2] - r[3], b2i = i[2] - i[3];
        // u1 = x0 + c1 a1 + c2 a2, u2 = x0 + c2 a1 + c1 a2;
        // t1 = s1 b1 + s2 b2, t2 = s2 b1 - s1 b2;
        // X1 = u1 + i t1, X4 = u1 - i t1, X2 = u2 + i t2, X3 = u2 - i t2
        const float u1r = r[0] + c1 * a1r + c2 * a2r;
        const float u1i = i[0] + c1 * a1i + c2 * a2i;
        const float u2r = r[0] + c2 * a1r + c1 * a2r;
        const float u2i = i[0] + c2 * a1i + c1 * a2i;
        const float t1r = s1 * b1r + s2 * b2r, t1i = s1 * b1i + s2 * b2i;
        const float t2r = s2 * b1r - s1 * b2r, t2i = s2 * b1i - s1 * b2i;
        r[0] = r[0] + a1r + a2r; i[0] = i[0] + a1i + a2i;
        r[1] = u1r - t1i; i[1] = u1i + t1r;
        r[4] = u1r + t1i; i[4] = u1i - t1r;
        r[2] = u2r - t2i; i[2] = u2i + t2r;
        r[3] = u2r + t2i; i[3] = u2i - t2r;
    }
};

// Copy rows t in [ta, tb) of stream b, both planes, into stage rows
// KP + t - t0 with cp.async of V floats; rows t < 0 from the history.
template <int M, int KP>
__device__ __forceinline__ void stage_rows(float* stage, const float* x0,
                                           const float* x1, const float* h0,
                                           const float* h1, int ta, int tb,
                                           int t0) {
    using S = Shape<M, KP>;
    constexpr int V = copy_floats<M>(), PS = plane_stride<M, KP>();
    const int nv = (tb - ta) * (M / V);  // copies a plane
    float* dst0 = stage + (KP + ta - t0) * M;
    for (int e = threadIdx.x; e < 2 * nv; e += S::NT) {
        const int pl = e >= nv;
        const int q = V * (e - pl * nv);
        const long long f = (long long)ta * M + q;
        const float* src = f < 0 ? (pl ? h1 : h0) + KP * M + f
                                 : (pl ? x1 : x0) + f;
        cp_async<V>(dst0 + pl * PS + q, src);
    }
}

template <int M, int KP>
__global__ void __launch_bounds__(Shape<M, KP>::NT, 2)
pfb_fft_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
               const float* __restrict__ hist, const float* __restrict__ ct,
               const float* __restrict__ tw, float* __restrict__ y_re,
               float* __restrict__ y_im, int Tm, int runs) {
    using S = Shape<M, KP>;
    constexpr int TT = S::TT, FR = S::FR, NT = S::NT;
    constexpr int R1 = Radix<M>::R1, R2 = Radix<M>::R2;
    constexpr int PS = plane_stride<M, KP>();
    constexpr int ST = 2 * PS;                        // a stage
    constexpr int VS = TT + 1;                        // row stride of V, odd
    constexpr int NCH = TT / FR;                      // FIR chunks a tile
    constexpr int NJOB = 2 * M * NCH;                 // FIR jobs a tile
    static_assert(TT % FR == 0 && TT % 32 == 0, "whole chunks and warps");
    static_assert(NJOB <= NT && TT * R1 <= NT,
                  "one FIR job and one stage-1 job a thread");
    static_assert((KP * M) % 4 == 0 && (TT * M) % 4 == 0 && PS % 4 == 0,
                  "float4 halo copies");
    extern __shared__ __align__(16) float smem[];
    float* s_v = smem + kStages * ST;  // [plane][slot][row], stride VS
    const int tid = threadIdx.x;

    const int b = blockIdx.x / runs, r = blockIdx.x - b * runs;
    const int tiles = (Tm + TT - 1) / TT;
    const int g0 = (int)((long long)r * tiles / runs);
    const int n = (int)((long long)(r + 1) * tiles / runs) - g0;
    const long long T = (long long)Tm * M;
    const float* x0 = x_re + b * T;
    const float* x1 = x_im + b * T;
    const float* h0 = hist + 2LL * b * KP * M;
    const float* h1 = h0 + KP * M;

    // this thread's FIR job: column fc of plane fp, rows fm0 .. fm0+FR-1
    const int fc = tid % M, fch = (tid / M) % NCH, fp = tid / (M * NCH);
    const int fm0 = fch * FR;
    float tap[KP + 1];
#pragma unroll
    for (int l = 0; l <= KP; ++l) tap[l] = tid < NJOB ? ct[l * M + fc] : 0.f;
    const int fslot = fc ? M - fc : 0;
    // stage 1's twiddles W^(k2 p1), p1 = tid / TT
    float twr[R2], twi[R2];
#pragma unroll
    for (int k = 0; k < R2; ++k) {
        const bool on = tid < TT * R1;
        twr[k] = on ? tw[(tid / TT) * R2 + k] : 0.f;
        twi[k] = on ? tw[M + (tid / TT) * R2 + k] : 0.f;
    }

    // prologue: tile 0 with its halo, then tiles 1 .. kAhead-1
    {
        const int t0 = g0 * TT;
        stage_rows<M, KP>(smem, x0, x1, h0, h1, t0 - KP, min(t0 + TT, Tm),
                          t0);
        cp_async_commit();
#pragma unroll
        for (int a = 1; a < kAhead; ++a) {
            const int ta = t0 + a * TT;
            if (a < n)
                stage_rows<M, KP>(smem + a * ST, x0, x1, h0, h1, ta,
                                  min(ta + TT, Tm), ta);
            cp_async_commit();
        }
    }

    for (int j = 0; j < n; ++j) {
        const int t0 = (g0 + j) * TT;
        if (j + kAhead < n) {
            const int ta = t0 + kAhead * TT;
            stage_rows<M, KP>(smem + ((j + kAhead) % kStages) * ST, x0, x1,
                              h0, h1, ta, min(ta + TT, Tm), ta);
        }
        cp_async_commit();
        // this thread's copies of tile j have landed, then everyone's; and
        // tile j-1 is done with V
        cp_async_wait<kAhead>();
        __syncthreads();
        const float* st = smem + (j % kStages) * ST;

        // stage rows [TT, TT + KP) become tile j+1's halo
        if (j + 1 < n) {
            float* nx = smem + ((j + 1) % kStages) * ST;
            constexpr int H4 = KP * M / 4;
            for (int e = tid; e < 2 * H4; e += NT) {
                const int pl = e >= H4;
                const int q = 4 * (e - pl * H4);
                *reinterpret_cast<float4*>(nx + pl * PS + q) =
                    *reinterpret_cast<const float4*>(st + pl * PS + TT * M +
                                                     q);
            }
        }

        // column FIR: input row i of the job is tile row fm0 - KP + i,
        // stage row fm0 + i; it feeds output o with tap o + KP - i
        if (tid < NJOB) {
            const float* xs = st + fp * PS + fm0 * M + fc;
            float acc[FR];
#pragma unroll
            for (int o = 0; o < FR; ++o) acc[o] = 0.f;
#pragma unroll
            for (int i = 0; i < KP + FR; ++i) {
                const float xv = xs[i * M];
#pragma unroll
                for (int o = 0; o < FR; ++o) {
                    const int l = o + KP - i;
                    if (l >= 0 && l <= KP) acc[o] = fmaf(tap[l], xv, acc[o]);
                }
            }
            float* vp = s_v + (fp * M + fslot) * VS + fm0;
#pragma unroll
            for (int o = 0; o < FR; ++o) vp[o] = acc[o];
        }
        __syncthreads();

        // FFT stage 1, in place: slots p1 + R1 p2 -> p1 + R1 k2
        if (tid < TT * R1) {
            float ar[R2], ai[R2];
            float* v = s_v + (tid / TT) * VS + tid % TT;
#pragma unroll
            for (int q = 0; q < R2; ++q) {
                ar[q] = v[q * R1 * VS];
                ai[q] = v[(M + q * R1) * VS];
            }
            Bfly<R2>::run(ar, ai);
#pragma unroll
            for (int q = 0; q < R2; ++q) {
                v[q * R1 * VS] = ar[q] * twr[q] - ai[q] * twi[q];
                v[(M + q * R1) * VS] = ar[q] * twi[q] + ai[q] * twr[q];
            }
        }
        __syncthreads();

        // FFT stage 2: slots p1 + R1 k2 -> channels k2 + R2 k1, job
        // (row, k2), NT jobs at a time
#pragma unroll
        for (int u = 0; u < (TT * R2 + NT - 1) / NT; ++u) {
            const int job = tid + u * NT;
            if (job >= TT * R2) break;
            const int row = job % TT, k2 = job / TT;
            float br[R1], bi[R1];
            const float* z = s_v + k2 * R1 * VS + row;
#pragma unroll
            for (int q = 0; q < R1; ++q) {
                br[q] = z[q * VS];
                bi[q] = z[(M + q) * VS];
            }
            Bfly<R1>::run(br, bi);
            const int t = t0 + row;
            if (t < Tm) {
                const long long o = ((long long)b * M + k2) * Tm + t;
#pragma unroll
                for (int q = 0; q < R1; ++q) {
                    y_re[o + (long long)q * R2 * Tm] = br[q];
                    y_im[o + (long long)q * R2 * Tm] = bi[q];
                }
            }
        }
    }
}

struct Args {
    const float *x_re, *x_im, *hist, *ct, *tw;
    float *y_re, *y_im;
    int B, Tm;
    cudaStream_t stream;
};

// Launches the instance on `a`. The first call on a device sets the
// shared-memory attribute and reads the occupancy and the SM count.
template <int M, int KP>
int launch(const Args& a) {
    using S = Shape<M, KP>;
    static int held[kMaxDev], sms[kMaxDev];  // 0 until read
    constexpr int smem = smem_bytes<M, KP>();
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDev) return (int)cudaErrorInvalidDevice;
    if (held[dev] == 0) {
        if (smem > 48 * 1024 &&
            (e = cudaFuncSetAttribute(
                 pfb_fft_kernel<M, KP>,
                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
                cudaSuccess)
            return (int)e;
        if ((e = cudaDeviceGetAttribute(&sms[dev],
                                        cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess)
            return (int)e;
        int n = 0;
        if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, pfb_fft_kernel<M, KP>, S::NT, smem)) != cudaSuccess)
            return (int)e;
        held[dev] = n > 0 ? n : 1;
    }
    const int tiles = (a.Tm + S::TT - 1) / S::TT;
    int runs = held[dev] * sms[dev] / a.B;
    runs = runs < 1 ? 1 : (runs > tiles ? tiles : runs);
    pfb_fft_kernel<M, KP><<<a.B * runs, S::NT, smem, a.stream>>>(
        a.x_re, a.x_im, a.hist, a.ct, a.tw, a.y_re, a.y_im, a.Tm, runs);
    return (int)cudaGetLastError();
}

using Launch = int (*)(const Args&);

template <int M>
Launch pick_kp(int kp) {
    switch (kp) {
        case 8: return launch<M, 8>;
        case 16: return launch<M, 16>;
        case 24: return launch<M, 24>;
        case 32: return launch<M, 32>;
    }
    return nullptr;
}

// The instance for (M, kp), null for a shape the kernel does not take.
Launch pick(int M, int kp) {
    switch (M) {
        case 8: return pick_kp<8>(kp);
        case 10: return kp == 56 ? launch<10, 56> : nullptr;
        case 16: return pick_kp<16>(kp);
        case 32: return pick_kp<32>(kp);
        case 64: return pick_kp<64>(kp);
    }
    return nullptr;
}

}  // namespace

extern "C" {

// x_re/x_im: contiguous (B, Tm*M); hist: contiguous (B, 2, kp*M); ct:
// contiguous (kp+1, M); tw: the twiddle table of fft_table(M), (2 M,);
// y_re/y_im: contiguous (B, M, Tm). The planes and the history 16-byte
// aligned (8-byte at M 10). Returns a CUDA error code, 0 after a clean launch.
int pfb_fft_f32(const void* x_re, const void* x_im, const void* hist,
                const void* ct, const void* tw, void* y_re, void* y_im, int B,
                int Tm, int M, int kp, void* stream) {
    const Launch f = pick(M, kp);
    if (f == nullptr || B < 1 || Tm < 1) return (int)cudaErrorInvalidValue;
    const Args a = {(const float*)x_re, (const float*)x_im,
                    (const float*)hist, (const float*)ct, (const float*)tw,
                    (float*)y_re, (float*)y_im, B, Tm, (cudaStream_t)stream};
    return f(a);
}

const char* pfb_fft_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

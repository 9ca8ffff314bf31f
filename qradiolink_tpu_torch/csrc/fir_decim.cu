// fir_decim_f32: polyphase decimating FIR over one or two f32 planes.
//
// Replaces, at its decimating shapes, the Pallas TPU kernel
// banded_fir_stream -> _stream_call (qradiolink_tpu/ops/pallas_fir.py:218),
// the streaming strided FIR with a carried tail. Its shape on the 4FSK main
// path is the 1 Msps -> 20 ksps resampler head: K = 419 taps, D = 50.
// csrc/fir.cu (fir_stream_f32) computes the same function and serves every
// other shape; ops/cuda_fir.route() says which kernel takes a call.
//
// Function, over the virtual stream xc = [tail (tail_len) | x (T)] of each
// row, with tf the flipped taps (tf[j] = h[K-1-j]):
//     y[m] = sum_{j<K} tf[j] * xc[m*D + shift + j],   m in [0, n_out)
// In polyphase form, with A = ceil(K/D), the taps padded with zeros to A*D
// and X[r][b] = xc[r*D + shift + b] for b < D:
//     y[m] = sum_{a<A} sum_{b<D} tf[a*D + b] * X[m + a][b]
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores)
// at the head, 2 planes x 2048 rows x 200,000 samples: 3.28 GB read and
// 65.5 MB written, >= 1.0 ms; 13.7 GFLOP, 0.2 ms. Memory-bound, so the
// design reads each input element once, from device memory straight into
// registers, and keeps shared memory off the FMA path (fir_stream_f32
// reads x from shared memory once per FMA, with a 2-way bank conflict at
// D = 50).
//
// Design: one warp owns one (plane, row, chunk of MW consecutive outputs),
// the three flattened into blockIdx.x, 4 warps a block.
//   * Taps in registers, one phase column per lane: lane l holds
//     tf[a*D + l] and tf[a*D + l + 32] for every a < A (zero where the
//     column is >= D or the tap is >= K), 2A registers. No tap is loaded
//     in the loop.
//   * The warp walks the rows r = m0 .. m0 + MW + A - 2 of X. Lane l loads
//     X[r][l] and X[r][l + 32]: one row is D contiguous floats, so the
//     loads coalesce. The tail/x seam is resolved per element; loads at or
//     past tail_len + T read 0 (the padded taps reach up to A*D - K samples
//     beyond the last real window). Rows are loaded a group of A ahead of
//     the FMAs that use them.
//   * A ring of A accumulators: row r adds tf[a*D + b] * X[r][b] into the
//     partial of output r - a. The row loop is unrolled A times, so every
//     ring index is a compile-time constant; the kernel is a template on A
//     and the launcher switches over A = 1 .. 16.
//   * After row r, output j = r - (A-1) of the chunk is complete in the 32
//     lane partials. Each lane stores its partial to row j mod 32 of a
//     padded 32 x 33 shared tile of the warp (one conflict-free store);
//     every 32 outputs, lane l sums tile row l (32 loads, 31 adds) and the
//     warp stores the 32 outputs as one 128-byte store. (A first version
//     summed each output with a 5-step __shfl_xor_sync butterfly inside
//     the row loop: 2.4 ms at the head, a dependent chain of ~150 cycles a
//     row that the next row's FMAs could not overlap.)
// Only (A-1)/MW of the rows (3% at the head) are read twice, at chunk
// seams. Per warp-row: 2 loads, 2A FMAs, 1 shared store, and amortised 1
// shared load and 1 add.
//
// Sum order: per lane over a (both columns of a row together), then lane
// 0 .. 31 in order. It differs from F.conv1d's by rounding (~1e-7
// relative). A non-finite input sample can reach one output more than in
// the plain version, through a zero padded tap.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;        // warps a block
constexpr int kMaxD = 64;        // two phase columns a lane
constexpr int kTargetMW = 256;   // about this many outputs a warp

// groups of A rows a warp walks, and the outputs it emits: MW + A - 1 rows
// are exactly NG groups
template <int A>
__host__ __device__ constexpr int groups() {
    return (kTargetMW + A - 1) / A + 1;
}
template <int A>
__host__ __device__ constexpr int chunk_outputs() {
    return (groups<A>() - 1) * A + 1;
}

// The explicit minimum of 1 block an SM matters: without it ptxas capped
// A = 9 at 96 registers and spilled 20 bytes (with it, no A spills).
template <int A>
__global__ void __launch_bounds__(kWarps * 32, 1)
fir_decim_kernel(const float* __restrict__ tail0,
                 const float* __restrict__ tail1, int tail_ld, int tail_len,
                 const float* __restrict__ x0, const float* __restrict__ x1,
                 const float* __restrict__ tf, float* __restrict__ y0,
                 float* __restrict__ y1, int C, int T, int K, int D,
                 int shift, int n_out, int n_chunks, long long n_warps) {
    constexpr int NG = groups<A>();
    constexpr int MW = chunk_outputs<A>();
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (w >= n_warps) return;  // whole warps only
    const int chunk = (int)(w % n_chunks);
    const int rp = (int)(w / n_chunks);
    const int plane = rp / C;
    const int row = rp - plane * C;

    // the warp's transpose tile: [output j mod 32][lane], padded to 33
    __shared__ float s_red[kWarps][32][33];
    float (*red)[33] = s_red[threadIdx.x >> 5];

    const float* tail = plane ? tail1 : tail0;
    if (tail != nullptr) tail += (size_t)row * tail_ld;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;
    float* y = (plane ? y1 : y0) + (size_t)row * n_out;

    const bool has0 = lane < D, has1 = lane + 32 < D;
    float t0[A], t1[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
        const int j = a * D + lane;
        t0[a] = has0 && j < K ? tf[j] : 0.0f;
        t1[a] = has1 && j + 32 < K ? tf[j + 32] : 0.0f;
    }

    const int m0 = chunk * MW;
    const int m_end = min(m0 + MW, n_out);
    const int n_in = tail_len + T;
    // X[r][lane] sits at xc[v] with v = r*D + shift + lane
    auto load = [&](int v, bool has) -> float {
        if (!has || v >= n_in) return 0.0f;
        return v < tail_len ? __ldg(tail + v) : __ldg(x + (v - tail_len));
    };

    // nxt zeroed: the last group copies it unread (left undefined, ptxas
    // spilled 4 bytes at A = 8)
    float cur0[A], cur1[A], nxt0[A] = {}, nxt1[A] = {}, acc[A];
    const int v0 = m0 * D + shift + lane;
#pragma unroll
    for (int u = 0; u < A; ++u) {
        cur0[u] = load(v0 + u * D, has0);
        cur1[u] = load(v0 + u * D + 32, has1);
        acc[u] = 0.0f;
    }

    for (int g = 0; g < NG; ++g) {
        const int r0 = g * A;  // first row of this group, from m0
        if (m0 + r0 - (A - 1) >= m_end) break;  // its outputs are all past
        if (g + 1 < NG) {
            const int vn = v0 + (r0 + A) * D;
#pragma unroll
            for (int u = 0; u < A; ++u) {
                nxt0[u] = load(vn + u * D, has0);
                nxt1[u] = load(vn + u * D + 32, has1);
            }
        }
#pragma unroll
        for (int u = 0; u < A; ++u) {
            // row m0 + r0 + u feeds output m0 + r0 + u - a, ring slot
            // (u - a) mod A
#pragma unroll
            for (int a = 0; a < A; ++a) {
                const int s = (u - a + A) % A;
                acc[s] = fmaf(t0[a], cur0[u], acc[s]);
                acc[s] = fmaf(t1[a], cur1[u], acc[s]);
            }
            // output j = r0 + u - (A-1) of the chunk is complete, slot
            // (u + 1) mod A, which output j + A starts from zero
            const int s = (u + 1) % A;
            const int j = r0 + u - (A - 1);
            if (j >= 0 && m0 + j < m_end) {
                red[j & 31][lane] = acc[s];
                if ((j & 31) == 31 || m0 + j == m_end - 1) {
                    __syncwarp();
                    float sum = 0.0f;
#pragma unroll
                    for (int k = 0; k < 32; ++k) sum += red[lane][k];
                    if (lane <= (j & 31)) y[m0 + (j & ~31) + lane] = sum;
                    __syncwarp();  // the tile is read before it is refilled
                }
            }
            acc[s] = 0.0f;
        }
#pragma unroll
        for (int u = 0; u < A; ++u) {
            cur0[u] = nxt0[u];
            cur1[u] = nxt1[u];
        }
    }
}

template <int A>
int launch(const float* tail0, const float* tail1, int tail_ld,
           int tail_len, const float* x0, const float* x1, const float* tf,
           float* y0, float* y1, int C, int T, int K, int D, int shift,
           int n_out, int planes, cudaStream_t stream) {
    const int n_chunks = (n_out + chunk_outputs<A>() - 1) / chunk_outputs<A>();
    const long long n_warps = (long long)n_chunks * C * planes;
    const long long blocks = (n_warps + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    fir_decim_kernel<A><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
        tail0, tail1, tail_ld, tail_len, x0, x1, tf, y0, y1, C, T, K, D,
        shift, n_out, n_chunks, n_warps);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Same arguments as fir_stream_f32 (csrc/fir.cu). tail0/tail1: (C,
// tail_ld)-strided rows of K-1 floats, or null (no tail); x0/x1, y0/y1:
// contiguous (C, T) and (C, n_out); planes 1 or 2 (the *1 pointers are read
// only for 2). Takes 1 <= D <= 64 and ceil(K/D) <= 16, and returns
// cudaErrorInvalidValue for any other shape; otherwise cudaGetLastError()
// after the launch.
int fir_decim_f32(const void* tail0, const void* tail1, int tail_ld,
                  const void* x0, const void* x1, const void* taps_flipped,
                  void* y0, void* y1, int C, int T, int K, int D, int shift,
                  int n_out, int planes, void* stream) {
    if (D < 1 || D > kMaxD || K < 1) return (int)cudaErrorInvalidValue;
    const int A = (K + D - 1) / D;
    const int tail_len = tail0 ? K - 1 : 0;
#define QRL_ARGS                                                           \
    (const float*)tail0, (const float*)tail1, tail_ld, tail_len,           \
        (const float*)x0, (const float*)x1, (const float*)taps_flipped,    \
        (float*)y0, (float*)y1, C, T, K, D, shift, n_out, planes,          \
        (cudaStream_t)stream
    switch (A) {
        case 1: return launch<1>(QRL_ARGS);
        case 2: return launch<2>(QRL_ARGS);
        case 3: return launch<3>(QRL_ARGS);
        case 4: return launch<4>(QRL_ARGS);
        case 5: return launch<5>(QRL_ARGS);
        case 6: return launch<6>(QRL_ARGS);
        case 7: return launch<7>(QRL_ARGS);
        case 8: return launch<8>(QRL_ARGS);
        case 9: return launch<9>(QRL_ARGS);
        case 10: return launch<10>(QRL_ARGS);
        case 11: return launch<11>(QRL_ARGS);
        case 12: return launch<12>(QRL_ARGS);
        case 13: return launch<13>(QRL_ARGS);
        case 14: return launch<14>(QRL_ARGS);
        case 15: return launch<15>(QRL_ARGS);
        case 16: return launch<16>(QRL_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef QRL_ARGS
}

const char* fir_decim_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

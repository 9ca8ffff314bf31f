// fir_long_f32: decimating FIR with many taps a phase, over one or two f32
// planes, as polyphase tap segments in column groups.
//
// Replaces, at its long decimating shapes, the Pallas TPU kernel
// banded_fir_stream -> _stream_call (qradiolink_tpu/ops/pallas_fir.py:218),
// the streaming strided FIR with a carried tail. Its shapes on the main
// paths, 45 taps a phase each (the default RationalResampler(1, M) taps):
//   * the NBFM/AM head (mixed path): K = 2,239, D = 50, 2 planes x 32 rows x
//     100,000 samples;
//   * the SSB head: K = 5,597, D = 125, 2 planes x 2048 rows x 200,000.
// csrc/fir_decim.cu (fir_decim_f32) computes the same function at
// ceil(K/D) <= 16 and D 32-64, csrc/fir_cols.cu (fir_cols_f32) at D < 32 and
// csrc/fir.cu (fir_stream_f32) at every shape; ops/cuda_fir.route() says
// which kernel takes a call.
//
// Function, over the virtual stream xc = [tail (tail_len) | x (T)] of each
// row, with tf the flipped taps (tf[j] = h[K-1-j]):
//     y[m] = sum_{j<K} tf[j] * xc[m*D + shift + j],   m in [0, n_out)
// In polyphase form, with A = ceil(K/D), the taps padded with zeros to A*D
// and X[r][b] = xc[r*D + shift + b] for b < D:
//     y[m] = sum_{a<A} sum_{b<D} tf[a*D + b] * X[m + a][b]
// Cut the A phase rows into S = ceil(A/16) segments of AS = ceil(A/S) rows
// and the D phase columns into G = ceil(D/64) groups of 64:
//     y[m] = sum_{g<G} sum_{s<S} y_gs[m],
//     y_gs[m] = sum_{a<AS} sum_{b<64} tf[(s*AS + a)*D + 64g + b]
//                                      * X[m + s*AS + a][64g + b]
// (terms with a column >= D or a tap >= K are zero). Each y_gs is a
// decimating FIR of AS*64 taps over the stream shifted by s*AS rows and
// 64g samples: the shape fir_decim_f32 computes without a spill.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
//   NBFM head, 2 x 32 x 100,000, 2,000 outputs a row: 25.6 MB of input,
//     0.57 MB of tails, 0.51 MB of output, >= 8.0 us; 573 MFLOP, >= 8.6 us;
//   SSB head, 2 x 2048 x 200,000, 1,600 outputs a row: 3.28 GB of input,
//     92 MB of tails, 26 MB of output, >= 1.015 ms; 73.4 GFLOP, >= 1.095 ms.
// Both are operation-bound. fir_stream_f32 spends two shared loads an FMA
// (about 16 FMAs a clock an SM against the SM's 128), and at the SSB head
// its block stages K + 127 D + K floats (108 KB), so two blocks fit an SM:
// 18.4 ms there. This kernel keeps the taps and the sums in registers,
// loads each input row once a segment, and needs no staging.
//
// Design: one block of G*S warps (at most 8) owns one (plane, row, chunk of
// MW consecutive outputs), the three flattened into blockIdx.x; warp
// w = g*S + s computes column group g of segment s of the chunk.
//   * Taps in registers, two phase columns a lane: lane l of group g holds
//     tf[(s*AS + a)*D + 64g + l] and tf[(s*AS + a)*D + 64g + l + 32] for
//     every a < AS (zero where the column is >= D or the tap is >= K), 2 AS
//     registers. No tap is loaded in the loop. At D 125, 125 of the 128
//     lane-columns of the two groups are busy; at D 32-64, one group.
//   * The warp walks the rows m0 + s*AS + r, r = 0 .. MW + AS - 2. Lane l
//     loads X[row][64g + l] and X[row][64g + l + 32]: 64 contiguous floats
//     of the row, so the loads coalesce (from L1/L2 after the first
//     segment). Rows are loaded a group of AS ahead of the FMAs that use
//     them. A group whose rows all lie inside x (a warp-uniform test, true
//     for all but the groups at the tail and at the end of the stream) is
//     loaded through one pointer; elsewhere the tail/x seam is resolved per
//     element and loads at or past tail_len + T read 0 (the padded taps of
//     the last segment reach up to A*D - K samples beyond the last real
//     window). A first column >= D (group 1 at D < 96) loads the row's
//     last column and a second column >= D loads 0, never the next row's
//     sample; their taps are zero.
//   * A ring of AS accumulators: row r adds tf[(s*AS + a)*D + b] * X[r][b]
//     into the partial of output r - a. The row loop is unrolled AS times,
//     so every ring index is a compile-time constant; the kernel is a
//     template on AS and the launcher switches over AS = 9 .. 16 (A in
//     17 .. 64, S <= 4). Four columns a lane at AS = 15 would need about
//     195 live registers: a spill, or one warp a scheduler. Column groups
//     keep about the registers of one group (168 at AS = 15, 158 before
//     the groups) and add warps.
//   * After row r, output j = r - (AS-1) of the segment is complete in the
//     32 lane partials. Each lane stores its partial to row j mod 32 of a
//     padded 32 x 33 shared tile of the warp; every 32 outputs lane l sums
//     tile row l (lanes 0 .. 31 in order) into the warp's row of a shared
//     (G*S) x MW tile of partials. A group whose AS outputs all lie in the
//     chunk (every group but the first and the last) skips the per-row
//     bounds test.
//   * One __syncthreads at the end of the chunk; then the block's threads
//     add the G*S partials of each output in order w = 0 .. G*S-1 and store
//     y with coalesced stores. No atomics and no second pass: the sum order
//     is fixed, so every run gives the same bits.
// Only (AS-1)/MW of the rows (5% at AS = 15) are read twice, at chunk
// seams. Per warp-row: 2 loads, 2 AS FMAs, 1 shared store, and amortised
// 1 shared load and 1 add. Shared memory is dynamic, G*S*(32*33 + MW)
// floats (16 KB at the NBFM head, 32 KB at the SSB head). At the NBFM head
// (AS = 15, MW = 271) the launch is 2 x 32 x 8 = 512 blocks of 3 warps; at
// the SSB head 2 x 2048 x 6 = 24,576 blocks of 6 warps, two an SM. (A first
// version resolved the seam at every load and tested every row's output
// against the chunk: a divergence region of several instructions a load
// in its SASS, 0.0685 ms at the NBFM head by chip_smoke.py.)
//
// Sum order: per lane over the segment's rows (both columns of a row
// together), then lane 0 .. 31, then warp 0 .. G*S-1. It differs from
// F.conv1d's by rounding (~1e-7 relative), and from fir_stream_f32's, so
// the two are held to the FIR's bound of the plain version, not to equal
// bits. Non-finite input departs from the plain version: a sample can reach
// one output more through a zero padded tap, and a column >= D that loads
// the row's last column multiplies it by a zero tap, so an Inf or NaN
// there reaches outputs the plain version keeps finite.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMinD = 32;        // every lane of group 0 holds a column
constexpr int kGroupCols = 64;   // phase columns a warp: two a lane
constexpr int kMaxAS = 16;       // phase rows a segment
constexpr int kMaxS = 4;         // segments: A = ceil(K/D) <= 64
constexpr int kMaxWarps = 8;     // column groups x segments a block
constexpr int kTargetMW = 256;   // about this many outputs a block

// groups of AS rows a warp walks, and the outputs it emits: MW + AS - 1
// rows are exactly NG groups
template <int AS>
__host__ __device__ constexpr int groups() {
    return (kTargetMW + AS - 1) / AS + 1;
}
template <int AS>
__host__ __device__ constexpr int chunk_outputs() {
    return (groups<AS>() - 1) * AS + 1;
}

// shared floats of a block of W warps: each warp's 32 x 33 transpose tile,
// then its row of the chunk's partials
template <int AS>
__host__ __device__ constexpr int smem_floats(int W) {
    return W * (32 * 33 + chunk_outputs<AS>());
}

// The explicit minimum of 1 block an SM: fir_decim_f32, whose loop this
// is, spilled without one.
template <int AS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
fir_long_kernel(const float* __restrict__ tail0,
                const float* __restrict__ tail1, int tail_ld, int tail_len,
                const float* __restrict__ x0, const float* __restrict__ x1,
                const float* __restrict__ tf, float* __restrict__ y0,
                float* __restrict__ y1, int C, int T, int K, int D,
                int shift, int n_out, int n_chunks, int S) {
    constexpr int NG = groups<AS>();
    constexpr int MW = chunk_outputs<AS>();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
    const int grp = warp / S;
    const int seg = warp - grp * S;
    const int chunk = (int)(blockIdx.x % (unsigned)n_chunks);
    const int rp = (int)(blockIdx.x / (unsigned)n_chunks);
    const int plane = rp / C;
    const int row = rp - plane * C;

    // each warp's transpose tile: [output j mod 32][lane], padded to 33;
    // then the warps' partials of the chunk's outputs, [W][MW]
    extern __shared__ float smem[];
    float (*red)[33] = reinterpret_cast<float (*)[33]>(smem) + warp * 32;
    float* s_part = smem + W * 32 * 33;
    float* part = s_part + warp * MW;

    const float* tail = plane ? tail1 : tail0;
    if (tail != nullptr) tail += (size_t)row * tail_ld;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;
    float* y = (plane ? y1 : y0) + (size_t)row * n_out;

    // lane l of group g holds columns 64g + l and 64g + l + 32 where they
    // are < D (group 0's first column always: D >= 32). A first column
    // >= D loads column D - 1 of the row (dcol), never the next row's, and
    // multiplies it by zero taps: no predicate on the loads.
    const int col = grp * kGroupCols + lane;
    const bool has0 = col < D;
    const bool has1 = col + 32 < D;
    const int dcol = has0 ? 0 : D - 1 - col;
    float t0[AS], t1[AS];
#pragma unroll
    for (int a = 0; a < AS; ++a) {
        const int j = (seg * AS + a) * D + col;
        t0[a] = has0 && j < K ? tf[j] : 0.0f;
        t1[a] = has1 && j + 32 < K ? tf[j + 32] : 0.0f;
    }

    const int m0 = chunk * MW;
    const int m_end = min(m0 + MW, n_out);
    const int last = m_end - 1 - m0;  // the chunk's last output, from m0
    const int n_in = tail_len + T;
    // X[r][col] sits at xc[v] with v = r*D + shift + col
    auto load = [&](int v, bool has) -> float {
        if (!has || v >= n_in) return 0.0f;
        return v < tail_len ? __ldg(tail + v) : __ldg(x + (v - tail_len));
    };
    // rows of a group from lane sample v of its first row: through one
    // pointer when the warp's AS rows (first sample v - lane, last
    // v - lane + (AS-1)*D + 63) all lie inside x
    auto load_group = [&](int v, float (&g0)[AS], float (&g1)[AS]) {
        const int w = v - lane;
        if (w >= tail_len && w + (AS - 1) * D + kGroupCols <= n_in) {
            const float* p = x + (v - tail_len);
#pragma unroll
            for (int u = 0; u < AS; ++u) {
                g0[u] = __ldg(p + u * D + dcol);
                g1[u] = has1 ? __ldg(p + u * D + 32) : 0.0f;
            }
        } else {
#pragma unroll
            for (int u = 0; u < AS; ++u) {
                g0[u] = load(v + u * D + dcol, true);
                g1[u] = load(v + u * D + 32, has1);
            }
        }
    };
    // output j of the chunk is complete in slot s: to the tile, and every
    // 32 outputs (or at the last) the lane partials summed lane by lane
    auto emit = [&](int j, float v) {
        red[j & 31][lane] = v;
        if ((j & 31) == 31 || j == last) {
            __syncwarp();
            float sum = 0.0f;
#pragma unroll
            for (int k = 0; k < 32; ++k) sum += red[lane][k];
            if (lane <= (j & 31)) part[(j & ~31) + lane] = sum;
            __syncwarp();  // the tile is read before it is refilled
        }
    };

    // nxt zeroed: the last group copies it unread
    float cur0[AS], cur1[AS], nxt0[AS] = {}, nxt1[AS] = {}, acc[AS];
    const int v0 = (m0 + seg * AS) * D + shift + col;
    load_group(v0, cur0, cur1);
#pragma unroll
    for (int u = 0; u < AS; ++u) acc[u] = 0.0f;

    // the bounds of this loop are the same for every warp of the block
    for (int g = 0; g < NG; ++g) {
        const int r0 = g * AS;  // first row of this group, from the base
        if (r0 - (AS - 1) > last) break;  // its outputs are all past
        if (g + 1 < NG) load_group(v0 + (r0 + AS) * D, nxt0, nxt1);
        // the group's rows; `full`: its outputs r0 - (AS-1) + u all lie in
        // the chunk, so no row tests its output
        auto rows = [&](auto full) {
#pragma unroll
            for (int u = 0; u < AS; ++u) {
                // row r0 + u feeds output r0 + u - a, ring slot
                // (u - a) mod AS
#pragma unroll
                for (int a = 0; a < AS; ++a) {
                    const int s = (u - a + AS) % AS;
                    acc[s] = fmaf(t0[a], cur0[u], acc[s]);
                    acc[s] = fmaf(t1[a], cur1[u], acc[s]);
                }
                // output j = r0 + u - (AS-1) of the chunk is complete,
                // slot (u + 1) mod AS, which output j + AS starts from 0
                const int s = (u + 1) % AS;
                const int j = r0 + u - (AS - 1);
                if (decltype(full)::value || (j >= 0 && j <= last))
                    emit(j, acc[s]);
                acc[s] = 0.0f;
            }
        };
        if (r0 >= AS - 1 && r0 <= last)
            rows(std::true_type{});
        else
            rows(std::false_type{});
#pragma unroll
        for (int u = 0; u < AS; ++u) {
            cur0[u] = nxt0[u];
            cur1[u] = nxt1[u];
        }
    }

    __syncthreads();
    for (int j = threadIdx.x; j < m_end - m0; j += blockDim.x) {
        float sum = s_part[j];
        for (int w = 1; w < W; ++w) sum += s_part[w * MW + j];
        y[m0 + j] = sum;
    }
}

template <int AS>
int launch(const float* tail0, const float* tail1, int tail_ld,
           int tail_len, const float* x0, const float* x1, const float* tf,
           float* y0, float* y1, int C, int T, int K, int D, int shift,
           int n_out, int planes, int S, int G, cudaStream_t stream) {
    const int n_chunks =
        (n_out + chunk_outputs<AS>() - 1) / chunk_outputs<AS>();
    const long long blocks = (long long)n_chunks * C * planes;
    if (blocks == 0) return (int)cudaSuccess;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    // at most 8 x (1,056 + 271) floats, 41.5 KB: no opt-in above 48 KB
    const size_t smem = (size_t)smem_floats<AS>(G * S) * sizeof(float);
    fir_long_kernel<AS><<<(unsigned)blocks, G * S * 32, smem, stream>>>(
        tail0, tail1, tail_ld, tail_len, x0, x1, tf, y0, y1, C, T, K, D,
        shift, n_out, n_chunks, S);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Same arguments as fir_stream_f32 (csrc/fir.cu). tail0/tail1: (C,
// tail_ld)-strided rows of K-1 floats, or null (no tail); x0/x1, y0/y1:
// contiguous (C, T) and (C, n_out); planes 1 or 2 (the *1 pointers are read
// only for 2). Takes D >= 32 and 16 < A = ceil(K/D) <= 64 with
// ceil(D/64) * ceil(A/16) <= 8 warps a block, and returns
// cudaErrorInvalidValue for any other shape; otherwise cudaGetLastError()
// after the launch.
int fir_long_f32(const void* tail0, const void* tail1, int tail_ld,
                 const void* x0, const void* x1, const void* taps_flipped,
                 void* y0, void* y1, int C, int T, int K, int D, int shift,
                 int n_out, int planes, void* stream) {
    if (D < kMinD || K < 1 || C < 1 || planes < 1 || planes > 2)
        return (int)cudaErrorInvalidValue;
    const int A = (K + D - 1) / D;
    if (A <= kMaxAS || A > kMaxS * kMaxAS) return (int)cudaErrorInvalidValue;
    const int S = (A + kMaxAS - 1) / kMaxAS;
    const int AS = (A + S - 1) / S;
    const int G = (D + kGroupCols - 1) / kGroupCols;
    if (G * S > kMaxWarps) return (int)cudaErrorInvalidValue;
    const int tail_len = tail0 ? K - 1 : 0;
#define QRL_ARGS                                                           \
    (const float*)tail0, (const float*)tail1, tail_ld, tail_len,           \
        (const float*)x0, (const float*)x1, (const float*)taps_flipped,    \
        (float*)y0, (float*)y1, C, T, K, D, shift, n_out, planes, S, G,    \
        (cudaStream_t)stream
    switch (AS) {
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

const char* fir_long_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

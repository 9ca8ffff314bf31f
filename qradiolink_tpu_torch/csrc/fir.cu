// fir_stream_f32: streaming strided FIR over one or two f32 planes, at any
// shape: the route's catch-all (ops/cuda_fir.route()).
//
// Replaces the two Pallas TPU kernels of qradiolink_tpu/ops/pallas_fir.py
// that compute the same strided FIR:
//   * banded_fir_stream -> _stream_call (pallas_fir.py:218, call :286), the
//     concat-free streaming form with a carried tail;
//   * banded_fir -> _banded_call (pallas_fir.py:111), the VALID form over an
//     input that is already concatenated.
//
// Function, over the virtual stream xc = [tail (tail_len) | x (T)] of each
// row, with tf the flipped taps (tf[j] = h[K-1-j]):
//     y[m] = sum_j tf[j] * xc[m*D + shift + j],   m in [0, n_out)
// tail_len is K-1 with a tail (K1) and 0 without one (K2). Each output is
// summed as acc = fmaf(tf[j], xc[m*D + shift + j], acc), j = 0 .. K-1 in
// order from 0.0f: the order of csrc/fir_stream_v0.cu (the first design,
// kept for timing in turns) and csrc/fir_s1.cu, so the three give equal
// bits.
//
// The shapes the route gives it (A = ceil(K/D) taps a phase; 256 rows x 2
// planes, the sweep of chip_smoke.py), bound on an H100 SXM (3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), each input read once and each
// output written once:
//   FreeDV's head    K1045 D125 (A 9) x 1,000,000: 2.07 GB, >= 0.617 ms;
//                    8.6 GFLOP, 0.128 ms: bound by bytes;
//   4FSK1KFM's head  K837 D100 (A 9) x 1,000,000: >= 0.618 ms, by bytes;
//   4FSK100K         K17 D2 (A 9) x 200,000 -> 100,000: 0.41 GB in, 0.20 GB
//                    out, >= 0.183 ms, by bytes.
// At the heads an output needs 125 (100) new samples and K FMAs: 2 FMAs a
// byte against the card's 10, so the FMAs fit under the bytes if they run
// at a fifth of the f32 peak.
//
// What held the first design back (csrc/fir_stream_v0.cu, one thread an
// output): scripts/fir_stream_variants.py --ablate times its staging
// alone (the FMA loop cut to one read) at 4.15 ms of its 4.66 at FreeDV's
// head, and its FMA loop alone on a span it writes itself at 0.93 (NVIDIA
// H100 80GB HBM3, 700 W). The staging is the cost: each block stages K +
// 127 D floats with single-float loads, a seam test each, before any FMA,
// and at D 125 only three such blocks fit an SM; then each FMA takes two
// shared loads (a tap and a sample) with 4-way bank conflicts at D 100.
//
// Design: one lane, one stream. A stream is L outputs of one (plane, row),
// m = s0, s0 + P, ..., s0 + (L-1) P, and the lane reads the samples they
// need in order, each once: positions 0 .. n_samp-1 of xc from s0*D +
// shift, n_samp = P (L-1) D + K. It keeps S accumulators, one an output
// in flight, oldest last. The stream is cut into periods of PD = P*D
// samples; an output starts at a period's start and takes S periods, so at
// position q of a period the accumulator of age k (k periods old) takes
// tap j = q + k PD. With P = 1 (A <= 16, every routed shape with A <= 16)
// S = A and a period is a phase row: the accumulators are a systolic FIR,
// each sample feeding S outputs. For A > 16, P = ceil(A / 16) and S =
// ceil(A / P) <= 16: the lane keeps every P-th output and P lanes share a
// segment, one each residue. Per sample the lane does one shared load of
// the sample, ceil(S / 4) float4 broadcasts of the S taps of that position
// (stored by position, taps[q][k] = tf[q + k PD], once a block), and S
// FMAs: (1 + S/4) / S shared loads an FMA, 0.44 at A 9, against 2; the
// next position's loads are issued before this one's FMAs. The oldest
// accumulator is complete at q = qmax = K - (S-1) PD, and takes no tap at
// q >= qmax (the loop runs in two templated forms, with and without it,
// so no output adds a product of a sample outside its window); at the
// period's end the accumulators shift by one and the newest starts from
// 0.0f. Every output thus sums j = 0 .. K-1 in order. At a period of 2 or
// 4 positions (4FSK100K's D 2) the taps live in registers and a period is
// straight-line code.
//   * Input: each warp holds its 32 lanes' streams in a ring of kSlots
//     slots of kCh positions (position o of stream s at word o*33 + s: the
//     32 lanes read one word each at one position, conflict-free), filled
//     kSlots - 1 chunks ahead with 4-byte cp.async: for each stream, the
//     warp copies kCh consecutive samples (coalesced reads; the writes at
//     stride 33 are conflict-free too). The tail/x seam and the end of the
//     input are resolved where the copies are issued: a chunk that lies in
//     x for all 32 streams copies without a test, any other tests each
//     element (and fills 0 past tail_len + T). A warp waits only for its
//     own copies (cp.async.wait_group, then __syncwarp): no block barrier
//     after the taps are staged.
//   * Output: a complete output goes to a staging buffer of kOut a lane;
//     every kOut outputs the warp writes each stream's run with one
//     coalesced store (strided by P for P > 1).
//   * Work: a launch is one wave. The streams are cut so that planes x
//     rows x streams a row fill the blocks that fit the card at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs x 128
//     lanes); a stream's first S - 1 periods only warm its accumulators
//     (their outputs belong to the lane before), so a row's samples are
//     read (L + S - 1) / L times, 1.07 at FreeDV's head.
// What holds it now (the same script, PERF.md; 1.38 ms at FreeDV's head,
// 45% of its bound, NVIDIA H100 80GB HBM3, 700 W): the FMA side alone (no
// copies) takes 0.43 ms and the copies alone about 0.83 (--probe), and
// the two nearly add up: the 4-byte copies and the shared loads share the
// SM's load/store pipe. Copies by the TMA engine would leave that pipe to
// the loads, but a bulk copy a lane lays each stream's chunk out
// contiguously, where the lanes' same-position loads conflict 4 ways, and
// costs a request a lane and chunk; that design ran slower (PERF.md).
// Shared memory: the taps (PD x ceil4(S) floats) and, a warp, the ring,
// the output buffer and its streams' table; `fir_stream_smem_bytes`. The
// wrapper raises where a block would need more than 227 KB.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kCh = 64;                   // positions a ring slot
constexpr int kSlots = 2;                 // ring slots a warp
constexpr int kPitch = 33;                // words a position: 32 lanes + 1
constexpr int kOut = 32;                  // outputs a lane a store round
constexpr int kMaxS = 16;                 // accumulators a lane
static_assert(kCh % 32 == 0, "a warp copies 32 positions an instruction");

// one lane's stream, read by its whole warp when it copies and stores
struct Stream {
    const float* x;      // the stream's row of x
    const float* tail;   // its row of the tail (x without a tail)
    float* y;            // its first output
    const float* xp;     // x at its first sample's place (in the tail:
                         // before x; only read past the tail)
    long long v0;        // xc index of its first sample, s0*D + shift
    int n_valid;         // outputs it stores (0 for a lane past the work)
    int pad;
};
static_assert(sizeof(Stream) % 16 == 0, "16-byte aligned warp regions");

constexpr int kTabWords = 32 * (int)sizeof(Stream) / 4;
constexpr int kSlotWords = kCh * kPitch;
constexpr int kOutWords = 32 * (kOut + 1);
constexpr int kWarpWords = kTabWords + kSlots * kSlotWords + kOutWords;

struct Args {
    const float* tail0;
    const float* tail1;
    const float* x0;
    const float* x1;
    const float* tf;
    float* y0;
    float* y1;
    long long n_streams;  // planes x C x NSR
    int tail_ld, tail_len, C, T, K, D, shift, n_out;
    int P, PD, qmax;      // the period plan (header note)
    int L;                // outputs a stream
    int NSR;              // streams a (plane, row)
    int n_samp;           // positions a stream reads, P (L-1) D + K
    int tap_words;        // shared floats of the taps, a multiple of 4
};

// floats a tap position takes: ceil4(S), or S for S <= 2
__host__ __device__ constexpr int tap_row(int S) {
    return S <= 2 ? S : (S + 3) / 4 * 4;
}

// 4-byte asynchronous copy to shared memory; 0 where !full (no byte read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(full ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk c of the warp's 32 streams (positions c*kCh .. c*kCh + kCh - 1)
// into one ring slot. fast: every stream's chunk lies in x.
__device__ __forceinline__ void issue_chunk(const Stream* tab, float* slot,
                                            int c, bool fast, int lane,
                                            int tail_len, long long lim) {
    const long long pos0 = (long long)c * kCh;
    float* dst = slot + lane * kPitch;
    if (fast) {
#pragma unroll 4
        for (int s = 0; s < 32; ++s) {
            const float* src = tab[s].xp + pos0 + lane;
#pragma unroll
            for (int i = 0; i < kCh / 32; ++i)
                cp_async4(dst + i * 32 * kPitch + s, src + i * 32, true);
        }
        return;
    }
#pragma unroll 1
    for (int s = 0; s < 32; ++s) {
        const Stream& t = tab[s];
#pragma unroll
        for (int i = 0; i < kCh / 32; ++i) {
            const long long u = t.v0 + pos0 + i * 32 + lane;
            const bool full = u < lim;
            const float* src = !full ? t.x
                               : u < tail_len ? t.tail + u
                                              : t.x + (u - tail_len);
            cp_async4(dst + i * 32 * kPitch + s, src, full);
        }
    }
}

// SP taps of one position from shared memory, as float4 (or float2, float)
template <int SP>
__device__ __forceinline__ void load_taps(const float* tp, float (&t)[SP]) {
    if constexpr (SP % 4 == 0) {
#pragma unroll
        for (int k = 0; k < SP / 4; ++k) {
            const float4 f = reinterpret_cast<const float4*>(tp)[k];
            t[4 * k] = f.x;
            t[4 * k + 1] = f.y;
            t[4 * k + 2] = f.z;
            t[4 * k + 3] = f.w;
        }
    } else if constexpr (SP == 2) {
        const float2 f = *reinterpret_cast<const float2*>(tp);
        t[0] = f.x;
        t[1] = f.y;
    } else {
        t[0] = tp[0];
    }
}

// n consecutive positions of a period: the sample of each feeds the S - 1
// younger accumulators and, with kOldest, the oldest (positions < qmax).
// The next position's sample and taps are loaded before this one's FMAs,
// so their shared-memory latency overlaps the FMAs.
template <int S, bool kOldest>
__device__ __forceinline__ void run(const float* xs, const float* tp, int n,
                                    float (&acc)[S]) {
    constexpr int SP = tap_row(S);
    float x = xs[0];
    float t[SP];
    load_taps<SP>(tp, t);
#pragma unroll 4
    for (int i = 1; i < n; ++i) {
        const float xn = xs[i * kPitch];
        float tn[SP];
        load_taps<SP>(tp + i * SP, tn);
#pragma unroll
        for (int k = 0; k < S - 1; ++k) acc[k] = fmaf(t[k], x, acc[k]);
        if (kOldest) acc[S - 1] = fmaf(t[S - 1], x, acc[S - 1]);
        x = xn;
#pragma unroll
        for (int k = 0; k < SP; ++k) t[k] = tn[k];
    }
#pragma unroll
    for (int k = 0; k < S - 1; ++k) acc[k] = fmaf(t[k], x, acc[k]);
    if (kOldest) acc[S - 1] = fmaf(t[S - 1], x, acc[S - 1]);
}

// the warp's staged outputs e_base .. e_base + count - 1 of each stream,
// one coalesced store a stream (strided by P)
__device__ __forceinline__ void flush(const Stream* tab, const float* obuf,
                                      int e_base, int count, int P,
                                      int lane) {
    __syncwarp();
    const int e = e_base + lane;
#pragma unroll 4
    for (int s = 0; s < 32; ++s) {
        if (lane < count && e < tab[s].n_valid)
            tab[s].y[(long long)e * P] = obuf[s * (kOut + 1) + lane];
    }
    __syncwarp();
}

// The oldest output is complete: staged (outputs e < 0 belong to the lane
// before), and every kOut (and the stream's last) the warp's stored.
__device__ __forceinline__ void emit(float v, int& e, int L, int P,
                                     const Stream* tab, float* obuf,
                                     int lane) {
    if (e >= 0) {
        const int r = e % kOut;
        obuf[lane * (kOut + 1) + r] = v;
        if (r == kOut - 1 || e == L - 1)
            flush(tab, obuf, e - r, r + 1, P, lane);
    }
    ++e;
}

// the next period: every output a period older, the newest from 0
template <int S>
__device__ __forceinline__ void next_period(float (&acc)[S]) {
#pragma unroll
    for (int k = S - 1; k > 0; --k) acc[k] = acc[k - 1];
    acc[0] = 0.0f;
}

// SPD: 0, or a period of SPD = PD positions known at compile time (2, 4:
// kCh is a multiple, so no period straddles a chunk). Then the taps live in
// registers, and a period is straight-line code, several in flight.
template <int S, int SPD>
__global__ void __launch_bounds__(kThreads)
    fir_stream_kernel(const Args a) {
    extern __shared__ __align__(16) float smem[];
    constexpr int SP = tap_row(S);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float* taps = smem;
    float* wbase = smem + a.tap_words + warp * kWarpWords;
    Stream* tab = reinterpret_cast<Stream*>(wbase);
    float* ring = wbase + kTabWords;
    float* obuf = ring + kSlots * kSlotWords;

    // the taps by period position: taps[q*SP + k] = tf[q + k*PD]
    for (int e = threadIdx.x; e < a.PD * SP; e += kThreads) {
        const int q = e / SP, k = e - q * SP;
        const long long j = q + (long long)k * a.PD;
        taps[e] = (k < S && j < a.K) ? a.tf[j] : 0.0f;
    }

    // this lane's stream; past the work, stream 0 storing nothing
    const long long sid =
        ((long long)blockIdx.x * kWarps + warp) * 32 + lane;
    const long long id = sid < a.n_streams ? sid : 0;
    const int rp = (int)(id / a.NSR);  // plane * C + row
    const int sigma = (int)(id - (long long)rp * a.NSR);
    const int plane = rp / a.C, row = rp - plane * a.C;
    const int g = sigma / a.P, rho = sigma - g * a.P;
    const long long s0 = (long long)g * a.P * a.L + rho;
    Stream st;
    st.x = (plane ? a.x1 : a.x0) + (size_t)row * a.T;
    st.tail = a.tail_len
                  ? (plane ? a.tail1 : a.tail0) + (size_t)row * a.tail_ld
                  : st.x;
    st.y = (plane ? a.y1 : a.y0) + (size_t)row * a.n_out + s0;
    st.v0 = s0 * a.D + a.shift;
    st.xp = st.x + (st.v0 - a.tail_len);
    st.n_valid = sid < a.n_streams && s0 < a.n_out
                     ? (int)min((long long)a.L,
                                (a.n_out - s0 + a.P - 1) / a.P)
                     : 0;
    tab[lane] = st;
    __syncthreads();  // the taps and the tables; no block barrier after
    if (((long long)blockIdx.x * kWarps + warp) * 32 >= a.n_streams) return;

    // the chunks that lie in x for all 32 streams: [c_lo, c_hi]
    const long long lim = (long long)a.tail_len + a.T;
    int c_lo = st.v0 >= a.tail_len
                   ? 0
                   : (int)((a.tail_len - st.v0 + kCh - 1) / kCh);
    int c_hi = (int)((lim - st.v0) / kCh) - 1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        c_lo = max(c_lo, __shfl_xor_sync(0xffffffffu, c_lo, o));
        c_hi = min(c_hi, __shfl_xor_sync(0xffffffffu, c_hi, o));
    }

    const int n_chunks = (a.n_samp + kCh - 1) / kCh;
#pragma unroll
    for (int c = 0; c < kSlots - 1; ++c) {
        if (c < n_chunks)
            issue_chunk(tab, ring + c * kSlotWords, c,
                        c >= c_lo && c <= c_hi, lane, a.tail_len, lim);
        cp_async_commit();
    }

    float acc[S];
#pragma unroll
    for (int k = 0; k < S; ++k) acc[k] = 0.0f;
    constexpr int kP = SPD > 0 ? SPD : 1;
    float tr[kP][S];  // SPD > 0: the taps of each position
    bool full[kP];    // SPD > 0: whether the oldest takes a tap there
    if constexpr (SPD > 0) {
#pragma unroll
        for (int q = 0; q < SPD; ++q) {
            full[q] = q < a.qmax;
#pragma unroll
            for (int k = 0; k < S; ++k) tr[q][k] = taps[q * SP + k];
        }
    }
    int q = 0;       // position in the period
    int e = 1 - S;   // index of the output the oldest accumulator holds
    const float* tp = taps;
    int left = a.n_samp;
    int per_left = a.L + S - 1;  // SPD > 0: periods still to run
    for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait<kSlots - 2>();  // this lane's copies of chunk c
        __syncwarp();                 // everyone's; slot c-1 read by all
        const int cn = c + kSlots - 1;
        if (cn < n_chunks)
            issue_chunk(tab, ring + (cn % kSlots) * kSlotWords, cn,
                        cn >= c_lo && cn <= c_hi, lane, a.tail_len, lim);
        cp_async_commit();
        const float* xs = ring + (c % kSlots) * kSlotWords + lane;
        if constexpr (SPD > 0) {
            const int n_per = min(kCh / SPD, per_left);
            per_left -= n_per;
#pragma unroll 4
            for (int i = 0; i < n_per; ++i) {
#pragma unroll
                for (int qq = 0; qq < SPD; ++qq) {
                    const float x = xs[(i * SPD + qq) * kPitch];
#pragma unroll
                    for (int k = 0; k < S - 1; ++k)
                        acc[k] = fmaf(tr[qq][k], x, acc[k]);
                    if (full[qq])
                        acc[S - 1] = fmaf(tr[qq][S - 1], x, acc[S - 1]);
                }
                emit(acc[S - 1], e, a.L, a.P, tab, obuf, lane);
                next_period(acc);
            }
            continue;
        }
        const int o_end = min(kCh, left);
        int o = 0;
        while (o < o_end) {
            const bool oldest = q < a.qmax;
            const int n = min(o_end - o, (oldest ? a.qmax : a.PD) - q);
            if (oldest)
                run<S, true>(xs + o * kPitch, tp, n, acc);
            else
                run<S, false>(xs + o * kPitch, tp, n, acc);
            o += n;
            q += n;
            tp += n * SP;
            if (q == a.qmax) emit(acc[S - 1], e, a.L, a.P, tab, obuf, lane);
            if (q == a.PD) {
                next_period(acc);
                q = 0;
                tp = taps;
            }
        }
        left -= o_end;
    }
    cp_async_wait<0>();
}

// The period plan of a shape (header note).
struct Plan {
    int S, P;
};

Plan plan_of(int K, int D) {
    const int A = (K + D - 1) / D;
    Plan p;
    p.P = A <= kMaxS ? 1 : (A + kMaxS - 1) / kMaxS;
    p.S = (A + p.P - 1) / p.P;
    return p;
}

long long tap_words(int K, int D) {
    const Plan p = plan_of(K, D);
    return ((long long)p.P * D * tap_row(p.S) + 3) / 4 * 4;
}

template <int S, int SPD>
int launch(Args a, int planes, long long smem, cudaStream_t stream) {
    auto kern = fir_stream_kernel<S, SPD>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, dev = 0, n_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, (size_t)smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // one wave of lanes: streams a row so that planes x C x NSR fill it
    const long long lanes = (long long)per_sm * n_sm * kThreads;
    const long long rows = (long long)planes * a.C;
    const long long segs = lanes / (rows * a.P) > 1 ? lanes / (rows * a.P)
                                                     : 1;
    const long long per_seg = (long long)a.P * segs;
    a.L = (int)((a.n_out + per_seg - 1) / per_seg);
    a.NSR = a.P * (int)((a.n_out + (long long)a.P * a.L - 1) /
                        ((long long)a.P * a.L));
    a.n_streams = rows * a.NSR;
    a.n_samp = (int)((long long)a.P * (a.L - 1) * a.D + a.K);
    const long long blocks = (a.n_streams + kThreads - 1) / kThreads;
    kern<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes.
long long fir_stream_smem_bytes(int K, int D) {
    return (tap_words(K, D) + (long long)kWarps * kWarpWords) *
           (long long)sizeof(float);
}

// tail0/tail1: (C, tail_ld)-strided rows of K-1 floats, or null (K2 form);
// x0/x1, y0/y1: contiguous (C, T) and (C, n_out); planes 1 or 2 (the *1
// pointers are read only for 2). Returns cudaGetLastError() after launch.
int fir_stream_f32(const void* tail0, const void* tail1, int tail_ld,
                   const void* x0, const void* x1, const void* taps_flipped,
                   void* y0, void* y1, int C, int T, int K, int D, int shift,
                   int n_out, int planes, void* stream) {
    if (n_out <= 0 || C <= 0) return 0;
    const Plan p = plan_of(K, D);
    Args a{};
    a.tail0 = (const float*)tail0;
    a.tail1 = (const float*)tail1;
    a.x0 = (const float*)x0;
    a.x1 = (const float*)x1;
    a.tf = (const float*)taps_flipped;
    a.y0 = (float*)y0;
    a.y1 = (float*)y1;
    a.tail_ld = tail_ld;
    a.tail_len = tail0 ? K - 1 : 0;
    a.C = C;
    a.T = T;
    a.K = K;
    a.D = D;
    a.shift = shift;
    a.n_out = n_out;
    a.P = p.P;
    a.PD = p.P * D;
    a.qmax = K - (p.S - 1) * a.PD;
    a.tap_words = (int)tap_words(K, D);
    const long long smem = fir_stream_smem_bytes(K, D);
    cudaStream_t s = (cudaStream_t)stream;
    switch (p.S) {
#define QRL_FIR_STREAM_S(S)                                          \
    case S:                                                          \
        return a.PD == 2   ? launch<S, 2>(a, planes, smem, s)        \
               : a.PD == 4 ? launch<S, 4>(a, planes, smem, s)        \
                           : launch<S, 0>(a, planes, smem, s);
        QRL_FIR_STREAM_S(1) QRL_FIR_STREAM_S(2) QRL_FIR_STREAM_S(3)
        QRL_FIR_STREAM_S(4) QRL_FIR_STREAM_S(5) QRL_FIR_STREAM_S(6)
        QRL_FIR_STREAM_S(7) QRL_FIR_STREAM_S(8) QRL_FIR_STREAM_S(9)
        QRL_FIR_STREAM_S(10) QRL_FIR_STREAM_S(11) QRL_FIR_STREAM_S(12)
        QRL_FIR_STREAM_S(13) QRL_FIR_STREAM_S(14) QRL_FIR_STREAM_S(15)
        QRL_FIR_STREAM_S(16)
#undef QRL_FIR_STREAM_S
    }
    return (int)cudaErrorInvalidValue;
}

const char* fir_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// depthwise_fir_f32: stride-1 VALID FIR with its own taps on every row,
// over one or two f32 planes.
//
// Replaces the Pallas TPU kernel of qradiolink_tpu/ops/pallas_fir.py
// `depthwise_fir` -> `_depthwise_call` (pallas_fir.py:401), which runs the
// PFB channelizer's branch filters (here: on complex input) and the PFB
// synthesizer's branch filters, at every kp that csrc/depthwise_run.cu
// (depthwise_run_f32) has no instance for (ops/cuda_depthwise.route). No
// registry path runs it: MMDVMmulti's synthesizer (kp 53), its last path,
// went to depthwise_run_f32, whose tail form reads the tails
// in place; here the tail form is a concatenation first (two launches),
// and each block stages its span behind one barrier with 4-byte loads
// and tests bounds at every FMA. chip_smoke.py times the two in turns.
//
// Function, for row r of a (rows, Tc) plane, with tf the flipped taps of
// that row's filter c = r mod C (tf[c][j] = taps[c][kp-1-j]):
//     y[r][m] = sum_j tf[c][j] * x[r][m + j],   m in [0, n_out)
// n_out <= Tc - kp + 1; the caller's input is already [history | block].
//
// Design: one block of G = 128 threads per (tile of G*R outputs, row,
// plane); the plane rides gridDim.z, so both planes of an IqPair go in one
// launch. The block stages the row's kp taps and its input span
// [m0, m0 + G*R + kp - 1) in shared memory with coalesced loads; thread t
// then computes the R outputs m0 + t + i*G (i < R), which keeps the
// shared-memory reads of a warp on consecutive words (no bank conflicts)
// and lets each tap read from shared memory serve R outputs. The sums run
// j = 0 .. kp-1 in order, one f32 FMA each. Every output is computed here:
// the caller has no remainder to stitch.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at the channelizer's branch shape (64 rows x 100,023 in,
// 100,000 out, kp 24, two planes): 2 x 64 x 200,023 x 4 B = 102 MB, so
// >= 0.031 ms, bytes-bound (0.61 GFLOP is 0.009 ms). The staged span
// reads each input element about once (the halo is kp-1 per G*R); the
// shared-memory traffic (kp*(R+1) words per R*kp FMAs) is what keeps
// this simple form above the memory bound.

#include <cuda_runtime.h>

namespace {

constexpr int kG = 128;  // threads per block
constexpr int kR = 4;    // outputs per thread
constexpr int kTile = kG * kR;

__global__ void depthwise_fir_kernel(const float* __restrict__ x0,
                                     const float* __restrict__ x1,
                                     const float* __restrict__ tf,
                                     float* __restrict__ y0,
                                     float* __restrict__ y1,
                                     int C, int Tc, int kp, int n_out) {
    extern __shared__ float smem[];
    float* s_tap = smem;       // kp
    float* s_x = smem + kp;    // kTile + kp - 1

    const int row = blockIdx.y;
    const int plane = blockIdx.z;
    const float* x = (plane ? x1 : x0) + (size_t)row * Tc;
    float* y = (plane ? y1 : y0) + (size_t)row * n_out;
    const float* taps = tf + (size_t)(row % C) * kp;

    const int m0 = blockIdx.x * kTile;
    const int count = min(kTile, n_out - m0);
    const int span = count + kp - 1;

    for (int i = threadIdx.x; i < kp; i += blockDim.x) s_tap[i] = taps[i];
    for (int i = threadIdx.x; i < span; i += blockDim.x) s_x[i] = x[m0 + i];
    __syncthreads();

    float acc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = 0.0f;
    for (int j = 0; j < kp; ++j) {
        const float h = s_tap[j];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
            const int m = threadIdx.x + i * kG;
            if (m < count) acc[i] = fmaf(h, s_x[m + j], acc[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
        const int m = threadIdx.x + i * kG;
        if (m < count) y[m0 + m] = acc[i];
    }
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes.
long long depthwise_smem_bytes(int kp) {
    return (long long)(kp + kTile + kp - 1) * (long long)sizeof(float);
}

// x0/x1: contiguous (rows, Tc); y0/y1: contiguous (rows, n_out); taps:
// contiguous (C, kp) flipped taps, row r using taps row r mod C; planes 1
// or 2 (the *1 pointers are read only for 2). Returns cudaGetLastError()
// after the launch.
int depthwise_fir_f32(const void* x0, const void* x1,
                      const void* taps_flipped, void* y0, void* y1,
                      int rows, int C, int Tc, int kp, int n_out, int planes,
                      void* stream) {
    const long long smem = depthwise_smem_bytes(kp);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            depthwise_fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((n_out + kTile - 1) / kTile, rows, planes);
    depthwise_fir_kernel<<<grid, kG, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)x0, (const float*)x1, (const float*)taps_flipped,
        (float*)y0, (float*)y1, C, Tc, kp, n_out);
    return (int)cudaGetLastError();
}

const char* depthwise_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// fir_stream_f32: streaming strided FIR over one or two f32 planes.
//
// Replaces the two Pallas TPU kernels of qradiolink_tpu/ops/pallas_fir.py
// that compute the same strided FIR:
//   * banded_fir_stream -> _stream_call (pallas_fir.py:218), the concat-free
//     streaming form with a carried tail (the 1 Msps /50 resampler head and
//     the channel low-pass of the 4FSK chain);
//   * banded_fir -> _banded_call (pallas_fir.py:111), the VALID form over an
//     input that is already concatenated (the 251-tap stride-1 RRC).
//
// Function, over the virtual stream xc = [tail (tail_len) | x (T)] of each
// row, with tf the flipped taps (tf[j] = h[K-1-j]):
//     y[m] = sum_j tf[j] * xc[m*D + shift + j],   m in [0, n_out)
// tail_len is K-1 with a tail (K1) and 0 without one (K2).
//
// Design: one block of G = 128 threads per (tile of G outputs, row, plane);
// the plane rides gridDim.z, so the re and im planes of an IqPair go in one
// launch. The block stages the taps and its input span
// [m0*D + shift, (m0+G-1)*D + shift + K) of the virtual stream in shared
// memory with coalesced loads (the tail/x seam is resolved per element, so
// the concatenation is never materialised), then each thread computes one
// output as K f32 FMAs from shared memory, j = 0 .. K-1 in order. Every
// output is computed here: the caller has no remainder to stitch.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at the 4FSK main path with 2048 channels x 200,000 samples:
//   head  K=419 D=50: 2 x 2048 x 200,000 x 4 B = 3.28 GB read, >= ~1.0 ms,
//                     memory-bound (13.7 GFLOP, 0.2 ms);
//   channel LP K=55 D=1: ~133 MB (~0.04 ms) vs 1.8 GFLOP (~0.03 ms),
//                     memory-bound;
//   RRC K=251 D=1, real: ~66 MB (~0.02 ms) vs 4.1 GFLOP (~0.06 ms),
//                     compute-bound, both tiny.
// The staged span reads each input element about once (the overlap of
// neighbouring tiles is K-D elements per G*D), so the head can approach the
// memory bound; the inner loop is plain FMAs from shared memory, not tensor
// cores, which bounds the long stride-1 filters. A cp.async/TMA ring and a
// tensor-core form are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kG = 128;  // outputs per block = threads per block

__global__ void fir_stream_kernel(const float* __restrict__ tail0,
                                  const float* __restrict__ tail1,
                                  int tail_ld, int tail_len,
                                  const float* __restrict__ x0,
                                  const float* __restrict__ x1,
                                  const float* __restrict__ tf,
                                  float* __restrict__ y0,
                                  float* __restrict__ y1,
                                  int T, int K, int D, int shift, int n_out) {
    extern __shared__ float smem[];
    float* s_tap = smem;       // K
    float* s_x = smem + K;     // (kG-1)*D + K

    const int row = blockIdx.y;
    const int plane = blockIdx.z;
    const float* tail = plane ? tail1 : tail0;
    const float* x = (plane ? x1 : x0) + (size_t)row * T;
    float* y = (plane ? y1 : y0) + (size_t)row * n_out;
    if (tail != nullptr) tail += (size_t)row * tail_ld;

    const int m0 = blockIdx.x * kG;
    const int g_count = min(kG, n_out - m0);
    const long long base = (long long)m0 * D + shift;
    const int span = (g_count - 1) * D + K;

    for (int i = threadIdx.x; i < K; i += blockDim.x) s_tap[i] = tf[i];
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const long long v = base + i;
        s_x[i] = v < tail_len ? tail[v] : x[v - tail_len];
    }
    __syncthreads();

    const int g = threadIdx.x;
    if (g < g_count) {
        const float* p = s_x + g * D;
        float acc = 0.0f;
        for (int j = 0; j < K; ++j) acc = fmaf(s_tap[j], p[j], acc);
        y[m0 + g] = acc;
    }
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes.
long long fir_stream_smem_bytes(int K, int D) {
    return (long long)(K + (kG - 1) * D + K) * (long long)sizeof(float);
}

// tail0/tail1: (C, tail_ld)-strided rows of K-1 floats, or null (K2 form);
// x0/x1, y0/y1: contiguous (C, T) and (C, n_out); planes 1 or 2 (the *1
// pointers are read only for 2). Returns cudaGetLastError() after launch.
int fir_stream_f32(const void* tail0, const void* tail1, int tail_ld,
                   const void* x0, const void* x1, const void* taps_flipped,
                   void* y0, void* y1, int C, int T, int K, int D, int shift,
                   int n_out, int planes, void* stream) {
    const int tail_len = tail0 ? K - 1 : 0;
    const long long smem = fir_stream_smem_bytes(K, D);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fir_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((n_out + kG - 1) / kG, C, planes);
    fir_stream_kernel<<<grid, kG, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, tail_len,
        (const float*)x0, (const float*)x1, (const float*)taps_flipped,
        (float*)y0, (float*)y1, T, K, D, shift, n_out);
    return (int)cudaGetLastError();
}

const char* fir_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

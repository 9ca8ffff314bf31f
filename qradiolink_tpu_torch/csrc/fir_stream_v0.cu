// fir_stream_v0_f32: the first design of fir_stream_f32 (csrc/fir.cu),
// kept unchanged beside the redesign so that the two can be timed in turns
// and held bit-equal. No path launches it: ops/cuda_fir.route() never
// names it, and only ops/cuda_fir.fir_stream_v0() calls it.
//
// Replaced the two Pallas TPU kernels of qradiolink_tpu/ops/pallas_fir.py
// that compute the strided FIR: banded_fir_stream -> _stream_call
// (pallas_fir.py:218) and banded_fir -> _banded_call (pallas_fir.py:111).
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
// output as K f32 FMAs from shared memory, j = 0 .. K-1 in order.
//
// What holds it back (csrc/fir.cu's note has the measurements): two shared
// loads (a tap and a sample) an FMA; 4-way bank conflicts at D = 100 and
// 2-way at even D; the whole span staged before any FMA, with nothing in
// flight during the FMAs but other resident blocks' loads; and at small D
// blocks of 128 outputs, each a barrier and a few hundred floats.

#include <cuda_runtime.h>

namespace {

constexpr int kG = 128;  // outputs per block = threads per block

__global__ void fir_stream_v0_kernel(const float* __restrict__ tail0,
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
long long fir_stream_v0_smem_bytes(int K, int D) {
    return (long long)(K + (kG - 1) * D + K) * (long long)sizeof(float);
}

// tail0/tail1: (C, tail_ld)-strided rows of K-1 floats, or null (K2 form);
// x0/x1, y0/y1: contiguous (C, T) and (C, n_out); planes 1 or 2 (the *1
// pointers are read only for 2). Returns cudaGetLastError() after launch.
int fir_stream_v0_f32(const void* tail0, const void* tail1, int tail_ld,
                   const void* x0, const void* x1, const void* taps_flipped,
                   void* y0, void* y1, int C, int T, int K, int D, int shift,
                   int n_out, int planes, void* stream) {
    const int tail_len = tail0 ? K - 1 : 0;
    const long long smem = fir_stream_v0_smem_bytes(K, D);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fir_stream_v0_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((n_out + kG - 1) / kG, C, planes);
    fir_stream_v0_kernel<<<grid, kG, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)tail0, (const float*)tail1, tail_ld, tail_len,
        (const float*)x0, (const float*)x1, (const float*)taps_flipped,
        (float*)y0, (float*)y1, T, K, D, shift, n_out);
    return (int)cudaGetLastError();
}

const char* fir_stream_v0_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

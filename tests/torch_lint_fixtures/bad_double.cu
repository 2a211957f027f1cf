// SITPU-CUDA bad fixture: `double_chunk` with a floored grid that no
// wrapper guards (P2), and a staged variant whose dynamic shared memory
// passes 48 KiB with no cudaFuncSetAttribute opt-in (P3). Parsed by the
// linter only, never built.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kThreads = 256;

__global__ void double_kernel(const float* x, float* y, float* m, int w) {
    const long long base = (long long)blockIdx.x * kTileH * w;
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < kTileH * w; i += kThreads) {
        mx = fmaxf(mx, x[base + i]);
        y[base + i] = 2.0f * x[base + i];
    }
    if (threadIdx.x == 0) m[blockIdx.x] = mx;
}

__global__ void staged_kernel(const float* x, float* y, float* m, int w) {
    extern __shared__ float tile[];
    const long long base = (long long)blockIdx.x * kTileH * w;
    for (int i = threadIdx.x; i < kTileH * w; i += kThreads)
        tile[i] = x[base + i];
    __syncthreads();
    for (int i = threadIdx.x; i < kTileH * w; i += kThreads)
        y[base + i] = 2.0f * tile[i];
    if (threadIdx.x == 0) m[blockIdx.x] = tile[0];
}

}  // namespace

extern "C" int bad_double_chunk(const float* x, float* y, float* m, int h,
                                int w, cudaStream_t stream) {
    const unsigned blocks = (unsigned)(h / kTileH);
    double_kernel<<<blocks, kThreads, 0, stream>>>(x, y, m, w);
    return (int)cudaGetLastError();
}

extern "C" int bad_double_chunk_staged(const float* x, float* y, float* m,
                                       int h, int w, cudaStream_t stream) {
    const size_t smem = (size_t)kTileH * w * sizeof(float);
    staged_kernel<<<(h + kTileH - 1) / kTileH, kThreads, smem, stream>>>(
        x, y, m, w);
    return (int)cudaGetLastError();
}

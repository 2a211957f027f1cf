// B10: the lint fixture's kernel `double_chunk` on Hopper (sm_90a).
//
// Replaces the Pallas kernel of tests/lint_fixtures/good_pallas.py
// (`double_chunk`, pallas_call at :24, `_kernel` at :13): y = 2 x of
// f32[H, W], and each 8-row tile's max over all of its values into
// f32[H/8, 1]. H % 8 == 0 is the wrapper's guard (good_cuda.py raises
// before it launches), so the grid below is one block per 8-row tile.
//
// Bound: bytes. Each value is read once and written once (8 B a value,
// 0.160 ms at 8192^2 on 3.35 TB/s); two float ops a value. Design: one
// block of 256 threads per tile streams it as float4 (16-byte loads and
// stores, evict-first, where the rows are 16-byte aligned), each thread
// keeps a running max, a warp-shuffle max and one shared-memory step
// reduce the block, and one thread stores the tile's max.
//
// The max propagates NaN as jnp.max and torch.amax do (fmaxf would drop
// it): a tile holding a NaN has the max NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
double_chunk_kernel(const float* __restrict__ x, float* __restrict__ y,
                    float* __restrict__ m, int w, int vec) {
    const long long base = (long long)blockIdx.x * kTileH * w;
    const int n = kTileH * w;
    float mx = -INFINITY;
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(x + base);
        float4* y4 = reinterpret_cast<float4*>(y + base);
        for (int i = threadIdx.x; i < n / 4; i += kThreads) {
            const float4 v = __ldcs(x4 + i);
            mx = nan_max(nan_max(nan_max(nan_max(mx, v.x), v.y), v.z), v.w);
            __stcs(y4 + i, make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f,
                                       v.w * 2.0f));
        }
    } else {
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const float v = x[base + i];
            mx = nan_max(mx, v);
            y[base + i] = v * 2.0f;
        }
    }
    for (int o = 16; o > 0; o >>= 1)
        mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    __shared__ float warp_max[kThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
    __syncthreads();
    if (threadIdx.x < 32) {
        mx = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : -INFINITY;
        for (int o = 16; o > 0; o >>= 1)
            mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (threadIdx.x == 0) m[blockIdx.x] = mx;
    }
}

}  // namespace

// x, y f32[h, w], m f32[h / 8]; h a multiple of 8 (the wrapper raises
// otherwise; refused here too).
extern "C" int double_chunk(const float* x, float* y, float* m, int h, int w,
                            cudaStream_t stream) {
    if (h < 0 || w < 1 || h % kTileH) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(h / kTileH);
    if (blocks == 0) return (int)cudaSuccess;
    const int vec = (w % 4 == 0) &&
        ((((uintptr_t)x) | ((uintptr_t)y)) % 16 == 0);
    double_chunk_kernel<<<blocks, kThreads, 0, stream>>>(x, y, m, w, vec);
    return (int)cudaGetLastError();
}

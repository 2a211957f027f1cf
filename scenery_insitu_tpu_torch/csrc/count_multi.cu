// K2 — segment-start counts of one chunk of shaded slices for B candidate
// thresholds at once (the histogram counting march that seeds the
// temporal threshold).
//
// Replaces the TPU kernel scenery_insitu_tpu/ops/pallas_march.py,
// count_multi_chunk, kernel body _count_kernel. Plain version and oracle:
// supersegments.push_count with threshold = tvec[:, None, None], run by
// ops/cuda_march.py::count_multi_chunk_plain.
//
// What bounds it on the H100: bytes. Per chunk a pixel reads C x 4 rgba
// values and reads and writes its B counts, 3 prev rgb values and the
// prev-empty flag; per slice the work is one distance and B compares.
//
// Design. A runtime slice loop would wait on each slice's compares before
// the next slice's loads, and one counter array as wide as the largest B
// would carry a predicate a counter; so:
//
// - One thread a pixel, neighbouring threads on neighbouring x, so every
//   plane access coalesces across the warp.
// - Builds templated on the slice count and on the counter width: C = 16
//   and C = 1 (the march's chunks) with the slice loop unrolled, and a
//   generic build for any other C; B = 16 (the seed's bins) exactly, and
//   B <= 32 on a 32-wide build whose unused thresholds are +inf. The
//   counters and thresholds live in registers, unrolled, with no
//   predicate in the slice loop: a padded counter counts only forced
//   starts and is never stored.
// - Memory-level parallelism: a thread issues the 4 loads of each of
//   kGroup slices before it walks them, and the C = 16 build unrolls its
//   four groups, so the next group's loads need not wait on this group's
//   compares. The slices are read once, evict-first (`__ldcs`); the
//   counters and the carry use the default policy.
// - The thresholds need not ascend: every counter compares with its own
//   threshold.
//
// Trials (chip_smoke.py phase 2, --k2-compare, in turns; PERF.md §6): on
// the threshold seed's 32 chunks of the frame (mostly empty
// pixels), groups of 4 slices beat groups of 8 by 5 % and groups of 16
// (118 registers, 2 blocks of 256 an SM) lost 3.5 %; blocks of 128
// threads beat 256 by 3 % there and 4 % on the seeded C = 16 and C = 1
// chunks. Each variant was a copy of this source served through
// --k2-compare.
//
// Exactness: one ulp in the distance flips a count wherever it sits on a
// threshold, and the counts must equal the plain version's exactly. The
// distance is written as the plain version writes it, sqrt(d0*d0 + d1*d1
// + d2*d2), and the library is built without FMA contraction.
//
// State (updated in place): count i32[B,H,W], prev f32[3,H,W], fe
// f32[H,W] (previous item empty, > 0.5).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 128;
constexpr int kMaxBins = 32;

// C: the slice count (0: any, read from c); NB: the counters (16 exactly
// B, or kMaxBins for any B <= kMaxBins, padded with +inf thresholds);
// G: the slices whose loads go out together
template <int C, int NB, int G>
__global__ void __launch_bounds__(kThreads)
count_multi_kernel(const float* __restrict__ rgba,
                   const float* __restrict__ tvec,
                   int* __restrict__ count, float* __restrict__ prev,
                   float* __restrict__ fe, int c_any, int nb, long long hw) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;
    const int c = C > 0 ? C : c_any;

    float t[NB];
    int cnt[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const bool on = NB == 16 || b < nb;
        t[b] = on ? __ldg(tvec + b) : INFINITY;
        cnt[b] = on ? count[(long long)b * hw + p] : 0;
    }
    float pr0 = prev[p], pr1 = prev[hw + p], pr2 = prev[2 * hw + p];
    bool pe = fe[p] > 0.5f;

#pragma unroll
    for (int s0 = 0; s0 < c; s0 += G) {
        float r[G], g[G], bl[G], a[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
            const bool in = (C > 0 && C % G == 0) || s0 + j < c;
            const float* src = rgba + (long long)(s0 + j) * 4 * hw + p;
            r[j] = in ? __ldcs(src) : 0.f;
            g[j] = in ? __ldcs(src + hw) : 0.f;
            bl[j] = in ? __ldcs(src + 2 * hw) : 0.f;
            a[j] = in ? __ldcs(src + 3 * hw) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
            if (!((C > 0 && C % G == 0) || s0 + j < c)) break;
            const bool emp = a[j] < kEmptyAlpha;
            if (!emp) {
                const float d0 = r[j] - pr0, d1 = g[j] - pr1,
                            d2 = bl[j] - pr2;
                const float diff = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
#pragma unroll
                for (int b = 0; b < NB; ++b)
                    cnt[b] += (pe || diff > t[b]) ? 1 : 0;
                pr0 = r[j];
                pr1 = g[j];
                pr2 = bl[j];
            }
            pe = emp;
        }
    }

#pragma unroll
    for (int b = 0; b < NB; ++b)
        if (NB == 16 || b < nb) count[(long long)b * hw + p] = cnt[b];
    prev[p] = pr0;
    prev[hw + p] = pr1;
    prev[2 * hw + p] = pr2;
    fe[p] = pe ? 1.0f : 0.0f;
}

constexpr int kGroup = 4;   // the slices whose loads go out together

template <int NB>
const void* pick_c(int c) {
    if (c == 16) return (const void*)count_multi_kernel<16, NB, kGroup>;
    if (c == 1) return (const void*)count_multi_kernel<1, NB, 1>;
    return (const void*)count_multi_kernel<0, NB, kGroup>;
}

// the build a call of (c, nb) takes
const void* pick(int c, int nb) {
    return nb == 16 ? pick_c<16>(c) : pick_c<kMaxBins>(c);
}

}  // namespace

extern "C" int count_multi(const float* rgba, const float* tvec, int* count,
                           float* prev, float* fe, int c, int nb, int h,
                           int w, cudaStream_t stream) {
    if (nb < 1 || nb > kMaxBins || c < 1) return (int)cudaErrorInvalidValue;
    const long long hw = (long long)h * w;
    const unsigned blocks = (unsigned)((hw + kThreads - 1) / kThreads);
    void* args[] = {(void*)&rgba, (void*)&tvec, (void*)&count, (void*)&prev,
                    (void*)&fe, (void*)&c, (void*)&nb, (void*)&hw};
    const cudaError_t e = cudaLaunchKernel(pick(c, nb), dim3(blocks),
                                           dim3(kThreads), args, 0, stream);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// the build a call of (c, nb) takes: out int[6] = registers a thread,
// local-memory bytes a thread, shared bytes a block, resident blocks an
// SM, threads a block, and the slices whose loads go out together
extern "C" int count_multi_attributes(int c, int nb, int* out) {
    if (nb < 1 || nb > kMaxBins || c < 1) return (int)cudaErrorInvalidValue;
    const void* fn = pick(c, nb);
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    int bps = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = bps;
    out[4] = kThreads;
    out[5] = c == 1 ? 1 : kGroup;
    return 0;
}

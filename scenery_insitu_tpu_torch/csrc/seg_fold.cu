// K1 — segmented write fold of one chunk of shaded slices into the K-slot
// supersegment state. Two entries share one body: the compact depth form
// (seg_fold_compact: t = sk * length computed here) and the planes form
// (seg_fold_planes, B1b: t0/t1 f32[C,H,W] read from memory).
//
// Replaces the TPU kernel scenery_insitu_tpu/ops/pallas_seg.py,
// fold_chunk_packed, compact form (kernel body _seg_kernel_compact) and
// planes form (kernel body _seg_kernel), both with _phase_a / _phase_b.
// Plain version and oracle: seg_fold.seg_fold_chunk, run by
// ops/cuda_seg.py::fold_chunk_packed_plain. Given planes that are the
// product sk * length (one f32 multiply, as here), the two forms are
// equal bit for bit.
//
// What bounds it on the H100: bytes. Per chunk a pixel reads its C x 4
// rgba values, its length (or its C x 2 depths) and threshold, reads and writes the 5-float
// small state, and reads and writes the color (4) and depth (2) rows of
// the slots the chunk touched; the arithmetic is ~20 flops per slice.
//
// Design. Pixels are independent, so one thread owns one pixel and
// neighbouring threads own neighbouring x, so every load and store of a
// [., H, W] plane coalesces. The thread walks the C slices with the four
// carries of the TPU kernel's phase A in registers (running start count,
// running transmittance, prev rgb, prev empty). Inside one chunk the slot
// of the non-empty slices, min(count - 1, K - 1), never decreases, so the
// records of one slot are contiguous: the thread accumulates the current
// slot's premultiplied sum and depth min/max in registers and flushes
// them into the state row with the under-merge co = oc + (1 - oc.a) *
// contrib (start = min, end = max) when the slot changes and at the end.
// Each touched slot row is read and written once and no [C, ...] scratch
// exists — the TPU kernel's VMEM record buffer and K-loop are gone.
// Untouched rows are left as they are, which is what the K-loop's merge
// of a zero contribution computes.
//
// State layout (updated in place): color f32[K,4,H,W], depth f32[K,2,H,W]
// (start, end), small f32[5,H,W] = count (f32-encoded), prev rgb, prev
// empty (> 0.5).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 256;

__device__ __forceinline__ void flush(float* color, float* depth, int slot,
                                      long long hw, long long p,
                                      const float acc[4], float dmin,
                                      float dmax) {
    float* oc = color + (long long)slot * 4 * hw + p;
    const float w = 1.0f - oc[3 * hw];
    oc[0] = oc[0] + w * acc[0];
    oc[hw] = oc[hw] + w * acc[1];
    oc[2 * hw] = oc[2 * hw] + w * acc[2];
    oc[3 * hw] = oc[3 * hw] + w * acc[3];
    float* od = depth + (long long)slot * 2 * hw + p;
    od[0] = fminf(od[0], dmin);
    od[hw] = fmaxf(od[hw], dmax);
}

// PLANES: t0/t1 are f32[C,H,W] planes (length, sk0 and sk1 unused);
// otherwise t = sk0[s] * length and sk1[s] * length (t0, t1 unused)
template <bool PLANES>
__global__ void __launch_bounds__(kThreads)
seg_fold_kernel(const float* __restrict__ rgba,
                const float* __restrict__ length,
                const float* __restrict__ thr,
                const float* __restrict__ sk0,
                const float* __restrict__ sk1,
                const float* __restrict__ t0,
                const float* __restrict__ t1,
                float* __restrict__ color,
                float* __restrict__ depth,
                float* __restrict__ small,
                int c, int k, long long hw) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;

    float cnt = small[p];
    float pr0 = small[hw + p], pr1 = small[2 * hw + p],
          pr2 = small[3 * hw + p];
    bool pe = small[4 * hw + p] > 0.5f;
    const float th = thr[p];
    const float ln = PLANES ? 0.0f : length[p];
    const float kf = (float)(k - 1);

    float t_run = 1.0f;
    int cur = -1;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float dmin = INFINITY, dmax = -INFINITY;

    for (int s = 0; s < c; ++s) {
        const float* src = rgba + (long long)s * 4 * hw + p;
        const float r = src[0], g = src[hw], b = src[2 * hw],
                    a = src[3 * hw];
        const bool emp = a < kEmptyAlpha;
        const float d0 = r - pr0, d1 = g - pr1, d2 = b - pr2;
        const float diff = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        const bool start = !emp && (pe || diff > th);
        cnt = cnt + (start ? 1.0f : 0.0f);
        const float sid = cnt - 1.0f;
        const bool reset = start && (sid <= kf);
        const float t_here = reset ? 1.0f : t_run;
        t_run = t_here * (1.0f - (emp ? 0.0f : a));
        if (!emp) {
            const int slot = (int)fminf(sid, kf);
            if (slot != cur) {
                if (cur >= 0) flush(color, depth, cur, hw, p, acc, dmin, dmax);
                cur = slot;
                acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
                dmin = INFINITY;
                dmax = -INFINITY;
            }
            acc[0] += r * t_here;
            acc[1] += g * t_here;
            acc[2] += b * t_here;
            acc[3] += a * t_here;
            if (PLANES) {
                dmin = fminf(dmin, t0[(long long)s * hw + p]);
                dmax = fmaxf(dmax, t1[(long long)s * hw + p]);
            } else {
                dmin = fminf(dmin, sk0[s] * ln);
                dmax = fmaxf(dmax, sk1[s] * ln);
            }
            pr0 = r;
            pr1 = g;
            pr2 = b;
        }
        pe = emp;
    }
    if (cur >= 0) flush(color, depth, cur, hw, p, acc, dmin, dmax);

    small[p] = cnt;
    small[hw + p] = pr0;
    small[2 * hw + p] = pr1;
    small[3 * hw + p] = pr2;
    small[4 * hw + p] = pe ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int seg_fold_compact(const float* rgba, const float* length,
                                const float* thr, const float* sk0,
                                const float* sk1, float* color, float* depth,
                                float* small, int c, int k, int h, int w,
                                cudaStream_t stream) {
    const long long hw = (long long)h * w;
    const unsigned blocks = (unsigned)((hw + kThreads - 1) / kThreads);
    seg_fold_kernel<false><<<blocks, kThreads, 0, stream>>>(
        rgba, length, thr, sk0, sk1, nullptr, nullptr, color, depth, small,
        c, k, hw);
    return (int)cudaGetLastError();
}

extern "C" int seg_fold_planes(const float* rgba, const float* t0,
                               const float* t1, const float* thr,
                               float* color, float* depth, float* small,
                               int c, int k, int h, int w,
                               cudaStream_t stream) {
    const long long hw = (long long)h * w;
    const unsigned blocks = (unsigned)((hw + kThreads - 1) / kThreads);
    seg_fold_kernel<true><<<blocks, kThreads, 0, stream>>>(
        rgba, nullptr, thr, nullptr, nullptr, t0, t1, color, depth, small,
        c, k, hw);
    return (int)cudaGetLastError();
}

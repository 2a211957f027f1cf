// K4 — the sort-last composite's resegment: fold one per-pixel
// depth-sorted stream of N*K supersegments into at most K_out output
// supersegments, with the adaptive per-pixel threshold search in front.
//
// Replaces the TPU kernel scenery_insitu_tpu/ops/pallas_composite.py,
// resegment_sorted, kernel body _kernel. Plain version and oracle:
// supersegments.push_count / push / finalize looped over the slots, run
// by ops/cuda_composite.py::resegment_sorted_plain.
//
// What it computes, per pixel: if iters > 0, `iters` counting passes of
// a bisection of the threshold over [0, thr_max] (a pass counts segment
// starts under the rgb-distance break and the depth-gap break; the
// bracket keeps the smallest threshold whose count is <= K_out); then
// one write pass with the resulting threshold (the given one when iters
// is 0) and the finalize of the open segment. Empty output slots hold
// zero colour and +inf depth.
//
// What bounds it on the H100: bytes. A pixel reads its N*K slots of
// 4 colour and 2 depth floats and writes K_out slots of 6 floats; the
// arithmetic is ~20 flops per slot and pass.
//
// Design. One thread per pixel, neighbouring threads on neighbouring x,
// so every slot plane read coalesces across the warp; nothing of the TPU
// kernel's (8, 128) tile or VMEM scratch survives. The count state
// (count, prev rgb, prev empty, prev end) and the open segment (rgba,
// start, end, prev rgb, flags, next slot) live in registers. Every slot
// is written exactly once, straight into the pixel's column of the
// output: a closed segment when it closes, the open one at the end, and
// the untouched tail as empty slots; no K_out-deep array is held. The
// stream is sorted with its empty slots last, and after an empty item
// further empty items change no state of either pass, so a first sweep
// over the alpha plane finds the last non-empty slot and every pass
// stops one slot after it. Any H and W: the ragged tail of the last
// block is masked.
//
// Exactness: one ulp in the rgb distance flips a count sitting on a
// threshold, and with it the bisection and every slot after it. The
// distance is written as the plain version writes it, sqrtf(d0*d0 +
// d1*d1 + d2*d2), and the library is built without FMA contraction, so
// the counts and thresholds equal the plain version's.
//
// Layout: sc f32[NK,4,H,W], sd f32[NK,2,H,W] (start, end), thr f32[H,W]
// (read when iters == 0) -> color f32[K_out,4,H,W], depth
// f32[K_out,2,H,W], and the threshold used, f32[H,W], into thr_out unless
// it is null.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 128;

__device__ __forceinline__ float rgb_distance(float r, float g, float b,
                                              float pr, float pg,
                                              float pb) {
    const float d0 = r - pr, d1 = g - pg, d2 = b - pb;
    return sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
}

// One counting pass (supersegments.push_count with the gap test) over
// slots [0, n): the number of segment starts under threshold `th`.
__device__ int count_starts(const float* __restrict__ sc,
                           const float* __restrict__ sd, int n, long long hw,
                           long long p, float th, float gap_eps) {
    int count = 0;
    float pr = 0.f, pg = 0.f, pb = 0.f;
    bool pe = true;
    float pend = -INFINITY;
    for (int i = 0; i < n; ++i) {
        const float* c = sc + (long long)i * 4 * hw + p;
        const float a = c[3 * hw];
        if (a < kEmptyAlpha) {
            pe = true;
            continue;
        }
        const float r = c[0], g = c[hw], b = c[2 * hw];
        const float t0 = sd[(long long)i * 2 * hw + p];
        const float t1 = sd[(long long)i * 2 * hw + hw + p];
        const bool start = pe || rgb_distance(r, g, b, pr, pg, pb) > th ||
                           (gap_eps >= 0.f && t0 > pend + gap_eps);
        count += start ? 1 : 0;
        pend = t1;
        pr = r;
        pg = g;
        pb = b;
        pe = false;
    }
    return count;
}

__device__ __forceinline__ void write_slot(float* color, float* depth,
                                           int slot, long long hw,
                                           long long p, const float seg[4],
                                           float start, float end) {
    float* oc = color + (long long)slot * 4 * hw + p;
    oc[0] = seg[0];
    oc[hw] = seg[1];
    oc[2 * hw] = seg[2];
    oc[3 * hw] = seg[3];
    float* od = depth + (long long)slot * 2 * hw + p;
    od[0] = start;
    od[hw] = end;
}

__global__ void __launch_bounds__(kThreads)
resegment_kernel(const float* __restrict__ sc, const float* __restrict__ sd,
                 const float* __restrict__ thr, float* __restrict__ color,
                 float* __restrict__ depth, float* __restrict__ thr_out,
                 int nk, int k_out, long long hw,
                 int iters, float gap_eps, float thr_max) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;

    // the passes stop one slot after the last non-empty one
    int n = 0;
    for (int i = 0; i < nk; ++i)
        if (!(sc[((long long)i * 4 + 3) * hw + p] < kEmptyAlpha)) n = i + 1;
    n = min(n + 1, nk);

    float th;
    if (iters > 0) {
        float lo = 0.0f, hi = thr_max;
        for (int it = 0; it < iters; ++it) {
            const float mid = 0.5f * (lo + hi);
            const bool too_many =
                count_starts(sc, sd, n, hw, p, mid, gap_eps) > k_out;
            lo = too_many ? mid : lo;
            hi = too_many ? hi : mid;
        }
        th = hi;
    } else {
        th = thr[p];
    }
    if (thr_out != nullptr) thr_out[p] = th;

    // the write pass: supersegments.push, then finalize
    int k = 0;
    bool open = false, pe = true;
    float seg[4] = {0.f, 0.f, 0.f, 0.f};
    float s0 = 0.f, s1 = 0.f;
    float pr = 0.f, pg = 0.f, pb = 0.f;
    for (int i = 0; i < n; ++i) {
        const float* c = sc + (long long)i * 4 * hw + p;
        const float r = c[0], g = c[hw], b = c[2 * hw], a = c[3 * hw];
        const float t0 = sd[(long long)i * 2 * hw + p];
        const float t1 = sd[(long long)i * 2 * hw + hw + p];
        const bool emp = a < kEmptyAlpha;
        bool brk = emp ? !pe
                       : (!pe && rgb_distance(r, g, b, pr, pg, pb) > th);
        if (gap_eps >= 0.f) brk = brk || (!emp && open && t0 > s1 + gap_eps);
        // merge overflow: the last slot never closes mid-stream
        if (open && brk && k < k_out - 1) {
            write_slot(color, depth, k, hw, p, seg, s0, s1);
            ++k;
            open = false;
        }
        if (!emp) {
            if (open) {
                const float w = 1.0f - seg[3];
                seg[0] = seg[0] + w * r;
                seg[1] = seg[1] + w * g;
                seg[2] = seg[2] + w * b;
                seg[3] = seg[3] + w * a;
            } else {
                seg[0] = r;
                seg[1] = g;
                seg[2] = b;
                seg[3] = a;
                s0 = t0;
                open = true;
            }
            s1 = t1;
            pr = r;
            pg = g;
            pb = b;
        }
        pe = emp;
    }
    if (open) {
        write_slot(color, depth, min(k, k_out - 1), hw, p, seg, s0, s1);
        ++k;
    }
    const float empty[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = k; s < k_out; ++s)
        write_slot(color, depth, s, hw, p, empty, INFINITY, INFINITY);
}

}  // namespace

extern "C" int resegment_sorted(const float* sc, const float* sd,
                                const float* thr, float* color, float* depth,
                                float* thr_out, int nk, int k_out, int h,
                                int w, int iters,
                                float gap_eps, float thr_max,
                                cudaStream_t stream) {
    const long long hw = (long long)h * w;
    const unsigned blocks = (unsigned)((hw + kThreads - 1) / kThreads);
    resegment_kernel<<<blocks, kThreads, 0, stream>>>(
        sc, sd, thr, color, depth, thr_out, nk, k_out, hw, iters, gap_eps,
        thr_max);
    return (int)cudaGetLastError();
}

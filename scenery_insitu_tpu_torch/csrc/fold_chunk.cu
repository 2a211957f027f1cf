// B7 — the sequential supersegment machine (supersegments.push) over one
// chunk of shaded slices, with the depth planes read from memory and an
// optional count of the true segment starts at the same threshold (the
// temporal controller's feedback, supersegments.push_count).
//
// Replaces the TPU kernel scenery_insitu_tpu/ops/pallas_march.py,
// fold_chunk, kernel body _fold_kernel (phase 1, the O(1) machine over
// the slices; phase 2, the per-slot extraction of the close events).
// Plain version and oracle: C sequential supersegments.push (and
// push_count) calls on the unpacked state, run by
// ops/cuda_march.py::fold_chunk_plain.
//
// What bounds it on the H100: bytes. Per chunk a pixel reads its C x 4
// rgba values and C x 2 depths, its threshold, reads and writes the
// 12-float machine state (and the count), and writes the colour (4) and
// depth (2) rows of the slots that close in this chunk; the work is ~30
// flops per slice.
//
// Design. One thread per pixel, neighbouring threads on neighbouring x so
// every [., H, W] plane access coalesces. The 12-float machine (open
// segment rgba, start, end, prev rgb, open, prev empty, next slot k)
// lives in registers over the C slices and is written back once per
// chunk. The TPU kernel recorded every slice's potential close event and
// merged them into the K slot rows in a second phase (a slot closes at
// most once per march, so the merge adds into zero colour rows and picks
// the depth with where(hit)); here a close writes slot k's colour and
// depth rows directly when it happens, which is that merge with no
// record buffer. Predicates, merge-overflow (close only while k < K-1)
// and the accumulation seg + (1 - seg.a) * rgba are supersegments.push's;
// the rgb distance is written as sqrt(d0*d0 + d1*d1 + d2*d2) and the
// library is built without FMA contraction, so closes and counts equal
// the plain version's exactly.
//
// State layout (updated in place): color f32[K,4,H,W], depth f32[K,2,H,W]
// (start, end; +inf until written), small f32[12,H,W] = seg rgba (0-3),
// seg start (4), seg end (5), prev rgb (6-8), open (9), prev empty (10),
// k (11), flags and k f32-encoded; count i32[H,W] or NULL.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fold_chunk_kernel(const float* __restrict__ rgba,
                  const float* __restrict__ t0,
                  const float* __restrict__ t1,
                  const float* __restrict__ thr,
                  float* __restrict__ color, float* __restrict__ depth,
                  float* __restrict__ small, int* __restrict__ count,
                  int c, int k, long long hw, float gap_eps) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;

    float sr = small[p], sg = small[hw + p], sb = small[2 * hw + p],
          sa = small[3 * hw + p];
    float s_start = small[4 * hw + p], s_end = small[5 * hw + p];
    float pr0 = small[6 * hw + p], pr1 = small[7 * hw + p],
          pr2 = small[8 * hw + p];
    bool open = small[9 * hw + p] > 0.5f;
    bool pe = small[10 * hw + p] > 0.5f;
    float kc = small[11 * hw + p];
    const float th = thr[p];
    const float klast = (float)(k - 1);
    int n_starts = 0;

    for (int s = 0; s < c; ++s) {
        const float* src = rgba + (long long)s * 4 * hw + p;
        const float r = src[0], g = src[hw], b = src[2 * hw],
                    a = src[3 * hw];
        const float ta = t0[(long long)s * hw + p];
        const float tb = t1[(long long)s * hw + p];
        const bool emp = a < kEmptyAlpha;
        const float d0 = r - pr0, d1 = g - pr1, d2 = b - pr2;
        const float diff = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        bool want_break = (!emp && !pe && diff > th) || (emp && !pe);
        if (gap_eps >= 0.0f)
            want_break = want_break || (!emp && open && ta > s_end + gap_eps);
        const bool do_close = open && want_break && kc < klast;
        if (!emp && (pe || diff > th)) ++n_starts;
        if (do_close) {
            const long long slot = (long long)kc;
            float* oc = color + slot * 4 * hw + p;
            oc[0] = sr;
            oc[hw] = sg;
            oc[2 * hw] = sb;
            oc[3 * hw] = sa;
            float* od = depth + slot * 2 * hw + p;
            od[0] = s_start;
            od[hw] = s_end;
            kc = kc + 1.0f;
            open = false;
        }
        if (!emp) {
            if (!open) {                       // start a new segment
                sr = r;
                sg = g;
                sb = b;
                sa = a;
                s_start = ta;
                open = true;
            } else {                           // accumulate under
                const float w = 1.0f - sa;
                sr = sr + w * r;
                sg = sg + w * g;
                sb = sb + w * b;
                sa = sa + w * a;
            }
            s_end = tb;
            pr0 = r;
            pr1 = g;
            pr2 = b;
        }
        pe = emp;
    }

    small[p] = sr;
    small[hw + p] = sg;
    small[2 * hw + p] = sb;
    small[3 * hw + p] = sa;
    small[4 * hw + p] = s_start;
    small[5 * hw + p] = s_end;
    small[6 * hw + p] = pr0;
    small[7 * hw + p] = pr1;
    small[8 * hw + p] = pr2;
    small[9 * hw + p] = open ? 1.0f : 0.0f;
    small[10 * hw + p] = pe ? 1.0f : 0.0f;
    small[11 * hw + p] = kc;
    if (count != nullptr) count[p] += n_starts;
}

}  // namespace

extern "C" int fold_chunk(const float* rgba, const float* t0,
                          const float* t1, const float* thr, float* color,
                          float* depth, float* small, int* count, int c,
                          int k, int h, int w, float gap_eps,
                          cudaStream_t stream) {
    const long long hw = (long long)h * w;
    const unsigned blocks = (unsigned)((hw + kThreads - 1) / kThreads);
    fold_chunk_kernel<<<blocks, kThreads, 0, stream>>>(
        rgba, t0, t1, thr, color, depth, small, count, c, k, hw, gap_eps);
    return (int)cudaGetLastError();
}

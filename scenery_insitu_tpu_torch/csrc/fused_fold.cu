// B5 and B6 — shade and fold in one kernel: the transfer function, the
// opacity correction and the premultiply applied to the resampled value
// planes, then kernel K1's segmented write fold, without the shaded rgba
// stream ever reaching device memory.
//
// Replaces the TPU kernels scenery_insitu_tpu/ops/pallas_seg.py,
// fused_fold_chunk (B5, kernel body _fused_kernel: one chunk a launch)
// and fused_stream_fold (B6, kernel body _fused_stream_kernel: the whole
// march in one launch). Plain versions and oracles:
// ops/cuda_fused.py::fused_fold_chunk_plain (the knot formula of
// _fused_kernel, then seg_fold.seg_fold_chunk on t = sk * length) and
// fused_stream_fold_plain (that, chunk after chunk).
//
// What bounds it on the H100: bytes. A pixel reads one value a slice (the
// shaded path reads four rgba values), its length, ratio and threshold,
// reads and writes the 5-float small state, and reads and writes the
// colour (4) and depth (2) rows of the slots it touches; the arithmetic
// is the knot sums (~2 flops a non-zero knot and channel), one powf and
// K1's ~26 flops a slice.
//
// Design. One thread per pixel, neighbouring threads on neighbouring x.
// The knots reach the kernel as a small device buffer (tf_knots in
// ops/cuda_fused.py: alpha x[16], alpha slope[16], alpha base, colour
// x[16], colour slope[16][3], colour base[3]), staged once per block in
// shared memory; zero-slope knots (the padding) are skipped, which adds
// nothing the plain version's +0 terms would change. The TPU kernel baked
// the knots into its binary; a buffer keeps one build for every transfer
// function. Each sample is shaded exactly as _fused_kernel shades it: x =
// clamp(v, 0, 1), a = base + sum m_i * max(x - x_i, 0) in knot order (and
// likewise each colour channel), a = 0 where v < -0.5 (a dead sample),
// a = 1 - powf(clamp(1 - a, 1e-7, 1), ratio), rgb premultiplied by a.
// The fold is K1's: per chunk the running transmittance restarts at 1 and
// each touched slot's contribution is summed in registers and merged once
// with co = oc + (1 - oc.a) * contrib (start = min, end = max).
//
// One body serves both entries. B5 is one chunk of C slices. B6 walks S
// slices in chunks of `chunk` and keeps the chunk boundaries, so it
// equals B5 called chunk after chunk bit for bit; what it saves is
// memory traffic: the small state is read and written once a pixel, and
// the slot row being merged stays in registers across chunks. A pixel's
// slot index never decreases over the march (the start count only
// grows), so a row that is left is never merged again and each touched
// row is read and written once per launch.
//
// State layout (updated in place): color f32[K,4,H,W], depth f32[K,2,H,W]
// (start +inf, end -inf until written), small f32[5,H,W] = count
// (f32-encoded), prev rgb, prev empty (> 0.5).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 256;
constexpr int kKnots = 16;             // transfer.MAX_KNOTS
// offsets of the knot buffer
constexpr int kAx = 0, kAm = 16, kAb = 32, kCx = 33, kCm = 49, kCb = 97;
constexpr int kTf = 100;

struct Row {                            // one slot row held in registers
    int slot = -1;
    float c[4];
    float d0, d1;
};

__device__ __forceinline__ void row_store(float* color, float* depth,
                                          long long hw, long long p,
                                          const Row& row) {
    float* oc = color + (long long)row.slot * 4 * hw + p;
    oc[0] = row.c[0];
    oc[hw] = row.c[1];
    oc[2 * hw] = row.c[2];
    oc[3 * hw] = row.c[3];
    float* od = depth + (long long)row.slot * 2 * hw + p;
    od[0] = row.d0;
    od[hw] = row.d1;
}

// merge one chunk's contribution to `slot` into the register row, after
// storing the row it holds and loading `slot`'s when they differ
__device__ __forceinline__ void merge(float* color, float* depth,
                                      long long hw, long long p, Row& row,
                                      int slot, const float acc[4],
                                      float dmin, float dmax) {
    if (slot != row.slot) {
        if (row.slot >= 0) row_store(color, depth, hw, p, row);
        const float* oc = color + (long long)slot * 4 * hw + p;
        row.c[0] = oc[0];
        row.c[1] = oc[hw];
        row.c[2] = oc[2 * hw];
        row.c[3] = oc[3 * hw];
        const float* od = depth + (long long)slot * 2 * hw + p;
        row.d0 = od[0];
        row.d1 = od[hw];
        row.slot = slot;
    }
    const float w = 1.0f - row.c[3];
    row.c[0] = row.c[0] + w * acc[0];
    row.c[1] = row.c[1] + w * acc[1];
    row.c[2] = row.c[2] + w * acc[2];
    row.c[3] = row.c[3] + w * acc[3];
    row.d0 = fminf(row.d0, dmin);
    row.d1 = fmaxf(row.d1, dmax);
}

// the transfer function, opacity correction and premultiply of one sample
__device__ __forceinline__ void shade(const float* tf, float v, float ratio,
                                      float out[4]) {
    const bool outside = v < -0.5f;
    const float x = fminf(fmaxf(v, 0.0f), 1.0f);
    float a = tf[kAb];
    for (int i = 0; i < kKnots; ++i) {
        const float m = tf[kAm + i];
        if (m != 0.0f) a = a + m * fmaxf(x - tf[kAx + i], 0.0f);
    }
    float ch[3];
    for (int c = 0; c < 3; ++c) {
        float acc = tf[kCb + c];
        for (int i = 0; i < kKnots; ++i) {
            const float m = tf[kCm + 3 * i + c];
            if (m != 0.0f) acc = acc + m * fmaxf(x - tf[kCx + i], 0.0f);
        }
        ch[c] = acc;
    }
    if (outside) a = 0.0f;
    a = 1.0f - powf(fminf(fmaxf(1.0f - a, 1e-7f), 1.0f), ratio);
    out[0] = ch[0] * a;
    out[1] = ch[1] * a;
    out[2] = ch[2] * a;
    out[3] = a;
}

__global__ void __launch_bounds__(kThreads)
fused_fold_kernel(const float* __restrict__ val,
                  const float* __restrict__ length,
                  const float* __restrict__ ratio,
                  const float* __restrict__ thr,
                  const float* __restrict__ sk0,
                  const float* __restrict__ sk1,
                  const float* __restrict__ knots,
                  float* __restrict__ color, float* __restrict__ depth,
                  float* __restrict__ small, int s_total, int chunk, int k,
                  long long hw) {
    __shared__ float tf[kTf];
    for (int i = threadIdx.x; i < kTf; i += blockDim.x) tf[i] = knots[i];
    __syncthreads();
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;

    float cnt = small[p];
    float pr0 = small[hw + p], pr1 = small[2 * hw + p],
          pr2 = small[3 * hw + p];
    bool pe = small[4 * hw + p] > 0.5f;
    const float th = thr[p];
    const float ln = length[p];
    const float rt = ratio[p];
    const float kf = (float)(k - 1);
    Row row;

    for (int c0 = 0; c0 < s_total; c0 += chunk) {
        float t_run = 1.0f;
        int cur = -1;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        float dmin = INFINITY, dmax = -INFINITY;
        for (int s = c0; s < c0 + chunk; ++s) {
            float sample[4];
            shade(tf, val[(long long)s * hw + p], rt, sample);
            const float r = sample[0], g = sample[1], b = sample[2],
                        a = sample[3];
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
                    if (cur >= 0)
                        merge(color, depth, hw, p, row, cur, acc, dmin, dmax);
                    cur = slot;
                    acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
                    dmin = INFINITY;
                    dmax = -INFINITY;
                }
                acc[0] += r * t_here;
                acc[1] += g * t_here;
                acc[2] += b * t_here;
                acc[3] += a * t_here;
                dmin = fminf(dmin, sk0[s] * ln);
                dmax = fmaxf(dmax, sk1[s] * ln);
                pr0 = r;
                pr1 = g;
                pr2 = b;
            }
            pe = emp;
        }
        if (cur >= 0) merge(color, depth, hw, p, row, cur, acc, dmin, dmax);
    }
    if (row.slot >= 0) row_store(color, depth, hw, p, row);

    small[p] = cnt;
    small[hw + p] = pr0;
    small[2 * hw + p] = pr1;
    small[3 * hw + p] = pr2;
    small[4 * hw + p] = pe ? 1.0f : 0.0f;
}

int launch(const float* val, const float* length, const float* ratio,
           const float* thr, const float* sk0, const float* sk1,
           const float* knots, float* color, float* depth, float* small,
           int s_total, int chunk, int k, int h, int w,
           cudaStream_t stream) {
    const long long hw = (long long)h * w;
    const unsigned blocks = (unsigned)((hw + kThreads - 1) / kThreads);
    fused_fold_kernel<<<blocks, kThreads, 0, stream>>>(
        val, length, ratio, thr, sk0, sk1, knots, color, depth, small,
        s_total, chunk, k, hw);
    return (int)cudaGetLastError();
}

}  // namespace

// B5: one chunk val f32[C,H,W], sk0/sk1 f32[C]
extern "C" int fused_fold_chunk(const float* val, const float* length,
                                const float* ratio, const float* thr,
                                const float* sk0, const float* sk1,
                                const float* knots, float* color,
                                float* depth, float* small, int c, int k,
                                int h, int w, cudaStream_t stream) {
    return launch(val, length, ratio, thr, sk0, sk1, knots, color, depth,
                  small, c, c, k, h, w, stream);
}

// B6: the whole march val f32[S,H,W], sk0/sk1 f32[S], S a multiple of
// chunk
extern "C" int fused_stream_fold(const float* val, const float* length,
                                 const float* ratio, const float* thr,
                                 const float* sk0, const float* sk1,
                                 const float* knots, float* color,
                                 float* depth, float* small, int s_total,
                                 int chunk, int k, int h, int w,
                                 cudaStream_t stream) {
    return launch(val, length, ratio, thr, sk0, sk1, knots, color, depth,
                  small, s_total, chunk, k, h, w, stream);
}

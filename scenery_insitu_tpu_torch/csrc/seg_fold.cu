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
// rgba values, its length (or its C x 2 depths) and threshold, reads and
// writes the 5-float small state, and reads and writes the colour (4) and
// depth (2) rows of the slots the chunk touched; the arithmetic is ~26
// flops a slice. The rgba stream is most of it on the frame: of a
// flagship frame's pixel-chunks 91 % touch no slot and the rest 1.6 on
// average. The state rows are the one scattered part: neighbouring
// pixels touch the same row only where their start counts agree, so on
// a chunk of random colours (6.6 rows a pixel) whole sectors move for
// single floats.
//
// Design. Pixels are independent: one thread owns one pixel, and
// neighbouring threads neighbouring x, so every plane load and store
// coalesces. What held the first design (a runtime slice loop, one
// slice's loads in flight a thread, a read of the slot row inside the
// loop at every slot change, the stream evicting the state from L2) was
// latency, not bytes, so:
//
// - The slice count is a template parameter for a live chunk's count,
//   C = 16, and the walk is unrolled; any other C, the skipped chunks'
//   one sample (C = 1) included, takes the generic build of the same
//   kernel with a runtime bound. A C = 1 build of its own (48 registers
//   against the generic build's 80) was 5.6 % slower at C = 1 and within
//   1 % on the frame's chunks, so there is none.
// - A thread issues the loads of 4 slices (16 values, 24 for the planes
//   form) before it walks them; C = 16 walks four such groups (72
//   registers, 7 blocks an SM). The sizes were timed on the flagship
//   frame's own chunks, the main path's traffic, where the walk is short
//   and resident threads are what keeps bytes in flight: 8 at a time
//   (96 registers, 5 blocks) was 7 % slower there, and 16 at a time
//   (122, 4) 8 % slower than 8. On a chunk of random colours that
//   touches 6.6 rows a pixel (the frame's touch 0.14), 8 at a time is
//   26 % faster: the walk stalls on its row reads between groups. Two or four neighbouring pixels a
//   thread with 8- or 16-byte loads took 148 or 250 registers and were
//   26 % and 60 % slower on the frame's chunks.
//
// The trials of the next four points were timed one change at a time
// with 8-slice groups.
//
// - The stream is loaded evict-first (ld.global.cs): it is read once,
//   and the small state, threshold and length (28 bytes a pixel, read
//   by every launch of a march) then stay in the 50 MB L2 across
//   launches (plain loads: 18 % slower on the frame's chunks).
// - An empty slice changes only prev-empty, and takes a branch that does
//   nothing else (without it: 10 % slower on the frame's chunks).
// - Slot rows are off the walk's critical path. Inside one chunk the
//   slot of the non-empty slices, min(count - 1, K - 1), never
//   decreases, and the first one is a = min(cnt - 1, K - 1) (no start)
//   or b = min(cnt, K - 1) (a start), both known from small before the
//   walk. Records of slot a and slot b accumulate into two register sums
//   that touch no memory during the walk; their rows are read together
//   after it, once, and only for a pixel that touched them, so an empty
//   chunk moves no state rows (reading them at entry instead was 17 %
//   slower on the frame's chunks and 19 % at C = 1, 2 % faster on the
//   many-row chunk). Only a pixel whose count passes b
//   opens a further row: its read is issued when the slot opens and
//   consumed when it closes, with the walk's arithmetic in between.
// - Each slot's sum is its records in slice order in registers and is
//   merged with co = oc + (1 - oc.a) * sum (start = min, end = max), as
//   the TPU kernel's phase B merges its masked sum: within 1e-5 of the
//   plain version with the start counts exact. Untouched rows are left as
//   they are, which is what the K-loop's merge of a zero contribution
//   computes, and no [C, ...] record buffer exists.
// - One 128-pixel tile a block. On the frame's chunks, persistent
//   blocks walking tiles (one wave of resident blocks) were 14 % slower
//   and a cp.async ring in shared memory (each thread copying its pixel's
//   next tile while it walks the current one) 50 % slower.
//
// State layout (updated in place): color f32[K,4,H,W], depth f32[K,2,H,W]
// (start, end), small f32[5,H,W] = count (f32-encoded), prev rgb, prev
// empty (> 0.5).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 128;          // a block's pixel tile
constexpr int kGroup = 4;              // slices a thread holds at once

// one slot's part of the chunk: its records' premultiplied sum in slice
// order and their depth extent
struct Acc {
    float r, g, b, a, lo, hi;

    __device__ __forceinline__ void zero() {
        r = g = b = a = 0.0f;
        lo = INFINITY;
        hi = -INFINITY;
    }
    __device__ __forceinline__ void add(float x0, float x1, float x2,
                                        float x3, float d0, float d1) {
        r += x0;
        g += x1;
        b += x2;
        a += x3;
        lo = fminf(lo, d0);
        hi = fmaxf(hi, d1);
    }
};

// a slot row of the state: colour rgba, depth (start, end)
struct Row {
    float r, g, b, a, lo, hi;

    __device__ __forceinline__ void load(const float* color,
                                         const float* depth, int slot,
                                         long long hw, long long p) {
        const float* c = color + (long long)slot * 4 * hw + p;
        const float* d = depth + (long long)slot * 2 * hw + p;
        r = c[0];
        g = c[hw];
        b = c[2 * hw];
        a = c[3 * hw];
        lo = d[0];
        hi = d[hw];
    }
    // the under-merge of a slot's sum into this row, stored
    __device__ __forceinline__ void merge_store(float* color, float* depth,
                                                int slot, long long hw,
                                                long long p,
                                                const Acc& x) const {
        float* c = color + (long long)slot * 4 * hw + p;
        float* d = depth + (long long)slot * 2 * hw + p;
        const float w = 1.0f - a;
        c[0] = r + w * x.r;
        c[hw] = g + w * x.g;
        c[2 * hw] = b + w * x.b;
        c[3 * hw] = a + w * x.a;
        d[0] = fminf(lo, x.lo);
        d[hw] = fmaxf(hi, x.hi);
    }
};

// one pixel's walk over the chunk: the TPU kernel's phase A carries
// (running count, running transmittance, prev rgb, prev empty), the sums
// of slots a and b, and the open row beyond b
struct Walk {
    float cnt, pr0, pr1, pr2, t_run, th, kf;
    bool pe, use_a, use_b;
    int sa, sb, cur;
    Acc acc_a, acc_b, acc_c;
    Row row_c;

    __device__ __forceinline__ void begin(const float* small,
                                          const float* thr, long long hw,
                                          long long p, int k) {
        cnt = small[p];
        pr0 = small[hw + p];
        pr1 = small[2 * hw + p];
        pr2 = small[3 * hw + p];
        pe = small[4 * hw + p] > 0.5f;
        th = thr[p];
        kf = (float)(k - 1);
        t_run = 1.0f;
        sa = (int)fminf(fmaxf(cnt - 1.0f, 0.0f), kf);
        sb = (int)fminf(fmaxf(cnt, 0.0f), kf);
        cur = -1;
        use_a = use_b = false;
        acc_a.zero();
        acc_b.zero();
        acc_c.zero();
    }

    __device__ __forceinline__ void step(float* color, float* depth,
                                         long long hw, long long p, float r,
                                         float g, float b, float a, float d0,
                                         float d1) {
        const bool emp = a < kEmptyAlpha;
        if (emp) {      // an empty slice changes nothing but prev empty
            pe = true;
            return;
        }
        const float q0 = r - pr0, q1 = g - pr1, q2 = b - pr2;
        const float diff = sqrtf(q0 * q0 + q1 * q1 + q2 * q2);
        const bool start = pe || diff > th;
        cnt = cnt + (start ? 1.0f : 0.0f);
        const float sid = cnt - 1.0f;
        const bool reset = start && (sid <= kf);
        const float t_here = reset ? 1.0f : t_run;
        t_run = t_here * (1.0f - a);
        const int slot = (int)fminf(fmaxf(sid, 0.0f), kf);
        const float x0 = r * t_here, x1 = g * t_here, x2 = b * t_here,
                    x3 = a * t_here;
        if (slot == sa) {
            acc_a.add(x0, x1, x2, x3, d0, d1);
            use_a = true;
        } else if (slot == sb) {
            acc_b.add(x0, x1, x2, x3, d0, d1);
            use_b = true;
        } else {
            if (slot != cur) {
                if (cur >= 0)
                    row_c.merge_store(color, depth, cur, hw, p, acc_c);
                cur = slot;
                row_c.load(color, depth, cur, hw, p);
                acc_c.zero();
            }
            acc_c.add(x0, x1, x2, x3, d0, d1);
        }
        pr0 = r;
        pr1 = g;
        pr2 = b;
        pe = false;
    }

    __device__ __forceinline__ void finish(float* color, float* depth,
                                           float* small, long long hw,
                                           long long p) {
        // rows a and b: both reads issued before either merge
        Row ra, rb;
        if (use_a) ra.load(color, depth, sa, hw, p);
        if (use_b) rb.load(color, depth, sb, hw, p);
        if (cur >= 0) row_c.merge_store(color, depth, cur, hw, p, acc_c);
        if (use_a) ra.merge_store(color, depth, sa, hw, p, acc_a);
        if (use_b) rb.merge_store(color, depth, sb, hw, p, acc_b);
        small[p] = cnt;
        small[hw + p] = pr0;
        small[2 * hw + p] = pr1;
        small[3 * hw + p] = pr2;
        small[4 * hw + p] = pe ? 1.0f : 0.0f;
    }
};

// C > 0: exactly C slices, the walk unrolled; C == 0: c slices, a
// runtime bound. Either loads kGroup slices, then walks them. PLANES:
// t0/t1 are f32[C,H,W] planes (length, sk0 and sk1 unused); otherwise
// t = sk0[s] * length and sk1[s] * length.
template <int C, bool PLANES>
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
    const int nc = C > 0 ? C : c;
    // the fixed-count builds keep the ratios in shared memory, the
    // generic one loads them with each group
    __shared__ float s_sk[2][C > 0 && !PLANES ? C : 1];
    if (C > 0 && !PLANES) {
        for (int i = threadIdx.x; i < C; i += kThreads) {
            s_sk[0][i] = sk0[i];
            s_sk[1][i] = sk1[i];
        }
        __syncthreads();
    }
    const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (p < hw) {
        Walk wk;
        wk.begin(small, thr, hw, p, k);
        const float ln = PLANES ? 0.0f : length[p];
        for (int s0 = 0; s0 < nc; s0 += kGroup) {
            float v[kGroup][4], e0[kGroup], e1[kGroup];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                const int s = s0 + j;
                if (C == 0 && s >= nc) break;
                const float* src = rgba + (long long)s * 4 * hw + p;
                v[j][0] = __ldcs(src);
                v[j][1] = __ldcs(src + hw);
                v[j][2] = __ldcs(src + 2 * hw);
                v[j][3] = __ldcs(src + 3 * hw);
                if (PLANES) {
                    e0[j] = __ldcs(t0 + (long long)s * hw + p);
                    e1[j] = __ldcs(t1 + (long long)s * hw + p);
                } else if (C == 0) {
                    e0[j] = sk0[s];
                    e1[j] = sk1[s];
                }
            }
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                const int s = s0 + j;
                if (C == 0 && s >= nc) break;
                float d0, d1;
                if (PLANES) {
                    d0 = e0[j];
                    d1 = e1[j];
                } else if (C == 0) {
                    d0 = e0[j] * ln;
                    d1 = e1[j] * ln;
                } else {
                    d0 = s_sk[0][s] * ln;
                    d1 = s_sk[1][s] * ln;
                }
                wk.step(color, depth, hw, p, v[j][0], v[j][1], v[j][2],
                        v[j][3], d0, d1);
            }
        }
        wk.finish(color, depth, small, hw, p);
    }
}

template <int C, bool PLANES>
const void* kernel_fn() {
    return (const void*)seg_fold_kernel<C, PLANES>;
}

const void* pick(int c, bool planes) {
    if (c == 16) return planes ? kernel_fn<16, true>() : kernel_fn<16, false>();
    return planes ? kernel_fn<0, true>() : kernel_fn<0, false>();
}

int launch(bool planes, const float* rgba, const float* length,
           const float* thr, const float* sk0, const float* sk1,
           const float* t0, const float* t1, float* color, float* depth,
           float* small, int c, int k, int h, int w, cudaStream_t stream) {
    if (c < 1 || k < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
    long long hw = (long long)h * w;
    const dim3 grid((unsigned)((hw + kThreads - 1) / kThreads));
    void* args[] = {(void*)&rgba, (void*)&length, (void*)&thr,
                    (void*)&sk0,  (void*)&sk1,    (void*)&t0,
                    (void*)&t1,   (void*)&color,  (void*)&depth,
                    (void*)&small, (void*)&c,     (void*)&k,
                    (void*)&hw};
    const cudaError_t e = cudaLaunchKernel(pick(c, planes), grid,
                                           dim3(kThreads), args, 0, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seg_fold_compact(const float* rgba, const float* length,
                                const float* thr, const float* sk0,
                                const float* sk1, float* color, float* depth,
                                float* small, int c, int k, int h, int w,
                                cudaStream_t stream) {
    return launch(false, rgba, length, thr, sk0, sk1, nullptr, nullptr,
                  color, depth, small, c, k, h, w, stream);
}

extern "C" int seg_fold_planes(const float* rgba, const float* t0,
                               const float* t1, const float* thr,
                               float* color, float* depth, float* small,
                               int c, int k, int h, int w,
                               cudaStream_t stream) {
    return launch(true, rgba, nullptr, thr, nullptr, nullptr, t0, t1, color,
                  depth, small, c, k, h, w, stream);
}

// the build that C = c takes (16, 1, or the generic one), compact
// (planes 0) or planes form (planes 1): out int[6] = registers a thread,
// local-memory bytes a thread, shared bytes a block, resident blocks an
// SM, threads a block, and the slices it holds in registers at once
extern "C" int seg_fold_attributes(int c, int planes, int* out) {
    if (c < 1) return (int)cudaErrorInvalidValue;
    const void* fn = pick(c, planes != 0);
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
    out[5] = c < kGroup ? c : kGroup;
    return 0;
}

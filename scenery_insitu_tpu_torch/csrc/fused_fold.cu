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
// What bounds it on the H100: bytes, once the shading is paid only where
// its result is read. A pixel reads one value a slice and writes its
// prev-empty; where it has a live sample it reads its ratio, and where it
// has a non-empty one its length and threshold, reads and writes the
// rest of the small state, and reads and writes the colour (4) and depth
// (2) rows of the slots it touches. The kernel loads a pixel's state at
// entry whatever its samples hold (see the trials below), so a chunk of
// dead planes costs it 8 floats a pixel more than it needs. The
// arithmetic is data-dependent: of a flagship march's samples 60 % are
// dead (v < -0.5: outside the volume, or a skipped chunk's -1 planes),
// 32 % live but empty (corrected alpha below EMPTY_ALPHA) and 8 %
// non-empty, and an empty sample's colour is never read. The first
// design shaded every sample in full (16 alpha and 48 colour knots, each
// a shared load and a branch, then powf) before it tested either, held
// the unrolled knots in 160 registers (one 256-thread block an SM) and
// took 6.1 ms for the march (B6) and 6.3 ms for a frame's 32 launches
// (B5) on an H100 80GB HBM3 at 700 W, 21-26x what they need from HBM.
//
// Design.
//
// - Test before shading. A dead sample is tested first: its alpha is 0
//   whatever the knots give, and 1 - powf(1, ratio) == 0 exactly, so it
//   only marks the previous sample empty. A live sample's alpha sum comes
//   next; where 1 - a rounds to 1 the corrected alpha is 0 exactly
//   (clamp to 1, powf(1, y) == 1), so powf runs only where alpha can be
//   non-zero. The colour knots and the premultiply run only for a sample
//   whose corrected alpha reaches EMPTY_ALPHA. All three are exact: the
//   skipped work cannot change a value the fold reads.
// - Cheap knots. A block prologue compacts the f32[100] knot buffer in
//   shared memory, in knot order: the (x, slope) pairs of the non-zero
//   alpha slopes, and the (x, r, g, b slope) quads of the knots with any
//   non-zero colour slope (a zero slope among the three adds +-0, which
//   changes no sum). Each list is walked with a runtime count, one
//   broadcast shared load a knot, and stops at the first knot whose
//   x_i >= x where the list ascends (the prologue checks the order): the
//   remaining terms are m * max(x - x_i, 0) = +-0. The sums keep the
//   plain version's order and operations (the library is built without
//   FMA contraction), so alpha, and with it every start, is unchanged.
// - The walk is one rolled loop over a stage of up to 16 slices in
//   shared memory: the shading and the fold are data-dependent branches,
//   and an unrolled walk of 8 slices in registers (94 registers, 5
//   blocks an SM) was 19 % slower on the march and 9 % on a frame's 32
//   launches. Each stage reaches shared memory by cp.async (4 bytes a
//   pixel and slice, evict-first in L2, so the small state, threshold,
//   length and ratio stay there across a march's launches), and the next
//   stage's copy is issued before a stage is walked. The first stage's
//   copy and the state's loads are issued before the knot prologue's
//   barrier. One thread a pixel, 128-pixel tiles, neighbouring threads on
//   neighbouring x; the slice count is a template parameter for the
//   march's two counts, C = 16 (a live chunk, B6's chunk) and C = 1 (the
//   per-chunk feed's skipped chunk, whose one value is loaded evict-first
//   into a register), and any other count takes the generic build of the
//   same kernel with a runtime bound. The two fixed builds were timed in
//   turns against the generic build serving every count on an H100 80GB
//   HBM3 at 700 W: the generic one was 5.1 % slower on the fullest
//   chunk, 7.6 % on a dead C = 16 chunk, 17.5 % on a dead C = 1 chunk
//   (56 registers and 9 blocks an SM for the C = 1 build, 72 and 7 for
//   the others), 4.5 % on a frame's 32 launches and 7.1 % on the march.
// - Registers set the resident threads, and the resident threads the
//   time: 72 registers, 7 blocks an SM. Trials in turns on an H100 80GB
//   HBM3 at 700 W (march / frame): capping at 64 registers (8 blocks)
//   spills and was 7 % / 1 % slower; reading the state only at a
//   pixel's first non-empty sample (80 registers, 6 blocks) 13 % / 4 %
//   slower, though 28 % faster on a dead one-plane chunk; a third
//   register sum for the slots beyond b, with the state loaded after
//   the prologue (91 registers, 5 blocks), 17 % / 5 %; with it, stages
//   of 8 slices were 3 % slower / 1.5 % faster.
// - The fold is K1's (csrc/seg_fold.cu): per chunk the running
//   transmittance restarts at 1; the records of slot a = min(cnt - 1,
//   K - 1) and of the slot open after it (b = min(cnt, K - 1) until a
//   later start) sum in registers, and their rows are read once, after
//   the walk, only where touched; a slot closed by a later start within
//   the chunk is read and merged when it closes. Each touched slot is
//   merged once a chunk with co = oc + (1 - oc.a) * contrib (start =
//   min, end = max). The small state is written back only where a chunk
//   folded a non-empty sample (prev empty always).
// - One body serves both entries. B5 is one chunk of C slices a launch.
//   B6 walks S slices in chunks of `chunk`, carrying the count, prev rgb
//   and prev empty in registers and merging each chunk's rows in memory,
//   so it equals B5 called chunk after chunk bit for bit; it saves the
//   launches and the per-chunk small-state traffic. Its 3,200 blocks at
//   640 x 640 are dealt to the SMs by the hardware as earlier blocks
//   finish, so the data-dependent cost of a tile (a dead tile is a
//   stream of copies) balances itself: persistent blocks, one wave
//   walking the tiles in turn, were 34 % slower on the march.
//
// State layout (updated in place): color f32[K,4,H,W], depth f32[K,2,H,W]
// (start +inf, end -inf until written), small f32[5,H,W] = count
// (f32-encoded), prev rgb, prev empty (> 0.5).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 128;          // a block's pixel tile
constexpr int kStage = 16;             // slices a stage holds
constexpr int kKnots = 16;             // transfer.MAX_KNOTS
// offsets of the knot buffer (ops/cuda_fused.py::tf_knots)
constexpr int kAx = 0, kAm = 16, kAb = 32, kCx = 33, kCm = 49, kCb = 97;

// the transfer function, compacted by the block prologue
struct Tf {
    float2 a[kKnots];   // (x, slope) of the non-zero alpha slopes
    float4 c[kKnots];   // (x, r, g, b slopes) of the knots with any
    float ab, cb[3];    // alpha and colour at x = 0
    int na, nc;         // kept knots
    int a_asc, c_asc;   // 1 where the kept x ascend: stop at x_i >= x
};

// warp 0 compacts the knots in knot order (a ballot ranks the kept
// ones) and checks their order; the block waits for it
__device__ __forceinline__ void load_tf(const float* __restrict__ knots,
                                        Tf& tf) {
    if (threadIdx.x < 32) {
        const int i = threadIdx.x;
        const bool in = i < kKnots;
        const float ax = in ? knots[kAx + i] : 0.0f;
        const float am = in ? knots[kAm + i] : 0.0f;
        const float cx = in ? knots[kCx + i] : 0.0f;
        const float m0 = in ? knots[kCm + 3 * i] : 0.0f;
        const float m1 = in ? knots[kCm + 3 * i + 1] : 0.0f;
        const float m2 = in ? knots[kCm + 3 * i + 2] : 0.0f;
        const bool ka = am != 0.0f;
        const bool kc = m0 != 0.0f || m1 != 0.0f || m2 != 0.0f;
        const unsigned ba = __ballot_sync(0xffffffffu, ka);
        const unsigned bc = __ballot_sync(0xffffffffu, kc);
        const unsigned below = (1u << i) - 1u;
        const int ra = __popc(ba & below), rc = __popc(bc & below);
        if (ka) tf.a[ra] = make_float2(ax, am);
        if (kc) tf.c[rc] = make_float4(cx, m0, m1, m2);
        const int na = __popc(ba), nc = __popc(bc);
        __syncwarp();
        const bool a_bad = i + 1 < na && tf.a[i].x > tf.a[i + 1].x;
        const bool c_bad = i + 1 < nc && tf.c[i].x > tf.c[i + 1].x;
        const bool any_a = __any_sync(0xffffffffu, a_bad);
        const bool any_c = __any_sync(0xffffffffu, c_bad);
        if (i == 0) {
            tf.na = na;
            tf.nc = nc;
            tf.a_asc = any_a ? 0 : 1;
            tf.c_asc = any_c ? 0 : 1;
            tf.ab = knots[kAb];
            tf.cb[0] = knots[kCb];
            tf.cb[1] = knots[kCb + 1];
            tf.cb[2] = knots[kCb + 2];
        }
    }
    __syncthreads();
}

// base + sum m_i * max(x - x_i, 0) over the kept alpha knots in order
__device__ __forceinline__ float alpha_sum(const Tf& tf, float x, int n,
                                           bool asc) {
    float a = tf.ab;
    for (int i = 0; i < n; ++i) {
        const float2 kn = tf.a[i];
        if (asc && kn.x >= x) break;
        a = a + kn.y * fmaxf(x - kn.x, 0.0f);
    }
    return a;
}

// the three colour sums over the kept colour knots in order
__device__ __forceinline__ void colour_sum(const Tf& tf, float x, int n,
                                           bool asc, float& r, float& g,
                                           float& b) {
    r = tf.cb[0];
    g = tf.cb[1];
    b = tf.cb[2];
    for (int i = 0; i < n; ++i) {
        const float4 kn = tf.c[i];
        if (asc && kn.x >= x) break;
        const float t = fmaxf(x - kn.x, 0.0f);
        r = r + kn.y * t;
        g = g + kn.z * t;
        b = b + kn.w * t;
    }
}

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

// one pixel's walk: the TPU kernel's phase A carries (running count,
// running transmittance, prev rgb, prev empty), the sum of slot a and
// the sum of the slot open after it (slot b until a later start)
struct Walk {
    float cnt, pr0, pr1, pr2, t_run, th, kf;
    bool pe, lit, use_a, use_b;
    int sa, sb;
    Acc acc_a, acc_b;

    __device__ __forceinline__ void load(const float* small,
                                         const float* thr, long long hw,
                                         long long p, int k) {
        cnt = small[p];
        pr0 = small[hw + p];
        pr1 = small[2 * hw + p];
        pr2 = small[3 * hw + p];
        pe = small[4 * hw + p] > 0.5f;
        th = thr[p];
        kf = (float)(k - 1);
        lit = false;
    }

    __device__ __forceinline__ void begin_chunk() {
        t_run = 1.0f;
        sa = (int)fminf(fmaxf(cnt - 1.0f, 0.0f), kf);
        sb = (int)fminf(fmaxf(cnt, 0.0f), kf);
        use_a = use_b = false;
        acc_a.zero();
        acc_b.zero();
    }

    // a non-empty sample (premultiplied r, g, b and alpha a)
    __device__ __forceinline__ void step(float* color, float* depth,
                                         long long hw, long long p, float r,
                                         float g, float b, float a, float d0,
                                         float d1) {
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
        } else {
            // slots never decrease: a later slot closes slot sb for good
            if (slot != sb) {
                if (use_b) {
                    Row row;
                    row.load(color, depth, sb, hw, p);
                    row.merge_store(color, depth, sb, hw, p, acc_b);
                }
                sb = slot;
                acc_b.zero();
            }
            acc_b.add(x0, x1, x2, x3, d0, d1);
            use_b = true;
        }
        pr0 = r;
        pr1 = g;
        pr2 = b;
        pe = false;
        lit = true;
    }

    // the chunk's rows: both reads issued before the first merge
    __device__ __forceinline__ void end_chunk(float* color, float* depth,
                                              long long hw, long long p) {
        Row ra, rb;
        if (use_a) ra.load(color, depth, sa, hw, p);
        if (use_b) rb.load(color, depth, sb, hw, p);
        if (use_a) ra.merge_store(color, depth, sa, hw, p, acc_a);
        if (use_b) rb.merge_store(color, depth, sb, hw, p, acc_b);
    }

    __device__ __forceinline__ void store(float* small, long long hw,
                                          long long p) const {
        if (lit) {
            small[p] = cnt;
            small[hw + p] = pr0;
            small[2 * hw + p] = pr1;
            small[3 * hw + p] = pr2;
        }
        small[4 * hw + p] = pe ? 1.0f : 0.0f;
    }
};

// one sample: the dead test, the alpha sum, the opacity correction, the
// empty test, and for a non-empty sample the colour and K1's step
__device__ __forceinline__ void sample(Walk& wk, const Tf& tf, float v,
                                      int s, int na, int nc, bool a_asc,
                                      bool c_asc, float rt, float ln,
                                      const float* __restrict__ sk0,
                                      const float* __restrict__ sk1,
                                      float* color, float* depth,
                                      long long hw, long long p) {
    // a dead sample: alpha 0, 1 - powf(1, ratio) == 0
    if (v < -0.5f) {
        wk.pe = true;
        return;
    }
    const float x = fminf(fmaxf(v, 0.0f), 1.0f);
    const float om = 1.0f - alpha_sum(tf, x, na, a_asc);
    // the clamp gives 1 and powf(1, ratio) == 1: alpha 0
    if (om >= 1.0f) {
        wk.pe = true;
        return;
    }
    const float a = 1.0f - powf(fminf(fmaxf(om, 1e-7f), 1.0f), rt);
    if (a < kEmptyAlpha) {
        wk.pe = true;
        return;
    }
    float r, g, b;
    colour_sum(tf, x, nc, c_asc, r, g, b);
    wk.step(color, depth, hw, p, r * a, g * a, b * a, a,
            __ldg(sk0 + s) * ln, __ldg(sk1 + s) * ln);
}

// copy slices [s, s + n) of the pixel's column into its column of the
// stage buffer, evict-first in L2, as one commit group
__device__ __forceinline__ void stage_in(float (*buf)[kThreads],
                                         const float* vp, int s, int n,
                                         long long hw,
                                         unsigned long long policy) {
    for (int j = 0; j < n; ++j) {
        const unsigned dst =
            (unsigned)__cvta_generic_to_shared(&buf[j][threadIdx.x]);
        const float* src = vp + (long long)(s + j) * hw;
        asm volatile(
            "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n"
            :: "r"(dst), "l"(src), "l"(policy));
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// C > 0: chunks of exactly C slices; C == 0: chunks of `chunk` slices,
// a runtime bound. s_total slices in all (B5: one chunk). A chunk is
// walked in stages of up to kStage slices; each stage's copy into
// shared memory is issued before the previous stage is walked.
template <int C>
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
    __shared__ Tf tf;
    __shared__ float buf[C == 1 ? 1 : 2][C == 1 ? 1 : kStage][kThreads];
    const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool mine = p < hw;
    const int nch = C > 0 ? C : chunk;
    const float* vp = val + p;
    unsigned long long policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    // the first stage's copy and the state's loads are in flight while
    // the block compacts the knots
    const int n_first = nch < kStage ? nch : kStage;
    if (C != 1 && mine) stage_in(buf[0], vp, 0, n_first, hw, policy);
    float v_next = 0.0f;            // C == 1: the next slice's value
    if (C == 1 && mine) v_next = __ldcs(vp);
    Walk wk;
    float ln = 0.0f, rt = 0.0f;
    if (mine) {
        wk.load(small, thr, hw, p, k);
        ln = length[p];
        rt = ratio[p];
    }
    load_tf(knots, tf);
    if (!mine) return;
    const int na = tf.na, nc = tf.nc;
    const bool a_asc = tf.a_asc != 0, c_asc = tf.c_asc != 0;

    int stage = 0;
    for (int c0 = 0; c0 < s_total; c0 += nch) {
        wk.begin_chunk();
        if (C == 1) {
            const float v = v_next;
            if (c0 + 1 < s_total)
                v_next = __ldcs(vp + (long long)(c0 + 1) * hw);
            sample(wk, tf, v, c0, na, nc, a_asc, c_asc, rt, ln, sk0, sk1,
                   color, depth, hw, p);
        } else {
            for (int s0 = c0; s0 < c0 + nch; s0 += kStage) {
                const int n0 = c0 + nch - s0 < kStage ? c0 + nch - s0
                                                      : kStage;
                // the next stage: the rest of this chunk, or the next's
                const int s1 = s0 + n0;
                if (s1 < s_total) {
                    const int left = s1 < c0 + nch ? c0 + nch - s1 : nch;
                    stage_in(buf[stage ^ 1], vp, s1,
                             left < kStage ? left : kStage, hw, policy);
                    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
                } else {
                    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
                }
#pragma unroll 1
                for (int j = 0; j < n0; ++j)
                    sample(wk, tf, buf[stage][j][threadIdx.x], s0 + j, na,
                           nc, a_asc, c_asc, rt, ln, sk0, sk1, color, depth,
                           hw, p);
                stage ^= 1;
            }
        }
        wk.end_chunk(color, depth, hw, p);
    }
    wk.store(small, hw, p);
}

template <int C>
const void* kernel_fn() {
    return (const void*)fused_fold_kernel<C>;
}

// the build a chunk of c slices takes
const void* pick(int c) {
    if (c == 16) return kernel_fn<16>();
    if (c == 1) return kernel_fn<1>();
    return kernel_fn<0>();
}

int launch(const float* val, const float* length, const float* ratio,
           const float* thr, const float* sk0, const float* sk1,
           const float* knots, float* color, float* depth, float* small,
           int s_total, int chunk, int k, int h, int w,
           cudaStream_t stream) {
    if (chunk < 1 || s_total < chunk || s_total % chunk || k < 1 || h < 1 ||
        w < 1)
        return (int)cudaErrorInvalidValue;
    long long hw = (long long)h * w;
    const dim3 grid((unsigned)((hw + kThreads - 1) / kThreads));
    void* args[] = {(void*)&val,   (void*)&length, (void*)&ratio,
                    (void*)&thr,   (void*)&sk0,    (void*)&sk1,
                    (void*)&knots, (void*)&color,  (void*)&depth,
                    (void*)&small, (void*)&s_total, (void*)&chunk,
                    (void*)&k,     (void*)&hw};
    const cudaError_t e = cudaLaunchKernel(pick(chunk), grid,
                                           dim3(kThreads), args, 0, stream);
    if (e != cudaSuccess) return (int)e;
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

// the build that chunks of c slices take (16, 1, or the generic one;
// B5 and B6 share it): out int[6] = registers a thread, local-memory
// bytes a thread, shared bytes a block, resident blocks an SM, threads
// a block, and the slices a stage holds
extern "C" int fused_fold_attributes(int c, int* out) {
    if (c < 1) return (int)cudaErrorInvalidValue;
    const void* fn = pick(c);
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
    out[5] = c < kStage ? c : kStage;
    return 0;
}

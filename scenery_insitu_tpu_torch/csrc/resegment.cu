// K4 — the sort-last composite's resegment: fold one per-pixel
// depth-sorted stream of N*K supersegments into at most K_out output
// supersegments, with the adaptive per-pixel threshold search in front.
//
// Replaces the TPU kernel scenery_insitu_tpu/ops/pallas_composite.py,
// resegment_sorted, kernel body _kernel. Plain version and oracle:
// supersegments.push_count / push / finalize looped over the slots, run
// by ops/cuda_composite.py::resegment_sorted_plain.
//
// What it computes, per pixel: if iters > 0, the `iters` steps of a
// bisection of the threshold over [0, thr_max] (a step counts segment
// starts under the rgb-distance break and the depth-gap break; the
// bracket keeps the smallest threshold whose count is <= K_out); then
// one write pass with the resulting threshold (the given one when iters
// is 0) and the finalize of the open segment. Empty output slots hold
// zero colour and +inf depth.
//
// What bounds it on the H100: bytes. A pixel reads the alpha of its N*K
// slots (to know which are empty) and the colour and depth of its
// non-empty ones, and writes K_out slots of 6 floats. In the 8-rank
// frame (N*K = 128, K_out = 16) a pixel has a few non-empty slots, so the
// alpha plane and the output are most of it.
//
// Design. A walk of a pixel's stream a counting pass (6 of them, with an
// alpha sweep before and the write pass after) would make a launch 8
// chains of loads, each waiting on the previous slot. One thread a pixel,
// neighbouring threads on neighbouring x, so every slot plane access
// coalesces across the warp. Three phases:
//
// A. The masks. The thread reads the alpha of all N*K slots, the loads of
//    kWords 32-slot words going out together, and keeps a bit a slot
//    (non-empty: alpha >= EMPTY_ALPHA or NaN, the plain version's
//    predicate) in shared memory, a column of (N*K + 31) / 32 words a
//    thread, and the last non-empty slot. This is the only pass over the
//    whole stream.
// B. One walk for the whole search, over slots [0, last]. A pixel's count
//    under threshold th is count(th) = F + #{j : d_j > th}. F counts the
//    forced starts: a non-empty slot after an empty one (or at the
//    front), or one whose depth gap to the previous slot fires. d_j is
//    the rgb distance of every other non-empty slot to the slot before it
//    (which is then non-empty). Neither F nor the d_j depends on th. So
//    the walk gathers F and the L largest d_j (L = K_out + 1, at most
//    N*K - 1) in a list kept descending, and the bisection then needs no
//    slot at all:
//      count(mid) > K_out  <=>  F > K_out  or  v > mid,
//    where v is the (K_out - F + 1)-th largest d_j (-inf if there are
//    fewer). Proof: with G = K_out - F >= 0, count(mid) > K_out iff at
//    least G + 1 of the d_j exceed mid iff the (G + 1)-th largest does.
//    The bisection itself runs as the plain version runs it, mid =
//    0.5f * (lo + hi) in f32 under the same no-FMA build, so every mid
//    it visits, and so every threshold, is the plain version's, for
//    every iters and thr_max: there is no table and no cap on iters. A
//    NaN distance never exceeds a threshold; it enters the list as -inf.
//    Inserting x sets entry j to max(v[j], min(v[j - 1], x)), every
//    entry from the old list at once: a network of depth 2 with no
//    data-dependent index, so for K_out <= 16 its 17 entries stay in
//    registers; a larger K_out keeps the list in shared memory (a column
//    of L floats a thread) and skips an x no larger than its last entry.
//    Neither the histogram over the bisection's midpoint table nor a
//    list of every distance is needed: the first caps iters by the
//    table's size, the second holds N*K floats a pixel. With iters = 0
//    there is no phase B.
// C. The write pass, one thread a pixel as before: supersegments.push
//    over slots [0, last + 1] (an empty slot after an empty one changes
//    nothing), then finalize. The open segment (rgba, start, end, prev
//    rgb, flags, next slot) lives in registers; every output slot is
//    written exactly once straight into the pixel's column, a closed
//    segment when it closes, the open one at the end, and the untouched
//    tail as empty slots in a loop that all lanes walk together, so that
//    a warp store writes one slot row.
//
// Both walks take one slot a step and read the non-empty slots through a
// ring in the thread's shared column: kAhead entries of 6 floats, filled
// by cp.async (4 bytes a value, only for the slots the masks mark
// non-empty) kAhead slots ahead of the walk. B's reads leave the slots in
// L2 for C.
//
// What the frame's launches meet is latency, not bytes. A column block
// of the 8-rank frame has 51,200 pixels, ~12 warps an SM; 57 % of the
// fullest block's pixels are empty, the others hold ~26 non-empty slots
// and a busy warp's fullest pixel 38 to 78, so ~5 warps an SM carry the
// walks and the launch ends with the longest chain of one thread's
// walk. A step's distance and forced flag (B) or rgb break (C) are
// computed before the sequential part, the list insert (B) or the
// segment state (C); each mask is built as four OR chains. In the trials
// (chip_smoke.py --k4-compare on the frame's column blocks, in turns;
// PERF.md §6) the frame's time moved with that chain: one-slot
// steps 8 ahead beat groups of 2, 4 and 8 slots written out in the
// source (their code and registers cost more than their loads in flight
// gained), while the one-slot loop unrolled 4 times by the compiler took
// 0.91 of the rolled loop's time and 2 times 0.92; neither an output
// buffer in shared memory written row by row, staging slots from B for
// C, other block sizes, nor interleaving the pixel-warps of far apart
// rows in a block moved it beyond 5 %. Skipping B for a pixel with at
// most K_out non-empty slots (exact: its count never exceeds them) made
// the frame slower: C then found the slots in HBM instead of L2. Each
// variant was a copy of this source served through --k4-compare.
//
// Any H and W: the ragged tail of the last block is masked.
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
constexpr int kWords = 2;              // alpha words whose loads go out together
constexpr int kAhead = 8;              // the ring's entries: slots copied ahead
static_assert((kAhead & (kAhead - 1)) == 0, "the ring's entries: a power of 2");
constexpr int kRegList = 17;           // the register list: K_out <= 16
constexpr int kMaxShared = 232448;     // a block's shared memory on sm_90

__device__ __forceinline__ float rgb_distance(float r, float g, float b,
                                              float pr, float pg,
                                              float pb) {
    const float d0 = r - pr, d1 = g - pg, d2 = b - pb;
    return sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
}

// The L largest distances, descending, -inf where fewer: registers.
// Inserting x: entry j becomes max(v[j], min(v[j - 1], x)), every entry
// from the old list at once (a network of depth 2, not a chain of L
// compare-exchanges).
template <int L>
struct RegList {
    float v[L];
    __device__ __forceinline__ void init() {
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = -INFINITY;
    }
    __device__ __forceinline__ void insert(float x) {
#pragma unroll
        for (int j = L - 1; j > 0; --j) v[j] = fmaxf(v[j], fminf(v[j - 1], x));
        v[0] = fmaxf(v[0], x);
    }
    __device__ __forceinline__ float at(int g) const {
        float r = -INFINITY;
#pragma unroll
        for (int j = 0; j < L; ++j)
            if (j == g) r = v[j];
        return r;
    }
};

// The same list in shared memory: a thread's column of `len` entries,
// `stride` floats apart (conflict-free across the warp). An x no larger
// than the last entry changes nothing and is skipped.
struct SharedList {
    float* v;
    int len, stride;
    __device__ __forceinline__ void init() {
        for (int j = 0; j < len; ++j) v[j * stride] = -INFINITY;
    }
    __device__ __forceinline__ void insert(float x) {
        if (!(x > v[(len - 1) * stride])) return;
        for (int j = len - 1; j > 0; --j)
            v[j * stride] = fmaxf(v[j * stride],
                                  fminf(v[(j - 1) * stride], x));
        v[0] = fmaxf(v[0], x);
    }
    __device__ __forceinline__ float at(int g) const {
        return g >= 0 && g < len ? v[g * stride] : -INFINITY;
    }
};

// Phase A: the non-empty mask of every 32-slot word of the pixel's
// stream (bit j of word w: slot 32 w + j has alpha >= EMPTY_ALPHA or
// NaN, the plain version's predicate) into masks[w * stride]; returns
// the last non-empty slot (-1 if none). The alphas of kWords words go
// out together.
__device__ __forceinline__ int live_masks(const float* __restrict__ sc,
                                          int nk, long long hw, long long p,
                                          unsigned* masks, int stride) {
    const int words = (nk + 31) / 32;
    int last = -1;
    for (int w0 = 0; w0 < words; w0 += kWords) {
        float a[kWords][32];
#pragma unroll
        for (int q = 0; q < kWords; ++q)
#pragma unroll
            for (int j = 0; j < 32; ++j) {
                const int i = (w0 + q) * 32 + j;
                a[q][j] = i < nk
                    ? __ldg(sc + ((long long)i * 4 + 3) * hw + p) : 0.f;
            }
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
            unsigned m[4] = {0u, 0u, 0u, 0u};   // four short OR chains
#pragma unroll
            for (int j = 0; j < 32; ++j)
                m[j % 4] |= (a[q][j] < kEmptyAlpha ? 0u : 1u) << j;
            const unsigned mw = (m[0] | m[1]) | (m[2] | m[3]);
            if (w0 + q < words) {
                masks[(w0 + q) * stride] = mw;
                if (mw != 0u) last = (w0 + q) * 32 + 31 - __clz(mw);
            }
        }
    }
    return last;
}

// The ring through which phases B and C read a pixel's slots: kAhead
// entries of 6 floats (r, g, b, a, t0, t1) in the thread's shared column,
// filled by cp.async kAhead slots ahead of the walk, so a walk waits on a
// slot's loads only when they are kAhead slots late. Only a non-empty slot
// is copied (the masks say which), and only what its walk reads: B r, g, b
// and, with the gap test, t0 and t1 (issue's rgb_only and depth); C all
// six.
struct Ring {
    float* buf;                 // value v of entry e at (6 e + v) * stride
    const unsigned* masks;
    const float* sc;
    const float* sd;
    long long hw, p;
    int stride, n;
    __device__ __forceinline__ bool live(int i) const {
        return (masks[(i >> 5) * stride] >> (i & 31)) & 1u;
    }
    __device__ __forceinline__ float at(int i, int v) const {
        return buf[(6 * (i & (kAhead - 1)) + v) * stride];
    }
    // copy slot i if it is non-empty and below n, and commit the copies as
    // one cp.async group (empty or not, so that the waits count slots)
    __device__ __forceinline__ void issue(int i, bool rgb_only,
                                          bool depth) const {
        if (i < n && live(i)) {
#pragma unroll
            for (int v = 0; v < 6; ++v) {
                if (v == 3 && rgb_only) continue;
                if (v >= 4 && !depth) continue;
                const float* src = v < 4
                    ? sc + ((long long)i * 4 + v) * hw + p
                    : sd + ((long long)i * 2 + v - 4) * hw + p;
                const unsigned dst = (unsigned)__cvta_generic_to_shared(
                    buf + (6 * (i & (kAhead - 1)) + v) * stride);
                // "memory": no read of the ring moves past a copy into it
                asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                             :: "r"(dst), "l"(src) : "memory");
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
};

__device__ __forceinline__ void ring_wait_oldest() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kAhead - 1) : "memory");
}

__device__ __forceinline__ void ring_drain() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Phase B, the search's one walk over slots [0, n), n one past the last
// non-empty slot (supersegments.push_count's predicates): the forced
// starts into `forced`, every other non-empty slot's distance into
// `lst`. A non-empty slot is forced when the slot before it is empty or
// the depth gap to that slot fires; otherwise the slot before it is
// non-empty, and its distance is to that slot. A slot's distance and
// forced flag are computed before it enters the count.
template <class List>
__device__ __forceinline__ void count_walk(const Ring ring, float gap_eps,
                                           List& lst, int& forced) {
    const bool gap = gap_eps >= 0.f;
    for (int i = 0; i < kAhead; ++i) ring.issue(i, true, gap);
    int f = 0;
    bool pl = false;            // the slot before is non-empty
    float pr = 0.f, pg = 0.f, pb = 0.f, pend = 0.f;
#pragma unroll 4
    for (int i = 0; i < ring.n; ++i) {
        ring_wait_oldest();
        const bool lv = ring.live(i);
        const float r = lv ? ring.at(i, 0) : 0.f;
        const float g = lv ? ring.at(i, 1) : 0.f;
        const float b = lv ? ring.at(i, 2) : 0.f;
        const float t0 = lv && gap ? ring.at(i, 4) : 0.f;
        const float t1 = lv && gap ? ring.at(i, 5) : 0.f;
        ring.issue(i + kAhead, true, gap);
        const float x = rgb_distance(r, g, b, pr, pg, pb);
        const bool fi = !pl || (gap && t0 > pend + gap_eps);
        if (lv) {
            if (fi)
                ++f;
            else
                lst.insert(x == x ? x : -INFINITY);
        }
        pl = lv;
        pr = r;
        pg = g;
        pb = b;
        pend = t1;
    }
    ring_drain();
    forced = f;
}

// The bisection of supersegments.adaptive_threshold on the walk's
// summary: count(mid) > k_out iff over or v > mid.
__device__ __forceinline__ float bisect(bool over, float v, int iters,
                                        float thr_max) {
    float lo = 0.0f, hi = thr_max;
    for (int it = 0; it < iters; ++it) {
        const float mid = 0.5f * (lo + hi);
        const bool too_many = over || v > mid;
        lo = too_many ? mid : lo;
        hi = too_many ? hi : mid;
    }
    return hi;
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

// Phase C, the write pass: supersegments.push over slots [0, n), n one
// past the slot after the last non-empty one (an empty slot after an
// empty one changes nothing), then finalize. A closed segment is written
// when it closes; the untouched tail at the end, the warp's lanes on one
// slot row a store. A slot's rgb break is computed before the segment
// state takes it.
__device__ __forceinline__ void write_walk(const Ring ring,
                                          float* __restrict__ color,
                                          float* __restrict__ depth,
                                          int k_out, float th,
                                          float gap_eps) {
    const long long hw = ring.hw, p = ring.p;
    for (int i = 0; i < kAhead; ++i) ring.issue(i, false, true);
    int k = 0;
    bool open = false, pe = true;
    float seg[4] = {0.f, 0.f, 0.f, 0.f};
    float s0 = 0.f, s1 = 0.f;
    float pr = 0.f, pg = 0.f, pb = 0.f;
#pragma unroll 4
    for (int i = 0; i < ring.n; ++i) {
        ring_wait_oldest();
        const bool lv = ring.live(i);
        const float r = lv ? ring.at(i, 0) : 0.f;
        const float g = lv ? ring.at(i, 1) : 0.f;
        const float b = lv ? ring.at(i, 2) : 0.f;
        const float a = lv ? ring.at(i, 3) : 0.f;
        const float t0 = lv ? ring.at(i, 4) : 0.f;
        const float t1 = lv ? ring.at(i, 5) : 0.f;
        ring.issue(i + kAhead, false, true);
        const bool far = rgb_distance(r, g, b, pr, pg, pb) > th;
        if (!lv) {
            // an empty slot after a non-empty one closes the segment
            if (!pe && open && k < k_out - 1) {
                write_slot(color, depth, k, hw, p, seg, s0, s1);
                ++k;
                open = false;
            }
            pe = true;
        } else {
            bool brk = !pe && far;
            if (gap_eps >= 0.f) brk = brk || (open && t0 > s1 + gap_eps);
            // merge overflow: the last slot never closes mid-stream
            if (open && brk && k < k_out - 1) {
                write_slot(color, depth, k, hw, p, seg, s0, s1);
                ++k;
                open = false;
            }
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
            pe = false;
        }
        pr = r;
        pg = g;
        pb = b;
    }
    ring_drain();
    if (open) {
        write_slot(color, depth, min(k, k_out - 1), hw, p, seg, s0, s1);
        ++k;
    }
    // the untouched tail, a slot row a warp store
    const float empty[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < k_out; ++s)
        if (s >= k)
            write_slot(color, depth, s, hw, p, empty, INFINITY, INFINITY);
}

// kSearch: iters > 0 (phase B gathers the search's summary); kRegs: the
// list in registers (K_out <= 16, or N*K <= 18), else in shared memory.
// Dynamic shared memory, a column a thread, `stride` words apart: the
// masks ((N*K + 31) / 32 words), the ring (6 kAhead floats), then the
// list where it is not in registers (list_len floats).
template <bool kSearch, bool kRegs>
__global__ void __launch_bounds__(kThreads)
resegment_kernel(const float* __restrict__ sc, const float* __restrict__ sd,
                 const float* __restrict__ thr, float* __restrict__ color,
                 float* __restrict__ depth, float* __restrict__ thr_out,
                 int nk, int k_out, long long hw, int iters, float gap_eps,
                 float thr_max, int list_len) {
    extern __shared__ unsigned smem[];
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;
    const int stride = blockDim.x;
    unsigned* masks = smem + threadIdx.x;
    const int last = live_masks(sc, nk, hw, p, masks, stride);
    float* ring_buf = reinterpret_cast<float*>(masks) +
                      (nk + 31) / 32 * stride;

    float th;
    if constexpr (!kSearch) {
        th = thr[p];
    } else {
        const Ring ring{ring_buf, masks, sc, sd, hw, p, stride, last + 1};
        int forced = 0;
        float v;
        if constexpr (kRegs) {
            RegList<kRegList> lst;
            lst.init();
            count_walk(ring, gap_eps, lst, forced);
            v = lst.at(k_out - forced);
        } else {
            SharedList lst{ring_buf + 6 * kAhead * stride, list_len, stride};
            lst.init();
            count_walk(ring, gap_eps, lst, forced);
            v = lst.at(k_out - forced);
        }
        th = bisect(forced > k_out, v, iters, thr_max);
    }
    if (thr_out != nullptr) thr_out[p] = th;
    const Ring ring{ring_buf, masks, sc, sd, hw, p, stride,
                    min(last + 2, nk)};
    write_walk(ring, color, depth, k_out, th, gap_eps);
}

struct Plan {
    const void* fn;
    int threads, shared, list_len, regs_list;
};

// The build a call takes, its block and its shared memory.
cudaError_t plan(int nk, int k_out, int iters, Plan* pl) {
    if (nk < 1 || k_out < 1) return cudaErrorInvalidValue;
    int words = (nk + 31) / 32 + 6 * kAhead;  // a thread's shared words
    pl->list_len = 0;
    pl->regs_list = 0;
    if (iters <= 0) {
        pl->fn = (const void*)resegment_kernel<false, true>;
    } else {
        // the distances number at most nk - 1
        pl->list_len = k_out + 1 < nk - 1 ? k_out + 1 : (nk > 2 ? nk - 1 : 1);
        if (pl->list_len <= kRegList) {
            pl->fn = (const void*)resegment_kernel<true, true>;
            pl->regs_list = 1;
        } else {
            pl->fn = (const void*)resegment_kernel<true, false>;
            words += pl->list_len;
        }
    }
    pl->threads = kThreads;
    while (words * pl->threads * 4 > kMaxShared && pl->threads > 32)
        pl->threads /= 2;
    pl->shared = words * pl->threads * 4;
    if (pl->shared > kMaxShared) return cudaErrorInvalidValue;
    // the first call of a build lets it have all of a block's shared
    // memory (a bound, not an allocation)
    static const void* granted[3] = {};
    for (const void*& g : granted) {
        if (g == pl->fn) break;
        if (g != nullptr) continue;
        const cudaError_t e = cudaFuncSetAttribute(
            pl->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
        if (e != cudaSuccess) return e;
        g = pl->fn;
        break;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" int resegment_sorted(const float* sc, const float* sd,
                                const float* thr, float* color, float* depth,
                                float* thr_out, int nk, int k_out, int h,
                                int w, int iters,
                                float gap_eps, float thr_max,
                                cudaStream_t stream) {
    Plan pl;
    cudaError_t e = plan(nk, k_out, iters, &pl);
    if (e != cudaSuccess) return (int)e;
    const long long hw = (long long)h * w;
    const unsigned blocks = (unsigned)((hw + pl.threads - 1) / pl.threads);
    void* args[] = {(void*)&sc, (void*)&sd, (void*)&thr, (void*)&color,
                    (void*)&depth, (void*)&thr_out, (void*)&nk,
                    (void*)&k_out, (void*)&hw, (void*)&iters,
                    (void*)&gap_eps, (void*)&thr_max, (void*)&pl.list_len};
    e = cudaLaunchKernel(pl.fn, dim3(blocks), dim3(pl.threads), args,
                         pl.shared, stream);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// the build a call of (nk, k_out, iters) takes: out int[7] = registers a
// thread, local-memory bytes a thread, shared bytes a block, resident
// blocks an SM, threads a block, the list's entries (0 without the
// search), and 1 where the list lives in registers
extern "C" int resegment_attributes(int nk, int k_out, int iters, int* out) {
    Plan pl;
    cudaError_t e = plan(nk, k_out, iters, &pl);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, pl.fn);
    if (e != cudaSuccess) return (int)e;
    int bps = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, pl.fn,
                                                      pl.threads, pl.shared);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes + pl.shared;
    out[3] = bps;
    out[4] = pl.threads;
    out[5] = pl.list_len;
    out[6] = pl.regs_list;
    return 0;
}

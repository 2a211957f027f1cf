// B7 — the sequential supersegment machine (supersegments.push) over one
// chunk of shaded slices, with the depth planes read from memory and an
// optional count of the true segment starts at the same threshold (the
// temporal controller's feedback, supersegments.push_count). Beside it,
// in the same translation unit so that all three run one machine step,
// the two deferred-event twins of the reference's fold microbenchmark:
// B8 (events_fold_chunk, the close events in registers) and B9
// (scratch_fold_chunk, the close events in shared memory).
//
// Replaces the TPU kernels
// - B7: scenery_insitu_tpu/ops/pallas_march.py, fold_chunk, kernel body
//   _fold_kernel (phase 1, the O(1) machine over the slices; phase 2,
//   the per-slot extraction of the close events, rolled over K);
// - B8: benchmarks/fold_microbench.py, events_fold_chunk, kernel body
//   _events_kernel (phase 2 fully unrolled over K x C);
// - B9: benchmarks/fold_microbench.py, scratch_fold_chunk, kernel body
//   _scratch_kernel (phase 1 writes the events to a VMEM scratch
//   f32[C,7,TH,W]; phase 2 a fori_loop over K reads them back).
// Plain versions and oracles: ops/cuda_march.py::fold_chunk_plain (C
// sequential supersegments.push calls) and, for B8 and B9,
// benchmarks/fold_microbench.py::{events,scratch}_fold_chunk_plain (the
// reference's two phases in torch).
//
// What bounds them on the H100: bytes. Per chunk a pixel reads its C x 4
// rgba values and C x 2 depths, its threshold, reads and writes the
// 12-float machine state (and B7's count), and must write the colour (4)
// and depth (2) rows of the slots that close in this chunk; the work is
// ~30 flops per slice.
//
// Design. One thread per pixel, neighbouring threads on neighbouring x so
// every [., H, W] plane access coalesces. The 12-float machine (open
// segment rgba, start, end, prev rgb, open, prev empty, next slot k)
// lives in registers over the C slices and is written back once per
// chunk (struct Machine: decide() is the slice's close and start
// predicates, advance() the state update after the close). B7 writes a
// closing slot's colour and depth rows when the close happens (a slot
// closes at most once per march, so this is the reference's merge with no
// record buffer).
//
// B8 and B9 keep the reference's schedule: phase 1 runs the machine over
// the chunk and records every close before phase 2 writes any slot row.
// The reference holds the slot as a vector over pixels, so its phase 2
// can only select masked rows over all K slots: that phase 2 sweeps
// every slot's 6 rows each chunk (768 B a pixel at K = 16, where the
// microbenchmark's stream closes 0.06 slots a pixel a chunk). One
// thread a pixel knows its own slots: a chunk's closes take consecutive
// slots from k at entry, in slice order (each close raises k by one, and
// closes stop at K - 1), so the slot is implicit and a chunk holds at
// most N = min(C, K - 1) closes. A close event is 6 floats (the closing
// segment's rgba, start, end), and phase 2 visits only the closed slots:
// colour += event (the reference's masked sum: one event hits a slot,
// every other term adds 0) and depth = the event's start and end (its
// where(hit)); every other slot keeps its values, as the reference's
// "+ 0" and "where" leave them.
// - B8 holds the N events in registers, a shift register whose index is
//   fixed at compile time (C and K are template parameters; a close
//   shifts the older events down one place and takes place 0), so they
//   never go to local memory. The slices' loads go out kGroup = 4 at a
//   time, evict-first (the stream is read once), not all C ahead of the
//   machine; the group loop is unrolled up to C = 16. Blocks of
//   kEventThreads = 128, three an SM. A close requests its slot's rows
//   into L2 at once (prefetch_rows), so phase 2's writes find them. Timed
//   on an H100 in turns, at C = 16, K = 16 and on the microbenchmark's
//   march, against this design: without the request 16 and 7 % slower;
//   with a second request before phase 2 15 and 1 %; a launch bound
//   that caps it at 128 registers spills 184 bytes, 12 and 113 %;
//   256-thread blocks 24 and 29 %; groups of 8 or 2 slices 15 and 10 %,
//   4 and 15 %; the next group's loads issued before the walk (197
//   registers) 13 and 10 %; the group loop unrolled at C = 32 (182
//   registers) 24 % at C = 32.
// - B9 appends each close to dynamic shared memory laid out
//   [N][6][threads] (a warp's accesses are consecutive), 24 N bytes a
//   thread, N from the runtime K: 46,080 bytes a 128-thread block at
//   K = 16, four blocks an SM, so shared memory, not its registers, sets
//   its 16 warps an SM. Its group loop is rolled and the next group's
//   loads go out before the current group is walked (without: 1.6 %
//   slower). Blocks of 128, as the wrapper passes them
//   (fold_microbench.scratch_block; 64 and 256 were 1-2 % slower). Phase 2 requests every closed slot's rows into L2, then
//   writes them (19 % faster at C = 16, K = 16 than without; requested
//   at each close instead, 15 % slower than this).
// - Phase 2 writes the latest close first, so the pixels of a warp that
//   reach the same k write the same slot rows in one instruction (B9:
//   1.7 % at C = 16, K = 16). Where a chunk closes many slots (a seeded
//   chunk of random colours: 6.3 a pixel), the rows of nearly every slot
//   move whole sectors for single floats; writing a colour row without
//   reading it first was slower still (11 % for B9).
// Predicates, merge-overflow (close only while k < K-1) and the
// accumulation seg + (1 - seg.a) * rgba are supersegments.push's; the rgb
// distance is written as sqrt(d0*d0 + d1*d1 + d2*d2) and the library is
// built without FMA contraction, so closes and counts equal the plain
// versions' exactly and B7, B8 and B9 agree bit for bit.
//
// State layout (updated in place): color f32[K,4,H,W], depth f32[K,2,H,W]
// (start, end; +inf until written), small f32[12,H,W] = seg rgba (0-3),
// seg start (4), seg end (5), prev rgb (6-8), open (9), prev empty (10),
// k (11), flags and k f32-encoded; count i32[H,W] or NULL (B7 only). B8
// and B9 take k at entry in [0, K - 1], as every state the machine
// reaches from init holds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 256;          // B7's block, B9's largest
constexpr int kEventFloats = 6;        // a close: rgba, start, end
constexpr int kEventThreads = 128;     // B8's block
constexpr int kGroup = 4;              // B8, B9: slices loaded together

struct Machine {
    float sr, sg, sb, sa, s_start, s_end, pr0, pr1, pr2, kc;
    bool open, pe;

    __device__ __forceinline__ void load(const float* small, long long hw,
                                         long long p) {
        sr = small[p];
        sg = small[hw + p];
        sb = small[2 * hw + p];
        sa = small[3 * hw + p];
        s_start = small[4 * hw + p];
        s_end = small[5 * hw + p];
        pr0 = small[6 * hw + p];
        pr1 = small[7 * hw + p];
        pr2 = small[8 * hw + p];
        open = small[9 * hw + p] > 0.5f;
        pe = small[10 * hw + p] > 0.5f;
        kc = small[11 * hw + p];
    }

    __device__ __forceinline__ void store(float* small, long long hw,
                                          long long p) const {
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
    }

    // Whether the open segment closes before this slice, and (into
    // *starts) whether the slice starts a segment by push_count's rule.
    __device__ __forceinline__ bool decide(float r, float g, float b,
                                           float a, float ta, float th,
                                           float klast, float gap_eps,
                                           bool* starts) const {
        const bool emp = a < kEmptyAlpha;
        const float d0 = r - pr0, d1 = g - pr1, d2 = b - pr2;
        const float diff = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        bool want_break = (!emp && !pe && diff > th) || (emp && !pe);
        if (gap_eps >= 0.0f)
            want_break = want_break || (!emp && open && ta > s_end + gap_eps);
        *starts = !emp && (pe || diff > th);
        return open && want_break && kc < klast;
    }

    // The state after the slice, once a close (if any) has been taken.
    __device__ __forceinline__ void advance(bool close, float r, float g,
                                            float b, float a, float ta,
                                            float tb) {
        if (close) {
            kc = kc + 1.0f;
            open = false;
        }
        const bool emp = a < kEmptyAlpha;
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
};

struct Slice {
    float r, g, b, a, ta, tb;
};

__device__ __forceinline__ Slice load_slice(const float* rgba,
                                            const float* t0,
                                            const float* t1, int s,
                                            long long hw, long long p) {
    const float* src = rgba + (long long)s * 4 * hw + p;
    return Slice{src[0], src[hw], src[2 * hw], src[3 * hw],
                 t0[(long long)s * hw + p], t1[(long long)s * hw + p]};
}

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

    Machine m;
    m.load(small, hw, p);
    const float th = thr[p];
    const float klast = (float)(k - 1);
    int n_starts = 0;

    for (int s = 0; s < c; ++s) {
        const Slice x = load_slice(rgba, t0, t1, s, hw, p);
        bool starts;
        const bool close = m.decide(x.r, x.g, x.b, x.a, x.ta, th, klast,
                                    gap_eps, &starts);
        if (starts) ++n_starts;
        if (close) {
            const long long slot = (long long)m.kc;
            float* oc = color + slot * 4 * hw + p;
            oc[0] = m.sr;
            oc[hw] = m.sg;
            oc[2 * hw] = m.sb;
            oc[3 * hw] = m.sa;
            float* od = depth + slot * 2 * hw + p;
            od[0] = m.s_start;
            od[hw] = m.s_end;
        }
        m.advance(close, x.r, x.g, x.b, x.a, x.ta, x.tb);
    }

    m.store(small, hw, p);
    if (count != nullptr) count[p] += n_starts;
}

// B8 and B9: slices [s0, s0 + G) of the chunk, loaded evict-first (the
// stream is read once): x[j] = rgba, start, end of slice s0 + j.
template <int G>
__device__ __forceinline__ void load_group(float (&x)[G][6],
                                           const float* __restrict__ rgba,
                                           const float* __restrict__ t0,
                                           const float* __restrict__ t1,
                                           int s0, long long hw,
                                           long long p) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
        const long long s = s0 + j;
        const float* src = rgba + s * 4 * hw + p;
        x[j][0] = __ldcs(src);
        x[j][1] = __ldcs(src + hw);
        x[j][2] = __ldcs(src + 2 * hw);
        x[j][3] = __ldcs(src + 3 * hw);
        x[j][4] = __ldcs(t0 + s * hw + p);
        x[j][5] = __ldcs(t1 + s * hw + p);
    }
}

// Phase 1's step: whether slice x closes the open segment (no gap test,
// as the reference's microbenchmark).
__device__ __forceinline__ bool closes(const Machine& m, const float* x,
                                       float th, float klast) {
    bool starts;
    return m.decide(x[0], x[1], x[2], x[3], x[4], th, klast, -1.0f,
                    &starts);
}

// A closed slot's colour and depth rows into L2 ahead of write_close:
// its colour is read there, and a sector that is written in part without
// being read costs more than one read first. A slot outside [0, k) is
// left, as write_close leaves it.
__device__ __forceinline__ void prefetch_rows(const float* color,
                                              const float* depth, int slot,
                                              int k, long long hw,
                                              long long p) {
    if (slot < 0 || slot >= k) return;
    const float* oc = color + (long long)slot * 4 * hw + p;
    const float* od = depth + (long long)slot * 2 * hw + p;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(oc));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(oc + hw));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(oc + 2 * hw));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(oc + 3 * hw));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(od));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(od + hw));
}

// Phase 2 for one close event: its slot's colour row += the event, its
// depths = the event's start and end. A slot outside [0, k) is left (a
// state whose k at entry is out of range).
__device__ __forceinline__ void write_close(float* color, float* depth,
                                            int slot, int k, long long hw,
                                            long long p, float r, float g,
                                            float b, float a, float ta,
                                            float tb) {
    if (slot < 0 || slot >= k) return;
    float* oc = color + (long long)slot * 4 * hw + p;
    oc[0] = oc[0] + r;
    oc[hw] = oc[hw] + g;
    oc[2 * hw] = oc[2 * hw] + b;
    oc[3 * hw] = oc[3 * hw] + a;
    float* od = depth + (long long)slot * 2 * hw + p;
    od[0] = ta;
    od[hw] = tb;
}

// B8's phase 1 over one group of slices: the machine over x[0..G), each
// close shifted into ev (ev[0] the latest; fixed indices, so registers)
// and counted in n, its slot's rows requested into L2 as it closes (the
// rest of the walk hides their latency).
template <int G, int N, int K>
__device__ __forceinline__ void walk_events(Machine& m,
                                            float (&ev)[N][kEventFloats],
                                            int& n, const float (&x)[G][6],
                                            float th, const float* color,
                                            const float* depth, int k0,
                                            long long hw, long long p) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
        const bool close = closes(m, x[j], th, (float)(K - 1));
        if (close) {
#pragma unroll
            for (int e = N - 1; e > 0; --e)
#pragma unroll
                for (int f = 0; f < kEventFloats; ++f) ev[e][f] = ev[e - 1][f];
            ev[0][0] = m.sr;
            ev[0][1] = m.sg;
            ev[0][2] = m.sb;
            ev[0][3] = m.sa;
            ev[0][4] = m.s_start;
            ev[0][5] = m.s_end;
            prefetch_rows(color, depth, k0 + n, K, hw, p);
            ++n;
        }
        m.advance(close, x[j][0], x[j][1], x[j][2], x[j][3], x[j][4],
                  x[j][5]);
    }
}

// (launch bound kThreads: the largest block of all three kernels)
template <int C, int K>
__global__ void __launch_bounds__(kThreads)
events_kernel(const float* __restrict__ rgba, const float* __restrict__ t0,
              const float* __restrict__ t1, const float* __restrict__ thr,
              float* __restrict__ color, float* __restrict__ depth,
              float* __restrict__ small, long long hw) {
    constexpr int N = C < K - 1 ? C : K - 1;   // the most closes a chunk
    constexpr int G = C < kGroup ? C : kGroup;
    static_assert(N >= 1 && C % G == 0, "a built (C, K) pair");
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;

    Machine m;
    m.load(small, hw, p);
    const float th = thr[p];
    const int k0 = (int)m.kc;
    float ev[N][kEventFloats];
#pragma unroll
    for (int e = 0; e < N; ++e)
#pragma unroll
        for (int f = 0; f < kEventFloats; ++f) ev[e][f] = 0.0f;
    int n = 0;
    // the group loop unrolled up to C = 16, rolled above (unrolled at
    // C = 32: 182 registers, two blocks an SM, 24 % slower)
    constexpr int kUnroll = C <= 16 ? C / G : 1;
#pragma unroll kUnroll
    for (int s0 = 0; s0 < C; s0 += G) {
        float x[G][6];
        load_group<G>(x, rgba, t0, t1, s0, hw, p);
        walk_events<G, N, K>(m, ev, n, x, th, color, depth, k0, hw, p);
    }
    m.store(small, hw, p);

    // the latest close first: pixels that reach the same k write the same
    // slot rows together
#pragma unroll
    for (int e = 0; e < N; ++e) {
        if (e < n)
            write_close(color, depth, k0 + n - 1 - e, K, hw, p, ev[e][0],
                        ev[e][1], ev[e][2], ev[e][3], ev[e][4], ev[e][5]);
    }
}

// B9's close events a thread holds: at most min(C, K - 1), 0 for K < 2.
__host__ __device__ __forceinline__ int scratch_entries(int c, int k) {
    const int n = c < k - 1 ? c : k - 1;
    return n > 0 ? n : 0;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
scratch_kernel(const float* __restrict__ rgba, const float* __restrict__ t0,
               const float* __restrict__ t1, const float* __restrict__ thr,
               float* __restrict__ color, float* __restrict__ depth,
               float* __restrict__ small, int k, long long hw) {
    extern __shared__ float scratch[];         // [N][6][blockDim.x]
    constexpr int G = C < kGroup ? C : kGroup;
    static_assert(C % G == 0, "a built C");
    const int nt = blockDim.x;
    const long long p = (long long)blockIdx.x * nt + threadIdx.x;
    if (p >= hw) return;                       // no block-wide sync below
    float* mine = scratch + threadIdx.x;
    const int cap = scratch_entries(C, k);

    Machine m;
    m.load(small, hw, p);
    const float th = thr[p];
    const float klast = (float)(k - 1);
    const int k0 = (int)m.kc;
    int n = 0;
    float x[G][6];
    load_group<G>(x, rgba, t0, t1, 0, hw, p);
#pragma unroll 1
    for (int s0 = 0; s0 < C; s0 += G) {
        float y[G][6];                         // the next group, in flight
        const bool more = s0 + G < C;
        if (more) load_group<G>(y, rgba, t0, t1, s0 + G, hw, p);
#pragma unroll
        for (int j = 0; j < G; ++j) {
            const bool close = closes(m, x[j], th, klast);
            if (close) {
                if (n < cap) {
                    float* ev = mine + n * kEventFloats * nt;
                    ev[0] = m.sr;
                    ev[nt] = m.sg;
                    ev[2 * nt] = m.sb;
                    ev[3 * nt] = m.sa;
                    ev[4 * nt] = m.s_start;
                    ev[5 * nt] = m.s_end;
                }
                ++n;
            }
            m.advance(close, x[j][0], x[j][1], x[j][2], x[j][3], x[j][4],
                      x[j][5]);
        }
        if (more) {
#pragma unroll
            for (int j = 0; j < G; ++j)
#pragma unroll
                for (int f = 0; f < 6; ++f) x[j][f] = y[j][f];
        }
    }
    m.store(small, hw, p);

    // every closed slot's rows requested before any is written, then the
    // latest close first, as B8
    const int held = n < cap ? n : cap;
#pragma unroll 1
    for (int e = held - 1; e >= 0; --e)
        prefetch_rows(color, depth, k0 + e, k, hw, p);
#pragma unroll 1
    for (int e = held - 1; e >= 0; --e) {
        const float* ev = mine + e * kEventFloats * nt;
        write_close(color, depth, k0 + e, k, hw, p, ev[0], ev[nt],
                    ev[2 * nt], ev[3 * nt], ev[4 * nt], ev[5 * nt]);
    }
}

// The (C, K) pairs B8 is built for, and the C B9 is built for (C = 1: the
// single-plane chunks a march with chunk skipping feeds); the wrappers
// (benchmarks/fold_microbench.py) keep the same lists.
#define EVENT_PAIRS(X) \
    X(1, 4) X(1, 8) X(1, 16) X(8, 4) X(8, 8) X(8, 16) \
    X(16, 4) X(16, 8) X(16, 16) X(32, 4) X(32, 8) X(32, 16)
#define SCRATCH_CHUNKS(X) X(1) X(8) X(16) X(32)

using EventsFn = void (*)(const float*, const float*, const float*,
                          const float*, float*, float*, float*, long long);
using ScratchFn = void (*)(const float*, const float*, const float*,
                           const float*, float*, float*, float*, int,
                           long long);

EventsFn events_fn(int c, int k) {
#define PICK(C, K) \
    if (c == C && k == K) return events_kernel<C, K>;
    EVENT_PAIRS(PICK)
#undef PICK
    return nullptr;
}

ScratchFn scratch_fn(int c) {
#define PICK(C) \
    if (c == C) return scratch_kernel<C>;
    SCRATCH_CHUNKS(PICK)
#undef PICK
    return nullptr;
}

// B9's dynamic shared bytes a block of ``threads``
int scratch_bytes(int c, int k, int threads) {
    return scratch_entries(c, k) * kEventFloats * (int)sizeof(float) *
           threads;
}

// the kernel an entry launches (which = 0 B7, 1 B8 at (c, k), 2 B9 at c)
const void* kernel_of(int which, int c, int k) {
    if (which == 0) return (const void*)fold_chunk_kernel;
    if (which == 1) return (const void*)events_fn(c, k);
    if (which == 2) return (const void*)scratch_fn(c);
    return nullptr;
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

extern "C" int events_fold_chunk(const float* rgba, const float* t0,
                                 const float* t1, const float* thr,
                                 float* color, float* depth, float* small,
                                 int c, int k, int h, int w,
                                 cudaStream_t stream) {
    const EventsFn fn = events_fn(c, k);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    const long long hw = (long long)h * w;
    const unsigned blocks =
        (unsigned)((hw + kEventThreads - 1) / kEventThreads);
    fn<<<blocks, kEventThreads, 0, stream>>>(rgba, t0, t1, thr, color, depth,
                                             small, hw);
    return (int)cudaGetLastError();
}

// ``threads`` (a multiple of 32, at most kThreads) is the block, from the
// wrapper (fold_microbench.scratch_block); 24 min(C, K - 1) bytes of
// shared memory a thread.
extern "C" int scratch_fold_chunk(const float* rgba, const float* t0,
                                  const float* t1, const float* thr,
                                  float* color, float* depth, float* small,
                                  int c, int k, int h, int w, int threads,
                                  cudaStream_t stream) {
    const ScratchFn fn = scratch_fn(c);
    if (fn == nullptr || threads < 32 || threads % 32 ||
        threads > kThreads) {
        return (int)cudaErrorInvalidValue;
    }
    const int bytes = scratch_bytes(c, k, threads);
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const long long hw = (long long)h * w;
    const unsigned blocks = (unsigned)((hw + threads - 1) / threads);
    fn<<<blocks, threads, bytes, stream>>>(rgba, t0, t1, thr, color, depth,
                                           small, k, hw);
    return (int)cudaGetLastError();
}

// Registers, local-memory bytes (spills) and the largest block of the
// kernel that an entry launches: which = 0 B7, 1 B8 at (c, k), 2 B9 at c.
// out: int[3].
extern "C" int fold_chunk_attributes(int which, int c, int k, int* out) {
    const void* fn = kernel_of(which, c, k);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = attr.maxThreadsPerBlock;
    return 0;
}

// The launch of an entry as it runs: which = 0 B7, 1 B8 at (c, k), 2 B9
// at (c, k) given ``threads`` as its entry is (B7 and B8 take their own
// block).
// out int[6] = registers a thread, local-memory bytes a thread, shared
// bytes a block (static and dynamic), resident blocks an SM, threads a
// block, and the close events a thread holds (B7: 0, it holds none).
extern "C" int fold_chunk_occupancy(int which, int c, int k, int threads,
                                    int* out) {
    const void* fn = kernel_of(which, c, k);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    int nt = kThreads, dyn = 0, held = 0;
    if (which == 1) {
        nt = kEventThreads;
        held = scratch_entries(c, k);
    } else if (which == 2) {
        if (threads < 32 || threads % 32 || threads > kThreads)
            return (int)cudaErrorInvalidValue;
        nt = threads;
        held = scratch_entries(c, k);
        dyn = scratch_bytes(c, k, nt);
        const cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
        if (e != cudaSuccess) return (int)e;
    }
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    int bps = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, nt, dyn);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes + dyn;
    out[3] = bps;
    out[4] = nt;
    out[5] = held;
    return 0;
}

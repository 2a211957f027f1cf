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
// ~30 flops per slice. B8 and B9 move more than that by design: their
// phase 2 reads and writes every slot's 6 rows each chunk, as the TPU
// kernels did.
//
// Design. One thread per pixel, neighbouring threads on neighbouring x so
// every [., H, W] plane access coalesces. The 12-float machine (open
// segment rgba, start, end, prev rgb, open, prev empty, next slot k)
// lives in registers over the C slices and is written back once per
// chunk (struct Machine: decide() is the slice's close and start
// predicates, advance() the state update after the close). B7 writes a
// closing slot's colour and depth rows when the close happens (a slot
// closes at most once per march, so this is the reference's merge with no
// record buffer). B8 keeps the reference's schedule: phase 1 records each
// slice's close event (slot or -1, rgba, start, end: 7 floats) in
// registers, 7 x C of them, fully unrolled with C and K as template
// parameters; phase 2, unrolled over K x C, adds each slot's masked events
// into its colour row (+ is a select: at most one event hits a slot, the
// others add 0) and picks the depths with where(hit). At C = 16 that is
// 112 live event floats beside the machine: what the variant measures is
// whether they stay in registers or spill to local memory. B9 writes the
// events to dynamic shared memory laid out [C][7][threads] (a warp's
// accesses are consecutive), 28 C bytes a thread, so the block size is
// derived from C by the wrapper (256 threads up to C = 32, within the
// 227 KB a block may opt in to); its slice loop is rolled, so neither
// the events nor the inputs are held in registers, and its phase 2 is a
// rolled loop over K that reads the C events back. Predicates,
// merge-overflow (close only while k < K-1) and the accumulation
// seg + (1 - seg.a) * rgba are supersegments.push's; the rgb distance is written as
// sqrt(d0*d0 + d1*d1 + d2*d2) and the library is built without FMA
// contraction, so closes and counts equal the plain versions' exactly and
// B7, B8 and B9 agree bit for bit.
//
// State layout (updated in place): color f32[K,4,H,W], depth f32[K,2,H,W]
// (start, end; +inf until written), small f32[12,H,W] = seg rgba (0-3),
// seg start (4), seg end (5), prev rgb (6-8), open (9), prev empty (10),
// k (11), flags and k f32-encoded; count i32[H,W] or NULL (B7 only).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEmptyAlpha = 1e-4f;   // supersegments.EMPTY_ALPHA
constexpr int kThreads = 256;
constexpr int kEventFloats = 7;        // slot, rgba, start, end

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

// Phase 1 of B8 and B9: slice s of the chunk through the machine, its
// close event as the reference records it (slot = k at the close, else
// -1; the closing segment's rgba, start and end, else 0).
__device__ __forceinline__ void record_event(Machine& m, const Slice& x,
                                             float th, float klast,
                                             float* ev, int stride) {
    bool starts;
    const bool close = m.decide(x.r, x.g, x.b, x.a, x.ta, th, klast, -1.0f,
                                &starts);
    ev[0] = close ? m.kc : -1.0f;
    ev[stride] = close ? m.sr : 0.0f;
    ev[2 * stride] = close ? m.sg : 0.0f;
    ev[3 * stride] = close ? m.sb : 0.0f;
    ev[4 * stride] = close ? m.sa : 0.0f;
    ev[5 * stride] = close ? m.s_start : 0.0f;
    ev[6 * stride] = close ? m.s_end : 0.0f;
    m.advance(close, x.r, x.g, x.b, x.a, x.ta, x.tb);
}

// Phase 2 for one slot: colour rows += the masked events, depths
// where(hit, the events' start/end, as they were).
__device__ __forceinline__ void write_slot(float* color, float* depth,
                                           int kk, long long hw, long long p,
                                           bool hit, const float* acc) {
    float* oc = color + (long long)kk * 4 * hw + p;
    oc[0] = oc[0] + acc[0];
    oc[hw] = oc[hw] + acc[1];
    oc[2 * hw] = oc[2 * hw] + acc[2];
    oc[3 * hw] = oc[3 * hw] + acc[3];
    float* od = depth + (long long)kk * 2 * hw + p;
    od[0] = hit ? acc[4] : od[0];
    od[hw] = hit ? acc[5] : od[hw];
}

template <int C, int K>
__global__ void __launch_bounds__(kThreads)
events_kernel(const float* __restrict__ rgba, const float* __restrict__ t0,
              const float* __restrict__ t1, const float* __restrict__ thr,
              float* __restrict__ color, float* __restrict__ depth,
              float* __restrict__ small, long long hw) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;

    Machine m;
    m.load(small, hw, p);
    const float th = thr[p];
    float ev[C][kEventFloats];                 // registers, or spilled
#pragma unroll
    for (int s = 0; s < C; ++s)
        record_event(m, load_slice(rgba, t0, t1, s, hw, p), th,
                     (float)(K - 1), ev[s], 1);
    m.store(small, hw, p);

#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
        bool hit = false;
        float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < C; ++s) {
            const bool m_s = ev[s][0] == (float)kk;
            const float mf = m_s ? 1.0f : 0.0f;
            hit = hit || m_s;
#pragma unroll
            for (int j = 0; j < 6; ++j) acc[j] = acc[j] + ev[s][1 + j] * mf;
        }
        write_slot(color, depth, kk, hw, p, hit, acc);
    }
}

template <int C>
__global__ void scratch_kernel(const float* __restrict__ rgba,
                               const float* __restrict__ t0,
                               const float* __restrict__ t1,
                               const float* __restrict__ thr,
                               float* __restrict__ color,
                               float* __restrict__ depth,
                               float* __restrict__ small, int k,
                               long long hw) {
    extern __shared__ float scratch[];         // [C][7][blockDim.x]
    const int nt = blockDim.x;
    const long long p = (long long)blockIdx.x * nt + threadIdx.x;
    if (p >= hw) return;                       // no block-wide sync below
    float* mine = scratch + threadIdx.x;

    Machine m;
    m.load(small, hw, p);
    const float th = thr[p];
    // rolled: unrolled, ptxas hoists every slice's loads ahead of the
    // machine and the kernel holds C x 6 inputs in registers (155 at
    // C = 16, 255 and spills at C = 32), which is B8's schedule, not this
    // one's
#pragma unroll 1
    for (int s = 0; s < C; ++s)
        record_event(m, load_slice(rgba, t0, t1, s, hw, p), th,
                     (float)(k - 1), mine + s * kEventFloats * nt, nt);
    m.store(small, hw, p);

#pragma unroll 1
    for (int kk = 0; kk < k; ++kk) {
        bool hit = false;
        float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int s = 0; s < C; ++s) {
            const float* ev = mine + s * kEventFloats * nt;
            const bool m_s = ev[0] == (float)kk;
            const float mf = m_s ? 1.0f : 0.0f;
            hit = hit || m_s;
#pragma unroll
            for (int j = 0; j < 6; ++j)
                acc[j] = acc[j] + ev[(1 + j) * nt] * mf;
        }
        write_slot(color, depth, kk, hw, p, hit, acc);
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

int fill_attributes(const void* fn, int* out) {
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = attr.maxThreadsPerBlock;
    return 0;
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
    const unsigned blocks = (unsigned)((hw + kThreads - 1) / kThreads);
    fn<<<blocks, kThreads, 0, stream>>>(rgba, t0, t1, thr, color, depth,
                                        small, hw);
    return (int)cudaGetLastError();
}

// ``threads`` (a multiple of 32) comes from the wrapper, which derives it
// from C: 28 C bytes of shared memory a thread.
extern "C" int scratch_fold_chunk(const float* rgba, const float* t0,
                                  const float* t1, const float* thr,
                                  float* color, float* depth, float* small,
                                  int c, int k, int h, int w, int threads,
                                  cudaStream_t stream) {
    const ScratchFn fn = scratch_fn(c);
    if (fn == nullptr || threads < 32 || threads % 32) {
        return (int)cudaErrorInvalidValue;
    }
    const int bytes = c * kEventFloats * (int)sizeof(float) * threads;
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
    if (which == 0) return fill_attributes((const void*)fold_chunk_kernel,
                                           out);
    if (which == 1) return fill_attributes((const void*)events_fn(c, k), out);
    if (which == 2) return fill_attributes((const void*)scratch_fn(c), out);
    return (int)cudaErrorInvalidValue;
}

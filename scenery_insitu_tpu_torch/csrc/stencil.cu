// K3 — T fused Gray-Scott steps (6-point Laplacian, periodic in z, y and x)
// in one pass over the grid, streaming through z.
//
// Replaces the TPU kernels scenery_insitu_tpu/sim/pallas_stencil.py,
// step_pallas2d (kernel body _kernel2d, (tz, th, W) blocks) and
// step_pallas (kernel body _kernel, (tz, H, W) slabs): both compute the
// same function, and this one kernel is the counterpart of both. Plain
// version and oracle: grayscott.step applied T times (the roll
// formulation), run by sim/cuda_stencil.py::step_fused_plain.
//
// What bounds it on the H100: bytes, then instructions. Per T steps the
// least device-memory traffic is one read and one write of u and v (16
// bytes a cell, 0.641 ms at 512^3 and 3.35 TB/s); the arithmetic is 29
// f32 operations a cell a step, issued one by one (the library is built
// without FMA contraction so that it rounds as the plain version does).
// A pass that keeps the T time levels on chip therefore has to spend few
// instructions besides those on each cell and level it computes, and
// compute few cells besides those it stores. At T = 4 this pass is bound
// by instruction issue, at T = 1, 2 it comes near the bytes.
//
// Design: 2.5-D blocking with a wavefront in time (z-streaming).
// - A block of 8 warps owns an xy tile of kTileX x kTileY = 32 x 32
//   columns, the core (32 - 2T) x (32 - 2T) plus a halo of T on each side
//   in x and y, and a segment of seg_z(T) planes in z (128 for T = 3, 4;
//   64 for T = 1, 2). It walks z once, over the seg_z + 2T input planes
//   its segment needs: a warm-up of 2T planes, not a halo on every tile.
// - One column a lane: a warp spans the tile's 32 columns, so the x
//   neighbours are warp shuffles; each thread holds kRY = 4 consecutive
//   rows of its column, so the y neighbours are its own registers except
//   at the ends of its strip, which come from the neighbouring warps
//   through a small double-buffered exchange in shared memory (rows 0
//   and kRY-1 of every level's newest plane). No thread indexes a tile:
//   no division or modulo runs per cell.
// - Wavefront: in iteration j the block takes input plane p = z0 - T + j
//   and computes level s of plane p - s for s = 1..T, from level s-1's
//   planes p-s-1, p-s (kept in registers from earlier iterations) and
//   p-s+1 (just made). Each level keeps two planes a thread in registers
//   (16 a cell at T = 4: the register file, not shared memory, sets the
//   tile); level T's plane is stored as soon as it is made, once the 2T
//   warm-up iterations are over. One __syncthreads an iteration. The walk
//   is unrolled 3 times at T = 3, 4, which lets the compiler rotate the
//   planes' registers instead of moving them.
// - Loads ahead of use: each thread copies its own cells of input plane
//   p + kStages - 1 into a shared-memory ring with cp.async (4-byte
//   copies; a warp's row is 128 contiguous bytes), kStages - 1 = 3 planes
//   in flight while it computes; it reads back only its own cells, so the
//   ring needs no barrier. The periodic wrap is computed once a thread
//   (its column and row offsets) and once a plane: any grid runs, also
//   one smaller than the halo (an index wraps more than once).
// - Occupancy: 256 threads, at most 128 registers and 40-64 KB of shared
//   memory a block, so two blocks (16 warps) reside on an SM.
// - Arithmetic: grayscott.step operation for operation (neighbour sum
//   z-1, z+1, y-1, y+1, x-1, x+1 then - 6c; uvv = (u v) v; the same
//   association of the rate terms), so the result equals the plain
//   version bit for bit.
//
// Bytes at T = 4 (core 24 x 24): each block reads (32 x 32) / (24 x 24)
// = 1.78x its cells, times (1 + 2T / 128) = 1.06 for the warm-up, and
// writes its core once: 8 B x 1.89 + 8 B = 23 B a cell against the
// bound's 16 if no halo were shared through L2 (0.92 ms at 3.35 TB/s).
// Neighbouring blocks run together and read the same halo rows, so much
// of the halo can hit L2. Instructions at T = 4: levels 1..T run on the
// whole 32 x 32 tile, 4 x 1024 / 576 = 7.1 cell-levels a stored cell,
// each 29 f32 operations and 4 shuffles plus its share of the strip
// ends' exchange, the loads, stores and loop; at T = 4 that, not the
// bytes, sets the pass's time. The trade of the segment length: seg_z
// planes cost 2T extra reads and cell-levels, and give ceil(D / seg_z)
// times as many blocks (22 x 22 x 4 = 1,936 at 512^3, T = 4).
//
// The entry grayscott_fused_ranges is the same pass with the occupancy
// epilogue of the TPU kernels' with_ranges variant (pallas_stencil.py,
// _kernel and _kernel2d with with_ranges=True, the rows' (1, 1) SMEM
// outputs): the min and max of the updated v per brick of the caller's
// (nzb, nyb) grid, brick (i, j) = z in [i*D/nzb, (i+1)*D/nzb) x y in
// [j*H/nyb, (j+1)*H/nyb) x all x. The TPU kernel reduced at its own
// block granularity and remapped onto the brick grid afterwards
// (occupancy.remap_ranges), which only contains the true ranges; this
// one folds every stored v straight into its brick, so lo/hi equal
// occupancy.field_ranges of the output bit for bit. Each thread keeps a
// running min/max of each of its rows in registers (two instructions a
// stored cell). When the z walk leaves a z-brick, or the segment ends,
// each warp merges its rows of one y-brick, reduces each row across the
// warp (a warp's row lies in one brick) and makes one atomic pair a
// brick, lanes 2r and 2r + 1 for row r. That flush is straight-line code
// in which every lane runs every shuffle: in trials, a flush that skipped
// the non-core rows by branching, or kept more registers (each row's
// brick, a running z-brick index), slowed the unrolled walk more than
// the rest of B4b together. Float min/max go through the integer atomics
// on the ordered bit pattern (sign bit clear: signed compare; set:
// unsigned compare reversed), so the +inf / -inf seeds the wrapper writes
// before each launch and slightly negative v both order correctly.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxT = 4;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRY = 4;                   // rows a thread holds
constexpr int kTileX = 32;               // one column a lane
constexpr int kTileY = kWarps * kRY;
constexpr int kStages = 4;               // cp.async ring, kStages-1 ahead
constexpr int kMinBlocks = 2;            // resident blocks an SM
constexpr unsigned kFull = 0xffffffffu;

// planes of a block's z segment, and the unrolling of its walk: the
// longer segment halves the warm-up where T = 3, 4 make it dear (2T
// planes of all T levels); T = 1, 2 keep more, shorter blocks in flight,
// and their walk rolled
__host__ __device__ constexpr int seg_z(int t) { return t >= 3 ? 128 : 64; }
__host__ __device__ constexpr int unroll_z(int t) { return t >= 3 ? 3 : 1; }

// dynamic shared memory of the pass for T steps, in floats: the input
// ring [kStages][u, v][kRY][kThreads] and the strip ends' exchange
// [2 parities][T levels][u, v][top, bottom][kThreads]
__host__ __device__ constexpr int ring_floats() {
    return kStages * 2 * kRY * kThreads;
}
__host__ __device__ constexpr int smem_floats(int t) {
    return ring_floats() + 2 * t * 2 * 2 * kThreads;
}

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void atomic_min_float(float* a, float x) {
    if (__float_as_int(x) >= 0)
        atomicMin(reinterpret_cast<int*>(a), __float_as_int(x));
    else
        atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(x));
}

__device__ __forceinline__ void atomic_max_float(float* a, float x) {
    if (__float_as_int(x) >= 0)
        atomicMax(reinterpret_cast<int*>(a), __float_as_int(x));
    else
        atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(x));
}

// The rows' ranges into their bricks, as straight-line code: every lane
// runs every shuffle, so the branch that calls it needs no reconvergence.
// Rows of one y-brick are merged into the later row by selects; each
// row's min and max are reduced across the warp, and lanes 2r and 2r + 1
// make row r's atomic pair, where it is a core row in the grid and not
// merged. b0 = the z-brick's first brick index, y = row 0's y, bys = a
// brick's rows.
__device__ __forceinline__ void flush_ranges(float (&rlo)[kRY],
                                             float (&rhi)[kRY],
                                             const bool (&rowok)[kRY],
                                             float* lo, float* hi, int b0,
                                             int y, int bys) {
    int yb[kRY];
    float vlo[kRY], vhi[kRY];
    bool emit[kRY];
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
        yb[r] = max(y + r, 0) / bys;
        vlo[r] = rlo[r];
        vhi[r] = rhi[r];
        rlo[r] = INFINITY;
        rhi[r] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
        // a non-core row's pair is +inf / -inf: it merges as identity
        const int rn = r + 1 < kRY ? r + 1 : r;
        const bool merge = rn != r && rowok[rn] && yb[r] == yb[rn];
        vlo[rn] = merge ? fminf(vlo[rn], vlo[r]) : vlo[rn];
        vhi[rn] = merge ? fmaxf(vhi[rn], vhi[r]) : vhi[rn];
        emit[r] = rowok[r] && !merge;
    }
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            vlo[r] = fminf(vlo[r], __shfl_xor_sync(kFull, vlo[r], o));
            vhi[r] = fmaxf(vhi[r], __shfl_xor_sync(kFull, vhi[r], o));
        }
    }
    const int lane = threadIdx.x & 31, lr = lane >> 1;
    float x = vlo[0];
    bool e = emit[0];
    int b = yb[0];
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
        if (lr == r) {
            x = lane & 1 ? vhi[r] : vlo[r];
            e = emit[r];
            b = yb[r];
        }
    }
    if (lane < 2 * kRY && e) {
        if (lane & 1)
            atomic_max_float(hi + b0 + b, x);
        else
            atomic_min_float(lo + b0 + b, x);
    }
}

struct Rates {
    float f, fk, du, dv, dt;
};

// one step of one cell: grayscott.step's operations in its order
__device__ __forceinline__ void gs_cell(const Rates& p, float uc, float vc,
                                        float uzm, float uzp, float uym,
                                        float uyp, float uxm, float uxp,
                                        float vzm, float vzp, float vym,
                                        float vyp, float vxm, float vxp,
                                        float& un, float& vn) {
    const float lu = uzm + uzp + uym + uyp + uxm + uxp - 6.0f * uc;
    const float lv = vzm + vzp + vym + vyp + vxm + vxp - 6.0f * vc;
    const float uvv = uc * vc * vc;
    const float dudt = p.du * lu - uvv + p.f * (1.0f - uc);
    const float dvdt = p.dv * lv + uvv - p.fk * vc;
    un = uc + p.dt * dudt;
    vn = vc + p.dt * dvdt;
}

template <int T, bool kRanges>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grayscott_stream_kernel(const float* __restrict__ u,
                        const float* __restrict__ v,
                        const float* __restrict__ params,
                        float* __restrict__ uo, float* __restrict__ vo,
                        float* __restrict__ lo, float* __restrict__ hi,
                        int d, int h, int w, int nzb, int nyb) {
    constexpr int kCX = kTileX - 2 * T, kCY = kTileY - 2 * T;
    constexpr int kSlot = 2 * kRY * kThreads;     // one plane of the ring
    constexpr int kLevel = 2 * 2 * kThreads;      // one level's exchange
    static_assert((kStages & (kStages - 1)) == 0, "ring slots: power of 2");
    extern __shared__ float sm[];
    float* const ring = sm;
    float* const xch = sm + ring_floats();

    const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
    const Rates p = {params[0], params[0] + params[1], params[2], params[3],
                     params[4]};
    const int x0 = blockIdx.x * kCX, y0 = blockIdx.y * kCY;
    const int za = blockIdx.z * seg_z(T), zb = min(za + seg_z(T), d);
    const int n = zb - za + 2 * T;                // input planes to walk
    const long long hw = (long long)h * w;

    // the wrap, once: this thread's column and its rows' offsets in a plane
    const int gx = wrap(x0 - T + lane, w);
    int roff[kRY];
    bool rowok[kRY];                               // a core row in the grid
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
        const int y = wp * kRY + r;
        roff[r] = wrap(y0 - T + y, h) * w + gx;
        rowok[r] = y >= T && y < kTileY - T && y0 + y - T < h;
    }
    const bool colok = lane >= T && lane < kTileX - T && x0 + lane - T < w;
    // neighbouring warps' strip ends (a tile edge reads its own: halo)
    const int above = (wp > 0 ? wp - 1 : wp) * 32 + lane;
    const int below = (wp < kWarps - 1 ? wp + 1 : wp) * 32 + lane;

    // the next input plane to copy, and once a plane its wrap
    int zi = wrap(za - T, d), ni = 0;
    const float* ug = u + zi * hw;
    const float* vg = v + zi * hw;
    auto issue = [&]() {
        if (ni < n) {
            float* slot = ring + (ni & (kStages - 1)) * kSlot + tid;
#pragma unroll
            for (int r = 0; r < kRY; ++r) {
                cp_async4(slot + r * kThreads, ug + roff[r]);
                cp_async4(slot + (kRY + r) * kThreads, vg + roff[r]);
            }
            ++ni;
            if (++zi == d) {
                zi = 0;
                ug = u;
                vg = v;
            } else {
                ug += hw;
                vg += hw;
            }
        }
        cp_async_commit();
    };

    // level l's planes z-1 (pu, pv) and z (cu, cv) of this thread's rows
    float pu[T][kRY], pv[T][kRY], cu[T][kRY], cv[T][kRY];
#pragma unroll
    for (int l = 0; l < T; ++l)
#pragma unroll
        for (int r = 0; r < kRY; ++r)
            pu[l][r] = pv[l][r] = cu[l][r] = cv[l][r] = 0.0f;

    // the output plane q = za + j - 2T
    float* uq = uo + za * hw;
    float* vq = vo + za * hw;
    // B4b: the running min/max of each row's stored v in the current
    // z-brick, and the iteration after which the walk leaves that brick
    float rlo[kRY], rhi[kRY];
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
        rlo[r] = INFINITY;
        rhi[r] = -INFINITY;
    }
    const int bzs = kRanges ? d / nzb : 1;
    int jflush = kRanges ? min(n, (za / bzs + 1) * bzs - za + 2 * T) : n;

#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) issue();

#pragma unroll (unroll_z(T))
    for (int j = 0; j < n; ++j) {
        issue();
        cp_async_wait<kStages - 1>();                 // plane j has landed
        float* const xw = xch + (j & 1) * (T * kLevel) + tid;
        const float* const xr = xch + ((j & 1) ^ 1) * (T * kLevel);
        const float* const xa = xr + above;
        const float* const xb = xr + below;
        const float* const rs = ring + (j & (kStages - 1)) * kSlot + tid;

        // level 0's new plane: input plane za - T + j
        float nu[kRY], nv[kRY];
#pragma unroll
        for (int r = 0; r < kRY; ++r) {
            nu[r] = rs[r * kThreads];
            nv[r] = rs[(kRY + r) * kThreads];
        }
#pragma unroll
        for (int s = 0; s <= T; ++s) {
            if (s > 0) {
                // level s of plane za - T + j - s from level l = s - 1
                const int l = s - 1;
                const float uup = xa[l * kLevel + 1 * kThreads];
                const float vup = xa[l * kLevel + 3 * kThreads];
                const float udn = xb[l * kLevel + 0 * kThreads];
                const float vdn = xb[l * kLevel + 2 * kThreads];
                float ou[kRY], ov[kRY];
#pragma unroll
                for (int r = 0; r < kRY; ++r) {
                    const float uc = cu[l][r], vc = cv[l][r];
                    const float uxm = __shfl_up_sync(kFull, uc, 1);
                    const float uxp = __shfl_down_sync(kFull, uc, 1);
                    const float vxm = __shfl_up_sync(kFull, vc, 1);
                    const float vxp = __shfl_down_sync(kFull, vc, 1);
                    const float uym = r > 0 ? cu[l][r - 1] : uup;
                    const float vym = r > 0 ? cv[l][r - 1] : vup;
                    const float uyp = r < kRY - 1 ? cu[l][r + 1] : udn;
                    const float vyp = r < kRY - 1 ? cv[l][r + 1] : vdn;
                    gs_cell(p, uc, vc, pu[l][r], nu[r], uym, uyp, uxm, uxp,
                            pv[l][r], nv[r], vym, vyp, vxm, vxp, ou[r],
                            ov[r]);
                }
#pragma unroll
                for (int r = 0; r < kRY; ++r) {
                    pu[l][r] = cu[l][r];
                    pv[l][r] = cv[l][r];
                    cu[l][r] = nu[r];
                    cv[l][r] = nv[r];
                    nu[r] = ou[r];
                    nv[r] = ov[r];
                }
            }
            if (s < T) {
                // the strip ends of level s's new plane, read next
                // iteration by the warps above and below
                float* const xs = xw + s * kLevel;
                xs[0 * kThreads] = nu[0];
                xs[1 * kThreads] = nu[kRY - 1];
                xs[2 * kThreads] = nv[0];
                xs[3 * kThreads] = nv[kRY - 1];
            }
        }

        if (j >= 2 * T) {
            // level T of plane q = za + j - 2T, valid on the core
#pragma unroll
            for (int r = 0; r < kRY; ++r) {
                if (rowok[r] && colok) {
                    uq[roff[r]] = nu[r];
                    vq[roff[r]] = nv[r];
                    if (kRanges) {
                        rlo[r] = fminf(rlo[r], nv[r]);
                        rhi[r] = fmaxf(rhi[r], nv[r]);
                    }
                }
            }
            uq += hw;
            vq += hw;
            if (kRanges && j + 1 == jflush) {
                // the walk leaves z-brick (za + j - 2T) / bzs (or its
                // segment ends): one atomic pair for each brick this
                // warp's rows touch
                const int b0 = ((za + j - 2 * T) / bzs) * nyb;
                flush_ranges(rlo, rhi, rowok, lo, hi, b0, y0 + wp * kRY - T,
                             h / nyb);
                jflush = min(n, jflush + bzs);
            }
        }
        __syncthreads();
    }
}

template <int T, bool kRanges>
const void* kernel_fn() {
    return (const void*)grayscott_stream_kernel<T, kRanges>;
}

template <bool kRanges>
const void* pick(int t) {
    switch (t) {
        case 1: return kernel_fn<1, kRanges>();
        case 2: return kernel_fn<2, kRanges>();
        case 3: return kernel_fn<3, kRanges>();
        case 4: return kernel_fn<4, kRanges>();
        default: return nullptr;
    }
}

size_t smem_bytes(int t) { return sizeof(float) * smem_floats(t); }

template <bool kRanges>
int launch_fused(const float* u, const float* v, const float* params,
                 float* uo, float* vo, float* lo, float* hi, int d, int h,
                 int w, int t, int nzb, int nyb, cudaStream_t stream) {
    if (t < 1 || t > kMaxT || d < 1 || h < 1 || w < 1)
        return (int)cudaErrorInvalidValue;
    if (kRanges && (nzb < 1 || nyb < 1 || d % nzb || h % nyb))
        return (int)cudaErrorInvalidValue;
    const void* fn = pick<kRanges>(t);
    const size_t smem = smem_bytes(t);
    // the shared-memory limit is a per-device attribute, so it is raised
    // on every call (cheap) rather than once per process
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int cx = kTileX - 2 * t, cy = kTileY - 2 * t;
    const dim3 grid((w + cx - 1) / cx, (h + cy - 1) / cy,
                    (d + seg_z(t) - 1) / seg_z(t));
    void* args[] = {(void*)&u,  (void*)&v,  (void*)&params, (void*)&uo,
                    (void*)&vo, (void*)&lo, (void*)&hi,     (void*)&d,
                    (void*)&h,  (void*)&w,  (void*)&nzb,    (void*)&nyb};
    e = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <bool kRanges>
int fill_attributes(int t, int* out) {
    const void* fn = pick<kRanges>(t);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(t);
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)(a.sharedSizeBytes + smem);
    out[3] = blocks;
    out[4] = kThreads;
    out[5] = kTileX - 2 * t;
    out[6] = kTileY - 2 * t;
    out[7] = seg_z(t);
    return 0;
}

}  // namespace

extern "C" int grayscott_fused(const float* u, const float* v,
                               const float* params, float* uo, float* vo,
                               int d, int h, int w, int t,
                               cudaStream_t stream) {
    return launch_fused<false>(u, v, params, uo, vo, nullptr, nullptr, d, h,
                               w, t, 1, 1, stream);
}

// lo, hi f32[nzb, nyb], seeded +inf / -inf by the caller
extern "C" int grayscott_fused_ranges(const float* u, const float* v,
                                      const float* params, float* uo,
                                      float* vo, float* lo, float* hi,
                                      int d, int h, int w, int t, int nzb,
                                      int nyb, cudaStream_t stream) {
    return launch_fused<true>(u, v, params, uo, vo, lo, hi, d, h, w, t, nzb,
                              nyb, stream);
}

// the build of K3 (ranges 0) or B4b (ranges 1) for T = t: out int[8] =
// registers a thread, local-memory bytes a thread, shared bytes a block
// (static and dynamic), resident blocks an SM, threads a block, and the
// core's x and y extent and the z segment's length in cells
extern "C" int stencil_attributes(int t, int ranges, int* out) {
    return ranges ? fill_attributes<true>(t, out)
                  : fill_attributes<false>(t, out);
}

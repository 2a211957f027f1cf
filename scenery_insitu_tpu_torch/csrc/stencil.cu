// K3 — T fused Gray-Scott steps (6-point Laplacian, periodic in z, y and x)
// in one pass over the grid.
//
// Replaces the TPU kernels scenery_insitu_tpu/sim/pallas_stencil.py,
// step_pallas2d (kernel body _kernel2d, (tz, th, W) blocks) and
// step_pallas (kernel body _kernel, (tz, H, W) slabs): both compute the
// same function, and this one kernel is the counterpart of both. Plain
// version and oracle: grayscott.step applied T times (the roll
// formulation), run by sim/cuda_stencil.py::step_fused_plain.
//
// What bounds it on the H100: bytes. Per T steps the least traffic is one
// read and one write of u and v (16 bytes a cell); the arithmetic is ~30
// flops a cell a step. Running the T steps out of shared memory divides
// the device-memory traffic of T single steps by about T, at the price
// of re-reading a T-wide halo.
//
// Design. A block owns a kTZ x kTY x kTX core of the grid and loads the
// (kTZ+2T) x (kTY+2T) x (kTX+2T) haloed tile of u and v into shared
// memory; the periodic wrap is done by modular global indices, and a
// ragged edge (a grid the core does not divide) loads the periodic
// continuation and masks the store, so any grid size runs. The T steps
// then run in shared memory with the valid region shrinking by one cell
// per step on every side, and the block writes its core. Two full copies
// of the tile per field do not fit next to each other, so each step
// sweeps the tile plane by plane in z and updates it in place: the new
// values of plane z go to a one-plane buffer, and before plane z is
// overwritten its old values are saved in a second one-plane buffer,
// which is the z-1 neighbour of the next plane. At T = 4 the two fields
// take 2 x (24*24*40 + 2*24*40) floats = 199,680 bytes of the 232,448 a
// block may use. The arithmetic repeats grayscott.step operation for
// operation (same association; the library is built without FMA
// contraction), so the result equals the plain version's.

// The entry grayscott_fused_ranges is the same pass with the occupancy
// epilogue of the TPU kernels' with_ranges variant (pallas_stencil.py,
// _kernel and _kernel2d with with_ranges=True, the rows' (1, 1) SMEM
// outputs): the min and max of the updated v per brick of the caller's
// (nzb, nyb) grid, brick (i, j) = z in [i*D/nzb, (i+1)*D/nzb) x y in
// [j*H/nyb, (j+1)*H/nyb) x all x. The TPU kernel reduced at its own
// block granularity and remapped onto the brick grid afterwards
// (occupancy.remap_ranges), which only contains the true ranges; this
// one folds every stored v straight into its brick, so lo/hi equal
// occupancy.field_ranges of the output bit for bit. It moves no more
// device-memory bytes than K3 (a few atomics a block): after the store,
// the block reads its core back from shared memory. When the core lies
// inside one brick (every block at 512^3 with the default (32, 16)
// bricks of 16 x 32 x 512 cells), the block reduces it and makes one
// atomic pair; otherwise each warp, which covers one x run of one (z, y)
// row, reduces its row and makes one atomic pair into that row's brick. Float min/max go
// through the integer atomics on the ordered bit pattern (sign bit
// clear: signed compare; set: unsigned compare reversed), so the +inf /
// -inf seeds the wrapper writes before each launch and slightly
// negative v both order correctly.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTZ = 16, kTY = 16, kTX = 32;
constexpr int kMaxT = 4;
constexpr int kThreads = 512;
// thread i holds (cy, cx) = (i / kTX, i % kTX) at every cz of the core,
// so a warp covers one x run of one (z, y) row
static_assert(kThreads == kTY * kTX && kTX == 32,
              "a warp must store one row of the core");

__host__ __device__ constexpr int tile_floats(int t) {
    // per field: the haloed tile + the saved plane + the new plane
    return (kTZ + 2 * t) * (kTY + 2 * t) * (kTX + 2 * t)
           + 2 * (kTY + 2 * t) * (kTX + 2 * t);
}

constexpr size_t kMaxSmem = 2 * sizeof(float) * tile_floats(kMaxT);

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
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

__device__ __forceinline__ void warp_min_max(float& lo, float& hi) {
    for (int o = 16; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
}

// The ranges of the block's core, read back from the tile in shared
// memory (vs, the core at offset t on each axis). Not inlined, so the
// kernel's own body compiles as K3's does: folding the reduction into
// the store loop took ptxas from 58 registers to 40 and the pass from
// 12.2 to 13.5 ms at 512^3, T = 4 (NVIDIA H100 80GB HBM3, 700 W).
__device__ __noinline__ void ranges_epilogue(const float* vs, float* lo,
                                             float* hi, int d, int h, int w,
                                             int t, int nzb, int nyb) {
    const int yp = kTY + 2 * t, xp = kTX + 2 * t;
    const int bz = d / nzb, by = h / nyb;
    const int cz0 = blockIdx.z * kTZ, cy0 = blockIdx.y * kTY;
    const int tid = threadIdx.x;
    const int core = kTZ * kTY * kTX;
    // is the core's last cell in the grid in the brick of its first?
    const bool one_brick = cz0 / bz == (min(cz0 + kTZ, d) - 1) / bz
                           && cy0 / by == (min(cy0 + kTY, h) - 1) / by;
    float vlo = INFINITY, vhi = -INFINITY;
    for (int i = tid; i < core; i += kThreads) {
        const int cz = i / (kTY * kTX), r = i - cz * (kTY * kTX);
        const int cy = r / kTX, cx = r - cy * kTX;
        const int gz = cz0 + cz, gy = cy0 + cy, gx = blockIdx.x * kTX + cx;
        if (gz >= d || gy >= h) continue;     // the same for the whole warp
        if (gx < w) {
            const float x = vs[((cz + t) * yp + (cy + t)) * xp + (cx + t)];
            vlo = fminf(vlo, x);
            vhi = fmaxf(vhi, x);
        }
        if (!one_brick) {
            // the warp's row: one atomic pair into its brick
            warp_min_max(vlo, vhi);
            if ((tid & 31) == 0) {
                const int b = (gz / bz) * nyb + gy / by;
                atomic_min_float(lo + b, vlo);
                atomic_max_float(hi + b, vhi);
            }
            vlo = INFINITY;
            vhi = -INFINITY;
        }
    }
    if (!one_brick) return;
    __shared__ float red[2][kThreads / 32];
    warp_min_max(vlo, vhi);
    if ((tid & 31) == 0) {
        red[0][tid >> 5] = vlo;
        red[1][tid >> 5] = vhi;
    }
    __syncthreads();
    if (tid < 32) {
        vlo = tid < kThreads / 32 ? red[0][tid] : INFINITY;
        vhi = tid < kThreads / 32 ? red[1][tid] : -INFINITY;
        warp_min_max(vlo, vhi);
        if (tid == 0) {
            const int b = (cz0 / bz) * nyb + cy0 / by;
            atomic_min_float(lo + b, vlo);
            atomic_max_float(hi + b, vhi);
        }
    }
}

template <bool kRanges>
__global__ void __launch_bounds__(kThreads)
grayscott_fused_kernel(const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ params,
                       float* __restrict__ uo, float* __restrict__ vo,
                       float* __restrict__ lo, float* __restrict__ hi,
                       int d, int h, int w, int t, int nzb, int nyb) {
    extern __shared__ float sm[];
    const int zp = kTZ + 2 * t, yp = kTY + 2 * t, xp = kTX + 2 * t;
    const int pl = yp * xp;
    const int np = zp * pl;
    float* us = sm;
    float* vs = us + np;
    float* usv = vs + np;      // saved old plane z-1
    float* vsv = usv + pl;
    float* un = vsv + pl;      // new plane z
    float* vn = un + pl;

    const float f = params[0], kk = params[1], du = params[2],
                dv = params[3], dt = params[4];
    const int z0 = blockIdx.z * kTZ - t;
    const int y0 = blockIdx.y * kTY - t;
    const int x0 = blockIdx.x * kTX - t;
    const int tid = threadIdx.x;

    for (int i = tid; i < np; i += kThreads) {
        const int lz = i / pl, r = i - lz * pl;
        const int ly = r / xp, lx = r - ly * xp;
        const long long g =
            ((long long)wrap(z0 + lz, d) * h + wrap(y0 + ly, h)) * w
            + wrap(x0 + lx, w);
        us[i] = u[g];
        vs[i] = v[g];
    }
    __syncthreads();

    for (int s = 1; s <= t; ++s) {
        for (int i = tid; i < pl; i += kThreads) {
            usv[i] = us[(s - 1) * pl + i];
            vsv[i] = vs[(s - 1) * pl + i];
        }
        __syncthreads();
        for (int z = s; z < zp - s; ++z) {
            for (int i = tid; i < pl; i += kThreads) {
                const int ly = i / xp, lx = i - ly * xp;
                if (ly < s || ly >= yp - s || lx < s || lx >= xp - s)
                    continue;
                const int c = z * pl + i;
                const float uc = us[c], vc = vs[c];
                // roll(x,1,0) + roll(x,-1,0) + roll(x,1,1) + roll(x,-1,1)
                // + roll(x,1,2) + roll(x,-1,2) - 6x, in that order
                const float lu = usv[i] + us[c + pl] + us[c - xp]
                                 + us[c + xp] + us[c - 1] + us[c + 1]
                                 - 6.0f * uc;
                const float lv = vsv[i] + vs[c + pl] + vs[c - xp]
                                 + vs[c + xp] + vs[c - 1] + vs[c + 1]
                                 - 6.0f * vc;
                const float uvv = uc * vc * vc;
                const float dudt = du * lu - uvv + f * (1.0f - uc);
                const float dvdt = dv * lv + uvv - (f + kk) * vc;
                un[i] = uc + dt * dudt;
                vn[i] = vc + dt * dvdt;
            }
            __syncthreads();
            for (int i = tid; i < pl; i += kThreads) {
                const int ly = i / xp, lx = i - ly * xp;
                const int c = z * pl + i;
                usv[i] = us[c];
                vsv[i] = vs[c];
                if (ly >= s && ly < yp - s && lx >= s && lx < xp - s) {
                    us[c] = un[i];
                    vs[c] = vn[i];
                }
            }
            __syncthreads();
        }
    }

    const int core = kTZ * kTY * kTX;
    for (int i = tid; i < core; i += kThreads) {
        const int cz = i / (kTY * kTX), r = i - cz * (kTY * kTX);
        const int cy = r / kTX, cx = r - cy * kTX;
        const int gz = blockIdx.z * kTZ + cz, gy = blockIdx.y * kTY + cy,
                  gx = blockIdx.x * kTX + cx;
        if (gz >= d || gy >= h || gx >= w) continue;
        const int c = ((cz + t) * yp + (cy + t)) * xp + (cx + t);
        const long long g = ((long long)gz * h + gy) * w + gx;
        uo[g] = us[c];
        vo[g] = vs[c];
    }
    if (kRanges)
        ranges_epilogue(vs, lo, hi, d, h, w, t, nzb, nyb);
}

template <bool kRanges>
int launch_fused(const float* u, const float* v, const float* params,
                 float* uo, float* vo, float* lo, float* hi, int d, int h,
                 int w, int t, int nzb, int nyb, cudaStream_t stream) {
    if (t < 1 || t > kMaxT) return (int)cudaErrorInvalidValue;
    if (kRanges && (nzb < 1 || nyb < 1 || d % nzb || h % nyb))
        return (int)cudaErrorInvalidValue;
    // the shared-memory limit is a per-device attribute, so it is raised
    // on every call (cheap) rather than once per process
    cudaError_t e = cudaFuncSetAttribute(
        grayscott_fused_kernel<kRanges>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY,
                    (d + kTZ - 1) / kTZ);
    const size_t smem = 2 * sizeof(float) * tile_floats(t);
    grayscott_fused_kernel<kRanges><<<grid, kThreads, smem, stream>>>(
        u, v, params, uo, vo, lo, hi, d, h, w, t, nzb, nyb);
    return (int)cudaGetLastError();
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

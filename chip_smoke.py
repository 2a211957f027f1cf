#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's in-situ frames on one CUDA card: the
single-chip frame, the distributed sort-last frame and the fold
microbenchmark.

    python3 chip_smoke.py               # the whole run (needs one card)
    python3 chip_smoke.py --profile     # + device time by kernel

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions, and the build of every kernel from ``csrc/`` with its wall
   seconds;
2. every kernel against its plain PyTorch version on the card, on seeded
   inputs at the flagship shapes and on real chunks of the frame: K3
   (fused Gray-Scott stencil) at 512^3 for T=4 and T=2, K1 (segmented
   write fold) and K2 (multi-threshold count) at C=16 and C=1, K=16,
   B=16, 640x640; B1b (K1's planes form) equal to K1 bit for bit on the
   frame's chunks and a seeded chunk; B7 (the machine's fold) with and
   without its count on a seeded chunk and the frame's chunks; B5 (shade
   and fold) on the frame's raw value chunks and B6 over the whole raw
   stream, B6 equal to B5 chunk after chunk bit for bit. Each prints
   its largest difference against the stated tolerance, its median time
   from CUDA events, the plain version's time, and its bound (the larger
   of bytes / 3.35 TB/s and operations / 67 TFLOP/s, the H100 SXM's f32
   rate outside the tensor cores);
3. the frame at the flagship size (512^3 Gray-Scott, 10 sim steps a
   frame, K=16, 16 histogram bins, chunk 16, temporal thresholds, the
   eye oscillating within the z march regime): ``init_threshold`` once,
   2 warm-up frames, 6 timed frames, with every kernel's launch count
   read from that run and required > 0; then the sim and the march
   timed apart; then the frame held against the CPU's plain versions on
   a small grid;
3b. the same frame under the folds ``pallas`` (B7), ``pallas_fused``
   (B5) and ``fused_stream`` (B6), each run as phase 3 runs it with the
   launch counts set to 0 before it and read after it (its kernel must
   launch), each VDI against the phase 3 fold's at the same state, eye
   and threshold (PSNR at least 60 dB, with the share of pixels whose
   live slot count differs), and each fold's 32^3 frame against the
   CPU's plain versions;
4. the distributed frame on an 8-rank in-process mesh (the reference's
   8-rank shape; 64 x 512 x 512 slabs, composited into K_out=16 slots
   with a 6-step threshold search): the seed, 2 warm-up and 6 timed
   temporal frames with the launch counts read from that run (K4 once
   per rank and frame); the sim, the march summed over the ranks, the
   column exchange and the composite timed apart; the PSNR against the
   single-chip march at the same state and eye (information); K4 (the
   composite's resegment) against its plain version at the per-rank
   shapes, on a seeded stream and on a real column block of the frame
   (thresholds and live slots exact, colour and depth within 1e-6);
   then the distributed frame on a 32^3 volume over 4 ranks held
   against the CPU's plain versions in both march regimes;
5. the sim-fused occupancy frame: (a) B4b (K3 with the ranges epilogue,
   checked with phase 2's kernels on its state) on the 512^3 state at
   T=4 and T=2 and on ragged grids whose bricks
   straddle K3's blocks (v partly negative on one), its u', v' equal to
   K3's bit for bit and its per-brick ranges equal to its plain
   version's and to ``field_ranges`` of its own v' exactly, timed
   against K3; (b) the flagship frame of phase 3 under
   ``occupancy="pyramid"`` and ``occupancy="sim"`` (16 in-plane tiles),
   run and timed as phase 3 runs it (B4b once a frame under "sim"), each
   image at least 60 dB from phase 3's chunk-skip frame at the same
   state, eye and threshold, with the largest difference; (c) the 32^3
   ``occupancy="sim"`` frame under every fold against the CPU's plain
   versions; (d) one run of the benchmark twin
   (``scenery_insitu_tpu_torch.bench``) with ``SITPU_BENCH_SKIP=sim`` at
   512^3, its JSON line logged as ``bench_twin``;
6. the fold microbenchmark (the twin of the reference's
   ``benchmarks/fold_microbench.py``): (a) B8 (the deferred close events
   in registers) and B9 (in shared memory) against their plain versions
   and against B7 on the frame's captured chunks and on seeded streams
   at 320 x 320 and 640 x 640 (C = 16, K = 16, and K = 4 filling the slot
   cap): slot counters exact, colour and depth within 1e-6, with whether
   they equal B7 bit for bit; each timed at 640 x 640 for several (C, K)
   beside B7 and its bound, with its registers, local-memory bytes and
   block size; (b) the twin's sweep with ``--check`` over every variant
   at S = 256 (320 x 320) and S = 512 (640 x 640), K = 16, C = 16, its
   JSON rows logged, the launch counts set to 0 before it and read after
   it (B8 and B9 each S/C launches a march).

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM f32, outside the tensor cores
GRID = 512
K = 16
BINS = 16
CHUNK = 16
SIM_STEPS = 10
WARMUP_FRAMES = 2
TIMED_FRAMES = 6
SEED = 0
# operations of one Gray-Scott step per cell: two Laplacians (6 adds, a
# multiply and a subtract each), u*v*v, the two rate expressions and the
# two Euler updates
STENCIL_FLOPS_PER_CELL_STEP = 32
# K1 per pixel per slice: distance (8), start/count/transmittance (6),
# premultiplied accumulation (8), the two depths and their min/max (4)
SEG_FLOPS_PER_PIXEL_SLICE = 26
# K4 per pixel per slot: a counting pass (distance 8, gap test 2) times
# the search iterations, and the write pass (distance 8, gap test 2,
# accumulation 8)
RESEG_COUNT_FLOPS, RESEG_WRITE_FLOPS = 10, 18
# B7 per pixel per slice: distance (8), break and close predicates (6),
# the under-accumulation (8), the start count (3), the depths (2)
MACHINE_FLOPS_PER_PIXEL_SLICE = 27
# B5/B6, counted from the run's own samples: every sample's dead test
# (1); a live sample's (v >= -0.5) value clamp (2), power (counted as 10:
# a logarithm, a multiply and an exponential), opacity clamp and
# subtractions (4), alpha knots and K1's fold; a non-empty sample's
# colour knots and premultiply (3). Each non-zero knot slope costs 4
# (subtract, max, multiply, add). A dead sample's alpha is 0 whatever
# the knots give, and an empty sample's colour is never read.
DEAD_TEST_FLOPS, ALPHA_FLOPS_PER_SAMPLE, PREMUL_FLOPS = 1, 16, 3
SHADE_FLOPS_PER_KNOT = 4
# the fold schedules of the fold phase and the kernel each launches
FOLD_KERNELS = {"pallas": "fold_chunk", "pallas_fused": "fused_fold_chunk",
                "fused_stream": "fused_stream_fold"}
FOLD_PSNR_DB = 60.0
# the kernels of each path
FRAME_KERNELS = ("grayscott_fused", "seg_fold_compact", "count_multi")
SIM_OCC_KERNELS = FRAME_KERNELS + ("grayscott_fused_ranges",)
OCC_PSNR_DB = 60.0
BENCH_FRAMES = 5
DIST_KERNELS = FRAME_KERNELS + ("resegment_sorted",)
# the distributed frame: the reference's 8-rank mesh, composited into
# K_OUT slots with the default 6-step threshold search
RANKS = 8
K_OUT = 16
COMP_ITERS = 6
SMALL_RANKS = 4
# the fold microbenchmark (phase 6): the reference's default S = 256
# (320 x 320) and the flagship's 512 (640 x 640), K = 16, C = 16
MICRO_GRIDS = (256, 512)
MICRO_ITERS = 3
EVENT_KERNELS = {"events": "events_fold_chunk",
                 "scratch": "scratch_fold_chunk"}
# B8's and B9's seeded gates: (image side, K, chunks); the timed (C, K)
# pairs at the largest side, the first the microbenchmark's
EVENT_SEEDED = ((320, K, 1), (640, K, 1), (640, 4, 3))
EVENT_TIMED = ((16, 16), (8, 16), (32, 16), (16, 4))


def log(key, value):
    print(f"{key}={value}", flush=True)


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def median_ms(fn, reps: int, setup=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn(setup())``; the
    setup runs outside the timed window."""
    import torch

    times = []
    for _ in range(reps):
        arg = setup() if setup is not None else None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def clone(xs):
    return tuple(x.clone() for x in xs)


def require_launched(launches, names, path):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on "
                                 f"{path}")


def max_abs(a, b) -> float:
    """Largest |a - b| where both are finite; +inf entries must agree."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or \
            not torch.equal(a[~fin], b[~fin]):
        return math.inf
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def check(name, err, tol):
    log(f"{name}.max_abs_err", f"{err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by {err} > {tol}")


# ------------------------------------------------------------- phase 2


def check_stencil(dev):
    import torch

    from scenery_insitu_tpu_torch.sim import cuda_stencil as cst
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = (st.u - 0.05 * torch.rand(st.u.shape, generator=g,
                                  device=dev)).contiguous()
    v = (st.v + 0.05 * torch.rand(st.v.shape, generator=g,
                                  device=dev)).contiguous()
    p = st.params.vector()
    out = {}
    for t in (4, 2):
        uk, vk = cst.step_fused(u, v, p, t)
        up, vp = cst.step_fused_plain(u, v, p, t)
        torch.cuda.synchronize()
        err = max(max_abs(uk, up), max_abs(vk, vp))
        check(f"stencil_T{t}", err, 1e-6 * t)
        ms = median_ms(lambda _: cst.step_fused(u, v, p, t), 10)
        pms = median_ms(lambda _: cst.step_fused_plain(u, v, p, t), 3)
        cells = u.numel()
        b, by = bound_ms(4 * 4 * cells,
                         STENCIL_FLOPS_PER_CELL_STEP * t * cells)
        log(f"stencil_T{t}.ms", f"{ms:.4f} plain_ms={pms:.4f} "
            f"bound_ms={b:.4f} ({by})")
        out[t] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by)
    return out


def seeded_stream(c, h, w, dev, seed):
    """Depth-ordered shaded chunk with empty runs and near-duplicate
    colors, so starts on gaps, breaks on the distance and accumulation
    all occur."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    rgb = r(c, 3, h, w)
    dup = (r(c, 1, h, w) < 0.3) & (torch.arange(c, device=dev)
                                   .reshape(c, 1, 1, 1) > 0)
    rgb = torch.where(dup, torch.roll(rgb, 1, 0), rgb)
    alpha = (0.05 + 0.85 * r(c, 1, h, w)) * (r(c, 1, h, w) > 0.4)
    return torch.cat([rgb * alpha, alpha], dim=1).contiguous()


def touched_rows(rgba, small, thr, k):
    """(pixel, slot) state rows one K1 call reads and writes: the
    distinct slots of each pixel's non-empty slices in this chunk."""
    import torch

    from scenery_insitu_tpu_torch.ops import seg_fold as sf

    emp, starts = sf.chunk_flags(rgba, small[1:4], small[4] > 0.5, thr)
    sid = small[0][None] + torch.cumsum(starts.to(torch.float32), 0) - 1
    slot = torch.clamp(sid, 0, k - 1)
    return int(sum(((slot == s) & ~emp).any(0).sum() for s in range(k)))


def k1_bound(rgba, small, thr, k):
    c, _, h, w = rgba.shape
    hw = h * w
    rows = touched_rows(rgba, small, thr, k)
    nbytes = 4 * (c * 4 * hw + 2 * hw + 2 * c + 2 * 5 * hw + 2 * 6 * rows)
    return bound_ms(nbytes, SEG_FLOPS_PER_PIXEL_SLICE * c * hw)


def k2_bound(rgba, b):
    c, _, h, w = rgba.shape
    hw = h * w
    nbytes = 4 * (c * 4 * hw + b + 2 * b * hw + 2 * 3 * hw + 2 * hw)
    return bound_ms(nbytes, (8 + 2 * b) * c * hw)


def fold_chunks(fold, packed, chunks, thr, length):
    for rgba, sk0, sk1 in chunks:
        fold(packed, rgba, thr, max_k=K, sk0=sk0, sk1=sk1, length=length)
    return packed


def count_chunks(count, carry, chunks, tvec):
    for rgba, _, _ in chunks:
        count(carry, rgba, tvec)
    return carry


def packed_err(a, b):
    return max(max_abs(x, y) for x, y in zip(a, b))


def check_fold_and_count(dev, real_chunks, real_thr, real_length):
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_march as cm
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs
    from scenery_insitu_tpu_torch.ops import supersegments as ss

    h, w = real_thr.shape          # the frame's intermediate grid
    g = torch.Generator(device=dev).manual_seed(SEED)
    thr = (0.05 + 0.5 * torch.rand((h, w), generator=g, device=dev))
    length = (2.0 + torch.rand((h, w), generator=g, device=dev))
    tvec = ss.threshold_candidates(BINS, device=dev)
    res = {}
    for c in (16, 1):
        rgba = seeded_stream(c, h, w, dev, SEED + c)
        sk0 = torch.linspace(1.0, 1.5, c, device=dev)
        sk1 = (sk0 + 0.5 / max(c, 1)).contiguous()
        # a state that has already folded one chunk, so slots continue
        # across the chunk boundary
        base = cs.init_seg_packed(K, h, w, device=dev)
        pre0 = torch.linspace(0.5, 0.9, 16, device=dev)
        cs.fold_chunk_packed_plain(base, seeded_stream(16, h, w, dev, 99),
                                   thr, max_k=K, sk0=pre0,
                                   sk1=(pre0 + 0.025).contiguous(),
                                   length=length)
        kern = cs.fold_chunk_packed(clone(base), rgba, thr, max_k=K,
                                    sk0=sk0, sk1=sk1, length=length)
        plain = cs.fold_chunk_packed_plain(clone(base), rgba, thr, max_k=K,
                                           sk0=sk0, sk1=sk1, length=length)
        torch.cuda.synchronize()
        err1 = packed_err(kern, plain)
        check(f"seg_fold_C{c}", err1, 1e-5)
        if not torch.equal(kern[2][0], plain[2][0]):
            raise AssertionError(f"seg_fold_C{c}: start counts differ")
        ms1 = median_ms(lambda st: cs.fold_chunk_packed(
            st, rgba, thr, max_k=K, sk0=sk0, sk1=sk1, length=length), 20,
            lambda: clone(base))
        pms1 = median_ms(lambda st: cs.fold_chunk_packed_plain(
            st, rgba, thr, max_k=K, sk0=sk0, sk1=sk1, length=length), 3,
            lambda: clone(base))
        b1, by1 = k1_bound(rgba, base[2], thr, K)
        log(f"seg_fold_C{c}.ms", f"{ms1:.4f} plain_ms={pms1:.4f} "
            f"bound_ms={b1:.4f} ({by1})")

        cbase = cm.init_count_multi_packed(BINS, h, w, device=dev)
        ck = cm.count_multi_chunk(clone(cbase), rgba, tvec)
        cp = cm.count_multi_chunk_plain(clone(cbase), rgba, tvec)
        torch.cuda.synchronize()
        mism = int((ck[0] != cp[0]).sum())
        err2 = max(packed_err(ck[1:], cp[1:]),
                   float((ck[0] - cp[0]).abs().max()))
        log(f"count_C{c}.mismatches", f"{mism} (must be 0)")
        check(f"count_C{c}", err2, 0.0)
        ms2 = median_ms(lambda st: cm.count_multi_chunk(st, rgba, tvec), 20,
                        lambda: clone(cbase))
        pms2 = median_ms(lambda st: cm.count_multi_chunk_plain(
            st, rgba, tvec), 3, lambda: clone(cbase))
        b2, by2 = k2_bound(rgba, BINS)
        log(f"count_C{c}.ms", f"{ms2:.4f} plain_ms={pms2:.4f} "
            f"bound_ms={b2:.4f} ({by2})")
        res[c] = dict(seg=dict(err=err1, ms=ms1, plain_ms=pms1, bound_ms=b1,
                               bound_by=by1),
                      count=dict(err=err2, ms=ms2, plain_ms=pms2,
                                 bound_ms=b2, bound_by=by2))

    # the frame's own shaded chunks, folded and counted end to end
    kern = fold_chunks(cs.fold_chunk_packed,
                       cs.init_seg_packed(K, h, w, device=dev), real_chunks,
                       real_thr, real_length)
    plain = fold_chunks(cs.fold_chunk_packed_plain,
                        cs.init_seg_packed(K, h, w, device=dev), real_chunks,
                        real_thr, real_length)
    torch.cuda.synchronize()
    check("seg_fold_frame_chunks", packed_err(kern, plain), 1e-5)
    ck = count_chunks(cm.count_multi_chunk,
                      cm.init_count_multi_packed(BINS, h, w, device=dev),
                      real_chunks, tvec)
    cp = count_chunks(cm.count_multi_chunk_plain,
                      cm.init_count_multi_packed(BINS, h, w, device=dev),
                      real_chunks, tvec)
    torch.cuda.synchronize()
    log("count_frame_chunks.mismatches", int((ck[0] != cp[0]).sum()))
    check("count_frame_chunks", float((ck[0] - cp[0]).abs().max()), 0.0)
    log("frame_chunks", f"{len(real_chunks)} (C="
        f"{sorted({c[0].shape[0] for c in real_chunks})})")
    return res


def planes(sk, length):
    """Depth planes t = sk * length, one f32 multiply each (what the
    compact form computes in the kernel)."""
    return (sk[:, None, None] * length[None]).contiguous()


def packed_equal(a, b):
    return all(bool((x == y).all()) for x, y in zip(a, b))


def timed(fold_k, fold_p, base, reps=20):
    """(kernel ms, plain ms): medians over fresh copies of ``base``."""
    return (median_ms(fold_k, reps, lambda: clone(base)),
            median_ms(fold_p, 3, lambda: clone(base)))


def fused_flops(raw, ratio, tf):
    """Operations B5/B6 need on the value chunks ``raw`` [(val, sk)]:
    the dead test on every sample, the alpha shading and K1's fold on
    the live ones, the colour knots and premultiply on the non-empty
    ones (what these chunks' data needs, not the most it could).
    Returns (operations, live samples, non-empty samples)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_fused as cf
    from scenery_insitu_tpu_torch.ops import supersegments as ss

    nz_a = int(torch.count_nonzero(tf.alpha_m))
    nz_c = int(torch.count_nonzero(tf.color_m))
    total = live = solid = 0
    for val, _ in raw:
        total += val.numel()
        live += int((val >= -0.5).sum())
        solid += int((cf.shade_plain(val, ratio, tf)[:, 3]
                      >= ss.EMPTY_ALPHA).sum())
    ops = (DEAD_TEST_FLOPS * total
           + (ALPHA_FLOPS_PER_SAMPLE + SHADE_FLOPS_PER_KNOT * nz_a
              + SEG_FLOPS_PER_PIXEL_SLICE) * live
           + (SHADE_FLOPS_PER_KNOT * nz_c + PREMUL_FLOPS) * solid)
    return ops, live, solid


def check_new_folds(dev, cap):
    """B1b, B7, B5 and B6 against their plain versions on the card, on
    the frame's captured chunks and on a seeded stream, with their times
    and bounds. B1b must equal K1's compact form bit for bit; B7's
    counts, B5's and B6's start counts exactly, colour and depth within
    1e-6; B6 must equal B5 chunk after chunk bit for bit."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_fused as cf
    from scenery_insitu_tpu_torch.ops import cuda_march as cm
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    thr, length, ratio, tf = cap["thr"], cap["length"], cap["ratio"], \
        cap["tf"]
    h, w = thr.shape
    hw = h * w
    res = {}

    # B1b: the frame's chunks through both K1 forms, then a seeded chunk
    compact = cs.init_seg_packed(K, h, w, device=dev)
    plane = cs.init_seg_packed(K, h, w, device=dev)
    for rgba, sk0, sk1 in cap["chunks"]:
        cs.fold_chunk_packed(compact, rgba, thr, max_k=K, sk0=sk0, sk1=sk1,
                             length=length)
        cs.fold_chunk_packed(plane, rgba, thr, max_k=K, t0=planes(sk0, length),
                             t1=planes(sk1, length))
    torch.cuda.synchronize()
    if not packed_equal(compact, plane):
        raise AssertionError("seg_fold_planes differs from K1's compact "
                             "form on the frame's chunks")
    log("seg_fold_planes_frame_chunks", "equal to K1's compact form bit "
        "for bit")
    del compact, plane
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    sthr = (0.05 + 0.5 * torch.rand((h, w), generator=g, device=dev))
    rgba = seeded_stream(CHUNK, h, w, dev, SEED + 7)
    sk0 = torch.linspace(1.0, 1.5, CHUNK, device=dev)
    sk1 = (sk0 + 0.5 / CHUNK).contiguous()
    t0, t1 = planes(sk0, length), planes(sk1, length)
    pre0 = torch.linspace(0.5, 0.9, 16, device=dev)
    pre_rgba = seeded_stream(16, h, w, dev, 99)
    base = cs.init_seg_packed(K, h, w, device=dev)
    cs.fold_chunk_packed_plain(base, pre_rgba, sthr, max_k=K,
                               t0=planes(pre0, length),
                               t1=planes(pre0 + 0.025, length))
    kern = cs.fold_chunk_packed(clone(base), rgba, sthr, max_k=K, t0=t0,
                                t1=t1)
    comp = cs.fold_chunk_packed(clone(base), rgba, sthr, max_k=K, sk0=sk0,
                                sk1=sk1, length=length)
    plain = cs.fold_chunk_packed_plain(clone(base), rgba, sthr, max_k=K,
                                       t0=t0, t1=t1)
    torch.cuda.synchronize()
    if not packed_equal(kern, comp):
        raise AssertionError("seg_fold_planes differs from K1's compact "
                             "form on a seeded chunk")
    err = packed_err(kern, plain)
    check("seg_fold_planes", err, 1e-5)
    ms, pms = timed(lambda st: cs.fold_chunk_packed(
        st, rgba, sthr, max_k=K, t0=t0, t1=t1), lambda st:
        cs.fold_chunk_packed_plain(st, rgba, sthr, max_k=K, t0=t0, t1=t1),
        base)
    rows = touched_rows(rgba, base[2], sthr, K)
    b, by = bound_ms(4 * (CHUNK * 6 * hw + hw + 2 * 5 * hw + 2 * 6 * rows),
                     SEG_FLOPS_PER_PIXEL_SLICE * CHUNK * hw)
    log("seg_fold_planes.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by})")
    res["seg_fold_planes"] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                                  bound_by=by)

    # B7: a seeded chunk after one folded chunk, without and with count
    mbase = cm.init_packed(K, h, w, device=dev)
    cm.fold_chunk_plain(mbase, pre_rgba, planes(pre0, length),
                        planes(pre0 + 0.025, length), sthr, max_k=K)
    errs = []
    for with_count in (False, True):
        ck = torch.zeros((h, w), dtype=torch.int32, device=dev)
        cp = ck.clone()
        kern = cm.fold_chunk(clone(mbase), rgba, t0, t1, sthr, max_k=K,
                             count=ck if with_count else None)
        plain = cm.fold_chunk_plain(clone(mbase), rgba, t0, t1, sthr,
                                    max_k=K, count=cp if with_count else None)
        if with_count:
            kern, plain = kern[0], plain[0]
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(kern[2][11],
                                                   plain[2][11])):
            raise AssertionError(f"fold_chunk (count={with_count}): counts "
                                 f"or slot counters differ")
        errs.append(packed_err(kern, plain))
        check(f"fold_chunk_count{int(with_count)}", errs[-1], 1e-6)
    cnt = torch.zeros((h, w), dtype=torch.int32, device=dev)
    ms, pms = timed(lambda st: cm.fold_chunk(st, rgba, t0, t1, sthr,
                                             max_k=K, count=cnt),
                    lambda st: cm.fold_chunk_plain(st, rgba, t0, t1, sthr,
                                                   max_k=K, count=cnt),
                    mbase)
    closes = float((kern[2][11] - mbase[2][11]).sum())
    b, by = bound_ms(4 * (CHUNK * 6 * hw + hw + 2 * 12 * hw + 2 * hw
                          + 6 * closes),
                     MACHINE_FLOPS_PER_PIXEL_SLICE * CHUNK * hw)
    log("fold_chunk.ms", f"{ms:.4f} plain_ms={pms:.4f} bound_ms={b:.4f} "
        f"({by}) closes_per_pixel={closes / hw:.3f}")
    # the frame's chunks, with the temporal count
    packs = [cm.init_packed(K, h, w, device=dev) for _ in range(2)]
    cnts = [torch.zeros((h, w), dtype=torch.int32, device=dev)
            for _ in range(2)]
    for rgba_c, sk0_c, sk1_c in cap["chunks"]:
        a0, a1 = planes(sk0_c, length), planes(sk1_c, length)
        cm.fold_chunk(packs[0], rgba_c, a0, a1, thr, max_k=K, count=cnts[0])
        cm.fold_chunk_plain(packs[1], rgba_c, a0, a1, thr, max_k=K,
                            count=cnts[1])
    torch.cuda.synchronize()
    log("fold_chunk_frame_chunks.count_mismatches",
        f"{int((cnts[0] != cnts[1]).sum())} (must be 0)")
    if not torch.equal(cnts[0], cnts[1]):
        raise AssertionError("fold_chunk: counts differ on the frame's "
                             "chunks")
    errs.append(packed_err(*packs))
    check("fold_chunk_frame_chunks", errs[-1], 1e-6)
    res["fold_chunk"] = dict(err=max(errs), ms=ms, plain_ms=pms, bound_ms=b,
                             bound_by=by)
    del packs, cnts, mbase

    # B5 over the frame's raw chunks, from the initial state
    ds = cap["ds"]
    k5 = cs.init_seg_packed(K, h, w, device=dev)
    p5 = cs.init_seg_packed(K, h, w, device=dev)
    live = [int((val > -0.5).sum()) for val, _ in cap["raw"]]
    j = live.index(max(live))
    base5 = None
    for i, (val, sk) in enumerate(cap["raw"]):
        if i == j:
            base5 = clone(k5)
        args = (val, length, ratio, sk, (sk + ds).contiguous(), thr)
        cf.fused_fold_chunk(k5, *args, max_k=K, tf=tf)
        cf.fused_fold_chunk_plain(p5, *args, max_k=K, tf=tf)
    torch.cuda.synchronize()
    mism = int((k5[2][0] != p5[2][0]).sum())
    log("fused_fold_chunk_frame_chunks.count_mismatches",
        f"{mism} (must be 0)")
    if mism:
        raise AssertionError("fused_fold_chunk: start counts differ")
    err5 = packed_err(k5, p5)
    check("fused_fold_chunk_frame_chunks", err5, 1e-6)
    val, sk = cap["raw"][j]
    args = (val, length, ratio, sk, (sk + ds).contiguous(), thr)
    ms, pms = timed(lambda st: cf.fused_fold_chunk(st, *args, max_k=K, tf=tf),
                    lambda st: cf.fused_fold_chunk_plain(st, *args, max_k=K,
                                                         tf=tf), base5)
    rows = touched_rows(cf.shade_plain(val, ratio, tf), base5[2], thr, K)
    ops, n_live, n_solid = fused_flops([(val, sk)], ratio, tf)
    b, by = bound_ms(4 * (CHUNK * hw + 3 * hw + 2 * CHUNK + cf.NKNOTS
                          + 2 * 5 * hw + 2 * 6 * rows), ops)
    log("fused_fold_chunk.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by}) chunk={j} samples={CHUNK * hw} "
        f"live={n_live} non_empty={n_solid}")
    # what a skipped chunk costs B5: one -1 plane (the chunked feed) or a
    # whole chunk of them (the feed of the gathered stream)
    for planes_n in (1, CHUNK):
        dead = torch.full((planes_n, h, w), -1.0, device=dev)
        dsk = sk[:planes_n].contiguous()
        dargs = (dead, length, ratio, dsk, (dsk + ds).contiguous(), thr)
        dms = median_ms(lambda st: cf.fused_fold_chunk(
            st, *dargs, max_k=K, tf=tf), 20, lambda: clone(base5))
        log(f"fused_fold_chunk_dead_C{planes_n}.ms", f"{dms:.4f}")
    res["fused_fold_chunk"] = dict(err=err5, ms=ms, plain_ms=pms,
                                   bound_ms=b, bound_by=by)
    del base5, p5

    # B6 over the whole captured stream
    val = torch.cat([v for v, _ in cap["raw"]])
    sk = torch.cat([s for _, s in cap["raw"]])
    args = (val, length, ratio, sk, (sk + ds).contiguous(), thr)
    init = cs.init_seg_packed(K, h, w, device=dev)
    k6 = cf.fused_stream_fold(clone(init), *args, max_k=K, chunk=CHUNK, tf=tf)
    p6 = cf.fused_stream_fold_plain(clone(init), *args, max_k=K, chunk=CHUNK,
                                    tf=tf)
    torch.cuda.synchronize()
    mism = int((k6[2][0] != p6[2][0]).sum())
    log("fused_stream_fold.count_mismatches", f"{mism} (must be 0)")
    if mism:
        raise AssertionError("fused_stream_fold: start counts differ")
    err6 = packed_err(k6, p6)
    check("fused_stream_fold", err6, 1e-6)
    if not packed_equal(k6, k5):
        raise AssertionError("fused_stream_fold differs from "
                             "fused_fold_chunk chunk after chunk")
    log("fused_stream_fold_vs_chunks", "equal to fused_fold_chunk chunk "
        "after chunk bit for bit")
    ms = median_ms(lambda st: cf.fused_stream_fold(
        st, *args, max_k=K, chunk=CHUNK, tf=tf), 5, lambda: clone(init))
    pms = median_ms(lambda st: cf.fused_stream_fold_plain(
        st, *args, max_k=K, chunk=CHUNK, tf=tf), 1, lambda: clone(init))
    s_total = val.shape[0]
    rows = float(torch.clamp(k6[2][0], max=K).sum())
    ops, n_live, n_solid = fused_flops(cap["raw"], ratio, tf)
    b, by = bound_ms(4 * (s_total * hw + 3 * hw + 2 * s_total + cf.NKNOTS
                          + 2 * 5 * hw + 2 * 6 * rows), ops)
    log("fused_stream_fold.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by}) slices={s_total} samples="
        f"{s_total * hw} live={n_live} non_empty={n_solid}")
    res["fused_stream_fold"] = dict(err=err6, ms=ms, plain_ms=pms,
                                    bound_ms=b, bound_by=by)
    return res


def capture_chunks(dev, u, v, eye):
    """The shaded chunks (rgba, sk0, sk1) of one write march of the
    flagship frame, with its seed threshold and ray lengths, and the same
    march's raw value chunks (val, sk) as the fused folds see them, every
    skipped chunk a full chunk of -1 planes; the raw chunks' opacity
    ratios and the transfer function."""
    import torch

    from scenery_insitu_tpu_torch.config import SliceMarchConfig, VDIConfig
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops.sampling import nominal_step

    tf = for_dataset("gray_scott", device=dev)
    vol = Volume.centered(v, extent=2.0)
    cam = Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0, device=dev)
    spec = slicer.make_spec(cam, tuple(v.shape),
                            SliceMarchConfig(chunk=CHUNK))
    axcam = slicer.make_axis_camera(vol, cam, spec)
    thr = slicer.initial_threshold(
        vol, tf, cam, spec, VDIConfig(max_supersegments=K,
                                      adaptive_mode="temporal",
                                      histogram_bins=BINS)).thr
    chunks = []

    def keep(carry, rgba, sk0, sk1):
        chunks.append((rgba.clone(), sk0.clone(), sk1.clone()))
        return carry

    occ = slicer.occupancy_for(vol, tf, spec)
    slicer.slice_march(vol, tf, axcam, spec, keep, None, occupancy=occ,
                       shaded_compact=True)
    raw = []

    def keep_raw(carry, val, sk):
        raw.append((val.clone(), sk.clone()))
        return carry

    slicer.slice_march(vol, tf, axcam, spec, keep_raw, None, occupancy=occ,
                       raw=True, raw_full_skip=True)
    length = axcam.ray_lengths().contiguous()
    ds = torch.abs(axcam.dwm) / axcam.zp
    ratio = (ds * length / nominal_step(vol)).contiguous()
    return dict(chunks=chunks, raw=raw, thr=thr.contiguous(), length=length,
                ds=ds, ratio=ratio, tf=tf)


# ------------------------------------------------------------- phase 3


def frame_config(device, fold="auto", occupancy=None):
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 SliceMarchConfig, VDIConfig)

    return dict(
        sim_steps=SIM_STEPS, occupancy=occupancy,
        vdi_cfg=VDIConfig(max_supersegments=K, adaptive_iters=2,
                          adaptive_mode="temporal", histogram_bins=BINS),
        comp_cfg=CompositeConfig(max_output_supersegments=K,
                                 adaptive_iters=2),
        slicer_cfg=SliceMarchConfig(fold=fold, chunk=CHUNK),
        device=device)


def yaw_of(i):
    # within ±0.35 rad of the base camera: every frame stays in the z
    # march regime the step was built for
    return 0.35 * math.sin(0.7 * (i + 1))


def run_frame(dev, profile=False, fold="auto", prefix="frame",
              kernel_names=FRAME_KERNELS, time_sim=True, occupancy=None):
    """The flagship temporal frame under ``fold`` and the empty-space
    mode ``occupancy``: ``init_threshold``, the warm-up and timed frames
    with the launch counts read from that run (every kernel of
    ``kernel_names`` launched), then the march and (``time_sim``) the
    sim timed apart, each the median of TIMED_FRAMES. The sim is the
    same K3 work under every fold, so the fold frames leave it to phase
    3; under ``occupancy="sim"`` it is the sim with B4b's ranges and the
    march includes the pyramid built from them. Logs under ``prefix``;
    returns the launch counts and the final (u, v, thresholds, step)."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    base = Camera.create((0.0, 0.6, 3.0), fov_y_deg=50.0, near=0.5,
                         far=20.0, device=dev)
    step = grayscott_vdi_frame_step(grid_shape=(GRID,) * 3,
                                    axis_sign=slicer.choose_axis(base),
                                    **frame_config(dev, fold, occupancy))
    log(f"{prefix}.spec", step.spec)
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    u, v = st.u, st.v
    eye = lambda i: orbit(base, yaw_of(i)).eye

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thr = step.init_threshold(u, v, eye(-1))
    torch.cuda.synchronize()
    log(f"{prefix}.init_threshold_s", f"{time.perf_counter() - t0:.3f}")
    for i in range(WARMUP_FRAMES):
        color, depth, u, v, thr = step(u, v, eye(i), thr)
    torch.cuda.synchronize()
    ev = []
    wall = []
    for i in range(WARMUP_FRAMES, WARMUP_FRAMES + TIMED_FRAMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        color, depth, u, v, thr = step(u, v, eye(i), thr)
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - h0) * 1e3)
        ev.append(a.elapsed_time(b))
    launches = kernels.launches()
    log(f"{prefix}.launches", json.dumps(launches))
    require_launched(launches, kernel_names,
                     f"the single-chip frame (fold {step.spec.fold})")
    ev.sort()
    wall.sort()
    log(f"{prefix}.ms_per_frame", f"{ev[len(ev) // 2]:.3f} (median of "
        f"{TIMED_FRAMES}, CUDA events; host clock {wall[len(wall) // 2]:.3f})")

    nj, ni = step.spec.nj, step.spec.ni
    check_vdi(prefix, VDI(color, depth), (K, 4, nj, ni), (K, 2, nj, ni))
    if not bool(torch.isfinite(u).all() & torch.isfinite(v).all()):
        raise AssertionError("sim state is not finite")

    # the split: the sim advance and the march, timed apart on this state
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import occupancy as occ

    sim_occ = occupancy == "sim"
    if time_sim:
        advance = gs.multi_step_fast_ranges if sim_occ else gs.multi_step_fast
        sim_ms = median_ms(lambda _: advance(
            gs.GrayScott(u, v, st.params), SIM_STEPS), TIMED_FRAMES)
        log(f"{prefix}.sim_ms", f"{sim_ms:.3f}")
    cfg = frame_config(dev)
    tf = for_dataset("gray_scott", device=dev)
    vol = Volume.centered(v, extent=2.0)
    cam = Camera.create(eye(0), fov_y_deg=50.0, near=0.5, far=20.0,
                        device=dev)
    pyramid = lambda: None
    if sim_occ:
        # the sim's ranges of this field (B4b's equal these exactly, 5a)
        rng = occ.field_ranges(v, *occ.default_bricks(tuple(v.shape)))
        pyramid = lambda: occ.pyramid_from_ranges(rng, vol, tf, step.spec)
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
    march_ms = median_ms(lambda _: slicer.generate_vdi_mxu_temporal(
        vol, tf, cam, step.spec, thr, cfg["vdi_cfg"], occupancy=pyramid()),
        TIMED_FRAMES)
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs
    log(f"{prefix}.march_ms", f"{march_ms:.3f} (median of {TIMED_FRAMES} "
        f"marches "
        f"alone; device allocations in them: {allocs})")
    if profile:
        state = [u, v, thr]

        def one(i):
            _, _, state[0], state[1], state[2] = step(*state[:2], eye(i),
                                                      state[2])

        profile_frames("profile" if prefix == "frame" else
                       f"{prefix}.profile", one)
    return launches, (u, v, thr, step)


def run_fold_frames(dev, ref, profile=False):
    """The flagship frame under each fold of FOLD_KERNELS, through
    ``grayscott_vdi_frame_step`` exactly as phase 3 runs it, with the
    launch counts set to 0 before each fold's run and read after it (the
    fold's kernel must launch). Then each fold's VDI against the phase 3
    frame's fold (``pallas_seg``) at the same state, eye and threshold:
    PSNR of the two images at least FOLD_PSNR_DB, and the share of
    pixels whose live slot count differs. Returns {fold: (launches,
    psnr)}."""
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer

    u, v, thr, ref_step = ref
    cfg = frame_config(dev)["vdi_cfg"]
    tf = for_dataset("gray_scott", device=dev)
    base = Camera.create((0.0, 0.6, 3.0), fov_y_deg=50.0, near=0.5,
                         far=20.0, device=dev)
    cam = Camera.create(orbit(base, yaw_of(0)).eye, fov_y_deg=50.0,
                        near=0.5, far=20.0, device=dev)
    vol = Volume.centered(v, extent=2.0)
    want, _, _, _ = slicer.generate_vdi_mxu_temporal(
        vol, tf, cam, ref_step.spec, thr, cfg)
    want_img = render_vdi_same_view(want)
    want_live = torch.isfinite(want.depth[:, 0]).sum(0)
    out = {}
    for fold, name in FOLD_KERNELS.items():
        torch.cuda.empty_cache()
        launches, (_, _, _, step) = run_frame(
            dev, profile, fold=fold, prefix=f"fold_{fold}",
            kernel_names=(name, "grayscott_fused", "count_multi"),
            time_sim=False)
        got, _, _, _ = slicer.generate_vdi_mxu_temporal(
            vol, tf, cam, step.spec, thr, cfg)
        psnr = image_psnr(render_vdi_same_view(got), want_img)
        live = torch.isfinite(got.depth[:, 0]).sum(0)
        share = float((live != want_live).float().mean())
        log(f"fold_{fold}.psnr_vs_pallas_seg_db", f"{psnr:.2f} (gate "
            f">= {FOLD_PSNR_DB}; pixels whose live slot count differs: "
            f"{share:.6f})")
        if not psnr >= FOLD_PSNR_DB:
            raise AssertionError(f"fold {fold}: image {psnr:.2f} dB from "
                                 f"the pallas_seg frame")
        out[fold] = (launches, psnr)
        del got
    return out


def profile_frames(prefix, frame, frames=2):
    """Device time by kernel over ``frames`` calls of ``frame(i)``
    (torch.profiler, after one unrecorded warm-up call), the device's
    busy share of the window's CUDA-event time, and from the trace the
    idle gaps and the host-to-device copies and stream synchronisations
    a frame makes; logged under ``prefix``. The Chrome trace goes to
    chiprun_out/<prefix>_trace.json."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=frames, repeat=1)) as prof:
        frame(99)
        # the warm-up frame's device work ends before the window opens
        torch.cuda.synchronize()
        prof.step()
        a.record()
        for i in range(frames):
            frame(100 + i)
            if i == frames - 1:
                b.record()
                b.synchronize()
            prof.step()
    window_ms = a.elapsed_time(b)
    # device-side rows (kernels, copies, fills) make the busy time; an
    # operator's row repeats the device time of the kernels it launched,
    # so it is listed apart (the port's own kernels have no operator row).
    # "Command Buffer Full" marks the host waiting on a full launch queue,
    # not device work, and a "ProfilerStep#" row spans a whole step.
    kern, ops = [], []
    for e in prof.key_averages():
        if e.self_device_time_total <= 0 or e.key == "Command Buffer Full" \
                or e.key.startswith("ProfilerStep"):
            continue
        row = (e.self_device_time_total / 1e3, e.count, e.key)
        (kern if e.device_type == DeviceType.CUDA else ops).append(row)
    busy = sum(r[0] for r in kern)
    log(f"{prefix}.window_ms", f"{window_ms:.3f} ({frames} frames)")
    log(f"{prefix}.device_busy_ms", f"{busy:.3f} (busy share "
        f"{busy / window_ms:.3f})")
    for kind, rows in (("kernel", kern), ("op", ops)):
        for ms, n, key in sorted(rows, reverse=True)[:12]:
            print(f"{prefix}.{kind} {ms / frames:10.3f} ms/frame "
                  f"{n // frames:6d} calls/frame  {key[:90]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"{prefix}_trace.json")
    prof.export_chrome_trace(path)
    trace_gaps(prefix, path, frames)


def trace_gaps(prefix, path, frames):
    """From a Chrome trace: the union of the device's busy intervals
    over the span from its first to its last device event, the idle
    gaps between them, and per frame the host-to-device copies and the
    host's stream synchronisations (each one drains the device's queue
    before the host launches on)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, gaps, (s0, e0) = 0.0, [], dev[0]
    for s1, e1 in dev[1:]:
        if s1 > e0:
            busy += e0 - s0
            gaps.append(s1 - e0)
            s0, e0 = s1, e1
        else:
            e0 = max(e0, e1)
    busy += e0 - s0
    span = dev[-1][1] - dev[0][0]
    h2d = sum(1 for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", ""))
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name") == "cudaStreamSynchronize")
    log(f"{prefix}.trace", f"device ops {len(dev) / frames:.0f}/frame, "
        f"busy {busy / 1e3:.3f} of {span / 1e3:.3f} ms (share "
        f"{busy / span:.3f}), idle gaps {sum(gaps) / 1e3 / frames:.3f} "
        f"ms/frame ({sum(g for g in gaps if g > 100) / 1e3 / frames:.3f} "
        f"in gaps over 0.1 ms), host-to-device copies "
        f"{h2d / frames:.1f}/frame, stream syncs {syncs / frames:.1f}/frame")


def check_small_frame(dev, fold="pallas_seg", occupancy=None):
    """The kernel path of ``fold`` (and empty-space mode ``occupancy``)
    on the card against its plain versions on the CPU, 3 temporal frames
    on a 32^3 grid from the same inputs."""
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    st = gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu")
    base = Camera.create((0.0, 0.6, 3.0), device="cpu")
    axis_sign = slicer.choose_axis(base)
    outs = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        step = grayscott_vdi_frame_step(
            grid_shape=(n,) * 3, axis_sign=axis_sign,
            **frame_config(d, fold=fold, occupancy=occupancy))
        u, v = st.u.to(d), st.v.to(d)
        thr = step.init_threshold(u, v, orbit(base, 0.1).eye.to(d))
        imgs = []
        for i in range(3):
            color, depth, u, v, thr = step(u, v, orbit(base, yaw_of(i))
                                           .eye.to(d), thr)
            imgs.append(render_vdi_same_view(VDI(color, depth)).cpu())
        outs[name] = (torch.stack(imgs), u.cpu(), v.cpu())
    prefix = "small_frame" if fold == "pallas_seg" else \
        f"small_frame_{fold}"
    if occupancy is not None:
        prefix = f"small_frame_{occupancy}_{fold}"
    uerr = max(max_abs(outs["cuda"][1], outs["cpu"][1]),
               max_abs(outs["cuda"][2], outs["cpu"][2]))
    check(f"{prefix}.sim", uerr, 1e-6 * 3 * SIM_STEPS)
    diff = (outs["cuda"][0] - outs["cpu"][0]).abs()
    log(f"{prefix}.image_max_abs_diff", f"{float(diff.max()):.3e}")
    log(f"{prefix}.image_mean_abs_diff", f"{float(diff.mean()):.3e}")
    if not (float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-4):
        raise AssertionError(f"the card's frame (fold {fold}) differs from "
                             f"the CPU's plain versions")


# ------------------------------------------------------------- phase 4


BASE_EYE = (0.0, 0.6, 3.0)


def dist_steps(dev, n, grid, base_eye, fold="auto"):
    """The distributed temporal step of an ``n``-rank mesh on ``dev``
    for a ``grid``^3 volume, in the march regime of ``base_eye``: (mesh,
    spec, tf, configs, seed, step, camera(i))."""
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n, device=dev)
    base = Camera.create(base_eye, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    vcfg = VDIConfig(max_supersegments=K, adaptive_mode="temporal",
                     histogram_bins=BINS)
    ccfg = CompositeConfig(max_output_supersegments=K_OUT,
                           adaptive_iters=COMP_ITERS)
    spec = slicer.make_spec(base, (grid,) * 3,
                            SliceMarchConfig(fold=fold, chunk=CHUNK),
                            axis_sign=slicer.choose_axis(base),
                            multiple_of=n)
    tf = for_dataset("gray_scott", device=dev)
    seed = dp.distributed_initial_threshold_mxu(mesh, tf, spec, vcfg)
    step = dp.distributed_vdi_step_mxu_temporal(mesh, tf, spec, vcfg, ccfg)

    def camera(i):
        return Camera.create(orbit(base, yaw_of(i)).eye, fov_y_deg=50.0,
                             near=0.5, far=20.0, device=dev)

    return mesh, spec, tf, (vcfg, ccfg), seed, step, camera


def check_vdi(prefix, vdi, want_c, want_d):
    import torch

    if tuple(vdi.color.shape) != want_c or tuple(vdi.depth.shape) != want_d:
        raise AssertionError(f"{prefix}: VDI shapes {tuple(vdi.color.shape)}"
                             f", {tuple(vdi.depth.shape)}; expected "
                             f"{want_c}, {want_d}")
    if not bool(torch.isfinite(vdi.color).all()):
        raise AssertionError(f"{prefix}: VDI color is not finite")
    if not bool((torch.isfinite(vdi.depth) | (vdi.depth == torch.inf))
                .all()):
        raise AssertionError(f"{prefix}: VDI depth holds NaN or -inf")
    live = torch.isfinite(vdi.depth[:, 0])
    log(f"{prefix}.live_slots", f"{int(live.sum())} of {live.numel()} "
        f"(pixels with a slot: {int(live.any(0).sum())})")
    if not bool(live.any()):
        raise AssertionError(f"{prefix}: the VDI has no live slot")


def image_psnr(a, b) -> float:
    """PSNR in dB of two premultiplied images over white, rgb in [0, 1]."""
    import torch

    def over_white(img):
        return (img[:3] + (1.0 - img[3:4])).clamp(0.0, 1.0)

    mse = float(torch.mean((over_white(a) - over_white(b)) ** 2))
    return math.inf if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def run_dist_frame(dev, profile=False):
    """The distributed temporal frame at the flagship size on an
    8-rank mesh: K3 advances the whole grid, `shard_volume` cuts it into
    z-slabs, and the step marches every slab, exchanges the column
    blocks and composites them through K4. ``seed`` once, 2 warm-up and
    6 timed frames with the launch counts read from that run; then the
    frame's phases timed apart on its final state; then, as information,
    the PSNR of its image against the single-chip march at the same eye.
    Returns the launch counts and the frame's exchanged column blocks."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.config import VDIConfig
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops.composite import composite_vdis
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    mesh, spec, tf, (vcfg, ccfg), seed, step, camera = dist_steps(
        dev, RANKS, GRID, BASE_EYE)
    log("dist.spec", f"{spec} ranks={RANKS} slab={GRID // RANKS}x{GRID}x"
        f"{GRID} k_out={K_OUT} composite_iters={COMP_ITERS}")
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    u, v = st.u, st.v
    box = Volume.centered(v, extent=2.0)
    origin, spacing = box.origin, box.spacing

    def frame(u, v, thr, i):
        state = gs.multi_step_fast(gs.GrayScott(u, v, st.params), SIM_STEPS)
        (vdi, _), thr = step(shard_volume(state.field, mesh), origin,
                             spacing, camera(i), thr)
        return vdi, state.u, state.v, thr

    kernels.reset_launches()
    thr = seed(shard_volume(v, mesh), origin, spacing, camera(-1))
    for i in range(WARMUP_FRAMES):
        vdi, u, v, thr = frame(u, v, thr, i)
    torch.cuda.synchronize()
    ev, wall = [], []
    for i in range(WARMUP_FRAMES, WARMUP_FRAMES + TIMED_FRAMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        vdi, u, v, thr = frame(u, v, thr, i)
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - h0) * 1e3)
        ev.append(a.elapsed_time(b))
    launches = kernels.launches()
    log("dist.launches", json.dumps(launches))
    require_launched(launches, DIST_KERNELS, "the distributed frame")
    frames = WARMUP_FRAMES + TIMED_FRAMES
    if launches["resegment_sorted"] != RANKS * frames:
        raise AssertionError(f"K4 launched {launches['resegment_sorted']} "
                             f"times in {frames} frames of {RANKS} ranks")
    ev.sort()
    wall.sort()
    log("dist.ms_per_frame", f"{ev[len(ev) // 2]:.3f} (median of "
        f"{TIMED_FRAMES}, CUDA events; host clock "
        f"{wall[len(wall) // 2]:.3f})")
    check_vdi("dist", vdi, (K_OUT, 4, spec.nj, spec.ni),
              (K_OUT, 2, spec.nj, spec.ni))
    if not bool(torch.isfinite(thr.thr).all()):
        raise AssertionError("dist: threshold maps are not finite")

    # the phases, timed apart on the final state
    sim_ms = median_ms(lambda _: gs.multi_step_fast(
        gs.GrayScott(u, v, st.params), SIM_STEPS), 5)
    slabs = shard_volume(v, mesh)
    halo = dp._halo_for(slabs, spec)
    cam = camera(WARMUP_FRAMES + TIMED_FRAMES)

    def march(_):
        return [dp._mxu_rank_generate(slabs, halo, r, origin, spacing, cam,
                                      spec, tf, vcfg,
                                      dp._rank_thr(thr, r, spec.nj))[0]
                for r in range(RANKS)]

    march_ms = median_ms(march, 3)
    frags = march(None)
    colors = torch.stack([f.color for f in frags])
    depths = torch.stack([f.depth for f in frags])
    del frags
    exchange_ms = median_ms(lambda _: dp._exchange_vdi_columns(
        colors, depths, RANKS), 5)
    rc, rd = dp._exchange_vdi_columns(colors, depths, RANKS)
    del colors, depths
    composite_ms = median_ms(lambda _: [
        composite_vdis(rc[j], rd[j], ccfg) for j in range(RANKS)], 3)
    log("dist.sim_ms", f"{sim_ms:.3f}")
    log("dist.march_ms", f"{march_ms:.3f} (sum over {RANKS} ranks)")
    log("dist.exchange_ms", f"{exchange_ms:.3f}")
    log("dist.composite_ms", f"{composite_ms:.3f} (sort + K4, {RANKS} "
        f"column blocks)")
    if profile:
        state = [u, v, thr]

        def one(i):
            _, state[0], state[1], state[2] = frame(*state, i)

        profile_frames("dist.profile", one)

    # information only: the same state and eye, histogram thresholds,
    # against the single-chip march
    hcfg = VDIConfig(max_supersegments=K, adaptive_mode="histogram",
                     histogram_bins=BINS)
    dvdi, _ = dp.distributed_vdi_step_mxu(mesh, tf, spec, hcfg, ccfg)(
        slabs, origin, spacing, cam)
    svdi, _, _ = slicer.generate_vdi_mxu(Volume.centered(v, extent=2.0), tf,
                                         cam, spec, hcfg)
    psnr = image_psnr(render_vdi_same_view(dvdi), render_vdi_same_view(svdi))
    log("dist.psnr_vs_single_chip_db", f"{psnr:.2f} (information; "
        f"histogram thresholds, same state and eye)")
    return launches, rc, rd


def seeded_sorted_stream(nk, h, w, dev, seed):
    """A per-pixel depth-sorted stream as the composite sees it: a random
    number of live slots front to back (repeated colours, depth gaps,
    alphas below the empty cut), then empty slots."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    start = torch.sort(1.0 + 4.0 * r(nk, h, w), dim=0).values
    end = start + torch.where(r(nk, h, w) < 0.5, 0.001, 0.2)
    rgb = r(nk, 3, h, w)
    dup = (r(nk, 1, h, w) < 0.3) & (torch.arange(nk, device=dev)
                                    .reshape(nk, 1, 1, 1) > 0)
    rgb = torch.where(dup, torch.roll(rgb, 1, 0), rgb)
    a = 0.05 + 0.9 * r(nk, 1, h, w)
    a = torch.where(r(nk, 1, h, w) < 0.1, 5e-5, a)
    n_live = (r(h, w) * (nk + 1)).floor()
    live = torch.arange(nk, device=dev).reshape(nk, 1, 1) < n_live
    color = torch.where(live[:, None], torch.cat([rgb * a, a], 1), 0.0)
    depth = torch.where(live[:, None], torch.stack([start, end], 1),
                        torch.inf)
    return color.contiguous(), depth.contiguous()


def k4_bound(sc, iters):
    """Bytes and operations the resegment of ``sc`` needs: every slot's
    alpha (to find where the stream ends), colour and depth of the slots
    up to one past the last non-empty one, the K_OUT output slots."""
    import torch

    nk, _, h, w = sc.shape
    nonempty = sc[:, 3] >= 1e-4
    idx = torch.arange(1, nk + 1, device=sc.device).reshape(nk, 1, 1)
    walked = torch.clamp((nonempty * idx).amax(0) + 1, max=nk)
    slots = float(walked.sum())
    nbytes = 4 * (nk * h * w + 5 * slots + 6 * K_OUT * h * w)
    return bound_ms(nbytes, slots * (iters * RESEG_COUNT_FLOPS
                                     + RESEG_WRITE_FLOPS)), slots / (h * w)


def check_resegment(dev, rc, rd):
    """K4 against its plain version on the card at the distributed
    frame's per-rank shapes: a seeded stream and the frame's own
    exchanged column block with the most live slots. Thresholds and
    live slots exact, colour and depth within 1e-6; times, bound."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_composite as cc
    from scenery_insitu_tpu_torch.ops.composite import sort_stream

    _, n, k, _, h, w = rc.shape
    j = int(torch.isfinite(rd[:, :, :, 0]).flatten(1).sum(1).argmax())
    frame_block = sort_stream(rc[j].reshape(n * k, 4, h, w),
                              rd[j].reshape(n * k, 2, h, w))
    seeded = seeded_sorted_stream(n * k, h, w, dev, SEED)
    res = {}
    for name, (sc, sd) in (("seeded", seeded), ("frame_block", frame_block)):
        tk = torch.empty((h, w), device=dev)
        tp = torch.empty((h, w), device=dev)
        ck = cc.resegment_sorted(sc, sd, None, K_OUT,
                                 adaptive_iters=COMP_ITERS, threshold_out=tk)
        cp = cc.resegment_sorted_plain(sc, sd, None, K_OUT,
                                       adaptive_iters=COMP_ITERS,
                                       threshold_out=tp)
        torch.cuda.synchronize()
        thr_mism = int((tk != tp).sum())
        slot_mism = int((torch.isfinite(ck[1][:, 0]).sum(0)
                         != torch.isfinite(cp[1][:, 0]).sum(0)).sum())
        log(f"resegment_{name}.mismatches", f"thresholds {thr_mism}, live "
            f"slot counts {slot_mism} (must be 0)")
        if thr_mism or slot_mism:
            raise AssertionError(f"resegment_{name}: K4 differs from its "
                                 f"plain version in thresholds or counts")
        err = max(max_abs(ck[0], cp[0]), max_abs(ck[1], cp[1]))
        check(f"resegment_{name}", err, 1e-6)
        ms = median_ms(lambda _: cc.resegment_sorted(
            sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS), 20)
        pms = median_ms(lambda _: cc.resegment_sorted_plain(
            sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS), 3)
        (b, by), walked = k4_bound(sc, COMP_ITERS)
        log(f"resegment_{name}.ms", f"{ms:.4f} plain_ms={pms:.4f} "
            f"bound_ms={b:.4f} ({by}) nk={n * k} hw={h}x{w} "
            f"slots_walked_per_pixel={walked:.2f}")
        res[name] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                         bound_by=by)
    return res


def check_small_dist(dev):
    """The distributed step on the card (K1, K2, K4) against the CPU's
    plain versions on a 32^3 Gray-Scott volume over 4 ranks, in both
    march regimes: seed + 3 temporal frames from the same inputs."""
    import torch

    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    v0 = gs.multi_step(gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu"),
                       2 * SIM_STEPS).v
    box = Volume.centered(v0, extent=2.0)
    for regime, eye in (("z", BASE_EYE), ("x", (3.0, 0.6, 0.4))):
        outs = {}
        for name, d in (("cuda", dev), ("cpu", "cpu")):
            mesh, spec, _, _, seed, step, camera = dist_steps(
                d, SMALL_RANKS, n, eye, fold="pallas_seg")
            data = shard_volume(v0.to(d), mesh)
            origin, spacing = box.origin.to(d), box.spacing.to(d)
            thr = seed(data, origin, spacing, camera(-1))
            imgs = []
            for i in range(3):
                (vdi, _), thr = step(data, origin, spacing, camera(i), thr)
                imgs.append(render_vdi_same_view(vdi).cpu())
            outs[name] = (torch.stack(imgs), thr.thr.cpu(), spec)
        log(f"small_dist_{regime}.spec", outs["cpu"][2])
        diff = (outs["cuda"][0] - outs["cpu"][0]).abs()
        tdiff = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
        log(f"small_dist_{regime}.image_max_abs_diff",
            f"{float(diff.max()):.3e}")
        log(f"small_dist_{regime}.image_mean_abs_diff",
            f"{float(diff.mean()):.3e}")
        log(f"small_dist_{regime}.threshold_max_abs_diff", f"{tdiff:.3e}")
        if not (float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-4):
            raise AssertionError(f"the card's distributed frame ({regime} "
                                 f"march) differs from the CPU's plain "
                                 f"versions")


# ------------------------------------------------------------- phase 5


def check_stencil_ranges(dev, g):
    """B4b against K3 and its plain version: the 512^3 state ``g`` with
    the default bricks (16 x 32 x 512 cells, one brick a block) at T=4
    and T=2, and ragged grids whose bricks straddle K3's 16 x 16 x 32
    blocks, one with v partly negative. Its u', v' must equal K3's bit
    for bit, its ranges ``field_ranges`` of its own v' and its plain
    version's exactly. Times B4b against K3 at T=4 and T=2 (the frame's
    last pass, the one that carries the epilogue) on the 512^3 state."""
    import torch

    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.sim import cuda_stencil as cst
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    p = g.params.vector()
    cases = [(f"{GRID}", g.u, g.v, occ.default_bricks(tuple(g.v.shape)),
              (4, 2))]
    for shape, bricks, shift in (((24, 24, 24), None, 0.0),
                                 ((36, 60, 50), (12, 5), -0.1)):
        st = gs.GrayScott.init(shape, seed=SEED, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        u = (st.u - 0.05 * torch.rand(shape, generator=gen, device=dev))
        v = (st.v + shift + 0.05 * torch.rand(shape, generator=gen,
                                              device=dev))
        bricks = bricks or occ.default_bricks(shape)
        cases.append(("x".join(map(str, shape)), u.contiguous(),
                      v.contiguous(), bricks, (4, 3)))
    err = 0.0
    for name, u, v, bricks, ts in cases:
        for t in ts:
            ur, vr, lo, hi = cst.step_fused_ranges(u, v, p, t, bricks)
            uk, vk = cst.step_fused(u, v, p, t)
            _, _, lp, hp = cst.step_fused_ranges_plain(u, v, p, t, bricks)
            own = occ.field_ranges(vr, *bricks)
            torch.cuda.synchronize()
            tag = f"stencil_ranges_{name}_T{t}"
            if not (torch.equal(ur, uk) and torch.equal(vr, vk)):
                raise AssertionError(f"{tag}: u', v' differ from K3's")
            if not (torch.equal(lo, own.lo) and torch.equal(hi, own.hi)):
                raise AssertionError(f"{tag}: ranges differ from "
                                     f"field_ranges of the kernel's v'")
            e = max(max_abs(lo, lp), max_abs(hi, hp))
            log(f"{tag}.bricks", f"{bricks} lo in [{float(lo.min()):.4f}, "
                f"{float(lo.max()):.4f}], hi in [{float(hi.min()):.4f}, "
                f"{float(hi.max()):.4f}]; u', v' equal K3's bit for bit")
            check(tag, e, 0.0)
            err = max(err, e)
    u, v, bricks = g.u, g.v, cases[0][3]
    cells = u.numel()
    out = {}
    for t in (4, 2):
        ms = median_ms(lambda _: cst.step_fused_ranges(u, v, p, t, bricks),
                       10)
        k3_ms = median_ms(lambda _: cst.step_fused(u, v, p, t), 10)
        pms = median_ms(lambda _: cst.step_fused_ranges_plain(
            u, v, p, t, bricks), 3)
        # K3's bytes and operations, plus the ranges written and a compare
        # a cell for each of min and max
        b, by = bound_ms(4 * 4 * cells + 2 * 4 * bricks[0] * bricks[1],
                         (STENCIL_FLOPS_PER_CELL_STEP * t + 2) * cells)
        log(f"stencil_ranges_T{t}.ms", f"{ms:.4f} k3_ms={k3_ms:.4f} "
            f"plain_ms={pms:.4f} bound_ms={b:.4f} ({by}) bricks={bricks}")
        out[t] = dict(err=err, ms=ms, k3_ms=k3_ms, plain_ms=pms, bound_ms=b,
                      bound_by=by)
    return out


def run_occupancy_frames(dev, ref, profile=False):
    """The flagship frame under ``occupancy="pyramid"`` and ``"sim"``,
    through ``grayscott_vdi_frame_step`` as phase 3 runs it, the launch
    counts set to 0 before each run and read after it (B4b once a frame
    under "sim"). Then each mode's VDI against phase 3's chunk-skip frame
    at the same state, eye and threshold: PSNR at least OCC_PSNR_DB, the
    largest image difference and the share of pixels whose live slot
    count differs. Returns {mode: launches}."""
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.ops import slicer

    u, v, thr, ref_step = ref
    cfg = frame_config(dev)["vdi_cfg"]
    tf = for_dataset("gray_scott", device=dev)
    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    cam = Camera.create(orbit(base, yaw_of(0)).eye, fov_y_deg=50.0,
                        near=0.5, far=20.0, device=dev)
    vol = Volume.centered(v, extent=2.0)
    want, _, _, _ = slicer.generate_vdi_mxu_temporal(
        vol, tf, cam, ref_step.spec, thr, cfg)
    want_img = render_vdi_same_view(want)
    want_live = torch.isfinite(want.depth[:, 0]).sum(0)
    rng = occ.field_ranges(v, *occ.default_bricks(tuple(v.shape)))
    out = {}
    for mode in ("pyramid", "sim"):
        torch.cuda.empty_cache()
        launches, (_, _, _, step) = run_frame(
            dev, profile, prefix=f"occ_{mode}", occupancy=mode,
            kernel_names=SIM_OCC_KERNELS if mode == "sim" else FRAME_KERNELS,
            time_sim=mode == "sim")
        frames = WARMUP_FRAMES + TIMED_FRAMES
        if mode == "sim" and launches["grayscott_fused_ranges"] != frames:
            raise AssertionError(
                f"B4b launched {launches['grayscott_fused_ranges']} times "
                f"in {frames} frames")
        pyr = (occ.pyramid_from_ranges(rng, vol, tf, step.spec)
               if mode == "sim" else
               occ.pyramid_from_volume(vol, tf, step.spec))
        log(f"occ_{mode}.pyramid", f"vtiles={step.spec.vtiles} live cells "
            f"{float(pyr.live_fraction()):.4f}, live chunks "
            f"{int(pyr.chunks.sum())} of {pyr.chunks.numel()}")
        got, _, _, _ = slicer.generate_vdi_mxu_temporal(
            vol, tf, cam, step.spec, thr, cfg,
            occupancy=pyr if mode == "sim" else None)
        img = render_vdi_same_view(got)
        psnr = image_psnr(img, want_img)
        diff = float((img - want_img).abs().max())
        live = torch.isfinite(got.depth[:, 0]).sum(0)
        share = float((live != want_live).float().mean())
        log(f"occ_{mode}.psnr_vs_chunk_skip_db", f"{psnr:.2f} (gate >= "
            f"{OCC_PSNR_DB}; largest image difference {diff:.3e}; pixels "
            f"whose live slot count differs: {share:.6f})")
        if not psnr >= OCC_PSNR_DB:
            raise AssertionError(f"occupancy {mode}: image {psnr:.2f} dB "
                                 f"from the chunk-skip frame")
        out[mode] = launches
        del got
    return out


def run_bench_twin(dev):
    """One run of the benchmark twin at the flagship size with the
    sim-fused occupancy; its JSON line is logged as ``bench_twin``."""
    from scenery_insitu_tpu_torch import bench

    res = bench.run(dev, env={"SITPU_BENCH_GRID": str(GRID),
                         "SITPU_BENCH_SKIP": "sim",
                         "SITPU_BENCH_FRAMES": str(BENCH_FRAMES)})
    log("bench_twin", json.dumps(res))
    if not (res["value"] > 0 and res["occupancy"]["mode"] == "sim"):
        raise AssertionError(f"bench twin: {res}")


# ------------------------------------------------------------- phase 6


def event_bound(rgba, closes):
    """B8's and B9's bound: B7's without the count (each input read
    once, the state read and written once, the closing slots' rows
    written)."""
    c, _, h, w = rgba.shape
    hw = h * w
    return bound_ms(4 * (c * 6 * hw + hw + 2 * 12 * hw + 6 * closes),
                    (MACHINE_FLOPS_PER_PIXEL_SLICE - 3) * c * hw)


def fold_events(fold, state, chunks, thr, k):
    """``chunks`` [(rgba, t0, t1)] through B8's or B9's ``fold`` (or its
    plain version) into ``state``, a ``((color, depth), small)`` pair."""
    for rgba, t0, t1 in chunks:
        fold(*state, rgba, t0, t1, thr, max_k=k)
    return state


def check_event_case(tag, chunks, thr, k, base=None):
    """B8 and B9 over ``chunks`` from ``base`` (default: the initial
    state) against their plain versions and B7: slot counters exact,
    colour and depth within 1e-6. Returns (largest difference, whether
    both equal B7 bit for bit)."""
    import torch

    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    h, w = thr.shape
    if base is None:
        base = cm.init_packed(k, h, w, device=thr.device)
    flat = lambda st: (*st[0], st[1])
    state = lambda: ((base[0].clone(), base[1].clone()), base[2].clone())
    b7 = clone(base)
    for rgba, t0, t1 in chunks:
        cm.fold_chunk(b7, rgba, t0, t1, thr, max_k=k)
    err, bitwise = 0.0, True
    for name, fold, plain in (
            ("events_fold_chunk", fm.events_fold_chunk,
             fm.events_fold_chunk_plain),
            ("scratch_fold_chunk", fm.scratch_fold_chunk,
             fm.scratch_fold_chunk_plain)):
        got = flat(fold_events(fold, state(), chunks, thr, k))
        want = flat(fold_events(plain, state(), chunks, thr, k))
        torch.cuda.synchronize()
        for other, what in ((want, "its plain version"), (b7, "B7")):
            if not torch.equal(got[2][11], other[2][11]):
                raise AssertionError(f"{name}_{tag}: slot counters differ "
                                     f"from {what}")
        e = max(packed_err(got, want), packed_err(got, b7))
        check(f"{name}_{tag}", e, 1e-6)
        err = max(err, e)
        bitwise = bitwise and packed_equal(got, b7)
    log(f"events_{tag}.pixels_at_slot_cap",
        f"{float((b7[2][11] == k - 1).float().mean()):.4f}; B8 and B9 "
        f"{'equal' if bitwise else 'differ from'} B7 bit for bit")
    return err, bitwise


def check_event_folds(dev):
    """Phase 6 (a): B8 and B9 against their plain versions and B7 on the
    frame's captured chunks (K = 16) and on seeded streams at 320 x 320
    and 640 x 640 (C = 16, K = 16, after one folded chunk), and a K = 4
    stream that fills the slot cap; then each kernel's time against its
    bound and its plain version at 640 x 640, with B7's in the same run,
    and the registers, local memory and block size of each timed build."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    g = gs_init(dev)
    cap = capture_chunks(dev, g.u, g.v, (0.0, 0.6, 3.0))
    del g
    length = cap["length"]
    frame = [(rgba, planes(sk0, length), planes(sk1, length))
             for rgba, sk0, sk1 in cap["chunks"]]
    err, bitwise = check_event_case("frame_chunks", frame, cap["thr"], K)
    del cap, frame
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    seeded = {}
    for side, k, n in EVENT_SEEDED:
        thr = (0.05 + 0.5 * torch.rand((side, side), generator=gen,
                                       device=dev))
        pre = seeded_stream(CHUNK, side, side, dev, 99)
        t = lambda i: torch.full((CHUNK, side, side), 0.0, device=dev) + \
            (0.1 * (i * CHUNK + 1 + torch.arange(
                CHUNK, device=dev, dtype=torch.float32)))[:, None, None]
        base = cm.init_packed(k, side, side, device=dev)
        cm.fold_chunk_plain(base, pre, t(0), t(0) + 0.1, thr, max_k=k)
        chunks = [(seeded_stream(CHUNK, side, side, dev, SEED + 10 + i),
                   t(i + 1), t(i + 1) + 0.1) for i in range(n)]
        e, same = check_event_case(f"seeded_{side}_K{k}", chunks, thr, k,
                                   base)
        err, bitwise = max(err, e), bitwise and same
        seeded[(side, k)] = (chunks, thr, base)
    log("events.bit_for_bit_with_b7", bitwise)

    side = EVENT_SEEDED[-1][0]
    chunks, thr, base16 = seeded[(side, K)]
    res = {}
    for c, k in EVENT_TIMED:
        rgba, t0, t1 = chunks[0]
        rgba, t0, t1 = (x[:c] if c <= CHUNK else torch.cat([x, x])[:c]
                        for x in (rgba, t0, t1))
        t0, t1 = t0.contiguous(), t1.contiguous()
        base = base16 if k == K else seeded[(side, 4)][2]
        st = lambda: ((base[0].clone(), base[1].clone()), base[2].clone())
        b7 = cm.fold_chunk(clone(base), rgba, t0, t1, thr, max_k=k)
        closes = float((b7[2][11] - base[2][11]).sum())
        b, by = event_bound(rgba, closes)
        b7_ms = median_ms(lambda s: cm.fold_chunk(s, rgba, t0, t1, thr,
                                                  max_k=k), 20,
                          lambda: clone(base))
        for name, fold, plain, which in (
                ("events_fold_chunk", fm.events_fold_chunk,
                 fm.events_fold_chunk_plain, 1),
                ("scratch_fold_chunk", fm.scratch_fold_chunk,
                 fm.scratch_fold_chunk_plain, 2)):
            ms = median_ms(lambda s: fold(*s, rgba, t0, t1, thr, max_k=k),
                           20, st)
            first = (c, k) == EVENT_TIMED[0]
            pms = median_ms(lambda s: plain(*s, rgba, t0, t1, thr, max_k=k),
                            3, st) if first else None
            regs, local, most = kernels.query("fold_chunk_attributes",
                                              which, c, k, nout=3)
            threads = fm.scratch_threads(c) if which == 2 else 256
            log(f"{name}_C{c}_K{k}.ms", f"{ms:.4f} fold_chunk_ms="
                f"{b7_ms:.4f} plain_ms={pms if pms is None else round(pms, 4)}"
                f" bound_ms={b:.4f} ({by}) closes_per_pixel="
                f"{closes / rgba[0, 0].numel():.3f} registers={regs} "
                f"local_bytes={local} threads={threads} "
                f"max_threads={most}")
            if first:
                res[name] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                                 bound_by=by, fold_chunk_ms=b7_ms)
    regs, local, _ = kernels.query("fold_chunk_attributes", 0, CHUNK, K,
                                   nout=3)
    log("fold_chunk.attributes", f"registers={regs} local_bytes={local}")
    return res


def run_microbench(dev):
    """Phase 6 (b): the fold microbenchmark twin with ``--check`` over
    every variant at each grid of MICRO_GRIDS (K = 16, C = 16), its rows
    logged as ``microbench_<grid>``; the launch counts set to 0 before
    the sweep and read after it. B8 and B9 must launch S/C times a march.
    Returns (launches, {grid: rows})."""
    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    rows = {}
    kernels.reset_launches()
    for grid in MICRO_GRIDS:
        rows[grid] = fm.sweep(
            fm.VARIANTS, grid, CHUNK, K, iters=MICRO_ITERS, check=True,
            device=dev,
            emit=lambda r, g=grid: log(f"microbench_{g}", json.dumps(r)))
    launches = kernels.launches()
    require_launched(launches, EVENT_KERNELS.values(), "the microbenchmark "
                     "sweep")
    for variant, name in EVENT_KERNELS.items():
        want = 0
        for grid, rs in rows.items():
            r = next(x for x in rs if x["variant"] == variant)
            per_march = r["launches"].get(name, 0) / r["marches"]
            if per_march != grid // CHUNK:
                raise AssertionError(f"{variant} at S={grid}: {per_march} "
                                     f"launches a march, not "
                                     f"{grid // CHUNK}")
            want += r["launches"][name]
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, the "
                                 f"sweep's rows count {want}")
    log("microbench.launches", json.dumps(launches))
    return launches, rows


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two frames of each path: device "
                         "time by kernel "
                         "and the device's busy share")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scenery_insitu_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("torch", f"{torch.__version__} cuda={torch.version.cuda} "
        f"python={sys.version.split()[0]}")
    dev = torch.device("cuda")
    log("device", torch.cuda.get_device_name(0))
    log("build_s", f"{kernels.build():.2f}")

    t0 = time.perf_counter()

    def phase_done(name):
        log(f"{name}.wall_s", f"{time.perf_counter() - t0:.1f} (since the "
            f"build)")

    g = gs_init(dev)
    cap = capture_chunks(dev, g.u, g.v, (0.0, 0.6, 3.0))
    stencil = check_stencil(dev)
    fold = check_fold_and_count(dev, cap["chunks"], cap["thr"],
                                cap["length"])
    new = check_new_folds(dev, cap)
    del cap
    ranges = check_stencil_ranges(dev, g)
    del g
    torch.cuda.empty_cache()
    phase_done("phase2")
    launches, ref = run_frame(dev, args.profile)
    check_small_frame(dev)
    phase_done("phase3")
    folds = run_fold_frames(dev, ref, args.profile)
    phase_done("phase3b.frames")
    for f in FOLD_KERNELS:
        check_small_frame(dev, f)
    torch.cuda.empty_cache()
    phase_done("phase3b")
    dist_launches, rc, rd = run_dist_frame(dev, args.profile)
    reseg = check_resegment(dev, rc, rd)
    del rc, rd
    torch.cuda.empty_cache()
    check_small_dist(dev)
    phase_done("phase4")
    occ_launches = run_occupancy_frames(dev, ref, args.profile)
    del ref
    torch.cuda.empty_cache()
    phase_done("phase5.frames")
    for f in ("pallas_seg",) + tuple(FOLD_KERNELS) + ("seg", "xla"):
        check_small_frame(dev, f, occupancy="sim")
    torch.cuda.empty_cache()
    run_bench_twin(dev)
    phase_done("phase5")
    events = check_event_folds(dev)
    torch.cuda.empty_cache()
    phase_done("phase6.gates")
    t6 = time.perf_counter()
    micro_launches, _ = run_microbench(dev)
    log("phase6.wall_s", f"{time.perf_counter() - t6:.1f} (the sweep)")
    torch.cuda.empty_cache()
    phase_done("phase6")

    table = [
        dict(name="grayscott_fused", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/stencil.cu",
             replaces="scenery_insitu_tpu/sim/pallas_stencil.py:509",
             launches=launches["grayscott_fused"],
             max_abs_err=stencil[4]["err"], ms=stencil[4]["ms"],
             plain_ms=stencil[4]["plain_ms"],
             bound_ms=stencil[4]["bound_ms"],
             bound_by=stencil[4]["bound_by"], library_ms=None),
        dict(name="seg_fold_compact", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/seg_fold.cu",
             replaces="scenery_insitu_tpu/ops/pallas_seg.py:237",
             launches=launches["seg_fold_compact"],
             max_abs_err=fold[16]["seg"]["err"], ms=fold[16]["seg"]["ms"],
             plain_ms=fold[16]["seg"]["plain_ms"],
             bound_ms=fold[16]["seg"]["bound_ms"],
             bound_by=fold[16]["seg"]["bound_by"], library_ms=None),
        dict(name="count_multi", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/count_multi.cu",
             replaces="scenery_insitu_tpu/ops/pallas_march.py:426",
             launches=launches["count_multi"],
             max_abs_err=fold[16]["count"]["err"],
             ms=fold[16]["count"]["ms"],
             plain_ms=fold[16]["count"]["plain_ms"],
             bound_ms=fold[16]["count"]["bound_ms"],
             bound_by=fold[16]["count"]["bound_by"], library_ms=None),
        dict(name="resegment_sorted", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/resegment.cu",
             replaces="scenery_insitu_tpu/ops/pallas_composite.py:172",
             launches=dist_launches["resegment_sorted"],
             max_abs_err=max(r["err"] for r in reseg.values()),
             ms=reseg["frame_block"]["ms"],
             plain_ms=reseg["frame_block"]["plain_ms"],
             bound_ms=reseg["frame_block"]["bound_ms"],
             bound_by=reseg["frame_block"]["bound_by"], library_ms=None),
    ]
    # the kernels of this slice: B1b has no caller on any path (the
    # reference's planes form serves tests only), so its launches on
    # the paths are 0; each fold kernel's count is its fold frame's run
    sources = {"seg_fold_planes": ("seg_fold.cu", "ops/pallas_seg.py:252"),
               "fold_chunk": ("fold_chunk.cu", "ops/pallas_march.py:367"),
               "fused_fold_chunk": ("fused_fold.cu", "ops/pallas_seg.py:426"),
               "fused_stream_fold": ("fused_fold.cu",
                                     "ops/pallas_seg.py:514")}
    runs = {name: folds[f][0][name] for f, name in FOLD_KERNELS.items()}
    runs["seg_fold_planes"] = launches["seg_fold_planes"]
    for name, (src, site) in sources.items():
        r = new[name]
        table.append(dict(
            name=name, route="cuda",
            source=f"scenery_insitu_tpu_torch/csrc/{src}",
            replaces=f"scenery_insitu_tpu/{site}", launches=runs[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None))
    # K3's one body replaces both stencil sites (3-D and 2-D grids), and
    # B4b both sites' ranges epilogue
    table[0]["also_replaces"] = ["scenery_insitu_tpu/sim/pallas_stencil.py"
                                 ":240"]
    table.append(dict(
        name="grayscott_fused_ranges", route="cuda",
        source="scenery_insitu_tpu_torch/csrc/stencil.cu",
        replaces="scenery_insitu_tpu/sim/pallas_stencil.py:125",
        also_replaces=["scenery_insitu_tpu/sim/pallas_stencil.py:404"],
        launches=occ_launches["sim"]["grayscott_fused_ranges"],
        max_abs_err=ranges[4]["err"], ms=ranges[4]["ms"],
        plain_ms=ranges[4]["plain_ms"], bound_ms=ranges[4]["bound_ms"],
        bound_by=ranges[4]["bound_by"], library_ms=None))
    # the microbenchmark's deferred-event folds: launches from its sweep
    for name, site in (("events_fold_chunk", "benchmarks/fold_microbench.py"
                        ":237"),
                       ("scratch_fold_chunk", "benchmarks/fold_microbench.py"
                        ":346")):
        r = events[name]
        table.append(dict(
            name=name, route="cuda",
            source="scenery_insitu_tpu_torch/csrc/fold_chunk.cu",
            replaces=site, launches=micro_launches[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None))
    log("library_ms", "null for every kernel: no single PyTorch call "
        "computes the fused Gray-Scott steps, the segmented write fold, "
        "the multi-threshold count, the sort-and-resegment of a "
        "supersegment stream, the supersegment machine (with its close "
        "events deferred or not), the shading "
        "and fold of a value stream or the stencil with per-brick "
        "ranges")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def gs_init(dev):
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    return gs.multi_step_fast(st, 2 * SIM_STEPS)


if __name__ == "__main__":
    sys.exit(main())

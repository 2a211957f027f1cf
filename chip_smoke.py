#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's in-situ frames on one CUDA card: the
single-chip frame, the distributed sort-last frame and the fold
microbenchmark.

    python3 chip_smoke.py               # the whole run (needs one card)
    python3 chip_smoke.py --profile     # + device time by kernel
    python3 chip_smoke.py --k4-compare old=OTHER/resegment.cu \
        --k2-compare old=OTHER/count_multi.cu \
        --events-compare old=OTHER/fold_chunk.cu  # + designs in turns

``--profile`` adds to each frame of phases 3 to 5 two profiled frames:
device time by kernel and by operator, each of the port's own kernels'
device ms and launches a frame by build (``<prefix>.port_kernel``),
the busy share, the idle gaps, copies and synchronisations.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions, and the build of every kernel from ``csrc/`` with its wall
   seconds;
2. every kernel against its plain PyTorch version on the card, on seeded
   inputs at the flagship shapes and on real chunks of the frame: K3
   (fused Gray-Scott stencil) at 512^3 for T=4 and T=2, bit for bit,
   with the registers, local bytes, shared bytes, resident blocks an SM
   and tile of its build for each T and its achieved GB/s, K1 (segmented
   write fold) and K2 (multi-threshold count) at C=16 and C=1, K=16,
   B=16, 640x640, and on the frame's own chunks; K1's builds (C=16, and
   the generic one C=1 takes; registers, local and shared bytes, blocks
   an SM) and, over one frame's 32 chunks, its summed time ("K1 ms a
   frame") with that work's bound (the bytes the 32 folds need from
   HBM; the sum of the launches' own bounds beside it), GB/s and the
   histogram of the slots a pixel touches a chunk; B1b (K1's planes form) equal to K1 bit for bit on the
   frame's chunks and a seeded chunk; B7 (the machine's fold) with and
   without its count on a seeded chunk and the frame's chunks; B5 (shade
   and fold) on the frame's raw value chunks and B6 over the whole raw
   stream, B6 equal to B5 chunk after chunk bit for bit; B5's and B6's
   builds (C = 16, C = 1, the generic one), B5 on the fullest chunk and
   on dead chunks of 1 and 16 planes, "B5 a frame" (the 32 chunks the
   ``pallas_fused`` march feeds, folded in order into a fresh state,
   with its bound counted once for the frame and the dead, live-but-empty
   and non-empty shares of its samples) and B6 over the stream, each
   with its GB/s. Each prints its largest difference against the stated
   tolerance, its median time from CUDA events (K3's and B4b's of 10
   launches back to back, so the wrapper's host time hides behind the
   previous launch; K1's, B1b's, K2's, B7's, B5's and B6's of 10 (B6 5)
   launches back to back behind a device sleep, each on a state cloned
   before the window, with the one-launch time beside),
   the plain version's time, and its bound (the larger of bytes / 3.35
   TB/s and operations / 67 TFLOP/s, the H100 SXM's f32 rate outside the
   tensor cores). ``--k1-compare NAME=PATH`` serves the same wrapper
   from another design of ``csrc/seg_fold.cu`` (e.g. an earlier
   commit's), checks it the same way and times it in turns with K1 and
   B1b (K1, other, other, K1) on the seeded chunks and the frame's
   chunks; ``--fused-compare NAME=PATH`` does the same for
   ``csrc/fused_fold.cu`` with B5 and B6 (the fullest chunk, the dead
   chunks, B5 a frame, B6). K2 is timed with the stream kept full on
   carries cloned before the window at C = 16 and C = 1 (the one launch
   beside it) and over the threshold seed's 32 chunks counted into a
   fresh carry ("K2 a seed", ``count_frame.ms``, beside its bound with
   the carry read and written once and the sum of the launches' own
   bounds), with its builds (``count_multi.build``: C = 16, 1 and the
   generic one at B = 16, and the padded 32-wide one at B = 5);
   ``--k2-compare NAME=PATH`` serves ``cuda_march.count_multi_chunk``
   from another ``csrc/count_multi.cu``, checks it the same way and
   times it in turns with K2 (C = 16, C = 1, the seed);
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
   (thresholds and live slots exact, colour and depth within 1e-6),
   each timed with the stream kept full (the one launch beside it), and
   the frame's 8 column blocks resegmented back to back as one frame
   (``resegment_frame.ms`` beside ``resegment_frame.bound_ms``), with
   K4's builds (``resegment.build``: the frame's, the one without the
   search and the shared-memory list of a K_out above 16);
   ``--k4-compare NAME=PATH`` serves ``cuda_composite.resegment_sorted``
   from another ``csrc/resegment.cu``, checks it the same way and times
   it in turns with K4 (the seeded stream, the fullest block, the
   frame);
   then the distributed frame on a 32^3 volume over 4 ranks held
   against the CPU's plain versions in both march regimes;
5. the sim-fused occupancy frame: (a) B4b (K3 with the ranges epilogue,
   checked with phase 2's kernels on its state) on the 512^3 state at
   T=4 and T=2 and on ragged grids whose brick edges fall inside K3's
   tiles and z segments (v partly negative on one), its u', v' equal to
   K3's bit for bit and its per-brick ranges equal to its plain
   version's and to ``field_ranges`` of its own v' exactly, timed
   against K3 in turns, with its builds as phase 2 logs K3's; (b) the
   flagship frame of phase 3 under
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
   they equal B7 bit for bit; B7, B8 and B9 timed at 640 x 640 for
   several (C, K) with the stream kept full (10 launches behind a device
   sleep, each on a state cloned before the window; the one launch
   beside), against their bound, with the registers, local bytes, shared
   bytes, resident blocks an SM, threads and close events a thread of
   each build; then a march: the microbenchmark's own stream at S = 512
   on 640 x 640 generated once, B8 and B9 against their plain versions
   and B7 over it, the closes a pixel a chunk, and B7, B8 and B9 each
   folding its 32 chunks back to back from the initial state behind a
   device sleep, against the march's bound (``*_march.ms``);
   ``--events-compare NAME=PATH`` serves the B8 and B9 wrappers from
   another ``csrc/fold_chunk.cu``, checks it at every gate above and
   times it in turns (new, other, other, new) at C = 16, K = 16 and over
   the march; (b) the twin's sweep with ``--check`` over every variant
   at S = 256 (320 x 320) and S = 512 (640 x 640), K = 16, C = 16, its
   JSON rows logged, the launch counts set to 0 before it and read after
   it (B8 and B9 each S/C launches a march; B1b, which the
   ``pallas_seg`` and ``tf_pallas_seg`` variants run, must launch: the
   kernel table's B1b count is this sweep's).

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import re
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
# phase 6 (a)'s march: the microbenchmark's stream at S = 512 (640 x 640)
MARCH_S = 512
# device sleep ahead of a timed window (~10 ms at the H100's clocks), so
# the host's launches queue behind it
LEAD_CYCLES = 20_000_000
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


def stream_ms(fn, launches: int = 10, reps: int = 5,
              behind_sleep: bool = False) -> float:
    """Device ms a call of ``fn()`` with the stream kept full: the median
    over ``reps`` of the CUDA-event time of ``launches`` calls back to
    back, over ``launches``. Unlike `median_ms` of one call, the host's
    time in the wrapper hides behind the previous launch. With
    ``behind_sleep`` the calls also queue behind `lead`, so a wrapper
    whose host time exceeds its kernel's device time is still timed by
    the device."""
    import torch

    def setup():
        torch.cuda.synchronize()
        lead()

    def run(_):
        for _ in range(launches):
            fn()                    # each result freed before the next

    return median_ms(run, reps, setup if behind_sleep else None) / launches


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
    log_stencil_builds("stencil", ranges=False)
    out = {}
    for t in (4, 2):
        uk, vk = cst.step_fused(u, v, p, t)
        up, vp = cst.step_fused_plain(u, v, p, t)
        torch.cuda.synchronize()
        err = max(max_abs(uk, up), max_abs(vk, vp))
        check(f"stencil_T{t}", err, 1e-6 * t)
        # the kernel repeats the plain version's operations: bit for bit
        if not (torch.equal(uk, up) and torch.equal(vk, vp)):
            raise AssertionError(f"stencil_T{t}: K3 differs from its plain "
                                 f"version")
        ms = stream_ms(lambda: cst.step_fused(u, v, p, t))
        one = median_ms(lambda _: cst.step_fused(u, v, p, t), 10)
        pms = median_ms(lambda _: cst.step_fused_plain(u, v, p, t), 3)
        cells = u.numel()
        b, by = bound_ms(4 * 4 * cells,
                         STENCIL_FLOPS_PER_CELL_STEP * t * cells)
        log(f"stencil_T{t}.ms", f"{ms:.4f} plain_ms={pms:.4f} "
            f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f} (the host's "
            f"wrapper time included)")
        log(f"stencil_T{t}.achieved_gb_s", f"{4 * 4 * cells / ms / 1e6:.1f} "
            f"(the bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
        out[t] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by)
    return out


def log_stencil_builds(prefix, ranges):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM and the tile of K3's (``ranges=False``) or B4b's build for every
    T, from ``cudaFuncGetAttributes`` and the occupancy calculator."""
    from scenery_insitu_tpu_torch.sim import cuda_stencil as cst

    for t in range(1, cst.FUSE_T + 1):
        a = cst.attributes(t, ranges)
        log(f"{prefix}_T{t}.build",
            f"registers={a['registers']} local_bytes={a['local_bytes']} "
            f"shared_bytes={a['shared_bytes']} "
            f"blocks_per_sm={a['blocks_per_sm']} threads={a['threads']} "
            f"core={a['core_x']}x{a['core_y']} seg_z={a['seg_z']}")


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


def touched_mask(rgba, small, thr, k):
    """The state rows one K1 call reads and writes: bool [K, H, W], true
    where a non-empty slice of this chunk lands in slot s of a pixel."""
    import torch

    from scenery_insitu_tpu_torch.ops import seg_fold as sf

    emp, starts = sf.chunk_flags(rgba, small[1:4], small[4] > 0.5, thr)
    sid = small[0][None] + torch.cumsum(starts.to(torch.float32), 0) - 1
    slot = torch.clamp(sid, 0, k - 1)
    return torch.stack([((slot == s) & ~emp).any(0) for s in range(k)])


def touched_rows(rgba, small, thr, k):
    """(pixel, slot) state rows one K1 call reads and writes."""
    return int(touched_mask(rgba, small, thr, k).sum())


def k1_work(rgba, small, thr, k):
    """(bytes, operations) one K1 call on these inputs must move and do:
    rgba, length and threshold read, the ratios, small read and written,
    and the touched rows read and written."""
    c, _, h, w = rgba.shape
    hw = h * w
    rows = touched_rows(rgba, small, thr, k)
    nbytes = 4 * (c * 4 * hw + 2 * hw + 2 * c + 2 * 5 * hw + 2 * 6 * rows)
    return nbytes, SEG_FLOPS_PER_PIXEL_SLICE * c * hw


def lead():
    """Enqueue ~10 ms of device sleep, so that the launches the host
    makes next queue up behind it and a window opened after it holds
    device time only (the stream kept full)."""
    import torch

    torch.cuda._sleep(LEAD_CYCLES)


def fresh_ms(fold, base, launches=10, reps=5) -> float:
    """Device ms a call of ``fold(state)`` with the stream kept full:
    ``launches`` calls back to back, each on its own copy of ``base``
    cloned before the window (so each does the same work as one call on
    ``base``), behind `lead`; the median over ``reps`` over
    ``launches``."""
    import torch

    def setup():
        states = [clone(base) for _ in range(launches)]
        torch.cuda.synchronize()
        lead()
        return states

    def run(states):
        for st in states:
            fold(st)

    return median_ms(run, reps, setup) / launches


def compare_designs(specs, lib, query, log_builds, tag, *wrappers):
    """{name: (wrapper, ...)} for each ``NAME=PATH`` of ``specs``,
    another design of ``csrc/<lib>.cu`` with the same C entries: each of
    ``wrappers`` served by that source's build
    (`kernels.source_override`), built here; each build's attributes are
    logged by ``log_builds`` where its source has the ``query``."""
    from scenery_insitu_tpu_torch import kernels

    def served(fn, path):
        def call(*args, **kw):
            with kernels.source_override(lib, path):
                return fn(*args, **kw)
        return call

    out = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        with kernels.source_override(lib, path):
            secs = kernels.build([lib])
            log(f"{tag}_{name}.build_s", f"{secs:.1f}")
            with open(path) as f:
                if query in f.read():
                    log_builds(f"{tag}_{name}_")
        out[name] = tuple(served(fn, path) for fn in wrappers)
    return out


def compare_folds(specs):
    """{name: fold} for each ``NAME=PATH`` of ``--k1-compare``, another
    design of ``csrc/seg_fold.cu``: fold is `cuda_seg.fold_chunk_packed`
    served by that source's build."""
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    return {name: fold for name, (fold,) in compare_designs(
        specs, "seg_fold", "seg_fold_attributes", log_k1_builds,
        "k1_compare", cs.fold_chunk_packed).items()}


def log_k1_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and slices held at once of K1's and B1b's builds
    (C = 16 unrolled; the generic one, which C = 1 takes), from
    ``cudaFuncGetAttributes`` and the occupancy calculator."""
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    for planes, tag in ((False, "seg_fold"), (True, "seg_fold_planes")):
        for c, name in ((16, "C16"), (1, "C1_generic")):
            a = cs.attributes(c, planes)
            log(f"{prefix}{tag}_{name}.build",
                " ".join(f"{n}={v}" for n, v in a.items()))


def k2_work(rgba, b):
    """Bytes and operations of one K2 launch: the chunk and the
    thresholds read once, the counts, prev rgb and prev-empty read and
    written once; a distance and B compares and adds a slice."""
    c, _, h, w = rgba.shape
    hw = h * w
    nbytes = 4 * (c * 4 * hw + b + 2 * b * hw + 2 * 3 * hw + 2 * hw)
    return nbytes, (8 + 2 * b) * c * hw


def log_k2_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and slices whose loads go out together of K2's
    builds (C = 16 and C = 1 fixed, the generic one; B = 16 exact, the
    padded 32-wide one), from ``cudaFuncGetAttributes`` and the occupancy
    calculator."""
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    for c, b in ((16, BINS), (1, BINS), (7, BINS), (16, 5)):
        a = cm.count_attributes(c, b)
        log(f"{prefix}count_multi.build", f"C={c} B={b} " + " ".join(
            f"{n}={v}" for n, v in a.items()))


def compare_counts(specs):
    """{name: count} for each ``NAME=PATH`` of ``--k2-compare``, another
    design of ``csrc/count_multi.cu``: count is
    `cuda_march.count_multi_chunk` served by that source's build."""
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    return {name: count for name, (count,) in compare_designs(
        specs, "count_multi", "count_multi_attributes", log_k2_builds,
        "k2_compare", cm.count_multi_chunk).items()}


def check_counts(name, got, want):
    """K2's carry ``got`` against the plain version's ``want``: every
    count, prev rgb and prev-empty flag exactly."""
    import torch

    mism = int((got[0] != want[0]).sum())
    log(f"{name}.mismatches", f"{mism} (must be 0)")
    err = max(packed_err(got[1:], want[1:]),
              float((got[0] - want[0]).abs().max()))
    check(name, err, 0.0)
    if mism or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: counts differ from the plain version")
    return err


def k2_frame(chunks, tvec, h, w, dev, compare):
    """K2 over the threshold seed's counting march: the frame's 32
    chunks counted in order into a fresh carry, all launches back to
    back behind `lead`, the median of 5; each ``compare`` build in
    turns. The bound counts the same work with the carry (counts, prev
    rgb, prev-empty) read and written once; the sum of the 32 launches'
    own bounds, which count the carry at every launch, is logged beside
    it."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    def setup():
        st = cm.init_count_multi_packed(BINS, h, w, device=dev)
        torch.cuda.synchronize()
        lead()
        return st

    run = lambda count: (lambda st: count_chunks(count, st, chunks, tvec))
    k2 = run(cm.count_multi_chunk)
    ms = median_ms(k2, 5, setup)
    launch_bytes = sum(k2_work(c[0], BINS)[0] for c in chunks)
    flops = sum(k2_work(c[0], BINS)[1] for c in chunks)
    carry = 4 * (2 * BINS + 2 * 3 + 2) * h * w
    nbytes = launch_bytes - (len(chunks) - 1) * carry
    bound, by = bound_ms(nbytes, flops)
    launch_bound, _ = bound_ms(launch_bytes, flops)
    log("count_frame.bound_ms", f"{bound:.4f} ({by}; the {len(chunks)} "
        f"chunks read once, the carry read and written once)")
    log("count_frame.ms", f"{ms:.4f} bound_ms={bound:.4f} launches="
        f"{len(chunks)}; the stream kept full, a fresh carry each time")
    log("count_frame.launch_bounds_sum_ms", f"{launch_bound:.4f} (the "
        f"carry counted at each of the {len(chunks)} launches)")
    log("count_frame.achieved_gb_s", f"{nbytes / ms / 1e6:.1f} (the "
        f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
    compare_ms = {}
    for name, count in compare.items():
        turns = [median_ms(f, 5, setup) for f in (k2, run(count), run(count),
                                                  k2)]
        log(f"count_frame.vs_{name}", in_turns(turns, nbytes, "k2"))
        compare_ms[name] = (turns[1] + turns[2]) / 2
    return dict(ms=ms, bound_ms=bound, bound_by=by, compare_ms=compare_ms)


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


def check_fold_and_count(dev, real_chunks, real_thr, real_length,
                         compare=None, k2_compare=None):
    """K1 and K2 against their plain versions on seeded chunks at C = 16
    and C = 1 and on the frame's own chunks. Both are timed with the
    stream kept full on states cloned before the window (`fresh_ms`;
    the one launch beside it), and over the frame's chunks as one frame
    folds (K1) or the threshold seed counts (K2) them; each ``compare``
    build (``--k1-compare``) and ``k2_compare`` build (``--k2-compare``)
    is checked the same way and timed in turns (ours, other, other,
    ours)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_march as cm
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs
    from scenery_insitu_tpu_torch.ops import supersegments as ss

    compare = compare or {}
    k2_compare = k2_compare or {}
    log_k1_builds()
    log_k2_builds()
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
        args = dict(max_k=K, sk0=sk0, sk1=sk1, length=length)
        plain = cs.fold_chunk_packed_plain(clone(base), rgba, thr, **args)
        folds = {"k1": cs.fold_chunk_packed, **compare}
        errs = {}
        for name, fold in folds.items():
            got = fold(clone(base), rgba, thr, **args)
            torch.cuda.synchronize()
            tag = f"seg_fold_C{c}" + ("" if name == "k1" else f"_{name}")
            errs[name] = packed_err(got, plain)
            check(tag, errs[name], 1e-5)
            if not torch.equal(got[2][0], plain[2][0]):
                raise AssertionError(f"{tag}: start counts differ")
        err1 = errs["k1"]
        k1 = lambda st: cs.fold_chunk_packed(st, rgba, thr, **args)
        ms1 = fresh_ms(k1, base)
        one = median_ms(k1, 20, lambda: clone(base))
        pms1 = median_ms(lambda st: cs.fold_chunk_packed_plain(
            st, rgba, thr, **args), 3, lambda: clone(base))
        nbytes, flops = k1_work(rgba, base[2], thr, K)
        b1, by1 = bound_ms(nbytes, flops)
        log(f"seg_fold_C{c}.ms", f"{ms1:.4f} plain_ms={pms1:.4f} "
            f"bound_ms={b1:.4f} ({by1}) one_launch_ms={one:.4f} (the "
            f"host's wrapper time included); stream kept full on states "
            f"cloned before the window")
        log(f"seg_fold_C{c}.achieved_gb_s", f"{nbytes / ms1 / 1e6:.1f} (the "
            f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak); touched "
            f"rows a pixel {touched_rows(rgba, base[2], thr, K) / (h * w):.3f}")
        for name, fold in compare.items():
            other = lambda st: fold(st, rgba, thr, **args)
            turns = [fresh_ms(f, base) for f in (k1, other, other, k1)]
            log(f"seg_fold_C{c}.vs_{name}", in_turns(turns, nbytes))

        # a carry that has already counted one chunk
        cbase = cm.count_multi_chunk_plain(
            cm.init_count_multi_packed(BINS, h, w, device=dev),
            seeded_stream(16, h, w, dev, 98), tvec)
        cp = cm.count_multi_chunk_plain(clone(cbase), rgba, tvec)
        err2 = check_counts(f"count_C{c}", cm.count_multi_chunk(
            clone(cbase), rgba, tvec), cp)
        for name, count in k2_compare.items():
            check_counts(f"count_C{c}_{name}", count(clone(cbase), rgba,
                                                     tvec), cp)
        k2 = lambda st: cm.count_multi_chunk(st, rgba, tvec)
        ms2 = fresh_ms(k2, cbase)
        one2 = median_ms(k2, 20, lambda: clone(cbase))
        pms2 = median_ms(lambda st: cm.count_multi_chunk_plain(
            st, rgba, tvec), 3, lambda: clone(cbase))
        nbytes2, flops2 = k2_work(rgba, BINS)
        b2, by2 = bound_ms(nbytes2, flops2)
        log(f"count_C{c}.ms", f"{ms2:.4f} plain_ms={pms2:.4f} "
            f"bound_ms={b2:.4f} ({by2}) one_launch_ms={one2:.4f} (the "
            f"host's wrapper time included); stream kept full on states "
            f"cloned before the window")
        log(f"count_C{c}.achieved_gb_s", f"{nbytes2 / ms2 / 1e6:.1f} (the "
            f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
        k2_ms = {}
        for name, count in k2_compare.items():
            other = lambda st: count(st, rgba, tvec)
            turns = [fresh_ms(f, cbase) for f in (k2, other, other, k2)]
            log(f"count_C{c}.vs_{name}", in_turns(turns, nbytes2, "k2"))
            k2_ms[name] = (turns[1] + turns[2]) / 2
        res[c] = dict(seg=dict(err=err1, ms=ms1, plain_ms=pms1, bound_ms=b1,
                               bound_by=by1, one_launch_ms=one),
                      count=dict(err=err2, ms=ms2, plain_ms=pms2,
                                 bound_ms=b2, bound_by=by2,
                                 one_launch_ms=one2, compare_ms=k2_ms))

    # the frame's own shaded chunks, folded and counted end to end
    init = lambda: cs.init_seg_packed(K, h, w, device=dev)
    smalls = []
    kern = init()
    for rgba, sk0, sk1 in real_chunks:
        smalls.append(kern[2].clone())
        cs.fold_chunk_packed(kern, rgba, real_thr, max_k=K, sk0=sk0, sk1=sk1,
                             length=real_length)
    plain = fold_chunks(cs.fold_chunk_packed_plain, init(), real_chunks,
                        real_thr, real_length)
    torch.cuda.synchronize()
    err = packed_err(kern, plain)
    check("seg_fold_frame_chunks", err, 1e-5)
    if not torch.equal(kern[2][0], plain[2][0]):
        raise AssertionError("seg_fold_frame_chunks: start counts differ")
    for name, fold in compare.items():
        got = fold_chunks(fold, init(), real_chunks, real_thr, real_length)
        torch.cuda.synchronize()
        check(f"seg_fold_frame_chunks_{name}", packed_err(got, plain), 1e-5)
    res["frame"] = k1_frame(real_chunks, smalls, real_thr, real_length,
                            init, compare)
    res["frame"]["err"] = err
    del kern, plain, smalls

    init = lambda: cm.init_count_multi_packed(BINS, h, w, device=dev)
    cp = count_chunks(cm.count_multi_chunk_plain, init(), real_chunks, tvec)
    for name, count in {"k2": cm.count_multi_chunk, **k2_compare}.items():
        check_counts("count_frame_chunks" + ("" if name == "k2" else
                                             f"_{name}"),
                     count_chunks(count, init(), real_chunks, tvec), cp)
    del cp
    log("frame_chunks", f"{len(real_chunks)} (C="
        f"{sorted({c[0].shape[0] for c in real_chunks})})")
    res["count_frame"] = k2_frame(real_chunks, tvec, h, w, dev, k2_compare)
    return res


def in_turns(turns, nbytes, tag="k1"):
    """The log line of a timing in turns (ours, other, other, ours), ours
    named ``tag``."""
    ms, other = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return (f"{tag}_ms={ms:.4f} other_ms={other:.4f} other/{tag}="
            f"{other / ms:.3f} turns={'/'.join(f'{x:.4f}' for x in turns)} "
            f"{tag}_gb_s={nbytes / ms / 1e6:.1f} other_gb_s="
            f"{nbytes / other / 1e6:.1f}")


def k1_frame(chunks, smalls, thr, length, init, compare):
    """K1 over one flagship frame's write march: its captured chunks
    folded in order into a fresh state, all launches back to back behind
    `lead` (the stream kept full), the median of 5; the bound of the
    same work; the histogram of the slots a pixel touches a chunk. Each
    ``compare`` build in turns.

    The bound counts the bytes the 32 folds need from HBM: every chunk's
    rgba and ratios, the small state, threshold and length read once and
    the small state written once, and each (pixel, slot) row any chunk
    touches read once and written once. The sum of the 32 launches'
    own bounds, which count the per-pixel state and the rows at every
    launch, is logged beside it."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    run = lambda fold: (lambda st: fold_chunks(fold, st, chunks, thr,
                                               length))

    def setup():
        st = init()
        torch.cuda.synchronize()
        lead()
        return st

    k1 = run(cs.fold_chunk_packed)
    ms = median_ms(k1, 5, setup)
    h, w = thr.shape
    rows = torch.zeros((K, h, w), dtype=torch.bool, device=thr.device)
    hist = torch.zeros(K + 1, dtype=torch.int64, device=thr.device)
    nbytes, flops, launch_bytes = 4 * (2 * 5 + 2) * h * w, 0, 0
    for (rgba, _, _), small in zip(chunks, smalls):
        c = rgba.shape[0]
        mask = touched_mask(rgba, small, thr, K)
        rows |= mask
        hist += torch.bincount(mask.sum(0).flatten(), minlength=K + 1)
        nbytes += 4 * (c * 4 * h * w + 2 * c)
        b, f = k1_work(rgba, small, thr, K)
        launch_bytes, flops = launch_bytes + b, flops + f
    nbytes += 4 * 2 * 6 * int(rows.sum())
    bound, by = bound_ms(nbytes, flops)
    launch_bound, _ = bound_ms(launch_bytes, flops)
    n_c = collections.Counter(rgba.shape[0] for rgba, _, _ in chunks)
    log("seg_fold_frame.ms", f"{ms:.4f} bound_ms={bound:.4f} ({by}; "
        f"{nbytes / (h * w):.1f} B a pixel) launches={len(chunks)} (chunks "
        f"by C: {dict(n_c)}); the stream kept full, a fresh state each time")
    log("seg_fold_frame.launch_bounds_sum_ms", f"{launch_bound:.4f} "
        f"({launch_bytes / (h * w):.1f} B a pixel: the per-pixel state "
        f"and rows counted at each of the {len(chunks)} launches)")
    log("seg_fold_frame.achieved_gb_s", f"{nbytes / ms / 1e6:.1f} (the "
        f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
    hist = hist.tolist()
    live = sum(hist[1:])
    log("seg_fold_frame.touched_slots", json.dumps(
        {"pixel_chunks_by_slots": {i: n for i, n in enumerate(hist) if n},
         "share_touching_none": hist[0] / sum(hist),
         "mean_over_touching": sum(i * n for i, n in enumerate(hist))
         / max(live, 1)}))
    for name, fold in compare.items():
        other = run(fold)
        turns = [median_ms(f, 5, setup) for f in (k1, other, other, k1)]
        log(f"seg_fold_frame.vs_{name}", in_turns(turns, nbytes))
    return dict(ms=ms, bound_ms=bound, bound_by=by)


def planes(sk, length):
    """Depth planes t = sk * length, one f32 multiply each (what the
    compact form computes in the kernel)."""
    return (sk[:, None, None] * length[None]).contiguous()


def packed_equal(a, b):
    return all(bool((x == y).all()) for x, y in zip(a, b))


def fused_work(raw, ratio, tf, rows):
    """Bytes and operations B5 or B6 need to fold the value chunks
    ``raw`` [(val, sk)] in order into one state (what these chunks'
    data needs, not the most it could). Bytes: every value plane and
    its two ratios read once and the knots; prev-empty written for every
    pixel; where a pixel has a live sample (v >= -0.5) its ratio read;
    where it has a non-empty one, its length and threshold read and the
    rest of the small state read and written once; ``rows`` (pixel,
    slot) rows read and written once. Operations: the dead test on every
    sample, the alpha shading and K1's fold on the live ones, the colour
    knots and premultiply on the non-empty ones. Returns (bytes,
    operations, live samples, non-empty samples)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_fused as cf
    from scenery_insitu_tpu_torch.ops import supersegments as ss

    nz_a = int(torch.count_nonzero(tf.alpha_m))
    nz_c = int(torch.count_nonzero(tf.color_m))
    lit = torch.zeros(ratio.shape, dtype=torch.bool, device=ratio.device)
    full = torch.zeros_like(lit)
    planes = live = solid = 0
    for val, _ in raw:
        alive = val >= -0.5
        drawn = cf.shade_plain(val, ratio, tf)[:, 3] >= ss.EMPTY_ALPHA
        lit |= alive.any(0)
        full |= drawn.any(0)
        planes += val.shape[0]
        live += int(alive.sum())
        solid += int(drawn.sum())
    hw = ratio.numel()
    nbytes = 4 * (planes * hw + 2 * planes + cf.NKNOTS + hw + int(lit.sum())
                  + (2 + 5 + 4) * int(full.sum()) + 2 * 6 * rows)
    ops = (DEAD_TEST_FLOPS * planes * hw
           + (ALPHA_FLOPS_PER_SAMPLE + SHADE_FLOPS_PER_KNOT * nz_a
              + SEG_FLOPS_PER_PIXEL_SLICE) * live
           + (SHADE_FLOPS_PER_KNOT * nz_c + PREMUL_FLOPS) * solid)
    return nbytes, ops, live, solid


def check_new_folds(dev, cap, compare=None, fused_compare=None):
    """B1b, B7, B5 and B6 against their plain versions on the card, on
    the frame's captured chunks and on a seeded stream, with their times
    and bounds. B1b must equal K1's compact form bit for bit; B7's
    counts, B5's and B6's start counts exactly, colour and depth within
    1e-6; B6 must equal B5 chunk after chunk bit for bit. B1b is timed as
    K1 is (`fresh_ms`), each ``compare`` build's planes entry in turns
    with it."""
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
    b1b = lambda st: cs.fold_chunk_packed(st, rgba, sthr, max_k=K, t0=t0,
                                          t1=t1)
    ms = fresh_ms(b1b, base)
    one = median_ms(b1b, 20, lambda: clone(base))
    pms = median_ms(lambda st: cs.fold_chunk_packed_plain(
        st, rgba, sthr, max_k=K, t0=t0, t1=t1), 3, lambda: clone(base))
    rows = touched_rows(rgba, base[2], sthr, K)
    nbytes = 4 * (CHUNK * 6 * hw + hw + 2 * 5 * hw + 2 * 6 * rows)
    b, by = bound_ms(nbytes, SEG_FLOPS_PER_PIXEL_SLICE * CHUNK * hw)
    log("seg_fold_planes.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f} (the host's "
        f"wrapper time included); stream kept full on states cloned before "
        f"the window")
    log("seg_fold_planes.achieved_gb_s", f"{nbytes / ms / 1e6:.1f}")
    for name, fold in (compare or {}).items():
        got = fold(clone(base), rgba, sthr, max_k=K, t0=t0, t1=t1)
        torch.cuda.synchronize()
        check(f"seg_fold_planes_{name}", packed_err(got, plain), 1e-5)
        other = lambda st: fold(st, rgba, sthr, max_k=K, t0=t0, t1=t1)
        turns = [fresh_ms(f, base) for f in (b1b, other, other, b1b)]
        log(f"seg_fold_planes.vs_{name}", in_turns(turns, nbytes))
    res["seg_fold_planes"] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                                  bound_by=by, one_launch_ms=one)

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
    b7 = lambda st: cm.fold_chunk(st, rgba, t0, t1, sthr, max_k=K, count=cnt)
    ms = fresh_ms(b7, mbase)
    one = median_ms(b7, 20, lambda: clone(mbase))
    pms = median_ms(lambda st: cm.fold_chunk_plain(
        st, rgba, t0, t1, sthr, max_k=K, count=cnt), 3, lambda: clone(mbase))
    closes = float((kern[2][11] - mbase[2][11]).sum())
    b, by = bound_ms(4 * (CHUNK * 6 * hw + hw + 2 * 12 * hw + 2 * hw
                          + 6 * closes),
                     MACHINE_FLOPS_PER_PIXEL_SLICE * CHUNK * hw)
    log("fold_chunk.ms", f"{ms:.4f} plain_ms={pms:.4f} bound_ms={b:.4f} "
        f"({by}) one_launch_ms={one:.4f} (the host's wrapper time "
        f"included) closes_per_pixel={closes / hw:.3f}; stream kept full on "
        f"states cloned before the window")
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
    # the least a frame's 32 launches need from HBM, counted once for the
    # frame: every sample's rgba and two depths, the 12-float state and
    # the count read and written and the threshold read once, and a
    # 6-float row written at each slot the machine closed
    samples = sum(rgba_c.shape[0] for rgba_c, _, _ in cap["chunks"]) * hw
    closes = float(packs[0][2][11].sum())
    fb, fby = bound_ms(4 * (6 * samples + 2 * 12 * hw + hw + 2 * hw
                            + 6 * closes),
                       MACHINE_FLOPS_PER_PIXEL_SLICE * samples)
    log("fold_chunk_frame.bound_ms", f"{fb:.4f} ({fby}; the frame's "
        f"{len(cap['chunks'])} chunks, {closes / hw:.3f} slots closed a "
        f"pixel)")
    res["fold_chunk"] = dict(err=max(errs), ms=ms, plain_ms=pms, bound_ms=b,
                             bound_by=by, one_launch_ms=one)
    del packs, cnts, mbase

    res.update(check_fused_folds(dev, cap, fused_compare))
    return res


def log_fused_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and slices a stage holds of B5's and B6's builds
    (C = 16 and C = 1 fixed; the generic one), from
    ``cudaFuncGetAttributes`` and the occupancy calculator."""
    from scenery_insitu_tpu_torch.ops import cuda_fused as cf

    for c, name in ((16, "C16"), (1, "C1"), (5, "generic")):
        a = cf.attributes(c)
        log(f"{prefix}fused_fold_{name}.build",
            " ".join(f"{n}={v}" for n, v in a.items()))


def compare_fused(specs):
    """{name: (b5, b6)} for each ``NAME=PATH`` of ``--fused-compare``,
    another design of ``csrc/fused_fold.cu``: the wrappers
    `cuda_fused.fused_fold_chunk` and `fused_stream_fold` served by that
    source's build."""
    from scenery_insitu_tpu_torch.ops import cuda_fused as cf

    return compare_designs(specs, "fused_fold", "fused_fold_attributes",
                           log_fused_builds, "fused_compare",
                           cf.fused_fold_chunk, cf.fused_stream_fold)


def time_vs(compare_ms, key, label, ours, others, nbytes, timer, tag):
    """Each fold of ``others`` {name: fn} timed in turns with ``ours``
    (ours, other, other, ours, each by ``timer``): the log line
    ``<label>.vs_<name>`` and the other's time at
    ``compare_ms[name][key]``."""
    for name, other in others.items():
        turns = [timer(f) for f in (ours, other, other, ours)]
        log(f"{label}.vs_{name}", in_turns(turns, nbytes, tag))
        compare_ms.setdefault(name, {})[key] = (turns[1] + turns[2]) / 2


def check_same(name, got, want):
    """``got`` against the packed state ``want``: start counts exactly,
    colour and depth within 1e-6."""
    import torch

    if not torch.equal(got[2][0], want[2][0]):
        raise AssertionError(f"{name}: start counts differ")
    check(name, packed_err(got, want), 1e-6)


def sample_shares(raw, live, solid):
    """The log line of the shares of the samples of the value chunks
    ``raw`` [(val, sk)] that B5/B6 find dead (v < -0.5), live with a
    corrected alpha below EMPTY_ALPHA, and non-empty (``live`` and
    ``solid`` samples, from `fused_work`)."""
    total = sum(val.numel() for val, _ in raw)
    return json.dumps(dict(samples=total, dead=(total - live) / total,
                           live_empty=(live - solid) / total,
                           non_empty=solid / total))


def check_fused_folds(dev, cap, compare=None):
    """B5 and B6 on the frame's captured value chunks: B5 over the 32
    chunks of the gathered feed (every skipped chunk a whole chunk of -1
    planes) and B6 over their stream against their plain versions (start
    counts exact, colour and depth within 1e-6; B6 equal to B5 chunk
    after chunk bit for bit). Timed with the stream kept full on states
    cloned before the window (`fresh_ms`, one launch beside it): B5 on
    the fullest chunk and on dead chunks of 1 and 16 planes, B6 over the
    stream; "B5 a frame": the 32 chunks the ``pallas_fused`` march feeds
    (a skipped chunk one -1 plane) folded in order into a fresh state,
    all launches back to back behind `lead`, with its own bound (counted
    once for the frame) and the dead, live-but-empty and non-empty
    shares of its samples. Each ``compare`` build (``--fused-compare``)
    is checked the same way and timed in turns (new, other, other,
    new)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_fused as cf
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    compare = compare or {}
    thr, length, ratio, tf, ds = (cap[n] for n in ("thr", "length", "ratio",
                                                   "tf", "ds"))
    h, w = thr.shape
    hw = h * w
    res = {}
    log_fused_builds()
    init = lambda: cs.init_seg_packed(K, h, w, device=dev)
    # the knots built once, as a march does, so no launch in a timed
    # window builds them
    kw = dict(max_k=K, tf=tf, knots=cf.tf_knots(tf))
    args_of = lambda val, sk: (val, length, ratio, sk, (sk + ds).contiguous(),
                               thr)
    # each design's B5 on fixed arguments, and B5 over a feed of them
    b5_of = lambda fold, args: (lambda st: fold(st, *args, **kw))

    def feed_of(fold, feed):
        def run(st):
            for args in feed:
                fold(st, *args, **kw)
            return st
        return run

    designs = lambda make: {name: make(o5, o6)
                            for name, (o5, o6) in compare.items()}

    # B5 over the gathered feed's chunks, from the initial state
    gathered = [args_of(val, sk) for val, sk in cap["raw"]]
    live = [int((val >= -0.5).sum()) for val, _ in cap["raw"]]
    j = live.index(max(live))
    base5 = feed_of(cf.fused_fold_chunk, gathered[:j])(init())
    k5 = feed_of(cf.fused_fold_chunk, gathered[j:])(clone(base5))
    p5 = init()
    for args in gathered:
        cf.fused_fold_chunk_plain(p5, *args, max_k=K, tf=tf)
    torch.cuda.synchronize()
    mism = int((k5[2][0] != p5[2][0]).sum())
    log("fused_fold_chunk_frame_chunks.count_mismatches",
        f"{mism} (must be 0)")
    if mism:
        raise AssertionError("fused_fold_chunk: start counts differ")
    err5 = packed_err(k5, p5)
    check("fused_fold_chunk_frame_chunks", err5, 1e-6)
    del p5
    for name, (o5, _) in compare.items():
        check_same(f"fused_fold_chunk_frame_chunks_{name}",
                   feed_of(o5, gathered)(init()), k5)

    # B5 on the fullest chunk and on dead chunks, stream kept full
    compare_ms = {}
    timer = lambda f: fresh_ms(f, base5)
    val, sk = cap["raw"][j]
    args = gathered[j]
    b5 = b5_of(cf.fused_fold_chunk, args)
    ms = fresh_ms(b5, base5)
    one = median_ms(b5, 20, lambda: clone(base5))
    pms = median_ms(lambda st: cf.fused_fold_chunk_plain(
        st, *args, max_k=K, tf=tf), 3, lambda: clone(base5))
    rows = touched_rows(cf.shade_plain(val, ratio, tf), base5[2], thr, K)
    nbytes, ops, n_live, n_solid = fused_work([(val, sk)], ratio, tf, rows)
    b, by = bound_ms(nbytes, ops)
    log("fused_fold_chunk.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f} (the host's "
        f"wrapper time included); stream kept full on states cloned before "
        f"the window; chunk={j} samples={CHUNK * hw} live={n_live} "
        f"non_empty={n_solid}")
    log("fused_fold_chunk.achieved_gb_s", f"{nbytes / ms / 1e6:.1f} (the "
        f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
    time_vs(compare_ms, "ms", "fused_fold_chunk", b5,
            designs(lambda o5, _: b5_of(o5, args)), nbytes, timer, "b5")
    # what a skipped chunk costs B5: one -1 plane (the chunked feed) or a
    # whole chunk of them (the gathered feed)
    for planes_n in (1, CHUNK):
        dead = torch.full((planes_n, h, w), -1.0, device=dev)
        dsk = sk[:planes_n].contiguous()
        dargs = args_of(dead, dsk)
        d5 = b5_of(cf.fused_fold_chunk, dargs)
        dms = fresh_ms(d5, base5)
        dbytes, dops, _, _ = fused_work([(dead, dsk)], ratio, tf, 0)
        db, dby = bound_ms(dbytes, dops)
        log(f"fused_fold_chunk_dead_C{planes_n}.ms", f"{dms:.4f} "
            f"bound_ms={db:.4f} ({dby}; {dbytes / hw:.1f} B a pixel) "
            f"one_launch_ms={median_ms(d5, 20, lambda: clone(base5)):.4f}; "
            f"stream kept full")
        time_vs(compare_ms, f"dead_C{planes_n}_ms",
                f"fused_fold_chunk_dead_C{planes_n}", d5,
                designs(lambda o5, _: b5_of(o5, dargs)), dbytes, timer,
                "b5")
    del base5

    # B5 a frame: the chunks the pallas_fused march feeds, in order
    feed = cap["raw_b5"]
    fargs = [args_of(v_, s_) for v_, s_ in feed]

    def setup():
        st = init()
        torch.cuda.synchronize()
        lead()
        return st

    b5_frame = feed_of(cf.fused_fold_chunk, fargs)
    frame_ms = median_ms(b5_frame, 5, setup)
    st = b5_frame(init())
    torch.cuda.synchronize()
    if not packed_equal(st, k5):
        raise AssertionError("B5 over the chunked feed differs from B5 over "
                             "the gathered feed")
    planes_n = sum(v_.shape[0] for v_, _ in feed)
    rows = float(torch.clamp(st[2][0], max=K).sum())
    fbytes, fops, f_live, f_solid = fused_work(feed, ratio, tf, rows)
    fb, fby = bound_ms(fbytes, fops)
    n_c = collections.Counter(v_.shape[0] for v_, _ in feed)
    log("fused_fold_frame.ms", f"{frame_ms:.4f} bound_ms={fb:.4f} ({fby}; "
        f"{fbytes / hw:.1f} B a pixel) launches={len(feed)} (chunks by C: "
        f"{dict(n_c)}, {planes_n} planes); the stream kept full, a fresh "
        f"state each time; equal to B5 over the gathered feed bit for bit")
    log("fused_fold_frame.achieved_gb_s", f"{fbytes / frame_ms / 1e6:.1f}")
    log("fused_fold_frame.samples", sample_shares(feed, f_live, f_solid))
    time_vs(compare_ms, "frame_ms", "fused_fold_frame", b5_frame,
            designs(lambda o5, _: feed_of(o5, fargs)), fbytes,
            lambda f: median_ms(f, 5, setup), "b5")
    del st
    res["fused_fold_chunk"] = dict(
        err=err5, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
        one_launch_ms=one, frame_ms=frame_ms, frame_bound_ms=fb,
        compare_ms=compare_ms)

    # B6 over the whole gathered stream
    val = torch.cat([v_ for v_, _ in cap["raw"]])
    sk = torch.cat([s_ for _, s_ in cap["raw"]])
    args = args_of(val, sk)
    b6_of = lambda fold: (lambda st: fold(st, *args, chunk=CHUNK, **kw))
    b6 = b6_of(cf.fused_stream_fold)
    k6 = b6(init())
    p6 = cf.fused_stream_fold_plain(init(), *args, max_k=K, chunk=CHUNK,
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
    del p6
    others6 = designs(lambda _, o6: b6_of(o6))
    for name, other in others6.items():
        check_same(f"fused_stream_fold_{name}", other(init()), k6)
    base6 = init()
    ms = fresh_ms(b6, base6, launches=5)
    one = median_ms(b6, 5, lambda: clone(base6))
    pms = median_ms(lambda st: cf.fused_stream_fold_plain(
        st, *args, max_k=K, chunk=CHUNK, tf=tf), 1, lambda: clone(base6))
    s_total = val.shape[0]
    rows = float(torch.clamp(k6[2][0], max=K).sum())
    nbytes, ops, n_live, n_solid = fused_work(cap["raw"], ratio, tf, rows)
    b, by = bound_ms(nbytes, ops)
    log("fused_stream_fold.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f}; stream kept "
        f"full on states cloned before the window; slices={s_total} "
        f"samples={s_total * hw} live={n_live} non_empty={n_solid}")
    log("fused_stream_fold.achieved_gb_s", f"{nbytes / ms / 1e6:.1f}")
    log("fused_stream_fold.samples", sample_shares(cap["raw"], n_live,
                                                   n_solid))
    compare6 = {}
    time_vs(compare6, "ms", "fused_stream_fold", b6, others6, nbytes,
            lambda f: fresh_ms(f, base6, launches=5), "b6")
    # one launch a march: the frame's B6 time is the march's
    res["fused_stream_fold"] = dict(err=err6, ms=ms, plain_ms=pms,
                                    bound_ms=b, bound_by=by,
                                    one_launch_ms=one, frame_ms=ms,
                                    frame_bound_ms=b, compare_ms=compare6)
    return res


def capture_chunks(dev, u, v, eye):
    """The shaded chunks (rgba, sk0, sk1) of one write march of the
    flagship frame, with its seed threshold and ray lengths, and the same
    march's raw value chunks (val, sk) as the fused folds see them: as
    ``fused_stream`` gathers them (``raw``, every skipped chunk a full
    chunk of -1 planes) and as ``pallas_fused`` feeds them (``raw_b5``,
    a skipped chunk one -1 plane); the raw chunks' opacity ratios and
    the transfer function."""
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
    gathered, raw = raw, []
    slicer.slice_march(vol, tf, axcam, spec, keep_raw, None, occupancy=occ,
                       raw=True)
    length = axcam.ray_lengths().contiguous()
    ds = torch.abs(axcam.dwm) / axcam.zp
    ratio = (ds * length / nominal_step(vol)).contiguous()
    return dict(chunks=chunks, raw=gathered, raw_b5=raw, thr=thr.contiguous(),
                length=length, ds=ds, ratio=ratio, tf=tf)


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
    a frame makes; logged under ``prefix``, with each build of the
    port's own kernels as ``<prefix>.port_kernel``. The Chrome
    trace goes to chiprun_out/<prefix>_trace.json."""
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
    own = collections.defaultdict(lambda: [0.0, 0])
    for ms, n, key in kern:
        m = re.match(r"(void )?\(anonymous namespace\)::(\w+(<[^>]*>)?)",
                     key)
        if m:
            own[m.group(2)][0] += ms
            own[m.group(2)][1] += n
    for name, (ms, n) in sorted(own.items(), key=lambda x: -x[1][0]):
        print(f"{prefix}.port_kernel {ms / frames:10.3f} ms/frame "
              f"{n / frames:6.1f} launches/frame  {name}", flush=True)
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
    """The bound of the resegment of ``sc`` from the bytes and operations
    it needs: every slot's alpha (to know which are empty), the colour
    and depth of the non-empty slots (an empty slot's never enter the
    result), the K_OUT output slots. Returns ((ms, by), non-empty slots
    a pixel, bytes)."""
    nk, _, h, w = sc.shape
    slots = float((~(sc[:, 3] < 1e-4)).sum())
    nbytes = 4 * (nk * h * w + 5 * slots + 6 * K_OUT * h * w)
    return (bound_ms(nbytes, slots * (iters * RESEG_COUNT_FLOPS
                                      + RESEG_WRITE_FLOPS)),
            slots / (h * w), nbytes)


def log_k4_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and the search list of K4's builds: the frame's
    (the search, the list in registers), the one without the search,
    and the one a K_out above 16 takes (the list in shared memory), from
    ``cudaFuncGetAttributes`` and the occupancy calculator."""
    from scenery_insitu_tpu_torch.ops import cuda_composite as cc

    for nk, k_out, iters in ((RANKS * K, K_OUT, COMP_ITERS),
                             (RANKS * K, K_OUT, 0),
                             (RANKS * K, 24, COMP_ITERS)):
        a = cc.attributes(nk, k_out, iters)
        log(f"{prefix}resegment.build", f"nk={nk} k_out={k_out} iters="
            f"{iters} " + " ".join(f"{n}={v}" for n, v in a.items()))


def log_live_slots(prefix, sc):
    """How the non-empty slots of a stream spread over its pixels and its
    warps (32 neighbouring pixels, as K4 takes them): the share of empty
    pixels, the mean over the others, and the fullest pixel of each warp
    that has one (median and max)."""
    n = (~(sc[:, 3] < 1e-4)).sum(0).flatten()
    if not bool((n > 0).any()):
        log(f"{prefix}.live_slots", "no non-empty slot")
        return
    warp_max = n[: n.numel() // 32 * 32].reshape(-1, 32).amax(1).float()
    warp_max = warp_max[warp_max > 0]
    log(f"{prefix}.live_slots",
        f"empty pixels {float((n == 0).float().mean()):.3f}, non-empty "
        f"slots a non-empty pixel {float(n[n > 0].float().mean()):.2f}, a "
        f"warp's fullest pixel median {float(warp_max.median()):.0f} max "
        f"{float(warp_max.max()):.0f}")


def compare_resegments(specs):
    """{name: resegment} for each ``NAME=PATH`` of ``--k4-compare``,
    another design of ``csrc/resegment.cu``: resegment is
    `cuda_composite.resegment_sorted` served by that source's build."""
    from scenery_insitu_tpu_torch.ops import cuda_composite as cc

    return {name: fn for name, (fn,) in compare_designs(
        specs, "resegment", "resegment_attributes", log_k4_builds,
        "k4_compare", cc.resegment_sorted).items()}


def check_k4(name, fn, sc, sd, want):
    """``fn`` (a build of K4) on the stream ``sc``, ``sd`` against the
    plain version's (color, depth, threshold) ``want``: thresholds and
    live slot counts exactly, colour and depth within 1e-6."""
    import torch

    h, w = sc.shape[2:]
    tk = torch.empty((h, w), device=sc.device)
    ck = fn(sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS, threshold_out=tk)
    torch.cuda.synchronize()
    thr_mism = int((tk != want[2]).sum())
    slot_mism = int((torch.isfinite(ck[1][:, 0]).sum(0)
                     != torch.isfinite(want[1][:, 0]).sum(0)).sum())
    log(f"{name}.mismatches", f"thresholds {thr_mism}, live slot counts "
        f"{slot_mism} (must be 0)")
    if thr_mism or slot_mism:
        raise AssertionError(f"{name}: K4 differs from its plain version "
                             f"in thresholds or counts")
    err = max(max_abs(ck[0], want[0]), max_abs(ck[1], want[1]))
    check(name, err, 1e-6)
    return err


def check_resegment(dev, rc, rd, compare=None):
    """K4 against its plain version on the card at the distributed
    frame's per-rank shapes: a seeded stream and the frame's own
    exchanged column block with the most live slots. Thresholds and
    live slots exact, colour and depth within 1e-6; times with the
    stream kept full behind a device sleep (`stream_ms`; the one launch
    beside it), bound; a
    frame's 8 launches, one a column block, back to back. Each
    ``compare`` build (``--k4-compare``) is checked the same way and
    timed in turns with K4 (K4, other, other, K4)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_composite as cc
    from scenery_insitu_tpu_torch.ops.composite import sort_stream

    compare = compare or {}
    log_k4_builds()
    _, n, k, _, h, w = rc.shape
    blocks = [sort_stream(rc[i].reshape(n * k, 4, h, w),
                          rd[i].reshape(n * k, 2, h, w))
              for i in range(rc.shape[0])]
    j = int(torch.isfinite(rd[:, :, :, 0]).flatten(1).sum(1).argmax())
    seeded = seeded_sorted_stream(n * k, h, w, dev, SEED)
    res = {}
    for name, (sc, sd) in (("seeded", seeded), ("frame_block", blocks[j])):
        tp = torch.empty((h, w), device=dev)
        want = cc.resegment_sorted_plain(sc, sd, None, K_OUT,
                                         adaptive_iters=COMP_ITERS,
                                         threshold_out=tp) + (tp,)
        err = check_k4(f"resegment_{name}", cc.resegment_sorted, sc, sd,
                       want)
        for other, fn in compare.items():
            check_k4(f"resegment_{name}_{other}", fn, sc, sd, want)
        del want
        k4 = lambda fn=cc.resegment_sorted: fn(sc, sd, None, K_OUT,
                                               adaptive_iters=COMP_ITERS)
        ms = stream_ms(k4, behind_sleep=True)
        one = median_ms(lambda _: k4(), 20)
        pms = median_ms(lambda _: cc.resegment_sorted_plain(
            sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS), 3)
        log_live_slots(f"resegment_{name}", sc)
        (b, by), live_slots, nbytes = k4_bound(sc, COMP_ITERS)
        log(f"resegment_{name}.ms", f"{ms:.4f} plain_ms={pms:.4f} "
            f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f} (the host's "
            f"wrapper time included) nk={n * k} hw={h}x{w} "
            f"non_empty_slots_per_pixel={live_slots:.2f}; stream kept full "
            f"behind a device sleep")
        log(f"resegment_{name}.achieved_gb_s", f"{nbytes / ms / 1e6:.1f} "
            f"(the bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
        compare_ms = {}
        for other, fn in compare.items():
            o = lambda: k4(fn)
            turns = [stream_ms(f, behind_sleep=True)
                     for f in (k4, o, o, k4)]
            log(f"resegment_{name}.vs_{other}", in_turns(turns, nbytes,
                                                         "k4"))
            compare_ms[other] = (turns[1] + turns[2]) / 2
        res[name] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                         bound_by=by, one_launch_ms=one,
                         compare_ms=compare_ms)
    # a frame's K4 launches, one a column block: their bounds summed, to
    # set beside K4's device time a frame from the profile
    works = [k4_bound(sc, COMP_ITERS) for sc, _ in blocks]
    fb = sum(wk[0][0] for wk in works)
    log("resegment_frame.bound_ms", f"{fb:.4f} (the {rc.shape[0]} column "
        f"blocks' bounds summed: one frame's K4 launches)")

    def frame(fn):
        def run(_):
            for sc, sd in blocks:
                fn(sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS)
        return run

    def setup():
        torch.cuda.synchronize()
        lead()

    k4f = frame(cc.resegment_sorted)
    fms = median_ms(k4f, 5, setup)
    fbytes = sum(wk[2] for wk in works)
    log("resegment_frame.ms", f"{fms:.4f} bound_ms={fb:.4f} launches="
        f"{len(blocks)}; the stream kept full; achieved_gb_s="
        f"{fbytes / fms / 1e6:.1f}")
    for other, fn in compare.items():
        o = frame(fn)
        turns = [median_ms(f, 5, setup) for f in (k4f, o, o, k4f)]
        log(f"resegment_frame.vs_{other}", in_turns(turns, fbytes, "k4"))
        res["frame_block"]["compare_ms"][f"{other}_frame"] = \
            (turns[1] + turns[2]) / 2
    res["frame"] = dict(ms=fms, bound_ms=fb)
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
    the default bricks (16 x 32 x 512 cells) at T=4 and T=2, and ragged
    grids whose brick edges fall inside K3's xy tiles and z segments,
    one with v partly negative. Its u', v' must equal K3's bit for bit,
    its ranges ``field_ranges`` of its own v' and its plain version's
    exactly. Times B4b against K3 at T=4 and T=2 (the frame's last pass,
    the one that carries the epilogue) on the 512^3 state, and logs its
    builds."""
    import torch

    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.sim import cuda_stencil as cst
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    p = g.params.vector()
    cases = [(f"{GRID}", g.u, g.v, occ.default_bricks(tuple(g.v.shape)),
              (4, 2))]
    for shape, bricks, shift in (((24, 24, 24), None, 0.0),
                                 ((36, 60, 50), (12, 5), -0.1),
                                 ((260, 70, 100), (26, 7), 0.0)):
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
    log_stencil_builds("stencil_ranges", ranges=True)
    u, v, bricks = g.u, g.v, cases[0][3]
    cells = u.numel()
    out = {}
    for t in (4, 2):
        # in turns, B4b, K3, K3, B4b, each with the stream kept full
        b4b = lambda: cst.step_fused_ranges(u, v, p, t, bricks)
        k3 = lambda: cst.step_fused(u, v, p, t)
        turns = [stream_ms(f) for f in (b4b, k3, k3, b4b)]
        ms, k3_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        one = median_ms(lambda _: b4b(), 10)
        pms = median_ms(lambda _: cst.step_fused_ranges_plain(
            u, v, p, t, bricks), 3)
        # K3's bytes and operations, plus the ranges written and a compare
        # a cell for each of min and max
        b, by = bound_ms(4 * 4 * cells + 2 * 4 * bricks[0] * bricks[1],
                         (STENCIL_FLOPS_PER_CELL_STEP * t + 2) * cells)
        log(f"stencil_ranges_T{t}.ms", f"{ms:.4f} k3_ms={k3_ms:.4f} "
            f"plain_ms={pms:.4f} bound_ms={b:.4f} ({by}) bricks={bricks} "
            f"turns={'/'.join(f'{x:.4f}' for x in turns)} "
            f"one_launch_ms={one:.4f}")
        log(f"stencil_ranges_T{t}.achieved_gb_s",
            f"{4 * 4 * cells / ms / 1e6:.1f} (K3 {4 * 4 * cells / k3_ms / 1e6:.1f}"
            f"); B4b / K3 = {ms / k3_ms:.4f}")
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
    """B8's and B9's (bound ms, what bounds it, bytes): B7's without the
    count (each input read once, the state read and written once, the
    closing slots' rows written)."""
    c, _, h, w = rgba.shape
    hw = h * w
    nbytes = 4 * (c * 6 * hw + hw + 2 * 12 * hw + 6 * closes)
    return (*bound_ms(nbytes, (MACHINE_FLOPS_PER_PIXEL_SLICE - 3) * c * hw),
            nbytes)


def fold_events(fold, state, chunks, thr, k):
    """``chunks`` [(rgba, t0, t1)] through B8's or B9's ``fold`` (or its
    plain version) into ``state``, a ``((color, depth), small)`` pair."""
    for rgba, t0, t1 in chunks:
        fold(*state, rgba, t0, t1, thr, max_k=k)
    return state


def event_designs(specs):
    """{name: (B8, B9)}: this tree's wrappers under "" and, for each
    ``NAME=PATH`` of ``--events-compare`` (another design of
    ``csrc/fold_chunk.cu`` with the same C entries), the same wrappers
    served by that source's build."""
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    return {"": (fm.events_fold_chunk, fm.scratch_fold_chunk),
            **compare_designs(specs, "fold_chunk", "fold_chunk_occupancy",
                              log_event_builds, "events_compare",
                              fm.events_fold_chunk, fm.scratch_fold_chunk)}


def log_event_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and close events a thread holds of B7's build and
    of B8's and B9's at every timed (C, K), from ``cudaFuncGetAttributes``
    and the occupancy calculator."""
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    builds = [("fold_chunk", "pallas", CHUNK, K)] + [
        (f"{name}_C{c}_K{k}", variant, c, k)
        for c, k in EVENT_TIMED
        for name, variant in (("events_fold_chunk", "events"),
                              ("scratch_fold_chunk", "scratch"))]
    for tag, variant, c, k in builds:
        a = fm.attributes(variant, c, k)
        log(f"{prefix}{tag}.build", " ".join(f"{n}={v}"
                                             for n, v in a.items()))


def check_event_case(tag, chunks, thr, k, base=None, designs=None):
    """B8 and B9 of each of ``designs`` (default: this tree's) over
    ``chunks`` from ``base`` (default: the initial state) against their
    plain versions and B7: slot counters exact, colour and depth within
    1e-6. Returns (largest difference, whether this tree's B8 and B9
    equal B7 bit for bit)."""
    import torch

    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    h, w = thr.shape
    if base is None:
        base = cm.init_packed(k, h, w, device=thr.device)
    designs = designs or {"": (fm.events_fold_chunk, fm.scratch_fold_chunk)}
    flat = lambda st: (*st[0], st[1])
    state = lambda: ((base[0].clone(), base[1].clone()), base[2].clone())
    b7 = clone(base)
    for rgba, t0, t1 in chunks:
        cm.fold_chunk(b7, rgba, t0, t1, thr, max_k=k)
    err, bitwise = 0.0, True
    for i, (name, plain) in enumerate((
            ("events_fold_chunk", fm.events_fold_chunk_plain),
            ("scratch_fold_chunk", fm.scratch_fold_chunk_plain))):
        want = flat(fold_events(plain, state(), chunks, thr, k))
        for design, folds in designs.items():
            case = f"{name}_{tag}" + (f"_{design}" if design else "")
            got = flat(fold_events(folds[i], state(), chunks, thr, k))
            torch.cuda.synchronize()
            for other, what in ((want, "its plain version"), (b7, "B7")):
                if not torch.equal(got[2][11], other[2][11]):
                    raise AssertionError(f"{case}: slot counters differ "
                                         f"from {what}")
            e = max(packed_err(got, want), packed_err(got, b7))
            check(case, e, 1e-6)
            if design:
                log(f"{case}.bit_for_bit_with_b7", packed_equal(got, b7))
            else:
                err = max(err, e)
                bitwise = bitwise and packed_equal(got, b7)
            del got
        del want
    log(f"events_{tag}.pixels_at_slot_cap",
        f"{float((b7[2][11] == k - 1).float().mean()):.4f}; B8 and B9 "
        f"{'equal' if bitwise else 'differ from'} B7 bit for bit")
    return err, bitwise


def event_folds(k, thr, rgba, t0, t1, designs):
    """{name: fold(flat state)} of one chunk: B7 (``fold_chunk``), then
    each design's B8 and B9 (``events_fold_chunk[_NAME]``, ...)."""
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    folds = {"fold_chunk": lambda s: cm.fold_chunk(s, rgba, t0, t1, thr,
                                                   max_k=k)}
    for design, pair in designs.items():
        for name, fold in zip(EVENT_KERNELS.values(), pair):
            folds[name + (f"_{design}" if design else "")] = \
                (lambda f: lambda s: f((s[0], s[1]), s[2], rgba, t0, t1, thr,
                                       max_k=k))(fold)
    return folds


def check_event_folds(dev, designs):
    """Phase 6 (a): B8 and B9 of each of ``designs`` against their plain
    versions and B7 on the frame's captured chunks (K = 16), on seeded
    streams at 320 x 320 and 640 x 640 (C = 16, K = 16, after one folded
    chunk), and a K = 4 stream that fills the slot cap; then B7, B8 and
    B9 timed at 640 x 640 at each (C, K) of EVENT_TIMED with the stream
    kept full (`fresh_ms`, the one launch beside it), against their bound
    and (at the first) their plain versions, each ``--events-compare``
    design in turns at the first; then a march (`event_march`). Logs
    every timed build (`log_event_builds`)."""
    import torch

    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    log_event_builds()
    g = gs_init(dev)
    cap = capture_chunks(dev, g.u, g.v, (0.0, 0.6, 3.0))
    del g
    length = cap["length"]
    frame = [(rgba, planes(sk0, length), planes(sk1, length))
             for rgba, sk0, sk1 in cap["chunks"]]
    err, bitwise = check_event_case("frame_chunks", frame, cap["thr"], K,
                                    designs=designs)
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
                                   base, designs)
        err, bitwise = max(err, e), bitwise and same
        seeded[(side, k)] = (chunks, thr, base)
    side = EVENT_SEEDED[-1][0]
    chunks, thr, base16 = seeded[(side, K)]
    res = {}
    for c, k in EVENT_TIMED:
        rgba, t0, t1 = chunks[0]
        rgba, t0, t1 = (x[:c] if c <= CHUNK else torch.cat([x, x])[:c]
                        for x in (rgba, t0, t1))
        rgba, t0, t1 = rgba.contiguous(), t0.contiguous(), t1.contiguous()
        base = base16 if k == K else seeded[(side, 4)][2]
        b7 = cm.fold_chunk(clone(base), rgba, t0, t1, thr, max_k=k)
        closes = float((b7[2][11] - base[2][11]).sum())
        del b7
        b, by, nbytes = event_bound(rgba, closes)
        first = (c, k) == EVENT_TIMED[0]
        folds = event_folds(k, thr, rgba, t0, t1, designs if first else
                            {"": designs[""]})
        for name, plain in (("fold_chunk", None),
                            ("events_fold_chunk", fm.events_fold_chunk_plain),
                            ("scratch_fold_chunk",
                             fm.scratch_fold_chunk_plain)):
            fold = folds[name]
            ms = fresh_ms(fold, base)
            one = median_ms(fold, 20, lambda: clone(base))
            pms = None
            if first and plain is not None:
                pms = median_ms(lambda s: plain((s[0], s[1]), s[2], rgba, t0,
                                                t1, thr, max_k=k), 3,
                                lambda: clone(base))
            log(f"{name}_C{c}_K{k}.ms", f"{ms:.4f} plain_ms="
                f"{pms if pms is None else round(pms, 4)} bound_ms={b:.4f} "
                f"({by}) one_launch_ms={one:.4f} (the host's wrapper time "
                f"included) closes_per_pixel="
                f"{closes / rgba[0, 0].numel():.3f}; stream kept full on "
                f"states cloned before the window")
            if not first:
                continue
            compare_ms = {}
            for design in designs:
                if design and name != "fold_chunk":
                    other = folds[f"{name}_{design}"]
                    turns = [fresh_ms(f, base)
                             for f in (fold, other, other, fold)]
                    log(f"{name}_C{c}_K{k}.vs_{design}",
                        in_turns(turns, nbytes, "new"))
                    compare_ms[design] = (turns[1] + turns[2]) / 2
            res[name] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                             bound_by=by, one_launch_ms=one,
                             compare_ms=compare_ms)
    log("events.bit_for_bit_with_b7", bitwise)
    del seeded, chunks
    torch.cuda.empty_cache()
    for name, r in event_march(dev, designs).items():
        res[name]["compare_ms"].update(r.pop("compare_ms"))
        res[name].update(r, err=max(res[name]["err"], r["err"]))
    return res


def event_march(dev, designs):
    """B7, B8 and B9 over the microbenchmark's own stream: S = MARCH_S
    slices on its image (640 x 640), generated once (``stream_chunk``,
    S / C chunks of C = 16), K = 16, threshold 0.35. B8 and B9 against
    their plain versions and B7 over the march (`check_event_case`); the
    closes a pixel a chunk; each kernel's S / C launches back to back from
    the initial state behind `lead`, the median of 5; each
    ``--events-compare`` design in turns. The bound counts the bytes the
    march needs from HBM: every chunk's rgba, t0 and t1 read once, the
    threshold and the 12-float state read once, the state written once,
    and a 6-float row a close."""
    import torch

    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    side = fm.image_side(MARCH_S)
    hw = side * side
    chunks = [fm.stream_chunk(ci, CHUNK, side, side, dev)
              for ci in range(MARCH_S // CHUNK)]
    thr = torch.full((side, side), fm.THRESHOLD, device=dev)
    err, _ = check_event_case("micro_march", chunks, thr, K,
                              designs=designs)
    st = cm.init_packed(K, side, side, device=dev)
    for rgba, t0, t1 in chunks:
        cm.fold_chunk(st, rgba, t0, t1, thr, max_k=K)
    closes = float(st[2][11].sum())
    del st
    nbytes = 4 * (MARCH_S * 6 * hw + hw + 2 * 12 * hw + 6 * closes)
    b, by = bound_ms(nbytes,
                     (MACHINE_FLOPS_PER_PIXEL_SLICE - 3) * MARCH_S * hw)
    log("events_march.closes", f"{closes / hw:.4f} a pixel, "
        f"{closes / hw / len(chunks):.4f} a pixel a chunk")
    log("events_march.bound_ms", f"{b:.4f} ({by}; {nbytes / hw:.1f} B a "
        f"pixel over {len(chunks)} chunks of {CHUNK} on {side}x{side})")

    def setup():
        s = cm.init_packed(K, side, side, device=dev)
        torch.cuda.synchronize()
        lead()
        return s

    def run(name):
        def march(s):
            for rgba, t0, t1 in chunks:
                event_folds(K, thr, rgba, t0, t1, designs)[name](s)
        return march

    res = {}
    for name in ("fold_chunk", *EVENT_KERNELS.values()):
        ms = median_ms(run(name), 5, setup)
        log(f"{name}_march.ms", f"{ms:.4f} bound_ms={b:.4f} "
            f"launches={len(chunks)}; the stream kept full, a fresh state "
            f"each time; achieved_gb_s={nbytes / ms / 1e6:.1f}")
        compare_ms = {}
        for design in designs:
            if design and name != "fold_chunk":
                turns = [median_ms(run(n), 5, setup) for n in
                         (name, f"{name}_{design}", f"{name}_{design}",
                          name)]
                log(f"{name}_march.vs_{design}", in_turns(turns, nbytes,
                                                          "new"))
                compare_ms[f"{design}_march"] = (turns[1] + turns[2]) / 2
        res[name] = dict(march_ms=ms, march_bound_ms=b, err=err,
                         compare_ms=compare_ms)
    return res


def run_microbench(dev):
    """Phase 6 (b): the fold microbenchmark twin with ``--check`` over
    every variant at each grid of MICRO_GRIDS (K = 16, C = 16), its rows
    logged as ``microbench_<grid>``; the launch counts set to 0 before
    the sweep and read after it. B8 and B9 must launch S/C times a march,
    and B1b (the ``pallas_seg`` and ``tf_pallas_seg`` variants) at
    least once.
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
    require_launched(launches, (*EVENT_KERNELS.values(), "seg_fold_planes"),
                     "the microbenchmark sweep")
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
    ap.add_argument("--k1-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/seg_fold.cu (the same C "
                         "entries) to check and time in turns with K1 and "
                         "B1b in phase 2; repeatable")
    ap.add_argument("--fused-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/fused_fold.cu (the same C "
                         "entries) to check and time in turns with B5 and "
                         "B6 in phase 2; repeatable")
    ap.add_argument("--k4-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/resegment.cu (the same C "
                         "entries) to check and time in turns with K4 in "
                         "phase 4; repeatable")
    ap.add_argument("--k2-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/count_multi.cu (the same "
                         "C entries) to check and time in turns with K2 in "
                         "phase 2; repeatable")
    ap.add_argument("--events-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/fold_chunk.cu (the same C "
                         "entries) whose B8 and B9 to check and time in "
                         "turns with this tree's in phase 6; repeatable")
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

    compare = compare_folds(args.k1_compare)
    fused_compare = compare_fused(args.fused_compare)
    k4_compare = compare_resegments(args.k4_compare)
    k2_compare = compare_counts(args.k2_compare)
    designs = event_designs(args.events_compare)
    g = gs_init(dev)
    cap = capture_chunks(dev, g.u, g.v, (0.0, 0.6, 3.0))
    stencil = check_stencil(dev)
    fold = check_fold_and_count(dev, cap["chunks"], cap["thr"],
                                cap["length"], compare, k2_compare)
    new = check_new_folds(dev, cap, compare, fused_compare)
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
    reseg = check_resegment(dev, rc, rd, k4_compare)
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
    events = check_event_folds(dev, designs)
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
             max_abs_err=max(fold[16]["seg"]["err"], fold[1]["seg"]["err"],
                             fold["frame"]["err"]),
             ms=fold[16]["seg"]["ms"],
             plain_ms=fold[16]["seg"]["plain_ms"],
             bound_ms=fold[16]["seg"]["bound_ms"],
             bound_by=fold[16]["seg"]["bound_by"], library_ms=None,
             frame_ms=fold["frame"]["ms"],
             frame_bound_ms=fold["frame"]["bound_ms"]),
        dict(name="count_multi", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/count_multi.cu",
             replaces="scenery_insitu_tpu/ops/pallas_march.py:426",
             launches=launches["count_multi"],
             max_abs_err=fold[16]["count"]["err"],
             ms=fold[16]["count"]["ms"],
             plain_ms=fold[16]["count"]["plain_ms"],
             bound_ms=fold[16]["count"]["bound_ms"],
             bound_by=fold[16]["count"]["bound_by"], library_ms=None,
             one_launch_ms=fold[16]["count"]["one_launch_ms"],
             frame_ms=fold["count_frame"]["ms"],
             frame_bound_ms=fold["count_frame"]["bound_ms"],
             compare_ms={**fold[16]["count"]["compare_ms"], **{
                 f"{n}_frame": v for n, v in
                 fold["count_frame"]["compare_ms"].items()}}),
        dict(name="resegment_sorted", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/resegment.cu",
             replaces="scenery_insitu_tpu/ops/pallas_composite.py:172",
             launches=dist_launches["resegment_sorted"],
             max_abs_err=max(reseg[b]["err"] for b in ("seeded",
                                                       "frame_block")),
             ms=reseg["frame_block"]["ms"],
             plain_ms=reseg["frame_block"]["plain_ms"],
             bound_ms=reseg["frame_block"]["bound_ms"],
             bound_by=reseg["frame_block"]["bound_by"], library_ms=None,
             one_launch_ms=reseg["frame_block"]["one_launch_ms"],
             frame_ms=reseg["frame"]["ms"],
             frame_bound_ms=reseg["frame"]["bound_ms"],
             compare_ms=reseg["frame_block"]["compare_ms"]),
    ]
    # the kernels of this slice: B1b has no caller on a frame path; the
    # microbenchmark's pallas_seg and tf_pallas_seg variants run it, so
    # its count is that sweep's; each fold kernel's count is its fold
    # frame's run
    sources = {"seg_fold_planes": ("seg_fold.cu", "ops/pallas_seg.py:252"),
               "fold_chunk": ("fold_chunk.cu", "ops/pallas_march.py:367"),
               "fused_fold_chunk": ("fused_fold.cu", "ops/pallas_seg.py:426"),
               "fused_stream_fold": ("fused_fold.cu",
                                     "ops/pallas_seg.py:514")}
    runs = {name: folds[f][0][name] for f, name in FOLD_KERNELS.items()}
    runs["seg_fold_planes"] = micro_launches["seg_fold_planes"]
    for name, (src, site) in sources.items():
        r = new[name]
        table.append(dict(
            name=name, route="cuda",
            source=f"scenery_insitu_tpu_torch/csrc/{src}",
            replaces=f"scenery_insitu_tpu/{site}", launches=runs[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None))
        if name == "fold_chunk":
            # B7: stream kept full on the seeded chunk (the one launch
            # beside it), and its S / C launches over phase 6's march
            table[-1].update(one_launch_ms=r["one_launch_ms"],
                             march_ms=events["fold_chunk"]["march_ms"],
                             march_bound_ms=events["fold_chunk"][
                                 "march_bound_ms"])
        if name in ("fused_fold_chunk", "fused_stream_fold"):
            # B5: its 32 launches over a frame's feed; B6: its one launch
            # a march. compare_ms: each --fused-compare design's times in
            # turns
            table[-1].update(frame_ms=r["frame_ms"],
                             frame_bound_ms=r["frame_bound_ms"],
                             compare_ms=r["compare_ms"])
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
    # the microbenchmark's deferred-event folds: launches from its sweep;
    # ms at (C, K) = (16, 16) with the stream kept full, march_ms over
    # phase 6's march; compare_ms: each --events-compare design in turns
    for name, site in (("events_fold_chunk", "benchmarks/fold_microbench.py"
                        ":253"),
                       ("scratch_fold_chunk", "benchmarks/fold_microbench.py"
                        ":362")):
        r = events[name]
        table.append(dict(
            name=name, route="cuda",
            source="scenery_insitu_tpu_torch/csrc/fold_chunk.cu",
            replaces=site, launches=micro_launches[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, one_launch_ms=r["one_launch_ms"],
            march_ms=r["march_ms"], march_bound_ms=r["march_bound_ms"],
            compare_ms=r["compare_ms"]))
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

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

K1 (segmented write fold) and its planes form B1b, K2
(multi-threshold count), K3 (fused Gray-Scott stencil) and its ranges
epilogue B4b, K4 (the
composite's resegment), B7 (the machine's write fold) and B5/B6 (shade
and fold, per chunk and over the whole march) are built from
``scenery_insitu_tpu_torch/csrc`` at first use. Every test here needs
a CUDA device and skips without one; on the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which this file
does not use). Tolerances: K2 counts exact; K1 within 1e-5 (the kernel
sums a slot's items sequentially, the plain version with one reduction);
K3 within 1e-6 per fused step (the library is built without FMA
contraction, so it repeats the plain version's rounding), and bit for
bit on the z-streaming geometry's edge cases; B4b's u, v
equal K3's bit for bit and its per-brick ranges equal
``occupancy.field_ranges`` of its own v exactly; K4 thresholds
and live slots exact, colours and depths within 1e-6; B1b equal to
K1's compact form bit for bit (every build of both: C = 16 unrolled,
C = 1, 7 and 33 generic; saturated counts, empty chunks,
threshold 0 and +inf); B7 counts exact, colour and depth within
1e-6 (it repeats the machine's arithmetic); B8 and B9 (the reference
microbenchmark's deferred-event folds) slot counters exact, colour and
depth within 1e-6 of their plain versions and of B7, and equal to B7
bit for bit on their design cases (every slice closing, a chunk entering
at the slot cap, an empty chunk after a live one, a segment open across
chunks, ragged images, C = 1 to 32); B5 and B6 start
counts exact, colour and depth within 1e-6, B6 equal to B5 chunk after
chunk bit for bit (every build: C = 16 and C = 1 fixed, C = 5 and 33
generic; values on the knots, dead chunks, saturated counts, threshold
0 and +inf, knots that do not ascend). K4's design cases (its one-walk
search at iters 0 to 10, ``thr_max`` 1.7, no gap test, empty slots
between live ones, empty pixels, distances on the bisection's
midpoints, ragged images, K_out above 16 with its list in shared
memory) hold thresholds and live slots exactly, so do its cases at a
brick map's 640-slot column block; K2's builds (C = 16, 1, 7, 33 by
B = 16, 5, 32, candidates in either order) count exactly; K1 on a
brick pooled to level 1 (``test_seg_fold_on_pooled_brick``) equals the
same march's plain version within 1e-5. B10, the lint fixture's kernel
(``tests/torch_lint_fixtures/good_double.cu``), equals its plain
version bit for bit, NaN positions equal."""

import numpy as np
import pytest
import torch

from scenery_insitu_tpu_torch import kernels
from scenery_insitu_tpu_torch.ops import cuda_composite as cc
from scenery_insitu_tpu_torch.ops import cuda_march as cm
from scenery_insitu_tpu_torch.ops import cuda_seg as cs
from scenery_insitu_tpu_torch.ops import occupancy as occ
from scenery_insitu_tpu_torch.ops import supersegments as ss
from scenery_insitu_tpu_torch.sim import cuda_stencil as cst
from scenery_insitu_tpu_torch.sim import grayscott as gs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc for "
                    "sm_90a and launched on the device")
    return torch.device("cuda")


def _stream(c, h, w, dev, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.random((c, 3, h, w), dtype=np.float32)
    dup = (rng.random((c, 1, h, w)) < 0.3) & \
        (np.arange(c)[:, None, None, None] > 0)
    rgb = np.where(dup, np.roll(rgb, 1, axis=0), rgb)
    a = (0.05 + 0.85 * rng.random((c, 1, h, w))) * \
        (rng.random((c, 1, h, w)) > 0.4)
    rgba = np.concatenate([rgb * a, a], axis=1).astype(np.float32)
    return torch.from_numpy(rgba).to(dev)


def sorted_stream(nk, h, w, seed):
    """A per-pixel depth-sorted stream as the composite sees it after its
    sort: live slots front to back, then empty ones (zero colour, +inf
    depth). Neighbouring slots repeat a colour (distance 0), leave depth
    gaps, or carry an alpha below the empty cut, so every break of the
    machine occurs."""
    rng = np.random.default_rng(seed)
    start = np.sort(rng.uniform(1.0, 5.0, (nk, h, w)), axis=0)
    end = start + rng.choice([0.001, 0.02, 0.2], (nk, h, w))
    rgb = rng.uniform(0.0, 1.0, (nk, 3, h, w))
    dup = (rng.random((nk, 1, h, w)) < 0.3) & \
        (np.arange(nk)[:, None, None, None] > 0)
    rgb = np.where(dup, np.roll(rgb, 1, axis=0), rgb)
    a = rng.uniform(0.05, 0.95, (nk, 1, h, w))
    a = np.where(rng.random((nk, 1, h, w)) < 0.1, 5e-5, a)
    color = np.concatenate([rgb * a, a], axis=1)
    n_live = rng.integers(0, nk + 1, (h, w))
    live = np.arange(nk)[:, None, None] < n_live[None]
    color = np.where(live[:, None], color, 0.0).astype(np.float32)
    depth = np.where(live[:, None], np.stack([start, end], axis=1), np.inf)
    thr = rng.uniform(0.0, 0.5, (h, w)).astype(np.float32)
    return color, depth.astype(np.float32), thr


def midpoint_stream(nk, h, w):
    """Live slots whose premultiplied rgb steps by exactly 0.5 or 1.0 (the
    bisection's midpoints over [0, 2]), alpha 1, no depth gaps; the
    number of live slots grows along x."""
    f32 = np.float32
    steps = np.array([0.0, 0.5, 1.0, 0.5, 0.0, 1.0, 0.5, 1.0], f32)
    red = np.resize(steps, nk)[:, None, None] * np.ones((1, h, w), f32)
    color = np.zeros((nk, 4, h, w), f32)
    color[:, 0] = red
    color[:, 3] = 1.0
    start = np.arange(nk, dtype=f32)[:, None, None] * np.ones((1, h, w), f32)
    depth = np.stack([start, start + 1.0], 1).astype(f32)
    n_live = (np.arange(w) % (nk + 1))[None] * np.ones((h, 1), int)
    live = np.arange(nk)[:, None, None] < n_live[None]
    color = np.where(live[:, None], color, f32(0.0))
    depth = np.where(live[:, None], depth, f32(np.inf))
    return color.astype(f32), depth.astype(f32)


def _err(a, b):
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    assert torch.equal(fa, fb) and torch.equal(a[~fa], b[~fb])
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


@pytest.mark.parametrize("t_steps,shape", [(1, (16, 16, 32)),
                                           (4, (32, 48, 64)),
                                           (2, (20, 24, 28)),
                                           (3, (9, 37, 70))])
def test_stencil_matches_plain(dev, t_steps, shape):
    st = gs.GrayScott.init(shape, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    u = (st.u - 0.05 * torch.rand(shape, generator=g, device=dev))
    v = (st.v + 0.05 * torch.rand(shape, generator=g, device=dev))
    p = st.params.vector()
    before = kernels.launches()["grayscott_fused"]
    uk, vk = cst.step_fused(u, v, p, t_steps)
    assert kernels.launches()["grayscott_fused"] == before + 1
    up, vp = cst.step_fused_plain(u, v, p, t_steps)
    torch.cuda.synchronize()
    assert max(_err(uk, up), _err(vk, vp)) <= 1e-6 * t_steps


@pytest.mark.parametrize("t_steps,shape,bricks,shift", [
    (4, (64, 64, 64), (4, 2), 0.0),        # one brick a block
    (2, (24, 24, 24), None, 0.0),          # (24, 12): bricks of 1 x 2 rows
    (3, (36, 60, 50), (12, 5), -0.1),      # ragged, v partly negative
    (1, (9, 37, 70), (3, 37), -0.3)])
def test_stencil_ranges_matches_k3_and_field_ranges(dev, t_steps, shape,
                                                    bricks, shift):
    st = gs.GrayScott.init(shape, seed=2, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    u = (st.u - 0.05 * torch.rand(shape, generator=g, device=dev))
    v = (st.v + shift + 0.05 * torch.rand(shape, generator=g, device=dev))
    p = st.params.vector()
    bricks = bricks or occ.default_bricks(shape)
    before = kernels.launches()["grayscott_fused_ranges"]
    ur, vr, lo, hi = cst.step_fused_ranges(u, v, p, t_steps, bricks)
    assert kernels.launches()["grayscott_fused_ranges"] == before + 1
    # a second call on the same operands: the seeds are reset every call
    lo2, hi2 = cst.step_fused_ranges(u, v, p, t_steps, bricks)[2:]
    uk, vk = cst.step_fused(u, v, p, t_steps)
    _, _, lp, hp = cst.step_fused_ranges_plain(u, v, p, t_steps, bricks)
    torch.cuda.synchronize()
    assert torch.equal(ur, uk) and torch.equal(vr, vk)
    want = occ.field_ranges(vr, *bricks)
    for got in ((lo, hi), (lo2, hi2)):
        assert torch.equal(got[0], want.lo) and torch.equal(got[1], want.hi)
    assert max(_err(lo, lp), _err(hi, hp)) <= 1e-6 * t_steps
    if shift < 0:
        assert bool((lo < 0).any())


def test_multi_step_ranges_launches_the_epilogue_once(dev):
    st = gs.GrayScott.init((32, 32, 32), seed=3, device=dev)
    p = st.params.vector()
    before = kernels.launches()
    u, v, lo, hi = cst.multi_step_fused_ranges(st.u, st.v, p, 10, (8, 4))
    after = kernels.launches()
    assert after["grayscott_fused_ranges"] == \
        before["grayscott_fused_ranges"] + 1
    assert after["grayscott_fused"] == before["grayscott_fused"] + 2
    uk, vk = cst.multi_step_fused(st.u, st.v, p, 10)
    want = occ.field_ranges(vk, 8, 4)
    torch.cuda.synchronize()
    assert torch.equal(u, uk) and torch.equal(v, vk)
    assert torch.equal(lo, want.lo) and torch.equal(hi, want.hi)


def _gs_operands(shape, dev, seed, shift=0.0):
    """u in [0.5, 1) and v in [shift, shift + 0.3): seeded noise, any
    shape (``GrayScott.init`` needs room for its seed cubes)."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(1.0 - 0.5 * rng.random(shape, dtype=np.float32))
    v = torch.from_numpy(shift + 0.3 * rng.random(shape, dtype=np.float32))
    p = gs.GrayScottParams.create(device=dev).vector()
    return u.to(dev), v.to(dev), p


# the z-streaming geometry: 32 x 32 xy tiles (core 32 - 2T), z segments
# of 64 planes (T = 1, 2) or 128 (T = 3, 4); every axis smaller than the
# halo, D and W not multiples of the segment or the core, several tiles
# and segments on every axis
@pytest.mark.parametrize("t_steps,shape", [
    (4, (3, 5, 7)), (3, (3, 5, 7)), (2, (2, 1, 3)), (1, (1, 1, 1)),
    (4, (130, 70, 100)), (3, (130, 70, 100)), (2, (130, 70, 100)),
    (1, (130, 70, 100)), (2, (70, 33, 29)), (4, (65, 24, 25)),
    (3, (128, 26, 52)), (4, (260, 30, 40))])
def test_stencil_streaming_equals_plain_bitwise(dev, t_steps, shape):
    u, v, p = _gs_operands(shape, dev, 5)
    before = kernels.launches()["grayscott_fused"]
    uk, vk = cst.step_fused(u, v, p, t_steps)
    assert kernels.launches()["grayscott_fused"] == before + 1
    up, vp = cst.step_fused_plain(u, v, p, t_steps)
    torch.cuda.synchronize()
    assert torch.equal(uk, up) and torch.equal(vk, vp)


# brick edges inside a z segment (10-plane bricks, 64/128-plane segments)
# and inside a y tile (10-row bricks, 24- to 30-row cores), v partly
# negative on one
@pytest.mark.parametrize("t_steps,shift", [(4, 0.0), (2, -0.1), (1, 0.0),
                                           (3, -0.3)])
def test_stencil_ranges_bricks_inside_segments_and_tiles(dev, t_steps,
                                                         shift):
    shape, bricks = (130, 70, 100), (13, 7)
    u, v, p = _gs_operands(shape, dev, 6, shift)
    ur, vr, lo, hi = cst.step_fused_ranges(u, v, p, t_steps, bricks)
    uk, vk = cst.step_fused(u, v, p, t_steps)
    up, vp = cst.step_fused_plain(u, v, p, t_steps)
    torch.cuda.synchronize()
    assert torch.equal(ur, uk) and torch.equal(vr, vk)
    assert torch.equal(uk, up) and torch.equal(vk, vp)
    want = occ.field_ranges(vp, *bricks)
    assert torch.equal(lo, want.lo) and torch.equal(hi, want.hi)
    if shift < 0:
        assert bool((lo < 0).any())


def test_stencil_attributes(dev):
    for ranges in (False, True):
        for t in range(1, cst.FUSE_T + 1):
            a = cst.attributes(t, ranges)
            assert a["registers"] > 0 and a["blocks_per_sm"] >= 1
            assert a["core_x"] == 32 - 2 * t and a["core_y"] == 32 - 2 * t
            assert a["shared_bytes"] <= 232448
    with pytest.raises(ValueError):
        cst.attributes(5)


@pytest.mark.parametrize("chunks,k,hw", [((16, 1, 16), 16, (64, 80)),
                                         ((5, 3), 4, (13, 37)),
                                         ((8,), 1, (8, 8))])
def test_seg_fold_matches_plain(dev, chunks, k, hw):
    h, w = hw
    g = torch.Generator(device=dev).manual_seed(2)
    thr = 0.05 + 0.5 * torch.rand(hw, generator=g, device=dev)
    length = 1.0 + torch.rand(hw, generator=g, device=dev)
    kern = cs.init_seg_packed(k, h, w, device=dev)
    plain = cs.init_seg_packed(k, h, w, device=dev)
    lo = 0.5
    for i, c in enumerate(chunks):
        rgba = _stream(c, h, w, dev, 10 + i)
        sk0 = torch.linspace(lo, lo + 0.3, c, device=dev)
        sk1 = (sk0 + 0.02).contiguous()
        lo += 0.4
        cs.fold_chunk_packed(kern, rgba, thr, max_k=k, sk0=sk0, sk1=sk1,
                             length=length)
        cs.fold_chunk_packed_plain(plain, rgba, thr, max_k=k, sk0=sk0,
                                   sk1=sk1, length=length)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert _err(a, b) <= 1e-5
    assert torch.equal(kern[2][0], plain[2][0])


@pytest.mark.parametrize("chunks,bins,hw", [((16, 1, 16), 16, (64, 80)),
                                            ((3, 4), 5, (13, 37)),
                                            ((2,), 32, (8, 8))])
def test_count_multi_matches_plain_exactly(dev, chunks, bins, hw):
    h, w = hw
    tvec = ss.threshold_candidates(bins, device=dev)
    kern = cm.init_count_multi_packed(bins, h, w, device=dev)
    plain = cm.init_count_multi_packed(bins, h, w, device=dev)
    for i, c in enumerate(chunks):
        rgba = _stream(c, h, w, dev, 20 + i)
        cm.count_multi_chunk(kern, rgba, tvec)
        cm.count_multi_chunk_plain(plain, rgba, tvec)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nk,k_out,hw,iters", [(32, 16, (40, 80), 6),
                                                (8, 5, (13, 37), 0),
                                                (6, 9, (3, 130), 6)])
def test_resegment_matches_plain(dev, nk, k_out, hw, iters):
    color, depth, thr = (torch.from_numpy(x).to(dev) for x in
                         sorted_stream(nk, *hw, seed=nk))
    tk = torch.empty(hw, device=dev)
    tp = torch.empty(hw, device=dev)
    before = kernels.launches()["resegment_sorted"]
    kern = cc.resegment_sorted(color, depth, thr, k_out,
                               adaptive_iters=iters, threshold_out=tk)
    assert kernels.launches()["resegment_sorted"] == before + 1
    plain = cc.resegment_sorted_plain(color, depth, thr, k_out,
                                      adaptive_iters=iters, threshold_out=tp)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp)
    for a, b in zip(kern, plain):
        assert _err(a, b) <= 1e-6


def test_wrappers_raise_on_cpu_operand_mixed_with_cuda(dev):
    packed = cs.init_seg_packed(2, 8, 8, device=dev)
    with pytest.raises(ValueError, match="is on cpu"):
        cs.fold_chunk_packed(packed, torch.zeros((1, 4, 8, 8)), 0.1,
                             max_k=2, sk0=torch.ones(1, device=dev),
                             sk1=torch.ones(1, device=dev),
                             length=torch.ones((8, 8), device=dev))


def _planes(sk, length):
    return (sk[:, None, None] * length[None]).contiguous()


@pytest.mark.parametrize("chunks,k,hw", [((16, 1, 16), 16, (37, 90)),
                                         ((5, 3), 4, (13, 37))])
def test_seg_fold_planes_equals_compact_and_plain(dev, chunks, k, hw):
    """B1b (K1's planes form) fed t = sk * length equals K1's compact
    form bit for bit, and its plain version within 1e-5, counts exact."""
    h, w = hw
    g = torch.Generator(device=dev).manual_seed(3)
    thr = 0.05 + 0.5 * torch.rand(hw, generator=g, device=dev)
    length = 1.0 + torch.rand(hw, generator=g, device=dev)
    planes, compact, plain = (cs.init_seg_packed(k, h, w, device=dev)
                              for _ in range(3))
    before = kernels.launches()["seg_fold_planes"]
    lo = 0.5
    for i, c in enumerate(chunks):
        rgba = _stream(c, h, w, dev, 30 + i)
        sk0 = torch.linspace(lo, lo + 0.3, c, device=dev)
        sk1 = (sk0 + 0.02).contiguous()
        lo += 0.4
        t0, t1 = _planes(sk0, length), _planes(sk1, length)
        cs.fold_chunk_packed(planes, rgba, thr, max_k=k, t0=t0, t1=t1)
        cs.fold_chunk_packed(compact, rgba, thr, max_k=k, sk0=sk0, sk1=sk1,
                             length=length)
        cs.fold_chunk_packed_plain(plain, rgba, thr, max_k=k, t0=t0, t1=t1)
    torch.cuda.synchronize()
    assert kernels.launches()["seg_fold_planes"] == before + len(chunks)
    for a, b, p in zip(planes, compact, plain):
        assert torch.equal(a, b)
        assert _err(a, p) <= 1e-5
    assert torch.equal(planes[2][0], plain[2][0])


def _k1_both_forms(k, hw, dev, chunks, thr, seed):
    """Fold ``chunks`` [(C, kind)] ("live": a seeded chunk, "empty": all
    zero) through K1's compact form, B1b and the plain version from one
    state, checking after each chunk: K1 within 1e-5 of the plain
    version with the start counts exact, B1b equal to K1 bit for bit.
    Returns K1's state."""
    h, w = hw
    g = torch.Generator(device=dev).manual_seed(seed)
    length = 1.0 + torch.rand(hw, generator=g, device=dev)
    compact, planes, plain = (cs.init_seg_packed(k, h, w, device=dev)
                              for _ in range(3))
    lo = 0.5
    for i, (c, kind) in enumerate(chunks):
        rgba = _stream(c, h, w, dev, seed + i)
        if kind == "empty":
            rgba = torch.zeros_like(rgba)
        sk0 = torch.linspace(lo, lo + 0.3, c, device=dev)
        sk1 = (sk0 + 0.02).contiguous()
        lo += 0.4
        before = kernels.launches()
        cs.fold_chunk_packed(compact, rgba, thr, max_k=k, sk0=sk0, sk1=sk1,
                             length=length)
        cs.fold_chunk_packed(planes, rgba, thr, max_k=k, t0=_planes(
            sk0, length), t1=_planes(sk1, length))
        cs.fold_chunk_packed_plain(plain, rgba, thr, max_k=k, sk0=sk0,
                                   sk1=sk1, length=length)
        after = kernels.launches()
        assert after["seg_fold_compact"] == before["seg_fold_compact"] + 1
        assert after["seg_fold_planes"] == before["seg_fold_planes"] + 1
        torch.cuda.synchronize()
        for a, b, p in zip(compact, planes, plain):
            assert torch.equal(a, b)
            assert _err(a, p) <= 1e-5
        assert torch.equal(compact[2][0], plain[2][0])
    return compact


@pytest.mark.parametrize("hw", [(37, 90), (13, 37), (64, 640)])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("c", [1, 16, 7, 33])
def test_seg_fold_builds_match_plain(dev, c, k, hw):
    """Every build of K1 and B1b (unrolled C = 16; the generic one at the
    march's other count, C = 1, and at C = 7 and 33) after a live chunk of 16, so slots continue across the
    boundary, then a second chunk of C."""
    g = torch.Generator(device=dev).manual_seed(c * 100 + k)
    thr = 0.05 + 0.5 * torch.rand(hw, generator=g, device=dev)
    _k1_both_forms(k, hw, dev, ((16, "live"), (c, "live"), (c, "live")),
                   thr, seed=40 + c)


@pytest.mark.parametrize("c", [1, 16, 7, 33])
@pytest.mark.parametrize("case", ["saturated", "empty_after_live", "thr0",
                                  "thr_inf"])
def test_seg_fold_edge_states(dev, case, c):
    """K1 and B1b on a state whose counts already exceed K (every record
    merges into slot K-1), an all-empty chunk after a live one, threshold
    0 (every non-empty slice of a new colour starts) and +inf (starts
    only after gaps)."""
    hw, k = (37, 90), 4
    thr = {"saturated": 0.2, "empty_after_live": 0.2, "thr0": 0.0,
           "thr_inf": float("inf")}[case]
    thr = torch.full(hw, thr, device=dev)
    chunks = {"saturated": ((16, "live"), (16, "live"), (c, "live")),
              "empty_after_live": ((16, "live"), (c, "empty"),
                                   (c, "live")),
              "thr0": ((c, "live"), (c, "live")),
              "thr_inf": ((c, "live"), (16, "live"), (c, "live"))}[case]
    out = _k1_both_forms(k, hw, dev, chunks, thr, seed=70 + c)
    if case == "saturated":
        assert float(out[2][0].min()) > k


def test_seg_fold_on_pooled_brick(dev):
    """K1 on a level-1 brick (pooled 2x by ``reslab_bricks_lod``, marched
    on the fine camera with ``dwm * 2`` and ``step_scale = 1/2``) equals
    the same march's plain version on the CPU within 1e-5, and
    launches."""
    from scenery_insitu_tpu_torch.config import SliceMarchConfig, VDIConfig
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel.bricks import BrickMap
    from scenery_insitu_tpu_torch.parallel.mesh import (make_mesh,
                                                        reslab_bricks_lod,
                                                        shard_volume)

    n, g = 4, 64
    field = gs.multi_step(gs.GrayScott.init((g,) * 3, seed=0, device="cpu"),
                          20).v
    bm = BrickMap(g, n, (0, 1, 2, 3, 0, 1, 2, 3), (1,) * 8)
    pooled = reslab_bricks_lod(shard_volume(field, make_mesh(n, device="cpu")),
                               bm, h=0)[1][1, 0]          # rank 1, slot 0
    start = int(bm.start_table_at(1)[1, 0])
    outs = {}
    for d in (dev, "cpu"):
        box = Volume.centered(field.to(d), extent=2.0)
        spacing = box.spacing
        vol = Volume(pooled.to(d), box.origin + torch.tensor(
            [0.0, 0.0, start * float(spacing[2])], device=d), spacing * 2.0)
        cam = Camera.create((0.0, 0.6, 3.0), device=d)
        spec = slicer.make_spec(cam, (g,) * 3, SliceMarchConfig(
            fold="pallas_seg", chunk=4), axis_sign=slicer.choose_axis(cam))
        axcam = slicer.make_axis_camera(
            box, cam, spec, box_min=box.origin, box_max=box.world_max)
        before = kernels.launches()["seg_fold_compact"]
        vdi, _, _ = slicer.generate_vdi_mxu(
            vol, for_dataset("gray_scott", device=d), cam, spec,
            VDIConfig(max_supersegments=8, adaptive_mode="histogram"),
            axcam=axcam._replace(dwm=axcam.dwm * 2), step_scale=0.5)
        if str(d) != "cpu":
            assert kernels.launches()["seg_fold_compact"] > before
        outs[str(d)] = [x.cpu() for x in vdi]
    (kc, kd), (pc, pd) = outs[str(dev)], outs["cpu"]
    live = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), live)
    assert _err(kc, pc) <= 1e-5
    assert float((kd[live] - pd[live]).abs().max()) <= 1e-5
    assert bool(live[:, 0].any())


def test_seg_fold_attributes(dev):
    """Every K1/B1b build keeps its walk in registers (0 local bytes)
    and fits at least one block an SM."""
    for planes in (False, True):
        for c, held in ((16, 4), (1, 1), (7, 4), (33, 4)):
            a = cs.attributes(c, planes)
            assert a["local_bytes"] == 0, (c, planes, a)
            assert a["blocks_per_sm"] >= 1 and a["registers"] > 0
            assert a["threads"] > 0 and a["slices"] == held
    with pytest.raises(ValueError):
        cs.attributes(0)


@pytest.mark.parametrize("chunks,k,hw,gap_eps", [((16, 1, 16), 6, (37, 90),
                                                  -1.0),
                                                 ((5, 3), 1, (13, 37), 1e-4),
                                                 ((8,), 16, (8, 300), -1.0)])
def test_fold_chunk_matches_plain(dev, chunks, k, hw, gap_eps):
    """B7 (the machine's fold) against its sequential push/push_count
    plain version: counts and slot counters exact, colour and depth
    within 1e-6."""
    h, w = hw
    g = torch.Generator(device=dev).manual_seed(4)
    thr = 0.05 + 0.5 * torch.rand(hw, generator=g, device=dev)
    kern, plain = (cm.init_packed(k, h, w, device=dev) for _ in range(2))
    ck, cp = (torch.zeros(hw, dtype=torch.int32, device=dev)
              for _ in range(2))
    t = 0.0
    for i, c in enumerate(chunks):
        rgba = _stream(c, h, w, dev, 40 + i)
        step = 0.1 + 0.05 * (torch.rand((c, h, w), generator=g, device=dev)
                             < 0.3)
        t0 = (t + torch.cumsum(step, 0)).contiguous()
        t1 = (t0 + 0.1).contiguous()
        t = float(t1.max())
        cm.fold_chunk(kern, rgba, t0, t1, thr, max_k=k, count=ck,
                      gap_eps=gap_eps)
        cm.fold_chunk_plain(plain, rgba, t0, t1, thr, max_k=k, count=cp,
                            gap_eps=gap_eps)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp)
    assert torch.equal(kern[2][11], plain[2][11])
    for a, b in zip(kern, plain):
        assert _err(a, b) <= 1e-6


@pytest.mark.parametrize("c,k,n,hw", [(16, 16, 3, (37, 90)),
                                      (16, 4, 4, (13, 37)),
                                      (8, 8, 5, (8, 300)),
                                      (32, 16, 2, (40, 41)),
                                      (1, 4, 9, (16, 33))])
def test_event_folds_match_plain_and_b7(dev, c, k, n, hw):
    """B8 (events in registers) and B9 (events in shared memory) against
    their plain versions and against B7, over ``n`` chunks (K = 4 fills
    the slot cap): slot counters exact, colour and depth within 1e-6."""
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    h, w = hw
    g = torch.Generator(device=dev).manual_seed(5)
    thr = 0.05 + 0.5 * torch.rand(hw, generator=g, device=dev)
    b7 = cm.init_packed(k, h, w, device=dev)
    states = {f: fm.events_init(k, h, w, device=dev)
              for f in (fm.events_fold_chunk, fm.events_fold_chunk_plain,
                        fm.scratch_fold_chunk, fm.scratch_fold_chunk_plain)}
    for i in range(n):
        rgba = _stream(c, h, w, dev, 60 + i)
        t0 = (0.1 * (i * c + 1 + torch.arange(c, device=dev,
                                               dtype=torch.float32))
              )[:, None, None].expand(c, h, w).contiguous()
        t1 = (t0 + 0.1).contiguous()
        cm.fold_chunk(b7, rgba, t0, t1, thr, max_k=k)
        for fold, (big, small) in states.items():
            fold(big, small, rgba, t0, t1, thr, max_k=k)
    torch.cuda.synchronize()
    if k == 4:
        assert int(b7[2][11].max()) == k - 1
    for big, small in states.values():
        assert torch.equal(small[11], b7[2][11])
        for a, b in zip((*big, small), b7):
            assert _err(a, b) <= 1e-6


def _event_chunks(case, c, k, hw, dev):
    """(chunks [(rgba, t0, t1)], threshold) of one design case of B8 and
    B9 (see `test_event_fold_design_cases`)."""
    h, w = hw
    f32 = torch.float32

    def depths(i, n=c):
        t0 = (0.1 * (i * n + 1 + torch.arange(n, device=dev, dtype=f32))
              )[:, None, None].expand(n, h, w).contiguous()
        return t0, (t0 + 0.1).contiguous()

    def alternating(i):
        # red and green by the slice's index in the march, alpha 0.5
        s = i * c + torch.arange(c, device=dev)
        rgba = torch.zeros((c, 4, h, w), device=dev)
        rgba[:, 0] = 0.5 * (s % 2 == 0).to(f32)[:, None, None]
        rgba[:, 1] = 0.5 * (s % 2 == 1).to(f32)[:, None, None]
        rgba[:, 3] = 0.5
        return rgba

    def flat(i, color, a=0.3):
        rgba = torch.zeros((c, 4, h, w), device=dev)
        for j, x in enumerate(color):
            rgba[:, j] = a * x
        rgba[:, 3] = a
        return rgba

    if case == "all_close":
        return [(alternating(i), *depths(i)) for i in range(3)], \
            torch.zeros(hw, device=dev)
    if case == "enter_at_cap":
        n = -(-(k + 1) // c) + 1
        return [(alternating(i), *depths(i)) for i in range(n)] + \
            [(_stream(c, h, w, dev, 90), *depths(n))], \
            torch.zeros(hw, device=dev)
    if case == "empty_after_live":
        return [(_stream(c, h, w, dev, 91), *depths(0)),
                (torch.zeros((c, 4, h, w), device=dev), *depths(1)),
                (_stream(c, h, w, dev, 92), *depths(2))], \
            torch.full(hw, 0.2, device=dev)
    if case == "open_across":
        # one colour for three chunks, then a second colour from the last
        # chunk's second half: the first close ends a segment that opened
        # two chunks earlier
        last = flat(3, (1.0, 0.2, 0.1))
        last[c // 2:] = flat(3, (0.1, 0.2, 1.0))[c // 2:]
        return [(flat(i, (1.0, 0.2, 0.1)), *depths(i)) for i in range(3)] + \
            [(last, *depths(3))], torch.full(hw, 0.2, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    return [(_stream(c, h, w, dev, 93 + i), *depths(i)) for i in range(3)], \
        0.05 + 0.5 * torch.rand(hw, generator=g, device=dev)


@pytest.mark.parametrize("k", [16, 4])
@pytest.mark.parametrize("c", [1, 8, 16, 32])
@pytest.mark.parametrize("case", ["all_close", "enter_at_cap",
                                  "empty_after_live", "open_across",
                                  "seeded_ragged"])
def test_event_fold_design_cases(dev, case, c, k):
    """B8 and B9 equal B7 bit for bit and their plain versions within
    1e-6, slot counters exactly, chunk after chunk: every slice closing
    (threshold 0, colours alternating, so a chunk closes min(C, K - 1 -
    k) slots), a chunk entering at k = K - 1, an all-empty chunk after a
    live one, a segment open across chunks, and a seeded stream on a
    ragged image (every image here is ragged: H x W is no multiple of
    the blocks)."""
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    hw = (37, 90) if case == "seeded_ragged" else (5, 37)
    h, w = hw
    chunks, thr = _event_chunks(case, c, k, hw, dev)
    b7 = cm.init_packed(k, h, w, device=dev)
    states = {f: fm.events_init(k, h, w, device=dev)
              for f in (fm.events_fold_chunk, fm.events_fold_chunk_plain,
                        fm.scratch_fold_chunk, fm.scratch_fold_chunk_plain)}
    kernels_ = (fm.events_fold_chunk, fm.scratch_fold_chunk)
    for i, (rgba, t0, t1) in enumerate(chunks):
        k_in, open_in = b7[2][11].clone(), b7[2][9] > 0.5
        cm.fold_chunk(b7, rgba, t0, t1, thr, max_k=k)
        for fold, (big, small) in states.items():
            fold(big, small, rgba, t0, t1, thr, max_k=k)
        torch.cuda.synchronize()
        closed = b7[2][11] - k_in
        if case == "all_close":
            want = torch.clamp(k - 1 - k_in, max=c - (i == 0))
            assert torch.equal(closed, want)
        if case == "enter_at_cap" and i == len(chunks) - 1:
            assert bool((k_in == k - 1).all()) and not bool(closed.any())
        if case == "empty_after_live" and i == 1:
            # the first empty slice closes an open segment below the cap
            assert torch.equal(closed, (open_in & (k_in < k - 1)).to(
                closed.dtype))
        if case == "open_across":
            assert int(closed.max()) == (1 if i == 3 else 0)
        for fold, (big, small) in states.items():
            assert torch.equal(small[11], b7[2][11]), (fold.__name__, i)
            for a, b in zip((*big, small), b7):
                if fold in kernels_:
                    assert torch.equal(a, b), (fold.__name__, i)
                else:
                    assert _err(a, b) <= 1e-6


def test_event_fold_occupancy(dev):
    """The occupancy query of every build: B8's events stay in registers
    (0 local bytes) up to C = 16, each build fits a block an SM, and B9's
    shared memory is 24 min(C, K - 1) bytes a thread of its
    `scratch_block`."""
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    for c, k in fm.EVENT_PAIRS:
        for variant in ("pallas", "events", "scratch"):
            a = fm.attributes(variant, c, k)
            assert a["registers"] > 0 and a["blocks_per_sm"] >= 1, a
            held = 0 if variant == "pallas" else min(c, k - 1)
            assert a["events"] == held, (variant, c, k, a)
            if variant == "events" and c <= 16:
                assert a["local_bytes"] == 0, (c, k, a)
            if variant == "scratch":
                assert a["threads"] == fm.scratch_block(c)
                assert a["shared_bytes"] == 24 * held * a["threads"], a


def test_event_fold_kernel_attributes(dev):
    """The query the chip run reads: registers, local-memory bytes and
    the largest block of B7, B8 at (16, 16) and B9 at C = 16."""
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    for which, c, k in ((0, 16, 16), (1, 16, 16), (2, 16, 16)):
        regs, local, max_threads = kernels.query(
            "fold_chunk_attributes", which, c, k, nout=3)
        assert 0 < regs <= 255 and local >= 0
        assert max_threads >= fm.scratch_threads(c)


def _values(s, h, w, dev, seed):
    rng = np.random.default_rng(seed)
    val = rng.uniform(-0.2, 1.2, (s, h, w)).astype(np.float32)
    val = np.where(rng.random((s, h, w)) < 0.2, np.float32(-1.0), val)
    rep = (rng.random((s, h, w)) < 0.3) & (np.arange(s)[:, None, None] > 0)
    val = np.where(rep, np.roll(val, 1, axis=0), val)
    sk = 0.6 + 0.02 * torch.arange(s, dtype=torch.float32, device=dev)
    length = torch.from_numpy(
        (2.0 + rng.random((h, w))).astype(np.float32)).to(dev)
    ratio = torch.from_numpy(
        (0.8 + 0.5 * rng.random((h, w))).astype(np.float32)).to(dev)
    thr = torch.from_numpy(
        (0.02 + 0.3 * rng.random((h, w))).astype(np.float32)).to(dev)
    return torch.from_numpy(val).to(dev), sk, length, ratio, thr


@pytest.mark.parametrize("c,k,hw,tf_name", [(16, 16, (37, 90), "gray_scott"),
                                            (5, 3, (13, 37), "procedural")])
def test_fused_fold_and_stream_match_plain(dev, c, k, hw, tf_name):
    """B5 over three chunks and B6 over the same stream against their
    plain versions: start counts exact, colour and depth within 1e-6;
    B6 equals B5 chunk after chunk bit for bit."""
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import cuda_fused as cf

    h, w = hw
    tf = for_dataset(tf_name, device=dev)
    val, sk, length, ratio, thr = _values(3 * c, h, w, dev, c + k)
    sk1 = (sk + 0.02).contiguous()
    b5, b5p = (cs.init_seg_packed(k, h, w, device=dev) for _ in range(2))
    before = kernels.launches()
    for lo in range(0, 3 * c, c):
        args = (val[lo:lo + c], length, ratio, sk[lo:lo + c],
                sk1[lo:lo + c], thr)
        cf.fused_fold_chunk(b5, *args, max_k=k, tf=tf)
        cf.fused_fold_chunk_plain(b5p, *args, max_k=k, tf=tf)
    b6, b6p = (cs.init_seg_packed(k, h, w, device=dev) for _ in range(2))
    cf.fused_stream_fold(b6, val, length, ratio, sk, sk1, thr, max_k=k,
                         chunk=c, tf=tf)
    cf.fused_stream_fold_plain(b6p, val, length, ratio, sk, sk1, thr,
                               max_k=k, chunk=c, tf=tf)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["fused_fold_chunk"] == before["fused_fold_chunk"] + 3
    assert after["fused_stream_fold"] == before["fused_stream_fold"] + 1
    for kern, plain in ((b5, b5p), (b6, b6p)):
        assert torch.equal(kern[2][0], plain[2][0])
        for a, b in zip(kern, plain):
            assert _err(a, b) <= 1e-6
    for a, b in zip(b5, b6):
        assert torch.equal(a, b)


def _fused_tf(name, dev):
    """A transfer function by name; "unordered" is gray_scott with its
    knots permuted (the same sums in another order), a list on which the
    kernel may not stop early."""
    from scenery_insitu_tpu_torch.core.transfer import (TransferFunction,
                                                        for_dataset)

    if name != "unordered":
        return for_dataset(name, device=dev)
    tf = for_dataset("gray_scott", device="cpu")
    rng = np.random.default_rng(3)
    pa, pc = (torch.from_numpy(rng.permutation(16)) for _ in range(2))
    return TransferFunction.from_arrays(
        tf.alpha_x[pa], tf.alpha_m[pa], tf.alpha_b, tf.color_x[pc],
        tf.color_m[pc], tf.color_b, device=dev)


def _edge_values(tf, s, h, w, seed):
    """Value planes with every knot position of ``tf``, values in
    (-0.5, 0), above 1, dead (-1) and random in [0, 1]."""
    rng = np.random.default_rng(seed)
    knots = torch.cat([tf.alpha_x, tf.color_x]).cpu().numpy()
    pool = np.concatenate([knots[knots <= 1.0],
                           np.float32([-0.49, -0.25, -1e-7, 1.0 + 1e-6,
                                       1.5, 7.0, -1.0])]).astype(np.float32)
    val = np.where(rng.random((s, h, w)) < 0.4,
                   rng.random((s, h, w), dtype=np.float32),
                   rng.choice(pool, (s, h, w)))
    return val.astype(np.float32)


def _fused_both(dev, tf, k, hw, chunks, thr, seed, init=None):
    """Fold ``chunks`` (value planes f32[C,H,W] each, one C) through B5
    and its plain version from one state, checking after each chunk:
    start counts exact, colour and depth within 1e-6. Then B6 over the
    chunks' stream from the same state against its plain version and
    equal to B5 chunk after chunk bit for bit. Returns B5's state."""
    from scenery_insitu_tpu_torch.ops import cuda_fused as cf

    h, w = hw
    c = chunks[0].shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    length = 1.0 + torch.rand(hw, generator=g, device=dev)
    ratio = 0.8 + 0.5 * torch.rand(hw, generator=g, device=dev)
    start = init or cs.init_seg_packed(k, h, w, device=dev)
    b5, b5p = (tuple(x.clone() for x in start) for _ in range(2))
    sks = []
    for i, val in enumerate(chunks):
        sk = torch.linspace(0.5 + 0.4 * i, 0.8 + 0.4 * i, c, device=dev)
        sks.append(sk)
        args = (val, length, ratio, sk, (sk + 0.02).contiguous(), thr)
        before = kernels.launches()["fused_fold_chunk"]
        cf.fused_fold_chunk(b5, *args, max_k=k, tf=tf)
        assert kernels.launches()["fused_fold_chunk"] == before + 1
        cf.fused_fold_chunk_plain(b5p, *args, max_k=k, tf=tf)
        torch.cuda.synchronize()
        assert torch.equal(b5[2][0], b5p[2][0])
        for a, b in zip(b5, b5p):
            assert _err(a, b) <= 1e-6
    val, sk = torch.cat(chunks).contiguous(), torch.cat(sks)
    args = (val, length, ratio, sk, (sk + 0.02).contiguous(), thr)
    b6, b6p = (tuple(x.clone() for x in start) for _ in range(2))
    before = kernels.launches()["fused_stream_fold"]
    cf.fused_stream_fold(b6, *args, max_k=k, chunk=c, tf=tf)
    assert kernels.launches()["fused_stream_fold"] == before + 1
    cf.fused_stream_fold_plain(b6p, *args, max_k=k, chunk=c, tf=tf)
    torch.cuda.synchronize()
    assert torch.equal(b6[2][0], b6p[2][0])
    for a, b, p in zip(b6, b5, b6p):
        assert torch.equal(a, b)
        assert _err(a, p) <= 1e-6
    return b5


@pytest.mark.parametrize("tf_name", ["gray_scott", "procedural"])
@pytest.mark.parametrize("hw", [(37, 90), (13, 37), (64, 640)])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("c", [1, 16, 5, 33])
def test_fused_fold_builds_match_plain(dev, c, k, hw, tf_name):
    """Every build of B5 and B6 (fixed C = 16 and C = 1; the generic
    one at C = 5 and 33) over three chunks of values on the knots, in
    (-0.5, 0), above 1 and dead, against the plain versions; B6 equal to
    B5 chunk after chunk bit for bit."""
    tf = _fused_tf(tf_name, dev)
    h, w = hw
    g = torch.Generator(device=dev).manual_seed(c * 100 + k)
    thr = 0.02 + 0.3 * torch.rand(hw, generator=g, device=dev)
    chunks = [torch.from_numpy(_edge_values(tf, c, h, w, 50 + c + i)).to(dev)
              for i in range(3)]
    _fused_both(dev, tf, k, hw, chunks, thr, seed=c + k)


@pytest.mark.parametrize("c", [1, 16, 5, 33])
@pytest.mark.parametrize("case", ["dead_chunk", "saturated", "thr0",
                                  "thr_inf", "unordered_knots"])
def test_fused_fold_edge_states(dev, case, c):
    """B5 and B6 on a chunk of only -1 planes between live chunks, a
    state whose start counts already exceed K, threshold 0 (every
    non-empty sample of a new colour starts) and +inf (starts only after
    a gap), and a knot list that does not ascend."""
    from scenery_insitu_tpu_torch.ops import cuda_fused as cf

    hw, k = (37, 90), 4
    h, w = hw
    tf = _fused_tf("unordered" if case == "unordered_knots"
                   else "gray_scott", dev)
    thr = {"thr0": 0.0, "thr_inf": float("inf")}.get(case, 0.2)
    thr = torch.full(hw, thr, device=dev)
    chunks = [torch.from_numpy(_edge_values(tf, c, h, w, 80 + c + i)).to(dev)
              for i in range(3)]
    init = None
    if case == "dead_chunk":
        chunks[1] = torch.full((c, h, w), -1.0, device=dev)
    if case == "saturated":
        init = cs.init_seg_packed(k, h, w, device=dev)
        pre = 0.2 + 0.8 * torch.rand((16, h, w), device=dev)
        sk = torch.linspace(0.1, 0.4, 16, device=dev)
        one = torch.ones(hw, device=dev)
        cf.fused_fold_chunk_plain(init, pre, one, one, sk, sk + 0.01,
                                  torch.zeros(hw, device=dev), max_k=k,
                                  tf=tf)
        assert float(init[2][0].min()) > k
    out = _fused_both(dev, tf, k, hw, chunks, thr, seed=90 + c, init=init)
    if case == "thr_inf":
        assert float(out[2][0].max()) >= 1


def test_fused_fold_attributes(dev):
    """Every B5/B6 build keeps its walk in registers (0 local bytes) and
    fits at least one block an SM."""
    from scenery_insitu_tpu_torch.ops import cuda_fused as cf

    for c, held in ((16, 16), (1, 1), (5, 5), (33, 16)):
        a = cf.attributes(c)
        assert a["local_bytes"] == 0, (c, a)
        assert a["blocks_per_sm"] >= 1 and a["registers"] > 0
        assert a["threads"] > 0 and a["slices"] == held
    with pytest.raises(ValueError):
        cf.attributes(0)


# K4's redesign (one walk for the search, the list of the largest
# distances): name -> (nk, k_out, (h, w), iters, thr_max, gap_eps, stream)
K4_CASES = {
    "frame_shape": (128, 16, (64, 80), 6, 2.0, 1e-4, "seeded"),
    "iters0": (128, 16, (64, 80), 0, 2.0, 1e-4, "seeded"),
    "iters8": (128, 16, (64, 80), 8, 2.0, 1e-4, "seeded"),
    "iters10": (128, 16, (64, 80), 10, 2.0, 1e-4, "seeded"),
    "thr_max_1.7": (128, 16, (64, 80), 6, 1.7, 1e-4, "seeded"),
    "gap_off": (128, 16, (64, 80), 6, 2.0, -1.0, "seeded"),
    "empties_between_live": (128, 16, (64, 80), 6, 2.0, 1e-4, "holes"),
    "all_empty_pixels": (128, 16, (64, 80), 6, 2.0, 1e-4, "blank_rows"),
    "midpoints": (16, 3, (8, 80), 6, 2.0, 1e-4, "midpoints"),
    "midpoints_iters8": (16, 5, (8, 80), 8, 2.0, 1e-4, "midpoints"),
    "ragged": (128, 16, (37, 91), 6, 2.0, 1e-4, "seeded"),
    "k_out_24_shared_list": (128, 24, (37, 91), 6, 2.0, 1e-4, "seeded"),
    "k_out_40_shared_list": (64, 40, (13, 37), 8, 1.7, 1e-4, "holes"),
    "short_stream_k_out_20": (12, 20, (13, 37), 6, 2.0, 1e-4, "seeded"),
    # the exchange schedules' shapes: the capped ring's accumulator
    # (ring_slots = 2K = 32) on a rank's column block, and one rank's
    # block of a tile wave (T = 4 of the 8-rank frame's 80 columns, and
    # a 16-column block)
    "ring_slots_32": (32, 16, (640, 80), 6, 2.0, 1e-4, "seeded"),
    "ring_slots_32_holes": (32, 16, (640, 80), 6, 2.0, 1e-4, "holes"),
    "wave_block_20": (128, 16, (640, 20), 6, 2.0, 1e-4, "seeded"),
    "wave_block_16": (128, 16, (512, 16), 6, 2.0, 1e-4, "blank_rows"),
    # a brick map's column block: 8 ranks x 5 slots x K = 16 sorted slots
    # (32 bricks, one rank owning none), 640 rows of an 80-column block
    "brick_stream_640": (640, 16, (640, 80), 6, 2.0, 1e-4, "seeded"),
    "brick_stream_640_holes": (640, 16, (640, 80), 6, 2.0, 1e-4, "holes"),
}


def _k4_stream(kind, nk, h, w, seed):
    """The stream of a K4 case: ``sorted_stream``; "holes" with every
    other live slot's alpha set to 5e-5 at its finite depth (empty slots
    between live ones); "blank_rows" with every third row all empty;
    "midpoints" the distances on the bisection's midpoints."""
    if kind == "midpoints":
        color, depth = midpoint_stream(nk, h, w)
        return color, depth, np.full((h, w), 0.25, np.float32)
    color, depth, thr = sorted_stream(nk, h, w, seed)
    if kind == "holes":
        hole = (np.arange(nk) % 2 == 1)[:, None, None] & \
            np.isfinite(depth[:, 0])
        color[:, 3] = np.where(hole, np.float32(5e-5), color[:, 3])
        color[:, :3] = np.where(hole[:, None], color[:, :3] * 1e-3,
                                color[:, :3])
    if kind == "blank_rows":
        color[:, :, ::3] = 0.0
        depth[:, :, ::3] = np.inf
    return color, depth, thr


@pytest.mark.parametrize("case", list(K4_CASES))
def test_resegment_design_cases(dev, case):
    """K4 against its plain version: thresholds and live-slot counts
    exact, colour and depth within 1e-6, one launch a call."""
    nk, k_out, (h, w), iters, thr_max, gap_eps, kind = K4_CASES[case]
    color, depth, thr = (torch.from_numpy(x).to(dev) for x in
                         _k4_stream(kind, nk, h, w, seed=nk + iters))
    tk = torch.empty((h, w), device=dev)
    tp = torch.empty((h, w), device=dev)
    args = dict(adaptive_iters=iters, thr_max=thr_max)
    before = kernels.launches()["resegment_sorted"]
    kern = cc.resegment_sorted(color, depth, thr, k_out, gap_eps,
                               threshold_out=tk, **args)
    assert kernels.launches()["resegment_sorted"] == before + 1
    plain = cc.resegment_sorted_plain(color, depth, thr, k_out, gap_eps,
                                      threshold_out=tp, **args)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp)
    live = lambda d: torch.isfinite(d[:, 0]).sum(0)
    assert torch.equal(live(kern[1]), live(plain[1]))
    for a, b in zip(kern, plain):
        assert _err(a, b) <= 1e-6


@pytest.mark.parametrize("bins", [16, 5, 32])
@pytest.mark.parametrize("c", [16, 1, 7, 33])
def test_count_multi_builds_match_plain(dev, c, bins):
    """Every K2 build (C = 16 and C = 1 fixed, others generic; B = 16
    exact, others on the padded 32-wide build) counts exactly as its
    plain version: a chunk of ``c`` after a chunk of 16, then one more
    with the candidates in descending order (the kernel must not rely on
    their order)."""
    h, w = 37, 90
    tvec = ss.threshold_candidates(bins, device=dev)
    kern = cm.init_count_multi_packed(bins, h, w, device=dev)
    plain = cm.init_count_multi_packed(bins, h, w, device=dev)
    for i, (n, t) in enumerate(((16, tvec), (c, tvec),
                                (c, tvec.flip(0).contiguous()))):
        rgba = _stream(n, h, w, dev, 60 + 3 * c + i)
        before = kernels.launches()["count_multi"]
        cm.count_multi_chunk(kern, rgba, t)
        assert kernels.launches()["count_multi"] == before + 1
        cm.count_multi_chunk_plain(plain, rgba, t)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


def test_resegment_and_count_attributes(dev):
    """K4's and K2's builds keep their state in registers (0 local
    bytes) and fit at least one block an SM; K4's list lives in
    registers up to K_out = 16."""
    for nk, k_out, iters, regs in ((128, 16, 6, 1), (128, 16, 0, 0),
                                   (8, 5, 6, 1), (128, 24, 6, 0),
                                   (64, 40, 8, 0)):
        a = cc.attributes(nk, k_out, iters)
        assert a["local_bytes"] == 0, (nk, k_out, iters, a)
        assert a["blocks_per_sm"] >= 1 and a["registers"] > 0
        assert a["list_in_registers"] == regs
        assert a["list"] == (0 if iters == 0 else min(k_out + 1, nk - 1))
    for c in (16, 1, 7, 33):
        for bins in (16, 5, 32):
            a = cm.count_attributes(c, bins)
            assert a["local_bytes"] == 0, (c, bins, a)
            assert a["blocks_per_sm"] >= 1 and a["registers"] > 0
    with pytest.raises(ValueError):
        cm.count_attributes(1, 33)


def test_resegment_on_hier_top_stream(dev):
    """K4 at the top of the two-level composite: the merged N·K stream a
    rank of a 2 x 4 mesh resegments (a 32^3 Gray-Scott frame, its
    level-1 all_to_all and level-2 DCN merges), its fullest block
    against the plain version: thresholds and live slots exact, colour
    and depth within 1e-6."""
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 MeshConfig,
                                                 SliceMarchConfig,
                                                 TopologyConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import hier
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.parallel.topology import make_topology_mesh

    g, k = 32, 8
    mesh, topo = make_topology_mesh(TopologyConfig(num_hosts=2),
                                    MeshConfig(num_devices=8), device=dev)
    field = gs.multi_step(gs.GrayScott.init((g,) * 3, seed=0, device="cpu"),
                          20).v.to(dev)
    box = Volume.centered(field, extent=2.0)
    cam = Camera.create((0.0, 0.6, 3.0), device=dev)
    spec = slicer.make_spec(cam, (g,) * 3, SliceMarchConfig(fold="pallas_seg"),
                            axis_sign=slicer.choose_axis(cam), multiple_of=8)
    vcfg = VDIConfig(max_supersegments=k, adaptive_mode="histogram")
    slabs = shard_volume(field, mesh)
    rows = dp._frame_rows(slabs, spec)
    frags = [dp._mxu_rank_generate(slabs, rows, r, box.origin, box.spacing,
                                   cam, spec, for_dataset("gray_scott",
                                                          device=dev),
                                   vcfg)[0] for r in range(8)]
    streams = hier.hier_accumulate(torch.stack([f.color for f in frags]),
                                   torch.stack([f.depth for f in frags]),
                                   topo, CompositeConfig())
    assert all(sc.shape[0] == 8 * k for sc, _ in streams)
    sc, sd = max(streams, key=lambda s: int(torch.isfinite(s[1][:, 0]).sum()))
    h, w = sc.shape[2:]
    tk = torch.empty((h, w), device=dev)
    tp = torch.empty((h, w), device=dev)
    before = kernels.launches()["resegment_sorted"]
    kern = cc.resegment_sorted(sc, sd, None, 16, threshold_out=tk,
                               adaptive_iters=6)
    assert kernels.launches()["resegment_sorted"] == before + 1
    plain = cc.resegment_sorted_plain(sc, sd, None, 16, threshold_out=tp,
                                      adaptive_iters=6)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp)
    live = lambda d: torch.isfinite(d[:, 0]).sum(0)
    assert torch.equal(live(kern[1]), live(plain[1]))
    assert int(live(plain[1]).sum()) > 0
    for a, b in zip(kern, plain):
        assert _err(a, b) <= 1e-6


def _b10():
    """The B10 fixture module, loaded by path (it registers its library
    with ``kernels``)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_lint_fixtures", "good_cuda.py")
    spec = importlib.util.spec_from_file_location("b10_good_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_bits(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32)))


@pytest.mark.parametrize("h,w,offset", [(8, 128, 0), (64, 256, 0),
                                        (64, 130, 0), (40, 1, 0),
                                        (16, 128, 1), (8192, 8192, 0)])
def test_b10_double_chunk_matches_plain(dev, h, w, offset):
    """B10 (``tests/torch_lint_fixtures/good_double.cu``, the Pallas lint
    fixture's kernel) equals its plain version bit for bit, NaN
    positions equal: float4 rows, rows of other widths, a buffer off the
    16-byte alignment, a NaN tile and tiles whose max is -0 and +0; one
    launch a call; a height that is not a multiple of 8 raises."""
    b10 = _b10()
    gen = torch.Generator(device=dev).manual_seed(h + w)
    buf = torch.randn(h * w + offset, generator=gen, device=dev)
    x = buf[offset:].view(h, w)
    x[h // 2] = 0.0
    if h >= 32:
        x[9, w // 3] = float("nan")
        x[16:32] = -x[16:32].abs()
        x[16] = -0.0
        x[27] = 0.0
    before = kernels.launches()["double_chunk"]
    got = b10.double_chunk(x)
    assert kernels.launches()["double_chunk"] == before + 1
    want = b10.double_chunk_plain(x)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and _same_bits(a, b)
    if h >= 32:
        m = got[1][:4, 0].tolist()
        assert np.isnan(m[1]) and np.signbit(m[2]) and not np.signbit(m[3])
    with pytest.raises(ValueError, match="multiple of 8"):
        b10.double_chunk(torch.zeros((h + 4, w), device=dev))

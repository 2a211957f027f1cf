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
contraction, so it repeats the plain version's rounding); B4b's u, v
equal K3's bit for bit and its per-brick ranges equal
``occupancy.field_ranges`` of its own v exactly; K4 thresholds
and live slots exact, colours and depths within 1e-6; B1b equal to
K1's compact form bit for bit; B7 counts exact, colour and depth within
1e-6 (it repeats the machine's arithmetic); B8 and B9 (the reference
microbenchmark's deferred-event folds) slot counters exact, colour and
depth within 1e-6 of their plain versions and of B7; B5 and B6 start
counts exact, colour and depth within 1e-6."""

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

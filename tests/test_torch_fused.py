"""Parity of the plain versions of kernels B7 (the machine's write fold,
``ops/cuda_march.py``), B1b (K1's planes form, ``ops/cuda_seg.py``), B5
and B6 (shade and fold, ``ops/cuda_fused.py``) with the reference's
Pallas kernels run in interpret mode, on the CPU, from the same
numpy-seeded inputs.

Tolerances: start counts are exact everywhere. B7 repeats the
sequential machine's arithmetic: colours and depths within rtol 2e-6,
atol 1e-6 (the bar of ``tests/test_pallas_march.py``). B1b sums a
slot's items as the reference's fold does: 1e-6. B5 and B6 shade with
a transfer function and a power the two libraries round differently:
1e-5. B6 against B5 chunk after chunk, both the port's: bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.ops import pallas_march as jpm
from scenery_insitu_tpu.ops import pallas_seg as jpsg
from scenery_insitu_tpu.ops import supersegments as jss
from scenery_insitu_tpu_torch import convert, kernels
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.ops import cuda_fused as cf
from scenery_insitu_tpu_torch.ops import cuda_march as cm
from scenery_insitu_tpu_torch.ops import cuda_seg as cs
from scenery_insitu_tpu_torch.ops import seg_fold as tsf
from scenery_insitu_tpu_torch.ops import supersegments as tss
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

CPU = "cpu"


def T(x):
    return torch.from_numpy(np.array(x))


def np_(x):
    return convert.to_numpy(x)


def stream(seed, n, h, w, gaps=False):
    """Depth-ordered shaded stream with empty runs and near-duplicate
    colours (starts on gaps, breaks on the distance and accumulation all
    occur); with ``gaps`` the depths leave holes between some items.
    Returns rgba [n,4,h,w], t0, t1 [n,h,w] (numpy f32)."""
    rng = np.random.default_rng(seed)
    rgb = rng.random((n, 3, h, w), dtype=np.float32)
    dup = (rng.random((n, 1, h, w)) < 0.3) & \
        (np.arange(n)[:, None, None, None] > 0)
    rgb = np.where(dup, np.roll(rgb, 1, axis=0), rgb)
    alpha = (0.05 + 0.85 * rng.random((n, 1, h, w), dtype=np.float32))
    alpha = alpha * (rng.random((n, 1, h, w)) > 0.4)
    rgba = np.concatenate([rgb * alpha, alpha], axis=1).astype(np.float32)
    step = np.full((n, h, w), 0.1, np.float32)
    if gaps:
        step = step + np.float32(0.05) * (rng.random((n, h, w)) < 0.3)
    t0 = np.cumsum(step, axis=0).astype(np.float32)
    return rgba, t0, (t0 + np.float32(0.1)).astype(np.float32)


def value_stream(seed, s, h, w):
    """Resampled value planes as the raw march feeds them: values in and
    beyond [0, 1], runs of dead (-1) samples, and repeated values."""
    rng = np.random.default_rng(seed)
    val = rng.uniform(-0.2, 1.2, (s, h, w)).astype(np.float32)
    val = np.where(rng.random((s, 1, w)) < 0.2, np.float32(-1.0), val)
    val = np.where(rng.random((s, h, w)) < 0.15, np.float32(-1.0), val)
    rep = (rng.random((s, h, w)) < 0.3) & (np.arange(s)[:, None, None] > 0)
    val = np.where(rep, np.roll(val, 1, axis=0), val)
    sk = (np.float32(0.6) + np.float32(0.02)
          * np.arange(s, dtype=np.float32)).astype(np.float32)
    length = (2.0 + rng.random((h, w))).astype(np.float32)
    ratio = (0.8 + 0.5 * rng.random((h, w))).astype(np.float32)
    thr = (0.02 + 0.3 * rng.random((h, w))).astype(np.float32)
    return val, sk, length, ratio, thr


TFS = {"procedural": (lambda: jtf.for_dataset("procedural"),
                      lambda: ttf.for_dataset("procedural", device=CPU)),
       "ramp": (lambda: jtf.TransferFunction.ramp(0.1, 0.7, 0.8, "jet"),
                lambda: ttf.TransferFunction.ramp(0.1, 0.7, 0.8, "jet",
                                                  device=CPU))}


def assert_packed_close(got, want, rtol, atol):
    for name, a, b in zip(("color", "depth", "small"), got, want):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)


# ------------------------------------------------------------------ B7


@pytest.mark.parametrize("h,w,k,gap_eps,with_count,chunks", [
    (8, 24, 1, -1.0, True, (5, 4)),
    (16, 40, 3, 1e-4, True, (6, 1, 5)),
    (8, 40, 6, -1.0, False, (7, 7, 2)),
    (16, 24, 6, 1e-4, False, (4, 4)),
    (16, 40, 6, -1.0, True, (8, 8, 8)),
])
def test_plain_b7_matches_pallas_march_interpret(h, w, k, gap_eps,
                                                 with_count, chunks):
    """B7's plain version (the CPU branch of `fold_chunk`) against the
    reference's two-phase kernel in interpret mode, carrying the packed
    state (and the count) across chunks; C=1 chunks included."""
    n = sum(chunks)
    rgba, t0, t1 = stream(k + n, n, h, w, gaps=gap_eps >= 0)
    thr = (np.random.default_rng(1).random((h, w)) * 0.5).astype(np.float32)
    jp = jpm.init_packed(k, h, w)
    tp = convert.packed_state(jp, device=CPU)
    assert_packed_close(tp, cm.init_packed(k, h, w, device=CPU), 0, 0)
    jc = jnp.zeros((h, w), jnp.int32)
    tc = torch.zeros((h, w), dtype=torch.int32)
    lo = 0
    for c in chunks:
        sl = slice(lo, lo + c)
        lo += c
        args = (jnp.asarray(rgba[sl]), jnp.asarray(t0[sl]),
                jnp.asarray(t1[sl]), jnp.asarray(thr))
        if with_count:
            jp, jc = jpm.fold_chunk(jp, *args, max_k=k, count=jc,
                                    gap_eps=gap_eps, interpret=True)
            out = cm.fold_chunk(tp, T(rgba[sl]), T(t0[sl]), T(t1[sl]),
                                T(thr), max_k=k, count=tc, gap_eps=gap_eps)
            assert out[0] is tp and out[1] is tc       # updated in place
            np.testing.assert_array_equal(np_(tc), np.asarray(jc))
        else:
            jp = jpm.fold_chunk(jp, *args, max_k=k, gap_eps=gap_eps,
                                interpret=True)
            assert cm.fold_chunk(tp, T(rgba[sl]), T(t0[sl]), T(t1[sl]),
                                 T(thr), max_k=k, gap_eps=gap_eps) is tp
        assert_packed_close(tp, jp, 2e-6, 1e-6)
        np.testing.assert_array_equal(np_(tp[2][11]), np.asarray(jp[2][11]))
    tcol, tdep = tss.finalize(cm.unpack_state(tp))
    jcol, jdep = jss.finalize(jpm.unpack_state(jp))
    np.testing.assert_allclose(np_(tcol), np.asarray(jcol), rtol=2e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np_(tdep), np.asarray(jdep), rtol=2e-6,
                               atol=1e-6)
    assert np.isfinite(np_(tdep)[:, 0]).any()


def test_b7_pack_unpack_round_trip_and_push_parity():
    """pack_state/unpack_state are exact inverses, and the plain B7 is
    the port's own sequential push/push_count on the unpacked state."""
    h, w, k = 8, 16, 4
    rgba, t0, t1 = stream(3, 9, h, w)
    thr = torch.full((h, w), 0.25)
    st = tss.init_state(k, h, w, device=CPU)
    cst = tss.init_count(h, w, device=CPU)
    for i in range(rgba.shape[0]):
        st = tss.push(st, k, thr, T(rgba[i]), T(t0[i]), T(t1[i]))
        cst = tss.push_count(cst, thr, T(rgba[i]))
    tp = cm.init_packed(k, h, w, device=CPU)
    cnt = torch.zeros((h, w), dtype=torch.int32)
    cm.fold_chunk(tp, T(rgba[:4]), T(t0[:4]), T(t1[:4]), 0.25, max_k=k,
                  count=cnt)
    cm.fold_chunk(tp, T(rgba[4:]), T(t0[4:]), T(t1[4:]), 0.25, max_k=k,
                  count=cnt)
    for a, b in zip(cm.pack_state(st), tp):
        assert torch.equal(a, b)
    assert torch.equal(cnt, cst.count)
    for a, b in zip(cm.pack_state(cm.unpack_state(tp)), tp):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- B1b


@pytest.mark.parametrize("chunks,k", [((6, 1, 5), 4), ((8, 8), 1)])
def test_plain_b1b_matches_pallas_seg_planes_interpret(chunks, k):
    """K1's planes form (the CPU branch of `fold_chunk_packed` with
    t0/t1) against the reference's planes-form kernel in interpret mode
    within 1e-6, and equal to the port's compact form on t = sk *
    length."""
    h, w = 16, 40
    thr = (np.random.default_rng(6).random((h, w)) * 0.4).astype(np.float32)
    length = (1.0 + np.random.default_rng(7).random((h, w))
              ).astype(np.float32)
    jp = jpsg.init_seg_packed(k, h, w)
    tp = convert.packed_state(jp, device=CPU)
    tq = cs.init_seg_packed(k, h, w, device=CPU)
    for i, c in enumerate(chunks):
        rgba, _, _ = stream(60 + i, c, h, w)
        sk0 = (np.float32(0.5 + 0.3 * i)
               + np.float32(0.02) * np.arange(c, dtype=np.float32))
        sk1 = (sk0 + np.float32(0.02)).astype(np.float32)
        t0 = T(sk0)[:, None, None] * T(length)[None]
        t1 = T(sk1)[:, None, None] * T(length)[None]
        jp = jpsg.fold_chunk_packed(jp, jnp.asarray(rgba), np_(t0),
                                    np_(t1), jnp.asarray(thr), max_k=k,
                                    interpret=True)
        assert cs.fold_chunk_packed(tp, T(rgba), T(thr), max_k=k, t0=t0,
                                    t1=t1) is tp
        cs.fold_chunk_packed(tq, T(rgba), T(thr), max_k=k, sk0=T(sk0),
                             sk1=T(sk1), length=T(length))
        assert_packed_close(tp, jp, 1e-6, 1e-6)
        np.testing.assert_array_equal(np_(tp[2][0]), np.asarray(jp[2][0]))
        for a, b in zip(tp, tq):
            assert torch.equal(a, b)


def test_seg_fold_chunk_drop_in_and_depth_forms():
    """`cuda_seg.seg_fold_chunk` is ``seg_fold.seg_fold_chunk`` and
    leaves its input state as it was; `fold_chunk_packed` takes exactly
    one complete depth form and raises on a mixed or incomplete set, as
    the reference does."""
    h, w, k = 8, 24, 3
    rgba, t0, t1 = stream(70, 6, h, w)
    st0 = tsf.init_seg_state(k, h, w, device=CPU)
    got = cs.seg_fold_chunk(st0, T(rgba), T(t0), T(t1), 0.2, max_k=k)
    want = tsf.seg_fold_chunk(st0, T(rgba), T(t0), T(t1), 0.2, max_k=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not st0.out_color.any()
    packed = cs.init_seg_packed(k, h, w, device=CPU)
    one = torch.ones(6)
    plane = T(t0)
    bad = [dict(t0=plane), dict(sk0=one, sk1=one),
           dict(t0=plane, t1=plane, length=torch.ones(h, w)),
           dict(sk0=one, sk1=one, length=torch.ones(h, w), t1=plane), {}]
    for kw in bad:
        with pytest.raises(ValueError, match="depth form"):
            cs.fold_chunk_packed(packed, T(rgba), 0.2, max_k=k, **kw)


# ------------------------------------------------------------- B5, B6


@pytest.mark.parametrize("tf_name,k,c", [("procedural", 6, 4),
                                         ("ramp", 1, 8),
                                         ("ramp", 6, 4)])
def test_plain_b5_matches_fused_fold_chunk_interpret(tf_name, k, c):
    """B5's plain version (the CPU branch of `fused_fold_chunk`) against
    the reference's fused kernel in interpret mode over three chunks of
    value planes (dead samples, values outside [0, 1]): start counts
    exact, colour, depth and carried state within 1e-5."""
    h, w = 16, 40
    jtf_, ttf_ = (f() for f in TFS[tf_name])
    val, sk, length, ratio, thr = value_stream(k + c, 3 * c, h, w)
    ds = np.float32(0.02)
    jp = jpsg.init_seg_packed(k, h, w)
    tp = cs.init_seg_packed(k, h, w, device=CPU)
    for lo in range(0, 3 * c, c):
        sl = slice(lo, lo + c)
        sk1 = (sk[sl] + ds).astype(np.float32)
        jp = jpsg.fused_fold_chunk(
            jp, jnp.asarray(val[sl]), jnp.asarray(length),
            jnp.asarray(ratio), jnp.asarray(sk[sl]), jnp.asarray(sk1),
            jnp.asarray(thr), max_k=k, tf=jtf_, interpret=True)
        out = cf.fused_fold_chunk(tp, T(val[sl]), T(length), T(ratio),
                                  T(sk[sl]), T(sk1), T(thr), max_k=k,
                                  tf=ttf_)
        assert out is tp
        np.testing.assert_array_equal(np_(tp[2][0]), np.asarray(jp[2][0]))
        assert_packed_close(tp, jp, 1e-5, 1e-5)
    assert np_(tp[2][0]).max() > 1


@pytest.mark.parametrize("tf_name,k,c,nchunks", [("procedural", 1, 8, 2),
                                                 ("ramp", 6, 4, 3)])
def test_plain_b6_matches_fused_stream_fold_interpret(tf_name, k, c,
                                                      nchunks):
    """B6's plain version against the reference's whole-march kernel in
    interpret mode (start counts exact, the rest within 1e-5), and equal
    bit for bit to B5's plain version called chunk after chunk."""
    h, w = 8, 24
    jtf_, ttf_ = (f() for f in TFS[tf_name])
    s = c * nchunks
    val, sk, length, ratio, thr = value_stream(30 + k, s, h, w)
    sk1 = (sk + np.float32(0.02)).astype(np.float32)
    jp = jpsg.fused_stream_fold(
        jpsg.init_seg_packed(k, h, w), jnp.asarray(val), jnp.asarray(length),
        jnp.asarray(ratio), jnp.asarray(sk), jnp.asarray(sk1),
        jnp.asarray(thr), max_k=k, chunk=c, tf=jtf_, interpret=True)
    tp = cf.fused_stream_fold(cs.init_seg_packed(k, h, w, device=CPU),
                              T(val), T(length), T(ratio), T(sk), T(sk1),
                              T(thr), max_k=k, chunk=c, tf=ttf_)
    np.testing.assert_array_equal(np_(tp[2][0]), np.asarray(jp[2][0]))
    assert_packed_close(tp, jp, 1e-5, 1e-5)
    tq = cs.init_seg_packed(k, h, w, device=CPU)
    for lo in range(0, s, c):
        cf.fused_fold_chunk_plain(tq, T(val[lo:lo + c]), T(length),
                                  T(ratio), T(sk[lo:lo + c]),
                                  T(sk1[lo:lo + c]), T(thr), max_k=k,
                                  tf=ttf_)
    for a, b in zip(tp, tq):
        assert torch.equal(a, b)


def _unordered_tfs():
    """The gray_scott transfer function with its knots in another order
    (the same knots, so the same sums in another order): the kernels
    cannot stop early on a knot list that does not ascend."""
    tf = ttf.for_dataset("gray_scott", device=CPU)
    rng = np.random.default_rng(3)
    pa, pc = rng.permutation(16), rng.permutation(16)
    arrays = (np_(tf.alpha_x)[pa], np_(tf.alpha_m)[pa], np_(tf.alpha_b),
              np_(tf.color_x)[pc], np_(tf.color_m)[pc], np_(tf.color_b))
    assert (np.diff(arrays[0][arrays[1] != 0]) < 0).any()
    return (jtf.TransferFunction(*(jnp.asarray(a) for a in arrays)),
            ttf.TransferFunction.from_arrays(*arrays, device=CPU))


def _edge_values(tf, s, h, w, seed):
    """Value planes on the knots: every knot position of ``tf``, values in
    (-0.5, 0), above 1, dead (-1) and random in [0, 1]."""
    rng = np.random.default_rng(seed)
    knots = np.concatenate([np_(tf.alpha_x), np_(tf.color_x)])
    pool = np.concatenate([knots[knots <= 1.0],
                           np.float32([-0.49, -0.25, -1e-7, 1.0 + 1e-6,
                                       1.5, 7.0, -1.0])]).astype(np.float32)
    val = rng.choice(pool, (s, h, w))
    return np.where(rng.random((s, h, w)) < 0.3,
                    rng.random((s, h, w), dtype=np.float32),
                    val).astype(np.float32)


@pytest.mark.parametrize("case", ["dead_chunk", "on_knots", "saturated",
                                  "thr0", "thr_inf", "unordered_knots"])
def test_plain_b5_b6_edge_cases_match_reference_interpret(case):
    """B5's and B6's plain versions against the reference's fused kernels
    in interpret mode on the cases the kernels treat apart: a chunk of
    only -1 planes between live chunks, values exactly on the knots, in
    (-0.5, 0) and above 1, a state whose start count already exceeds K,
    threshold 0 and +inf, and knots that do not ascend. Start counts
    exact, the rest within 1e-5; B6 equal to B5 chunk after chunk."""
    h, w, c, k = 8, 24, 4, 3
    if case == "unordered_knots":
        jtf_, ttf_ = _unordered_tfs()
    else:
        jtf_ = jtf.for_dataset("gray_scott")
        ttf_ = ttf.for_dataset("gray_scott", device=CPU)
    val, sk, length, ratio, thr = value_stream(90, 3 * c, h, w)
    if case != "dead_chunk":
        val = _edge_values(ttf_, 3 * c, h, w, seed=91)
    else:
        val[c:2 * c] = -1.0
    thr = {"thr0": np.zeros_like(thr),
           "thr_inf": np.full_like(thr, np.inf)}.get(case, thr)
    sk1 = (sk + np.float32(0.02)).astype(np.float32)
    jp = jpsg.init_seg_packed(k, h, w)
    tp = cs.init_seg_packed(k, h, w, device=CPU)
    if case == "saturated":
        # a chunk at threshold 0 first: counts pass K before the test
        pre = np.random.default_rng(92).uniform(
            0.2, 1.0, (12, h, w)).astype(np.float32)
        pre_sk = np.linspace(0.1, 0.5, 12, dtype=np.float32)
        zero = np.zeros_like(thr)
        jp = jpsg.fused_fold_chunk(
            jp, jnp.asarray(pre), jnp.asarray(length), jnp.asarray(ratio),
            jnp.asarray(pre_sk), jnp.asarray(pre_sk + np.float32(0.01)),
            jnp.asarray(zero), max_k=k, tf=jtf_, interpret=True)
        cf.fused_fold_chunk(tp, T(pre), T(length), T(ratio), T(pre_sk),
                            T(pre_sk + np.float32(0.01)), T(zero), max_k=k,
                            tf=ttf_)
        assert np_(tp[2][0]).min() > k
    j6 = jpsg.fused_stream_fold(
        jp, jnp.asarray(val), jnp.asarray(length), jnp.asarray(ratio),
        jnp.asarray(sk), jnp.asarray(sk1), jnp.asarray(thr), max_k=k,
        chunk=c, tf=jtf_, interpret=True)
    t6 = cf.fused_stream_fold(tuple(x.clone() for x in tp), T(val),
                              T(length), T(ratio), T(sk), T(sk1), T(thr),
                              max_k=k, chunk=c, tf=ttf_)
    np.testing.assert_array_equal(np_(t6[2][0]), np.asarray(j6[2][0]))
    assert_packed_close(t6, j6, 1e-5, 1e-5)
    for lo in range(0, 3 * c, c):
        sl = slice(lo, lo + c)
        jp = jpsg.fused_fold_chunk(
            jp, jnp.asarray(val[sl]), jnp.asarray(length),
            jnp.asarray(ratio), jnp.asarray(sk[sl]), jnp.asarray(sk1[sl]),
            jnp.asarray(thr), max_k=k, tf=jtf_, interpret=True)
        cf.fused_fold_chunk(tp, T(val[sl]), T(length), T(ratio), T(sk[sl]),
                            T(sk1[sl]), T(thr), max_k=k, tf=ttf_)
        np.testing.assert_array_equal(np_(tp[2][0]), np.asarray(jp[2][0]))
        assert_packed_close(tp, jp, 1e-5, 1e-5)
    for a, b in zip(tp, t6):
        assert torch.equal(a, b)
    if case == "thr_inf":      # starts only where a sample follows a gap
        assert np_(tp[2][0]).max() >= 1


def test_tf_knots_layout_and_shading():
    """The knot buffer the kernels read, and the plain shading against
    the port's transfer function with the same opacity correction: the
    knot formula sums in another order, so within 1e-6."""
    tf = ttf.for_dataset("gray_scott", device=CPU)
    knots = cf.tf_knots(tf)
    assert knots.shape == (cf.NKNOTS,) and cf.NKNOTS == 100
    assert torch.equal(knots[:16], tf.alpha_x)
    assert torch.equal(knots[32], tf.alpha_b)
    assert torch.equal(knots[49:97].reshape(16, 3), tf.color_m)
    assert torch.equal(knots[97:], tf.color_b)
    val, _, _, ratio, _ = value_stream(5, 4, 8, 16)
    rgba = cf.shade_plain(T(val), T(ratio), tf)
    rgb, a = tf(T(val))
    a = torch.where(T(val) < -0.5, 0.0, a)
    a = 1.0 - torch.pow(torch.clamp(1.0 - a, 1e-7, 1.0), T(ratio))
    np.testing.assert_allclose(np_(rgba[:, 3]), np_(a), atol=1e-6)
    np.testing.assert_allclose(np_(rgba[:, :3]),
                               np_(rgb.movedim(-1, 1) * a[:, None]),
                               atol=1e-6)
    assert (np_(rgba[:, 3])[val < -0.5] == 0).all()


def test_new_wrappers_reject_bad_operands():
    h, w, k = 8, 16, 3
    rgba, t0, t1 = stream(80, 4, h, w)
    tp = cm.init_packed(k, h, w, device=CPU)
    with pytest.raises(ValueError, match="max_k"):
        cm.fold_chunk(tp, T(rgba), T(t0), T(t1), 0.2, max_k=k + 1)
    with pytest.raises(ValueError, match="shape"):
        cm.fold_chunk(tp, T(rgba), T(t0[:3]), T(t1), 0.2, max_k=k)
    with pytest.raises(TypeError):
        cm.fold_chunk(tp, T(rgba), T(t0), T(t1), 0.2, max_k=k,
                      count=torch.zeros((h, w)))
    with pytest.raises(ValueError, match="shape"):
        cm.fold_chunk(cs.init_seg_packed(k, h, w, device=CPU), T(rgba),
                      T(t0), T(t1), 0.2, max_k=k)
    tf = ttf.for_dataset("procedural", device=CPU)
    val, sk, length, ratio, thr = value_stream(81, 8, h, w)
    sp = cs.init_seg_packed(k, h, w, device=CPU)
    with pytest.raises(ValueError, match="multiple of chunk"):
        cf.fused_stream_fold(sp, T(val), T(length), T(ratio), T(sk),
                             T(sk), T(thr), max_k=k, chunk=3, tf=tf)
    with pytest.raises(ValueError, match="shape"):
        cf.fused_fold_chunk(sp, T(val), T(length), T(ratio), T(sk[:4]),
                            T(sk), T(thr), max_k=k, tf=tf)
    with pytest.raises(ValueError, match="knots"):
        cf.tf_knots(tf._replace(alpha_x=tf.alpha_x[:8]))
    with pytest.raises(ValueError, match="not a packed fold state"):
        convert.packed_state((np.zeros((2, 4, 8, 8)), np.zeros((2, 2, 8, 8)),
                              np.zeros((7, 8, 8))), device=CPU)


def test_fused_fold_source_binds_its_entries_and_keeps_powf():
    """``csrc/fused_fold.cu`` defines every C entry and query that
    ``kernels.py`` binds to it (B5, B6 and the build query), and shades
    with ``powf`` in a library built without FMA contraction or fast
    math: alpha feeds the empty cut and the start test, so a change of
    rounding can flip a start count."""
    with open(kernels.source_path("fused_fold")) as f:
        src = f.read()
    names = [n for n, (lib, _) in {**kernels.ENTRIES,
                                   **kernels.QUERIES}.items()
             if lib == "fused_fold"]
    assert sorted(names) == ["fused_fold_attributes", "fused_fold_chunk",
                             "fused_stream_fold"]
    for name in names:
        assert f'extern "C" int {name}(' in src, name
    assert "powf(" in src and "__powf" not in src
    assert "-fmad=false" in kernels.NVCC_FLAGS
    assert not any("fast_math" in f for f in kernels.NVCC_FLAGS)

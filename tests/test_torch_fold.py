"""Parity of the port's supersegment folds with the JAX package, on the
CPU: the sequential machine (`push`/`finalize`/`push_count`), the
threshold controllers, the segmented-scan fold, and the plain versions
of kernels K1 (segmented write fold, ``ops/cuda_seg.py``) and K2
(multi-threshold count, ``ops/cuda_march.py``) against the reference's
Pallas kernels run in interpret mode.

Tolerances: segment counts, start flags and thresholds derived from
them are exact; colors and depths agree to 1e-6 where both sides run
the same sequential arithmetic, and to 1e-5 where one side sums a
segment's items in another order (the segmented fold vs `push`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu.ops import pallas_march as jpm
from scenery_insitu_tpu.ops import pallas_seg as jpsg
from scenery_insitu_tpu.ops import seg_fold as jsf
from scenery_insitu_tpu.ops import supersegments as jss
from scenery_insitu_tpu_torch import convert, kernels
from scenery_insitu_tpu_torch.ops import cuda_march as cm
from scenery_insitu_tpu_torch.ops import cuda_seg as cs
from scenery_insitu_tpu_torch.ops import seg_fold as tsf
from scenery_insitu_tpu_torch.ops import supersegments as tss
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

CPU = "cpu"


def stream(seed, n, h, w, empty_frac=0.4, dup_frac=0.3):
    """Depth-ordered shaded stream (numpy) with empty runs and
    near-duplicate colors, so starts on gaps, breaks on the distance and
    accumulation all occur. Returns rgba [n,4,h,w], t0, t1 [n,h,w]."""
    rng = np.random.default_rng(seed)
    rgb = rng.random((n, 3, h, w), dtype=np.float32)
    dup = (rng.random((n, 1, h, w)) < dup_frac) & \
        (np.arange(n)[:, None, None, None] > 0)
    rgb = np.where(dup, np.roll(rgb, 1, axis=0), rgb)
    alpha = (0.05 + 0.85 * rng.random((n, 1, h, w), dtype=np.float32))
    alpha = alpha * (rng.random((n, 1, h, w)) > empty_frac)
    rgba = np.concatenate([rgb * alpha, alpha], axis=1).astype(np.float32)
    t0 = np.cumsum(np.full((n, h, w), 0.1, np.float32), axis=0)
    return rgba, t0, (t0 + np.float32(0.1)).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def np_(x):
    return convert.to_numpy(x)


def assert_state_close(got, want, atol):
    for a, b in zip(got, want):
        a, b = np_(a), np.asarray(b)
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=atol)


@pytest.mark.parametrize("gap_eps", [-1.0, 0.05])
def test_push_finalize_push_count_match(gap_eps):
    h, w, k = 8, 24, 4
    rgba, t0, t1 = stream(0, 14, h, w)
    thr = np.random.default_rng(1).random((h, w), dtype=np.float32) * 0.6
    if gap_eps >= 0:                     # depth gaps between items
        t0 = (t0 + 0.07 * (np.arange(14) % 3)[:, None, None]
              ).astype(np.float32)
        t1 = (t0 + 0.1).astype(np.float32)
    js, ts = jss.init_state(k, h, w), tss.init_state(k, h, w, device=CPU)
    jc, tc = jss.init_count(h, w), tss.init_count(h, w, device=CPU)
    for i in range(rgba.shape[0]):
        js = jss.push(js, k, jnp.asarray(thr), jnp.asarray(rgba[i]),
                      jnp.asarray(t0[i]), jnp.asarray(t1[i]), gap_eps)
        ts = tss.push(ts, k, T(thr), T(rgba[i]), T(t0[i]), T(t1[i]),
                      gap_eps)
        jc = jss.push_count(jc, jnp.asarray(thr), jnp.asarray(rgba[i]),
                            jnp.asarray(t0[i]), jnp.asarray(t1[i]), gap_eps)
        tc = tss.push_count(tc, T(thr), T(rgba[i]), T(t0[i]), T(t1[i]),
                            gap_eps)
        assert_state_close(ts, js, 1e-6)
        assert_state_close(tc, jc, 0.0)
    assert_state_close(tss.finalize(ts), jss.finalize(js), 1e-6)


def test_threshold_candidates_and_pick():
    for bins in (2, 8, 16):
        np.testing.assert_array_equal(
            np_(tss.threshold_candidates(bins, 2.0, device=CPU)),
            np.asarray(jss.threshold_candidates(bins, 2.0)))
    rng = np.random.default_rng(2)
    tvec = jss.threshold_candidates(8, 2.0)
    counts = np.sort(rng.integers(0, 12, (8, 6, 10)), axis=0)[::-1]
    counts = np.ascontiguousarray(counts).astype(np.int32)
    for k in (0, 4, 11):
        np.testing.assert_array_equal(
            np_(tss.pick_threshold(T(counts), T(np.asarray(tvec)), k)),
            np.asarray(jss.pick_threshold(jnp.asarray(counts), tvec, k)))


@pytest.mark.parametrize("max_k,delta,track", [(8, 0.15, 0.9),
                                               (16, 0.15, 0.9),
                                               (6, 0.3, 0.75)])
def test_update_threshold_over_frames(max_k, delta, track):
    """The temporal controller carried over 8 frames, each fed a count
    map that straddles the band (over, under and in band): the states
    must stay equal frame after frame."""
    rng = np.random.default_rng(3)
    h, w = 12, 20
    thr0 = rng.random((h, w), dtype=np.float32) * 0.5
    js = jss.init_threshold_state(jnp.asarray(thr0), 1e-3, 2.0)
    ts = tss.init_threshold_state(T(thr0), 1e-3, 2.0)
    assert_state_close(ts, js, 0.0)
    for _ in range(8):
        count = rng.integers(0, 2 * max_k, (h, w)).astype(np.int32)
        js = jss.update_threshold(js, jnp.asarray(count), max_k, delta,
                                  1e-3, 2.0, track)
        ts = tss.update_threshold(ts, T(count), max_k, delta, 1e-3, 2.0,
                                  track)
        assert_state_close(ts, js, 1e-7)


def test_adaptive_threshold_search():
    h, w, k = 8, 16, 3
    rgba, _, _ = stream(4, 12, h, w)

    def jcount(thr):
        st = jss.init_count(h, w)
        for i in range(rgba.shape[0]):
            st = jss.push_count(st, thr, jnp.asarray(rgba[i]))
        return st.count

    def tcount(thr):
        st = tss.init_count(h, w, device=CPU)
        for i in range(rgba.shape[0]):
            st = tss.push_count(st, thr, T(rgba[i]))
        return st.count

    np.testing.assert_array_equal(
        np_(tss.adaptive_threshold(tcount, k, 5, h, w, device=CPU)),
        np.asarray(jss.adaptive_threshold(jcount, k, 5, h, w)))


@pytest.mark.parametrize("chunks", [(12,), (7, 5), (1, 4, 1, 6)])
def test_seg_fold_chunk_matches_reference(chunks):
    h, w, k = 16, 40, 5
    rgba, t0, t1 = stream(5, 12, h, w)
    thr = np.full((h, w), 0.35, np.float32)
    js = jsf.init_seg_state(k, h, w)
    ts = tsf.init_seg_state(k, h, w, device=CPU)
    lo = 0
    for c in chunks:
        sl = slice(lo, lo + c)
        js = jsf.seg_fold_chunk(js, jnp.asarray(rgba[sl]), jnp.asarray(t0[sl]),
                                jnp.asarray(t1[sl]), jnp.asarray(thr),
                                max_k=k)
        ts = tsf.seg_fold_chunk(ts, T(rgba[sl]), T(t0[sl]), T(t1[sl]),
                                T(thr), max_k=k)
        lo += c
    assert_state_close(ts, js, 1e-6)
    assert_state_close(tsf.seg_finalize(ts), jsf.seg_finalize(js), 1e-6)


def _compact(seed, c, h, w):
    """A compact-form chunk: rgba plus per-slice ratios and ray lengths."""
    rng = np.random.default_rng(seed)
    rgba, _, _ = stream(seed, c, h, w)
    sk0 = (np.sort(rng.random(c)).astype(np.float32) + np.float32(0.5))
    sk1 = (sk0 + np.float32(0.03)).astype(np.float32)
    length = (1.0 + rng.random((h, w))).astype(np.float32)
    return rgba, sk0, sk1, length


@pytest.mark.parametrize("chunks,k", [((16,), 16), ((6, 1, 5), 4),
                                      ((1, 1), 3), ((8, 8), 1)])
def test_plain_k1_matches_pallas_seg_interpret(chunks, k):
    """The plain K1 (the CPU branch of fold_chunk_packed) against the
    reference's compact-form Pallas fold in interpret mode, carrying the
    packed state across chunks, C=1 chunks included."""
    h, w = 16, 40
    thr = (np.random.default_rng(6).random((h, w)) * 0.5).astype(np.float32)
    jp = jpsg.init_seg_packed(k, h, w)
    tp = cs.init_seg_packed(k, h, w, device=CPU)
    for pj, pt in zip(jp, tp):
        np.testing.assert_array_equal(np_(pt), np.asarray(pj))
    for i, c in enumerate(chunks):
        rgba, sk0, sk1, length = _compact(10 + i, c, h, w)
        if i == 1 and c == 1:
            rgba = np.zeros_like(rgba)   # the occupancy-skip sample
        jp = jpsg.fold_chunk_packed(jp, jnp.asarray(rgba),
                                    threshold=jnp.asarray(thr), max_k=k,
                                    sk0=jnp.asarray(sk0),
                                    sk1=jnp.asarray(sk1),
                                    length=jnp.asarray(length),
                                    interpret=True)
        out = cs.fold_chunk_packed(tp, T(rgba), T(thr), max_k=k, sk0=T(sk0),
                                   sk1=T(sk1), length=T(length))
        assert out is tp                          # updated in place
        for name, a, b in zip(("color", "depth", "small"), tp, jp):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(np_(tp[2][0]), np.asarray(jp[2][0]))


# (chunks as (C, kind), K, (H, W), threshold): the edges K1's card
# builds are tested on — saturated counts, threshold 0 and +inf, empty
# chunks after live ones, the generic build's C = 7 and 33, W not a
# multiple of 4 (H a multiple of the reference's TILE_H)
K1_EDGES = {
    "saturated": (((16, "live"), (16, "live"), (16, "live")), 4, (16, 40),
                  "rand"),
    "thr0": (((16, "live"), (7, "live")), 16, (8, 40), "zero"),
    "thr_inf": (((16, "live"), (16, "live")), 4, (8, 40), "inf"),
    "empty_after_live": (((16, "live"), (16, "empty"), (1, "empty"),
                          (16, "live")), 4, (8, 40), "rand"),
    "c7": (((7, "live"), (7, "live"), (7, "live")), 4, (16, 40), "rand"),
    "c33": (((33, "live"),), 16, (8, 40), "rand"),
    "w37": (((16, "live"), (1, "live")), 4, (8, 37), "rand"),
    "w90_k1": (((33, "live"), (7, "live")), 1, (8, 90), "rand"),
}


@pytest.mark.parametrize("case", sorted(K1_EDGES))
def test_plain_k1_matches_pallas_seg_interpret_edges(case):
    """The plain K1 against the reference's compact-form Pallas fold in
    interpret mode on the edge cases of K1's card tests, the packed state
    carried across chunks; the bars of
    test_plain_k1_matches_pallas_seg_interpret."""
    chunks, k, (h, w), thr_kind = K1_EDGES[case]
    thr = {"rand": (np.random.default_rng(7).random((h, w)) * 0.5),
           "zero": np.zeros((h, w)),
           "inf": np.full((h, w), np.inf)}[thr_kind].astype(np.float32)
    jp = jpsg.init_seg_packed(k, h, w)
    tp = cs.init_seg_packed(k, h, w, device=CPU)
    for i, (c, kind) in enumerate(chunks):
        rgba, sk0, sk1, length = _compact(60 + i, c, h, w)
        if kind == "empty":
            rgba = np.zeros_like(rgba)
        jp = jpsg.fold_chunk_packed(jp, jnp.asarray(rgba),
                                    threshold=jnp.asarray(thr), max_k=k,
                                    sk0=jnp.asarray(sk0),
                                    sk1=jnp.asarray(sk1),
                                    length=jnp.asarray(length),
                                    interpret=True)
        cs.fold_chunk_packed(tp, T(rgba), T(thr), max_k=k, sk0=T(sk0),
                             sk1=T(sk1), length=T(length))
        for name, a, b in zip(("color", "depth", "small"), tp, jp):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} {i}")
        np.testing.assert_array_equal(np_(tp[2][0]), np.asarray(jp[2][0]))
    cnt = np_(tp[2][0])
    if case == "saturated":
        assert cnt.min() > k
    if thr_kind == "zero":
        # every non-empty slice whose colour differs from the last starts
        assert cnt.max() > 16
    assert cnt.max() > 0


def test_plain_k1_matches_seg_fold_chunk_and_round_trips():
    """fold_chunk_packed's plain branch = the reference seg_fold_chunk
    on the unpacked state with t = sk * length; pack/unpack are exact
    inverses."""
    h, w, k = 8, 24, 4
    thr = np.float32(0.3)
    tp = cs.init_seg_packed(k, h, w, device=CPU)
    js = jsf.init_seg_state(k, h, w)
    for i, c in enumerate((5, 1, 7)):
        rgba, sk0, sk1, length = _compact(20 + i, c, h, w)
        cs.fold_chunk_packed(tp, T(rgba), float(thr), max_k=k, sk0=T(sk0),
                             sk1=T(sk1), length=T(length))
        js = jsf.seg_fold_chunk(js, jnp.asarray(rgba),
                                jnp.asarray(sk0[:, None, None] * length),
                                jnp.asarray(sk1[:, None, None] * length),
                                thr, max_k=k)
    st = cs.unpack_seg_state(tp)
    assert_state_close(st, js, 1e-6)
    for a, b in zip(cs.pack_seg_state(st), tp):
        np.testing.assert_array_equal(np_(a), np_(b))


@pytest.mark.parametrize("chunks,bins", [((4, 6), 6), ((16, 1, 16), 16),
                                         ((1,), 2)])
def test_plain_k2_matches_count_multi_interpret(chunks, bins):
    """The plain K2 against the reference's Pallas count in interpret
    mode: counts exactly equal, carried state equal."""
    h, w = 16, 24
    tvec = np.asarray(jss.threshold_candidates(bins, 2.0))
    jc = jpm.init_count_multi_packed(bins, h, w)
    tc = cm.init_count_multi_packed(bins, h, w, device=CPU)
    for i, c in enumerate(chunks):
        rgba, _, _ = stream(30 + i, c, h, w)
        jc = jpm.count_multi_chunk(jc, jnp.asarray(rgba), tvec,
                                   interpret=True)
        out = cm.count_multi_chunk(tc, T(rgba), T(tvec))
        assert out is tc
        np.testing.assert_array_equal(np_(tc[0]), np.asarray(jc[0]))
        np.testing.assert_array_equal(np_(tc[1]), np.asarray(jc[1]))
        np.testing.assert_array_equal(np_(tc[2]), np.asarray(jc[2]))
    assert int(np_(tc[0]).max()) > 0


def test_plain_k2_matches_multi_push_count():
    """K2 ≅ init_count_multi state fed through push_count with the
    candidate stack as the threshold (the port's own oracle)."""
    h, w, bins = 8, 16, 5
    rgba, _, _ = stream(40, 9, h, w, dup_frac=0.5)
    tvec = tss.threshold_candidates(bins, 2.0, device=CPU)
    st = tss.init_count_multi(bins, h, w, device=CPU)
    for i in range(rgba.shape[0]):
        st = tss.push_count(st, tvec[:, None, None], T(rgba[i]))
    carry = cm.init_count_multi_packed(bins, h, w, device=CPU)
    cm.count_multi_chunk(carry, T(rgba[:3]), tvec)
    cm.count_multi_chunk(carry, T(rgba[3:]), tvec)
    np.testing.assert_array_equal(np_(carry[0]), np_(st.count))


def test_wrappers_reject_bad_operands():
    h, w, k = 8, 16, 3
    rgba, sk0, sk1, length = _compact(50, 4, h, w)
    tp = cs.init_seg_packed(k, h, w, device=CPU)
    kw = dict(max_k=k, sk0=T(sk0), sk1=T(sk1), length=T(length))
    with pytest.raises(ValueError, match="max_k"):
        cs.fold_chunk_packed(tp, T(rgba), 0.3, **{**kw, "max_k": k + 1})
    with pytest.raises(TypeError):
        cs.fold_chunk_packed(tp, T(rgba).double(), 0.3, **kw)
    with pytest.raises(ValueError, match="shape"):
        cs.fold_chunk_packed(tp, T(rgba[:, :3]), 0.3, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cs.fold_chunk_packed(tp, T(rgba).transpose(2, 3).contiguous()
                             .transpose(2, 3)[:, :, :, :], 0.3,
                             **{**kw, "length": T(length.T).T})
    carry = cm.init_count_multi_packed(4, h, w, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        cm.count_multi_chunk(carry, T(rgba), torch.zeros(5))
    with pytest.raises(ValueError, match="1..32"):
        cm.count_multi_chunk(cm.init_count_multi_packed(33, h, w,
                                                        device=CPU),
                             T(rgba), torch.zeros(33))


def test_kernels_source_override_serves_another_source(tmp_path):
    """`kernels.source_override` builds a library from another source
    inside the block (a library path of its own, from that source's
    hash) and from ``csrc/`` again after it, also when the block
    raises: how chip_smoke.py times another K1 design through the same
    wrapper."""
    own, own_lib = (kernels.source_path("seg_fold"),
                    kernels.library_path("seg_fold"))
    other = tmp_path / "seg_fold.cu"
    with open(own) as f:
        other.write_text(f.read() + "\n// another design\n")
    with kernels.source_override("seg_fold", str(other)):
        assert kernels.source_path("seg_fold") == str(other)
        assert kernels.library_path("seg_fold") != own_lib
        assert kernels.source_path("stencil") != str(other)
    with pytest.raises(KeyError):
        with kernels.source_override("seg_fold", str(other)):
            raise KeyError("inside the block")
    assert kernels.source_path("seg_fold") == own
    assert kernels.library_path("seg_fold") == own_lib

"""The exactness argument of K4's threshold search (``csrc/resegment.cu``),
checked on the CPU against the JAX package.

K4 walks a pixel's sorted stream once and keeps F, the forced segment
starts, and the largest rgb distances of the other non-empty slots to
their predecessors; the bisection then decides each step by ``F > K_out
or v > mid``, v the (K_out - F + 1)-th largest distance. `search` below
is a plain emulation of that search. On seeded sorted streams, for every
listed ``adaptive_iters`` and ``thr_max``, its thresholds must equal:

- the reference's own search, the functions the reference Pallas
  kernel's body runs (``supersegments.adaptive_threshold`` over
  ``push_count`` passes), exactly;
- the port's ``resegment_sorted_plain`` (``threshold_out``), exactly;
- and, handed to the reference's Pallas ``resegment_sorted`` (interpret
  mode) as a fixed threshold, they give the same slots bit for bit as
  that kernel's own in-kernel search (and the port's plain slots are
  within the composite tests' 1e-6 of them).

The bisection's midpoints, walked in order, ascend strictly, and the
search's threshold is the smallest of them (or ``thr_max``) whose count
is <= K_out: what makes a summary of the distances enough. K4's and
K2's sources define the entries ``kernels.py`` binds and keep the plain
version's distance. K4 itself runs only on a card
(``tests/test_torch_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu.ops import pallas_composite as jpc
from scenery_insitu_tpu.ops import supersegments as jss
from scenery_insitu_tpu_torch import kernels
from scenery_insitu_tpu_torch.ops import cuda_composite as tcc
from tests.test_torch_composite import assert_slots_close
from tests.test_torch_kernels import midpoint_stream, sorted_stream
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

EMPTY_ALPHA = np.float32(1e-4)
GAP_EPS = 1e-4
F32 = np.float32


def walk(color, depth, k_out, gap_eps):
    """One walk over the slots of every pixel, as K4 walks them: (F
    i32[H,W], the K_out + 1 largest non-forced distances f32[L,H,W]
    descending with -inf where fewer, every non-forced distance as a
    list [H,W] of arrays)."""
    nk, _, h, w = color.shape
    forced = np.zeros((h, w), np.int32)
    top = np.full((k_out + 1, h, w), -np.inf, F32)
    dists = [[[] for _ in range(w)] for _ in range(h)]
    pe = np.ones((h, w), bool)
    prev = np.zeros((3, h, w), F32)
    pend = np.full((h, w), -np.inf, F32)
    for i in range(nk):
        rgb, a = color[i, :3], color[i, 3]
        live = ~(a < EMPTY_ALPHA)
        f = pe.copy()
        if gap_eps >= 0.0:
            f |= ~pe & (depth[i, 0] > pend + F32(gap_eps))
        d = rgb - prev
        x = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        other = live & ~f
        forced += (live & f).astype(np.int32)
        x_in = np.where(other & (x == x), x, F32(-np.inf)).astype(F32)
        # the insert network: entry j <- max(v[j], min(v[j - 1], x))
        top[1:] = np.maximum(top[1:], np.minimum(top[:-1], x_in))
        top[0] = np.maximum(top[0], x_in)
        for y, xx in zip(*np.nonzero(other)):
            dists[y][xx].append(x[y, xx])
        prev = np.where(live[None], rgb, prev)
        pend = np.where(live, depth[i, 1], pend)
        pe = ~live
    return forced, top, dists


def search(color, depth, k_out, iters, thr_max, gap_eps=GAP_EPS, thr=None):
    """K4's threshold: the walk's summary, then the bisection."""
    _, _, h, w = color.shape
    if iters <= 0:
        return thr
    forced, top, _ = walk(color, depth, k_out, gap_eps)
    g = k_out - forced
    v = np.take_along_axis(top, np.clip(g, 0, k_out)[None], 0)[0]
    v = np.where(g >= 0, v, F32(np.inf))        # over: F > K_out
    lo = np.zeros((h, w), F32)
    hi = np.full((h, w), thr_max, F32)
    for _ in range(iters):
        mid = F32(0.5) * (lo + hi)
        too_many = (forced > k_out) | (v > mid)
        lo, hi = np.where(too_many, mid, lo), np.where(too_many, hi, mid)
    return hi


def midpoint_table(iters, thr_max):
    """The midpoints the bisection can visit, in order (left subtree,
    node, right subtree), each made by its own f32 operations."""
    def node(lo, hi, depth):
        if depth == 0:
            return []
        mid = F32(0.5) * (lo + hi)
        return node(lo, mid, depth - 1) + [mid] + node(mid, hi, depth - 1)

    return np.array(node(F32(0.0), F32(thr_max), iters), F32)


def reference_search(color, depth, k_out, iters, thr_max, gap_eps):
    """The reference's search: the functions its Pallas kernel's body
    runs, on the whole image."""
    _, _, h, w = color.shape
    sc, sd = jnp.asarray(color), jnp.asarray(depth)

    def count_fn(mid):
        st = jss.init_count(h, w)
        for i in range(sc.shape[0]):
            st = jss.push_count(st, mid, sc[i], sd[i, 0], sd[i, 1], gap_eps)
        return st.count

    return np.asarray(jss.adaptive_threshold(count_fn, k_out, iters, h, w,
                                             thr_max))


CASES = [("seeded", 24, 5, GAP_EPS), ("midpoints", 16, 3, GAP_EPS),
         ("gap_off", 24, 5, -1.0)]


@pytest.mark.parametrize("thr_max", [2.0, 1.7])
@pytest.mark.parametrize("iters", [0, 1, 6, 8])
@pytest.mark.parametrize("case,nk,k_out,gap_eps", CASES)
def test_search_equals_reference(case, nk, k_out, gap_eps, iters, thr_max):
    h, w = 3, 37
    if case == "midpoints":
        color, depth = midpoint_stream(nk, h, w)
        thr = np.full((h, w), 0.25, F32)
    else:
        color, depth, thr = sorted_stream(nk, h, w, seed=nk + iters)
    got = search(color, depth, k_out, iters, thr_max, gap_eps, thr)

    # the port's plain version, with its threshold_out
    t_out = torch.empty((h, w))
    plain = tcc.resegment_sorted_plain(
        torch.from_numpy(color), torch.from_numpy(depth),
        torch.from_numpy(thr), k_out, gap_eps, adaptive_iters=iters,
        thr_max=thr_max, threshold_out=t_out)
    np.testing.assert_array_equal(got, t_out.numpy())
    if iters > 0:
        np.testing.assert_array_equal(got, reference_search(
            color, depth, k_out, iters, thr_max, gap_eps))

    # the reference kernel: its own search, and the same stream at the
    # emulated thresholds, slot for slot
    sc, sd = jnp.asarray(color), jnp.asarray(depth)
    want = jpc.resegment_sorted(sc, sd, jnp.asarray(thr), k_out, gap_eps,
                                interpret=True, adaptive_iters=iters,
                                thr_max=thr_max)
    fixed = jpc.resegment_sorted(sc, sd, jnp.asarray(got), k_out, gap_eps,
                                 interpret=True, adaptive_iters=0)
    for a, b in zip(want, fixed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert_slots_close(plain[0], plain[1], want[0], want[1])


@pytest.mark.parametrize("thr_max", [2.0, 1.7])
@pytest.mark.parametrize("iters", [1, 6, 8, 10])
def test_midpoint_table_ascends_and_bounds_the_search(iters, thr_max):
    """The in-order walk of the bisection's midpoints ascends strictly,
    and the search's threshold is the smallest table entry (or
    ``thr_max``) whose count F + #{d > m} is <= K_out."""
    table = midpoint_table(iters, thr_max)
    assert table.shape == (2 ** iters - 1,)
    assert (np.diff(table) > 0).all()
    nk, k_out, h, w = 24, 5, 3, 37
    color, depth, thr = sorted_stream(nk, h, w, seed=7 + iters)
    got = search(color, depth, k_out, iters, thr_max, thr=thr)
    forced, _, dists = walk(color, depth, k_out, GAP_EPS)
    grid = np.append(table, F32(thr_max))
    for y in range(h):
        for x in range(w):
            d = np.asarray(dists[y][x], F32)
            counts = forced[y, x] + (d[None] > grid[:, None]).sum(1)
            fits = np.nonzero(counts <= k_out)[0]
            want = grid[fits[0]] if fits.size else F32(thr_max)
            assert got[y, x] == want, (y, x)


@pytest.mark.parametrize("lib,names", [
    ("resegment", ["resegment_attributes", "resegment_sorted"]),
    ("count_multi", ["count_multi", "count_multi_attributes"])])
def test_kernel_source_binds_its_entries_and_keeps_the_distance(lib, names):
    """``csrc/resegment.cu`` (K4) and ``csrc/count_multi.cu`` (K2) define
    every C entry and query that ``kernels.py`` binds to them, and write
    the rgb distance as the plain version writes it, in a library built
    without FMA contraction or fast math: one ulp in a distance flips a
    count, and with it a threshold."""
    with open(kernels.source_path(lib)) as f:
        src = f.read()
    bound = sorted(n for n, (owner, _) in {**kernels.ENTRIES,
                                           **kernels.QUERIES}.items()
                   if owner == lib)
    assert bound == names
    for name in names:
        assert f'extern "C" int {name}(' in src, name
    assert "sqrtf(d0 * d0 + d1 * d1 + d2 * d2)" in src
    assert "-fmad=false" in kernels.NVCC_FLAGS
    assert not any("fast_math" in f for f in kernels.NVCC_FLAGS)

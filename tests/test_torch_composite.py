"""Parity of the port's sort-last composite with the JAX package, on the
CPU: the plain version of kernel K4 against the reference's Pallas
``resegment_sorted`` (interpret mode), and ``composite_vdis`` of N > 1
ranks under every backend against the reference's ``composite_vdis``.

Inputs are made with numpy from a seed and handed to both packages. The
bar is the reference's own for its Pallas composite, atol 1e-6
(``tests/test_pallas.py``), with the same slots live on both sides.
K4 itself runs only on a card (``tests/test_torch_kernels.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.ops import composite as jcomp
from scenery_insitu_tpu.ops import pallas_composite as jpc
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch.ops import composite as tcomp
from scenery_insitu_tpu_torch.ops import cuda_composite as tcc
from tests.test_torch_kernels import sorted_stream
from tests.test_torch_pipeline import (  # noqa: F401
    _vdi_stack, np_, one_torch_thread)

ATOL = 1e-6


def assert_slots_close(color, depth, want_color, want_depth):
    color, depth = np_(color), np_(depth)
    want_color, want_depth = np.asarray(want_color), np.asarray(want_depth)
    np.testing.assert_allclose(color, want_color, atol=ATOL, rtol=0)
    live = np.isfinite(want_depth)
    assert (np.isfinite(depth) == live).all(), "slot liveness"
    np.testing.assert_allclose(depth[live], want_depth[live], atol=ATOL,
                               rtol=0)


# (nk, k_out, h, w): no H or W a multiple of the reference's (8, 128)
# tile; k_out below and above nk
@pytest.mark.parametrize("nk,k_out,h,w", [(8, 5, 5, 37), (24, 16, 13, 20),
                                          (6, 9, 3, 130)])
@pytest.mark.parametrize("iters", [0, 6])
def test_resegment_plain_matches_reference(nk, k_out, h, w, iters):
    color, depth, thr = sorted_stream(nk, h, w, seed=nk + iters)
    want = jpc.resegment_sorted(jnp.asarray(color), jnp.asarray(depth),
                                jnp.asarray(thr), k_out, 1e-4,
                                interpret=True, adaptive_iters=iters)
    got = tcc.resegment_sorted(torch.from_numpy(color),
                               torch.from_numpy(depth),
                               torch.from_numpy(thr), k_out, 1e-4,
                               adaptive_iters=iters)
    assert got[0].shape == (k_out, 4, h, w)
    assert_slots_close(got[0], got[1], want[0], want[1])


def test_resegment_checks_its_inputs():
    color, depth, _ = sorted_stream(4, 3, 5, seed=1)
    c, d = torch.from_numpy(color), torch.from_numpy(depth)
    with pytest.raises(ValueError, match="shape"):
        tcc.resegment_sorted(c, d[:, :, :2], None, 4)
    with pytest.raises(TypeError, match="float32"):
        tcc.resegment_sorted(c.double(), d, None, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tcc.resegment_sorted(c.transpose(2, 3).contiguous().transpose(2, 3),
                             d, None, 4)
    with pytest.raises(ValueError, match="k_out"):
        tcc.resegment_sorted(c, d, None, 0)


# (n ranks, k, k_out, adaptive, adaptive_iters)
CASES = [(2, 5, 4, True, 6), (2, 5, 16, True, 6), (4, 4, 6, True, 6),
         (4, 3, 8, False, 6), (2, 4, 3, True, 0)]


@functools.lru_cache(maxsize=None)
def _reference(case, backend):
    n, k, k_out, adaptive, iters = case
    color, depth = _vdi_stack(11 + n + k_out, n, k, 7, 19)
    out = jcomp.composite_vdis(
        jnp.asarray(color), jnp.asarray(depth), jcfg.CompositeConfig(
            max_output_supersegments=k_out, adaptive=adaptive,
            adaptive_iters=iters, backend=backend))
    return color, depth, np.asarray(out.color), np.asarray(out.depth)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_composite_matches_reference(case, backend):
    """N > 1 ranks' sub-VDIs, sorted and resegmented: every backend of
    the port against the reference's same backend (its "auto" is "xla"
    off the TPU, as the port's is on the CPU)."""
    n, k, k_out, adaptive, iters = case
    color, depth, want_c, want_d = _reference(
        case, "xla" if backend == "auto" else backend)
    out = tcomp.composite_vdis(
        torch.from_numpy(color), torch.from_numpy(depth),
        tcfg.CompositeConfig(max_output_supersegments=k_out,
                             adaptive=adaptive, adaptive_iters=iters,
                             backend=backend))
    assert out.color.shape == (k_out, 4, 7, 19)
    assert_slots_close(out.color, out.depth, want_c, want_d)


def test_backends_agree_wherever_the_reference_does():
    """With a non-zero search depth the reference's two backends give the
    same VDI, and so do the port's."""
    n, k, k_out, adaptive, iters = CASES[2]
    color, depth = _vdi_stack(5, n, k, 9, 10)
    outs = [tcomp.composite_vdis(torch.from_numpy(color),
                                 torch.from_numpy(depth),
                                 tcfg.CompositeConfig(
                                     max_output_supersegments=k_out,
                                     adaptive_iters=iters, backend=b))
            for b in ("xla", "pallas")]
    torch.testing.assert_close(outs[0].color, outs[1].color, rtol=0, atol=0)
    torch.testing.assert_close(outs[0].depth, outs[1].depth, rtol=0, atol=0)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        tcfg.CompositeConfig(backend="triton")

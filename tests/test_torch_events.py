"""The exactness argument of B8's and B9's phase 2 (``csrc/fold_chunk.cu``
in ``scenery_insitu_tpu_torch``), on the CPU.

The reference's phase 2 matches every recorded close event against
every slot and adds the masked events into each slot's colour row (the
depths by ``where(hit)``). The kernels instead write each close at a slot
they do not record: k at entry plus the closes before it in the chunk,
and visit no other slot. Two facts make that exact, and this file holds
both without a card:

- phase 1 (`fold_microbench._record_events`, the machine the plain
  versions and the kernels share) gives a chunk's closes consecutive
  slots from k at entry, in slice order, so at most one a slot and at
  most min(C, K - 1 - k) a chunk: on the microbenchmark's own stream
  (S = 256 on a small image), seeded streams, a stream whose every slice
  closes, and a K = 4 stream that fills the slot cap;
- a torch emulation of the kernels' phase 2 (implicit slots, only the
  closed slots written: colour += event, depth = the event's start and
  end) equals the plain versions of B8 and B9 and B7's plain version bit
  for bit on the same streams, and the reference's ``_scratch_kernel``
  in interpret mode at C = 8, K = 4 (slot counters exactly, the state
  within 1e-6, the bar of ``tests/test_torch_microbench.py``).

The reference's B8 kernel is left out: in interpret mode it takes ~200 s
a call at C = 16."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.benchmarks import fold_microbench as tfm
from scenery_insitu_tpu_torch.ops import cuda_march as cm

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "reference_fold_microbench",
    os.path.join(ROOT, "benchmarks", "fold_microbench.py"))
rfm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rfm)

H, W = 8, 40
STREAMS = ("micro", "seeded", "all_close", "cap")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of small torch operations: one thread each, so the
    suite's other workers do not wait on each other's pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stream(kind, c, k):
    """(chunks [(rgba, t0, t1)], threshold f32[H, W]) of one stream:
    ``micro`` the microbenchmark's own (S = 256, threshold 0.35),
    ``seeded`` random colours with empty runs and near-duplicates over
    3 chunks, ``all_close`` colours alternating by slice at threshold 0
    (every slice after the first closes), ``cap`` the seeded stream over
    4 chunks into K = 4 slots whatever ``k``; at least 32 slices each."""
    f32 = np.float32
    if kind == "micro":
        chunks = [tfm.stream_chunk(ci, c, H, W, CPU)
                  for ci in range(256 // c)]
        return chunks, torch.full((H, W), tfm.THRESHOLD)
    # at least 32 slices, so every C reaches the cap where it should
    n = max({"seeded": 3, "all_close": 3, "cap": 4}[kind], 32 // c)
    s = n * c
    rng = np.random.default_rng(c * 100 + k)
    if kind == "all_close":
        rgba = np.zeros((s, 4, H, W), f32)
        rgba[0::2, 0] = 0.5
        rgba[1::2, 1] = 0.5
        rgba[:, 3] = 0.5
        thr = np.zeros((H, W), f32)
    else:
        rgb = rng.random((s, 3, H, W), dtype=f32)
        dup = (rng.random((s, 1, H, W)) < 0.3) & \
            (np.arange(s)[:, None, None, None] > 0)
        rgb = np.where(dup, np.roll(rgb, 1, axis=0), rgb)
        a = (0.05 + 0.85 * rng.random((s, 1, H, W), dtype=f32)) * \
            (rng.random((s, 1, H, W)) > 0.4)
        rgba = np.concatenate([rgb * a, a], axis=1).astype(f32)
        thr = (0.05 + 0.5 * rng.random((H, W))).astype(f32)
    t0 = np.cumsum(np.full((s, H, W), 0.1, f32), axis=0)
    t1 = (t0 + f32(0.1)).astype(f32)
    chunks = [tuple(torch.from_numpy(np.ascontiguousarray(x[i:i + c]))
                    for x in (rgba, t0, t1)) for i in range(0, s, c)]
    return chunks, torch.from_numpy(thr)


def slots_of(kind, k):
    return 4 if kind == "cap" else k


def implicit_fold(big, small, rgba, t0, t1, threshold, *, max_k):
    """The kernels' two phases in torch, in place: phase 1 as the plain
    versions (its recorded slot read only as a close flag), then phase
    2, once every close is recorded, writing each close at its implicit
    slot (k at entry plus the closes before it in the chunk) and visiting
    no other slot."""
    color, depth = big
    k_in = small[11].clone()
    closes = torch.zeros_like(k_in)
    rows = []
    for slot, ev_rgba, ev_start, ev_end in tfm._record_events(
            small, rgba, t0, t1, threshold, max_k):
        hit = slot >= 0
        i, j = torch.nonzero(hit, as_tuple=True)
        rows.append(((k_in + closes).long()[i, j], i, j, ev_rgba[:, i, j],
                     ev_start[i, j], ev_end[i, j]))
        closes = closes + hit.to(closes.dtype)
    for s, i, j, c, a, b in rows:
        color[s, :, i, j] = color[s, :, i, j] + c.T
        depth[s, 0, i, j] = a
        depth[s, 1, i, j] = b
    return big, small


@pytest.mark.parametrize("c", [1, 8, 16, 32])
@pytest.mark.parametrize("kind", STREAMS)
def test_closes_take_consecutive_slots(kind, c):
    """Each chunk's closes take slots k_in, k_in + 1, ... in slice order:
    at most one a slot, at most min(C, K - 1 - k_in), and k after the
    chunk is k_in plus the closes."""
    k = slots_of(kind, 16)
    chunks, thr = stream(kind, c, k)
    _, small = tfm.events_init(k, H, W, device=CPU)
    closed = 0
    for i, (rgba, t0, t1) in enumerate(chunks):
        k_in = small[11].clone()
        events = tfm._record_events(small, rgba, t0, t1, thr, k)
        n = torch.zeros_like(k_in)
        for slot, _, _, _ in events:
            hit = slot >= 0
            assert torch.equal(slot[hit], (k_in + n)[hit])
            n = n + hit.to(n.dtype)
        assert bool((n <= torch.clamp(k - 1 - k_in, max=c)).all())
        assert torch.equal(small[11], k_in + n)
        if kind == "all_close":
            assert torch.equal(n, torch.clamp(k - 1 - k_in,
                                              max=c - (i == 0)))
        closed += int(n.sum())
    assert closed > 0
    if kind == "cap":
        assert bool((small[11] == k - 1).all()), "the stream fills the cap"


@pytest.mark.parametrize("c", [1, 8, 16, 32])
@pytest.mark.parametrize("kind", STREAMS)
def test_implicit_phase2_equals_plain_versions(kind, c):
    """The emulation equals B8's and B9's plain versions and B7's plain
    version bit for bit, chunk after chunk."""
    k = slots_of(kind, 16)
    chunks, thr = stream(kind, c, k)
    states = {f: tfm.events_init(k, H, W, device=CPU)
              for f in (implicit_fold, tfm.events_fold_chunk_plain,
                        tfm.scratch_fold_chunk_plain)}
    b7 = cm.init_packed(k, H, W, device=CPU)
    for rgba, t0, t1 in chunks:
        cm.fold_chunk_plain(b7, rgba, t0, t1, thr, max_k=k)
        for fold, (big, small) in states.items():
            fold(big, small, rgba, t0, t1, thr, max_k=k)
        for fold, (big, small) in states.items():
            for a, b in zip((*big, small), b7):
                assert torch.equal(a, b), fold.__name__


def test_implicit_phase2_matches_reference_scratch_kernel():
    """C = 8, K = 4 over the seeded stream's 4 chunks (it fills the slot
    cap): the emulation against the reference's ``_scratch_kernel`` in
    interpret mode."""
    k, c = 4, 8
    chunks, thr = stream("cap", c, k)
    big, small = tfm.events_init(k, H, W, device=CPU)
    rbig, rsmall = rfm.events_init(k, H, W)
    for rgba, t0, t1 in chunks:
        implicit_fold(big, small, rgba, t0, t1, thr, max_k=k)
        rbig, rsmall = rfm.scratch_fold_chunk(
            rbig, rsmall, *(jnp.asarray(x.numpy()) for x in (rgba, t0, t1)),
            jnp.asarray(thr.numpy()), max_k=k)
    np.testing.assert_array_equal(convert.to_numpy(small[11]),
                                  np.asarray(rsmall[11]))
    assert float(small[11].max()) == k - 1
    for got, want in zip((*big, small), (*rbig, rsmall)):
        np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("c", tfm.SCRATCH_CHUNKS)
def test_scratch_block_holds_the_kernels_scratch(c):
    """B9's block is a whole number of warps, no larger than
    `SCRATCH_BLOCK` or `scratch_threads`, and its scratch (24 min(C, K - 1)
    bytes a thread) fits the shared memory a block may opt in to at any
    K."""
    threads = tfm.scratch_block(c)
    assert threads % 32 == 0 and threads >= 32
    assert threads <= min(tfm.SCRATCH_BLOCK, tfm.scratch_threads(c))
    for k in (2, 4, 16, 64, 1024):
        assert 24 * min(c, k - 1) * threads <= tfm.SMEM_OPTIN_BYTES

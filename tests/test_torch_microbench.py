"""The port's fold-schedule microbenchmark
(``scenery_insitu_tpu_torch/benchmarks/fold_microbench.py``) against the
reference's ``benchmarks/fold_microbench.py``, on the CPU.

The reference script is not a package; it is loaded from its path. Its
Pallas kernels run in interpret mode on the CPU (``pallas_util.
should_interpret``). Tolerances:

- the synthetic streams and the torch shading: within 1e-6 (the sines
  and powers of the two libraries may round an ulp apart);
- the plain versions of B8 (``events_fold_chunk``) and B9
  (``scratch_fold_chunk``) against the reference's kernels: slot counts
  exact, the machine state, colours and depths within 1e-6; B8 plain,
  B9 plain and B7 plain (``cuda_march.fold_chunk_plain``) equal to each
  other exactly (a slot closes at most once over a march, so phase 2's
  sums are selects);
- every variant's ``build`` against the reference's: rtol 1e-5, atol
  1e-5 (the reference's ``--check`` bar).

The reference's B8 kernel in interpret mode takes ~3 s a call at C = 8,
K = 4, and ~200 s at C = 16, K = 6 (its phase 2 unrolls K x C blocks;
timed on an x86 CPU). At C = 16, K = 6 B8's plain version is therefore
held against the reference's B9 kernel (the same function) and its
plain oracle, C sequential ``supersegments.push`` calls."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu.ops import supersegments as jss
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.benchmarks import fold_microbench as tfm
from scenery_insitu_tpu_torch.ops import cuda_march as cm
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "reference_fold_microbench",
    os.path.join(ROOT, "benchmarks", "fold_microbench.py"))
rfm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rfm)

H, W = 16, 128
REF_KEYS = {"variant", "ms_per_march", "compile_s", "grid", "hw", "k",
            "chunk", "platform"}


def np_(x):
    return convert.to_numpy(x)


def T(x):
    return torch.from_numpy(np.array(x))


def seeded_chunks(seed, n, c, h=H, w=W):
    """``n`` chunks of a depth-ordered shaded stream with empty runs and
    near-duplicate colours (starts, distance breaks and accumulation all
    occur), and a per-pixel threshold: [(rgba, t0, t1)], thr (numpy)."""
    rng = np.random.default_rng(seed)
    s = n * c
    rgb = rng.random((s, 3, h, w), dtype=np.float32)
    dup = (rng.random((s, 1, h, w)) < 0.3) & \
        (np.arange(s)[:, None, None, None] > 0)
    rgb = np.where(dup, np.roll(rgb, 1, axis=0), rgb)
    alpha = (0.05 + 0.85 * rng.random((s, 1, h, w), dtype=np.float32))
    alpha = alpha * (rng.random((s, 1, h, w)) > 0.4)
    rgba = np.concatenate([rgb * alpha, alpha], axis=1).astype(np.float32)
    t0 = np.cumsum(np.full((s, h, w), 0.1, np.float32), axis=0)
    t1 = (t0 + np.float32(0.1)).astype(np.float32)
    thr = (0.05 + 0.5 * rng.random((h, w))).astype(np.float32)
    return [(rgba[i:i + c], t0[i:i + c], t1[i:i + c])
            for i in range(0, s, c)], thr


def twin_fold(fold, chunks, thr, k):
    big, small = tfm.events_init(k, H, W, device=CPU)
    for rgba, t0, t1 in chunks:
        fold(big, small, T(rgba), T(t0), T(t1), T(thr), max_k=k)
    return big, small


def assert_state_close(big, small, want_big, want_small, k):
    np.testing.assert_array_equal(np_(small[11]), np.asarray(want_small[11]))
    assert np_(small[11]).max() == k - 1, "the stream fills the slot cap"
    for got, want in zip((*big, small), (*want_big, want_small)):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------- streams


@pytest.mark.parametrize("ci", [0, 3, 9])
def test_streams_and_shading_match_reference(ci):
    c, h, w = 16, 24, 40
    for a, b in zip(tfm.stream_chunk(ci, c, h, w, CPU),
                    rfm.stream_chunk(jnp.int32(ci), c, h, w)):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-6)
    val, sk = tfm.stream_val_chunk(ci, c, h, w, CPU)
    rval, rsk = rfm.stream_val_chunk(jnp.int32(ci), c, h, w)
    np.testing.assert_allclose(np_(val), np.asarray(rval), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_(sk), np.asarray(rsk), rtol=0, atol=1e-6)
    rng = np.random.default_rng(ci)
    length = (1.0 + rng.random((h, w))).astype(np.float32)
    ratio = (0.5 + rng.random((h, w))).astype(np.float32)
    got = tfm.shade(T(np.asarray(rval)), T(np.asarray(rsk)), tfm.fused_tf(CPU),
                    T(length), T(ratio), 0.01)
    want = rfm._shade_xla(rval, rsk, rfm._fused_tf(), jnp.asarray(length),
                          jnp.asarray(ratio), jnp.float32(0.01))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-6)


# ------------------------------------------------------ B8, B9: plain vs ref


def reference_fold(fold, chunks, thr, k):
    big, small = rfm.events_init(k, H, W)
    for rgba, t0, t1 in chunks:
        big, small = fold(big, small, jnp.asarray(rgba), jnp.asarray(t0),
                          jnp.asarray(t1), jnp.asarray(thr), max_k=k)
    return big, small


@pytest.mark.parametrize("variant", ["events", "scratch"])
def test_event_folds_plain_match_reference_kernels(variant):
    """C = 8, K = 4 over 4 chunks, each plain version against its own
    reference kernel in interpret mode."""
    chunks, thr = seeded_chunks(1, 4, 8)
    plain = {"events": tfm.events_fold_chunk_plain,
             "scratch": tfm.scratch_fold_chunk_plain}[variant]
    ref = {"events": rfm.events_fold_chunk,
           "scratch": rfm.scratch_fold_chunk}[variant]
    assert_state_close(*twin_fold(plain, chunks, thr, 4),
                       *reference_fold(ref, chunks, thr, 4), 4)


def test_event_folds_plain_match_reference_c16_k6():
    """C = 16, K = 6 over 3 chunks: both plain versions against the
    reference's B9 kernel in interpret mode, and B8's against the
    reference's sequential machine (C ``supersegments.push`` calls a
    chunk), finalised."""
    k = 6
    chunks, thr = seeded_chunks(2, 3, 16)
    want_big, want_small = reference_fold(rfm.scratch_fold_chunk, chunks,
                                          thr, k)
    for plain in (tfm.events_fold_chunk_plain, tfm.scratch_fold_chunk_plain):
        assert_state_close(*twin_fold(plain, chunks, thr, k), want_big,
                           want_small, k)
    st = jss.init_state(k, H, W)
    for rgba, t0, t1 in chunks:
        for i in range(rgba.shape[0]):
            st = jss.push(st, k, jnp.asarray(thr), jnp.asarray(rgba[i]),
                          jnp.asarray(t0[i]), jnp.asarray(t1[i]))
    want = jss.finalize(st)
    got = tfm.events_finalize(*twin_fold(tfm.events_fold_chunk_plain,
                                         chunks, thr, k))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("c,k", [(8, 4), (16, 6), (16, 16)])
def test_event_folds_plain_equal_b7_plain(c, k):
    """B8 plain = B9 plain = B7 plain, exactly, chunk after chunk."""
    chunks, thr = seeded_chunks(3, 3, c)
    b7 = cm.init_packed(k, H, W, device=CPU)
    for rgba, t0, t1 in chunks:
        cm.fold_chunk_plain(b7, T(rgba), T(t0), T(t1), T(thr), max_k=k)
    for plain in (tfm.events_fold_chunk_plain, tfm.scratch_fold_chunk_plain):
        big, small = twin_fold(plain, chunks, thr, k)
        for a, b in zip((*big, small), b7):
            assert torch.equal(a, b)


# ------------------------------------------------------------ the variants


CASES = [(v, 16) for v in tfm.VARIANTS] + \
    [(v, 64) for v in ("xla", "events", "scratch", "fused_stream")]


@pytest.mark.parametrize("variant,s_total", CASES)
def test_build_matches_reference(variant, s_total):
    """Each variant's march against the reference's at C = 8, K = 4 on a
    16 x 128 image. At S = 16 every sample of the rgba stream is empty
    (the blobs sit at s ~ 60 and 150); S = 64 reaches the first blob."""
    c, k = 8, 4
    got = tfm.build(variant, s_total, c, k, H, W, CPU)()
    want = rfm.build(variant, s_total, c, k, H, W)()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_main_prints_a_line_per_variant(capsys):
    """The CPU sweep over every variant with the check, on a stream that
    reaches the first blob: one JSON line each, with the reference's
    keys."""
    argv = ["--grid", "64", "--chunk", "8", "--k", "4", "--iters", "1",
            "--device", "cpu", "--check", "--variants",
            ",".join(tfm.VARIANTS)]
    assert tfm.main(argv) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["variant"] for r in rows] == list(tfm.VARIANTS)
    for r in rows:
        assert REF_KEYS <= set(r), r
        assert (r["grid"], r["hw"], r["k"], r["chunk"], r["platform"]) == \
            (64, [96, 96], 4, 8, "cpu")
        assert r["ms_per_march"] > 0 and r["launches"] == {}


def test_main_reports_a_failing_variant(capsys):
    assert tfm.main(["--grid", "16", "--chunk", "8", "--k", "4", "--iters",
                     "1", "--device", "cpu", "--variants",
                     "none,pallas_t16"]) == 1
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert rows[0]["variant"] == "none" and "error" not in rows[0]
    assert rows[1]["variant"] == "pallas_t16" and "error" in rows[1]


@pytest.mark.parametrize("variant", ["pallas_t16", "pallas_t32",
                                     "pallas_w256", "pallas_gated"])
def test_geometry_sweeps_raise(variant):
    with pytest.raises(NotImplementedError, match="B7 geometry sweep"):
        tfm.build(variant, 16, 8, 4, H, W, CPU)


@pytest.mark.parametrize("variant", ["pallas_x", "pallas_t", "bogus", ""])
def test_unknown_variants_raise(variant):
    with pytest.raises(ValueError, match="unknown"):
        tfm.build(variant, 16, 8, 4, H, W, CPU)


def test_main_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.main(["--grid", "16", "--variants", "none"])


# ---------------------------------------------------------- the wrappers


def test_wrappers_reject_what_the_kernels_do_not_take():
    chunks, thr = seeded_chunks(4, 1, 8)
    rgba, t0, t1 = (T(x) for x in chunks[0])
    big, small = tfm.events_init(4, H, W, device=CPU)
    with pytest.raises(ValueError, match="tile_h"):
        tfm.events_fold_chunk(big, small, rgba, t0, t1, T(thr), max_k=4,
                              tile_h=16)
    with pytest.raises(ValueError, match="max_k"):
        tfm.scratch_fold_chunk(big, small, rgba, t0, t1, T(thr), max_k=5)
    big6, small6 = tfm.events_init(6, H, W, device=CPU)
    with pytest.raises(ValueError, match=r"\(8, 4\)"):
        tfm.events_fold_chunk(big6, small6, rgba, t0, t1, T(thr), max_k=6)
    with pytest.raises(ValueError, match="built for C"):
        tfm.scratch_fold_chunk(big, small, rgba[:4], t0[:4], t1[:4], T(thr),
                               max_k=4)
    with pytest.raises(ValueError, match=r"\(1, 4\)"):
        tfm.events_fold_chunk(big, small, rgba[:4], t0[:4], t1[:4], T(thr),
                              max_k=4)
    # the wrappers on the CPU equal the plain versions (scalar threshold)
    for fold, plain in ((tfm.events_fold_chunk, tfm.events_fold_chunk_plain),
                        (tfm.scratch_fold_chunk,
                         tfm.scratch_fold_chunk_plain)):
        a = tfm.events_init(4, H, W, device=CPU)
        b = tfm.events_init(4, H, W, device=CPU)
        fold(*a, rgba, t0, t1, 0.2, max_k=4)
        plain(*b, rgba, t0, t1, torch.full((H, W), 0.2), max_k=4)
        for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
            assert torch.equal(x, y)


@pytest.mark.parametrize("c,threads", [(8, 256), (16, 256), (32, 256),
                                       (64, 128), (256, 32)])
def test_scratch_threads_fit_shared_memory(c, threads):
    assert tfm.scratch_threads(c) == threads
    assert threads * c * 28 <= tfm.SMEM_OPTIN_BYTES


def test_scratch_threads_raise_when_one_warp_does_not_fit():
    with pytest.raises(ValueError, match="one warp"):
        tfm.scratch_threads(300)

"""Parity of the port's ring exchange (``CompositeConfig.exchange="ring"``)
with the JAX package's, on the CPU.

``merge_vdis_pairwise`` is held bit for bit against the reference's on
the reference's unit cases (disjoint, overlapping, empty slots,
truncation, ties to the accumulator), the same numpy-seeded streams in
both. The 4-rank distributed mxu histogram step and temporal step (the
seed and 2 frames) run under the lossless ring and ``ring_slots`` 12, in
both march regimes, against the reference's same steps at the ``xla``
fold bar of ``tests/test_torch_parallel.py`` (rtol 1e-4, atol 1e-5), and
the lossless ring against the port's own ``all_to_all`` within 1e-6.
Also: the cap's validation message, and the build's counters and events
with the reference's modeled traffic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.ops import composite as jcomp
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.ops import composite as tcomp
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from tests.test_torch_parallel import EYES, N, _args, _check_meta, _setup
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, np_, one_torch_thread)

RTOL, ATOL = 1e-4, 1e-5
K, K_OUT = 10, 16
CAPS = [0, 12]


def _stream(rng, k, h, w, live, lo=1.0, hi=5.0):
    """A per-pixel depth-sorted stream with ``live`` live slots (empty
    slots: zero colour, +inf depth), as numpy."""
    s = np.sort(rng.uniform(lo, hi, (k, h, w)), axis=0).astype(np.float32)
    e = (s + rng.uniform(0.01, 0.2, (k, h, w))).astype(np.float32)
    c = rng.uniform(0.0, 1.0, (k, 4, h, w)).astype(np.float32)
    mask = np.arange(k)[:, None, None] < live
    s = np.where(mask, s, np.inf)
    e = np.where(mask, e, np.inf)
    c = np.where(mask[:, None], c, 0.0).astype(np.float32)
    return c, np.stack([s, e], axis=1).astype(np.float32)


def _ties():
    da = np.asarray([[[[2.0]], [[2.5]]]], np.float32)
    db = np.asarray([[[[2.0]], [[2.6]]]], np.float32)
    return (np.full((1, 4, 1, 1), 0.25, np.float32), da,
            np.full((1, 4, 1, 1), 0.75, np.float32), db)


def _case(name):
    """The reference's merge cases: (ca, da, cb, db, k_cap)."""
    rng = np.random.default_rng({"disjoint": 1, "overlapping": 2,
                                 "empties": 3, "all_empty": 5,
                                 "truncation": 4, "cap_above": 4,
                                 "pixel_ties": 6}.get(name, 0))
    if name == "disjoint":
        return (*_stream(rng, 3, 2, 2, 3, 1.0, 2.0),
                *_stream(rng, 3, 2, 2, 3, 3.0, 4.0), None)
    if name == "overlapping":
        return (*_stream(rng, 5, 3, 4, 5), *_stream(rng, 4, 3, 4, 4), None)
    if name == "empties":
        return (*_stream(rng, 4, 2, 3, 2), *_stream(rng, 4, 2, 3, 1), None)
    if name == "all_empty":
        e = _stream(rng, 3, 2, 2, 0)
        return (*e, *e, None)
    if name in ("truncation", "cap_above"):
        return (*_stream(rng, 4, 2, 2, 4), *_stream(rng, 4, 2, 2, 4),
                5 if name == "truncation" else 8)
    if name == "ties":
        return (*_ties(), None)
    # ties in every pixel: b repeats a's start depths, a's wins
    ca, da = _stream(rng, 5, 3, 3, 4)
    cb, db = _stream(rng, 5, 3, 3, 3)
    db[:3, 0] = da[:3, 0]
    db[:3, 1] = np.where(np.isfinite(db[:3, 0]),
                         np.maximum(db[:3, 1], db[:3, 0]), np.inf)
    return ca, da, cb, db, 7


@pytest.mark.parametrize("case", ["disjoint", "overlapping", "empties",
                                  "all_empty", "truncation", "cap_above",
                                  "ties", "pixel_ties"])
def test_merge_pairwise_matches_reference(case):
    ca, da, cb, db, cap = _case(case)
    tc, td = tcomp.merge_vdis_pairwise(*(torch.from_numpy(x) for x in
                                         (ca, da, cb, db)), k_cap=cap)
    jc, jd = jcomp.merge_vdis_pairwise(*(jnp.asarray(x) for x in
                                         (ca, da, cb, db)), k_cap=cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    m = ca.shape[0] + cb.shape[0]
    assert tc.shape[0] == (m if cap is None else min(cap, m))
    if case == "ties":
        assert float(tc[0, 0, 0, 0]) == 0.25 and float(tc[1, 0, 0, 0]) == 0.75


@pytest.fixture(scope="module", params=range(len(EYES)),
                ids=["z_march", "x_march"])
def steps(request):
    """Per march regime: the reference's histogram VDI and temporal
    frames (seed + 2) under the lossless and the capped ring."""
    s = _setup(EYES[request.param])
    out = {"s": s}
    hcfg = dict(max_supersegments=K, adaptive_mode="histogram")
    tcfg_ = dict(max_supersegments=K, adaptive_mode="temporal")
    jthr0 = jpipe.distributed_initial_threshold_mxu(
        s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**tcfg_))(
            *_args(s, "j"))
    out["jthr0"] = jthr0
    for cap in CAPS:
        ccfg = jcfg.CompositeConfig(max_output_supersegments=K_OUT,
                                    exchange="ring", ring_slots=cap)
        out[("hist", cap)] = jpipe.distributed_vdi_step_mxu(
            s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**hcfg),
            ccfg)(*_args(s, "j"))
        step = jpipe.distributed_vdi_step_mxu_temporal(
            s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**tcfg_), ccfg)
        thr, frames = jthr0, []
        for _ in range(2):
            (vdi, meta), thr = step(*_args(s, "j"), thr)
            frames.append((vdi, meta, thr))
        out[("temporal", cap)] = frames
    return out


def _port_ring(s, temporal, cap, exchange="ring"):
    vcfg = tcfg.VDIConfig(max_supersegments=K, adaptive_mode=(
        "temporal" if temporal else "histogram"))
    ccfg = tcfg.CompositeConfig(max_output_supersegments=K_OUT,
                                exchange=exchange, ring_slots=cap)
    build = (tpipe.distributed_vdi_step_mxu_temporal if temporal
             else tpipe.distributed_vdi_step_mxu)
    return build(s["tmesh"], s["ttf"], s["tspec"], vcfg, ccfg)


@pytest.mark.parametrize("cap", CAPS)
def test_ring_histogram_step_matches_reference(steps, cap):
    s = steps["s"]
    tvdi, tmeta = _port_ring(s, False, cap)(*_args(s, "t"))
    jvdi, jmeta = steps[("hist", cap)]
    assert tvdi.color.shape == (K_OUT, 4, s["tspec"].nj, s["tspec"].ni)
    assert_vdi_close(tvdi.color, tvdi.depth, jvdi.color, jvdi.depth, RTOL,
                     ATOL)
    _check_meta(tmeta, jmeta)
    assert np.isfinite(np_(tvdi.depth)[:, 0]).any(), "live slots"


@pytest.mark.parametrize("cap", CAPS)
def test_ring_temporal_steps_match_reference(steps, cap):
    s = steps["s"]
    from scenery_insitu_tpu_torch import convert

    jthr0 = steps["jthr0"]
    thr = convert.threshold_state(
        {f: np.asarray(x) for f, x in zip(jthr0._fields, jthr0)},
        device="cpu")
    step = _port_ring(s, True, cap)
    for jvdi, jmeta, jthr in steps[("temporal", cap)]:
        (tvdi, tmeta), thr = step(*_args(s, "t"), thr)
        assert_vdi_close(tvdi.color, tvdi.depth, jvdi.color, jvdi.depth,
                         RTOL, ATOL)
        for a, b in zip(thr, jthr):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    _check_meta(tmeta, jmeta)


@pytest.mark.parametrize("temporal", [False, True],
                         ids=["histogram", "temporal"])
@pytest.mark.parametrize("eye", EYES, ids=["z_march", "x_march"])
def test_lossless_ring_equals_all_to_all(eye, temporal):
    """Inside the port the lossless ring gives the all_to_all composite
    (within 1e-6; the slabs' start depths never tie), and so does the
    capped ring where no pixel overflows the cap."""
    s = _setup(eye)
    args = _args(s, "t")
    extra = ()
    if temporal:
        extra = (tpipe.distributed_initial_threshold_mxu(
            s["tmesh"], s["ttf"], s["tspec"], tcfg.VDIConfig(
                max_supersegments=K, adaptive_mode="temporal"))(*args),)
    outs = {}
    for name, ex, cap in (("a2a", "all_to_all", 0), ("ring", "ring", 0),
                          ("wide_cap", "ring", N * K)):
        out = _port_ring(s, temporal, cap, ex)(*args, *extra)
        outs[name] = (out[0][0], out[1]) if temporal else (out[0], None)
    want, want_thr = outs["a2a"]
    for name in ("ring", "wide_cap"):
        got, thr = outs[name]
        assert_vdi_close(got.color, got.depth, want.color, want.depth, 0.0,
                         1e-6)
        if temporal:
            for a, b in zip(thr, want_thr):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ring_slots_below_k_rejected():
    """A cap below one fragment raises with the reference's message; the
    port raises when the step is built."""
    s = _setup(EYES[0])
    vcfg = dict(max_supersegments=K)
    with pytest.raises(ValueError) as a:
        jpipe.distributed_vdi_step_mxu(
            s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**vcfg),
            jcfg.CompositeConfig(exchange="ring", ring_slots=K - 1))(
                *_args(s, "j"))
    with pytest.raises(ValueError) as b:
        tpipe.distributed_vdi_step_mxu(
            s["tmesh"], s["ttf"], s["tspec"], tcfg.VDIConfig(**vcfg),
            tcfg.CompositeConfig(exchange="ring", ring_slots=K - 1))
    assert str(a.value) == str(b.value)
    for kw in ({"ring_slots": -1}, {"exchange": "mesh"}):
        with pytest.raises(ValueError) as a:
            jcfg.CompositeConfig(**kw)
        with pytest.raises(ValueError) as b:
            tcfg.CompositeConfig(**kw)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("cap", CAPS)
def test_ring_build_counts_hops_and_models_traffic(cap):
    """One ring built: ``ring_exchange_builds`` once and
    ``ring_steps_built`` once a hop (n - 1), at build time and not
    again a frame; the build event carries the reference's modeled
    traffic, each hop event its fragment bytes."""
    s = _setup(EYES[0])
    rec = tobs.Recorder(enabled=True)
    prev = tobs.set_recorder(rec)
    try:
        step = _port_ring(s, False, cap)
        step(*_args(s, "t"))
        step(*_args(s, "t"))
    finally:
        tobs.set_recorder(prev)
    assert rec.counters["ring_exchange_builds"] == 1
    assert rec.counters["ring_steps_built"] == N - 1
    builds = [e for e in rec.events if e["name"] == "ring_exchange_build"]
    nj, ni = s["tspec"].nj, s["tspec"].ni
    assert builds[0]["attrs"]["traffic"] == jcomp.modeled_exchange_traffic(
        N, K, nj, ni, k_out=K_OUT, mode="ring", ring_slots=cap, wire="f32")
    assert builds[0]["attrs"]["slots"] == (cap or N * K)
    hops = [e["attrs"] for e in rec.events if e["name"] == "ring_step"]
    assert [h["step"] for h in hops] == list(range(1, N))
    assert all(h["frag_bytes"] == K * nj * (ni // N) * 24 for h in hops)

"""Parity of the port's temporal deltas with the JAX package's, on the
CPU.

The P-frame codec (``ops/delta.py``: `diff_runs`/`apply_runs`, the
encoder's SKIP/P/I sequence on a seeded stream with its forced I's and
reset, the decoder's resync) and the packed delta blobs
(``io/vdi_io.pack_delta_blobs``) are held byte for byte against the
reference's. Fragment reuse (``CompositeConfig.temporal_reuse =
"ranges"``) runs on the reference tests' 32^3 blob scene over 8 ranks,
histogram thresholds, on the frame schedule and in tile waves: the seed
and the signatures equal the reference's exactly, frame 1 marches every
rank and frame 2 none, frame 2 equals frame 1 and the port's reuse-off
step bit for bit, and every frame is within ``ATOL`` of the
reference's. A value pushed out of its cell dirties exactly the ranks
the reference's does, a moved camera dirties every rank, ``range_tol``
accumulates against the last marched frame, a clean rank calls no
generate function, and a brick map ledgers the knob inert. The frozen
8-rank session skips every rank after the first frame and its frames
equal one another bit for bit. Reference runs are shared through
module-scoped fixtures."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu.config import CompositeConfig as JComp
from scenery_insitu_tpu.config import SliceMarchConfig as JSlicer
from scenery_insitu_tpu.config import VDIConfig as JVDI
from scenery_insitu_tpu.core.camera import Camera as JCamera
from scenery_insitu_tpu.core.transfer import TransferFunction as JTF
from scenery_insitu_tpu.io import vdi_io as jio
from scenery_insitu_tpu.ops import delta as jdl
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.config import CompositeConfig as TComp
from scenery_insitu_tpu_torch.config import FrameworkConfig as TFramework
from scenery_insitu_tpu_torch.config import SliceMarchConfig as TSlicer
from scenery_insitu_tpu_torch.config import VDIConfig as TVDI
from scenery_insitu_tpu_torch.core.camera import Camera as TCamera
from scenery_insitu_tpu_torch.core.transfer import TransferFunction as TTF
from scenery_insitu_tpu_torch.io import vdi_io as tio
from scenery_insitu_tpu_torch.ops import delta as tdl
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.parallel.bricks import BrickMap
from scenery_insitu_tpu_torch.runtime.session import InSituSession
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401

CPU = "cpu"
N = 8
K = 6
ATOL = 1e-5
SCHEDULES = ["frame", "waves"]


# ------------------------------------------------------------- the codec


def _codes(rng, shape=(3, 4, 6)):
    return (rng.integers(0, 2**31, shape).astype(np.uint32),
            rng.integers(0, 2**15, shape).astype(np.uint16))


def _stream(seed=0, steps=8):
    """A seeded stream of two tiles: each step repeats a tile, flips one
    code, edits a depth run, changes the scale or re-draws it densely,
    with a reset at step 5."""
    rng = np.random.default_rng(seed)
    tiles = [_codes(rng), _codes(rng)]
    kinds = (0, 0, 1, 2, 0, 3, 4, 0)
    out = []
    for i in range(steps):
        for key in (0, 1):
            c, d = (x.copy() for x in tiles[key])
            if kinds[i] == 1:
                c.ravel()[rng.integers(0, c.size)] ^= np.uint32(
                    1 << int(rng.integers(0, 32)))
            elif kinds[i] == 2:
                d.ravel()[3:7] ^= np.uint16(5)
            elif kinds[i] == 4:
                c, d = _codes(rng)
            tiles[key] = (c, d)
            far = 2.0 if kinds[i] == 3 else 1.0
            out.append((key, c, d, 0.0, far, i == 5 and key == 0))
    return out


def _records_equal(a, b):
    assert (a.mode, a.gen, a.base_gen, a.scale, a.full_bytes,
            a.wire_bytes, a.reason) == (b.mode, b.gen, b.base_gen, b.scale,
                                        b.full_bytes, b.wire_bytes, b.reason)
    for pa, pb in ((a.c_payload, b.c_payload), (a.d_payload, b.d_payload)):
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_diff_apply_runs_match_reference():
    rng = np.random.default_rng(3)
    prev = rng.integers(0, 2**31, 257, dtype=np.int64).astype(np.uint32)
    cur = prev.copy()
    for lo, hi in ((3, 9), (40, 41), (100, 160), (250, 257)):
        cur[lo:hi] = rng.integers(0, 2**31, hi - lo).astype(np.uint32)
    got, want = tdl.diff_runs(prev, cur), jdl.diff_runs(prev, cur)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tdl.apply_runs(prev, *got), cur)
    assert tdl.runs_wire_bytes(got[0], got[2]) == \
        jdl.runs_wire_bytes(want[0], want[2])
    a = np.arange(10, dtype=np.uint16)
    assert all(x.size == 0 for x in tdl.diff_runs(a, a.copy()))
    with pytest.raises(ValueError, match="disagree"):
        tdl.diff_runs(a, a.astype(np.uint32))
    with pytest.raises(ValueError, match="values"):
        tdl.apply_runs(a, np.asarray([1], np.uint32),
                       np.asarray([3], np.uint32), np.asarray([7], np.uint16))


@pytest.mark.parametrize("period", [3, 100])
def test_encoder_sequence_and_blobs_match_reference(period):
    """The seeded stream through both encoders: every record equal field
    by field, the same counters, each record's packed blobs byte for
    byte, and both decoders rebuilding every tile bit for bit."""
    trec, jrec = tobs.Recorder(enabled=True), jobs.Recorder(enabled=True)
    tprev, jprev = tobs.set_recorder(trec), jobs.set_recorder(jrec)
    try:
        tenc, jenc = tdl.DeltaEncoder(period), jdl.DeltaEncoder(period)
        tdec = tdl.DeltaDecoder()
        modes = []
        for key, c, d, near, far, reset in _stream():
            if reset:
                tenc.reset()
                jenc.reset()
            a = tenc.encode(key, c, d, near, far)
            b = jenc.encode(key, c, d, near, far)
            _records_equal(a, b)
            modes.append(a.mode)
            th, tcb, tdb = tio.pack_delta_blobs(a, codec="zlib")
            jh, jcb, jdb = jio.pack_delta_blobs(b, codec="zlib")
            assert (th, tcb, tdb) == (jh, jcb, jdb)
            craw = tio.decompress(tcb, "zlib") if tcb else b""
            draw = tio.decompress(tdb, "zlib") if tdb else b""
            assert (len(craw), len(draw)) == tio.delta_expected_bytes(
                th, c.shape, d.shape) == jio.delta_expected_bytes(
                jh, c.shape, d.shape)
            cp, dp = tio.unpack_delta_payload(th, craw, draw, c.shape,
                                              d.shape)
            got = tdec.apply(key, th["mode"], th["gen"], th["base"], cp, dp,
                             a.scale)
            assert got is not None
            np.testing.assert_array_equal(got[0], c)
            np.testing.assert_array_equal(got[1], d)
        assert tenc.stats == jenc.stats
    finally:
        tobs.set_recorder(tprev)
        jobs.set_recorder(jprev)
    assert {"I", "P", "SKIP"} <= set(modes)
    for name in ("delta_tiles_skipped", "iframe_forced", "delta_bytes_saved"):
        assert trec.counters.get(name, 0) == jrec.counters.get(name, 0), name
    assert trec.counters.get("iframe_forced", 0) >= 1


def test_decoder_resync_matches_reference():
    rng = np.random.default_rng(5)
    enc = tdl.DeltaEncoder(iframe_period=10**6)
    c, d = _codes(rng)
    c1 = c.copy()
    c1.ravel()[0] ^= 1
    c2 = c1.copy()
    c2.ravel()[1] ^= 1
    recs = [enc.encode(0, x, d, 0.0, 1.0) for x in (c, c1, c2)]
    recs.append(tdl.DeltaEncoder(10**6).encode(0, c2, d, 0.0, 1.0))
    tdec, jdec = tdl.DeltaDecoder(), jdl.DeltaDecoder()
    # r1 is lost, then arrives late (its base still matches), then an I
    for i in (0, 2, 1, 3):
        r = recs[i]
        args = (0, r.mode, r.gen, r.base_gen, r.c_payload, r.d_payload,
                r.scale)
        got, want = tdec.apply(*args), jdec.apply(*args)
        assert (got is None) == (want is None), i
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
    assert tdec.stats == jdec.stats and tdec.stats["resync"] == 1
    with pytest.raises(ValueError, match="unknown delta mode"):
        tio.pack_delta_blobs(recs[0]._replace(mode="X"))


def test_modeled_delta_traffic_matches_reference():
    for kw in (dict(skip_frac=0.6, p_frac=0.2, residual_frac=0.1),
               dict(skip_frac=0.0), dict(skip_frac=0.875, iframe_period=4)):
        assert tdl.modeled_delta_traffic(20, 720, 1280, **kw) == \
            jdl.modeled_delta_traffic(20, 720, 1280, **kw)
    with pytest.raises(ValueError):
        tdl.modeled_delta_traffic(20, 720, 1280, skip_frac=0.9, p_frac=0.2)


# ------------------------------------------------------- fragment reuse


@pytest.mark.parametrize("tol", [0.0, 0.25])
def test_reuse_dirty_matches_reference(tol):
    """``reuse_dirty`` on seeded signatures: the seed, still ranges,
    sub- and super-tolerance drift, NaN and a moved camera leaf, as the
    reference decides them."""
    rng = np.random.default_rng(4)
    prev = rng.random(20).astype(np.float32)
    cases = [(prev.copy(), 1), (prev.copy(), 0)]       # still; the seed
    for i, bump in ((3, 0.1), (7, 0.5), (18, 1e-6)):   # ranges, camera
        cur = prev.copy()
        cur[i] += np.float32(bump)
        cases.append((cur, 1))
    cur = prev.copy()
    cur[2] = np.nan
    cases.append((cur, 1))
    for k, (cur, valid) in enumerate(cases):
        v = np.array([valid], np.int32)
        got = tdl.reuse_dirty(torch.from_numpy(cur), torch.from_numpy(prev),
                              torch.from_numpy(v), tol, 16)
        want = jdl.reuse_dirty(jnp.asarray(cur), jnp.asarray(prev),
                               jnp.asarray(v), tol, 16)
        assert bool(got) == bool(want), (tol, k)


def _field(size=32):
    rng = np.random.default_rng(0)
    field = np.zeros((size, size, size), np.float32)
    field[4:12, 8:24, 8:24] = rng.random((8, 16, 16)).astype(np.float32)
    return field


def _cams(eye=(0.0, 0.4, 2.5)):
    return JCamera.create(eye), TCamera.create(eye, device=CPU)


def _scene():
    jc, tc = _cams()
    spacing = np.full((3,), 2.0 / 32, np.float32)
    origin = np.full((3,), -1.0, np.float32)
    jspec = jsl.make_spec(jc, (32,) * 3, JSlicer(scale=1.0),
                          multiple_of=2 * N)
    tspec = tsl.make_spec(tc, (32,) * 3, TSlicer(scale=1.0),
                          multiple_of=2 * N)
    assert (tspec.axis, tspec.ni, tspec.nj) == (jspec.axis, jspec.ni,
                                                jspec.nj)
    return dict(jc=jc, tc=tc, jspec=jspec, tspec=tspec, origin=origin,
                spacing=spacing, jmesh=jmesh.make_mesh(N),
                tmesh=tmesh.make_mesh(N, device=CPU),
                jtf=JTF.ramp(0.1, 0.9, 0.8, "hot"),
                ttf=TTF.ramp(0.1, 0.9, 0.8, "hot", device=CPU))


def _comp(side, schedule, reuse=True, **extra):
    kw = dict(schedule="waves", wave_tiles=2) if schedule == "waves" else {}
    kw.update(extra)
    if reuse:
        kw["temporal_reuse"] = "ranges"
    return (JComp if side == "j" else TComp)(max_output_supersegments=K,
                                             **kw)


def _vcfg(side):
    return (JVDI if side == "j" else TVDI)(max_supersegments=K,
                                           adaptive_mode="histogram")


def _jargs(s, field, cam=None):
    return (jpipe.shard_volume(jnp.asarray(field), s["jmesh"]),
            jnp.asarray(s["origin"]), jnp.asarray(s["spacing"]),
            cam if cam is not None else s["jc"])


def _targs(s, field, cam=None):
    return (tmesh.shard_volume(torch.from_numpy(field), s["tmesh"]),
            torch.from_numpy(s["origin"]), torch.from_numpy(s["spacing"]),
            cam if cam is not None else s["tc"])


def _jsteps(s, schedule, **kw):
    cc = _comp("j", schedule)
    return (jpipe.distributed_vdi_step_mxu(s["jmesh"], s["jtf"], s["jspec"],
                                           _vcfg("j"), cc, **kw),
            jpipe.distributed_initial_reuse_mxu(s["jmesh"], s["jtf"],
                                                s["jspec"], _vcfg("j"), cc))


def _tsteps(s, schedule, **kw):
    cc = _comp("t", schedule)
    return (tpipe.distributed_vdi_step_mxu(s["tmesh"], s["ttf"], s["tspec"],
                                           _vcfg("t"), cc, **kw),
            tpipe.distributed_initial_reuse_mxu(s["tmesh"], s["ttf"],
                                                s["tspec"], _vcfg("t"), cc))


def _assert_vdi(tv, jv):
    np.testing.assert_allclose(np_(tv.color), np.asarray(jv.color),
                               atol=ATOL, rtol=0)
    td, jd = np_(tv.depth), np.asarray(jv.depth)
    live = np.isfinite(jd)
    assert (np.isfinite(td) == live).all(), "VDI slot liveness"
    np.testing.assert_allclose(td[live], jd[live], atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module", params=SCHEDULES)
def reuse_runs(request, scene):
    """Per schedule: the reference's seed and two frames on the still
    scene, and the port's, with the port's reuse-off frame."""
    s, sched, field = scene, request.param, _field()
    jstep, jseed = _jsteps(s, sched)
    ru0 = jseed(*_jargs(s, field))
    (jv1, _), jru1 = jstep(*_jargs(s, field), ru0)
    (jv2, _), jru2 = jstep(*_jargs(s, field), jru1)
    tstep, tseed = _tsteps(s, sched)
    tr0 = tseed(*_targs(s, field))
    (tv1, tm1), tru1 = tstep(*_targs(s, field), tr0)
    (tv2, tm2), tru2 = tstep(*_targs(s, field), tru1)
    off = tpipe.distributed_vdi_step_mxu(
        s["tmesh"], s["ttf"], s["tspec"], _vcfg("t"),
        _comp("t", sched, reuse=False))(*_targs(s, field))
    return dict(sched=sched, j=(ru0, jv1, jru1, jv2, jru2),
                t=(tr0, tv1, tru1, tv2, tru2, tm1, tm2), off=off,
                tstep=tstep, args=_targs(s, field))


def test_reuse_seed_and_signatures_match_reference(reuse_runs):
    ru0, _, jru1, _, jru2 = reuse_runs["j"]
    tr0, _, tru1, _, tru2, _, _ = reuse_runs["t"]
    for got, want in ((tr0, ru0), (tru1, jru1), (tru2, jru2)):
        for name in ("sig", "valid", "dirty"):
            a, b = np_(getattr(got, name)), np.asarray(getattr(want, name))
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert tuple(got.color.shape) == tuple(np.shape(want.color))
    assert not np_(tr0.valid).any()
    # the carried fragments: the pre-exchange marches, at the bar
    np.testing.assert_allclose(np_(tru1.color), np.asarray(jru1.color),
                               atol=ATOL, rtol=0)


def test_reuse_frame2_skips_and_is_bitwise(reuse_runs):
    """Frame 1 marches every rank, frame 2 none; frame 2 equals frame 1
    and the reuse-off step bit for bit; both are at the reference's
    bar."""
    _, jv1, _, jv2, _ = reuse_runs["j"]
    _, tv1, tru1, tv2, tru2, tm1, tm2 = reuse_runs["t"]
    assert np_(tru1.dirty).all() and not np_(tru2.dirty).any()
    for a, b in ((tv2, tv1), (tv1, reuse_runs["off"][0])):
        np.testing.assert_array_equal(np_(a.color), np_(b.color))
        np.testing.assert_array_equal(np_(a.depth), np_(b.depth))
    for m, n in zip(tm1, tm2):
        np.testing.assert_array_equal(np_(m), np_(n))
    _assert_vdi(tv1, jv1)
    _assert_vdi(tv2, jv2)


def test_reference_carry_converts_and_steps(reuse_runs):
    """The reference's carry after frame 1, converted
    (`convert.reuse_state`), drives the port's step: no rank marches and
    the frame is at the bar of the reference's frame 2; a reference
    codec record converts (`convert.delta_record`) to one that packs to
    the same bytes."""
    _, _, jru1, jv2, _ = reuse_runs["j"]
    ru = convert.reuse_state(jru1, device=CPU)
    assert ru.valid.device.type == "cpu" and ru.dirty.dtype == torch.int32
    (v, _), ru2 = reuse_runs["tstep"](*reuse_runs["args"], ru)
    assert not np_(ru2.dirty).any()
    _assert_vdi(v, jv2)
    rng = np.random.default_rng(9)
    c, d = _codes(rng)
    enc = jdl.DeltaEncoder()
    enc.encode(3, c, d, 0.0, 1.0)
    c2 = c.copy()
    c2.ravel()[4] ^= 1
    rec = enc.encode(3, c2, d, 0.0, 1.0)
    got = convert.delta_record(rec)
    assert isinstance(got, tdl.DeltaRecord) and got.mode == "P"
    assert tio.pack_delta_blobs(got, codec="zlib") == \
        jio.pack_delta_blobs(rec, codec="zlib")


class _GenerateCounter:
    """Counts calls into the slicer's two generate functions."""

    def __init__(self, monkeypatch):
        self.calls = 0
        for name in ("generate_vdi_mxu", "generate_vdi_mxu_temporal"):
            fn = getattr(tsl, name)
            monkeypatch.setattr(tsl, name, self._wrap(fn))

    def _wrap(self, fn):
        def counted(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        return counted


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_clean_rank_calls_no_generate(scene, schedule, monkeypatch):
    """A clean rank marches nothing: a still frame calls no generate
    function; one rank pushed out of its cells calls it once (T times in
    waves)."""
    s, field = scene, _field()
    step, seed = _tsteps(s, schedule)
    (_, _), ru = step(*_targs(s, field), seed(*_targs(s, field)))
    counter = _GenerateCounter(monkeypatch)
    (_, _), ru = step(*_targs(s, field), ru)
    assert counter.calls == 0
    f2 = field.copy()
    f2[21, 16, 16] = 2.0                # rank 5's slab
    (_, _), ru = step(*_targs(s, f2), ru)
    assert np_(ru.dirty).tolist() == [0, 0, 0, 0, 0, 1, 0, 0]
    assert counter.calls == (2 if schedule == "waves" else 1)


@pytest.fixture(scope="module")
def pushed(scene):
    """The reference's dirty bits as one value a target rank is pushed
    above the global max, frame after frame."""
    s, field = scene, _field()
    jstep, jseed = _jsteps(s, "frame")
    (_, _), ru = jstep(*_jargs(s, field), jseed(*_jargs(s, field)))
    bits = []
    for z in (5, 21, 30):
        field = field.copy()
        field[z, 16, 16] = 2.0
        (_, _), ru = jstep(*_jargs(s, field), ru)
        bits.append(np.asarray(ru.dirty).copy())
    return bits


def test_reuse_dirty_exactly_the_owning_rank(scene, pushed):
    s, field = scene, _field()
    step, seed = _tsteps(s, "frame")
    off = tpipe.distributed_vdi_step_mxu(
        s["tmesh"], s["ttf"], s["tspec"], _vcfg("t"),
        _comp("t", "frame", reuse=False))
    (_, _), ru = step(*_targs(s, field), seed(*_targs(s, field)))
    for (z, rank), want in zip(((5, 1), (21, 5), (30, 7)), pushed):
        field = field.copy()
        field[z, 16, 16] = 2.0
        (v, _), ru = step(*_targs(s, field), ru)
        np.testing.assert_array_equal(np_(ru.dirty), want)
        assert np_(ru.dirty)[rank] == 1 and np_(ru.dirty).sum() == 1
        ref, _ = off(*_targs(s, field))
        np.testing.assert_array_equal(np_(v.color), np_(ref.color))
        np.testing.assert_array_equal(np_(v.depth), np_(ref.depth))


def test_reuse_camera_move_and_range_tol(scene):
    """A moved camera dirties every rank, as in the reference; under
    ``range_tol = 0.3`` a +0.2 drift stays clean and a further +0.2
    (0.4 from the marched frame) marches, in both packages."""
    s = scene
    field = _field()
    step, seed = _tsteps(s, "frame")
    (_, _), ru = step(*_targs(s, field), seed(*_targs(s, field)))
    jc2, tc2 = _cams((0.05, 0.4, 2.5))
    (_, _), ru2 = step(*_targs(s, field, tc2), ru)
    assert np_(ru2.dirty).all()

    f0 = field.copy()
    f0[20, 16, 16] = 1.2
    jstep, jseed = _jsteps(s, "frame", reuse_tol=0.3)
    tstep, tseed = _tsteps(s, "frame", reuse_tol=0.3)
    (_, _), jru = jstep(*_jargs(s, f0), jseed(*_jargs(s, f0)))
    (_, _), tru = tstep(*_targs(s, f0), tseed(*_targs(s, f0)))
    for bump, want in ((0.2, 0), (0.4, 1)):
        f2 = f0.copy()
        f2[20, 16, 16] = 1.2 + bump
        (_, _), jru = jstep(*_jargs(s, f2), jru)
        (_, _), tru = tstep(*_targs(s, f2), tru)
        np.testing.assert_array_equal(np_(tru.dirty), np.asarray(jru.dirty))
        np.testing.assert_array_equal(np_(tru.sig), np.asarray(jru.sig))
        assert np_(tru.dirty)[5] == want, bump


def test_reuse_with_bricks_ledgers_inert(scene):
    """A brick map carries no fragment: the step ledgers ``delta.reuse``
    (and, with the budget, ``occupancy.k_budget``) as the reference's
    step does, and takes no carry."""
    s = scene
    tobs.clear_ledger()
    bm = BrickMap(32, N, tuple((3 * i) % N for i in range(16)))
    cc = TComp(max_output_supersegments=K, temporal_reuse="ranges",
               rebalance="bricks", k_budget="occupancy")
    step = tpipe.distributed_vdi_step_mxu(s["tmesh"], s["ttf"], s["tspec"],
                                          _vcfg("t"), cc, bricks=bm)
    rows = {e["component"]: (e["from"], e["to"]) for e in tobs.ledger()}
    assert rows.get("delta.reuse") == ("ranges", "off")
    assert rows.get("occupancy.k_budget") == ("occupancy", "static")
    vdi, _ = step(*_targs(s, _field()))
    assert vdi.color.shape[0] == K


# ------------------------------------------------------------- session


class _FrozenSim:
    """A still volume sim: every frame after the first skips every
    rank."""

    kind = "frozen"

    def __init__(self, field):
        self._f = torch.from_numpy(field)

    def advance(self, n: int) -> None:
        pass

    @property
    def field(self):
        return self._f


def test_frozen_session_skips_and_is_bitwise(scene):
    """The 8-rank reuse session on a still scene: frames 1-3 equal frame
    0 bit for bit, ``delta_march_skipped`` counts at least two frames of
    all ranks, the last ``delta_dirty_tiles`` event skips every rank,
    and frame 0 is at the reference's bar."""
    s, field = scene, _field()
    over = ["composite.temporal_reuse=ranges",
            "composite.max_output_supersegments=6",
            "vdi.max_supersegments=6", "vdi.adaptive_mode=histogram",
            "slicer.engine=mxu", "slicer.scale=1.0", "obs.enabled=true",
            "sim.grid=[32,32,32]", f"mesh.num_devices={N}"]
    frames = {}
    sess = InSituSession(TFramework().with_overrides(*over),
                         sim=_FrozenSim(field), tf=s["ttf"], camera=s["tc"],
                         sinks=[lambda i, p: frames.update(
                             {i: (p["vdi_color"], p["vdi_depth"])})],
                         device=CPU)
    sess.run(4)
    assert sorted(frames) == [0, 1, 2, 3]
    for i in (1, 2, 3):
        np.testing.assert_array_equal(frames[i][0], frames[0][0])
        np.testing.assert_array_equal(frames[i][1], frames[0][1])
    assert sess.obs.counters.get("delta_march_skipped", 0) >= 2 * N
    assert sess.obs.counters.get("reuse_steps_built", 0) >= 1
    evs = [e for e in sess.obs.events if e.get("name") == "delta_dirty_tiles"]
    assert evs and evs[-1]["attrs"]["skipped_tiles"] == N
    assert evs[-1]["attrs"]["dirty"] == [0] * N
    # frame 0 against the reference's hand-driven step at the same
    # placement (the session centres the grid at the origin)
    jstep, jseed = _jsteps(s, "frame")
    (jv, _), _ = jstep(*_jargs(s, field), jseed(*_jargs(s, field)))
    _assert_vdi(type(jv)(frames[0][0], frames[0][1]), jv)


def test_replanning_session_reseeds_reuse():
    """``rebalance=occupancy`` every 2 frames with reuse, histogram
    thresholds, on 8 ranks over a moving, brightening field: a new plan (another band
    depth, so another signature length) rebuilds the steps and re-seeds
    the carry, as the reference's session does, and every frame equals
    the same session's without reuse bit for bit. (A replan drops the
    carry before the next frame reads its decision, so
    ``delta_march_skipped`` counts no skip made just before one.)"""
    from tests.test_torch_rebalance import MovingSim, session_overrides

    class BrighteningSim(MovingSim):
        """`MovingSim` whose band also brightens a step, so every cell it
        touches moves its range: a band moving inside one cell at one
        value keeps the cell's [lo, hi], which a range signature cannot
        see (the detector's contract, the reference's too)."""

        def _make(self):
            f = super()._make()
            return torch.where(f == 0.6, 0.5 + 0.01 * self._t, f)

    runs = {}
    for reuse in ("ranges", "off"):
        got = {}
        sess = InSituSession(
            TFramework().with_overrides(*session_overrides(**{
                "composite.rebalance": "occupancy",
                "composite.rebalance_period": "2",
                "composite.rebalance_quantum": "1",
                "composite.rebalance_min_depth": "1",
                "composite.rebalance_hysteresis": "0.05",
                "vdi.adaptive_mode": "histogram",
                "composite.temporal_reuse": reuse})),
            sim=BrighteningSim(torch.from_numpy),
            sinks=[lambda i, p, got=got: got.__setitem__(i, p)], device=CPU)
        sess.run(6)
        runs[reuse] = (got, dict(sess.obs.counters),
                       list(sess._mxu_reuse.values()))
    (on, cnt, carries), (off, _, _) = runs["ranges"], runs["off"]
    assert cnt["rebalance_replans"] >= 2
    assert cnt["build_steps"] == 1 + cnt["rebalance_replans"]
    assert cnt["reuse_steps_built"] == cnt["compile_step"] >= 2
    # the last frame (after the last replan's re-seed) skipped some ranks
    assert len(carries) == 1 and (np_(carries[0].dirty) == 0).any()
    for i in range(6):
        for key in ("vdi_color", "vdi_depth"):
            np.testing.assert_array_equal(on[i][key], off[i][key])

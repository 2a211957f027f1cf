"""Parity of the port's brick render partitions (``CompositeConfig.
rebalance == "bricks"``) with the JAX package's, on the CPU.

``BrickMap`` (tables, levels, slots, ``permute``, ``even``,
``contiguous``, validation), ``auto_nbricks``, ``brick_work``,
``rank_work``, ``straggler_factor`` and ``steal_plan`` (its
deterministic ties and its object-equal return when nothing moves) give
the reference's values exactly. ``reslab_bricks`` equals the reference's
under ``shard_map``, absent slots zero, with the reference's messages.
The 8-rank distributed mxu step under the reference tests' maps (one
brick a rank ``OWNER``, its relabelling ``PERM``, two interleaved bricks
a rank, and islands with an empty rank), in both march regimes, and the
temporal step (seed and 2 frames, a map set a slot), match the
reference's same steps at the ``xla`` fold bar and the port's even step
at the reference's 1e-5 gate; bricks cross the tile waves and the ring.
The even-convex map short-circuits unbuilt; a map without its mode or
for another rank count raises the reference's message. The session
steals bricks as the reference's does (the same owners and frames) and
rejects a non-dividing ``rebalance_bricks`` at build."""

import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.parallel import bricks as jbk
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.runtime import session as jses
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.parallel import bricks as tbk
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.runtime import session as tses
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401
from tests.test_torch_rebalance import (CPU, D, EYES, GATE, N, REGIMES,
                                        MovingSim, assert_frames_close,
                                        assert_meta_global,
                                        assert_sessions_match, jax_sharded,
                                        live_slots, memo_runs, port_slabs,
                                        run_jax, run_port, run_sessions,
                                        scene_data, session_overrides)

# the reference tests' maps (tests/test_bricks.py)
OWNER = (3, 0, 5, 1, 4, 7, 2, 6)
PERM = (2, 0, 3, 1, 5, 7, 4, 6)
INTERLEAVED = tuple(list(range(N)) + list(range(N)))
ISLANDS = (0, 0, 1, 2, 3, 4, 5, 6)
MAPS = {"owner": OWNER, "perm": tuple(PERM[o] for o in OWNER),
        "interleaved": INTERLEAVED, "islands": ISLANDS}
# the port runs several tests of this file repeat, each run once
port_run = memo_runs(run_port)


def maps(owner, level=()):
    return (jbk.BrickMap(D, N, owner, level),
            tbk.BrickMap(D, N, owner, level))


# ---------------------------------------------------------------- units


def _table_view(bm):
    return dict(nbricks=bm.nbricks, brick_depth=bm.brick_depth,
                slots=bm.slots, total_slots=bm.total_slots,
                max_level=bm.max_level, levels=bm.levels_present(),
                ranks=[bm.rank_bricks(r) for r in range(bm.n_ranks)],
                intervals=[bm.intervals(r) for r in range(bm.n_ranks)],
                table=bm.start_table().tolist(),
                tables={lv: bm.start_table_at(lv).tolist()
                        for lv in bm.levels_present()},
                even_convex=bm.is_even_convex(), level=bm.level,
                owner=bm.owner)


@pytest.mark.parametrize("owner,level", [
    (OWNER, ()), (INTERLEAVED, ()), (ISLANDS, ()),
    (ISLANDS, (0, 0, 0, 0, 0, 0, 2, 0)), (tuple(range(N)), (1,) * N),
    ((0,) * 4 + (1,) * 4, (2, 0, 1, 0, 0, 0, 0, 2))])
def test_brickmap_tables_match_reference(owner, level):
    n = max(owner) + 1 if len(owner) != N else N
    j = jbk.BrickMap(D, max(n, 2), owner, level)
    t = tbk.BrickMap(D, max(n, 2), owner, level)
    assert _table_view(t) == _table_view(j)
    perm = list(range(j.n_ranks))[::-1]
    assert _table_view(t.permute(perm)) == _table_view(j.permute(perm))
    assert t.with_levels((0,) * t.nbricks).level == (0,) * t.nbricks


def test_brickmap_constructors_and_validation_match_reference():
    for args in ((D, N), (D, N, 16)):
        assert _table_view(tbk.BrickMap.even(*args)) == \
            _table_view(jbk.BrickMap.even(*args))
    for d, n, nb in ((D, N, 16), (30 * N, N, 30), (512, 8, 32), (24, 4, 6)):
        assert _table_view(tbk.BrickMap.contiguous(d, n, nb)) == \
            _table_view(jbk.BrickMap.contiguous(d, n, nb))
    bad = [lambda m: m.BrickMap(30, 4, (0, 1, 2, 3, 0, 1, 2)),
           lambda m: m.BrickMap(32, 4, (0, 1, 2, 4)),
           lambda m: m.BrickMap(32, 4, (0, 1, 2, 3)).permute([0, 0, 1, 2]),
           lambda m: m.BrickMap.even(32, 3, nbricks=4),
           lambda m: m.BrickMap(32, 4, ()),
           lambda m: m.BrickMap(32, 4, (0, 1), (0,)),
           lambda m: m.BrickMap(32, 4, (0, 1), (0, -1)),
           lambda m: m.BrickMap(32, 4, (0, 1), (0, 5))]
    for fn in bad:
        with pytest.raises(ValueError) as a:
            fn(jbk)
        with pytest.raises(ValueError) as b:
            fn(tbk)
        assert str(a.value) == str(b.value)


def test_brick_work_and_auto_nbricks_match_reference():
    for d, n in [(96, 8), (100, 8), (32, 8), (512, 8), (7, 2)]:
        for target in (4, 2):
            assert tbk.auto_nbricks(d, n, target) == \
                jbk.auto_nbricks(d, n, target)
    rng = np.random.default_rng(2)
    for prof, nb, base in ((rng.random(16), 16, None), (rng.random(8), 32,
                                                        0.0),
                           (np.eye(1, 32, 3)[0], 8, 0.1)):
        np.testing.assert_array_equal(tbk.brick_work(prof, D, nb, base),
                                      jbk.brick_work(prof, D, nb, base))
        work = tbk.brick_work(prof, D, nb, base)
        j, t = (m.BrickMap.contiguous(D, N, nb) for m in (jbk, tbk))
        np.testing.assert_array_equal(tbk.rank_work(t, work),
                                      jbk.rank_work(j, work))
        assert tbk.straggler_factor(t, work) == \
            jbk.straggler_factor(j, work)
    with pytest.raises(ValueError) as a:
        jbk.brick_work(np.ones(4), 30, 8)
    with pytest.raises(ValueError) as b:
        tbk.brick_work(np.ones(4), 30, 8)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("seed", range(6))
def test_steal_plan_matches_reference(seed):
    """Steal sequences from seeded and skewed profiles, ties included
    (equal works), with levels riding their bricks; a converged or
    balanced map comes back as the same object."""
    rng = np.random.default_rng(seed)
    nb = [16, 8, 32][seed % 3]
    work = (np.round(rng.random(nb) * 4) if seed % 2
            else tbk.brick_work(np.where(np.arange(16) < 4, 1.0, 0.0), D,
                                nb))
    level = tuple(int(x) for x in rng.integers(0, 2, nb)) \
        if seed >= 3 and nb <= 16 \
        else ()
    j = jbk.BrickMap.contiguous(D, N, nb)
    t = tbk.BrickMap.contiguous(D, N, nb)
    if level:
        j, t = j.with_levels(level), t.with_levels(level)
    for moves, hyst in ((2, 0.1), (1, 0.0), (3, 0.25)) * 3:
        j2 = jbk.steal_plan(j, work, max_moves=moves, hysteresis=hyst)
        t2 = tbk.steal_plan(t, work, max_moves=moves, hysteresis=hyst)
        assert (t2.owner, t2.level) == (j2.owner, j2.level)
        assert (t2 is t) == (j2 is j)
        j, t = j2, t2
    balanced = tbk.BrickMap.even(D, N, 16)
    assert tbk.steal_plan(balanced, np.ones(16), hysteresis=0.1) is balanced
    with pytest.raises(ValueError) as a:
        jbk.steal_plan(jbk.BrickMap.even(D, N), np.ones(3))
    with pytest.raises(ValueError) as b:
        tbk.steal_plan(tbk.BrickMap.even(D, N), np.ones(3))
    assert str(a.value) == str(b.value)


# ---------------------------------------------------------- reslab_bricks


@pytest.mark.parametrize("owner", [ISLANDS, INTERLEAVED])
@pytest.mark.parametrize("h", [0, 1])
def test_reslab_bricks_matches_reference(owner, h):
    data = np.random.default_rng(3).random((D, 4, 6)).astype(np.float32)
    jm, tm = maps(owner)
    want = jax_sharded(lambda x: jmesh.reslab_bricks(x, jm, "ranks", h=h),
                       data, out_dims=4)
    got = tmesh.reslab_bricks(port_slabs(data), tm, h=h)
    np.testing.assert_array_equal(np_(got), want.reshape(np_(got).shape))
    table = tm.start_table()
    for r, s in zip(*np.nonzero(table < 0)):
        assert (np_(got)[r, s] == 0).all()


def test_reslab_bricks_errors_match_reference():
    data = np.zeros((D, 4, 4), np.float32)
    for owner, depth, n in (((0, 1, 2, 3), D, 4),
                            (tuple(range(N)), 2 * D, N)):
        jm = jbk.BrickMap(depth, n, owner)
        with pytest.raises(ValueError) as a:
            jax_sharded(lambda x: jmesh.reslab_bricks(x, jm, "ranks"), data,
                        out_dims=4)
        with pytest.raises(ValueError) as b:
            tmesh.reslab_bricks(port_slabs(data),
                                tbk.BrickMap(depth, n, owner))
        assert str(a.value) == str(b.value)


# ------------------------------------------------------- distributed steps


@pytest.fixture(scope="module", params=range(len(EYES)), ids=REGIMES)
def brick_steps(request):
    """Per march regime: the reference's step under every map."""
    eye = EYES[request.param]
    out = {name: run_jax(eye, "bricks", bricks=maps(owner)[0])
           for name, owner in MAPS.items()}
    out["eye"] = eye
    return out


def test_brick_steps_match_reference_and_even(brick_steps):
    eye = brick_steps["eye"]
    even = port_run(eye)
    for name, owner in MAPS.items():
        got = run_port(eye, "bricks", bricks=maps(owner)[1])
        assert_frames_close(got, brick_steps[name])
        assert_frames_close(got, even, rtol=0.0, atol=GATE)
        assert_meta_global(got, brick_steps[name][0][3])
    assert live_slots(even) > 0


@pytest.mark.parametrize("owner", [OWNER, INTERLEAVED],
                         ids=["owner", "interleaved"])
def test_brick_temporal_step_matches_reference_and_even(owner):
    """A map set a slot, row-stacked (``[n*slots*nj, ni]``): the seed
    and 2 frames against the reference's, and the frames against the
    even step's (the z march, as the reference holds it)."""
    noisy = scene_data("noisy")
    jm, tm = maps(owner)
    want = run_jax(EYES[0], "bricks", temporal=True, data=noisy, bricks=jm)
    got = run_port(EYES[0], "bricks", temporal=True, data=noisy, bricks=tm)
    nj = got[0][0].shape[-2]
    assert got[0][2][0].shape[0] == N * tm.slots * nj
    assert_frames_close(got, want)
    assert_frames_close(got, port_run(EYES[0], temporal=True, data=noisy),
                        rtol=0.0, atol=GATE, thr_atol=None)


@pytest.mark.parametrize("comp", [
    dict(schedule="waves", wave_tiles=2), dict(exchange="ring"),
    dict(exchange="ring", schedule="waves", wave_tiles=2)],
    ids=["waves", "ring", "ring_waves"])
@pytest.mark.parametrize("owner", [OWNER, ISLANDS], ids=["owner", "islands"])
def test_brick_schedules_cross_match_frame(comp, owner):
    """Bricks x the exchange schedules: the tile waves and the ring
    reproduce the brick frame schedule's all_to_all output (the
    temporal carry through the waves too)."""
    bm = maps(owner)[1]
    base = port_run(EYES[0], "bricks", temporal=True, bricks=bm)
    got = run_port(EYES[0], "bricks", temporal=True, comp=comp, bricks=bm)
    assert_frames_close(got, base, rtol=0.0, atol=GATE)


def test_brick_resolution_counts_and_messages():
    """The even-convex map and one rank short-circuit unbuilt; a map
    counts one build a step with the reference's event; a map without
    its mode or for another rank count raises the reference's
    message."""
    from scenery_insitu_tpu.parallel import pipeline as jpipe

    rec = tobs.Recorder(enabled=True)
    prev = tobs.set_recorder(rec)
    try:
        cc = tcfg.CompositeConfig(rebalance="bricks")
        assert tpipe._resolve_bricks(cc, N, tbk.BrickMap.even(D, N)) is None
        assert tpipe._resolve_bricks(cc, N,
                                     tbk.BrickMap.even(D, N, 16)) is None
        assert tpipe._resolve_bricks(cc, 1, tbk.BrickMap(D, 1, (0,))) is None
        assert rec.counters.get("bricks_steps_built", 0) == 0
        run_port(EYES[0], "bricks", bricks=maps(ISLANDS)[1])
    finally:
        tobs.set_recorder(prev)
    assert rec.counters["bricks_steps_built"] == 1
    ev = [e["attrs"] for e in rec.events if e.get("name") == "bricks_build"]
    assert ev[0]["owner"] == list(ISLANDS) and ev[0]["slots"] == 2
    assert ev[0]["bricks_per_rank"][7] == 0 and ev[0]["total_slots"] == 2
    jm, tm = maps(OWNER)
    for cfg, n, m in (("even", N, (jm, tm)), ("bricks", 4, (jm, tm)),
                      ("bricks", N, ((0, 1), (0, 1)))):
        errors = []
        for pipe, pkg, bm in ((jpipe, jcfg, m[0]), (tpipe, tcfg, m[1])):
            with pytest.raises((ValueError, TypeError)) as e:
                pipe._resolve_bricks(pkg.CompositeConfig(rebalance=cfg), n,
                                     bm)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


# ------------------------------------------------------------ the session


def test_session_steals_bricks_as_reference():
    """``rebalance=bricks`` every 2 frames on 4 ranks, 8 bricks: the same
    owners adopted at the same frames, the same rebuilds and frames."""
    frames = 4
    out = run_sessions(frames, n=4, **{
        "composite.rebalance": "bricks", "composite.rebalance_period": "2",
        "composite.rebalance_bricks": "8",
        "composite.rebalance_hysteresis": "0.05"})
    assert_sessions_match(out, frames)
    ev = out["port"][1]
    assert ev and all(e["kind"] == "bricks" for e in ev)
    sess = out["port"][3]
    assert sess.obs.counters["bricks_steps_built"] >= 1
    js = out["jax"][3]
    assert (None if sess._bricks is None else sess._bricks.owner) == \
        (None if js._bricks is None else js._bricks.owner)


def test_session_rejects_non_dividing_brick_count():
    over = session_overrides(**{"composite.rebalance": "bricks",
                                "composite.rebalance_bricks": "10"})
    with pytest.raises(ValueError) as a:
        jses.InSituSession(jcfg.FrameworkConfig().with_overrides(*over),
                           sim=MovingSim(lambda f: f))
    with pytest.raises(ValueError) as b:
        tses.InSituSession(tcfg.FrameworkConfig().with_overrides(*over),
                           sim=MovingSim(torch.from_numpy), device=CPU)
    assert str(a.value) == str(b.value)
    assert "composite.rebalance_bricks=10" in str(b.value)

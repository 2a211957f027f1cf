"""Parity of the port's occupancy K budgets with the JAX package's, on
the CPU.

``ops/occupancy.k_budget_target`` is held exactly (f32) against the
reference's over a grid of inputs; the tensor-target threshold
controller (``update_threshold``, ``pick_threshold``) exactly against
the int target and the reference's. On the reference tests' 4-rank 16^3
fields (``tests/test_occupancy.py``) and a graded field whose last rank
gets a fractional target: the per-rank targets (the live fractions
summed over the ranks) against the reference's own frame state's at
1e-6, the budgeted VDIs and threshold maps in histogram and temporal
mode, on the frame schedule and in tile waves, at ``ATOL``; on the
uniform field every target is K and the budgeted step equals the static
one bit for bit. A fixed threshold and
a brick map ledger the knob inert. A 2 x 2 two-level mesh runs the
budget and fragment reuse together against the reference's. Reference
runs are shared through module-scoped fixtures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core.camera import Camera as JCamera
from scenery_insitu_tpu.core.transfer import TransferFunction as JTF
from scenery_insitu_tpu.core.volume import Volume as JVolume
from scenery_insitu_tpu.ops import occupancy as jocc
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.ops import supersegments as jss
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu.parallel import topology as jtopo
from scenery_insitu_tpu.utils.compat import shard_map
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core.camera import Camera as TCamera
from scenery_insitu_tpu_torch.core.transfer import TransferFunction as TTF
from scenery_insitu_tpu_torch.core.volume import Volume as TVolume
from scenery_insitu_tpu_torch.ops import occupancy as tocc
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.ops import supersegments as tss
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.parallel import topology as ttopo
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401

CPU = "cpu"
N = 4
K, K_OUT, K_MIN = 4, 6, 2
ATOL = 1e-5
EYE = (0.0, 0.2, 3.0)


# ------------------------------------------------------------ the pieces


def test_k_budget_target_matches_reference():
    """A grid of live fractions, totals, rank counts, K and floors, the
    reference's unit cases among them, exact to f32."""
    rng = np.random.default_rng(0)
    cases = [(0.5, 1.0, 4, 16, 4), (0.05, 1.0, 4, 16, 4),
             (0.25, 1.0, 4, 16, 4), (0.1, 0.8, 4, 16, 2),
             (0.0, 0.0, 4, 16, 4), (0.3, 1e-10, 8, 6, 2),
             (0.2, 0.2, 1, 16, 4), (0.7, 1.3, 2, 3, 8)]
    for _ in range(24):
        n = int(rng.integers(1, 9))
        live = np.float32(rng.random())
        total = np.float32(live + rng.random() * (n - 1))
        cases.append((live, total, n, int(rng.integers(1, 20)),
                      int(rng.integers(1, 8))))
    for live, total, n, k, k_min in cases:
        want = np.asarray(jocc.k_budget_target(np.float32(live),
                                               np.float32(total), n, k,
                                               k_min))
        got = tocc.k_budget_target(torch.tensor(np.float32(live)),
                                   torch.tensor(np.float32(total)), n, k,
                                   k_min)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert np_(got) == want, (live, total, n, k, k_min)
    assert float(tocc.k_budget_target(0.5, 1.0, 4, 16, 4)) == 16.0


@pytest.mark.parametrize("target", [8, 5.5, 3.2])
def test_tensor_target_controller_matches_reference(target):
    """``update_threshold`` and ``pick_threshold`` with an f32 0-dim
    target equal the reference's exactly; an integral target equals the
    int path bit for bit."""
    rng = np.random.default_rng(1)
    thr = rng.uniform(0.01, 1.5, (6, 7)).astype(np.float32)
    lo = (thr * rng.uniform(0.2, 1.2, thr.shape)).astype(np.float32)
    hi = (thr * rng.uniform(0.8, 2.0, thr.shape)).astype(np.float32)
    count = rng.integers(0, 12, thr.shape).astype(np.int32)
    counts = np.sort(rng.integers(0, 12, (9, 6, 7)), axis=0)[::-1]
    counts = np.ascontiguousarray(counts).astype(np.int32)
    tvec = np.asarray(jss.threshold_candidates(9))
    kt = np.float32(target)
    tstate = tss.ThresholdState(*(torch.from_numpy(x) for x in (thr, lo,
                                                                 hi)))
    jstate = jss.ThresholdState(*(jnp.asarray(x) for x in (thr, lo, hi)))
    got = tss.update_threshold(tstate, torch.from_numpy(count),
                               torch.tensor(kt))
    want = jss.update_threshold(jstate, jnp.asarray(count), jnp.float32(kt))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    tvec = tvec.copy()
    pick = tss.pick_threshold(torch.from_numpy(counts),
                              torch.from_numpy(tvec), torch.tensor(kt))
    np.testing.assert_array_equal(np_(pick), np.asarray(jss.pick_threshold(
        jnp.asarray(counts), jnp.asarray(tvec), jnp.float32(kt))))
    if float(target).is_integer():
        ints = tss.update_threshold(tstate, torch.from_numpy(count),
                                    int(target))
        for a, b in zip(got, ints):
            np.testing.assert_array_equal(np_(a), np_(b))
        np.testing.assert_array_equal(np_(pick), np_(tss.pick_threshold(
            torch.from_numpy(counts), torch.from_numpy(tvec), int(target))))


# ------------------------------------------------- the distributed step


def _field(kind):
    """The reference tests' uniform and sparse fields, and a graded one:
    seeded noise on ranks 0-2 and in the first 4 rows of rank 3's slab,
    whose live fractions (1, 1, 1, 1/2 under 4 in-plane tiles with their
    one-row aprons) give rank 3 a fractional target between ``K_MIN``
    and K, below the segments its noise needs."""
    if kind == "uniform":
        rng = np.random.RandomState(0)
        return rng.uniform(0.4, 0.8, (16, 16, 16)).astype(np.float32)
    data = np.zeros((16, 16, 16), np.float32)
    if kind == "sparse":
        data[0:4] = 0.7                      # all content on rank 0
        return data
    rng = np.random.default_rng(2)
    data[0:12] = rng.uniform(0.05, 0.9, (12, 16, 16)).astype(np.float32)
    data[12:16, 0:4] = rng.uniform(0.05, 0.9, (4, 4, 16)).astype(np.float32)
    return data


def _setup(vtiles=0):
    jc = JCamera.create(EYE, fov_y_deg=45.0)
    tc = TCamera.create(EYE, fov_y_deg=45.0, device=CPU)
    jspec = jsl.make_spec(jc, (16,) * 3, jcfg.SliceMarchConfig(
        matmul_dtype="f32", scale=1.0, occupancy_vtiles=vtiles),
        multiple_of=N)
    tspec = tsl.make_spec(tc, (16,) * 3, tcfg.SliceMarchConfig(
        scale=1.0, occupancy_vtiles=vtiles), multiple_of=N)
    return dict(jc=jc, tc=tc, jspec=jspec, tspec=tspec,
                jmesh=jmesh.make_mesh(N), tmesh=tmesh.make_mesh(N, device=CPU),
                jtf=JTF.ramp(0.05, 0.8, 0.7),
                ttf=TTF.ramp(0.05, 0.8, 0.7, device=CPU))


def _cfgs(mod, mode, budget="occupancy", **comp):
    vcfg = mod.VDIConfig(max_supersegments=K, adaptive_iters=2,
                         adaptive_mode=mode)
    ccfg = mod.CompositeConfig(max_output_supersegments=K_OUT,
                               adaptive_iters=2, k_budget=budget,
                               k_budget_min=K_MIN, **comp)
    return vcfg, ccfg


def _args(s, side, data, cam=None):
    if side == "j":
        vol = JVolume.centered(jnp.asarray(data), extent=2.0)
        return (jpipe.shard_volume(vol.data, s["jmesh"]), vol.origin,
                vol.spacing, cam or s["jc"])
    vol = TVolume.centered(torch.from_numpy(data), extent=2.0)
    return (tmesh.shard_volume(vol.data, s["tmesh"]), vol.origin,
            vol.spacing, cam or s["tc"])


def _drive(side, s, data, mode, frames=2, budget="occupancy", **comp):
    """The seed and ``frames`` frames of one package's step; returns
    [(vdi, thr)] a frame."""
    mod, pipe = (jcfg, jpipe) if side == "j" else (tcfg, tpipe)
    mesh, tf, spec = (s["jmesh"], s["jtf"], s["jspec"]) if side == "j" \
        else (s["tmesh"], s["ttf"], s["tspec"])
    vcfg, ccfg = _cfgs(mod, mode, budget, **comp)
    args = _args(s, side, data)
    if mode == "temporal":
        thr = pipe.distributed_initial_threshold_mxu(mesh, tf, spec,
                                                     vcfg)(*args)
        step = pipe.distributed_vdi_step_mxu_temporal(mesh, tf, spec, vcfg,
                                                      ccfg)
        out = []
        for _ in range(frames):
            (vdi, _), thr = step(*args, thr)
            out.append((vdi, thr.thr))
        return out
    step = pipe.distributed_vdi_step_mxu(mesh, tf, spec, vcfg, ccfg)
    return [(step(*args)[0], None)]


def _assert_frames(got, want):
    for (tv, tt), (jv, jt) in zip(got, want):
        np.testing.assert_allclose(np_(tv.color), np.asarray(jv.color),
                                   atol=ATOL, rtol=0)
        td, jd = np_(tv.depth), np.asarray(jv.depth)
        live = np.isfinite(jd)
        assert (np.isfinite(td) == live).all(), "VDI slot liveness"
        np.testing.assert_allclose(td[live], jd[live], atol=ATOL, rtol=0)
        if jt is not None:
            np.testing.assert_allclose(np_(tt), np.asarray(jt), atol=ATOL,
                                       rtol=0)


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def graded_setup():
    return _setup(vtiles=4)


def _reference_targets(s, data):
    """The reference's own per-rank targets: its frame state under
    ``shard_map``, the live fractions summed by ``psum``."""
    vcfg, ccfg = _cfgs(jcfg, "temporal")
    axis, n, _ = jtopo.resolve_mesh_topology(s["jmesh"])

    def f(local, origin, spacing):
        kt = jpipe._rank_frame_state(local, origin, spacing, s["jspec"],
                                     s["jtf"], vcfg, axis, n, ccfg)[-1]
        return jnp.reshape(kt, (1,))

    if "jtargets" not in s:                 # one compile a setup
        s["jtargets"] = jax.jit(shard_map(
            f, mesh=s["jmesh"], in_specs=(P(axis, None, None), P(), P()),
            out_specs=P(axis), check_vma=False))
    return np.asarray(s["jtargets"](*_args(s, "j", data)[:3]))


def _port_targets(s, data):
    vcfg, ccfg = _cfgs(tcfg, "temporal")
    slabs, origin, spacing, cam = _args(s, "t", data)
    rows = tpipe._frame_rows(slabs, s["tspec"])
    frames = [tpipe._RankFrame(slabs, rows, r, origin, spacing, cam,
                               s["tspec"], s["ttf"], pyramid=True)
              for r in range(N)]
    return np.array([float(x) for x in tpipe._k_targets(frames, N, vcfg,
                                                        ccfg)], np.float32)


@pytest.mark.parametrize("kind", ["sparse", "uniform", "graded"])
def test_rank_targets_match_reference(setup, graded_setup, kind):
    s = graded_setup if kind == "graded" else setup
    got, want = _port_targets(s, _field(kind)), \
        _reference_targets(s, _field(kind))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if kind == "uniform":
        assert (got == K).all()
    elif kind == "sparse":
        assert got[0] == K and (got[1:] == K_MIN).all()
    else:
        assert (got[:3] == K).all() and K_MIN < got[3] < K


@pytest.fixture(scope="module", params=[("histogram", "frame", "sparse"),
                                        ("histogram", "frame", "graded"),
                                        ("temporal", "frame", "graded"),
                                        ("temporal", "waves", "graded")],
                ids=["histogram_sparse", "histogram", "temporal",
                     "temporal_waves"])
def budget_runs(request, setup, graded_setup):
    mode, sched, kind = request.param
    s = graded_setup if kind == "graded" else setup
    comp = dict(schedule="waves", wave_tiles=2) if sched == "waves" else {}
    data = _field(kind)
    return (kind, _drive("j", s, data, mode, **comp),
            _drive("t", s, data, mode, **comp),
            _drive("t", s, data, mode, budget="static", **comp))


def test_budgeted_step_matches_reference(budget_runs):
    """Budgeted VDIs and threshold maps at the reference's bar; on the
    graded field the budget changes the port's frame."""
    kind, want, got, static = budget_runs
    _assert_frames(got, want)
    if kind == "graded":
        (gv, gt), (sv, st) = got[-1], static[-1]
        changed = not torch.equal(gv.depth, sv.depth) or (
            gt is not None and not torch.equal(gt, st))
        assert changed, "the budget left the graded frame unchanged"


def test_uniform_budget_equals_static(setup):
    """On the uniform field every target is K: the budgeted temporal
    step equals the static one bit for bit (the reference holds them at
    rtol 1e-6), and it is at the reference's bar."""
    data = _field("uniform")
    got = _drive("t", setup, data, "temporal")
    static = _drive("t", setup, data, "temporal", budget="static")
    for (gv, gt), (sv, st) in zip(got, static):
        assert torch.equal(gv.color, sv.color)
        assert torch.equal(gv.depth, sv.depth)
        assert torch.equal(gt, st)
    _assert_frames(got, _drive("j", setup, data, "temporal"))


def test_budget_build_counters_and_inert_ledger(setup):
    """A budgeted build counts ``occupancy_kbudget_builds`` with its
    event; a fixed threshold ledgers ``occupancy.k_budget`` inert, as
    the reference's frame state does."""
    s = setup
    rec = tobs.Recorder(enabled=True)
    prev = tobs.set_recorder(rec)
    tobs.clear_ledger()
    try:
        vcfg, ccfg = _cfgs(tcfg, "histogram")
        tpipe.distributed_vdi_step_mxu(s["tmesh"], s["ttf"], s["tspec"],
                                       vcfg, ccfg)
        fixed = tcfg.VDIConfig(max_supersegments=K, adaptive=False)
        step = tpipe.distributed_vdi_step_mxu(s["tmesh"], s["ttf"],
                                              s["tspec"], fixed, ccfg)
        vdi, _ = step(*_args(s, "t", _field("sparse")))
    finally:
        tobs.set_recorder(prev)
    assert rec.counters.get("occupancy_kbudget_builds") == 1
    ev = [e for e in rec.events if e.get("name") == "occupancy_kbudget_build"]
    assert ev and ev[0]["attrs"] == dict(ranks=N, k=K, k_min=K_MIN)
    rows = [e for e in tobs.ledger()
            if e["component"] == "occupancy.k_budget"]
    assert rows and (rows[0]["from"], rows[0]["to"]) == ("occupancy",
                                                         "static")
    assert vdi.color.shape[0] == K_OUT


# ---------------------------------------------- the two-level mesh


def test_two_level_budget_and_reuse_match_reference(graded_setup):
    """A 2 x 2 ``(hosts, ranks)`` mesh with the K budget and fragment
    reuse on, temporal thresholds: two frames of the graded field
    against the reference's at the bar, the dirty bits and signatures
    exactly, the second frame skipping every rank."""
    s = graded_setup
    data = _field("graded")
    outs = {}
    for side in ("j", "t"):
        mod, pipe, topo_mod = (jcfg, jpipe, jtopo) if side == "j" \
            else (tcfg, tpipe, ttopo)
        tc = mod.TopologyConfig(num_hosts=2)
        if side == "j":
            mesh, _ = topo_mod.make_topology_mesh(tc, mod.MeshConfig(
                num_devices=N))
            tf, spec = s["jtf"], s["jspec"]
        else:
            mesh, _ = topo_mod.make_topology_mesh(tc, mod.MeshConfig(
                num_devices=N), device=CPU)
            tf, spec = s["ttf"], s["tspec"]
        vcfg, ccfg = _cfgs(mod, "temporal", temporal_reuse="ranges")
        args = _args(dict(s, jmesh=mesh, tmesh=mesh), side, data)
        thr = pipe.distributed_initial_threshold_mxu(mesh, tf, spec,
                                                     vcfg)(*args)
        ru = pipe.distributed_initial_reuse_mxu(mesh, tf, spec, vcfg,
                                                ccfg)(*args)
        step = pipe.distributed_vdi_step_mxu_temporal(mesh, tf, spec, vcfg,
                                                      ccfg, topology=tc)
        frames = []
        for _ in range(2):
            (vdi, _), thr, ru = step(*args, thr, ru)
            frames.append(((vdi, thr.thr), np_(ru.dirty), np_(ru.sig)))
        outs[side] = frames
    _assert_frames([f[0] for f in outs["t"]], [f[0] for f in outs["j"]])
    for (_, td, ts), (_, jd, js) in zip(outs["t"], outs["j"]):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ts, js)
    assert outs["t"][0][1].all() and not outs["t"][1][1].any()


def test_plan_budget_and_reuse_match_reference(graded_setup):
    """A render plan (``rebalance="occupancy"``) with the K budget and
    fragment reuse on, temporal thresholds: the budget reads each
    rank's planned band; two frames against the reference's at the bar,
    the dirty bits and signatures exactly."""
    s = graded_setup
    data = _field("graded")
    plan = (6, 2, 4, 4)
    outs = {}
    for side in ("j", "t"):
        mod, pipe = (jcfg, jpipe) if side == "j" else (tcfg, tpipe)
        mesh, tf, spec = (s["jmesh"], s["jtf"], s["jspec"]) if side == "j" \
            else (s["tmesh"], s["ttf"], s["tspec"])
        vcfg, ccfg = _cfgs(mod, "temporal", temporal_reuse="ranges",
                           rebalance="occupancy")
        args = _args(s, side, data)
        thr = pipe.distributed_initial_threshold_mxu(mesh, tf, spec, vcfg,
                                                     plan=plan)(*args)
        ru = pipe.distributed_initial_reuse_mxu(mesh, tf, spec, vcfg, ccfg,
                                                plan=plan)(*args)
        step = pipe.distributed_vdi_step_mxu_temporal(mesh, tf, spec, vcfg,
                                                      ccfg, plan=plan)
        frames = []
        for _ in range(2):
            (vdi, _), thr, ru = step(*args, thr, ru)
            frames.append(((vdi, thr.thr), np_(ru.dirty), np_(ru.sig)))
        outs[side] = frames
    _assert_frames([f[0] for f in outs["t"]], [f[0] for f in outs["j"]])
    for (_, td, ts), (_, jd, js) in zip(outs["t"], outs["j"]):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ts, js)
    assert outs["t"][0][1].all() and not outs["t"][1][1].any()

"""Parity of the port's render rebalancing (``CompositeConfig.rebalance
== "occupancy"``) with the JAX package's, on the CPU.

The planners (``slice_plan`` on the reference's conservation, skew,
min-depth, quantum and hysteresis cases, ``even_plan``, ``plan_work``,
``straggler_factor``) and the profiles (``z_live_profile``,
``z_range_profile``) give the reference's values exactly. ``reslab_z``
equals the reference's under ``shard_map`` (an even plan equals
``halo_exchange_z`` bit for bit), with the reference's messages. The
8-rank distributed mxu step and temporal step (seed and 2 frames) under
the reference tests' plan, in both march regimes, match the reference's
same steps at the ``xla`` fold bar (rtol 1e-4, atol 1e-5) and the port's
own even step at the reference's 1e-5 gate, so do the plan crossed with
tile waves and the ring. The session replans and rebuilds as the
reference's does (the same plans and frames), is inert on one rank on
the ledger, and the bench twin reports the reference's ``rebalance``
block. The scene is the reference tests' (``tests/test_rebalance.py``):
8 ranks, D = 32, 16 x 16, blobs clear of every band boundary.

The helpers here (scene, steps of both packages, comparisons) serve
``tests/test_torch_bricks.py`` and ``tests/test_torch_lod.py`` too."""

import copy
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.ops import occupancy as jocc
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu.runtime import session as jses
from scenery_insitu_tpu.utils.compat import shard_map
from scenery_insitu_tpu_torch import bench as tbench
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.ops import occupancy as tocc
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.runtime import session as tses
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401

CPU = "cpu"
N, D, HW = 8, 32, 16
PLAN = (8, 4, 4, 4, 4, 2, 2, 4)          # the reference tests' plan
RTOL, ATOL = 1e-4, 1e-5                  # the xla fold bar
GATE = 1e-5                              # the reference's mxu gate
EYES = [(0.0, 0.2, 4.0), (3.8, 0.3, 0.6)]    # march axis z, march axis x
REGIMES = ["z_march", "x_march"]
BLOBS = [(1, 3, 0.3), (5, 7, 0.5), (9, 11, 0.7), (13, 15, 0.4),
         (17, 19, 0.6), (21, 23, 0.8), (29, 31, 0.45)]


# ----------------------------------------------------------------- helpers


def scene_data(kind: str = "blobs") -> np.ndarray:
    """The reference tests' scenes: constant blobs >= 2 slices clear of
    every band and brick boundary, or the smooth field of
    ``tests/test_lod.py``. ``"noisy"``: the blobs plus seeded noise in
    [0, 1e-3), below the transfer function's first opacity (the temporal
    seed counts segments at candidate thresholds, and a constant blob's
    samples, equal in one package and an ulp apart in the other, flip a
    count there, as ``tests/test_torch_session.py`` explains)."""
    if kind == "noisy":
        rng = np.random.default_rng(11)
        return scene_data() + rng.uniform(0.0, 1e-3, (D, HW, HW)).astype(
            np.float32)
    if kind == "smooth":
        z = np.arange(D)[:, None, None] / D
        y = np.arange(HW)[None, :, None] / HW
        x = np.arange(HW)[None, None, :] / HW
        return (0.45 + 0.18 * np.sin(2 * np.pi * z) * np.cos(np.pi * y)
                * np.cos(np.pi * x)).astype(np.float32)
    data = np.zeros((D, HW, HW), np.float32)
    for a, b, v in BLOBS:
        data[a:b] = v
    return data


def _box():
    vox = 2.0 / D
    return (np.array([-HW * vox / 2, -HW * vox / 2, -1.0], np.float32),
            np.full(3, vox, np.float32))


def cfgs(pkg, rebalance="even", temporal=False, k=6, **comp):
    """The reference tests' configurations, in package ``pkg``."""
    mode = "temporal" if temporal else "search"
    return (pkg.VDIConfig(max_supersegments=k, adaptive_iters=2,
                          adaptive_mode=mode),
            pkg.CompositeConfig(max_output_supersegments=12,
                                adaptive_iters=2, rebalance=rebalance,
                                **comp))


def _cams(eye):
    return (jcam.Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0),
            tcam.Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0,
                               device=CPU))


def run_jax(eye, rebalance="even", temporal=False, frames=2, data=None, k=6,
            comp=None, **decomp):
    """The reference's 8-rank step on the scene: one frame, or the seed
    and ``frames`` temporal frames. Returns [(color, depth, thr)]."""
    data = scene_data() if data is None else data
    origin, spacing = _box()
    cam, _ = _cams(eye)
    mesh = jmesh.make_mesh(N)
    spec = jsl.make_spec(cam, (D, HW, HW), jcfg.SliceMarchConfig(
        matmul_dtype="f32", scale=2.0), multiple_of=N)
    tf = jtf.TransferFunction.ramp(0.05, 0.8, 0.7)
    vc, cc = cfgs(jcfg, rebalance, temporal, k, **(comp or {}))
    args = (jpipe.shard_volume(jnp.asarray(data), mesh), jnp.asarray(origin),
            jnp.asarray(spacing), cam)
    if not temporal:
        vdi, meta = jpipe.distributed_vdi_step_mxu(mesh, tf, spec, vc, cc,
                                                   **decomp)(*args)
        return [(np.asarray(vdi.color), np.asarray(vdi.depth), None, meta)]
    thr = jpipe.distributed_initial_threshold_mxu(mesh, tf, spec, vc,
                                                  **decomp)(*args)
    step = jpipe.distributed_vdi_step_mxu_temporal(mesh, tf, spec, vc, cc,
                                                   **decomp)
    out = []
    for _ in range(frames):
        (vdi, meta), thr = step(*args, thr)
        out.append((np.asarray(vdi.color), np.asarray(vdi.depth),
                    [np.asarray(x) for x in thr], meta))
    return out


def run_port(eye, rebalance="even", temporal=False, frames=2, data=None, k=6,
             comp=None, **decomp):
    """`run_jax`'s twin on the port (CPU, plain versions)."""
    data = scene_data() if data is None else data
    origin, spacing = _box()
    _, cam = _cams(eye)
    mesh = tmesh.make_mesh(N, device=CPU)
    spec = tsl.make_spec(cam, (D, HW, HW), tcfg.SliceMarchConfig(scale=2.0),
                         multiple_of=N)
    tf = ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU)
    vc, cc = cfgs(tcfg, rebalance, temporal, k, **(comp or {}))
    args = (tmesh.shard_volume(torch.from_numpy(data), mesh),
            torch.from_numpy(origin), torch.from_numpy(spacing), cam)
    if not temporal:
        vdi, meta = tpipe.distributed_vdi_step_mxu(mesh, tf, spec, vc, cc,
                                                   **decomp)(*args)
        return [(np_(vdi.color), np_(vdi.depth), None, meta)]
    thr = tpipe.distributed_initial_threshold_mxu(mesh, tf, spec, vc,
                                                  **decomp)(*args)
    step = tpipe.distributed_vdi_step_mxu_temporal(mesh, tf, spec, vc, cc,
                                                   **decomp)
    out = []
    for _ in range(frames):
        (vdi, meta), thr = step(*args, thr)
        out.append((np_(vdi.color), np_(vdi.depth), [np_(x) for x in thr],
                    meta))
    return out


def _memo_key(value):
    """A hashable key of a `run_port` argument: arrays by their dtype,
    shape and bytes, containers item by item, the rest by repr."""
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape,
                hashlib.sha1(value.tobytes()).hexdigest())
    if isinstance(value, dict):
        return tuple(sorted((k, _memo_key(v)) for k, v in value.items()))
    if isinstance(value, (tuple, list)):
        return tuple(_memo_key(v) for v in value)
    return repr(value)


def memo_runs(runner):
    """``runner`` (`run_port`) memoised for one test file: each distinct
    call runs once, and every caller gets its own deep copy of the
    result. Runs whose side effects a test reads (a recorder's counters)
    call ``runner`` itself."""
    cache = {}

    def run(*args, **kw):
        key = (_memo_key(args), _memo_key(kw))
        if key not in cache:
            cache[key] = runner(*args, **kw)
        return copy.deepcopy(cache[key])

    return run


port_run = memo_runs(run_port)


def assert_frames_close(got, want, rtol=RTOL, atol=ATOL, thr_atol=1e-6):
    """Frame by frame: colours close, the same slots live, live depths
    close, threshold maps within ``thr_atol`` (None: not compared, as
    between decompositions whose maps differ in layout)."""
    assert len(got) == len(want)
    for (gc, gd, gt, _), (wc, wd, wt, _) in zip(got, want):
        np.testing.assert_allclose(gc, wc, rtol=rtol, atol=atol)
        live = np.isfinite(wd)
        assert (np.isfinite(gd) == live).all(), "VDI slot liveness"
        np.testing.assert_allclose(gd[live], wd[live], rtol=rtol, atol=atol)
        if wt is not None and thr_atol is not None:
            for a, b in zip(gt, wt):
                np.testing.assert_allclose(a, b, atol=thr_atol)


def assert_meta_global(frames, meta_want=None):
    for _, _, _, meta in frames:
        np.testing.assert_array_equal(np_(meta.volume_dims),
                                      [HW, HW, D])
        if meta_want is not None:
            for f in ("projection", "view", "window_dims", "nw"):
                np.testing.assert_allclose(np_(getattr(meta, f)),
                                           np.asarray(getattr(meta_want,
                                                              f)),
                                           atol=1e-6, err_msg=f)


def live_slots(frames) -> int:
    return int(sum(np.isfinite(d[:, 0]).sum() for _, d, _, _ in frames))


# ------------------------------------------------------------- planners


def _plan_cases():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(10):                                   # conservation
        cases.append((rng.random(16), 64, int(rng.integers(2, 9)),
                      dict(min_depth=2, quantum=int(rng.integers(1, 5)))))
    skew = np.zeros(32)
    skew[:8] = 1.0
    cases += [(skew, 128, 8, dict(min_depth=4, quantum=1)),          # skew
              (skew, 128, 8, dict(min_depth=4, quantum=1, max_depth=128))]
    clamp = np.zeros(16)
    clamp[0] = 100.0
    cases.append((clamp, 32, 8, dict(min_depth=3, quantum=1)))   # min depth
    cases.append((np.random.default_rng(3).random(16), 64, 4,    # quantum
                  dict(min_depth=4, quantum=4)))
    return cases


@pytest.mark.parametrize("case", range(len(_plan_cases())))
def test_slice_plan_matches_reference(case):
    prof, d, n, kw = _plan_cases()[case]
    want = jocc.slice_plan(prof, d, n, **kw)
    got = tocc.slice_plan(prof, d, n, **kw)
    assert got == want and sum(got) == d and len(got) == n
    plans = [got] + ([tocc.even_plan(d, n)] if d % n == 0 else [])
    for plan in plans:
        assert tocc.plan_work(prof, d, plan) == jocc.plan_work(prof, d, plan)
        assert tocc.straggler_factor(prof, d, plan) == \
            jocc.straggler_factor(prof, d, plan)


def test_slice_plan_hysteresis_keeps_prev():
    rng = np.random.default_rng(4)
    prof = rng.random(16)
    plan = tocc.slice_plan(prof, 64, 4, min_depth=2, quantum=1)
    prof2 = prof + rng.normal(0, 0.01, 16).clip(-0.05, 0.05)
    for hyst in (0.5, 0.25, 0.0):
        got = tocc.slice_plan(prof2, 64, 4, min_depth=2, quantum=1,
                              prev=plan, hysteresis=hyst)
        want = jocc.slice_plan(prof2, 64, 4, min_depth=2, quantum=1,
                               prev=plan, hysteresis=hyst)
        assert got == want
    # a small perturbation keeps the previous plan
    assert tocc.slice_plan(prof2, 64, 4, min_depth=2, quantum=1, prev=plan,
                           hysteresis=0.5) == plan
    big = tocc.slice_plan(prof[::-1].copy(), 64, 4, min_depth=2, quantum=1,
                          prev=plan, hysteresis=0.25)
    assert big == jocc.slice_plan(prof[::-1].copy(), 64, 4, min_depth=2,
                                  quantum=1, prev=plan, hysteresis=0.25)
    prev = (16, 16, 16, 16)
    assert tocc.slice_plan(np.ones(16), 64, 4, prev=prev,
                           hysteresis=0.5) == prev


def test_plan_helpers_and_errors_match_reference():
    assert tocc.even_plan(32, 8) == jocc.even_plan(32, 8) == (4,) * 8
    assert tocc.PLAN_BASE_COST == jocc.PLAN_BASE_COST
    for fn, args in ((lambda m: m.even_plan(30, 8), ()),
                     (lambda m: m.plan_work(np.ones(4), 32, (8, 8)), ()),
                     (lambda m: m.slice_plan(np.ones(3), 32, 4), ())):
        with pytest.raises(ValueError) as a:
            fn(jocc)
        with pytest.raises(ValueError) as b:
            fn(tocc)
        assert str(a.value) == str(b.value)


def test_z_profiles_match_reference():
    rng = np.random.default_rng(5)
    field = rng.random((D, HW, HW)).astype(np.float32) * 0.3
    field[8:12] = 0.9
    jt = jtf.TransferFunction.ramp(0.05, 0.8, 0.7)
    tt = ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU)
    for nzb, nyb in ((0, 0), (8, 4), (4, 1)):
        want = np.asarray(jocc.z_live_profile(jnp.asarray(field), jt,
                                              nzb=nzb, nyb=nyb))
        got = np_(tocc.z_live_profile(torch.from_numpy(field), tt, nzb=nzb,
                                      nyb=nyb))
        np.testing.assert_array_equal(got, want)
        jl, jh = jocc.z_range_profile(jnp.asarray(field), nzb=nzb)
        tl, th = tocc.z_range_profile(torch.from_numpy(field), nzb=nzb)
        np.testing.assert_array_equal(np_(tl), np.asarray(jl))
        np.testing.assert_array_equal(np_(th), np.asarray(jh))


# --------------------------------------------------------------- reslab_z


def jax_sharded(fn, data, out_dims=3, levels=None):
    """``fn`` of each rank's even slab under the reference's shard_map:
    the per-rank outputs stacked ``[n, ...]`` (a dict of them by level
    when ``levels`` are given)."""
    mesh = jmesh.make_mesh(N)
    spec = P("ranks", *([None] * (out_dims - 1)))
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=P("ranks", None, None),
                          out_specs=spec if levels is None
                          else {lv: spec for lv in levels},
                          check_vma=False))
    out = f(jpipe.shard_volume(jnp.asarray(data), mesh))

    def stack(x):
        x = np.asarray(x)
        return x.reshape((N, x.shape[0] // N) + x.shape[1:])

    return stack(out) if levels is None else \
        {lv: stack(x) for lv, x in out.items()}


def port_slabs(data):
    return tmesh.shard_volume(torch.from_numpy(data),
                              tmesh.make_mesh(N, device=CPU))


@pytest.mark.parametrize("h", [0, 1, 2])
def test_reslab_z_matches_reference(h):
    data = np.random.default_rng(1).random((D, 6, 5)).astype(np.float32)
    slabs = port_slabs(data)
    for plan in (PLAN, tocc.even_plan(D, N)):
        want = jax_sharded(lambda x: jmesh.reslab_z(x, plan, "ranks", h=h),
                           data)
        got = tmesh.reslab_z(slabs, plan, h=h)
        np.testing.assert_array_equal(np_(got), want)
    if h:
        even = tmesh.reslab_z(slabs, tocc.even_plan(D, N), h=h)
        np.testing.assert_array_equal(np_(even),
                                      np_(tmesh.halo_exchange_z(slabs, h)))
    bf = tmesh.reslab_z(slabs.to(torch.bfloat16), PLAN, h=h)
    assert bf.dtype == torch.bfloat16


def test_reslab_z_errors_match_reference():
    slabs = port_slabs(np.zeros((D, 2, 2), np.float32))
    for plan, h in ((PLAN, 3), ((4,) * 7, 1), ((8, 8, 8, 8, 0, 0, 0, 0), 1),
                    ((8,) * 8, 1)):
        with pytest.raises(ValueError) as a:
            jax_sharded(lambda x: jmesh.reslab_z(x, plan, "ranks", h=h),
                        np.zeros((D, 2, 2), np.float32))
        with pytest.raises(ValueError) as b:
            tmesh.reslab_z(slabs, plan, h=h)
        assert str(a.value) == str(b.value)
    with pytest.raises(ValueError, match=r"rank 5.*rebalance_min_depth"):
        tmesh.validate_plan(PLAN, 8, h=3)


def test_plan_without_occupancy_rebalance_raises_as_reference():
    spec = tsl.make_spec(_cams(EYES[0])[1], (D, HW, HW),
                         tcfg.SliceMarchConfig(scale=2.0), multiple_of=N)
    jspec = jsl.make_spec(_cams(EYES[0])[0], (D, HW, HW),
                          jcfg.SliceMarchConfig(scale=2.0), multiple_of=N)
    with pytest.raises(ValueError) as a:
        jpipe.distributed_vdi_step_mxu(
            jmesh.make_mesh(N), jtf.TransferFunction.ramp(0.05, 0.8, 0.7),
            jspec, *cfgs(jcfg), plan=PLAN)
    with pytest.raises(ValueError) as b:
        tpipe.distributed_vdi_step_mxu(
            tmesh.make_mesh(N, device=CPU),
            ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU), spec,
            *cfgs(tcfg), plan=PLAN)
    assert str(a.value) == str(b.value)


# ------------------------------------------------------- distributed steps


@pytest.fixture(scope="module", params=range(len(EYES)), ids=REGIMES)
def plan_steps(request):
    """Per march regime: the reference's planned step (K = 10, the
    reference tests' plan configuration) and its seed and 2 temporal
    frames on the noisy scene."""
    eye = EYES[request.param]
    return dict(eye=eye,
                step=run_jax(eye, "occupancy", k=10, plan=PLAN),
                temporal=run_jax(eye, "occupancy", temporal=True, k=10,
                                 data=scene_data("noisy"), plan=PLAN))


def test_planned_step_matches_reference_and_even(plan_steps):
    eye = plan_steps["eye"]
    got = run_port(eye, "occupancy", k=10, plan=PLAN)
    assert_frames_close(got, plan_steps["step"])
    assert_meta_global(got, plan_steps["step"][0][3])
    assert_frames_close(got, port_run(eye, k=10), rtol=0.0, atol=GATE)
    assert live_slots(got) > 0


def test_planned_temporal_step_matches_reference_and_even(plan_steps):
    """The temporal step against the reference's in both regimes, and
    against the even step where the reference holds it (the z march:
    an x/y march's per-rank threshold maps adapt to each rank's band,
    in the reference as here)."""
    eye = plan_steps["eye"]
    noisy = scene_data("noisy")
    got = run_port(eye, "occupancy", temporal=True, k=10, data=noisy,
                   plan=PLAN)
    assert_frames_close(got, plan_steps["temporal"])
    if eye == EYES[0]:
        assert_frames_close(got, port_run(eye, temporal=True, k=10,
                                          data=noisy),
                            rtol=0.0, atol=GATE)


@pytest.mark.parametrize("exchange", ["all_to_all", "ring"])
def test_planned_waves_cross_matches_frame(exchange):
    """Plans x the exchange schedules: the planned temporal step in tile
    waves (T = 2) equals the planned frame schedule and the even
    step."""
    comp = dict(exchange=exchange, schedule="waves", wave_tiles=2)
    got = run_port(EYES[0], "occupancy", temporal=True, comp=comp,
                   plan=PLAN)
    frame = run_port(EYES[0], "occupancy", temporal=True,
                     comp=dict(exchange=exchange), plan=PLAN)
    assert_frames_close(got, frame, rtol=0.0, atol=1e-6)
    assert_frames_close(got, port_run(EYES[0], temporal=True), rtol=0.0,
                        atol=GATE)


def test_planned_build_counts_and_even_plan_short_circuits():
    """A plan step counts one build a step with the reference's event;
    an even plan (and one rank) takes the slab path unbuilt."""
    for plan, built in ((PLAN, 1), (tocc.even_plan(D, N), 0)):
        rec = tobs.Recorder(enabled=True)
        prev = tobs.set_recorder(rec)
        try:
            run_port(EYES[1], "occupancy", plan=plan)
        finally:
            tobs.set_recorder(prev)
        assert rec.counters.get("rebalance_steps_built", 0) == built
        ev = [e for e in rec.events if e.get("name") == "rebalance_build"]
        if built:
            assert ev[0]["attrs"]["plan"] == list(PLAN)
            assert ev[0]["attrs"]["max_depth"] == max(PLAN)
            assert ev[0]["attrs"]["pad_overhead"] == round(
                8 * N / float(D) - 1.0, 4)


# ------------------------------------------------------------ the session


class MovingSim:
    """A field whose live content moves up the z axis by 4 slices a
    sim step (numpy; wrapped for either package), so replans adopt
    changing plans."""

    kind = "moving_blobs"

    def __init__(self, wrap, d=D, hw=HW):
        self._wrap = wrap
        self._t = 0
        self._d, self._hw = d, hw
        self.field = self._make()

    def _make(self):
        f = np.zeros((self._d, self._hw, self._hw), np.float32)
        lo = (2 + 4 * self._t) % (self._d - 8)
        f[lo:lo + 6] = 0.6
        f[self._d - 3:self._d - 1, :4] = 0.3
        return self._wrap(f)

    def advance(self, n):
        self._t += n
        self.field = self._make()


def session_overrides(n=N, **extra):
    over = {"slicer.engine": "mxu", "slicer.matmul_dtype": "f32",
            "slicer.scale": "2.0", "render.width": "32",
            "render.height": "32", "vdi.max_supersegments": "6",
            "vdi.adaptive_iters": "2", "vdi.adaptive_mode": "temporal",
            "composite.max_output_supersegments": "12",
            "composite.adaptive_iters": "2", "mesh.num_devices": str(n),
            "sim.steps_per_frame": "1", "obs.enabled": "true"}
    over.update(extra)
    return [f"{k}={v}" for k, v in over.items()]


def run_sessions(frames, n=N, **extra):
    """The reference's session and the port's on `MovingSim` with the
    same configuration: (per package: frames, replan events, counters,
    the session)."""
    out = {}
    for name, pkg_cfg, ses, wrap, kw in (
            ("jax", jcfg.FrameworkConfig, jses, jnp.asarray, {}),
            ("port", tcfg.FrameworkConfig, tses, torch.from_numpy,
             {"device": CPU})):
        got = {}
        sess = ses.InSituSession(
            pkg_cfg().with_overrides(*session_overrides(n, **extra)),
            sim=MovingSim(wrap), sinks=[lambda i, p, got=got:
                                        got.__setitem__(i, p)], **kw)
        sess.run(frames)
        events = [e["attrs"] for e in sess.obs.events
                  if e.get("name") == "rebalance_plan"]
        out[name] = (got, events, dict(sess.obs.counters), sess)
    return out


def assert_sessions_match(out, frames):
    (jf, jev, jcnt, _), (tf_, tev, tcnt, _) = out["jax"], out["port"]
    assert tev == jev
    for key in ("rebalance_replans", "build_steps",
                "rebalance_steps_built", "bricks_steps_built"):
        assert tcnt.get(key, 0) == jcnt.get(key, 0), key
    for i in range(frames):
        g, w = tf_[i], jf[i]
        assert_frames_close([(g["vdi_color"], g["vdi_depth"], None, None)],
                            [(w["vdi_color"], w["vdi_depth"], None, None)])


def test_session_replans_and_rebuilds_as_reference():
    """``rebalance=occupancy`` every 2 frames on 8 ranks: the same plans
    adopted at the same frames, one rebuild each, the same frames."""
    frames = 6
    out = run_sessions(frames, **{
        "composite.rebalance": "occupancy",
        "composite.rebalance_period": "2",
        "composite.rebalance_quantum": "1",
        "composite.rebalance_min_depth": "1",
        "composite.rebalance_hysteresis": "0.05"})
    assert_sessions_match(out, frames)
    ev = out["port"][1]
    assert len(ev) >= 2 and all(sum(e["plan"]) == D for e in ev)
    sess = out["port"][3]
    assert sess._plan == out["jax"][3]._plan
    assert sess.obs.counters["rebalance_replans"] == len(ev)
    assert sess.obs.counters["build_steps"] == 1 + len(ev)


def test_session_inert_on_one_rank_with_the_ledger():
    tobs.clear_ledger()
    sess = tses.InSituSession(
        tcfg.FrameworkConfig().with_overrides(*session_overrides(
            1, **{"composite.rebalance": "occupancy"})),
        sim=MovingSim(torch.from_numpy), device=CPU)
    sess.run(2)
    assert sess._plan is None
    rows = [e for e in tobs.ledger()
            if e["component"] == "occupancy.rebalance"]
    assert rows and rows[0]["reason"] == "single-rank mesh has one band"
    assert sess.obs.counters.get("rebalance_replans", 0) == 0


# ------------------------------------------------------------ bench twin


def test_bench_rebalance_block_matches_reference_computation():
    """The twin's ``rebalance`` block on a field equals the reference
    bench's computation (root ``bench.py``) on the same field."""
    rng = np.random.default_rng(9)
    grid = 64
    field = (rng.random((grid, grid, grid)) * 0.05).astype(np.float32)
    field[4:20, 8:40] = 0.5
    got = tbench.rebalance_block(torch.from_numpy(field), grid,
                                 "occupancy", CPU)
    prof = jocc.z_live_profile(jnp.asarray(field),
                               jtf.for_dataset("gray_scott"))
    plan8 = jocc.slice_plan(prof, grid, 8, min_depth=4, quantum=4)
    want = {
        "mode": "occupancy", "modeled_ranks": 8, "plan": list(plan8),
        "plan_histogram": {str(d): sum(1 for p in plan8 if p == d)
                           for d in sorted(set(plan8))},
        "straggler_even": round(jocc.straggler_factor(
            prof, grid, jocc.even_plan(grid, 8)), 3),
        "straggler_planned": round(jocc.straggler_factor(prof, grid, plan8),
                                   3)}
    assert got == want
    assert got["plan"] != [grid // 8] * 8
    with pytest.raises(ValueError, match="even|occupancy"):
        tbench.bench_config({"SITPU_BENCH_REBALANCE": "bricks"},
                            on_card=False)

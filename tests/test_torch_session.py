"""Parity of the port's in-situ session with the JAX package's, on the CPU.

Both sessions run the same configuration (``slicer.engine=mxu``, 16^3
Gray-Scott, 2 sim steps a frame, K = 6 into 8 output slots, orbit 0.05
rad a frame) from the same ``u, v``, on 1 and 4 ranks, with temporal and
histogram thresholds. The payloads are compared frame by frame at the
``xla`` fold bar of ``tests/test_torch_parallel.py`` (rtol 1e-4, atol
1e-5), the metadata matrices within 1e-6 and the frame index exactly.
The start state is the port's ``GrayScott.init`` plus seeded noise of
1e-3: the init alone holds cubes of constant value, where the two
packages' resampling products (summed in different orders) leave
samples equal in one and an ulp apart in the other, which flips a
pixel's count at the histogram's zero candidate threshold
(`test_init_state_flips_only_the_zero_candidate` holds that caveat
apart, as ``tests/test_torch_pipeline.py`` does for the bf16 march).

Also: checkpoints cross-load between the packages in both directions and
resume within the same bars; the port's own resume, ``pipeline_depth`` 2
and the async delivery plane are bit-exact; ``prewarm_regimes`` restores
the session's state; the sinks' artifacts load in both packages; the
unported session features raise naming their ROADMAP row; the example
twin writes its PNGs and checkpoints. JAX sessions are shared through a
module-scoped fixture."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scenery_insitu_tpu.config import FrameworkConfig as JConfig
from scenery_insitu_tpu.io import vdi_io as jio
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel.pipeline import (
    distributed_initial_threshold_mxu as jseed)
from scenery_insitu_tpu.parallel.pipeline import shard_volume as jshard
from scenery_insitu_tpu.runtime import checkpoint as jck
from scenery_insitu_tpu.runtime import session as jses
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.config import FrameworkConfig as TConfig
from scenery_insitu_tpu_torch.io import vdi_io as tio
from scenery_insitu_tpu_torch.parallel.mesh import shard_volume as tshard
from scenery_insitu_tpu_torch.parallel.pipeline import (
    distributed_initial_threshold_mxu as tseed)
from scenery_insitu_tpu_torch.runtime import checkpoint as tck
from scenery_insitu_tpu_torch.runtime import session as tses
from scenery_insitu_tpu_torch.sim import grayscott as tgs
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, np_, one_torch_thread)

CPU = "cpu"
GRID = 16
FRAMES = 3          # frames compared; the reference runs 2 more
ORBIT = 0.05
RTOL, ATOL = 1e-4, 1e-5
CASES = [(1, "temporal"), (1, "histogram"), (4, "temporal"),
         (4, "histogram")]
META_FIELDS = ("projection", "view", "model", "volume_dims", "window_dims",
               "nw")


def _overrides(n, mode, **extra):
    over = {"slicer.engine": "mxu", "slicer.scale": "1.0",
            "sim.grid": f"[{GRID},{GRID},{GRID}]",
            "sim.steps_per_frame": "2", "vdi.max_supersegments": "6",
            "vdi.adaptive_mode": mode,
            "composite.max_output_supersegments": "8",
            "mesh.num_devices": str(n)}
    over.update(extra)
    return [f"{k}={v}" for k, v in over.items()]


def _start_state():
    """The port's Gray-Scott init plus seeded noise (numpy)."""
    st = tgs.GrayScott.init((GRID,) * 3, seed=0, device=CPU)
    rng = np.random.default_rng(7)
    u = st.u.numpy() + rng.normal(0.0, 1e-3, st.u.shape)
    v = st.v.numpy() + rng.normal(0.0, 1e-3, st.v.shape)
    return u.astype(np.float32), v.astype(np.float32)


def _capture(store):
    def sink(index, payload):
        store[index] = payload
    return sink


def jax_session(n, mode, state=True, **extra):
    sess = jses.InSituSession(JConfig().with_overrides(
        *_overrides(n, mode, **extra)))
    sess.orbit_rate = ORBIT
    if state:
        u, v = _start_state()
        sess.sim.state = sess.sim.state._replace(u=jnp.asarray(u),
                                                 v=jnp.asarray(v))
    return sess


def port_session(n, mode, state=True, sinks=(), **extra):
    sess = tses.InSituSession(TConfig().with_overrides(
        *_overrides(n, mode, **extra)), sinks=sinks, device=CPU)
    sess.orbit_rate = ORBIT
    if state:
        u, v = _start_state()
        sess.sim.state = sess.sim.state._replace(u=torch.from_numpy(u),
                                                 v=torch.from_numpy(v))
    return sess


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per case: the JAX session's payloads of frames 0..4, its
    checkpoint after frame 2, its threshold states then, and the session
    itself."""
    out = {}
    for n, mode in CASES:
        frames = {}
        sess = jax_session(n, mode)
        sess.sinks.append(_capture(frames))
        sess.run(FRAMES)
        path = str(tmp_path_factory.mktemp("jck") / f"{n}_{mode}.npz")
        jck.save_session(sess, path)
        thr = {k: [np.asarray(x) for x in v]
               for k, v in sess._mxu_thr.items()}
        sess.run(2)
        out[(n, mode)] = dict(frames=frames, ckpt=path, thr=thr, sess=sess)
    return out


def assert_payloads_close(got, want, frames):
    for i in frames:
        g, w = got[i], want[i]
        assert g["frame"] == w["frame"] == i
        assert_vdi_close(g["vdi_color"], g["vdi_depth"], w["vdi_color"],
                         w["vdi_depth"], RTOL, ATOL)
        for f in META_FIELDS:
            np.testing.assert_allclose(np_(getattr(g["meta"], f)),
                                       np.asarray(getattr(w["meta"], f)),
                                       atol=1e-6, err_msg=f)
        assert int(g["meta"].index) == int(w["meta"].index) == i


def assert_payloads_equal(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        for key in ("vdi_color", "vdi_depth"):
            np.testing.assert_array_equal(got[i][key], want[i][key])


@pytest.mark.parametrize("n,mode", CASES)
def test_session_matches_reference(n, mode, reference):
    ref = reference[(n, mode)]
    frames = {}
    sess = port_session(n, mode, sinks=[_capture(frames)])
    last = sess.run(FRAMES)
    assert last["frame"] == FRAMES - 1
    assert_payloads_close(frames, ref["frames"], range(FRAMES))
    assert np.isfinite(frames[FRAMES - 1]["vdi_depth"][:, 0]).any()
    # the carried threshold state, keyed by Python-int regime tuples
    assert set(sess._mxu_thr) == set(ref["thr"])
    for key, state in sess._mxu_thr.items():
        assert all(type(p) is int for p in key)
        for a, b in zip(state, ref["thr"][key]):
            np.testing.assert_allclose(np_(a), b, atol=1e-6)
    assert sess.timers.stats["sim"].n == FRAMES
    assert sess.frame_index == FRAMES


@pytest.mark.parametrize("n", [1, 4])
def test_checkpoints_cross_load(n, reference, tmp_path):
    """A JAX checkpoint resumed in the port, and a port checkpoint
    resumed in JAX, each give the reference's next 2 frames."""
    ref = reference[(n, "temporal")]
    tail = (FRAMES, FRAMES + 1)     # the uninterrupted run's next frames
    got = {}
    port = port_session(n, "temporal", state=False, sinks=[_capture(got)])
    port.orbit_rate = 0.123            # the checkpoint restores it
    tck.load_session(port, ref["ckpt"])
    assert port.frame_index == FRAMES and port.orbit_rate == ORBIT
    port.run(2)
    assert_payloads_close(got, ref["frames"], tail)
    src = port_session(n, "temporal")
    src.run(FRAMES)
    path = str(tmp_path / "port.npz")
    tck.save_session(src, path)
    jframes = {}
    jsess = jax_session(n, "temporal", state=False)
    jsess.sinks.append(_capture(jframes))
    jck.load_session(jsess, path)
    assert jsess.frame_index == FRAMES
    assert jsess._last_regime_key == src._last_regime_key
    jsess.run(2)
    assert_payloads_close(jframes, ref["frames"], tail)


def test_resume_is_bit_exact(tmp_path):
    """The twin of the reference's ``test_resume_is_bit_exact``: 5
    frames, against 3 frames, a checkpoint, a fresh session, 2 more."""
    path = str(tmp_path / "ckpt.npz")
    a = port_session(4, "temporal")
    ref = a.run(5)
    b = port_session(4, "temporal")
    b.run(3)
    tck.save_session(b, path)
    c = port_session(4, "temporal", state=False)
    c.orbit_rate = 0.123
    tck.load_session(c, path)
    assert c.frame_index == b.frame_index
    assert c.orbit_rate == ORBIT
    assert set(c._mxu_thr) == set(b._mxu_thr)
    got = c.run(2)
    assert got["frame"] == ref["frame"]
    np.testing.assert_array_equal(ref["vdi_color"], got["vdi_color"])
    np.testing.assert_array_equal(ref["vdi_depth"], got["vdi_depth"])


def test_checkpoint_rejects_mismatch(tmp_path):
    path = str(tmp_path / "m.npz")
    a = port_session(4, "temporal")
    a.run(1)
    tck.save_session(a, path)
    with pytest.raises(ValueError, match="shape"):
        tck.load_session(port_session(4, "temporal", state=False, **{
            "sim.grid": "[32,32,32]"}), path)
    with pytest.raises(ValueError, match="mesh_devices"):
        tck.load_session(port_session(2, "temporal", state=False), path)
    with pytest.raises(ValueError, match="temporal"):
        tck.load_session(port_session(4, "histogram", state=False), path)


def test_pipeline_depth_and_async_delivery_are_bit_exact():
    """``pipeline_depth`` 2, and the sinks on the delivery worker, give
    the payloads of depth 1 with inline sinks, bit for bit."""
    runs = {}
    for name, extra in (("depth1", {}),
                        ("depth2", {"runtime.pipeline_depth": "2"}),
                        ("async", {"runtime.pipeline_depth": "2",
                                   "delivery.enabled": "true"})):
        got = {}
        sess = port_session(4, "temporal", sinks=[_capture(got)], **extra)
        sess.run(4)
        runs[name] = got
        if name == "async":
            assert sess.obs.counters["delivery_frames_delivered"] == 4
            sess._delivery.close()
    assert_payloads_equal(runs["depth2"], runs["depth1"])
    assert_payloads_equal(runs["async"], runs["depth1"])


def test_prewarm_restores_state():
    """Prewarming every regime leaves the camera, the carried thresholds,
    the regime tracker, the sim and the frame index as they were: the
    next frames equal those of a session that never prewarmed."""
    a = port_session(1, "temporal")
    b = port_session(1, "temporal")
    a.run(1)
    b.run(1)
    eye, thr = a.camera.eye.clone(), {k: [x.clone() for x in v]
                                      for k, v in a._mxu_thr.items()}
    last, v = a._last_regime_key, a.sim.state.v.clone()
    times = a.prewarm_regimes()
    assert set(times) == {(x, s) for x in (0, 1, 2) for s in (1, -1)}
    assert len(a._mxu_steps) == 6
    torch.testing.assert_close(a.camera.eye, eye, rtol=0, atol=0)
    assert set(a._mxu_thr) == set(thr)
    for k in thr:
        for x, y in zip(a._mxu_thr[k], thr[k]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a._last_regime_key == last and a.frame_index == 1
    torch.testing.assert_close(a.sim.state.v, v, rtol=0, atol=0)
    pa, pb = a.run(2), b.run(2)
    np.testing.assert_array_equal(pa["vdi_color"], pb["vdi_color"])
    with pytest.raises(ValueError, match="invalid march regime"):
        a.prewarm_regimes([(3, 1)])


def test_regime_camera_and_metadata_match_reference(reference):
    ref = reference[(4, "temporal")]["sess"]
    port = port_session(4, "temporal", state=False)
    port.camera = port.camera._replace(
        eye=torch.from_numpy(np.array(ref.camera.eye)))
    for regime in [(a, s) for a in (0, 1, 2) for s in (1, -1)]:
        got = tses.regime_camera(port.camera, regime)
        want = jses.regime_camera(ref.camera, regime, jsl)
        np.testing.assert_allclose(np_(got.eye), np.asarray(want.eye),
                                   atol=1e-6)
    got, want = port.frame_metadata(7), ref.frame_metadata(7)
    for f in META_FIELDS + ("index",):
        np.testing.assert_allclose(np_(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=1e-6)


def test_sinks_write_artifacts_both_packages_read(tmp_path):
    got = {}
    d = str(tmp_path)
    sess = port_session(1, "temporal", sinks=[
        tses.png_sink(d, every=2), tses.vdi_sink(d, every=2, codec="zlib"),
        _capture(got)])
    sess.sinks.append(tck.checkpoint_sink(d, every=2).bind(sess))
    sess.run(3)
    assert sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(d, "frame*.png"))) == \
        ["frame00000.png", "frame00002.png"]
    assert sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(d, "ckpt_*.npz"))) == \
        ["ckpt_00002.npz", "ckpt_00003.npz"]
    for i in (0, 2):
        path = tio.dump_path(d, "session", i, "vdi")
        for load in (tio.load_vdi, jio.load_vdi):
            vdi, meta = load(path)
            np.testing.assert_array_equal(np.asarray(vdi.color),
                                          got[i]["vdi_color"])
            np.testing.assert_array_equal(np.asarray(vdi.depth),
                                          got[i]["vdi_depth"])
    # the reference's png_sink on the same payload: the same pixels, up
    # to one display level where the two decodes round apart
    jses.png_sink(str(tmp_path / "j"), every=2)(2, got[2])
    a = np.asarray(Image.open(os.path.join(d, "frame00002.png")), np.int16)
    b = np.asarray(Image.open(str(tmp_path / "j" / "frame00002.png")),
                   np.int16)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    # a tile payload through the tile sink keeps its placement
    tile = dict(got[2], tile=1, tiles=2, col0=8)
    tses.vdi_tile_sink(d, codec="none")(2, tile)
    vdi, meta, placement = jio.load_vdi_tile(
        tio.dump_path(d, "session", 2, "vditile01"))
    assert placement == (1, 2, 8)
    np.testing.assert_array_equal(np.asarray(vdi.color), got[2]["vdi_color"])
    np.testing.assert_allclose(np.asarray(meta.view),
                               np_(got[2]["meta"].view))


def _raises_with(n=1, mode="temporal", **extra):
    return lambda: port_session(n, mode, state=False, **extra)


def _runs_with(n=1, mode="temporal", **extra):
    def run():
        sess = port_session(n, mode, state=False, **extra)
        sess.run(1)
        return sess
    return run


class _Endpoint:
    """A steering endpoint's drain (``runtime/streaming.
    SteeringEndpoint``) without its socket."""

    def __init__(self, *msgs):
        self.msgs = list(msgs)

    def drain(self):
        msgs, self.msgs = self.msgs, []
        yield from msgs


def _steering():
    sess = port_session(1, "temporal", state=False,
                        **{"obs.enabled": "true"})
    sess.orbit_rate = 0.0
    sess.steering = _Endpoint({"type": "camera", "eye": [0.0, 0.0, 9.0]},
                              {"type": "record"})
    seen = []
    sess.on_steer.append(seen.append)
    sess.run(1)
    assert sess.camera.eye.tolist() == [0.0, 0.0, 9.0]
    assert seen == [{"type": "record"}] and not sess.steering.msgs
    return sess


def _tf_message():
    sess = port_session(1, "temporal", state=False,
                        **{"obs.enabled": "true"})
    for cb in sess.on_steer:
        cb({"type": "tf", "points": [[0.0, 0.0], [1.0, 0.5]]})
    sess.run(1)
    return sess


def _profiled():
    import tempfile

    sess = port_session(1, "temporal", state=False,
                        **{"obs.enabled": "true"})
    with tempfile.TemporaryDirectory() as d:
        sess.run(1, profile_dir=d)
        with open(os.path.join(d, "trace.json")) as f:
            assert "sitpu_march" in f.read()
    return sess


def _snapshot():
    sess = _runs_with(**{"obs.enabled": "true"})()
    assert sess.device_snapshot() == {
        str(sess._slicer.choose_axis(sess.camera)): {
            "source": "unavailable",
            "error": "host-side closure (temporal step)"}}
    return sess


UNPORTED = {
    "scan_frames": (_raises_with(**{"runtime.scan_frames": "4"}), "A3/A7"),
    # ported since (A4, A9): a one-rank session renders its plain image
    # on the slice march (one step built for the regime), or its VDI on
    # the gather engine (one step built with the session, no regime)
    "plain_modes": (_runs_with(**{"runtime.generate_vdis": "false",
                                  "render.width": "32",
                                  "render.height": "24",
                                  "obs.enabled": "true"}),
                    {"compile_step": 1, "frames_eager_dispatch": 1}),
    "gather": (_runs_with(mode="histogram", **{
        "slicer.engine": "gather", "render.width": "32",
        "render.height": "24", "render.max_steps": "32",
        "obs.enabled": "true"}),
        {"compile_step": 0, "frames_eager_dispatch": 1}),
    # ported since (A10): the vortex session renders VDIs on the slice
    # march, the particle sims sort-first spheres (no regime step), the
    # hybrid session its regime's hybrid step
    "vortex": (_runs_with(**{"sim.kind": "vortex", "obs.enabled": "true"}),
               {"compile_step": 1, "frames_eager_dispatch": 1}),
    "lennard_jones": (_runs_with(**{
        "sim.kind": "lennard_jones", "sim.num_particles": "64",
        "obs.enabled": "true"}),
        {"compile_step": 0, "frames_eager_dispatch": 1}),
    "sho": (_runs_with(**{"sim.kind": "sho", "sim.num_particles": "64",
                          "obs.enabled": "true"}),
            {"compile_step": 0, "frames_eager_dispatch": 1}),
    "hybrid": (_runs_with(**{"sim.kind": "hybrid", "sim.num_particles": "64",
                             "obs.enabled": "true"}),
               {"compile_step": 1, "frames_eager_dispatch": 1}),
    # ported since (A8b, item 4): a one-rank session runs its frame and
    # ledgers the inert knob, as the reference's does
    "rebalance_occupancy": (_runs_with(
        **{"composite.rebalance": "occupancy"}), ("occupancy.rebalance",)),
    "rebalance_bricks": (_runs_with(**{"composite.rebalance": "bricks"}),
                         ("occupancy.rebalance",)),
    "lod": (_runs_with(**{"lod.enabled": "true"}), ("lod.inert",)),
    # ported since (A8b, item 6): a one-rank session builds its reuse
    # step, or its budgeted step, and counts the build as the
    # reference's session does
    "temporal_reuse": (_runs_with(
        **{"composite.temporal_reuse": "ranges", "obs.enabled": "true"}),
        {"reuse_steps_built": 1}),
    "k_budget": (_runs_with(**{"composite.k_budget": "occupancy",
                               "obs.enabled": "true"}),
                 {"occupancy_kbudget_builds": 1}),
    # ported since (A8b, item 5): a 2-host session of 2 ranks builds
    # the two-level mesh and composites its frame in two levels
    "num_hosts": (_runs_with(n=2, **{"topology.num_hosts": "2",
                                     "obs.enabled": "true"}),
                  {"hier_composite_builds": 1, "dcn_hops_built": 1}),
    # ported since (A12): a configured collector gets the frame's batch
    # and the end-of-run forced one (nothing listens: the PUB socket
    # drops them, unblocked); a profiled run writes its trace; the cost
    # snapshot of a temporal step is the reference's "unavailable"
    "obs_collector": (_runs_with(**{"obs.collector": "tcp://127.0.0.1:1",
                                    "obs.enabled": "true"}),
                      {"obs_batches_published": 2}),
    "profile_dir": (_profiled, {"frames_eager_dispatch": 1}),
    "device_snapshot": (_snapshot, {"frames_eager_dispatch": 1}),
    # ported since (A11): the session drains its steering endpoint at
    # the top of the frame (camera applied, other kinds to on_steer)
    "steering": (_steering, {"tf_updates": 0}),
    # ported since (A10c): a steered TF rebuilds the session's steps
    # (the TF was not seen before) and the frame runs on them
    "tf_steering": (_tf_message, {"tf_updates": 1, "tf_steps_reused": 0,
                                  "build_steps": 2}),
}


@pytest.mark.parametrize("feature", sorted(UNPORTED))
def test_unported_features_raise(feature):
    """Each feature not ported yet raises naming its ROADMAP row; one
    ported since runs and puts its inert knob on the ledger, or runs
    and counts its build."""
    call, row = UNPORTED[feature]
    if isinstance(row, dict):
        sess = call()
        assert sess.frame_index == 1
        for key, count in row.items():
            assert sess.obs.counters.get(key, 0) == count, key
        return
    if isinstance(row, tuple):
        tobs.clear_ledger()
        sess = call()
        assert sess.frame_index == 1
        assert any(e["component"] == row[0] for e in tobs.ledger()), row
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {row}"):
        call()


def test_device_none_without_card_raises(monkeypatch):
    """``device=None`` means CUDA: without a card the session raises
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tses.InSituSession(TConfig().with_overrides(*_overrides(
            1, "temporal")))


def test_example_twin_writes_pngs_and_checkpoint(tmp_path, capsys):
    from scenery_insitu_tpu_torch.examples import insitu_grayscott as ex

    out = str(tmp_path / "out")
    args = ["--grid", "16", "--device", "cpu", "--out", out, "--orbit",
            "0.05"]
    assert ex.main(args + ["--frames", "3", "--checkpoint-every", "2"]) == 0
    assert sorted(os.listdir(out)) == [
        "ckpt_00002.npz", "ckpt_00003.npz", "frame00000.png",
        "frame00001.png", "frame00002.png"]
    assert ex.main(args + ["--frames", "1", "--prewarm", "--resume",
                           os.path.join(out, "ckpt_00002.npz")]) == 0
    assert "resumed at frame 2" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "frame00002.png"))
    # the streaming flags (ported since, A11): an I_PCM movie of the
    # frames, at the size its layout gives
    from scenery_insitu_tpu_torch.io.h264 import ipcm_stream_bytes

    movie = os.path.join(out, "run.h264")
    assert ex.main(args + ["--frames", "2", "--movie", movie]) == 0
    h, w = np.asarray(Image.open(os.path.join(out, "frame00000.png"))
                      ).shape[:2]
    assert os.path.getsize(movie) == ipcm_stream_bytes(w & ~1, h & ~1, 2)


def test_init_state_flips_only_the_zero_candidate():
    """The caveat the module docstring names: on the Gray-Scott init
    state (constant cubes) after one frame's sim advance, the two
    packages' temporal seeds differ only where one takes the zero
    candidate (clamped to 1e-3) and the other the next (0.0078125)."""
    jsess = jax_session(1, "temporal", state=False)
    port = port_session(1, "temporal", state=False)
    u, v = port.sim.state.u.numpy(), port.sim.state.v.numpy()
    jsess.sim.state = jsess.sim.state._replace(u=jnp.asarray(u),
                                               v=jnp.asarray(v))
    jsess.sim.advance(2)
    field = np.asarray(jsess.sim.field)
    cfg = port.cfg
    tspec = port._slicer.make_spec(port.camera, (GRID,) * 3, cfg.slicer)
    jspec = jsl.make_spec(jsess.camera, (GRID,) * 3, jsess.cfg.slicer)
    want = jseed(jsess.mesh, jsess.tf, jspec, jsess.cfg.vdi)(
        jshard(jnp.asarray(field), jsess.mesh), jsess._origin,
        jsess._spacing, jsess.camera)
    got = tseed(port.mesh, port.tf, tspec, cfg.vdi)(
        tshard(torch.from_numpy(field.copy()), port.mesh), port._origin,
        port._spacing, port.camera)
    a, b = np_(got.thr), np.asarray(want.thr)
    off = np.abs(a - b) > 1e-6
    assert off.mean() < 0.05, off.mean()
    pair = {(np.float32(1e-3), np.float32(0.0078125))}
    assert set(zip(a[off], b[off])) <= pair | {p[::-1] for p in pair}

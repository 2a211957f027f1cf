"""Parity of the port's scenario zoo (``scenarios/``), its in-process
steering consumer (``runtime/session.steer_session`` and the steered-TF
step cache) and the steering messages (``runtime/streaming.py``) with
the JAX package's, on the CPU.

The cases of ``tests/test_scenarios.py``: the registry, the configs, the
schedules, the vortex scenario steered end to end (its last payload held
against the reference's steered run from the same start state, at the
bar of the port's vortex session tests: rtol 1e-4, atol 1e-5), the
recompile-or-reuse counters over 13 frames equal to the reference's
(4 updates, 2 reuses, 3 builds) with ``scenario.tf_update`` on the
ledger, the hybrid and Lennard-Jones scenarios, the one-call run and the
camera message. The gather engine's rays take 32 samples here in both
packages (the counters do not depend on it). The messages and the TF
they build equal the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu import scenarios as jscn
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.runtime import streaming as jstream
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch import scenarios
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.runtime import session as tses
from scenery_insitu_tpu_torch.runtime import streaming as tstream
from scenery_insitu_tpu_torch.sim import vortex as tvx
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, np_, one_torch_thread)

CPU = "cpu"
TINY = ("sim.grid=[16,16,16]", "sim.steps_per_frame=1",
        "render.width=32", "render.height=32")
# one rank in both packages (the suite's JAX runs on 8 host devices, and
# the reference's session meshes every device by default)
VORTEX = TINY + ("slicer.engine=gather", "render.max_steps=32",
                 "obs.enabled=true", "mesh.num_devices=1")
FRAMES = 13


def _ring():
    """The port's start state of the vortex scenario, handed to both."""
    return np_(tvx.VortexFlow.init_ring((16, 16, 16),
                                        tvx.VortexParams.create(
                                            device=CPU), device=CPU).u)


def _capture(store):
    def sink(index, payload):
        store[index] = payload
    return sink


def _port_vortex(frames):
    got = {}
    sess = scenarios.make_session("vortex", extra_overrides=VORTEX,
                                  device=CPU, sinks=[_capture(got)])
    sess.sim.state = sess.sim.state._replace(u=torch.from_numpy(_ring()))
    payload = scenarios.run_steered(sess, scenarios.get("vortex"), frames)
    return sess, payload, got


@pytest.fixture(scope="module")
def jax_vortex():
    """The reference's steered vortex run over 13 frames from the port's
    start state: its payloads and counters."""
    jobs.clear_ledger()
    got = {}
    sess = jscn.make_session("vortex", extra_overrides=VORTEX,
                             sinks=[_capture(got)])
    sess.sim.state = sess.sim.state._replace(u=jnp.asarray(_ring()))
    jscn.run_steered(sess, jscn.get("vortex"), FRAMES)
    return dict(frames=got, counters=dict(sess.obs.counters),
                ledger={e["component"] for e in jobs.ledger()})


def test_registry_names_and_lookup():
    names = scenarios.names()
    assert names == jscn.names()
    for expected in ("gray_scott", "vortex", "hybrid", "lennard_jones"):
        assert expected in names
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.get("nope")
    with pytest.raises(ValueError, match="already registered"):
        scenarios.register(scenarios.get("vortex"))
    for n in names:
        a, b = scenarios.get(n), jscn.get(n)
        assert (a.overrides, a.bench_overrides, a.bench_frames,
                a.brick_parity) == (b.overrides, b.bench_overrides,
                                    b.bench_frames, b.brick_parity)


def test_make_config_applies_overrides():
    cfg = scenarios.make_config("vortex",
                                extra_overrides=("sim.grid=[8,8,8]",))
    assert cfg.sim.kind == "vortex"
    assert cfg.runtime.dataset == "vortex"
    assert cfg.sim.grid == (8, 8, 8)
    cfg = scenarios.make_config("hybrid")
    assert cfg.sim.kind == "hybrid"


def test_tf_schedule_and_dolly_validation():
    with pytest.raises(ValueError):
        scenarios.tf_schedule([], period=3)
    msgs = [{"type": "tf", "points": [[0.0, 0.0], [1.0, 0.5]],
             "colormap": "hot"}]
    hook = scenarios.tf_schedule(msgs, period=2)

    class _S:
        pass

    assert hook(_S(), 0) is None          # frame 0 keeps the session TF
    assert hook(_S(), 1) is None
    assert hook(_S(), 2) is msgs[0]
    # every built-in schedule fires the reference's messages
    for n in scenarios.names():
        a, b = scenarios.get(n).steering, jscn.get(n).steering
        if n == "lennard_jones":
            continue
        for f in range(13):
            assert a(_S(), f) == b(_S(), f), (n, f)


def test_vortex_scenario_steered_end_to_end(jax_vortex):
    """The vortex scenario runs through the whole session with its TF
    schedule firing over the steering consumer; its last payload equals
    the reference's steered run's frame 6."""
    sess, payload, _ = _port_vortex(7)
    assert {"vdi_color", "vdi_depth", "meta"} <= set(payload)
    assert payload["frame"] == 6
    assert np.isfinite(payload["vdi_color"]).all()
    # the period-3 schedule fired at frames 3 and 6
    assert sess.obs.counters.get("tf_updates", 0) == 2
    want = jax_vortex["frames"][6]
    assert_vdi_close(payload["vdi_color"], payload["vdi_depth"],
                     want["vdi_color"], want["vdi_depth"], 1e-4, 1e-5)


def test_tf_update_recompile_or_reuse(jax_vortex):
    """Cycling 2 TFs over 13 frames: 4 updates, but only 2 distinct looks
    build steps — the later updates restore cached steps
    (tf_steps_reused), and the first-contact rebuilds land on the
    scenario.tf_update ledger; the counters are the reference's."""
    tobs.clear_ledger()
    sess, _, got = _port_vortex(FRAMES)
    c = sess.obs.counters
    assert c.get("tf_updates", 0) == 4
    assert c.get("tf_steps_reused", 0) == 2
    # initial build + one per DISTINCT steered TF
    assert c.get("build_steps", 0) == 3
    for k in ("tf_updates", "tf_steps_reused", "build_steps"):
        assert c.get(k, 0) == jax_vortex["counters"].get(k, 0), k
    assert any(e["component"] == "scenario.tf_update"
               for e in tobs.ledger())
    assert "scenario.tf_update" in jax_vortex["ledger"]
    reused = [e for e in sess.obs.events if e.get("name") == "tf_update"
              and e["attrs"].get("reused")]
    assert len(reused) == 2
    assert set(got) == set(range(FRAMES))      # every frame delivered


def test_hybrid_scenario_multi_volume_smoke():
    scn = scenarios.get("hybrid")
    sess = scenarios.make_session(
        "hybrid", extra_overrides=TINY + ("sim.num_particles=64",),
        device=CPU)
    assert sess.mode == "hybrid"
    payload = scenarios.run_steered(sess, scn, 2)
    img = payload["image"]
    assert img.shape == (4, 32, 32)
    assert np.isfinite(img).all()
    assert float(np.abs(img).sum()) > 0.0


def test_lennard_jones_scenario_camera_steering():
    scn = scenarios.get("lennard_jones")
    sess = scenarios.make_session(
        "lennard_jones",
        extra_overrides=("sim.num_particles=256", "render.width=32",
                         "render.height=32", "sim.steps_per_frame=1"),
        device=CPU)
    assert sess.mode == "particles"
    eye0 = sess.camera.eye.clone()
    payload = scenarios.run_steered(sess, scn, 3)
    assert {"image", "depth"} <= set(payload)
    assert not torch.allclose(sess.camera.eye, eye0)
    # the dolly's message is the reference's on the same camera
    j = jcam.Camera.create(np_(eye0), fov_y_deg=50.0, near=0.3, far=20.0)
    t = tcam.Camera.create(np_(eye0), fov_y_deg=50.0, near=0.3, far=20.0,
                           device=CPU)

    class _S:
        pass

    a, b = _S(), _S()
    a.camera, b.camera = t, j
    got = scn.steering(a, 0)["eye"]
    want = jscn.get("lennard_jones").steering(b, 0)["eye"]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_run_one_call():
    payload = scenarios.run(
        "gray_scott", 2,
        extra_overrides=TINY + ("slicer.engine=gather",
                                "render.max_steps=32"), device=CPU)
    assert "vdi_color" in payload


def test_steer_session_camera_message():
    sess = scenarios.make_session(
        "gray_scott", extra_overrides=TINY + ("slicer.engine=gather",
                                              "render.max_steps=32"),
        device=CPU)
    tses.steer_session(sess, {"type": "camera", "eye": [0.5, 0.5, 2.0]})
    np.testing.assert_allclose(np_(sess.camera.eye), [0.5, 0.5, 2.0])
    seen = []
    sess.on_steer.append(lambda m: seen.append(m))
    tses.steer_session(sess, {"type": "custom", "x": 1})
    assert seen and seen[0]["x"] == 1
    sess.render_frame()


def test_steering_messages_match_reference():
    """make_camera_message, make_tf_message, tf_from_message and
    apply_steering give the reference's messages, TF knots and camera;
    equal TFs share a fingerprint and steps, a malformed ``tf`` message
    is ignored."""
    t = tcam.Camera.create((0.3, 0.4, 2.5), fov_y_deg=40.0, near=0.2,
                           far=9.0, device=CPU)
    j = jcam.Camera.create((0.3, 0.4, 2.5), fov_y_deg=40.0, near=0.2,
                           far=9.0)
    a, b = tstream.make_camera_message(t), jstream.make_camera_message(j)
    assert a.keys() == b.keys() and a["type"] == b["type"] == "camera"
    for k in set(a) - {"type"}:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    pts = [(0.0, 0.0), (0.2, 0.05), (0.6, 0.4), (1.0, 0.7)]
    msg = tstream.make_tf_message(pts, "viridis")
    assert msg == jstream.make_tf_message(pts, "viridis")
    tf = tstream.tf_from_message(msg, device=CPU)
    jtf_ = jstream.tf_from_message(msg)
    for x, y in zip(tf, jtf_):
        np.testing.assert_allclose(np_(x), np.asarray(y), rtol=1e-6,
                                   atol=1e-7)
    moved = {"type": "camera", "eye": [1.0, 2.0, 3.0], "fov_y": 0.5}
    cam, other = tstream.apply_steering(t, moved)
    jc, jo = jstream.apply_steering(j, moved)
    assert other == jo == {}
    for x, y in zip(cam, jc):
        np.testing.assert_allclose(np_(x), np.asarray(y), rtol=1e-6)
    assert tstream.apply_steering(t, {"type": "x"})[1] == {"x": {"type": "x"}}
    assert tses._tf_fingerprint(tf) == tses._tf_fingerprint(
        tstream.tf_from_message(dict(msg), device=CPU))
    assert tses._tf_fingerprint(tf) != tses._tf_fingerprint(
        tstream.tf_from_message(tstream.make_tf_message(pts, "hot"),
                                device=CPU))
    sess = scenarios.make_session(
        "gray_scott", extra_overrides=TINY + ("slicer.engine=gather",
                                              "render.max_steps=32"),
        device=CPU)
    tf0 = sess.tf
    tses.steer_session(sess, {"type": "tf", "points": "garbage"})
    assert sess.tf is tf0

"""The port's fleet telemetry side-channel (``obs/collector.py``) and
the sessions' observability hooks against the JAX package's, on the CPU.

- ``lineage`` and ``trace_ctx`` live in ``obs/collector.py`` and mint
  the reference's instants.
- A publisher of either package feeds a collector of either package
  (all four directions merge one trace); a dead collector's drops are
  counted and ledgered ``obs.collector``.
- ``InSituSession`` pumps a configured collector (the reference's
  ``tests/test_obs.py`` shapes: 2 ranks, 16^3, 32 x 24); its
  ``device_snapshot`` has the reference session's keys and
  ``unavailable`` texts on the same configurations; ``run(profile_dir=
  ...)`` writes a trace naming the phase scopes.
- ``SceneSession`` accepts ``obs.collector`` as the reference's does.
- The traced-fleet drill of ``tests/test_multihost.py`` runs on the
  port's ``testing/multiproc`` with 2 processes: every frame delivered
  and seen, one merged trace whose flow arrows cross the processes.

The module imports nothing of JAX at its top (the drill's workers import
it); the reference's collector and recorder import none either.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu.obs import collector as jcol
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.config import FrameworkConfig as TConfig
from scenery_insitu_tpu_torch.obs import collector as tcol
from scenery_insitu_tpu_torch.parallel.mesh import make_mesh
from scenery_insitu_tpu_torch.runtime import session as tses
from scenery_insitu_tpu_torch.testing import multiproc
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

CPU = "cpu"
PKG = {"ref": (jcol, jobs), "port": (tcol, tobs)}
FLEET_FRAMES = 6


@pytest.fixture(autouse=True)
def _isolate_obs():
    prev_t, prev_j = tobs.get_recorder(), jobs.get_recorder()
    tobs.clear_ledger()
    jobs.clear_ledger()
    yield
    tobs.set_recorder(prev_t)
    jobs.set_recorder(prev_j)
    tobs.clear_ledger()
    jobs.clear_ledger()


def _session_overrides(**kw):
    base = {"render.width": "32", "render.height": "24",
            "render.max_steps": "24", "vdi.max_supersegments": "6",
            "vdi.adaptive_iters": "2",
            "composite.max_output_supersegments": "8",
            "composite.adaptive_iters": "2", "sim.grid": "[16,16,16]",
            "sim.steps_per_frame": "2", "runtime.stats_window": "2",
            **kw}
    return [f"{k}={v}" for k, v in base.items()]


def _link(pub, col, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pub.linked and time.monotonic() < deadline:
        pub.probe()
        col.poll(10)
    assert pub.linked


# --------------------------------------------------------------- lineage

def test_lineage_instants_and_age():
    rec = tobs.Recorder(enabled=True)
    tobs.set_recorder(rec)
    tcol.lineage("publish", "send", 3)
    ctx = tcol.trace_ctx(3, src=1)
    tcol.lineage("publish", "recv", None, ctx=ctx)
    send, recv = [e for e in rec.events if e["name"] == "lineage"]
    assert send["attrs"]["stage"] == "publish"
    assert send["attrs"]["role"] == "send" and send["frame"] == 3
    assert recv["frame"] == 3 and recv["attrs"]["src"] == 1
    assert recv["attrs"]["t_origin"] == ctx["t"]
    assert recv["attrs"]["age_ms"] >= 0.0
    assert set(ctx) == set(jcol.trace_ctx(3, src=1))
    assert tcol.ARC_ORDER == jcol.ARC_ORDER
    # the delivery plane, the stream, the head and the server take the
    # helpers from here
    from scenery_insitu_tpu_torch.runtime import delivery, head, streaming
    from scenery_insitu_tpu_torch.serve import server
    assert delivery.lineage is tcol.lineage
    for mod in (head, streaming, server):
        assert mod.lineage is tcol.lineage
        assert mod.trace_ctx is tcol.trace_ctx


@pytest.mark.parametrize("pub_pkg,col_pkg", [
    ("port", "port"), ("port", "ref"), ("ref", "port"), ("ref", "ref")])
def test_publisher_collector_roundtrip(pub_pkg, col_pkg, tmp_path):
    """A publisher of one package into a collector of the other (or its
    own): the batch merges into ONE fleet trace with the span on its
    rank's track and the clock model bounded on loopback."""
    pytest.importorskip("zmq")
    pcol, pobs = PKG[pub_pkg]
    ccol, _ = PKG[col_pkg]
    col = ccol.Collector()
    pub = pcol.ObsPublisher(col.endpoint, col.hb_endpoint, rank=2,
                            interval_s=0.0)
    try:
        _link(pub, col)
        assert col.batches == 0            # probes carry no payload
        rec = pobs.Recorder(enabled=True, rank=2)
        with rec.span("frame", frame=0):
            pass
        pcol.lineage("publish", "send", 0, rec=rec)
        assert pub.pump(rec, force=True)
        # the batch crosses PUB/SUB asynchronously: wait for it (a loaded
        # host can hold it past the reference test's 2 s)
        deadline = time.monotonic() + 20.0
        while col.batches == 0 and time.monotonic() < deadline:
            col.poll(20)
        assert col.batches == 1
        merged = col.merged_events()
        assert any(e["name"] == "frame" and e["rank"] == 2 for e in merged)
        assert col.frames_seen() == [0]
        assert pub.rtt > 0.0 and abs(pub.clock_offset) < 5.0
        path = col.export_fleet_trace(str(tmp_path / "fleet.json"))
        doc = json.load(open(path))
        assert doc["otherData"]["ranks"] == [2]
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert [(e["name"], e["pid"]) for e in spans] == [("frame", 2)]
        assert rec.counters.get("obs_batches_published") == 1
    finally:
        pub.close()
        col.close()


def test_publisher_to_dead_collector_drops_are_ledgered():
    pytest.importorskip("zmq")
    col = tcol.Collector()
    ep, hb = col.endpoint, col.hb_endpoint
    col.close()                            # the collector is gone
    pub = tcol.ObsPublisher(ep, hb, rank=0, interval_s=0.0)
    rec = tobs.Recorder(enabled=True)
    try:
        for i in range(5):
            with rec.span("frame", frame=i):
                pass
            pub.pump(rec, force=True)      # never raises, never blocks
        assert pub.drops > 0
        assert rec.counters.get("obs_batch_drops", 0) > 0
        assert any(e["component"] == "obs.collector"
                   for e in tobs.ledger())
    finally:
        pub.close()


# --------------------------------------------------------------- sessions

def test_session_pumps_configured_collector():
    pytest.importorskip("zmq")
    col = tcol.Collector()
    try:
        cfg = TConfig().with_overrides(*_session_overrides(**{
            "obs.enabled": "true", "obs.collector": col.endpoint,
            "obs.collector_hb": col.hb_endpoint,
            "obs.collector_interval_s": "0.001"}))
        sess = tses.InSituSession(cfg, mesh=make_mesh(2, device=CPU))
        _link(sess._obs_pub, col)
        sess.run(3)
        for _ in range(100):
            col.poll(20)
            if col.batches > 0 and any(
                    e["name"] == "sim" for e in col.merged_events()):
                break
        assert col.batches > 0
        names = {e["name"] for e in col.merged_events()}
        assert "sim" in names              # the session's phases arrived
        assert sess.obs.counters.get("obs_batches_published", 0) > 0
    finally:
        col.close()


SNAPSHOT_CONFIGS = {
    "gather": {"slicer.engine": "gather", "vdi.adaptive_mode": "histogram"},
    "mxu_temporal": {"slicer.engine": "mxu",
                     "vdi.adaptive_mode": "temporal"},
    "mxu_histogram": {"slicer.engine": "mxu",
                      "vdi.adaptive_mode": "histogram"},
    "plain_gather": {"slicer.engine": "gather",
                     "runtime.generate_vdis": "false"},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOT_CONFIGS))
def test_device_snapshot_matches_reference_keys(name):
    """One frame on 2 ranks in both packages: the same snapshot keys;
    an ``unavailable`` entry has the reference's text word for word;
    an available one counts bytes (the reference's is XLA's cost
    analysis, the port's its dispatch count)."""
    from scenery_insitu_tpu.config import FrameworkConfig as JConfig
    from scenery_insitu_tpu.parallel.mesh import make_mesh as jmesh
    from scenery_insitu_tpu.runtime import session as jses

    over = _session_overrides(**SNAPSHOT_CONFIGS[name])
    jsess = jses.InSituSession(JConfig().with_overrides(*over),
                               mesh=jmesh(2))
    jsess.run(1)
    want = jsess.device_snapshot()
    tsess = tses.InSituSession(TConfig().with_overrides(*over),
                               mesh=make_mesh(2, device=CPU))
    tsess.run(1)
    got = tsess.device_snapshot()
    assert set(got) == set(want) and got, (got, want)
    for key, snap in want.items():
        if snap is not None and snap.get("source") == "unavailable":
            assert got[key] == snap, key
        else:
            assert got[key]["source"] == "torch_dispatch_count", got[key]
            assert got[key]["bytes_accessed"] > 0


def test_run_profile_dir_writes_a_trace(tmp_path):
    cfg = TConfig().with_overrides(*_session_overrides(
        **{"slicer.engine": "mxu", "vdi.adaptive_mode": "temporal"}))
    sess = tses.InSituSession(cfg, mesh=make_mesh(2, device=CPU))
    payload = sess.run(2, profile_dir=str(tmp_path / "prof"))
    assert payload["frame"] == 1
    with open(tmp_path / "prof" / "trace.json") as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"sitpu_march", "sitpu_exchange", "sitpu_resegment"} <= names


def test_scene_session_accepts_collector_as_reference():
    """Both packages' scene sessions on one config with ``obs.collector``
    set: both render (neither pumps a publisher), and the frames agree
    within the scene parity bar of ``tests/test_torch_scene.py``
    (rtol 2e-4, atol 2e-5 against the reference's jitted session)."""
    from scenery_insitu_tpu.config import FrameworkConfig as JConfig
    from scenery_insitu_tpu.core.volume import procedural_volume
    from scenery_insitu_tpu.runtime.scene_session import SceneSession as JS
    from scenery_insitu_tpu_torch.runtime.scene_session import (
        SceneSession as TS)
    from tests.test_torch_pipeline import assert_vdi_close

    over = ("render.width=32", "render.height=24", "render.max_steps=24",
            "vdi.adaptive_iters=1", "vdi.max_supersegments=4",
            "composite.max_output_supersegments=6",
            "composite.adaptive_iters=1", "slicer.engine=mxu",
            "slicer.matmul_dtype=f32", "runtime.dataset=procedural",
            "obs.collector=tcp://127.0.0.1:1")
    j = procedural_volume(24, kind="blobs", seed=5)
    data, origin = np.asarray(j.data), np.asarray(j.origin)
    spacing = np.asarray(j.spacing)
    jsess = JS(JConfig().with_overrides(*over))
    tsess = TS(TConfig().with_overrides(*over), device=CPU)
    for sess in (jsess, tsess):
        sess.update_data(0, [data], [origin], spacing)
    want, got = jsess.render_frame(), tsess.render_frame()
    assert not hasattr(tsess, "_obs_pub") and not hasattr(jsess, "_obs_pub")
    assert got["frame"] == want["frame"] == 0
    assert_vdi_close(got["vdi_color"], got["vdi_depth"],
                     want["vdi_color"], want["vdi_depth"], 2e-4, 2e-5)


# ------------------------------------------------------ the traced fleet

def _entry_fleet(ctx):
    """The traced-fleet drill on the port: process 1 publishes a VDI
    stream (trace context in every header), process 0 subscribes and
    hosts the collector; both pump their recorders into it, and process
    0 exports the ONE merged trace and the verdicts the test reads."""
    from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
    from scenery_insitu_tpu_torch.parallel import multihost
    from scenery_insitu_tpu_torch.runtime.streaming import (StreamDrop,
                                                            VDIPublisher,
                                                            VDISubscriber)

    pid = ctx.process_id
    rec = tobs.Recorder(enabled=True, rank=pid)
    tobs.set_recorder(rec)
    col = None
    if pid == 0:
        col = tcol.Collector()
        multihost.kv_put_bytes("fleet/obs_ep", col.endpoint.encode())
        multihost.kv_put_bytes("fleet/hb_ep", col.hb_endpoint.encode())
    multihost.barrier("fleet_col")
    opub = tcol.ObsPublisher(
        multihost.kv_get_bytes("fleet/obs_ep").decode(),
        multihost.kv_get_bytes("fleet/hb_ep").decode(),
        rank=pid, interval_s=0.0)

    if pid == 1:
        rng = np.random.default_rng(17)
        kk, hh, ww = 3, 10, 12
        vdi = VDI(torch.from_numpy(rng.random((kk, 4, hh, ww)).astype(
                      np.float32)),
                  torch.from_numpy(rng.random((kk, 2, hh, ww)).astype(
                      np.float32)))
        meta = VDIMetadata.create(torch.eye(4), torch.eye(4),
                                  volume_dims=(8, 8, 8),
                                  window_dims=(ww, hh), index=0)
        pub = VDIPublisher(bind="tcp://127.0.0.1:0", codec="zlib")
        multihost.kv_put_bytes("fleet/vdi_ep", pub.endpoint.encode())
        multihost.barrier("fleet_eps")
        multihost.barrier("fleet_subs")
        deadline = time.monotonic() + 20.0
        while not opub.linked and time.monotonic() < deadline:
            opub.probe()
            time.sleep(0.02)
        multihost.barrier("fleet_linked")
        for i in range(FLEET_FRAMES):
            with rec.span("frame", frame=i):
                pub.publish(vdi, meta._replace(
                    index=torch.tensor(i, dtype=torch.int32)))
            opub.pump(rec, force=True)
            time.sleep(0.03)
        multihost.barrier("fleet_frames", timeout_ms=120_000)
        opub.close(rec)
        pub.close()
        return

    multihost.barrier("fleet_eps")
    sub = VDISubscriber(
        connect=multihost.kv_get_bytes("fleet/vdi_ep").decode())
    time.sleep(0.5)                        # zmq slow-joiner settle
    multihost.barrier("fleet_subs")
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        col.poll(10)
        opub.probe()
        if opub.linked and sorted(col.ranks) == [0, 1]:
            break
    multihost.barrier("fleet_linked")
    frames_got = []
    deadline = time.monotonic() + 60.0
    while len(frames_got) < FLEET_FRAMES and time.monotonic() < deadline:
        got = sub.receive_tile(timeout_ms=200)
        col.poll(0)
        opub.pump(rec, force=True)
        if got is None or isinstance(got, StreamDrop):
            continue
        frames_got.append(int(np.asarray(got[1].index)))
    multihost.barrier("fleet_frames", timeout_ms=120_000)
    opub.close(rec)
    for _ in range(20):
        col.poll(50)
    col.export_fleet_trace(os.path.join(ctx.workdir, "fleet_trace.json"))
    arcs_monotone, arcs_cross = [], []
    for f in col.frames_seen():
        arc = col.frame_arc(f)
        ts = [e["t_us"] for e in arc]
        arcs_monotone.append(ts == sorted(ts))
        arcs_cross.append(len({e["rank"] for e in arc}) >= 2)
    json.dump({"frames_delivered": sorted(frames_got),
               "frames_seen": col.frames_seen(),
               "ranks": sorted(col.ranks),
               "arcs_monotone": arcs_monotone,
               "arcs_cross_process": arcs_cross,
               "batches": col.batches},
              open(os.path.join(ctx.workdir, "fleet_results.json"), "w"))
    sub.close()
    col.close()


@pytest.mark.multiproc
def test_traced_fleet_drill(tmp_path):
    pytest.importorskip("zmq")
    results = multiproc.run_multiproc(
        "tests.test_torch_collector:_entry_fleet", n_procs=2,
        ranks_per_proc=1, workdir=str(tmp_path), timeout_s=300.0,
        device=CPU)
    for r in results:
        assert r.ok, f"worker {r.process_id} failed:\n{r.output}"
    data = json.load(open(tmp_path / "fleet_results.json"))
    assert data["frames_delivered"] == list(range(FLEET_FRAMES))
    assert data["frames_seen"] == list(range(FLEET_FRAMES))
    assert data["ranks"] == [0, 1] and data["batches"] > 0
    assert all(data["arcs_monotone"]) and all(data["arcs_cross_process"])
    trace = json.load(open(tmp_path / "fleet_trace.json"))
    evs = trace["traceEvents"]
    assert {e.get("pid") for e in evs if e.get("ph") == "M"} == {0, 1}
    starts = {e["id"]: e for e in evs
              if e.get("ph") == "s" and e.get("cat") == "lineage"}
    ends = {e["id"]: e for e in evs
            if e.get("ph") == "f" and e.get("cat") == "lineage"}
    assert starts and set(starts) == set(ends)
    assert any(starts[i]["pid"] != ends[i]["pid"] for i in starts)
    cm = trace["otherData"]["clock_model"]
    assert set(cm) == {"0", "1"}
    assert all(m["error_bound_ms"] < 1000.0 for m in cm.values())

"""Parity of the port's mesh topology and two-level composite with the
JAX package's, on the CPU.

The reference tests' scene (``tests/test_topology.py``): the 16^3
procedural blobs, 8 ranks, the mxu march (f32 matmuls, scale 2, 16 x 16
output), K = 6 into 8 output slots. The config and resolution helpers
give the reference's values and messages. On a 2 x 4 (and 4 x 2) mesh
the port's hierarchical step, ring tile waves, temporal frames with
their threshold maps, and plan match the reference's same hierarchical
steps at the reference's mxu gate (1e-5 absolute on colours, live
depths and thresholds), and the port's own flat frame column for column
(bit for bit here). The lossy DCN wires hold 60 dB against the
reference's and the reference's 30 dB floor against the flat frame. The
build records the reference's counters and events, the traffic model
is the reference's, and the session builds the two-level mesh, resumes
bit for bit and cross-loads the reference's checkpoint. Where the
reference test runs its gather engine (A9), the reference's mxu step
under the same topology stands in. Each configuration runs once in each
package (module-scoped fixtures)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel import hier as jhier
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu.parallel import topology as jtop
from scenery_insitu_tpu.runtime import checkpoint as jck
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import hier as thier
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.parallel import topology as ttop
from scenery_insitu_tpu_torch.runtime import checkpoint as tck
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401
from tests.test_torch_session import (_capture, assert_payloads_close,
                                      assert_payloads_equal, jax_session,
                                      port_session)

CPU = "cpu"
N = 8
EYE = (0.0, 0.2, 4.0)
GATE = 1e-5                  # the reference's mxu gate, absolute
DCN_FLOOR_DB = 30.0          # the reference's lossy-DCN floor vs flat
PORT_DB = 60.0               # a lossy wire, port against reference
PLAN = (3, 1, 2, 2, 2, 2, 2, 2)
SESSION_FRAMES = 3
HIER = {"topology.num_hosts": "2", "obs.enabled": "true"}


# ----------------------------------------------------------------- helpers


def _pkg(name):
    if name == "jax":
        return dict(cfg=jcfg, cam=jcam, tf=jtf, vol=jvol, sl=jsl,
                    mesh=jmesh, pipe=jpipe, top=jtop, obs=jobs, kw={},
                    arr=np.asarray, spec_cfg=dict(matmul_dtype="f32"))
    return dict(cfg=tcfg, cam=tcam, tf=ttf, vol=tvol, sl=tsl, mesh=tmesh,
                pipe=tpipe, top=ttop, obs=tobs, kw={"device": CPU}, arr=np_,
                spec_cfg={})


def _mesh(p, hosts, dcn="f32"):
    """(mesh, TopologyConfig or None) of N ranks, ``hosts`` domains."""
    if hosts == 1:
        return p["mesh"].make_mesh(N, **p["kw"]), None
    tc = p["cfg"].TopologyConfig(num_hosts=hosts, dcn_wire=dcn)
    if p["kw"]:
        mesh, _ = p["top"].make_topology_mesh(
            tc, p["cfg"].MeshConfig(num_devices=N), **p["kw"])
    else:
        mesh, _ = p["top"].make_topology_mesh(tc)
    return mesh, tc


def _scene(p):
    vol = p["vol"].procedural_volume(16, kind="blobs", **p["kw"])
    cam = p["cam"].Camera.create(EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                                 **p["kw"])
    spec = p["sl"].make_spec(cam, tuple(vol.data.shape),
                             p["cfg"].SliceMarchConfig(scale=2.0,
                                                       **p["spec_cfg"]),
                             multiple_of=N)
    return vol, cam, spec, p["tf"].TransferFunction.ramp(0.05, 0.8, 0.7,
                                                         **p["kw"])


def run(pkg, hosts=1, temporal=False, frames=2, dcn="f32", plan=None,
        record=False, **comp):
    """The 8-rank mxu step of package ``pkg`` on ``hosts`` domains: one
    frame, or the seed and ``frames`` temporal frames. Returns
    dict(frames=[(color, depth, thr maps or None)], events, counters);
    the last two only under ``record``."""
    p = _pkg(pkg)
    vol, cam, spec, tf = _scene(p)
    mesh, tc = _mesh(p, hosts, dcn)
    vc = p["cfg"].VDIConfig(max_supersegments=6, **(
        dict(adaptive_mode="temporal") if temporal
        else dict(adaptive_iters=2)))
    cc = p["cfg"].CompositeConfig(max_output_supersegments=8,
                                  adaptive_iters=2, **comp)
    decomp = {} if plan is None else {"plan": plan}
    args = (p["pipe"].shard_volume(vol.data, mesh) if pkg == "jax"
            else tmesh.shard_volume(vol.data, mesh),
            vol.origin, vol.spacing, cam)
    rec = p["obs"].Recorder(enabled=True)
    prev = p["obs"].get_recorder()
    p["obs"].set_recorder(rec if record else p["obs"].Recorder(
        enabled=False))
    try:
        out = []
        if not temporal:
            vdi, _ = p["pipe"].distributed_vdi_step_mxu(
                mesh, tf, spec, vc, cc, topology=tc, **decomp)(*args)
            out.append((p["arr"](vdi.color), p["arr"](vdi.depth), None))
        else:
            thr = p["pipe"].distributed_initial_threshold_mxu(
                mesh, tf, spec, vc, **decomp)(*args)
            step = p["pipe"].distributed_vdi_step_mxu_temporal(
                mesh, tf, spec, vc, cc, topology=tc, **decomp)
            for _ in range(frames):
                (vdi, _), thr = step(*args, thr)
                out.append((p["arr"](vdi.color), p["arr"](vdi.depth),
                            [p["arr"](x) for x in thr]))
    finally:
        p["obs"].set_recorder(prev)
    return dict(frames=out, events=list(rec.events),
                counters=dict(rec.counters))


# the configurations both packages run: name -> run() arguments
CONFIGS = {
    "h2": dict(hosts=2, record=True),
    "h4": dict(hosts=4),
    "waves": dict(hosts=2, exchange="ring", schedule="waves", wave_tiles=2),
    "temporal": dict(hosts=2, temporal=True),
    "bf16": dict(hosts=2, dcn="bf16"),
    "qpack8": dict(hosts=2, dcn="qpack8"),
    "plan": dict(hosts=2, plan=PLAN, rebalance="occupancy",
                 rebalance_min_depth=1, rebalance_quantum=1),
}
# the port's flat twins
FLAT = {
    "flat": dict(),
    "flat_ring": dict(exchange="ring"),
    "flat_temporal": dict(temporal=True),
    "flat_plan": dict(plan=PLAN, rebalance="occupancy",
                      rebalance_min_depth=1, rebalance_quantum=1),
}


class _Runs:
    """Each configuration run once a package, on first use."""

    def __init__(self, pkg, table):
        self.pkg, self.table, self.done = pkg, table, {}

    def __getitem__(self, name):
        if name not in self.done:
            self.done[name] = run(self.pkg, **self.table[name])
        return self.done[name]


@pytest.fixture(scope="module")
def ref():
    return _Runs("jax", CONFIGS)


@pytest.fixture(scope="module")
def port():
    return _Runs("port", {**CONFIGS, **FLAT})


def assert_frames_close(got, want, atol=GATE, thr=True):
    """Frame by frame: colours within ``atol``, the same slots live,
    live depths within ``atol``, threshold maps within ``atol``
    (absolute; 0 asks for equality)."""
    assert len(got) == len(want)
    for (gc, gd, gt), (wc, wd, wt) in zip(got, want):
        np.testing.assert_allclose(gc, wc, rtol=0, atol=atol)
        live = np.isfinite(wd)
        assert (np.isfinite(gd) == live).all(), "VDI slot liveness"
        np.testing.assert_allclose(gd[live], wd[live], rtol=0, atol=atol)
        if thr and wt is not None:
            for a, b in zip(gt, wt):
                np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak ** 2 / mse)


# --------------------------------------------------- config + resolution


def test_config_validation_matches_reference():
    for kw, word in ((dict(num_hosts=0), "num_hosts"),
                     (dict(domain_size=-1), "domain_size"),
                     (dict(dcn_wire="f16"), "dcn_wire"),
                     (dict(hosts_axis=""), "hosts_axis")):
        with pytest.raises(ValueError, match=word) as a:
            jcfg.TopologyConfig(**kw)
        with pytest.raises(ValueError, match=word) as b:
            tcfg.TopologyConfig(**kw)
        assert str(a.value) == str(b.value)


def test_resolution_and_messages_match_reference():
    """``domain_size`` must tile the ranks ("tile"), the axes must be
    "distinct"; a 2-host split of 8 resolves as the reference's."""
    for kw in (dict(num_hosts=3), dict(num_hosts=2, domain_size=3),
               dict(num_hosts=2, hosts_axis="ranks")):
        with pytest.raises(ValueError) as a:
            jtop.resolve_topology(jcfg.TopologyConfig(**kw), 8)
        with pytest.raises(ValueError, match="tile|distinct") as b:
            ttop.resolve_topology(tcfg.TopologyConfig(**kw), 8)
        assert str(a.value) == str(b.value)
    for hosts in (2, 4):
        want = jtop.resolve_topology(jcfg.TopologyConfig(num_hosts=hosts), 8)
        got = ttop.resolve_topology(tcfg.TopologyConfig(num_hosts=hosts), 8)
        assert tuple(got) == tuple(want)
        assert (got.n_ranks, got.flat_axis, got.out_axis) == \
            (want.n_ranks, want.flat_axis, want.out_axis) == \
            (8, ("hosts", "ranks"), ("ranks", "hosts"))


def test_single_host_resolves_flat_with_inert_ledger():
    tobs.clear_ledger()
    assert ttop.resolve_topology(tcfg.TopologyConfig(), 8) is None
    assert tobs.ledger() == []
    assert ttop.resolve_topology(tcfg.TopologyConfig(num_hosts=1,
                                                     domain_size=4), 8) is None
    rows = [e for e in tobs.ledger() if e["component"] == "topology.hier"]
    jobs.clear_ledger()
    jtop.resolve_topology(jcfg.TopologyConfig(num_hosts=1, domain_size=4), 8)
    want = [e for e in jobs.ledger() if e["component"] == "topology.hier"]
    assert rows and [(e["from"], e["to"], e["reason"]) for e in rows] == \
        [(e["from"], e["to"], e["reason"]) for e in want]


def test_make_topology_mesh_shapes():
    mc = tcfg.MeshConfig(num_devices=N)
    mesh, topo = ttop.make_topology_mesh(tcfg.TopologyConfig(num_hosts=2),
                                         mc, device=CPU)
    jm, _ = jtop.make_topology_mesh(jcfg.TopologyConfig(num_hosts=2))
    assert mesh.axis_names == tuple(jm.axis_names) == ("hosts", "ranks")
    assert (mesh.num_hosts, mesh.domain_size) == \
        (jm.shape["hosts"], jm.shape["ranks"]) == (2, 4)
    assert mesh.n == 8
    assert (mesh.hosts_axis, mesh.ranks_axis) == ("hosts", "ranks")
    assert topo.num_hosts == 2 and topo.domain_size == 4
    flat, none = ttop.make_topology_mesh(tcfg.TopologyConfig(), mc,
                                         device=CPU)
    assert flat == tmesh.make_mesh(N, device=CPU) and none is None
    assert flat.hosts_axis is None and flat.domain_size == N
    # positional construction and make_mesh keep their flat form
    assert tmesh.Mesh(4, torch.device(CPU)).axis_names == ("ranks",)
    with pytest.raises(ValueError, match="tile"):
        ttop.make_topology_mesh(tcfg.TopologyConfig(num_hosts=2),
                                device=CPU)      # 0 devices = one rank


def test_topology_of_mismatch_raises_as_reference():
    mesh, _ = ttop.make_topology_mesh(tcfg.TopologyConfig(num_hosts=2),
                                      tcfg.MeshConfig(num_devices=N),
                                      device=CPU)
    jm, _ = jtop.make_topology_mesh(jcfg.TopologyConfig(num_hosts=2))
    for got_args, want_args, word in (
            ((mesh, tcfg.TopologyConfig(num_hosts=4)),
             (jm, jcfg.TopologyConfig(num_hosts=4)), "disagrees"),
            ((tmesh.make_mesh(N, device=CPU),
              tcfg.TopologyConfig(num_hosts=2)),
             (jmesh.make_mesh(N), jcfg.TopologyConfig(num_hosts=2)),
             "flat 1-D")):
        with pytest.raises(ValueError) as a:
            jtop.topology_of(*want_args)
        with pytest.raises(ValueError, match=word) as b:
            ttop.topology_of(*got_args)
        assert str(a.value) == str(b.value)


def test_resolve_mesh_topology_views():
    mesh, _ = ttop.make_topology_mesh(tcfg.TopologyConfig(num_hosts=2),
                                      tcfg.MeshConfig(num_devices=N),
                                      device=CPU)
    axis, n, topo = ttop.resolve_mesh_topology(mesh)
    assert axis == ("hosts", "ranks") and n == 8
    assert isinstance(topo, ttop.Topology) and topo.dcn_wire == "f32"
    _, _, topo = ttop.resolve_mesh_topology(
        mesh, tcfg.TopologyConfig(num_hosts=2, dcn_wire="qpack8"))
    assert topo.dcn_wire == "qpack8"
    axis, n, topo = ttop.resolve_mesh_topology(tmesh.make_mesh(4,
                                                               device=CPU))
    assert axis == "ranks" and n == 4 and topo is None


# ------------------------------------------------------ the mxu steps


@pytest.mark.parametrize("name", ["h2", "h4"])
def test_hier_step_matches_reference_and_flat(name, ref, port):
    """2 x 4 and 4 x 2: the reference's hierarchical step at its gate,
    and the port's flat frame column for column."""
    got = port[name]["frames"]
    assert_frames_close(got, ref[name]["frames"])
    flat = port["flat"]["frames"]
    assert_frames_close(got, flat, atol=0.0)
    assert int(np.isfinite(got[0][1]).sum()) > 0


def test_hier_columns_in_natural_order(port):
    """The blocks come back in ``out_axis`` order: every column equals
    the flat frame's same column, and the hosts-major order would have
    moved sub-blocks (the check would see it)."""
    got, flat = port["h2"]["frames"][0][0], port["flat"]["frames"][0][0]
    w = got.shape[-1]
    sub = w // N
    for col in range(w):
        np.testing.assert_array_equal(got[..., col], flat[..., col])
    # rank (h, d)'s block sits at d*H + h; hosts-major h*D + d differs
    hosts_major = np.concatenate(
        [got[..., (d * 2 + h) * sub:(d * 2 + h + 1) * sub]
         for h in range(2) for d in range(4)], axis=-1)
    assert not np.array_equal(hosts_major, flat)


def test_hier_waves_match_reference_and_flat(ref, port):
    """Ring tile waves x the hierarchy: every wave runs the two-level
    composite; the frame matches the reference's and the flat ring
    frame."""
    got = port["waves"]["frames"]
    assert_frames_close(got, ref["waves"]["frames"])
    assert_frames_close(got, port["flat_ring"]["frames"])


def test_hier_temporal_carry_matches_reference_and_flat(ref, port):
    """Seed and two temporal frames: the VDIs and the threshold maps in
    flat rank order, against the reference's and the port's flat
    frames."""
    got = port["temporal"]["frames"]
    assert len(got) == 2 and got[0][2][0].shape[0] == N * got[0][0].shape[-2]
    assert_frames_close(got, ref["temporal"]["frames"])
    assert_frames_close(got, port["flat_temporal"]["frames"])


@pytest.mark.parametrize("dcn", ["bf16", "qpack8"])
def test_hier_lossy_dcn_wire_psnr(dcn, ref, port):
    """A lossy DCN wire quantizes the merged D·K accumulator against one
    scale: 60 dB from the reference's same step, and the reference's
    30 dB floor against the flat frame, without equalling it."""
    got = port[dcn]["frames"][0][0]
    assert _psnr(got, ref[dcn]["frames"][0][0]) >= PORT_DB
    flat = port["flat"]["frames"][0][0]
    assert DCN_FLOOR_DB <= _psnr(got, flat) < float("inf")


def test_hier_plan_matches_reference_and_flat_plan(ref, port):
    """A render plan under 2 hosts reslabs over the flat rank order: the
    reference's planned hierarchical step, and the port's flat planned
    frame column for column."""
    got = port["plan"]["frames"]
    assert_frames_close(got, ref["plan"]["frames"])
    assert_frames_close(got, port["flat_plan"]["frames"], atol=0.0)


def test_hier_geometry_rejected_at_build():
    """A width the two-level split does not tile fails at build, with
    the reference's message."""
    errors = []
    for pkg in ("jax", "port"):
        p = _pkg(pkg)
        vol, cam, spec, tf = _scene(p)
        spec = dataclasses.replace(spec, ni=12)
        mesh, tc = _mesh(p, 2)
        with pytest.raises(ValueError, match="divisible") as e:
            p["pipe"].distributed_vdi_step_mxu(mesh, tf, spec, topology=tc)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------ obs + the model


def test_hier_build_counters_and_events_match_reference(ref, port):
    got, want = port["h2"], ref["h2"]
    for key in ("hier_composite_builds", "dcn_hops_built"):
        assert got["counters"][key] == want["counters"][key] == 1, key
    assert "ring_exchange_builds" not in got["counters"]

    def named(run, name):
        return [e["attrs"] for e in run["events"] if e.get("name") == name]

    ev = named(got, "hier_composite_build")
    assert ev == named(want, "hier_composite_build")
    assert ev[0]["hosts"] == 2 and ev[0]["domain_size"] == 4
    assert ev[0]["dcn"]["dcn_bytes_sent_per_host"] > 0
    hops = named(got, "dcn_hop")
    assert hops == named(want, "dcn_hop")
    assert hops and all(h["wire"] == "f32" for h in hops)


def test_hier_ring_build_counts_hops_per_level():
    """Under a level-1 ring the build counts D - 1 ICI hops and H - 1
    DCN hops, each ring under its own names; a lossy DCN wire counts
    its encode."""
    p = _pkg("port")
    vol, cam, spec, tf = _scene(p)
    mesh, tc = _mesh(p, 2, dcn="qpack8")
    rec = tobs.Recorder(enabled=True)
    prev = tobs.set_recorder(rec)
    try:
        tpipe.distributed_vdi_step_mxu(
            mesh, tf, spec, comp_cfg=tcfg.CompositeConfig(exchange="ring"),
            topology=tc)
    finally:
        tobs.set_recorder(prev)
    assert rec.counters["ring_steps_built"] == 3
    assert rec.counters["dcn_hops_built"] == 1
    assert rec.counters["wire_encode_builds"] == 1
    assert [e["attrs"]["wire"] for e in rec.events
            if e.get("name") == "dcn_hop"] == ["qpack8"]


@pytest.mark.parametrize("args", [
    (2, 4, 6, 16, 16, "f32", 0), (2, 4, 6, 16, 16, "qpack8", 0),
    (2, 4, 6, 16, 16, "f32", 8), (2, 4, 6, 16, 16, "f32", 64),
    (4, 2, 16, 640, 640, "bf16", 0), (2, 4, 16, 640, 640, "f32", 32)])
def test_modeled_dcn_traffic_matches_reference(args):
    h, d, k, hh, w, wire, slots = args
    got = thier.modeled_dcn_traffic(h, d, k, hh, w, dcn_wire=wire,
                                    ring_slots=slots)
    assert got == jhier.modeled_dcn_traffic(h, d, k, hh, w, dcn_wire=wire,
                                            ring_slots=slots)
    if args[:6] == (2, 4, 6, 16, 16, "f32"):
        # 24 slots a pixel, sub-block 2 columns wide, 24 B a slot, 1 hop
        assert got["slots_per_pixel"] == (8 if slots == 8 else 24)
        if not slots:
            assert got["dcn_bytes_sent_per_rank"] == 1 * 24 * 16 * 2 * 24
            assert got["dcn_bytes_sent_per_host"] == \
                4 * got["dcn_bytes_sent_per_rank"]


# ------------------------------------------------------------ the session


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The reference's 2 x 4 session (temporal, 16^3 Gray-Scott) and the
    port's: payloads of frames 0..2, the reference's checkpoint after
    frame 1, and the sessions."""
    out = {}
    path = str(tmp_path_factory.mktemp("hier") / "jax.npz")
    frames = {}
    js = jax_session(N, "temporal", **HIER)
    js.sinks.append(_capture(frames))
    js.run(SESSION_FRAMES - 1)
    jck.save_session(js, path)
    js.run(1)
    out["jax"] = dict(frames=frames, ckpt=path, sess=js)
    frames = {}
    ts = port_session(N, "temporal", sinks=[_capture(frames)], **HIER)
    ts.run(SESSION_FRAMES)
    out["port"] = dict(frames=frames, sess=ts)
    return out


def test_session_hier_traced_frame(sessions):
    """The 2-host session builds the 2-D mesh, counts the two-level
    build, and its frames are the reference's."""
    sess, js = sessions["port"]["sess"], sessions["jax"]["sess"]
    assert sess.mesh.axis_names == tuple(js.mesh.axis_names) == \
        ("hosts", "ranks")
    assert sess._n_ranks == js._n_ranks == N
    assert sess._topo.num_hosts == 2 and sess._topo.domain_size == 4
    assert sess.obs.counters["hier_composite_builds"] >= 1
    assert sess.obs.counters["dcn_hops_built"] >= 1
    got, want = sessions["port"]["frames"], sessions["jax"]["frames"]
    assert_payloads_close(got, want, range(SESSION_FRAMES))
    assert np.isfinite(got[SESSION_FRAMES - 1]["vdi_color"]).all()


def test_session_flat_default_unchanged():
    from scenery_insitu_tpu.runtime import session as jses

    sess = port_session(N, "temporal", state=False)
    js = jses.InSituSession(jcfg.FrameworkConfig().with_overrides(
        "sim.grid=[16,16,16]"))
    assert sess.mesh.axis_names == tuple(js.mesh.axis_names) == ("ranks",)
    assert sess._topo is None and js._topo is None
    assert sess._n_ranks == js._n_ranks == N


def test_session_hier_checkpoint_roundtrip(sessions, tmp_path):
    """The header records the total rank count; the port's resume
    continues bit for bit, and the reference's checkpoint resumes in
    the port at the session bar."""
    path = str(tmp_path / "hier.npz")
    a = port_session(N, "temporal", **HIER)
    a.run(SESSION_FRAMES - 1)
    tck.save_session(a, path)
    with np.load(path) as z:
        assert json.loads(bytes(z["__header__"]).decode())[
            "mesh_devices"] == N
    b = port_session(N, "temporal", state=False, **HIER)
    tck.load_session(b, path)
    assert b.frame_index == a.frame_index == SESSION_FRAMES - 1
    got = {}
    b.sinks.append(_capture(got))
    b.run(1)
    last = SESSION_FRAMES - 1
    assert_payloads_equal(got, {last: sessions["port"]["frames"][last]})
    c = port_session(N, "temporal", state=False, **HIER)
    tck.load_session(c, sessions["jax"]["ckpt"])
    got = {}
    c.sinks.append(_capture(got))
    c.run(1)
    assert_payloads_close(got, sessions["jax"]["frames"], [last])


def test_session_particles_hier_raise_naming_their_row():
    """Particle sessions (ported since, A10) composite sort-first: a
    hierarchy request is inert on the ledger and the flat mesh renders,
    as the reference's ``test_session_particles_hier_inert_ledger``
    holds."""
    tobs.clear_ledger()
    sess = port_session(N, "temporal", state=False, **{
        "sim.kind": "lennard_jones", "sim.num_particles": "64",
        "topology.num_hosts": "2"})
    assert sess.mesh.axis_names == ("ranks",) and sess.mesh.n == N
    assert any(e["component"] == "topology.hier" for e in tobs.ledger())
    sess.run(1)

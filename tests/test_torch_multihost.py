"""The port's multi-process fleet against the JAX package and against the
port's own in-process mesh, on the CPU: real ``torch.distributed``
processes (gloo) through the port's harness
(``scenery_insitu_tpu_torch/testing/multiproc.py``).

One harness run (module fixture: 2 processes x 2 ranks, the flat 4-rank
decomposition) on the reference test's scene (``tests/test_multihost.py``:
16^3, W = H = 16, K = 4, K_out = 6, 24 steps; the state from the port's
seeded Gray-Scott init, handed to both packages as data) exercises:

- the two-level composite's host path (per-host domain partials, f32
  tile streams over loopback, incremental head assembly): its frame
  equals the port's in-process 4-rank ``distributed_vdi_step`` bit for
  bit and the JAX package's within the gather tests' 1e-5;
- the process mesh: the gather-engine step and the temporal MXU chain
  (seed and 2 frames) equal the in-process mesh bit for bit;
- ``gather_vdi_tiles`` across processes, the obs-event merge, and the
  two transports of ``_allgather_blobs``.

The worker entries live at the module's top level, and nothing at the
top level imports JAX, so the workers never load it. The single-process
tests run without a spawn, but for the smoke launcher's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                             SliceMarchConfig, VDIConfig)
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.core.transfer import for_dataset
from scenery_insitu_tpu_torch.core.vdi import VDI
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import hier as thier
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import multihost as tmh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.sim import grayscott as tgs
from scenery_insitu_tpu_torch.testing import multiproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ATOL = 1e-5                  # tests/test_torch_gather.py's bar
GRID = 16
N_TOTAL = 4                  # 2 processes x 2 ranks
W = H = 16
K, K_OUT = 4, 6
MAX_STEPS = 24
EYE = (0.0, 0.4, 3.0)
MXU_FRAMES = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's in-process runs (the port's
    test files share ``tests/test_torch_pipeline.py``'s fixture; that
    module imports JAX, which the workers must not load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field() -> np.ndarray:
    return tgs.GrayScott.init((GRID,) * 3, n_seeds=4, device=CPU).v.numpy()


def _scene(dev=CPU):
    """The harness scene on the port's side (shared by the workers and
    the in-process references)."""
    return dict(
        tf=for_dataset("gray_scott", device=dev),
        cam=Camera.create(EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                          device=dev),
        origin=torch.tensor([-1.0, -1.0, -1.0], device=dev),
        spacing=torch.full((3,), 2.0 / GRID, device=dev),
        vcfg=VDIConfig(max_supersegments=K, adaptive_iters=2),
        ccfg=CompositeConfig(max_output_supersegments=K_OUT,
                             adaptive_iters=2))


def _mxu(s, mesh):
    spec = tsl.make_spec(s["cam"], (GRID,) * 3,
                         SliceMarchConfig(matmul_dtype="f32"),
                         multiple_of=N_TOTAL)
    cfg = VDIConfig(max_supersegments=K, adaptive_mode="temporal")
    return (tpipe.distributed_initial_threshold_mxu(mesh, s["tf"], spec,
                                                    cfg),
            tpipe.distributed_vdi_step_mxu_temporal(mesh, s["tf"], spec,
                                                    cfg, s["ccfg"]))


# ----------------------------------------------------- the worker entry


def _entry_all(ctx):
    """Runs in every harness worker: the host path, the process-mesh
    steps, the gathers, the obs merge and the blob transports. Each
    process writes its own blocks; the head (process 0) writes the
    host-path frame and the verdicts."""
    pid, nproc, ranks = ctx.process_id, ctx.num_processes, ctx.ranks_per_proc
    rec = tobs.Recorder(enabled=True, rank=pid)
    tobs.set_recorder(rec)
    field = _field()
    s = _scene()
    args = (s["origin"], s["spacing"], s["cam"])

    # the host path of the two-level composite
    hp = thier.run_host_path(pid, nproc, field, s["tf"], s["cam"],
                             s["origin"], s["spacing"], W, H, s["vcfg"],
                             s["ccfg"], ranks, CPU, max_steps=MAX_STEPS)
    if pid == 0:
        c, d, degraded = hp["frames"][0]
        np.savez(os.path.join(ctx.workdir, "mh_hier.npz"), color=c,
                 depth=d, degraded=np.array(degraded))

    # the process mesh: this process's slabs only
    mesh = tmh.global_mesh(ranks, CPU)
    dn = GRID // mesh.n
    slabs = tmh.shard_global(field[mesh.first_rank * dn:(mesh.first_rank
                                                         + ranks) * dn],
                             mesh)
    vdi = tpipe.distributed_vdi_step(mesh, s["tf"], W, H, s["vcfg"],
                                     s["ccfg"], MAX_STEPS)(slabs, *args)
    out = {"gather_c": vdi.color.numpy(), "gather_d": vdi.depth.numpy()}
    seed, step = _mxu(s, mesh)
    thr = seed(slabs, *args)
    out.update({f"thr0_{f}": x.numpy() for f, x in zip(thr._fields, thr)})
    for i in range(1, MXU_FRAMES + 1):
        (v, _), thr = step(slabs, *args, thr)
        out.update({f"mxu{i}_c": v.color.numpy(), f"mxu{i}_d":
                    v.depth.numpy()})
        out.update({f"thr{i}_{f}": x.numpy()
                    for f, x in zip(thr._fields, thr)})
    np.savez(os.path.join(ctx.workdir, f"mh_mesh_{pid}.npz"), **out)
    whole = tmh.gather_vdi_compressed(vdi, codec="zlib")

    # gather_vdi_tiles across the processes (the store transport)
    wp = 8
    color = torch.full((2, 4, 4, wp), float(pid + 1))
    depth = torch.stack([torch.full((2, 4, wp), 0.1 * (pid + 1)),
                         torch.full((2, 4, wp), 0.2 * (pid + 1))], dim=1)
    tiles = tmh.gather_vdi_tiles(VDI(color, depth), codec="zlib")
    gather = list(tiles) if pid == 0 else None
    assert pid == 0 or tiles is None

    # the obs-event merge
    with rec.span("mh_rank_work", frame=pid):
        pass
    merged = tmh.gather_obs_events(rec)
    assert pid == 0 or merged is None

    # both transports of the blob allgather under gloo
    blobs = [bytes([p + 1]) * (10 + 7 * p) for p in range(nproc)]
    got = {}
    for transport in ("kv", "device"):
        b, ln = tmh._allgather_blobs(blobs[pid], transport=transport)
        got[transport] = [bytes(b[p, 0, :int(ln[p, 0])])
                          for p in range(nproc)]
    assert got["kv"] == got["device"] == blobs, got

    if pid == 0:
        g_ok = (len(gather) == nproc
                and [g[0] for g in gather] == [wp * p for p in range(nproc)]
                and all(np.allclose(g[1], p + 1)
                        for p, g in enumerate(gather))
                and all(np.allclose(g[2][:, 1], 0.2 * (p + 1))
                        for p, g in enumerate(gather))
                and all(g[1].shape == (2, 4, 4, wp) for g in gather)
                and all(g[2].shape == (2, 2, 4, wp) for g in gather))
        np.savez(os.path.join(ctx.workdir, "mh_whole.npz"), color=whole[0],
                 depth=whole[1])
        ledger = [e["component"] for e in tobs.ledger()]
        with open(os.path.join(ctx.workdir, "mh_results.json"), "w") as f:
            json.dump({
                "gather_ok": bool(g_ok),
                "span_ranks": sorted({e.get("rank") for e in merged
                                      if e.get("name") == "mh_rank_work"}),
                "kv_transport_ledgered": "multihost.transport" in ledger,
                "transports_equal": True,
                "dcn_bytes_sent": rec.counters.get("dcn_bytes_sent", 0),
                "dcn_bytes_received": rec.counters.get(
                    "dcn_bytes_received", 0),
                "dcn_span_names": sorted({
                    e.get("name") for e in merged
                    if str(e.get("name", "")).startswith("dcn")}),
            }, f)


def _entry_fail(ctx):
    """A launch whose process 1 fails (process 0 reports no norm)."""
    if ctx.process_id == 1:
        raise RuntimeError("a worker that fails")


# ------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """ONE two-process harness run shared by every test here."""
    workdir = tmp_path_factory.mktemp("mh")
    results = multiproc.run_multiproc(
        "tests.test_torch_multihost:_entry_all", n_procs=2,
        ranks_per_proc=2, workdir=str(workdir), timeout_s=300.0,
        device=CPU)
    for r in results:
        assert r.ok, f"worker {r.process_id} failed:\n{r.output}"
    with open(workdir / "mh_results.json") as f:
        data = json.load(f)
    return workdir, data


@pytest.fixture(scope="module")
def in_process():
    """The port's in-process 4-rank runs of the same scene."""
    s = _scene()
    field = _field()
    mesh = tmesh.make_mesh(N_TOTAL, device=CPU)
    slabs = tmesh.shard_volume(torch.from_numpy(field), mesh)
    args = (s["origin"], s["spacing"], s["cam"])
    vdi = tpipe.distributed_vdi_step(mesh, s["tf"], W, H, s["vcfg"],
                                     s["ccfg"], MAX_STEPS)(slabs, *args)
    seed, step = _mxu(s, mesh)
    thr = seed(slabs, *args)
    chain = [(None, thr)]
    for _ in range(MXU_FRAMES):
        (v, _), thr = step(slabs, *args, thr)
        chain.append((v, thr))
    return field, vdi, chain


def _same_vdi(color, depth, want_c, want_d):
    """Bit for bit: the colours, which slots are live, the live depths."""
    want_c, want_d = np.asarray(want_c), np.asarray(want_d)
    np.testing.assert_array_equal(color, want_c)
    assert (np.isinf(depth) == np.isinf(want_d)).all()
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(depth[fin], want_d[fin])


def _blocks(workdir, key):
    """Every process's column block of ``key`` side by side."""
    return np.concatenate([np.load(workdir / f"mh_mesh_{p}.npz")[key]
                           for p in range(2)], axis=-1)


# ---------------------------------------------------- across processes


@pytest.mark.multiproc
def test_host_path_frame_matches_flat_steps(harness, in_process):
    """The host-path frame of 2 real processes equals the port's flat
    4-rank step bit for bit (resegmentation happens once, at the head,
    so the merged stream is the flat stream), and the JAX package's flat
    4-rank step within 1e-5."""
    import jax.numpy as jnp

    from scenery_insitu_tpu import config as jcfg
    from scenery_insitu_tpu.core import camera as jcam
    from scenery_insitu_tpu.core import transfer as jtf
    from scenery_insitu_tpu.parallel import mesh as jmesh
    from scenery_insitu_tpu.parallel import pipeline as jpipe

    workdir, _ = harness
    got = np.load(workdir / "mh_hier.npz")
    assert not bool(got["degraded"])
    field, vdi, _ = in_process
    _same_vdi(got["color"], got["depth"], vdi.color.numpy(),
              vdi.depth.numpy())
    jm = jmesh.make_mesh(N_TOTAL)
    jstep = jpipe.distributed_vdi_step(
        jm, jtf.for_dataset("gray_scott"), W, H,
        jcfg.VDIConfig(max_supersegments=K, adaptive_iters=2),
        jcfg.CompositeConfig(max_output_supersegments=K_OUT,
                             adaptive_iters=2), max_steps=MAX_STEPS)
    ref = jstep(jpipe.shard_volume(jnp.asarray(field), jm),
                jnp.array([-1.0, -1.0, -1.0], jnp.float32),
                jnp.full((3,), 2.0 / GRID, jnp.float32),
                jcam.Camera.create(EYE, fov_y_deg=50.0, near=0.5, far=20.0))
    rc, rd = np.asarray(ref.color), np.asarray(ref.depth)
    np.testing.assert_allclose(got["color"], rc, rtol=0, atol=ATOL)
    live = np.isfinite(rd)
    assert (np.isfinite(got["depth"]) == live).all()
    np.testing.assert_allclose(got["depth"][live], rd[live], rtol=0,
                               atol=ATOL)
    assert live[:, 0].any(), "live slots"


@pytest.mark.multiproc
@pytest.mark.parametrize("path", ["gather", "mxu"])
def test_process_mesh_steps_match_in_process(harness, in_process, path):
    """On the 2 x 2 process mesh the gather-engine step (each process's
    column block, and the frame process 0 puts together) and the
    temporal MXU chain (every frame's blocks and every process's rows of
    the threshold maps, seed included) equal the in-process mesh's bit
    for bit."""
    workdir, _ = harness
    _, vdi, chain = in_process
    if path == "gather":
        _same_vdi(_blocks(workdir, "gather_c"), _blocks(workdir, "gather_d"),
                  vdi.color.numpy(), vdi.depth.numpy())
        whole = np.load(workdir / "mh_whole.npz")
        _same_vdi(whole["color"], whole["depth"], vdi.color.numpy(),
                  vdi.depth.numpy())
        return
    for i, (v, thr) in enumerate(chain):
        for f, x in zip(thr._fields, thr):
            got = np.concatenate([np.load(workdir / f"mh_mesh_{p}.npz")[
                f"thr{i}_{f}"] for p in range(2)])
            np.testing.assert_array_equal(got, x.numpy(), err_msg=(i, f))
        if v is not None:
            _same_vdi(_blocks(workdir, f"mxu{i}_c"),
                      _blocks(workdir, f"mxu{i}_d"), v.color.numpy(),
                      v.depth.numpy())


@pytest.mark.multiproc
def test_gather_vdi_tiles_across_real_processes(harness):
    """Each process's column block arrives at the head in column order
    with its content, over the store transport (gloo), which the ledger
    records."""
    _, data = harness
    assert data["gather_ok"]
    assert data["kv_transport_ledgered"]


@pytest.mark.multiproc
def test_obs_event_merge_across_real_processes(harness):
    """gather_obs_events returns both ranks' spans in one rebased
    timeline, with the DCN hops as dcn_* spans and byte counters."""
    _, data = harness
    assert data["span_ranks"] == [0, 1]
    assert "dcn_allgather" in data["dcn_span_names"]
    assert data["dcn_bytes_sent"] > 0
    assert data["dcn_bytes_received"] > 0


@pytest.mark.multiproc
def test_allgather_transports_agree_under_gloo(harness):
    """The store and the process-group transports of `_allgather_blobs`
    return the same blobs (every worker asserts it on its own)."""
    _, data = harness
    assert data["transports_equal"]


# ---------------------------------------------------- one process


def _seeded_partial(rng, m):
    """A host's sorted accumulator: per pixel m slots by start depth,
    some empty (+inf, colour 0)."""
    d0 = rng.uniform(0.5, 4.0, (m, H, W)).astype(np.float32)
    d0[rng.random((m, H, W)) < 0.3] = np.inf
    d0 = np.sort(d0, axis=0)
    depth = np.stack([d0, d0 + 0.05], axis=1).astype(np.float32)
    color = rng.random((m, 4, H, W)).astype(np.float32) * 0.5
    color[~np.isfinite(d0)[:, None].repeat(4, 1)] = 0.0
    return color, depth


def test_merge_partial_blocks_matches_reference():
    """The head's merge of seeded partials (sort, then one resegment)
    against the reference's at 1e-6."""
    from scenery_insitu_tpu import config as jcfg
    from scenery_insitu_tpu.parallel import hier as jhier

    rng = np.random.default_rng(3)
    parts = [_seeded_partial(rng, 8), _seeded_partial(rng, 8)]
    got = thier.merge_partial_blocks(
        parts, CompositeConfig(max_output_supersegments=K_OUT,
                               adaptive_iters=2), device=CPU)
    want = jhier.merge_partial_blocks(
        parts, jcfg.CompositeConfig(max_output_supersegments=K_OUT,
                                    adaptive_iters=2))
    wc, wd = np.asarray(want.color), np.asarray(want.depth)
    np.testing.assert_allclose(got.color.numpy(), wc, rtol=0, atol=1e-6)
    live = np.isfinite(wd)
    assert (np.isfinite(got.depth.numpy()) == live).all()
    np.testing.assert_allclose(got.depth.numpy()[live], wd[live], rtol=0,
                               atol=1e-6)


def test_flush_incomplete_degrades_and_ledgers():
    """A host that never sends: the pending block composes from the
    partial that arrived, stamped degraded, with ``multihost.host_down``
    on the ledger."""
    tobs.clear_ledger()
    rng = np.random.default_rng(4)
    c, d = _seeded_partial(rng, 8)
    ccfg = CompositeConfig(max_output_supersegments=K_OUT, adaptive_iters=2)
    asm = thier.HierTileAssembler(2, ccfg, device=CPU)
    meta = type("M", (), {"index": np.int32(5)})()
    assert asm.add(0, VDI(c, d), meta, {"tile": 0, "tiles": 1,
                                        "col0": 0}) == []
    (frame, tile, col0, block, degraded), = asm.flush_incomplete()
    assert (frame, tile, col0, degraded) == (5, 0, 0, True)
    want = thier.merge_partial_blocks([(c, d)], ccfg, device=CPU)
    np.testing.assert_array_equal(block.color.numpy(), want.color.numpy())
    assert asm.stats["degraded"] == 1
    assert "multihost.host_down" in [e["component"] for e in tobs.ledger()]


def test_single_process_gathers():
    """In a one-process world (no fleet): gather_obs_events is the local
    timeline plus a summary, and gather_vdi_tiles yields the one block,
    which the whole-frame gather equals (the twins of
    ``tests/test_obs.py`` and ``tests/test_waves.py``)."""
    rec = tobs.Recorder(enabled=True, rank=0)
    with rec.span("sim", frame=0):
        pass
    merged = tmh.gather_obs_events(rec)
    assert merged[0]["name"] == "sim"
    assert merged[-1]["type"] == "summary"
    s = _scene()
    mesh = tmesh.make_mesh(N_TOTAL, device=CPU)
    vdi = tpipe.distributed_vdi_step(mesh, s["tf"], W, H, s["vcfg"],
                                     s["ccfg"], MAX_STEPS)(
        tmesh.shard_volume(torch.from_numpy(_field()), mesh), s["origin"],
        s["spacing"], s["cam"])
    color, depth = tmh.gather_vdi_compressed(vdi, codec="zlib")
    tiles = list(tmh.gather_vdi_tiles(vdi, codec="zlib"))
    assert [t[0] for t in tiles] == [0]
    np.testing.assert_array_equal(tiles[0][1], color)
    np.testing.assert_array_equal(color, vdi.color.numpy())
    np.testing.assert_array_equal(depth, vdi.depth.numpy())


def test_initialize_unreachable_coordinator_raises():
    """A coordinator that never comes: the ladder gives up within its
    short budget with a RuntimeError naming the process and the
    address, each retry on the ledger as ``multihost.connect``."""
    import time

    tobs.clear_ledger()
    addr = f"127.0.0.1:{multiproc.free_port()}"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=f"process 1 .*{addr}"):
        tmh.initialize(addr, 2, 1, timeout_s=3.0, attempt_timeout_s=1.0,
                       device=CPU)
    assert time.monotonic() - t0 < 10.0
    assert "multihost.connect" in [e["component"] for e in tobs.ledger()]
    assert tmh.process_count() == 1


def test_process_mesh_unported_knobs_raise():
    """A process mesh runs the VDI steps flat on even slabs (every
    exchange, wire and schedule, the K budget and reuse:
    ``tests/test_torch_multihost_knobs.py``); a render plan, a brick map,
    a two-level topology, and the plain and hybrid builders name ROADMAP
    A8b item 9."""
    from scenery_insitu_tpu_torch.config import RenderConfig, TopologyConfig
    from scenery_insitu_tpu_torch.parallel.bricks import BrickMap

    mesh = tmesh.Mesh(4, torch.device(CPU), first_rank=2, local_ranks=2)
    s = _scene()
    spec = tsl.make_spec(s["cam"], (GRID,) * 3,
                         SliceMarchConfig(matmul_dtype="f32"),
                         multiple_of=4)
    topo = TopologyConfig(num_hosts=2)
    for call in (
            lambda: tpipe.distributed_vdi_step_mxu_temporal(
                mesh, s["tf"], spec, comp_cfg=CompositeConfig(
                    rebalance="occupancy"), plan=(2, 6, 4, 4)),
            lambda: tpipe.distributed_vdi_step_mxu(
                mesh, s["tf"], spec, comp_cfg=CompositeConfig(
                    rebalance="bricks"), bricks=BrickMap.contiguous(
                        GRID, 4, 8)),
            lambda: tpipe.distributed_vdi_step(
                mesh, s["tf"], W, H, topology=topo),
            lambda: tpipe.distributed_vdi_step_mxu(
                mesh._replace(axis_names=("hosts", "ranks"), num_hosts=2),
                s["tf"], spec),
            lambda: tpipe.distributed_initial_threshold_mxu(
                mesh, s["tf"], spec, plan=(2, 6, 4, 4)),
            lambda: tpipe.distributed_plain_step(mesh, s["tf"], W, H),
            lambda: tpipe.distributed_plain_step_mxu(
                mesh, s["tf"], spec, RenderConfig()),
            lambda: tpipe.distributed_hybrid_step_mxu(mesh, s["tf"],
                                                      spec)):
        with pytest.raises(NotImplementedError, match="A8b item 9"):
            call()
    with pytest.raises(ValueError, match="shard_global"):
        tmesh.shard_volume(torch.zeros(GRID, GRID, GRID), mesh)


@pytest.mark.multiproc
def test_launch_smoke_prints_launch_ok():
    """``python -m ...parallel.multihost --launch 2 --device cpu``: every
    worker's norms agree, the gather and the host path run, exit 0."""
    out = subprocess.run(
        [sys.executable, "-m", "scenery_insitu_tpu_torch.parallel."
         "multihost", "--launch", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "LAUNCH_OK" in out.stdout
    assert "MULTIHOST_GATHER_OK" in out.stdout
    assert "MULTIHOST_HIER_OK" in out.stdout


@pytest.mark.multiproc
def test_launch_reports_a_failed_worker(capsys):
    """A worker that fails makes the launcher print LAUNCH_FAILED and
    return 1."""
    rc = tmh._launch(2, 2, CPU, entry="tests.test_torch_multihost:"
                     "_entry_fail", timeout_s=120.0)
    assert rc == 1
    assert "LAUNCH_FAILED" in capsys.readouterr().out

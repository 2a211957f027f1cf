"""The process mesh's compositing knobs on the CPU: real
``torch.distributed`` processes (gloo, 2 processes x 2 ranks) through the
port's harness (``scenery_insitu_tpu_torch/testing/multiproc.py``), held
bit for bit against the port's in-process 4-rank mesh on the same inputs,
and against the JAX package's 4-device steps at the bars of the
in-process mesh's own parity files.

One harness run (module fixture) on ``tests/test_torch_kbudget.py``'s
graded 16^3 scene (K = 4, K_out = 6; the slice march's intermediate grid
split into 8 column tiles so the waves have two tiles a rank) drives the
temporal MXU chain (the seed and 2 frames) under the ring (lossless and
capped at 2K slots), the bf16 and qpack8 wires, the ring on qpack8, tile
waves (alone and with the ring on qpack8), the K budget and fragment
reuse (the second frame on the same field and camera: every rank clean),
the gather-engine step in tile waves on bf16, and the session with the
ring and reuse (its blocks after 3 frames, and the ``ValueError`` of
sinks and ``fetch=True``). The JAX package runs the same cases on 4 of
the suite's host devices, in the pytest process while the harness runs:
an f32 frame is held at ``tests/test_torch_ring.py``'s and
``test_torch_waves.py``'s bar (rtol 1e-4, atol 1e-5; the K budget and
reuse at ``test_torch_kbudget.py``'s atol 1e-5), a lossy wire's image at
``test_torch_wire.py``'s 60 dB with its threshold maps within 1e-6, the
session at ``test_torch_session.py``'s bar.

The worker entry lives at the module's top level, and nothing at the top
level imports JAX (the reference's modules are imported inside the
functions that run it), so the workers never load it.
"""

import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch.config import FrameworkConfig
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import multihost as tmh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.runtime.session import InSituSession
from scenery_insitu_tpu_torch.sim import grayscott as tgs
from scenery_insitu_tpu_torch.testing import multiproc
from scenery_insitu_tpu_torch.utils.image import psnr

CPU = "cpu"
GRID = 16
N_TOTAL = 4                  # 2 processes x 2 ranks
RANKS = 2
W = H = 16                   # the gather engine's image
K, K_OUT, K_MIN = 4, 6, 2
MAX_STEPS = 24
EYE = (0.0, 0.2, 3.0)
FRAMES = 2
WAVE_TILES = 2
SESSION_FRAMES = 3
RTOL, ATOL = 1e-4, 1e-5      # the f32 frames' bar against the reference
LOSSY_DB, LOSSY_THR = 60.0, 1e-6

# the knobs of the MXU chain, each a CompositeConfig's settings
MXU_CASES = {
    "ring": dict(exchange="ring"),
    "ring_cap": dict(exchange="ring", ring_slots=2 * K),
    "bf16": dict(wire="bf16"),
    "qpack8": dict(wire="qpack8"),
    "ring_qpack8": dict(exchange="ring", wire="qpack8"),
    "waves": dict(schedule="waves", wave_tiles=WAVE_TILES),
    "ring_qpack8_waves": dict(exchange="ring", wire="qpack8",
                              schedule="waves", wave_tiles=WAVE_TILES),
    "kbudget": dict(k_budget="occupancy", k_budget_min=K_MIN),
    "reuse": dict(temporal_reuse="ranges"),
}
GATHER_CASE = dict(schedule="waves", wave_tiles=WAVE_TILES, wire="bf16")
LOSSY = ("bf16", "qpack8", "ring_qpack8", "ring_qpack8_waves")
# test_torch_kbudget.py holds the budget (and reuse with it) at rtol 0
EXACT_RTOL = ("kbudget", "reuse")


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
    """``tests/test_torch_kbudget.py``'s graded field: seeded noise on
    ranks 0-2 and in the first 4 rows of rank 3's slab, so under 4
    in-plane occupancy tiles the last rank's K budget target falls below
    K, and every live pixel holds more segments than K."""
    data = np.zeros((GRID,) * 3, np.float32)
    rng = np.random.default_rng(2)
    data[0:12] = rng.uniform(0.05, 0.9, (12, 16, 16)).astype(np.float32)
    data[12:16, 0:4] = rng.uniform(0.05, 0.9, (4, 4, 16)).astype(np.float32)
    return data


def _port():
    """The port's side of a run: its modules and keyword arguments."""
    return types.SimpleNamespace(
        cfg=tcfg, camera=tcam, pipe=tpipe, slicer=tsl, tf=TransferFunction,
        dev=dict(device=CPU), array=torch.tensor, session=InSituSession,
        np=lambda x: x.numpy())


def _reference_side():
    """The JAX package's side of a run, imported here only (the pytest
    process runs it; the workers never call this)."""
    import jax.numpy as jnp

    from scenery_insitu_tpu import config as jcfg
    from scenery_insitu_tpu.core import camera as jcam
    from scenery_insitu_tpu.core.transfer import TransferFunction as JTF
    from scenery_insitu_tpu.ops import slicer as jsl
    from scenery_insitu_tpu.parallel import pipeline as jpipe
    from scenery_insitu_tpu.runtime.session import InSituSession as JSess

    return types.SimpleNamespace(
        cfg=jcfg, camera=jcam, pipe=jpipe, slicer=jsl, tf=JTF, dev={},
        array=jnp.asarray, session=JSess, np=np.asarray)


def _scene(side=None):
    side = side or _port()
    cam = side.camera.Camera.create(EYE, fov_y_deg=45.0, near=0.5,
                                    far=20.0, **side.dev)
    spec = side.slicer.make_spec(
        cam, (GRID,) * 3, side.cfg.SliceMarchConfig(
            matmul_dtype="f32", scale=1.0, occupancy_vtiles=4),
        multiple_of=N_TOTAL * WAVE_TILES)
    return dict(side=side, cam=cam, spec=spec,
                tf=side.tf.ramp(0.05, 0.8, 0.7, **side.dev),
                origin=side.array([-1.0, -1.0, -1.0]),
                spacing=side.array([2.0 / GRID] * 3))


def _camera(s, name, i):
    """Frame i's camera: a small orbit a frame, held still under reuse
    (a clean rank needs its ranges and the camera unmoved)."""
    if name == "reuse":
        return s["cam"]
    return s["side"].camera.orbit(s["cam"], 0.05 * i)


def _ccfg(cfg, **knobs):
    return cfg.CompositeConfig(max_output_supersegments=K_OUT,
                               adaptive_iters=2, **knobs)


def _run_mxu(mesh, slabs, s, name):
    """The seed and FRAMES frames of the case's temporal MXU chain on
    either package: {"f<i>_c", "f<i>_d", "f<i>_t", "f<i>_dirty"} of
    every frame (the threshold maps' rows; the dirty bits under
    reuse)."""
    side = s["side"]
    vcfg = side.cfg.VDIConfig(max_supersegments=K, adaptive_mode="temporal")
    ccfg = _ccfg(side.cfg, **MXU_CASES[name])
    tf, spec, o, sp = s["tf"], s["spec"], s["origin"], s["spacing"]
    pipe = side.pipe
    thr = pipe.distributed_initial_threshold_mxu(mesh, tf, spec, vcfg)(
        slabs, o, sp, _camera(s, name, 0))
    step = pipe.distributed_vdi_step_mxu_temporal(mesh, tf, spec, vcfg,
                                                  ccfg)
    ru = None
    if name == "reuse":
        ru = pipe.distributed_initial_reuse_mxu(mesh, tf, spec, vcfg,
                                                ccfg)(slabs, o, sp,
                                                      s["cam"])
    out = {}
    for i in range(FRAMES):
        cam = _camera(s, name, i)
        if ru is None:
            (v, _), thr = step(slabs, o, sp, cam, thr)
        else:
            (v, _), thr, ru = step(slabs, o, sp, cam, thr, ru)
            out[f"f{i}_dirty"] = np.asarray(side.np(ru.dirty))
        out[f"f{i}_c"] = np.asarray(side.np(v.color))
        out[f"f{i}_d"] = np.asarray(side.np(v.depth))
        out[f"f{i}_t"] = np.asarray(side.np(thr.thr))
    return out


def _run_gather(mesh, slabs, s):
    side = s["side"]
    step = side.pipe.distributed_vdi_step(
        mesh, s["tf"], W, H, side.cfg.VDIConfig(max_supersegments=K,
                                                adaptive_iters=2),
        _ccfg(side.cfg, **GATHER_CASE), MAX_STEPS)
    v = step(slabs, s["origin"], s["spacing"], s["cam"])
    return {"f0_c": np.asarray(side.np(v.color)),
            "f0_d": np.asarray(side.np(v.depth))}


def _session_cfg(cfg=tcfg):
    return cfg.FrameworkConfig().with_overrides(
        f"sim.grid=[{GRID},{GRID},{GRID}]", "sim.steps_per_frame=2",
        f"vdi.max_supersegments={K}", "vdi.adaptive_mode=temporal",
        "vdi.histogram_bins=8", f"composite.max_output_supersegments={K_OUT}",
        "composite.exchange=ring", "composite.temporal_reuse=ranges",
        "slicer.engine=mxu", "slicer.matmul_dtype=f32",
        f"mesh.num_devices={N_TOTAL}", "runtime.dataset=gray_scott")


def _start_state():
    """The port's Gray-Scott init plus seeded noise of 1e-3, as
    ``tests/test_torch_session.py`` starts both packages' sessions (the
    init's constant cubes flip a count at the histogram's zero
    candidate between the packages)."""
    st = tgs.GrayScott.init((GRID,) * 3, seed=0, device=CPU)
    rng = np.random.default_rng(7)
    u = st.u.numpy() + rng.normal(0.0, 1e-3, st.u.shape)
    v = st.v.numpy() + rng.normal(0.0, 1e-3, st.v.shape)
    return u.astype(np.float32), v.astype(np.float32)


def _session(mesh, side=None):
    side = side or _port()
    cam = side.camera.Camera.create(EYE, fov_y_deg=50.0, near=0.5,
                                    far=20.0, **side.dev)
    kw = dict(device=CPU) if side.dev else {}
    sess = side.session(_session_cfg(side.cfg), mesh=mesh, camera=cam, **kw)
    sess.orbit_rate = 0.05
    u, v = _start_state()
    sess.sim.state = sess.sim.state._replace(u=side.array(u),
                                             v=side.array(v))
    return sess


def _run_session(mesh, side=None):
    """SESSION_FRAMES frames: all but the last through ``run`` without a
    fetch, the last through ``render_frame``, whose block is kept."""
    side = side or _port()
    sess = _session(mesh, side)
    sess.run(SESSION_FRAMES - 1, fetch=False)
    v = sess.render_frame()
    return {"f0_c": np.asarray(side.np(v.color)),
            "f0_d": np.asarray(side.np(v.depth))}


# ----------------------------------------------------- the worker entry


def _entry_knobs(ctx):
    """Runs in every harness worker: every case on this process's slabs
    of the process mesh, each case's blocks to ``knobs_<case>_<pid>.npz``,
    then the session and its refusals."""
    pid = ctx.process_id
    mesh = tmh.global_mesh(ctx.ranks_per_proc, CPU)
    dn = GRID // mesh.n
    lo = mesh.first_rank * dn
    slabs = tmh.shard_global(_field()[lo:lo + mesh.n_local * dn], mesh)
    s = _scene()

    def save(name, out):
        np.savez(os.path.join(ctx.workdir, f"knobs_{name}_{pid}.npz"),
                 **out)

    for name in MXU_CASES:
        save(name, _run_mxu(mesh, slabs, s, name))
    save("gather_waves_bf16", _run_gather(mesh, slabs, s))
    save("session", _run_session(mesh))
    refusals = {}
    try:
        _session(mesh).run(1)
    except ValueError as e:
        refusals["fetch"] = str(e)
    try:
        InSituSession(_session_cfg(), mesh=mesh,
                      sinks=[lambda i, p: None], device=CPU)
    except ValueError as e:
        refusals["sinks"] = str(e)
    with open(os.path.join(ctx.workdir, f"refusals_{pid}.json"), "w") as f:
        json.dump(refusals, f)


# ------------------------------------------------------------- fixtures


def _reference():
    """The JAX package's runs of every case on 4 of the suite's host
    devices, the same field, cameras, specs and configs."""
    from scenery_insitu_tpu.parallel import mesh as jmesh

    side = _reference_side()
    mesh = jmesh.make_mesh(N_TOTAL)
    slabs = side.pipe.shard_volume(side.array(_field()), mesh)
    s = _scene(side)
    want = {name: _run_mxu(mesh, slabs, s, name) for name in MXU_CASES}
    want["gather_waves_bf16"] = _run_gather(mesh, slabs, s)
    want["session"] = _run_session(mesh, side)
    return want


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """ONE two-process harness run shared by every test here, with the
    JAX package's reference runs made in this process meanwhile:
    (workdir, reference)."""
    workdir = tmp_path_factory.mktemp("knobs")
    results = []
    fleet = threading.Thread(target=lambda: results.extend(
        multiproc.run_multiproc(
            "tests.test_torch_multihost_knobs:_entry_knobs", n_procs=2,
            ranks_per_proc=RANKS, workdir=str(workdir), timeout_s=300.0,
            device=CPU)))
    fleet.start()
    try:
        reference = _reference()
    finally:
        fleet.join()
    assert len(results) == 2, "the harness returned no results"
    for r in results:
        assert r.ok, f"worker {r.process_id} failed:\n{r.output}"
    return workdir, reference


@pytest.fixture(scope="module")
def in_process():
    """The in-process 4-rank mesh's runs of every case, computed once."""
    mesh = tmesh.make_mesh(N_TOTAL, device=CPU)
    slabs = tmesh.shard_volume(torch.from_numpy(_field()), mesh)
    s = _scene()
    want = {name: _run_mxu(mesh, slabs, s, name) for name in MXU_CASES}
    want["gather_waves_bf16"] = _run_gather(mesh, slabs, s)
    want["session"] = _run_session(mesh)
    return want


def _same(got, want, what):
    """Bit for bit: every float's bits, +inf empty slots included."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, what
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        f"{what}: largest gap "
        f"{np.nanmax(np.abs(np.nan_to_num(got - want, posinf=0)))}")


def _blocks(workdir, name):
    """The processes' blocks of a case side by side: the frames' columns,
    the threshold maps' rows; each process's dirty bits apart."""
    parts = [np.load(workdir / f"knobs_{name}_{p}.npz") for p in range(2)]
    got = {key: np.concatenate([p[key] for p in parts],
                               axis=0 if key.endswith("_t") else -1)
           for key in parts[0].files if not key.endswith("_dirty")}
    return got, parts


def _check_case(workdir, want, name):
    got, parts = _blocks(workdir, name)
    assert set(got) == {k for k in want if not k.endswith("_dirty")}
    for key in got:
        _same(got[key], want[key], f"{name} {key}")
    return parts


def _image(color, depth):
    return render_vdi_same_view(VDI(torch.from_numpy(color),
                                    torch.from_numpy(depth))).numpy()


def _reference_image(color, depth):
    from scenery_insitu_tpu.core import vdi as jvdi

    return np.asarray(jvdi.render_vdi_same_view(jvdi.VDI(color, depth)))


def _close_vdi(got, want, prefix, rtol, atol):
    from tests.test_torch_pipeline import assert_vdi_close

    assert_vdi_close(got[prefix + "_c"], got[prefix + "_d"],
                     want[prefix + "_c"], want[prefix + "_d"], rtol, atol)


# ---------------------------------------------------- across processes


@pytest.mark.multiproc
@pytest.mark.parametrize("name", list(MXU_CASES))
def test_process_mesh_knob_matches_in_process(harness, in_process, name):
    """Every frame of the case's temporal MXU chain (the seed, then
    FRAMES frames) on 2 processes x 2 ranks: the processes' column
    blocks side by side equal the in-process 4-rank frame bit for bit.
    Under reuse the second frame marches no rank in either process."""
    parts = _check_case(harness[0], in_process[name], name)
    assert in_process[name]["f0_c"][:, 3].max() > 0, "a blank frame"
    if name == "reuse":
        for p in parts:
            np.testing.assert_array_equal(p["f0_dirty"], [1] * RANKS)
            np.testing.assert_array_equal(p["f1_dirty"], [0] * RANKS)
        np.testing.assert_array_equal(in_process[name]["f1_dirty"],
                                      [0] * N_TOTAL)


@pytest.mark.multiproc
def test_process_mesh_gather_waves_bf16(harness, in_process):
    """The gather-engine step in tile waves on the bf16 wire over the
    process mesh equals the in-process mesh's frame bit for bit."""
    _check_case(harness[0], in_process["gather_waves_bf16"],
                "gather_waves_bf16")


@pytest.mark.multiproc
def test_session_on_process_mesh(harness, in_process):
    """``InSituSession(mesh=multihost.global_mesh(2))`` with the ring and
    reuse: each process's block of the third frame (``render_frame``
    after two frames of ``run(fetch=False)``) equals the in-process
    4-rank session's columns bit for bit; ``run(fetch=True)`` and sinks
    raise a ``ValueError`` naming ``multihost.gather_vdi_compressed``."""
    _check_case(harness[0], in_process["session"], "session")
    for p in range(2):
        with open(harness[0] / f"refusals_{p}.json") as f:
            refusals = json.load(f)
        assert set(refusals) == {"fetch", "sinks"}, refusals
        for msg in refusals.values():
            assert "gather_vdi_compressed" in msg, msg


@pytest.mark.multiproc
@pytest.mark.parametrize("name", list(MXU_CASES))
def test_process_mesh_knob_matches_reference(harness, name):
    """The processes' blocks side by side against the JAX package's
    4-device frames of the same case: an f32 frame and its threshold
    maps at the in-process mesh's bar, a lossy wire's image at 60 dB
    with the maps within 1e-6; under reuse the dirty bits exactly."""
    workdir, reference = harness
    got, parts = _blocks(workdir, name)
    want = reference[name]
    for i in range(FRAMES):
        f = f"f{i}"
        if name in LOSSY:
            q = psnr(_image(got[f + "_c"], got[f + "_d"]),
                     _reference_image(want[f + "_c"], want[f + "_d"]))
            assert q >= LOSSY_DB, f"{name} frame {i}: {q:.1f} dB"
            np.testing.assert_allclose(got[f + "_t"], want[f + "_t"],
                                       rtol=0, atol=LOSSY_THR)
            continue
        rtol = 0.0 if name in EXACT_RTOL else RTOL
        _close_vdi(got, want, f, rtol, ATOL)
        np.testing.assert_allclose(got[f + "_t"], want[f + "_t"],
                                   rtol=rtol, atol=ATOL)
        if name == "reuse":
            np.testing.assert_array_equal(
                np.concatenate([p[f + "_dirty"] for p in parts]),
                want[f + "_dirty"])


@pytest.mark.multiproc
def test_process_mesh_gather_waves_bf16_matches_reference(harness):
    """The gather-engine step in tile waves on the bf16 wire: the
    processes' blocks side by side render within 60 dB of the JAX
    package's 4-device frame (``tests/test_torch_gather.py``'s bar for
    a lossy wire)."""
    workdir, reference = harness
    got, _ = _blocks(workdir, "gather_waves_bf16")
    want = reference["gather_waves_bf16"]
    q = psnr(_image(got["f0_c"], got["f0_d"]),
             _reference_image(want["f0_c"], want["f0_d"]))
    assert q >= LOSSY_DB, f"{q:.1f} dB"


@pytest.mark.multiproc
def test_session_on_process_mesh_matches_reference(harness):
    """The process mesh's session blocks of the third frame side by side
    against the JAX package's 4-device session with the ring and reuse,
    from the same start state, at ``tests/test_torch_session.py``'s
    bar."""
    workdir, reference = harness
    got, _ = _blocks(workdir, "session")
    _close_vdi(got, reference["session"], "f0", RTOL, ATOL)


# ---------------------------------------------------- one process


def _fake_process_mesh():
    """A process mesh's view without a fleet: ranks 2-3 of 4."""
    return tmesh.Mesh(N_TOTAL, torch.device(CPU), first_rank=2,
                      local_ranks=2)


@pytest.mark.parametrize("override", [
    "sim.kind=lennard_jones", "sim.kind=hybrid",
    "runtime.generate_vdis=false", "composite.rebalance=occupancy"])
def test_session_modes_off_the_process_mesh_raise(override):
    """The particle, hybrid and plain modes and a replanning
    decomposition on a process mesh raise, naming A8b item 9."""
    cfg = FrameworkConfig().with_overrides(
        f"sim.grid=[{GRID},{GRID},{GRID}]", "sim.num_particles=64",
        "render.width=16", "render.height=16", "vdi.adaptive_mode=histogram",
        override)
    with pytest.raises(NotImplementedError, match="A8b item 9"):
        InSituSession(cfg, mesh=_fake_process_mesh(), device=CPU)

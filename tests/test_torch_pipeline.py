"""End-to-end parity of the port's single-chip frame with the JAX package,
on the CPU: the committed golden VDI, the temporal Gray-Scott frame step
over several frames with its threshold state carried, the N = 1
composite, the state converters, and the package's isolation from JAX.

Tolerances are stated at each comparison; the golden bars are those of
``tests/test_golden.py``."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.models import pipelines as jpipe
from scenery_insitu_tpu.ops import composite as jcomp
from scenery_insitu_tpu.sim import grayscott as jgs
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch import scenarios as tscenarios
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import scene as tscene
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
from scenery_insitu_tpu_torch.models import pipelines as tpipe
from scenery_insitu_tpu_torch.ops import composite as tcomp
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import hier as thier
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import multihost as tmh
from scenery_insitu_tpu_torch import serve as tserve
from scenery_insitu_tpu_torch.runtime import scene_session as tscene_session
from scenery_insitu_tpu_torch.serve import __main__ as tserve_main
from scenery_insitu_tpu_torch.sim import grayscott as tgs
from scenery_insitu_tpu_torch.sim import particles as tpt
from scenery_insitu_tpu_torch.sim import vortex as tvx
from scenery_insitu_tpu_torch.testing import multiproc as tmultiproc
from tests.golden import make_golden as mg

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a module's tests, restored after. The port's
    CPU runs are loops of small operations: with the suite's workers
    sharing the host, torch's intra-op threads oversubscribe it and
    every parallel region waits on them (a brick step's port runs took
    100 times as long in the 6-worker suite as alone). Every port test
    file that runs the port imports this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_(x):
    return convert.to_numpy(x)


def assert_vdi_close(color, depth, want_color, want_depth, rtol, atol):
    """Colors close; the same slots live; live depths close."""
    color, depth = np_(color), np_(depth)
    want_color, want_depth = np.asarray(want_color), np.asarray(want_depth)
    np.testing.assert_allclose(color, want_color, rtol=rtol, atol=atol)
    live = np.isfinite(want_depth)
    assert (np.isfinite(depth) == live).all(), "VDI slot liveness"
    np.testing.assert_allclose(depth[live], want_depth[live], rtol=rtol,
                               atol=atol)


def build_golden_vdi(fold):
    """The port's twin of ``make_golden.build_vdi``."""
    vol = tvol.procedural_volume(mg.GRID, kind="blobs", seed=mg.SEED,
                                 device=CPU)
    cam = tcam.Camera.create(mg.EYE, fov_y_deg=50.0, near=0.3, far=20.0,
                             device=CPU)
    spec = tsl.make_spec(cam, tuple(vol.data.shape),
                         tcfg.SliceMarchConfig(matmul_dtype="f32", fold=fold))
    vdi, meta, _ = tsl.generate_vdi_mxu(
        vol, ttf.for_dataset("procedural", device=CPU), cam, spec,
        tcfg.VDIConfig(max_supersegments=mg.K, adaptive_mode="histogram",
                       histogram_bins=8))
    comp = tcomp.composite_vdis(
        vdi.color[None], vdi.depth[None],
        tcfg.CompositeConfig(max_output_supersegments=mg.K))
    return comp, meta


# fold -> (rtol, atol): the bars of tests/test_golden.py for the
# sequential machine and for a fold that sums in another order
@pytest.mark.parametrize("fold,tol", [("xla", (1e-4, 1e-5)),
                                      ("seg", (2e-4, 2e-5)),
                                      ("pallas_seg", (2e-4, 2e-5))])
def test_golden_vdi(fold, tol):
    comp, _ = build_golden_vdi(fold)
    with np.load(os.path.join(mg.GOLDEN_DIR, "golden_vdi.npz")) as z:
        assert_vdi_close(comp.color, comp.depth, z["color"], z["depth"],
                         *tol)


def test_vdi_metadata_matches_and_converts():
    comp, meta = build_golden_vdi("xla")
    jcomp_, jmeta, _ = mg.build_vdi(fold="xla")
    for name, a, b in zip(jmeta._fields, meta, jmeta):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # reference values -> port tensors -> numpy, field for field
    m2 = convert.vdi_metadata({n: np.asarray(x) for n, x in
                               zip(jmeta._fields, jmeta)}, device=CPU)
    assert m2.window_dims.dtype == torch.int32
    for a, b in zip(m2, jmeta):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    v2 = convert.vdi(jcomp_, device=CPU)
    np.testing.assert_array_equal(np_(v2.color), np.asarray(jcomp_.color))
    assert isinstance(np_(v2), VDI)


def _gs_state(n, seed=0):
    st = jgs.GrayScott.init((n,) * 3, n_seeds=3, seed=seed)
    st = jgs.multi_step(st, 4)
    return np.asarray(st.u), np.asarray(st.v), \
        [np.asarray(x) for x in st.params]


@pytest.mark.parametrize("fold", ["xla", "seg"])
def test_temporal_frame_step_matches_reference(fold):
    """3 temporal frames of ``grayscott_vdi_frame_step`` (roll sim, the
    same fold name on both sides) from the same u, v: VDI color and
    depth within 1e-4, sim state within 1e-5, and the carried
    thresholds within 1e-6 frame after frame (they bisect from integer
    counts, so they agree exactly unless a count flips)."""
    _check_temporal_frames(fold, occupancy=None)


@pytest.mark.parametrize("occupancy", ["off", "pyramid"])
def test_frame_step_occupancy_modes_match_reference(occupancy):
    """The same 3-frame comparison with empty-space skipping off, and
    with the in-plane tile gate of the pyramid mode (12 v-tiles on this
    grid), at the same bars."""
    _check_temporal_frames("seg", occupancy=occupancy)


@pytest.mark.parametrize("fold", ["xla", "seg"])
def test_bf16_temporal_frame_step_matches_reference(fold):
    """The same 3-frame comparison with the march's copy of the field in
    bf16 (``render_dtype="bf16"``), at the same bars: off the TPU the
    reference casts the field to bf16 as the port does (only its
    ``matmul_dtype`` is forced to f32 there). The frames advance no sim
    step, so both packages cast the same f32 field: the two sims differ
    by ulps, and an ulp can move a value across a bf16 rounding
    boundary, a 2^-8 step.

    The histogram seed is held apart. bf16 storage leaves runs of equal
    values, where the two resampling products (summed in different
    orders) give samples equal in one package and an ulp apart in the
    other; the seed's first candidate threshold is 0, so a pixel's count
    at that candidate can differ, and it then takes candidate 1
    (0.0078125) where the other takes candidate 0 (clamped to 0.001).
    The f32 march of the same field rounded to bf16 values flips the
    same pixels. So the seeds must be equal except for that pair, and
    the frames run from the reference's seed at the full bars."""
    _check_temporal_frames(fold, occupancy=None, render_dtype="bf16",
                           sim_steps=0, seed_pair=(1e-3, 0.0078125))


def _check_temporal_frames(fold, occupancy, render_dtype=None, sim_steps=3,
                           seed_pair=None):
    n, k = 24, 6
    u, v, params = _gs_state(n)
    eyes = [(0.3 * np.sin(0.7 * i), 0.6, 3.0) for i in range(4)]
    kw = dict(sim_steps=sim_steps, grid_shape=(n,) * 3, sim_fused=False,
              fov_y_deg=50.0, occupancy=occupancy, render_dtype=render_dtype)
    jstep = jpipe.grayscott_vdi_frame_step(
        64, 48, engine="mxu", axis_sign=(2, -1),
        vdi_cfg=jcfg.VDIConfig(max_supersegments=k, adaptive_mode="temporal",
                               histogram_bins=8),
        comp_cfg=jcfg.CompositeConfig(max_output_supersegments=k),
        slicer_cfg=jcfg.SliceMarchConfig(matmul_dtype="f32", fold=fold),
        params=jgs.GrayScottParams(*(jnp.asarray(p) for p in params)), **kw)
    tstep = tpipe.grayscott_vdi_frame_step(
        engine="mxu", axis_sign=(2, -1),
        vdi_cfg=tcfg.VDIConfig(max_supersegments=k, adaptive_mode="temporal",
                               histogram_bins=8),
        comp_cfg=tcfg.CompositeConfig(max_output_supersegments=k),
        slicer_cfg=tcfg.SliceMarchConfig(fold=fold),
        params=tgs.GrayScottParams(*(torch.from_numpy(np.array(p))
                                     for p in params)), device=CPU, **kw)
    assert tstep.spec.fold == fold
    assert tstep.spec.render_dtype == (render_dtype or "f32")
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    jthr = jstep.init_threshold(ju, jv, jnp.asarray(eyes[0], jnp.float32))
    tthr = tstep.init_threshold(tu, tv, torch.tensor(eyes[0]))
    for a, b in zip(tthr, jthr):
        a, b = np_(a), np.asarray(b)
        if seed_pair is not None:
            off = np.abs(a - b) > 1e-6
            assert off.mean() < 0.05, off.mean()
            pair = tuple(np.float32(x) for x in seed_pair)
            assert set(zip(a[off], b[off])) <= {pair, pair[::-1]}, \
                "seeds differ beyond the pair"
            a = np.where(off, b, a)
        np.testing.assert_allclose(a, b, atol=1e-6)
    # the converter carries a reference threshold state over as it is
    tthr = convert.threshold_state({f: np.asarray(x) for f, x in
                                    zip(jthr._fields, jthr)}, device=CPU)
    for i in range(1, 4):
        jc, jd, ju, jv, jthr = jstep(ju, jv, jnp.asarray(eyes[i],
                                                          jnp.float32), jthr)
        tc, td, tu, tv, tthr = tstep(tu, tv, torch.tensor(eyes[i]), tthr)
        assert_vdi_close(tc, td, jc, jd, 1e-4, 1e-4)
        np.testing.assert_allclose(np_(tv), np.asarray(jv), atol=1e-5)
        for a, b in zip(tthr, jthr):
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-6)
    assert np.isfinite(np_(td)[:, 0]).any(), "the frame has live slots"


def test_kernel_fold_frame_step_matches_seg():
    """The kernel fold's CPU branch (the plain K1 and K2) through the
    whole temporal frame equals the port's own seg fold: same VDI within
    2e-5 and the same thresholds."""
    n, k = 20, 5
    u, v, _ = _gs_state(n, seed=1)
    steps = {
        fold: tpipe.grayscott_vdi_frame_step(
            sim_steps=2, grid_shape=(n,) * 3, axis_sign=(2, -1),
            vdi_cfg=tcfg.VDIConfig(max_supersegments=k,
                                   adaptive_mode="temporal"),
            comp_cfg=tcfg.CompositeConfig(max_output_supersegments=k + 2),
            slicer_cfg=tcfg.SliceMarchConfig(fold=fold), device=CPU)
        for fold in ("seg", "pallas_seg")}
    out = {}
    for fold, step in steps.items():
        uu, vv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
        thr = step.init_threshold(uu, vv, torch.tensor((0.1, 0.6, 3.0)))
        for i in range(2):
            c, d, uu, vv, thr = step(uu, vv, torch.tensor((0.1 * i, 0.6, 3.0)),
                                     thr)
        out[fold] = (c, d, thr)
    assert out["seg"][0].shape[0] == k + 2     # padded by the composite
    assert_vdi_close(out["pallas_seg"][0], out["pallas_seg"][1],
                     np_(out["seg"][0]), np_(out["seg"][1]), 2e-5, 2e-5)
    np.testing.assert_array_equal(np_(out["pallas_seg"][2].thr),
                                  np_(out["seg"][2].thr))


def _vdi_stack(seed, n, k, h, w):
    """N sorted sub-VDIs as the march writes them: front-to-back live
    slots, then empty slots (zero color, +inf depth)."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.random((n, k, h, w)) < 0.7, axis=1)[:, ::-1]
    t0 = np.sort(rng.random((n, k, h, w)) * 3.0, axis=1).astype(np.float32)
    rgb = rng.random((n, k, 3, h, w)).astype(np.float32)
    a = (0.05 + 0.9 * rng.random((n, k, 1, h, w))).astype(np.float32)
    color = np.concatenate([rgb * a, a], axis=2) * live[:, :, None]
    depth = np.stack([t0, t0 + np.float32(0.05)], axis=2)
    depth = np.where(live[:, :, None], depth, np.inf).astype(np.float32)
    return color.astype(np.float32), depth


@pytest.mark.parametrize("n,k,k_out", [(1, 4, 4), (1, 4, 7), (1, 6, 3),
                                       (2, 3, 4)])
def test_composite_matches_reference(n, k, k_out):
    """N = 1 with k_out >= k is the identity, padded with empty slots
    (exact); k_out < k and N = 2 resegment through the sequential
    machine (1e-6)."""
    color, depth = _vdi_stack(7, n, k, 8, 12)
    jo = jcomp.composite_vdis(jnp.asarray(color), jnp.asarray(depth),
                              jcfg.CompositeConfig(
                                  max_output_supersegments=k_out,
                                  adaptive_iters=3))
    to = tcomp.composite_vdis(torch.from_numpy(color),
                              torch.from_numpy(depth),
                              tcfg.CompositeConfig(
                                  max_output_supersegments=k_out,
                                  adaptive_iters=3))
    assert to.color.shape == jo.color.shape
    tol = 0.0 if n == 1 and k_out >= k else 1e-6
    np.testing.assert_allclose(np_(to.color), np.asarray(jo.color), atol=tol)
    np.testing.assert_allclose(np_(to.depth), np.asarray(jo.depth), atol=tol)


def test_composite_pallas_backend_is_not_ported_yet():
    """The test of ``backend="pallas"``, which raised until kernel K4
    was ported under its name: on the CPU the fused resegment (the plain
    version of K4) equals the reference's Pallas path (interpret mode)
    within 1e-6, for one rank with fewer output slots than input slots
    and for two ranks."""
    for n, k, k_out in ((1, 3, 2), (2, 3, 4)):
        color, depth = _vdi_stack(8 + n, n, k, 8, 8)
        cfg = dict(max_output_supersegments=k_out, adaptive_iters=3,
                   backend="pallas")
        jo = jcomp.composite_vdis(jnp.asarray(color), jnp.asarray(depth),
                                  jcfg.CompositeConfig(**cfg))
        to = tcomp.composite_vdis(torch.from_numpy(color),
                                  torch.from_numpy(depth),
                                  tcfg.CompositeConfig(**cfg))
        np.testing.assert_allclose(np_(to.color), np.asarray(jo.color),
                                   atol=1e-6)
        np.testing.assert_allclose(np_(to.depth), np.asarray(jo.depth),
                                   atol=1e-6)


def test_frame_step_options():
    step = tpipe.grayscott_vdi_frame_step(
        grid_shape=(16,) * 3, axis_sign=(2, -1), device=CPU,
        occupancy="off", sim_steps=1)
    assert not step.spec.skip_empty
    u, v, _ = _gs_state(16)
    c, d, u2, v2 = step(torch.from_numpy(u.copy()), torch.from_numpy(v.copy()),
                        torch.tensor((0.0, 0.6, 3.0)))
    assert c.shape[0] == 8 and torch.isfinite(c).all()
    img = render_vdi_same_view(VDI(c, d))
    assert img.shape == (4, step.spec.nj, step.spec.ni)
    cfg = tcfg.SliceMarchConfig()
    assert tpipe.resolve_occupancy_cfg(cfg, "pyramid").occupancy_vtiles == 16
    assert tpipe.resolve_occupancy_cfg(cfg, "chunk").occupancy_vtiles == 0
    assert tpipe.resolve_occupancy_cfg(cfg, "sim") == \
        tpipe.resolve_occupancy_cfg(cfg, "pyramid")
    with pytest.raises(ValueError, match="occupancy must be"):
        tpipe.resolve_occupancy_cfg(cfg, "bricks")
    # the gather engine's step: the ray march at its own image size, no
    # slice-march spec; its slice-march-only options raise
    gather = tpipe.grayscott_vdi_frame_step(
        engine="gather", width=16, height=12, max_steps=16, sim_steps=1,
        device=CPU)
    assert gather.spec is None
    c, d, _, _ = gather(torch.from_numpy(u.copy()),
                        torch.from_numpy(v.copy()),
                        torch.tensor((0.0, 0.6, 3.0)))
    assert c.shape == (8, 4, 12, 16) and d.shape == (8, 2, 12, 16)
    assert torch.isfinite(c).all() and torch.isfinite(d[:, 0]).any()
    for bad in (dict(occupancy="sim"),
                dict(vdi_cfg=tcfg.VDIConfig(adaptive_mode="temporal")),
                dict(width=None)):
        with pytest.raises(ValueError):
            tpipe.grayscott_vdi_frame_step(
                **{**dict(engine="gather", width=16, height=12,
                          device=CPU), **bad})
    with pytest.raises(ValueError, match="grid_shape"):
        tpipe.grayscott_vdi_frame_step(device=CPU)


def test_entry_points_without_cuda_raise(monkeypatch):
    """device=None means CUDA: without a card the entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tpipe.grayscott_vdi_frame_step(
            grid_shape=(16,) * 3, axis_sign=(2, -1)),
        lambda: tgs.GrayScott.init((8, 8, 8)),
        lambda: tvol.procedural_volume(8),
        lambda: tcam.Camera.create((0.0, 0.0, 3.0)),
        lambda: ttf.for_dataset("gray_scott"),
        lambda: convert.vdi((np.zeros((1, 4, 2, 2)), np.zeros((1, 2, 2, 2)))),
        # the particle and hybrid workloads
        lambda: tpipe.hybrid_vortex_frame_step(16, 16, (16,) * 3, (2, -1)),
        lambda: tpipe.lj_particle_frame_step(16, 16, None, None),
        lambda: tvx.VortexFlow.init_ring((8, 8, 8)),
        lambda: tpt.lj_init(8),
        lambda: tpt.sho_init(8),
        # the multi-grid scene, its session and the scenario zoo
        lambda: tscene.MultiGridScene(),
        lambda: tscene_session.SceneSession(),
        lambda: tscenarios.make_session(
            "gray_scott", extra_overrides=("sim.grid=[8,8,8]",)),
        # the serving tier and its entry point (python -m ...serve)
        lambda: tserve.ViewerServer.without_sockets(),
        lambda: tserve.camera_from_message({"eye": [0.0, 0.0, 3.0]}),
        lambda: tserve_main.main(["--seconds", "0", "--connect",
                                  "tcp://127.0.0.1:1", "--bind",
                                  "tcp://127.0.0.1:0"]),
        # the multi-process fleet: its entry points and the host path
        lambda: tmh.initialize("127.0.0.1:1", 2, 1, timeout_s=1.0),
        lambda: tmh.global_mesh(2),
        lambda: thier.domain_partial_vdi_step(tmesh.make_mesh(2), None,
                                              16, 16),
        lambda: thier.merge_partial_blocks([(np.zeros((1, 4, 2, 2)),
                                             np.zeros((1, 2, 2, 2)))]),
        lambda: tmultiproc.run_multiproc("tests.x:y", 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_package_imports_no_jax():
    """Importing the port, every submodule and ``chip_smoke.py`` loads
    neither JAX nor any module of the JAX package, and no import
    statement of theirs (those inside functions too, which an import
    does not run) names one. The socket, msgpack and cv2 packages, which
    the card's machine lacks, are imported only inside functions."""
    import ast
    import glob

    files = glob.glob(os.path.join(ROOT, "scenery_insitu_tpu_torch", "**",
                                   "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    banned = ("jax", "scenery_insitu_tpu")
    lazy = ("zmq", "msgpack", "cv2")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        in_function = {id(n) for f in ast.walk(tree)
                       if isinstance(f, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       for n in ast.walk(f)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, (path, m)
                assert m.split(".")[0] not in lazy \
                    or id(node) in in_function, (path, m)
    assert len(files) >= 40, files
    for new in ("ingest/shm.py", "ingest/shm_tool.py", "io/lz4.py",
                "tools/lint/cuda.py", "tools/lint/ledger.py",
                "obs/profiler.py", "obs/collector.py", "obs/device.py",
                "obs/roofline.py", "testing/faults.py"):
        assert os.path.join(ROOT, "scenery_insitu_tpu_torch", new) in files
    code = (
        "import pkgutil, sys\n"
        "import scenery_insitu_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: __import__(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'scenery_insitu_tpu' or m.startswith('scenery_insitu_tpu.')"
        " or m.split('.')[0] in ('zmq', 'msgpack', 'cv2')]"
        "\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "assert {'scenery_insitu_tpu_torch.ingest.shm', "
        "'scenery_insitu_tpu_torch.io.lz4', "
        "'scenery_insitu_tpu_torch.tools.lint.cuda', "
        "'scenery_insitu_tpu_torch.obs.profiler', "
        "'scenery_insitu_tpu_torch.obs.collector', "
        "'scenery_insitu_tpu_torch.obs.device', "
        "'scenery_insitu_tpu_torch.obs.roofline', "
        "'scenery_insitu_tpu_torch.testing.faults'} <= set(names)\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")

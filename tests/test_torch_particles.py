"""Parity of the port's particle workloads with the JAX package's, on the
CPU: the SHO and Lennard-Jones sims, the sphere splat and its speed
colours, the sort-first distributed step, the Lennard-Jones frame step
and the particle sessions (``sim.kind`` ``lennard_jones`` and ``sho``).

Both packages get the same inputs: the port's seeded initial states
(numpy generators; the reference draws from ``jax.random``) handed to
the reference as numpy arrays. Tolerances: the SHO 1e-6; LJ's cell
table equal, its forces within 1e-5 * max|F| and its positions after 5
steps within 1e-4; the splat's depth within 1e-6 and its image within
1e-5; ``speed_colors`` within 1e-6 on the reference test's 256
velocities (the reference's fused norm accumulates with FMA, one ulp of
a speed moves a jet colour by up to ~8e-7); the frame step within 1e-5
with ``sim_steps=0`` and >= 60 dB after 3 steps; the sort-first step
against the reference's within 1e-5, and against the single-device
splat at the reference test's bar (depth within 1e-6, >= 99.9 % of the
pixels within 1e-5); the sessions at that bar frame by frame. Where two
fragments reach a pixel at the same depth, both packages keep the one
with the largest flat index (`test_splat_tie_takes_the_last_fragment`).
The reference's runs are shared through module fixtures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu.config import FrameworkConfig as JConfig
from scenery_insitu_tpu.core.camera import Camera as JCamera
from scenery_insitu_tpu.models import pipelines as jpipes
from scenery_insitu_tpu.ops import splat as jsplat
from scenery_insitu_tpu.parallel import particles as jpar
from scenery_insitu_tpu.parallel.mesh import make_mesh as jmesh
from scenery_insitu_tpu.runtime import checkpoint as jck
from scenery_insitu_tpu.runtime import session as jses
from scenery_insitu_tpu.sim import particles as jpt
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.config import FrameworkConfig as TConfig
from scenery_insitu_tpu_torch.core.camera import Camera as TCamera
from scenery_insitu_tpu_torch.models import pipelines as tpipes
from scenery_insitu_tpu_torch.ops import splat as tsplat
from scenery_insitu_tpu_torch.parallel import particles as tpar
from scenery_insitu_tpu_torch.parallel.mesh import make_mesh as tmesh
from scenery_insitu_tpu_torch.runtime import checkpoint as tck
from scenery_insitu_tpu_torch.runtime import session as tses
from scenery_insitu_tpu_torch.sim import particles as tpt
from scenery_insitu_tpu_torch.utils.image import psnr
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401

CPU = "cpu"
W, H = 64, 48
N_RANKS = 8
EYE = (0.0, 0.0, 5.0)
DEPTH_TOL, IMAGE_TOL = 1e-6, 1e-5
AGREE = 0.999               # the reference test's share of agreeing pixels


def _cams(eye=EYE, near=0.5, far=50.0):
    kw = dict(target=(0.0, 0.0, 0.0), fov_y_deg=50.0, near=near, far=far)
    return JCamera.create(eye, **kw), TCamera.create(eye, device=CPU, **kw)


def _cloud(n, seed, lo=-1.2, hi=1.2):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    return pos, vel


@jax.jit
def _jsplat(pos, rgba, cam):
    """The reference's splat (radius 0.15, stamp 9), one compile; the
    camera is an argument, not a constant XLA could fold."""
    return jsplat.splat_particles(pos, rgba, 0.15, cam, W, H, stamp=9)


def _splat_close(got, want, image_tol=IMAGE_TOL):
    """Port against reference: the same pixels covered, depth within
    1e-6 relative (a depth is a distance from the eye; at a sphere's rim
    ``sqrt(1 - d²/r²)`` magnifies an ulp of the projection), the image
    within 1e-5."""
    gd, wd = np_(got.depth), np.asarray(want.depth)
    assert (np.isfinite(gd) == np.isfinite(wd)).all(), "covered pixels"
    live = np.isfinite(wd)
    np.testing.assert_allclose(gd[live], wd[live], rtol=DEPTH_TOL, atol=0)
    np.testing.assert_allclose(np_(got.image), np.asarray(want.image),
                               rtol=0, atol=image_tol)


def _splat_agree(got, want):
    """The reference test's bar: depth within 1e-6, >= 99.9 % of the
    pixels within 1e-5 (equal-depth ties may resolve apart)."""
    gd, wd = np_(got.depth), np.asarray(want.depth)
    assert (np.isfinite(gd) == np.isfinite(wd)).all()
    live = np.isfinite(wd)
    np.testing.assert_allclose(gd[live], wd[live], rtol=0, atol=DEPTH_TOL)
    agree = np.isclose(np_(got.image), np.asarray(want.image),
                       atol=IMAGE_TOL).all(axis=0)
    assert agree.mean() >= AGREE, agree.mean()


# --------------------------------------------------------------- the sims


def test_sho_matches_reference():
    st, p = tpt.sho_init(100, seed=4, device=CPU)
    js = jpt.ParticleState(jnp.asarray(np_(st.pos)), jnp.asarray(np_(st.vel)),
                           jnp.float32(1.0))
    jp = jpt.SHOParams(jnp.float32(4.0), jnp.float32(0.005))
    for _ in range(50):
        js = jpt.sho_step(js, jp)
    got = tpt.sho_multi_step(st, p, 50)
    np.testing.assert_allclose(np_(got.pos), np.asarray(js.pos), atol=1e-6)
    np.testing.assert_allclose(np_(got.vel), np.asarray(js.vel), atol=1e-6)
    np.testing.assert_allclose(np_(tpt.speeds(got)),
                               np.asarray(jpt.speeds(js)), atol=1e-6)
    # the reference test's physics: the centre of mass stays mid-box
    st = tpt.sho_multi_step(tpt.sho_init(100, device=CPU)[0],
                            tpt.sho_init(100, device=CPU)[1], 200)
    assert np.isfinite(np_(st.pos)).all()
    assert np.abs(np_(st.pos).mean(axis=0) - 0.5).max() < 0.3


@pytest.mark.parametrize("n,density", [(27, 0.5), (64, 0.3), (256, 0.4),
                                       (1000, 0.5), (2048, 0.5)])
def test_lj_init_geometry_matches_reference(n, density):
    """The box, ncell and capacity arithmetic is the reference's (the
    lattice side rounds up in f32: 27 particles make a 3-side lattice)."""
    st, _, spec = tpt.lj_init(n, density=density, device=CPU)
    jst, _, jspec = jpt.lj_init(n, density=density)
    assert tuple(spec) == tuple(jspec)
    assert float(st.box) == float(jst.box)
    assert st.pos.shape == (n, 3) and float(np_(st.pos).min()) >= 0.0
    np.testing.assert_allclose(np_(st.vel).mean(axis=0), 0.0, atol=1e-6)


@pytest.fixture(scope="module")
def lj_reference():
    """Per case: the port's start state and the reference's cell table,
    forces, potential and state after 5 steps from it."""
    out = {}
    for n, density in ((256, 0.4), (2048, 0.5)):
        st, params, spec = tpt.lj_init(n, density=density, seed=1,
                                       device=CPU)
        js = jpt.ParticleState(jnp.asarray(np_(st.pos)),
                               jnp.asarray(np_(st.vel)),
                               jnp.float32(float(st.box)))
        jp = jpt.LJParams.create()
        jspec = jpt.CellSpec(*spec)
        f, pot = jpt.lj_forces(js.pos, js.box, jp, jspec)
        out[n] = dict(
            st=st, params=params, spec=spec,
            table=np.asarray(jpt._build_cells(js.pos, js.box, jspec)),
            forces=np.asarray(f), pot=float(pot),
            after=jpt.lj_multi_step(js, jp, jspec, 5))
    return out


@pytest.mark.parametrize("n", [256, 2048])
def test_lj_forces_and_steps_match_reference(n, lj_reference):
    ref = lj_reference[n]
    st, params, spec = ref["st"], ref["params"], ref["spec"]
    np.testing.assert_array_equal(np_(tpt._build_cells(st.pos, st.box,
                                                       spec)), ref["table"])
    f, pot = tpt.lj_forces(st.pos, st.box, params, spec)
    scale = np.abs(ref["forces"]).max()
    np.testing.assert_allclose(np_(f), ref["forces"], rtol=0,
                               atol=1e-5 * scale)
    assert abs(float(pot) - ref["pot"]) <= 1e-5 * abs(ref["pot"])
    # blocks of particles change no number
    fb, potb = tpt.lj_forces(st.pos, st.box, params, spec, block=37)
    assert torch.equal(fb, f)
    assert abs(float(potb) - float(pot)) <= 1e-6 * abs(float(pot))
    got = tpt.lj_multi_step(st, params, spec, 5)
    np.testing.assert_allclose(np_(got.pos), np.asarray(ref["after"].pos),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np_(got.vel), np.asarray(ref["after"].vel),
                               rtol=0, atol=1e-4)
    assert abs(float(tpt.kinetic_energy(got))
               - float(jpt.kinetic_energy(ref["after"]))) \
        <= 1e-5 * float(jpt.kinetic_energy(ref["after"]))


def test_lj_physics():
    """The reference tests' physics on the port: energy conserved within
    2 % over 40 steps, forces equal to the brute-force sum, a crammed
    cell list's forces finite."""
    st, params, spec = tpt.lj_init(256, density=0.4, temperature=0.5,
                                   device=CPU)
    _, pot0 = tpt.lj_forces(st.pos, st.box, params, spec)
    e0 = float(tpt.kinetic_energy(st)) + float(pot0)
    st2 = tpt.lj_multi_step(st, params, spec, 40)
    _, pot2 = tpt.lj_forces(st2.pos, st2.box, params, spec)
    e2 = float(tpt.kinetic_energy(st2)) + float(pot2)
    assert abs(e2 - e0) / abs(e0) < 0.02, (e0, e2)

    st, params, spec = tpt.lj_init(64, density=0.3, device=CPU)
    f, _ = tpt.lj_forces(st.pos, st.box, params, spec)
    pos, box = np_(st.pos).astype(np.float64), float(st.box)
    dr = pos[:, None, :] - pos[None, :, :]
    dr -= box * np.round(dr / box)
    r2 = (dr ** 2).sum(-1) + np.eye(len(pos)) * 1e10
    inv6 = (1.0 / r2) ** 3
    fmag = 24 * (2 * inv6 ** 2 - inv6) / r2 * (r2 < 2.5 ** 2)
    assert np.abs(np_(f) - (fmag[..., None] * dr).sum(1)).max() < 1e-3

    st, params, spec = tpt.lj_init(128, density=2.0, device=CPU)
    f, _ = tpt.lj_forces(st.pos, st.box, params, spec)
    assert np.isfinite(np_(f)).all()


def test_particle_state_converts():
    st, params, spec = jpt.lj_init(64)
    got = convert.particle_state(st, CPU)
    np.testing.assert_array_equal(np_(got.pos), np.asarray(st.pos))
    assert float(got.box) == float(st.box)
    assert convert.cell_spec(spec) == tuple(spec)
    assert [float(x) for x in convert.lj_params(params, CPU)] == \
        [float(x) for x in params]
    sho, sp = jpt.sho_init(8)
    assert [float(x) for x in convert.sho_params(sp, CPU)] == \
        [float(x) for x in sp]


# ------------------------------------------------------------- the splat


def test_speed_colors_match_reference():
    vel = np.asarray(np.random.default_rng(1).normal(size=(256, 3)),
                     np.float32)
    for cmap in ("jet", "grays"):
        want = np.asarray(jsplat.speed_colors(jnp.asarray(vel), cmap))
        got = tsplat.speed_colors(torch.from_numpy(vel), cmap)
        np.testing.assert_allclose(np_(got), want, rtol=0, atol=1e-6)
    # the reference tests': monotone in speed, explicit stats
    rgba = np_(tsplat.speed_colors(torch.tensor(
        [[0.1, 0, 0], [1.0, 0, 0], [3.0, 0, 0]]), "grays"))
    assert rgba[0, 0] < rgba[1, 0] < rgba[2, 0] and (rgba[:, 3] == 1).all()
    v = torch.from_numpy(vel)
    speed = torch.sqrt((v * v).sum(-1))
    np.testing.assert_allclose(
        np_(tsplat.speed_colors(v, "jet", mean=speed.mean(),
                                std=speed.std(unbiased=False))),
        np_(tsplat.speed_colors(v, "jet")), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splat_matches_reference(seed):
    pos, vel = _cloud(2048, seed, -1.5, 1.5)
    jc, tc = _cams()
    rgba = np.array(jsplat.speed_colors(jnp.asarray(vel), "jet"))
    want = _jsplat(jnp.asarray(pos), jnp.asarray(rgba), jc)
    got = tsplat.splat_particles(torch.from_numpy(pos),
                                 torch.from_numpy(rgba), 0.15, tc, W, H,
                                 stamp=9)
    _splat_close(got, want)
    assert np.isfinite(np_(got.depth)).sum() > W * H // 4


def test_splat_view_proj_and_radii_match_reference():
    """Explicit view/proj (the hybrid frame's way) and per-particle
    radii."""
    pos, _ = _cloud(512, 5)
    rgba = np.random.default_rng(6).uniform(0, 1, (512, 4)).astype(
        np.float32)
    radii = np.random.default_rng(7).uniform(0.02, 0.2, 512).astype(
        np.float32)
    jc, tc = _cams((0.5, 0.8, 3.5))
    from scenery_insitu_tpu.core.camera import (projection_matrix,
                                                view_matrix)
    view, proj = view_matrix(jc), projection_matrix(jc, 40, 30)
    want = jsplat.splat_particles(jnp.asarray(pos), jnp.asarray(rgba), 0.1,
                                  None, 40, 30, 7, radii=jnp.asarray(radii),
                                  view=view, proj=proj)
    got = tsplat.splat_particles(
        torch.from_numpy(pos), torch.from_numpy(rgba), 0.1, None, 40, 30,
        7, radii=torch.from_numpy(radii),
        view=torch.from_numpy(np.asarray(view)),
        proj=torch.from_numpy(np.asarray(proj)))
    _splat_close(got, want)


def test_splat_tie_takes_the_last_fragment():
    """Coincident particles at the same depth: the reference's serial
    scatter on the CPU keeps the last fragment, and so does the port's
    deterministic rule (the largest flat fragment index)."""
    pos = np.array([[0, 0, 0], [0, 0, 0], [0.3, 0.1, 0], [0.3, 0.1, 0],
                    [0.3, 0.1, 0]], np.float32)
    rgba = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1],
                     [1, 1, 0, 1], [0, 1, 1, 0.5]], np.float32)
    jc, tc = _cams()
    want = jsplat.splat_particles(jnp.asarray(pos), jnp.asarray(rgba), 0.3,
                                  jc, W, H, stamp=11)
    got = tsplat.splat_particles(torch.from_numpy(pos),
                                 torch.from_numpy(rgba), 0.3, tc, W, H,
                                 stamp=11)
    np.testing.assert_array_equal(np_(got.depth), np.asarray(want.depth))
    np.testing.assert_allclose(np_(got.image), np.asarray(want.image),
                               atol=1e-6)
    img = np_(got.image)
    assert img[1, H // 2, W // 2] > 0 and img[0, H // 2, W // 2] == 0


def test_splat_reference_cases():
    """The reference's splat tests on the port."""
    jc, tc = _cams()
    out = tsplat.splat_particles(torch.tensor([[0.0, 0.0, 0.0]]),
                                 torch.tensor([[1.0, 0.0, 0.0, 1.0]]), 0.3,
                                 tc, W, H, stamp=11)
    img, dep = np_(out.image), np_(out.depth)
    cy, cx = H // 2, W // 2
    assert img[3, cy, cx] == 1.0 and img[0, cy, cx] > 0 and \
        img[1, cy, cx] == 0
    assert dep[cy, cx] == pytest.approx(5.0 - 0.3, abs=0.05)
    assert img[3, 0, 0] == 0.0 and np.isinf(dep[0, 0])
    out = tsplat.splat_particles(
        torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
        torch.tensor([[1.0, 0, 0, 1], [0, 1.0, 0, 1]]), 0.3, tc, W, H,
        stamp=11)
    assert np_(out.image)[1, cy, cx] > 0 and np_(out.image)[0, cy, cx] == 0
    out = tsplat.splat_particles(torch.tensor([[0.0, 0.0, 10.0]]),
                                 torch.ones((1, 4)), 0.3, tc, W, H)
    assert np_(out.image).max() == 0.0
    out = tsplat.splat_particles(torch.tensor([[0.0, 0.0, 0.0]]),
                                 torch.ones((1, 4)), 0.5, tc, W, H, stamp=15)
    img = np_(out.image)
    covered = img[3] > 0
    assert covered.sum() > 4 and img[0, cy, cx] == img[0][covered].max()
    assert img[0][covered].min() < img[0, cy, cx] * 0.8


# --------------------------------------------------- the sort-first step


@pytest.fixture(scope="module")
def sort_first():
    """The reference's 8-rank sort-first frame of 512 particles."""
    pos, vel = _cloud(64 * N_RANKS, 2)
    jc, _ = _cams()
    mesh = jmesh(N_RANKS)
    step = jpar.distributed_particle_step(mesh, W, H, radius=0.15, stamp=9)
    out = step(jpar.shard_particles(jnp.asarray(pos), mesh),
               jpar.shard_particles(jnp.asarray(vel), mesh), jc)
    return dict(pos=pos, vel=vel, out=out)


def test_sort_first_step_matches_reference_and_single_device(sort_first):
    pos, vel = sort_first["pos"], sort_first["vel"]
    _, tc = _cams()
    mesh = tmesh(N_RANKS, device=CPU)
    step = tpar.distributed_particle_step(mesh, W, H, radius=0.15, stamp=9)
    got = step(tpar.shard_particles(torch.from_numpy(pos), mesh),
               tpar.shard_particles(torch.from_numpy(vel), mesh), tc)
    assert got.image.shape == (4, H, W) and got.depth.shape == (H, W)
    _splat_close(got, sort_first["out"])
    one = tsplat.splat_particles(
        torch.from_numpy(pos), tsplat.speed_colors(torch.from_numpy(vel)),
        0.15, tc, W, H, stamp=9)
    _splat_agree(got, one)
    with pytest.raises(ValueError, match="divisible"):
        tpar.shard_particles(torch.zeros(9, 3), mesh)
    with pytest.raises(ValueError, match="rank shards"):
        step(torch.zeros(4, 2, 3), torch.zeros(4, 2, 3), tc)


# ----------------------------------------------------------- the LJ frame


@pytest.mark.parametrize("sim_steps", [0, 3])
def test_lj_frame_step_matches_reference(sim_steps):
    st, params, spec = tpt.lj_init(128, density=0.4, device=CPU)
    eye = (0.0, 0.0, float(st.box) * 1.6)
    want = jpipes.lj_particle_frame_step(
        W, H, jpt.LJParams.create(), jpt.CellSpec(*spec),
        sim_steps=sim_steps, radius=0.4)(
        jnp.asarray(np_(st.pos)), jnp.asarray(np_(st.vel)),
        jnp.float32(float(st.box)), jnp.asarray(eye, jnp.float32))
    step = tpipes.lj_particle_frame_step(W, H, params, spec,
                                         sim_steps=sim_steps, radius=0.4,
                                         device=CPU)
    img, dep, pos, vel = step(st.pos, st.vel, st.box, torch.tensor(eye))
    assert img.shape == (4, H, W) and np_(img)[3].max() > 0.0
    if sim_steps == 0:
        _splat_close(tsplat.SplatOutput(img, dep),
                     jsplat.SplatOutput(want[0], want[1]))
        np.testing.assert_array_equal(np_(pos), np_(st.pos))
    else:
        assert psnr(np_(img), np.asarray(want[0])) >= 60.0
        assert not np.allclose(np_(pos), np_(st.pos))
        np.testing.assert_allclose(np_(pos), np.asarray(want[2]), atol=1e-4)


# ------------------------------------------------------------ the sessions


SESSION_FRAMES = 3


def _overrides(kind, n, **extra):
    over = {"render.width": "32", "render.height": "24",
            "sim.kind": kind, "sim.num_particles": str(n),
            "sim.particle_radius": "0.3" if kind == "lennard_jones"
            else "0.05", "sim.steps_per_frame": "2",
            "vdi.adaptive_mode": "histogram", "mesh.num_devices": "2",
            "slicer.engine": "mxu"}
    over.update(extra)
    return [f"{k}={v}" for k, v in over.items()]


def _capture(store):
    def sink(index, payload):
        store[index] = payload
    return sink


def _state(kind, n):
    """The port's seeded start state of a particle session."""
    if kind == "lennard_jones":
        return tpt.lj_init(n, seed=3, device=CPU)[0]
    return tpt.sho_init(n, seed=3, device=CPU)[0]


def jax_session(kind, n, **extra):
    sess = jses.InSituSession(JConfig().with_overrides(
        *_overrides(kind, n, **extra)))
    st = _state(kind, n)
    sess.sim.state = jpt.ParticleState(jnp.asarray(np_(st.pos)),
                                       jnp.asarray(np_(st.vel)),
                                       jnp.float32(float(st.box)))
    return sess


def port_session(kind, n, state=True, **extra):
    sess = tses.InSituSession(TConfig().with_overrides(
        *_overrides(kind, n, **extra)), device=CPU)
    if state:
        sess.sim.state = _state(kind, n)
    return sess


CASES = [("lennard_jones", 64), ("sho", 32)]


@pytest.fixture(scope="module")
def particle_sessions(tmp_path_factory):
    """Per sim kind: the reference session's frames 0..3 and its
    checkpoint after frame 1."""
    out = {}
    for kind, n in CASES:
        frames = {}
        sess = jax_session(kind, n)
        sess.sinks.append(_capture(frames))
        sess.run(2)
        path = str(tmp_path_factory.mktemp("jpck") / f"{kind}.npz")
        jck.save_session(sess, path)
        sess.run(2)
        out[kind] = dict(frames=frames, ckpt=path, sess=sess)
    return out


def _payloads_agree(got, want, frames):
    """Session frames after sim steps: the frame step's bar after steps
    (>= 60 dB), the covered pixels equal but for 0.1 %, live depths
    within 1e-5 relative (the states differ by the ulps of their
    integration), the metadata within 1e-6."""
    for i in frames:
        assert got[i]["frame"] == want[i]["frame"] == i
        g, w = got[i], want[i]
        assert psnr(g["image"], np.asarray(w["image"])) >= 60.0
        gl, wl = np.isfinite(g["depth"]), np.isfinite(np.asarray(w["depth"]))
        assert (gl == wl).mean() >= AGREE
        both = gl & wl
        np.testing.assert_allclose(g["depth"][both],
                                   np.asarray(w["depth"])[both], rtol=1e-5)
        np.testing.assert_allclose(np_(g["meta"].view),
                                   np.asarray(w["meta"].view), atol=1e-6)
        assert float(g["meta"].nw) == float(w["meta"].nw) == 1.0


@pytest.mark.parametrize("kind,n", CASES)
def test_particle_session_matches_reference(kind, n, particle_sessions,
                                            tmp_path):
    ref = particle_sessions[kind]
    got = {}
    sess = port_session(kind, n)
    sess.sinks.append(_capture(got))
    assert sess.mode == "particles" and sess.prewarm_regimes() == {}
    last = sess.run(4)
    assert last["image"].shape == (4, 24, 32)
    assert last["depth"].shape == (24, 32)
    assert np.isfinite(last["image"]).all()
    _payloads_agree(got, ref["frames"], range(4))
    ref_sess = ref["sess"]
    np.testing.assert_allclose(np_(sess.sim.pos),
                               np.asarray(ref_sess.sim.pos), atol=1e-4)
    # the reference's checkpoint resumes in the port, and the port's
    # own resume is bit for bit
    c = port_session(kind, n, state=False)
    tck.load_session(c, ref["ckpt"])
    tail = {}
    c.sinks.append(_capture(tail))
    c.run(2)
    _payloads_agree(tail, ref["frames"], (2, 3))
    b = port_session(kind, n)
    b.run(2)
    path = str(tmp_path / "p.npz")
    tck.save_session(b, path)
    r = port_session(kind, n, state=False)
    tck.load_session(r, path)
    np.testing.assert_array_equal(r.run(2)["image"], got[3]["image"])
    # and the port's checkpoint resumes in the reference
    j = jses.InSituSession(JConfig().with_overrides(*_overrides(kind, n)))
    jck.load_session(j, path)
    jt = {}
    j.sinks.append(_capture(jt))
    j.run(2)
    _payloads_agree(got, jt, (2, 3))


def test_particle_sessions_ledger_inert_knobs():
    """A particle session composites sort-first: a hierarchy request is
    inert on the ledger and the flat mesh renders; fragment reuse and a
    rebalance are inert too (no volume fragment to carry or balance)."""
    tobs.clear_ledger()
    sess = port_session("lennard_jones", 64, **{
        "topology.num_hosts": "2", "composite.temporal_reuse": "ranges",
        "composite.rebalance": "occupancy"})
    assert sess.mesh.axis_names == ("ranks",) and sess.mesh.n == 2
    sess.run(1)
    comps = {e["component"] for e in tobs.ledger()}
    assert {"topology.hier", "delta.reuse", "occupancy.rebalance"} <= comps


def test_particle_session_checkpoint_rejects_mismatch(tmp_path):
    path = str(tmp_path / "m.npz")
    a = port_session("sho", 32)
    a.run(1)
    tck.save_session(a, path)
    with pytest.raises(ValueError, match="sim kind"):
        tck.load_session(port_session("lennard_jones", 64), path)
    with pytest.raises(ValueError, match="shape"):
        tck.load_session(port_session("sho", 64), path)


def test_particle_entry_points_without_cuda_raise(monkeypatch):
    """``device=None`` means CUDA: every new particle entry point raises
    without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tpt.sho_init(8),
        lambda: tpt.lj_init(8),
        lambda: tpt.LJParams.create(),
        lambda: tpipes.lj_particle_frame_step(
            W, H, None, tpt.CellSpec(3, 8)),
        lambda: tses.InSituSession(TConfig().with_overrides(
            *_overrides("sho", 8))),
        lambda: convert.particle_state((np.zeros((1, 3)), np.zeros((1, 3)),
                                        1.0)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

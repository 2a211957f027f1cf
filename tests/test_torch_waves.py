"""Parity of the port's tile waves (``CompositeConfig.schedule="waves"``)
with the JAX package's, on the CPU.

The slicer's wave helpers are held exactly against the reference's. The
4-rank distributed mxu temporal step (the seed and 2 frames) runs in
waves of T = 2 under the ``all_to_all`` and the ``ring`` exchange, in
both march regimes, against the reference's same steps at the ``xla``
fold bar of ``tests/test_torch_parallel.py`` (rtol 1e-4, atol 1e-5),
and against the port's own frame schedule within 1e-6 (VDI, threshold
maps and metadata), with the histogram step too. A waves request on one
rank degrades to the frame on the ledger; the build's counters and
event carry the reference's modeled traffic. The in-situ session runs
the ring in waves over 4 ranks against the reference's session (as
``tests/test_torch_session.py`` does), and its tile sinks receive every
tile in ascending column order before the frame's sinks, directly and
through the delivery worker."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import composite as jcomp
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.io import vdi_io as tio
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.runtime import session as tses
from tests.test_torch_parallel import EYES, N, _args, _check_meta, _setup
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, np_, one_torch_thread)
from tests.test_torch_session import (_capture, assert_payloads_close,
                                      jax_session, port_session)

RTOL, ATOL = 1e-4, 1e-5
K, K_OUT = 10, 16
T = 2
EXCHANGES = ["all_to_all", "ring"]


@pytest.mark.parametrize("w", [0, 1, 2])
def test_wave_helpers_match_reference(w):
    rng = np.random.default_rng(w)
    x = rng.random((3, 5, 24), dtype=np.float32)
    xw = rng.random((3, 5, 12), dtype=np.float32)
    got = tsl.wave_cols(torch.from_numpy(x), 4, 3, w)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsl.wave_cols(jnp.asarray(x), 4, 3, w)))
    xw = xw[..., :got.shape[-1]]
    got = tsl.wave_update_cols(torch.from_numpy(x), torch.from_numpy(xw),
                               4, 3, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jsl.wave_update_cols(jnp.asarray(x), jnp.asarray(xw), 4, 3, w)))
    # the update touches wave w's columns only, and round-trips
    back = tsl.wave_cols(got, 4, 3, w)
    np.testing.assert_array_equal(back.numpy(), xw)
    assert tsl.wave_block(24, 4, 3) == jsl.wave_block(24, 4, 3) == 2


def test_wave_block_and_camera_match_reference():
    with pytest.raises(ValueError) as a:
        jsl.wave_block(24, 4, 4)
    with pytest.raises(ValueError) as b:
        tsl.wave_block(24, 4, 4)
    assert str(a.value) == str(b.value)
    s = _setup(EYES[0])
    jv = jvol.Volume(jnp.asarray(s["data"]), jnp.asarray(s["origin"]),
                     jnp.asarray(s["spacing"]))
    tv = tvol.Volume(*(torch.from_numpy(s[k]) for k in
                       ("data", "origin", "spacing")))
    jax_cam = jsl.make_axis_camera(jv, s["jc"], s["jspec"])
    tax_cam = tsl.make_axis_camera(tv, s["tc"], s["tspec"])
    for w in range(T):
        jcw, jspw = jsl.wave_camera(jax_cam, s["jspec"], N, T, w)
        tcw, tspw = tsl.wave_camera(tax_cam, s["tspec"], N, T, w)
        assert tspw.ni == jspw.ni == s["tspec"].ni // T
        np.testing.assert_allclose(tcw.u_grid.numpy(),
                                   np.asarray(jcw.u_grid), atol=1e-6)


@pytest.fixture(scope="module", params=range(len(EYES)),
                ids=["z_march", "x_march"])
def steps(request):
    """Per march regime: the reference's seed and 2 temporal frames in
    waves under each exchange."""
    s = _setup(EYES[request.param])
    vcfg = jcfg.VDIConfig(max_supersegments=K, adaptive_mode="temporal")
    jthr0 = jpipe.distributed_initial_threshold_mxu(
        s["jmesh"], s["jtf"], s["jspec"], vcfg)(*_args(s, "j"))
    out = {"s": s, "jthr0": jthr0}
    for ex in EXCHANGES:
        step = jpipe.distributed_vdi_step_mxu_temporal(
            s["jmesh"], s["jtf"], s["jspec"], vcfg,
            jcfg.CompositeConfig(max_output_supersegments=K_OUT,
                                 exchange=ex, schedule="waves",
                                 wave_tiles=T))
        thr, frames = jthr0, []
        for _ in range(2):
            (vdi, meta), thr = step(*_args(s, "j"), thr)
            frames.append((vdi, meta, thr))
        out[ex] = frames
    return out


def _port_step(s, exchange, schedule, temporal=True):
    vcfg = tcfg.VDIConfig(max_supersegments=K, adaptive_mode=(
        "temporal" if temporal else "histogram"))
    ccfg = tcfg.CompositeConfig(max_output_supersegments=K_OUT,
                                exchange=exchange, schedule=schedule,
                                wave_tiles=T)
    build = (tpipe.distributed_vdi_step_mxu_temporal if temporal
             else tpipe.distributed_vdi_step_mxu)
    return build(s["tmesh"], s["ttf"], s["tspec"], vcfg, ccfg)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_waves_temporal_steps_match_reference_and_frame(steps, exchange):
    """The waves' VDI and carried threshold maps against the reference's
    waves at the ``xla`` bar, and against the port's own frame schedule
    within 1e-6 (the meta equal)."""
    s = steps["s"]
    jthr0 = steps["jthr0"]
    thr0 = convert.threshold_state(
        {f: np.asarray(x) for f, x in zip(jthr0._fields, jthr0)},
        device="cpu")
    waves = _port_step(s, exchange, "waves")
    frame = _port_step(s, exchange, "frame")
    thr, fthr = thr0, thr0
    for jvdi, jmeta, jthr in steps[exchange]:
        (tvdi, tmeta), thr = waves(*_args(s, "t"), thr)
        (fvdi, fmeta), fthr = frame(*_args(s, "t"), fthr)
        assert_vdi_close(tvdi.color, tvdi.depth, jvdi.color, jvdi.depth,
                         RTOL, ATOL)
        for a, b in zip(thr, jthr):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
        assert_vdi_close(tvdi.color, tvdi.depth, fvdi.color, fvdi.depth,
                         0.0, 1e-6)
        for a, b in zip(thr, fthr):
            np.testing.assert_allclose(np_(a), np_(b), rtol=0, atol=1e-6)
        for a, b in zip(tmeta, fmeta):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    _check_meta(tmeta, jmeta)
    assert np.isfinite(np_(tvdi.depth)[:, 0]).any(), "live slots"


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("eye", EYES, ids=["z_march", "x_march"])
def test_waves_histogram_step_equals_frame(eye, exchange):
    """The histogram step (its threshold counted per wave) in waves
    against the frame schedule within 1e-6."""
    s = _setup(eye)
    wv, wm = _port_step(s, exchange, "waves", temporal=False)(*_args(s, "t"))
    fv, fm = _port_step(s, exchange, "frame", temporal=False)(*_args(s, "t"))
    assert_vdi_close(wv.color, wv.depth, fv.color, fv.depth, 0.0, 1e-6)
    for a, b in zip(wm, fm):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wave_geometry_rejected_at_build():
    """A width that does not split into ranks * wave_tiles raises when
    the step is built, with the reference's message."""
    s = _setup(EYES[0])
    ni = s["tspec"].ni
    t = next(t for t in range(2, ni) if ni % (N * t))
    with pytest.raises(ValueError) as a:
        jsl.wave_block(ni, N, t)
    with pytest.raises(ValueError) as b:
        tpipe.distributed_vdi_step_mxu(
            s["tmesh"], s["ttf"], s["tspec"],
            tcfg.VDIConfig(max_supersegments=K),
            tcfg.CompositeConfig(schedule="waves", wave_tiles=t))
    assert str(a.value) == str(b.value)
    with pytest.raises(ValueError) as a:
        jcfg.CompositeConfig(wave_tiles=0)
    with pytest.raises(ValueError) as b:
        tcfg.CompositeConfig(wave_tiles=0)
    assert str(a.value) == str(b.value)


def test_waves_single_rank_degrades_to_frame():
    s = _setup(EYES[0])
    mesh = tmesh.make_mesh(1, device="cpu")
    args = (tmesh.shard_volume(torch.from_numpy(s["data"]), mesh),) + \
        _args(s, "t")[1:]
    tobs.clear_ledger()
    vdis = [tpipe.distributed_vdi_step_mxu(
        mesh, s["ttf"], s["tspec"], tcfg.VDIConfig(max_supersegments=K),
        tcfg.CompositeConfig(max_output_supersegments=K_OUT,
                             schedule=sched, wave_tiles=T))(*args)[0]
        for sched in ("waves", "frame")]
    for a, b in zip(vdis[0], vdis[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(e["component"] == "composite.schedule"
               and e["from"] == "waves" and e["to"] == "frame"
               for e in tobs.ledger())


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_waves_build_counts_and_models_traffic(exchange):
    """One wave schedule built: ``wave_schedule_builds`` once and
    ``wave_steps_built`` T, at build time; the event carries the
    reference's modeled overlap accounting. A ring in waves is one ring
    build over the wave's width."""
    s = _setup(EYES[0])
    rec = tobs.Recorder(enabled=True)
    prev = tobs.set_recorder(rec)
    try:
        step = _port_step(s, exchange, "waves", temporal=False)
        step(*_args(s, "t"))
        step(*_args(s, "t"))
    finally:
        tobs.set_recorder(prev)
    assert rec.counters["wave_schedule_builds"] == 1
    assert rec.counters["wave_steps_built"] == T
    nj, ni = s["tspec"].nj, s["tspec"].ni
    ev = [e["attrs"] for e in rec.events
          if e["name"] == "wave_schedule_build"][0]
    assert ev["march_per_wave"] and ev["tiles"] == T
    assert (ev["wave_cols"], ev["tile_cols"]) == (ni // T, ni // (N * T))
    assert ev["traffic"] == jcomp.modeled_exchange_traffic(
        N, K, nj, ni, k_out=K_OUT, mode=exchange, wire="f32",
        schedule="waves", wave_tiles=T)
    assert rec.counters.get("ring_exchange_builds", 0) == \
        (exchange == "ring")
    if exchange == "ring":
        ring = [e["attrs"] for e in rec.events
                if e["name"] == "ring_exchange_build"][0]
        assert ring["traffic"] == jcomp.modeled_exchange_traffic(
            N, K, nj, ni // T, k_out=K_OUT, mode="ring", wire="f32")


# ------------------------------------------------------------- session

WAVES = {"composite.exchange": "ring", "composite.schedule": "waves",
         "composite.wave_tiles": str(T)}
FRAMES = 3


@pytest.fixture(scope="module")
def ref_session():
    frames = {}
    sess = jax_session(4, "temporal", **WAVES)
    sess.sinks.append(_capture(frames))
    sess.run(FRAMES)
    return frames


def _tile_log(events):
    def sink(index, payload):
        events.append(("tile", index, payload["tile"], payload["col0"],
                       payload["tiles"], payload["vdi_color"].copy(),
                       payload["vdi_depth"].copy()))
    return sink


@pytest.mark.parametrize("delivery", [False, True],
                         ids=["direct", "delivery"])
def test_session_waves_matches_reference_with_tiles(ref_session, delivery,
                                                    tmp_path):
    """The port's 4-rank ring session in waves gives the reference's
    frames; every frame's tiles arrive in ascending column order before
    its frame sinks, and side by side equal the frame bit for bit."""
    events, frames = [], {}
    extra = dict(WAVES)
    if delivery:
        extra["delivery.enabled"] = "true"
    sess = port_session(4, "temporal", sinks=[_capture(frames)], **extra)
    sess.sinks.insert(0, lambda i, p: events.append(("frame", i)))
    sess.tile_sinks.append(_tile_log(events))
    sess.tile_sinks.append(tses.vdi_tile_sink(str(tmp_path), codec="zlib"))
    sess.run(FRAMES)
    assert_payloads_close(frames, ref_session, range(FRAMES))
    tiles_total = 4 * T
    for f in range(FRAMES):
        tiles = [e for e in events if e[0] == "tile" and e[1] == f]
        assert [t[2] for t in tiles] == list(range(tiles_total))
        assert all(t[4] == tiles_total for t in tiles)
        wb = frames[f]["vdi_color"].shape[-1] // tiles_total
        assert [t[3] for t in tiles] == [i * wb for i in range(tiles_total)]
        fi = events.index(("frame", f))
        assert all(events.index(t) < fi for t in tiles)
        np.testing.assert_array_equal(
            np.concatenate([t[5] for t in tiles], -1), frames[f]["vdi_color"])
        np.testing.assert_array_equal(
            np.concatenate([t[6] for t in tiles], -1), frames[f]["vdi_depth"])
        # the dumped tiles reassemble the frame too
        cols = []
        for t in range(tiles_total):
            vdi, _, place = tio.load_vdi_tile(tio.dump_path(
                str(tmp_path), "session", f, f"vditile{t:02d}"))
            assert place == (t, tiles_total, t * wb)
            cols.append(vdi.color)
        np.testing.assert_array_equal(np.concatenate(cols, -1),
                                      frames[f]["vdi_color"])
    assert sess.obs.counters.get("tiles_delivered", 0) == \
        FRAMES * tiles_total

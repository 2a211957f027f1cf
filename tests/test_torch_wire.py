"""Parity of the port's supersegment wire formats (``ops/wire.py``) and
exchange traffic model with the JAX package's, on the CPU.

The codecs get the same numpy-seeded fragments in both packages: the
bf16 and qpack8 codes and scales bit for bit, the decoded values at rtol
1e-6, atol 1e-7, with the reference's unit cases (empty-slot sentinels,
a fully empty fragment, near == far, sort and tie order kept). The numpy
quantizer twins and ``modeled_exchange_traffic`` are compared exactly.
The lossy wires then run through the 4-rank distributed temporal step
in both march regimes, under both exchanges: the rendered image at least
60 dB from the reference's same configuration, not bitwise the f32
wire's and at least 40 dB from it (the reference's threading checks),
and the threshold maps equal to the reference's and to f32's within
1e-6 (they are upstream of the exchange)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import vdi as jvdi
from scenery_insitu_tpu.ops import composite as jcomp
from scenery_insitu_tpu.ops import wire as jwire
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu.utils import image as jimg
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
from scenery_insitu_tpu_torch.ops import composite as tcomp
from scenery_insitu_tpu_torch.ops import wire as twire
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from tests.test_torch_parallel import EYES, _args, _setup
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401

LOSSY = ("bf16", "qpack8")
RTOL, ATOL = 1e-6, 1e-7
K, K_OUT = 6, 8


def _stream(rng, k, h, w, live, lo=1.0, hi=5.0, lead=()):
    """A per-pixel depth-sorted fragment with ``live`` live slots (empty
    slots: zero colour, +inf depth), as numpy; ``lead`` leading dims."""
    shape = lead + (k, h, w)
    s = np.sort(rng.uniform(lo, hi, shape), axis=-3).astype(np.float32)
    e = (s + rng.uniform(0.01, 0.2, shape)).astype(np.float32)
    c = rng.uniform(0.0, 1.0, lead + (k, 4, h, w)).astype(np.float32)
    mask = np.arange(k)[:, None, None] < live
    s = np.where(mask, s, np.inf).astype(np.float32)
    e = np.where(mask, e, np.inf).astype(np.float32)
    c = np.where(mask[:, None], c, 0.0).astype(np.float32)
    return c, np.stack([s, e], axis=-3)


def _bf16_np(x):
    """A bf16 tensor's bits as numpy uint16 (numpy has no bfloat16)."""
    return x.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("case", ["sorted", "fully_empty", "near_eq_far",
                                  "batched"])
@pytest.mark.parametrize("wire", LOSSY)
def test_codes_and_decode_match_reference(wire, case):
    """The codes and scale bit for bit, the decoded fragment at rtol
    1e-6, atol 1e-7, the empty slots' sentinels exact."""
    rng = np.random.default_rng(11)
    if case == "batched":
        c, d = _stream(rng, 5, 3, 4, live=3, lead=(3,))
    else:
        c, d = _stream(rng, 5, 3, 4, live=0 if case == "fully_empty" else 3)
    if case == "near_eq_far":
        d = np.where(np.isfinite(d), np.float32(2.5), d).astype(np.float32)
    tc, td, ts = twire.encode_fragment(torch.from_numpy(c),
                                       torch.from_numpy(d), wire)
    jc, jd, js = jwire.encode_fragment(jnp.asarray(c), jnp.asarray(d), wire)
    if wire == "bf16":
        assert ts is None and js is None
        np.testing.assert_array_equal(_bf16_np(tc),
                                      np.asarray(jc).view(np.uint16))
        np.testing.assert_array_equal(_bf16_np(td),
                                      np.asarray(jd).view(np.uint16))
    else:
        assert (tc.dtype, td.dtype) == (torch.uint32, torch.uint16)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if case == "fully_empty":
            assert ts.tolist() == [0.0, 1.0]
            assert (td.numpy() == 0xFFFF).all()
    oc, od = twire.decode_fragment(tc, td, ts, wire)
    rc, rd = jwire.decode_fragment(jc, jd, js, wire)
    np.testing.assert_allclose(np_(oc), np.asarray(rc), rtol=RTOL,
                               atol=ATOL)
    fin = np.isfinite(np.asarray(rd))
    np.testing.assert_array_equal(np.isfinite(np_(od)), fin)
    np.testing.assert_array_equal(np.isinf(np_(od)), ~fin)
    np.testing.assert_allclose(np_(od)[fin], np.asarray(rd)[fin],
                               rtol=RTOL, atol=ATOL)
    # the sentinel: every empty slot decodes to +inf, zero colour
    np.testing.assert_array_equal(np.isinf(np_(od)), np.isinf(d))


def test_batched_scales_decode_per_source():
    """After the exchange every destination decodes source s against
    its own scale: a ``[n, 2]`` scale broadcast over ``[n, K, H, W]``
    codes, as the reference decodes an all_gathered scale."""
    rng = np.random.default_rng(12)
    frags = [_stream(rng, 4, 3, 5, live=2 + i, lo=1.0 + i, hi=2.0 + 2 * i)
             for i in range(3)]
    enc = [twire.encode_fragment(torch.from_numpy(c), torch.from_numpy(d),
                                 "qpack8") for c, d in frags]
    tc, td, ts = (torch.stack([e[i] for e in enc]) for i in range(3))
    jenc = [jwire.encode_fragment(jnp.asarray(c), jnp.asarray(d), "qpack8")
            for c, d in frags]
    jc, jd, js = (jnp.stack([e[i] for e in jenc]) for i in range(3))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    oc, od = twire.decode_fragment(tc, td, ts, "qpack8")
    rc, rd = jwire.decode_fragment(jc, jd, js, "qpack8")
    np.testing.assert_allclose(oc.numpy(), np.asarray(rc), rtol=RTOL,
                               atol=ATOL)
    fin = np.isfinite(np.asarray(rd))
    np.testing.assert_array_equal(np.isfinite(od.numpy()), fin)
    np.testing.assert_allclose(od.numpy()[fin], np.asarray(rd)[fin],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wire", LOSSY)
def test_roundtrip_keeps_sort_and_ties(wire):
    """Both quantizers are monotone: a sorted stream decodes sorted, and
    equal start depths stay equal (the ring merge's precondition)."""
    rng = np.random.default_rng(13)
    c, d = _stream(rng, 6, 4, 4, live=6)
    d[3, 0] = d[2, 0]                          # a tie in every pixel
    d[3, 1] = np.maximum(d[3, 1], d[3, 0])
    _, od = twire.decode_fragment(*twire.encode_fragment(
        torch.from_numpy(c), torch.from_numpy(d), wire), wire)
    s = od[:, 0].numpy()
    assert (np.diff(s, axis=0) >= 0).all()
    np.testing.assert_array_equal(s[3], s[2])


def test_f32_is_identity_and_unknown_wire_raises():
    rng = np.random.default_rng(14)
    c, d = (torch.from_numpy(x) for x in _stream(rng, 3, 2, 2, live=2))
    ec, ed, sc = twire.encode_fragment(c, d, "f32")
    assert ec is c and ed is d and sc is None
    for fn, args in ((twire.encode_fragment, (c, d)),
                     (twire.decode_fragment, (c, d, None)),
                     (twire.wire_slot_bytes, ())):
        with pytest.raises(ValueError) as a:
            fn(*args, "f16")
        with pytest.raises(ValueError) as b:
            getattr(jwire, fn.__name__)(
                *(jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor)
                  else x for x in args), "f16")
        assert str(a.value) == str(b.value)
    assert twire.WIRE_SLOT_BYTES == jwire.WIRE_SLOT_BYTES
    assert twire.WIRE_CODES == jwire.WIRE_CODES
    assert twire.WIRE_FORMATS == jwire.WIRE_FORMATS


@pytest.mark.parametrize("wire", LOSSY)
def test_plain_codec_matches_reference(wire):
    rng = np.random.default_rng(15)
    img = rng.uniform(0.0, 1.0, (2, 4, 5, 6)).astype(np.float32)
    dep = rng.uniform(1.0, 3.0, (2, 5, 6)).astype(np.float32)
    dep[:, ::2, ::3] = np.inf
    t = twire.encode_plain(torch.from_numpy(img), torch.from_numpy(dep),
                           wire)
    j = jwire.encode_plain(jnp.asarray(img), jnp.asarray(dep), wire)
    for a, b in zip(t[:2], j[:2]):
        if wire == "bf16":
            np.testing.assert_array_equal(_bf16_np(a),
                                          np.asarray(b).view(np.uint16))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ti, td = twire.decode_plain(*t, wire)
    ji, jd = jwire.decode_plain(*j, wire)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL,
                               atol=ATOL)
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(td.numpy()), fin)
    np.testing.assert_allclose(td.numpy()[fin], np.asarray(jd)[fin],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("live", [0, 2, 5])
def test_qpack8_numpy_twins_match_reference_exactly(live):
    """The host quantizer twins equal the reference's exactly, and equal
    the port's tensor encode's codes."""
    rng = np.random.default_rng(16 + live)
    c, d = _stream(rng, 5, 4, 6, live=live)
    tq = twire.qpack8_quantize_np(c, d)
    jq = jwire.qpack8_quantize_np(c, d)
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    ec, ed, sc = twire.encode_fragment(torch.from_numpy(c),
                                       torch.from_numpy(d), "qpack8")
    np.testing.assert_array_equal(ec.numpy(), tq[0])
    np.testing.assert_array_equal(ed.numpy(), tq[1])
    assert sc.tolist() == [np.float32(tq[2]), np.float32(tq[3])]
    for a, b in zip(twire.qpack8_dequantize_np(*tq),
                    jwire.qpack8_dequantize_np(*jq)):
        np.testing.assert_array_equal(a, b)


TRAFFIC = [dict(n=n, k=k, height=h, width=w, k_out=ko, mode=m,
                ring_slots=rs, wire=wi, schedule=sc, wave_tiles=t)
           for (n, k, h, w, ko), m, rs, wi, (sc, t) in itertools.product(
               [(8, 16, 720, 1280, 16), (4, 6, 24, 24, None),
                (1, 10, 64, 60, 8)],
               ["all_to_all", "ring"], [0, 12], ["f32", "bf16", "qpack8"],
               [("frame", 1), ("waves", 4), ("waves", 3)])]


@pytest.mark.parametrize("kw", TRAFFIC, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_modeled_exchange_traffic_matches_reference(kw):
    assert tcomp.modeled_exchange_traffic(**kw) == \
        jcomp.modeled_exchange_traffic(**kw)


# ------------------------------------------------ the distributed step


def _psnr(a, b):
    return jimg.psnr(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module", params=range(len(EYES)),
                ids=["z_march", "x_march"])
def frames(request):
    """Per march regime: the seed and 2 temporal frames of the 4-rank
    step under each (exchange, wire), in both packages; the images of
    the last frame and its threshold maps."""
    s = _setup(EYES[request.param])
    vcfg = dict(max_supersegments=K, adaptive_mode="temporal")
    jthr0 = jpipe.distributed_initial_threshold_mxu(
        s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**vcfg))(
            *_args(s, "j"))
    tthr0 = tpipe.distributed_initial_threshold_mxu(
        s["tmesh"], s["ttf"], s["tspec"], tcfg.VDIConfig(**vcfg))(
            *_args(s, "t"))
    out = {}
    combos = [("all_to_all", "f32"), ("all_to_all", "bf16"),
              ("all_to_all", "qpack8"), ("ring", "qpack8")]
    for ex, wire in combos:
        ccfg = dict(max_output_supersegments=K_OUT, exchange=ex, wire=wire)
        tstep = tpipe.distributed_vdi_step_mxu_temporal(
            s["tmesh"], s["ttf"], s["tspec"], tcfg.VDIConfig(**vcfg),
            tcfg.CompositeConfig(**ccfg))
        tthr = tthr0
        for _ in range(2):
            (tvdi, _), tthr = tstep(*_args(s, "t"), tthr)
        entry = dict(timg=np_(render_vdi_same_view(tvdi)),
                     tthr=[np_(x) for x in tthr])
        if wire != "f32":
            jstep = jpipe.distributed_vdi_step_mxu_temporal(
                s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**vcfg),
                jcfg.CompositeConfig(**ccfg))
            jthr = jthr0
            for _ in range(2):
                (jv, _), jthr = jstep(*_args(s, "j"), jthr)
            entry.update(jimg=np.asarray(jvdi.render_vdi_same_view(jv)),
                         jthr=[np.asarray(x) for x in jthr])
        out[(ex, wire)] = entry
    return out


@pytest.mark.parametrize("ex,wire", [("all_to_all", "bf16"),
                                     ("all_to_all", "qpack8"),
                                     ("ring", "qpack8")])
def test_lossy_wire_step_matches_reference(frames, ex, wire):
    got, f32 = frames[(ex, wire)], frames[("all_to_all", "f32")]
    assert np.isfinite(got["timg"]).all()
    q = _psnr(got["timg"], got["jimg"])
    assert q >= 60.0, f"{ex}/{wire} vs the reference: {q:.1f} dB"
    # the reference's threading checks: the wire engaged, within its floor
    assert not np.array_equal(got["timg"], f32["timg"])
    q = _psnr(got["timg"], f32["timg"])
    assert q >= 40.0, f"{ex}/{wire} vs f32: {q:.1f} dB"
    for a, b, c in zip(got["tthr"], got["jthr"], f32["tthr"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)


def test_wire_build_counts_once_a_step():
    """A lossy wire's step counts ``wire_encode_builds`` once when it is
    built, with the reference's event; f32 counts nothing."""
    from scenery_insitu_tpu_torch import obs as tobs

    s = _setup(EYES[0])
    for wire, want in (("f32", 0), ("qpack8", 1), ("bf16", 1)):
        rec = tobs.Recorder(enabled=True)
        prev = tobs.set_recorder(rec)
        try:
            step = tpipe.distributed_vdi_step_mxu(
                s["tmesh"], s["ttf"], s["tspec"],
                tcfg.VDIConfig(max_supersegments=K),
                tcfg.CompositeConfig(max_output_supersegments=K_OUT,
                                     wire=wire))
            step(*_args(s, "t"))
            step(*_args(s, "t"))
        finally:
            tobs.set_recorder(prev)
        assert rec.counters.get("wire_encode_builds", 0) == want
        ev = [e for e in rec.events if e.get("name") == "wire_encode"]
        assert len(ev) == want
        if want:
            assert ev[0]["attrs"] == dict(
                wire=wire, bytes_per_slot=sum(twire.wire_slot_bytes(wire)))


def test_one_rank_lossy_wire_quantizes_like_reference():
    """On one rank the all_to_all path still ships through the codec,
    as the reference's does: the qpack8 VDI equals the dequantized f32
    VDI's codes."""
    s = _setup(EYES[0])
    from scenery_insitu_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh(1, device="cpu")
    args = (tmesh.shard_volume(torch.from_numpy(s["data"]), mesh),) + \
        _args(s, "t")[1:]
    vdis = {}
    for wire in ("f32", "qpack8"):
        vdis[wire], _ = tpipe.distributed_vdi_step_mxu(
            mesh, s["ttf"], s["tspec"], tcfg.VDIConfig(max_supersegments=K),
            tcfg.CompositeConfig(max_output_supersegments=K, wire=wire))(
                *args)
    f = vdis["f32"]
    want = twire.decode_fragment(*twire.encode_fragment(
        f.color, f.depth, "qpack8"), "qpack8")
    np.testing.assert_array_equal(np_(vdis["qpack8"].color), np_(want[0]))
    np.testing.assert_array_equal(np_(vdis["qpack8"].depth), np_(want[1]))

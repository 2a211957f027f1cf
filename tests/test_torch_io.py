"""Parity of the port's VDI artifacts and images with the JAX package's,
on the CPU: ``.npz`` VDIs written by one package load in the other
(codecs none, zlib, lzma, and zstd with its zlib degrade) with their
metadata and tile placement; column segments packed by one unpack in the
other; ``save_png``'s decoded pixels equal the reference's (which writes
through PIL); the codecs and formats still to port raise naming their
ROADMAP row. Values made from a seed with numpy; comparisons exact."""

import numpy as np
import pytest
import torch
from PIL import Image

from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import vdi as jvdi
from scenery_insitu_tpu.io import vdi_io as jio
from scenery_insitu_tpu.utils import image as jimg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import vdi as tvdi
from scenery_insitu_tpu_torch.io import vdi_io as tio
from scenery_insitu_tpu_torch.utils import image as timg
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

CODECS = ["none", "zlib", "lzma", "zstd"]


def _vdi(k=4, h=6, w=8, seed=0):
    """A VDI with empty slots (+inf depth, zero colour), as numpy."""
    rng = np.random.default_rng(seed)
    color = rng.random((k, 4, h, w), dtype=np.float32)
    depth = np.sort(rng.random((k, 2, h, w), dtype=np.float32) * 5, axis=1)
    empty = rng.random((k, 1, h, w)) < 0.3
    color = np.where(empty, 0.0, color).astype(np.float32)
    depth = np.where(empty, np.inf, depth).astype(np.float32)
    return color, depth


def _meta(seed=1):
    rng = np.random.default_rng(seed)
    return dict(projection=rng.random((4, 4), dtype=np.float32),
                view=rng.random((4, 4), dtype=np.float32),
                volume_dims=(16, 16, 32), window_dims=(8, 6), nw=0.125,
                index=7)


def _np_meta(meta):
    return {f: np.asarray(convert.to_numpy(getattr(meta, f)))
            for f in meta._fields}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("tile", [None, (1, 4, 8)])
def test_vdi_artifacts_cross_load(codec, tile, tmp_path):
    color, depth = _vdi()
    m = _meta()
    jmeta = jvdi.VDIMetadata.create(**m)
    tmeta = tvdi.VDIMetadata.create(
        projection=torch.from_numpy(m["projection"]),
        **{k: v for k, v in m.items() if k != "projection"})
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jn = jio.save_vdi(jpath, jvdi.VDI(color, depth), jmeta, codec=codec,
                      tile=tile)
    tn = tio.save_vdi(tpath, tvdi.VDI(torch.from_numpy(color),
                                      torch.from_numpy(depth)), tmeta,
                      codec=codec, tile=tile, workers=2)
    assert tn == jn, "the same bytes"
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    for load, path in ((tio.load_vdi_tile, jpath), (jio.load_vdi_tile, tpath)):
        vdi, meta, placement = load(path)
        np.testing.assert_array_equal(np.asarray(vdi.color), color)
        np.testing.assert_array_equal(np.asarray(vdi.depth), depth)
        assert placement == tile
        got = _np_meta(meta)
        for f, want in _np_meta(jmeta).items():
            np.testing.assert_array_equal(got[f], want)


def test_vdi_artifact_without_meta(tmp_path):
    color, depth = _vdi(seed=3)
    path = str(tmp_path / "a.npz")
    tio.save_vdi(path, tvdi.VDI(color, depth), codec="zlib")
    vdi, meta = jio.load_vdi(path)
    np.testing.assert_array_equal(np.asarray(vdi.depth), depth)
    assert meta is None
    assert tio.load_vdi_tile(path)[2] is None


def test_zstd_degrades_to_zlib(monkeypatch, tmp_path):
    """Without zstandard, the writers degrade the default codec to zlib
    through the ledger, as the reference's do."""
    monkeypatch.setattr(tio, "_ZSTD_OK", False)
    monkeypatch.setattr(jio, "_ZSTD_OK", False)
    tobs.clear_ledger()
    jobs.clear_ledger()
    with pytest.warns(UserWarning, match="zstd"):
        assert tio.resolve_codec("zstd") == "zlib"
    with pytest.warns(UserWarning, match="zstd"):
        assert jio.resolve_codec("zstd") == "zlib"
    strip = lambda obs: [{k: v for k, v in e.items() if k != "t"}
                         for e in obs.ledger()]
    assert strip(tobs) == strip(jobs)
    color, depth = _vdi(seed=4)
    path = str(tmp_path / "z.npz")
    tio.save_vdi(path, tvdi.VDI(color, depth))
    with np.load(path) as z:
        assert bytes(z["__codec__"]).decode() == "zlib"
    np.testing.assert_array_equal(np.asarray(jio.load_vdi(path)[0].color),
                                  color)
    assert tio.resolve_codec("lzma") == "lzma"


@pytest.mark.parametrize("codec", ["none", "zlib", "lzma", "zstd"])
def test_segments_cross_load(codec):
    color, depth = _vdi(k=3, h=4, w=12, seed=5)
    tblobs, tcl, tdl = tio.pack_vdi_segments(
        tvdi.VDI(torch.from_numpy(color), torch.from_numpy(depth)), 3,
        codec=codec)
    jblobs, jcl, jdl = jio.pack_vdi_segments(jvdi.VDI(color, depth), 3,
                                             codec=codec)
    assert tblobs == jblobs
    np.testing.assert_array_equal(tcl, jcl)
    np.testing.assert_array_equal(tdl, jdl)
    for unpack, blobs in ((tio.unpack_vdi_segments, jblobs),
                          (jio.unpack_vdi_segments, tblobs)):
        vdi = unpack(blobs, 3, 4, 12, codec=codec)
        np.testing.assert_array_equal(np.asarray(vdi.color), color)
        np.testing.assert_array_equal(np.asarray(vdi.depth), depth)
    with pytest.raises(ValueError, match="not divisible"):
        tio.pack_vdi_segments(tvdi.VDI(color, depth), 5)


def test_codecs_and_paths_match(tmp_path):
    data = np.random.default_rng(6).random(300).astype(np.float32).tobytes()
    for codec in CODECS:
        assert tio.compress(data, codec) == jio.compress(data, codec)
        assert tio.decompress(jio.compress(data, codec), codec) == data
    with pytest.raises(ValueError, match="unknown codec"):
        tio.compress(data, "snappy")
    assert tio.dump_path(str(tmp_path), "gs", 12, "vdi") == \
        jio.dump_path(str(tmp_path), "gs", 12, "vdi")


def _qpack8_saves(path):
    """A qpack8 artifact written by the port, with its metadata: the same
    bytes as the reference's, and each package loads the other's equal
    to its own load, dequantized, tagged qpack8."""
    color, depth = _vdi()
    m = _meta()
    tmeta = tvdi.VDIMetadata.create(
        projection=torch.from_numpy(m["projection"]),
        **{k: v for k, v in m.items() if k != "projection"})
    jpath = path + ".ref.npz"
    tn = tio.save_vdi(path, tvdi.VDI(torch.from_numpy(color),
                                     torch.from_numpy(depth)), tmeta,
                      precision="qpack8", codec="zlib")
    jn = jio.save_vdi(jpath, jvdi.VDI(color, depth),
                      jvdi.VDIMetadata.create(**m), precision="qpack8",
                      codec="zlib")
    assert tn == jn
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    (jc, jd), jm = jio.load_vdi(path)
    (tc, td), tm = tio.load_vdi(jpath)
    np.testing.assert_array_equal(np.asarray(jc), tc)
    np.testing.assert_array_equal(np.asarray(jd), td)
    assert int(jm.precision) == int(tm.precision) == 1


def _delta_record():
    """A P record of the port's encoder over a seeded tile."""
    from scenery_insitu_tpu_torch.ops import delta as tdl

    rng = np.random.default_rng(6)
    c = rng.integers(0, 2**31, (2, 5, 7)).astype(np.uint32)
    d = rng.integers(0, 2**15, (2, 5, 7)).astype(np.uint16)
    enc = tdl.DeltaEncoder(iframe_period=10**6)
    enc.encode(0, c, d, 0.0, 1.0)
    c2 = c.copy()
    c2.ravel()[3:6] ^= 9
    return enc.encode(0, c2, d, 0.0, 1.0), c2, d


def _delta_packs(path):
    """A P record packs into blobs the reference's packer writes byte for
    byte."""
    rec, _, _ = _delta_record()
    assert rec.mode == "P"
    assert tio.pack_delta_blobs(rec, codec="zlib") == \
        jio.pack_delta_blobs(rec, codec="zlib")


def _delta_unpacks(path):
    """The packed P record unpacks (in both packages) into the payload
    that rebuilds the tile."""
    from scenery_insitu_tpu_torch.ops import delta as tdl

    rec, c2, d = _delta_record()
    h, cb, db = tio.pack_delta_blobs(rec, codec="zlib")
    craw, draw = tio.decompress(cb, "zlib"), tio.decompress(db, "zlib")
    cp, dp = tio.unpack_delta_payload(h, craw, draw, c2.shape, d.shape)
    jcp, jdp = jio.unpack_delta_payload(h, craw, draw, c2.shape, d.shape)
    for a, b in zip(cp + dp, jcp + jdp):
        np.testing.assert_array_equal(a, b)
    base = c2.copy()
    base.ravel()[3:6] ^= 9
    np.testing.assert_array_equal(tdl.apply_runs(base, *cp), c2)


@pytest.mark.parametrize("call", [
    lambda p: tio.compress(b"x", "lz4"),
    lambda p: tio.decompress(b"x", "lz4"),
    _qpack8_saves,
    _delta_packs,
    _delta_unpacks,
], ids=["lz4_enc", "lz4_dec", "qpack8", "delta_pack", "delta_unpack"])
def test_unported_formats_raise(call, tmp_path):
    """The formats still to port raise naming their ROADMAP row; qpack8
    artifacts (ROADMAP A8b item 2) are ported and now save, and the
    temporal-delta records (item 6) round-trip with the reference's
    bytes."""
    if call in (_qpack8_saves, _delta_packs, _delta_unpacks):
        call(str(tmp_path / "x.npz"))
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP A(11|8b)"):
        call(str(tmp_path / "x.npz"))


def test_qpack8_artifact_raises_on_load(tmp_path):
    """A reference qpack8 artifact (once refused) loads in the port equal
    to the reference's own ``load_vdi``, metadata included."""
    path = str(tmp_path / "q.npz")
    jio.save_vdi(path, jvdi.VDI(*_vdi()), jvdi.VDIMetadata.create(**_meta()),
                 precision="qpack8", codec="zlib")
    (tc, td), tmeta = tio.load_vdi(path)
    (jc, jd), jmeta = jio.load_vdi(path)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(td, np.asarray(jd))
    assert np.isinf(td).any() and np.isfinite(td).any()
    for f in jmeta._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tmeta, f)),
                                      np.asarray(getattr(jmeta, f)),
                                      err_msg=f)


@pytest.mark.parametrize("gamma", [2.2, 1.0])
def test_save_png_pixels_match_reference(gamma, tmp_path):
    rng = np.random.default_rng(8)
    img = rng.random((4, 9, 13), dtype=np.float32) * 1.2 - 0.1
    tio_path, jpath = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    timg.save_png(tio_path, img, gamma)
    jimg.save_png(jpath, img, gamma)
    got = np.asarray(Image.open(tio_path))
    want = np.asarray(Image.open(jpath))
    assert got.shape == (9, 13, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timg.to_display(img, gamma, True),
                                  jimg.to_display(img, gamma, True))
    b = img + 0.01
    assert timg.psnr(img, b) == jimg.psnr(img, b)
    assert timg.psnr(img, img) == float("inf")


def test_vdi_helpers_and_camera_matrices():
    color, depth = _vdi()
    got = tvdi.to_numpy(tvdi.VDI(torch.from_numpy(color),
                                 torch.from_numpy(depth)))
    want = jvdi.to_numpy(jvdi.VDI(color, depth))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tvdi.vdi_nbytes(20, 720, 1280) == jvdi.vdi_nbytes(20, 720, 1280)
    for eye in [(0.0, 0.6, 3.0), (2.5, -0.4, 0.7)]:
        jc = jcam.Camera.create(eye, fov_y_deg=50.0, near=0.3, far=20.0)
        tc = tcam.Camera.create(eye, fov_y_deg=50.0, near=0.3, far=20.0,
                                device="cpu")
        np.testing.assert_allclose(tcam.view_matrix(tc).numpy(),
                                   np.asarray(jcam.view_matrix(jc)),
                                   atol=1e-6)
        np.testing.assert_allclose(
            tcam.projection_matrix(tc, 64, 48).numpy(),
            np.asarray(jcam.projection_matrix(jc, 64, 48)), atol=1e-6)

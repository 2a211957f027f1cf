"""The port's example twins on the CPU (``--device cpu``):
``volume_from_file`` held against the reference's slicer calls on the
same arguments (the views' PNG pixels within one 8-bit level of the
reference's image written by the reference's ``save_png``, the stored
VDIs within 1e-5 with their metadata), and ``ao_render``'s four images
finite and non-empty. ``--publish`` streams the views' VDIs."""

import glob
import os

import numpy as np
import pytest

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.utils import image as jimg
from scenery_insitu_tpu_torch.examples import ao_render, volume_from_file
from scenery_insitu_tpu_torch.io.vdi_io import load_vdi
from scenery_insitu_tpu_torch.utils.image import load_png
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, one_torch_thread)

VIEWS, SIDE = 2, 48


def test_volume_from_file_matches_reference(tmp_path):
    out = str(tmp_path / "views")
    assert volume_from_file.main([
        "--out", out, "--views", str(VIEWS), "--width", str(SIDE),
        "--height", str(SIDE), "--store-vdis", "--device", "cpu"]) == 0
    assert len(glob.glob(os.path.join(out, "view*.png"))) == VIEWS
    assert len(glob.glob(os.path.join(out, "vdi*.npz"))) == VIEWS
    # the reference script's calls on the same arguments
    vol = jvol.procedural_volume(96, kind="blobs", seed=1)
    tf = jtf.for_dataset("procedural")
    cam0 = jcam.Camera.create((0.0, 0.5, 3.0), fov_y_deg=50.0, near=0.3,
                              far=20.0)
    for i in range(VIEWS):
        cam = jcam.orbit(cam0, 2.0 * np.pi * i / VIEWS * 0.25)
        spec = jsl.make_spec(cam, vol.data.shape, jcfg.SliceMarchConfig())
        img = jsl.raycast_mxu(vol, tf, cam, SIDE, SIDE, spec).image
        ref = str(tmp_path / f"ref{i}.png")
        jimg.save_png(ref, np.asarray(img))
        got = load_png(os.path.join(out, f"view{i:03d}.png"))
        want = load_png(ref)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() \
            <= 1
        vdi, meta, _ = jsl.generate_vdi_mxu(
            vol, tf, cam, spec,
            jcfg.VDIConfig(max_supersegments=16, adaptive_iters=4),
            frame_index=i)
        gv, gm = load_vdi(os.path.join(out, f"vdi{i:03d}.npz"))
        assert_vdi_close(gv.color, gv.depth, vdi.color, vdi.depth, 1e-5,
                         1e-5)
        assert int(gm.index) == i
        np.testing.assert_allclose(gm.view, np.asarray(meta.view),
                                   atol=1e-6)
        np.testing.assert_allclose(gm.volume_dims,
                                   np.asarray(meta.volume_dims), atol=1e-6)


def test_ao_render_writes_four_images(tmp_path):
    out = str(tmp_path / "ao")
    assert ao_render.main(["--out", out, "--grid", "24", "--width", "40",
                           "--height", "32", "--steps", "48",
                           "--device", "cpu"]) == 0
    names = ("gather_plain", "gather_ao", "mxu_plain", "mxu_ao")
    imgs = {n: load_png(os.path.join(out, f"{n}.png")) for n in names}
    for n, img in imgs.items():
        assert img.shape[:2] == (32, 40), n
        assert (img[..., :3] < 250).any(), f"{n} is blank"
    # occlusion darkens: the AO images differ from the plain ones
    assert not np.array_equal(imgs["gather_ao"], imgs["gather_plain"])
    assert not np.array_equal(imgs["mxu_ao"], imgs["mxu_plain"])


def test_volume_from_file_publish_raises(tmp_path, monkeypatch):
    """``--publish`` raised before the sockets were ported (A11); it now
    publishes each view's VDI, which the reference's subscriber decodes
    to the stored ``.npz`` VDI of the same view."""
    pytest.importorskip("zmq")
    from scenery_insitu_tpu.runtime import streaming as jst
    from scenery_insitu_tpu_torch.io.vdi_io import load_vdi
    from scenery_insitu_tpu_torch.runtime import streaming as tst

    sent = []

    class _Tee:
        """The publisher's socket, keeping each message it sends."""

        def __init__(self, sock):
            self.sock = sock

        def send_multipart(self, parts):
            sent.append([bytes(p) for p in parts])
            self.sock.send_multipart(parts)

        def close(self, linger=0):
            self.sock.close(linger=linger)

    class _Capture(tst.VDIPublisher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.sock = _Tee(self.sock)

    monkeypatch.setattr(tst, "VDIPublisher", _Capture)
    out = str(tmp_path / "pub")
    assert volume_from_file.main(
        ["--out", out, "--views", "2", "--width", "24", "--height", "24",
         "--k", "4", "--store-vdis", "--publish", "tcp://127.0.0.1:0",
         "--device", "cpu"]) == 0
    sub = jst.VDISubscriber("tcp://127.0.0.1:1")
    try:
        assert len(sent) == 2
        for i, parts in enumerate(sent):
            vdi, meta, _ = sub._decode(parts)
            want, _ = load_vdi(os.path.join(out, f"vdi{i:03d}.npz"))
            assert int(np.asarray(meta.index)) == i
            np.testing.assert_array_equal(np.asarray(vdi.color), want.color)
            np.testing.assert_array_equal(np.asarray(vdi.depth), want.depth)
    finally:
        sub.close()

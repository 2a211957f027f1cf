"""The port's example twins on the CPU (``--device cpu``):
``volume_from_file`` held against the reference's slicer calls on the
same arguments (the views' PNG pixels within one 8-bit level of the
reference's image written by the reference's ``save_png``, the stored
VDIs within 1e-5 with their metadata), and ``ao_render``'s four images
finite and non-empty. ``--publish`` streams the views' VDIs. The
streamed-VDI client both ways, each in a subprocess on a loopback stream:
the port's ``vdi_client`` (``--device cpu``) on the reference's
publisher, and the root's ``examples/vdi_client.py`` on the port's; each
PNG within one 8-bit level of the other package's ``render_vdi_any`` and
``save_png`` of the same VDI (its depths scaled by 1.0007, as
``tests/test_torch_novel.py`` holds the plane sweep), and ``--steer``
delivering the novel camera to a steering endpoint."""

import glob
import os
import subprocess
import sys
import time

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


# ------------------------------------------------ the streamed-VDI client

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENT_SIDE, CLIENT_YAW = 32, 0.15


# every streamed depth scaled by this: the plane sweep's planes are the
# slice planes that made the VDI, so unscaled slab edges lie on them and
# a one-ulp difference between the packages moves a sample across an
# edge (``tests/test_torch_novel.py`` holds the sweep the same way)
DEPTH_SHIFT = 1.0007


def _stream_vdi():
    """The reference's slice-march VDI of a small procedural volume, its
    depths scaled by DEPTH_SHIFT, and the volume for the port."""
    vol = jvol.procedural_volume(24, kind="blobs", seed=1)
    cam = jcam.Camera.create((0.0, 0.5, 3.0), fov_y_deg=50.0, near=0.3,
                             far=20.0)
    spec = jsl.make_spec(cam, vol.data.shape,
                         jcfg.SliceMarchConfig(matmul_dtype="f32"))
    vdi, meta, _ = jsl.generate_vdi_mxu(
        vol, jtf.for_dataset("procedural"), cam, spec,
        jcfg.VDIConfig(max_supersegments=4, adaptive_iters=2))
    return vol, vdi._replace(depth=vdi.depth * DEPTH_SHIFT), meta


def _run_client(cmd, env, pub, vdi, meta, steering=None):
    """Run a client subprocess, publishing (vdi, meta) every 0.2 s until
    it exits (a loopback SUB drops what the PUB sent before it joined);
    drains ``steering`` meanwhile. Returns (returncode, output, the
    steering messages)."""
    client = subprocess.Popen(cmd, env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    msgs = []
    try:
        deadline = time.monotonic() + 240
        while client.poll() is None and time.monotonic() < deadline:
            pub.publish(vdi, meta)
            if steering is not None:
                msgs += list(steering.drain())
            time.sleep(0.2)
        if steering is not None:
            for _ in range(10):
                msgs += list(steering.drain())
                time.sleep(0.05)
    finally:
        if client.poll() is None:
            client.kill()
        out = client.communicate()[0]
    return client.returncode, out, msgs


def _within_one_level(got_path, want_path):
    got, want = load_png(got_path), load_png(want_path)
    assert got.shape == want.shape
    assert (want[..., :3] < 250).any(), "a blank reference view"
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_port_client_on_reference_stream(tmp_path):
    """The port's client (``--device cpu``) on the reference's publisher:
    its novel view within one 8-bit level of the reference's
    ``render_vdi_any`` + ``save_png`` of the same VDI from the same
    metadata, resampled in f32 as the port resolves the metadata's bf16
    on the CPU (the reference's spec keeps bf16 there, ~2 levels away),
    and ``--steer`` delivers that camera to a steering endpoint."""
    pytest.importorskip("zmq")
    from scenery_insitu_tpu.ops import vdi_novel as jnov
    from scenery_insitu_tpu.runtime import streaming as jst
    from scenery_insitu_tpu_torch.runtime import streaming as tst

    _, vdi, meta = _stream_vdi()
    pub = jst.VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
    steering = tst.SteeringEndpoint("tcp://127.0.0.1:0")
    out = str(tmp_path / "client")
    try:
        rc, log, msgs = _run_client(
            [sys.executable, "-m", "scenery_insitu_tpu_torch.examples."
             "vdi_client", "--connect", pub.endpoint, "--frames", "1",
             "--timeout", "200", "--width", str(CLIENT_SIDE), "--height",
             str(CLIENT_SIDE), "--yaw", str(CLIENT_YAW), "--out", out,
             "--steer", steering.endpoint, "--device", "cpu"],
            {**os.environ, "PYTHONPATH": ROOT}, pub, vdi, meta, steering)
    finally:
        pub.close()
        steering.close()
    assert rc == 0, log[-3000:]
    spec0 = jnov.axis_spec_from_meta(meta, matmul_dtype="f32")
    axcam0 = jnov.axis_camera_from_meta(meta, spec0)
    cam = jcam.Camera.create(tuple(np.linalg.inv(np.asarray(meta.view))[
        :3, 3]), fov_y_deg=50.0, near=0.3, far=20.0)
    novel = jcam.orbit(cam, CLIENT_YAW)
    ref = str(tmp_path / "ref.png")
    jimg.save_png(ref, np.asarray(jnov.render_vdi_any(
        vdi, axcam0, spec0, novel, CLIENT_SIDE, CLIENT_SIDE)))
    _within_one_level(os.path.join(out, "novel000.png"), ref)
    cams = [m for m in msgs if m.get("type") == "camera"]
    assert cams, msgs
    np.testing.assert_allclose(cams[0]["eye"], np.asarray(novel.eye),
                               atol=1e-5)


def test_reference_client_on_port_stream(tmp_path):
    """The root's ``examples/vdi_client.py`` on the port's publisher of
    the port's VDI of the same volume: its novel view (resampled in bf16,
    the reference's default on the CPU too) within one 8-bit level of the
    port's ``render_vdi_any`` + ``save_png`` from the same metadata (f32
    on the CPU)."""
    pytest.importorskip("zmq")
    import torch

    from scenery_insitu_tpu_torch.config import SliceMarchConfig, VDIConfig
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer as tsl
    from scenery_insitu_tpu_torch.ops import vdi_novel as tnov
    from scenery_insitu_tpu_torch.runtime import streaming as tst
    from scenery_insitu_tpu_torch.utils.image import save_png

    jv, _, _ = _stream_vdi()
    vol = Volume(*(torch.from_numpy(np.array(x)) for x in (
        jv.data, jv.origin, jv.spacing)))
    cam0 = Camera.create((0.0, 0.5, 3.0), fov_y_deg=50.0, near=0.3,
                         far=20.0, device="cpu")
    spec = tsl.make_spec(cam0, tuple(vol.data.shape),
                         SliceMarchConfig(matmul_dtype="f32"))
    vdi, meta, _ = tsl.generate_vdi_mxu(
        vol, for_dataset("procedural", device="cpu"), cam0, spec,
        VDIConfig(max_supersegments=4, adaptive_iters=2))
    vdi = vdi._replace(depth=vdi.depth * DEPTH_SHIFT)
    pub = tst.VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
    out = str(tmp_path / "client")
    try:
        rc, log, _ = _run_client(
            [sys.executable, "-u", os.path.join(ROOT, "examples",
                                                "vdi_client.py"),
             "--connect", pub.endpoint, "--frames", "1", "--timeout", "200",
             "--width", str(CLIENT_SIDE), "--height", str(CLIENT_SIDE),
             "--yaw", str(CLIENT_YAW), "--out", out],
            {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu",
             "_EX_CHILD": "1"}, pub, vdi, meta)
    finally:
        pub.close()
    assert rc == 0, log[-3000:]
    spec0 = tnov.axis_spec_from_meta(meta)
    axcam0 = tnov.axis_camera_from_meta(meta, spec0)
    eye = np.linalg.inv(meta.view.numpy())[:3, 3]
    cam = Camera.create(tuple(float(x) for x in eye), fov_y_deg=50.0,
                        near=0.3, far=20.0, device="cpu")
    ref = str(tmp_path / "ref.png")
    save_png(ref, tnov.render_vdi_any(vdi, axcam0, spec0,
                                      orbit(cam, CLIENT_YAW), CLIENT_SIDE,
                                      CLIENT_SIDE).numpy())
    _within_one_level(os.path.join(out, "novel000.png"), ref)

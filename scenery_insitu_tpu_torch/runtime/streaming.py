"""The steering protocol's messages: the first part of the port of the
reference's ``runtime/streaming.py``.

A viewer steers a running session with plain dict messages (``type``
``camera`` or ``tf``; any other type passes to the session's
``on_steer`` callbacks). These helpers build and apply them; the
session's consumer is ``runtime/session.steer_session``, which the
scenario zoo's in-process hooks drive (``scenarios/``).

The rest of the reference's module — the VDI publisher and subscriber,
the tile assembler, the steering endpoint and relay, and the video
sinks, all over sockets — is ROADMAP A11.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.core.camera import Camera


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def make_camera_message(cam: Camera) -> dict:
    """Viewer -> renderer camera pose (≅ the msgpack camera payload,
    VolumeFromFileExample.kt:907-918). Carries the whole camera, near
    and far included: a re-rendering consumer generates its rays through
    this pose, and the near plane takes part in ray generation
    (steering consumers ignore the extra fields)."""
    return {"type": "camera",
            "eye": _host(cam.eye).tolist(),
            "target": _host(cam.target).tolist(),
            "up": _host(cam.up).tolist(),
            "fov_y": float(_host(cam.fov_y)),
            "near": float(_host(cam.near)),
            "far": float(_host(cam.far))}


def make_tf_message(points, colormap: str = "hot") -> dict:
    """Viewer -> renderer transfer-function update (≅ updateVis's TF
    payload, DistributedVolumeRenderer.kt:747-774 — there dispatched by
    payload size, here an explicit type). ``points`` are (value, alpha)
    control points; the session rebuilds its TF and swaps the affected
    steps (knot arrays are fixed-shape, so no shape changes)."""
    return {"type": "tf",
            "points": [[float(v), float(a)] for v, a in points],
            "colormap": str(colormap)}


def tf_from_message(msg: dict, device=None):
    """The TransferFunction a ``tf`` steering message describes, on
    ``device`` (None: CUDA)."""
    from scenery_insitu_tpu_torch.core.transfer import TransferFunction

    return TransferFunction.points(
        [tuple(p) for p in msg["points"]],
        colormap=msg.get("colormap", "hot"), device=device)


def apply_steering(cam: Camera, msg: dict) -> Tuple[Camera, dict]:
    """Apply one steering message; returns (camera, side_effects). A
    ``camera`` message moves the camera (on the camera's device); other
    types pass through in side_effects, keyed by type (≅ updateVis
    dispatch, DistributedVolumeRenderer.kt:747-774)."""
    kind = msg.get("type")
    if kind == "camera":
        dev = cam.eye.device
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32),
                                        device=dev)
        cam = cam._replace(
            eye=f32(msg["eye"]),
            target=f32(msg.get("target", _host(cam.target))),
            up=f32(msg.get("up", _host(cam.up))))
        if "fov_y" in msg:
            cam = cam._replace(fov_y=f32(msg["fov_y"]))
        return cam, {}
    return cam, {kind: msg}

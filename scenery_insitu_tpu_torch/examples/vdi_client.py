"""Streamed-VDI client on the port: the twin of the reference's
``examples/vdi_client.py`` (the remote-viewer chain: the ZMQ VDI
transport, novel views rendered from the VDI alone, camera messages
back). Subscribes to a VDI stream, rebuilds the generating camera from
each frame's metadata, renders a novel view ``--yaw`` radians about it
(``ops/vdi_novel.render_vdi_any``) and writes it as a PNG; with
``--steer`` it sends that camera to the producer's steering endpoint.
Needs pyzmq and msgpack.

    python -m scenery_insitu_tpu_torch.examples.vdi_client \\
        --connect tcp://localhost:6655 --frames 10 --out client_out/
    ... --device cpu                                  # the plain versions

Tile streams (``composite.schedule="waves"``) arrive whole:
`VDISubscriber.receive` assembles a frame's tiles before it returns it.
``--device`` defaults to CUDA.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--connect", default="tcp://localhost:6655")
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="seconds to wait for each VDI")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="client_out")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--yaw", type=float, default=0.15,
                    help="novel-view offset (radians) from the stream pose")
    ap.add_argument("--steer", default="",
                    help="ZMQ address of the producer's steering endpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
    from scenery_insitu_tpu_torch.device import resolve_device
    from scenery_insitu_tpu_torch.ops import vdi_novel
    from scenery_insitu_tpu_torch.runtime.streaming import (
        SteeringPublisher, StreamDrop, VDISubscriber, make_camera_message)
    from scenery_insitu_tpu_torch.utils.image import save_png

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    sub = VDISubscriber(args.connect)
    steer = SteeringPublisher(args.steer) if args.steer else None
    print(f"listening on {args.connect} ...", flush=True)
    i = 0
    while i < args.frames:
        got = sub.receive(timeout_ms=int(args.timeout * 1000))
        if got is None:
            print(f"no VDI within {args.timeout:.0f} s; is a producer "
                  "publishing?", flush=True)
            return 2
        if isinstance(got, StreamDrop):
            # a corrupt or stale message the subscriber refused: wait for
            # the next good frame without spending one of --frames
            print(f"dropped {got.kind} message: {got.reason}", flush=True)
            continue
        vdi, meta = got
        vdi = VDI(torch.as_tensor(vdi.color, device=dev),
                  torch.as_tensor(vdi.depth, device=dev))
        meta = VDIMetadata(*(torch.as_tensor(np.asarray(x), device=dev)
                             for x in meta))
        # the generating camera's slice geometry from the metadata alone
        spec0 = vdi_novel.axis_spec_from_meta(meta)
        axcam0 = vdi_novel.axis_camera_from_meta(meta, spec0)
        eye = np.linalg.inv(meta.view.cpu().numpy())[:3, 3]
        cam = Camera.create(tuple(float(x) for x in eye), fov_y_deg=50.0,
                            near=0.3, far=20.0, device=dev)
        novel = orbit(cam, args.yaw)
        # the plane sweep in the VDI's regime, the pre-shaded proxy
        # across regimes
        img = vdi_novel.render_vdi_any(vdi, axcam0, spec0, novel,
                                       args.width, args.height)
        save_png(os.path.join(args.out, f"novel{i:03d}.png"),
                 img.cpu().numpy())
        print(f"frame {int(meta.index)}: rendered novel view "
              f"({i + 1}/{args.frames})", flush=True)
        if steer is not None:
            steer.send(make_camera_message(novel))
        i += 1
    sub.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Offline dataset rendering and VDI generation on the port: the twin of
the reference's ``examples/volume_from_file.py`` (≅ the original
VolumeFromFileExample.kt:69-1116). Loads a raw volume (or a procedural
one), renders a view sweep on the slice march and optionally stores the
views' VDIs or publishes them over ZMQ (``--publish``; needs pyzmq and
msgpack).

    python -m scenery_insitu_tpu_torch.examples.volume_from_file \\
        --out out/                                    # procedural, card
    python -m scenery_insitu_tpu_torch.examples.volume_from_file \\
        --dataset Kingsnake --data-dir /data --out out/ --store-vdis
    ... --device cpu                                  # the plain versions

``--device`` defaults to CUDA.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="procedural",
                    help="named raw dataset (core.volume dims table) or "
                         "'procedural'")
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--out", default="out")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--store-vdis", action="store_true")
    ap.add_argument("--publish", default="",
                    help="ZMQ bind address to stream generated VDIs")
    ap.add_argument("--k", type=int, default=16, help="max supersegments")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from scenery_insitu_tpu_torch.config import SliceMarchConfig, VDIConfig
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import (load_dataset,
                                                      procedural_volume)
    from scenery_insitu_tpu_torch.io.vdi_io import save_vdi
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.utils.image import save_png

    dev = args.device
    if args.dataset == "procedural":
        vol = procedural_volume(96, kind="blobs", seed=1, device=dev)
    else:
        vol = load_dataset(args.dataset, args.data_dir, device=dev)
    tf = for_dataset(args.dataset, device=dev)
    os.makedirs(args.out, exist_ok=True)

    cam0 = Camera.create((0.0, 0.5, 3.0), fov_y_deg=50.0, near=0.3, far=20.0,
                         device=dev)
    pub = None
    if args.publish:
        from scenery_insitu_tpu_torch.runtime.streaming import VDIPublisher
        pub = VDIPublisher(args.publish)
    for i in range(args.views):
        cam = orbit(cam0, 2.0 * np.pi * i / max(args.views, 1) * 0.25)
        spec = slicer.make_spec(cam, tuple(vol.data.shape),
                                SliceMarchConfig())
        out = slicer.raycast_mxu(vol, tf, cam, args.width, args.height, spec)
        save_png(os.path.join(args.out, f"view{i:03d}.png"),
                 out.image.cpu().numpy())
        if args.store_vdis or pub is not None:
            vdi, meta, _ = slicer.generate_vdi_mxu(
                vol, tf, cam, spec,
                VDIConfig(max_supersegments=args.k, adaptive_iters=4))
            meta = meta._replace(index=torch.tensor(i, dtype=torch.int32))
            if args.store_vdis:
                save_vdi(os.path.join(args.out, f"vdi{i:03d}.npz"), vdi,
                         meta)
            if pub is not None:
                pub.publish(vdi, meta)
        print(f"view {i + 1}/{args.views} done")
    if pub is not None:
        pub.close()
    print(f"wrote {args.views} views to {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

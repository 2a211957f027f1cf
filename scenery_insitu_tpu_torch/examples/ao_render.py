"""Ambient-occlusion demo on the port: the twin of the reference's
``examples/ao_render.py``. Renders a procedural volume with and without
AO on both engines (the gather raycast and the slice march, the latter
through the pre-shaded volume of ``ops/ao.shade_volume_ao``) and writes
the four PNGs.

    python -m scenery_insitu_tpu_torch.examples.ao_render --out out_ao/ \\
        [--strength 0.8] [--radius 4]                 # on the card
    ... --grid 32 --width 96 --height 72 --device cpu

``--device`` defaults to CUDA.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="out_ao")
    ap.add_argument("--grid", type=int, default=96)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--strength", type=float, default=0.8)
    ap.add_argument("--radius", type=int, default=4)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from scenery_insitu_tpu_torch.config import (RenderConfig,
                                                 SliceMarchConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import procedural_volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops.ao import shade_volume_ao
    from scenery_insitu_tpu_torch.ops.raycast import raycast
    from scenery_insitu_tpu_torch.utils.image import save_png

    dev = args.device
    os.makedirs(args.out, exist_ok=True)
    vol = procedural_volume(args.grid, kind="blobs", seed=5, device=dev)
    tf = for_dataset("procedural", device=dev)
    cam = Camera.create((0.5, 0.8, 2.6), fov_y_deg=50.0, near=0.3, far=20.0,
                        device=dev)
    bg = (1.0, 1.0, 1.0, 1.0)
    w, h = args.width, args.height
    host = lambda img: img.cpu().numpy()

    cfg = RenderConfig(max_steps=args.steps, background=bg)
    cfg_ao = RenderConfig(max_steps=args.steps, background=bg,
                          ao_strength=args.strength, ao_radius=args.radius)
    save_png(os.path.join(args.out, "gather_plain.png"),
             host(raycast(vol, tf, cam, w, h, cfg).image))
    save_png(os.path.join(args.out, "gather_ao.png"),
             host(raycast(vol, tf, cam, w, h, cfg_ao).image))

    spec = slicer.make_spec(cam, tuple(vol.data.shape), SliceMarchConfig())
    save_png(os.path.join(args.out, "mxu_plain.png"),
             host(slicer.raycast_mxu(vol, tf, cam, w, h, spec,
                                     background=bg).image))
    shaded = shade_volume_ao(vol, tf, args.radius, args.strength)
    save_png(os.path.join(args.out, "mxu_ao.png"),
             host(slicer.raycast_mxu(shaded, None, cam, w, h, spec,
                                     background=bg).image))
    print(f"wrote 4 images to {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

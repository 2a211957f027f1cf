"""Hybrid volume + particle compositing (the reference's BASELINE Config
5: a simulated volume rendered as a VDI with opaque tracer spheres
inside it).

The particle z-buffer is inserted into the volume's transparency
integral: per pixel, supersegments in front of the particle contribute
in full, the supersegment holding the particle's depth contributes its
traversed fraction (opacity re-corrected as ``1 - (1 - A)^f``, the
traversed-fraction law of ``ops/sampling.adjust_opacity``), the particle
is alpha-undered at its depth, and everything behind an opaque particle
is occluded.

Both inputs must share rays: the same camera, pixel grid and depth
convention (the world ray parameter t). The slice-march frames splat the
particles onto the virtual axis camera's grid (``ops/splat.
splat_particles`` with ``view``/``proj``) to guarantee it.
"""

from __future__ import annotations

import torch

from scenery_insitu_tpu_torch.core.vdi import VDI
from scenery_insitu_tpu_torch.ops.splat import SplatOutput


def composite_vdi_with_particles(vdi: VDI, splat: SplatOutput
                                 ) -> torch.Tensor:
    """Merge a VDI (supersegments sorted front to back per pixel, the
    generation order) with an opaque particle layer. Returns the
    premultiplied image ``f32[4, H, W]`` (background-free).

    Pixels without a particle (splat depth +inf) reproduce the plain VDI
    decode; pixels whose particle sits in front of everything show the
    particle over nothing."""
    tp = splat.depth                                       # [H, W]
    has_p = torch.isfinite(tp)
    live = torch.isfinite(vdi.depth)
    color = torch.where(live[:, 0:1], vdi.color, 0.0)
    t0s = torch.where(live[:, 0], vdi.depth[:, 0], 0.0)
    t1s = torch.where(live[:, 1], vdi.depth[:, 1], 0.0)
    acc = torch.zeros_like(color[0])
    for c, t0, t1 in zip(color, t0s, t1s):
        # the fraction of the slab in front of the particle (1 when the
        # slab ends before it or there is none; 0 when fully behind it)
        denom = torch.clamp(t1 - t0, min=1e-12)
        frac = torch.clamp((tp - t0) / denom, 0.0, 1.0)
        frac = torch.where(has_p, frac, 1.0)
        a = c[3]
        a_eff = 1.0 - torch.pow(torch.clamp(1.0 - a, min=0.0), frac)
        scale = torch.where(a > 1e-12, a_eff / torch.clamp(a, min=1e-12),
                            0.0)
        acc = acc + (1.0 - acc[3:4]) * (c * scale[None])
    # the opaque particle layer sits behind exactly the front fraction
    return acc + (1.0 - acc[3:4]) * splat.image

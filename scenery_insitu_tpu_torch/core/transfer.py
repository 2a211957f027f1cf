"""Transfer functions in knot form, evaluated as a relu-sum::

    f(x) = base + sum_i  m_i * relu(x - x_i)

(x_i = knot positions, m_i = slope changes at the knots), exact for the
polyline the control points define. Knot arrays are padded to MAX_KNOTS;
padding knots sit at x = 2 with zero slope. The knots are built with
numpy exactly as the reference builds them, so both packages evaluate the
same polyline.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.device import resolve_device

LUT_SIZE = 256
MAX_KNOTS = 16


def _relu_terms(xs: np.ndarray, ys: np.ndarray):
    """Knot form (x, slope deltas, base) of the clamped piecewise-linear
    interpolant through (xs, ys)."""
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.float32)
    slopes = np.diff(ys) / np.maximum(np.diff(xs), 1e-6)
    s_in = np.concatenate([[0.0], slopes]).astype(np.float32)
    s_out = np.concatenate([slopes, [0.0]]).astype(np.float32)
    return xs, s_out - s_in, np.float32(ys[0])


def _pad(x: np.ndarray, fill: float) -> np.ndarray:
    out = np.full(MAX_KNOTS, fill, np.float32)
    out[: len(x)] = x
    return out


def _pad2(x: np.ndarray) -> np.ndarray:
    out = np.zeros((MAX_KNOTS, x.shape[1]), np.float32)
    out[: len(x)] = x
    return out


class TransferFunction(NamedTuple):
    """Maps normalized scalar value [0, 1] -> (rgb, alpha)."""

    alpha_x: torch.Tensor   # f32[MAX_KNOTS] alpha knot positions
    alpha_m: torch.Tensor   # f32[MAX_KNOTS] alpha slope deltas
    alpha_b: torch.Tensor   # f32[]          alpha at x=0
    color_x: torch.Tensor   # f32[MAX_KNOTS] color knot positions
    color_m: torch.Tensor   # f32[MAX_KNOTS, 3] per-channel slope deltas
    color_b: torch.Tensor   # f32[3]         rgb at x=0

    @classmethod
    def from_polylines(cls, alpha_pts: Sequence[Tuple[float, float]],
                       color_xs: np.ndarray, color_rgb: np.ndarray,
                       device=None) -> "TransferFunction":
        alpha_pts = sorted(alpha_pts)
        if len(alpha_pts) > MAX_KNOTS - 1:
            raise ValueError(f"at most {MAX_KNOTS - 1} alpha control points")
        ax, am, ab = _relu_terms(np.array([p[0] for p in alpha_pts]),
                                 np.array([p[1] for p in alpha_pts]))
        cx, _, _ = _relu_terms(color_xs, color_rgb[:, 0])
        cms = np.stack([_relu_terms(color_xs, color_rgb[:, c])[1]
                        for c in range(3)], axis=-1)
        return cls.from_arrays(_pad(ax, 2.0), _pad(am, 0.0), ab,
                               _pad(cx, 2.0), _pad2(cms),
                               np.asarray(color_rgb[0], np.float32), device)

    @classmethod
    def from_arrays(cls, alpha_x, alpha_m, alpha_b, color_x, color_m,
                    color_b, device=None) -> "TransferFunction":
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return cls(t(alpha_x), t(alpha_m), t(alpha_b), t(color_x),
                   t(color_m), t(color_b))

    @classmethod
    def ramp(cls, low: float = 0.0, high: float = 1.0,
             max_alpha: float = 1.0, colormap: str = "grays",
             device=None) -> "TransferFunction":
        """Opacity 0 below ``low``, linear to ``max_alpha`` at ``high``."""
        high = max(high, low + 1e-6)
        xs, rgb = colormap_polyline(colormap)
        return cls.from_polylines([(low, 0.0), (high, max_alpha)], xs, rgb,
                                  device)

    @classmethod
    def points(cls, pts: Sequence[Tuple[float, float]],
               colormap: str = "grays", device=None) -> "TransferFunction":
        """Piecewise-linear opacity through (value, alpha) control points."""
        xs, rgb = colormap_polyline(colormap)
        return cls.from_polylines(pts, xs, rgb, device)

    def __call__(self, value: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample -> (rgb f32[..., 3], alpha f32[...]). Gather-free."""
        x = torch.clamp(value, 0.0, 1.0)[..., None]
        a = self.alpha_b + torch.sum(
            self.alpha_m * torch.clamp(x - self.alpha_x, min=0.0), dim=-1)
        tc = torch.clamp(x - self.color_x, min=0.0)        # [..., K]
        rgb = self.color_b + torch.tensordot(tc, self.color_m,
                                             dims=([-1], [0]))
        return rgb, a

    def max_alpha_in(self, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
        """Max alpha over value interval(s) [lo, hi] — the conservative
        bound of empty-space skipping."""
        lo = torch.clamp(lo, 0.0, 1.0)[..., None]
        hi = torch.clamp(hi, 0.0, 1.0)[..., None]
        ends = torch.cat([
            self.alpha_b + torch.sum(
                self.alpha_m * torch.clamp(lo - self.alpha_x, min=0.0), -1,
                keepdim=True),
            self.alpha_b + torch.sum(
                self.alpha_m * torch.clamp(hi - self.alpha_x, min=0.0), -1,
                keepdim=True)], dim=-1)
        # interior maxima can only sit at knots inside (lo, hi)
        knot_vals = self.alpha_b + torch.sum(
            self.alpha_m * torch.clamp(self.alpha_x[:, None]
                                       - self.alpha_x[None, :], min=0.0), -1)
        inside = (self.alpha_x >= lo) & (self.alpha_x <= hi)
        interior = torch.amax(
            torch.where(inside, knot_vals,
                        torch.full_like(knot_vals, -torch.inf)), dim=-1)
        return torch.maximum(torch.amax(ends, dim=-1), interior)


def opacity_edges(tf: TransferFunction, eps: float = 1e-4) -> np.ndarray:
    """Sorted f32[M] positions of the TF's active opacity knots — where
    the alpha polyline changes slope — on the host. The edge set of the
    LOD planner's TF-straddle gate (`parallel.lod.select_levels`):
    pooling a brick whose value range crosses one of these positions
    averages across an opacity feature, so such bricks stay level 0.
    Padding knots (x = 2, zero slope) and knots whose |slope delta| <=
    ``eps`` carry no feature and are dropped."""
    x = tf.alpha_x.detach().cpu().numpy().astype(np.float32)
    m = tf.alpha_m.detach().cpu().numpy().astype(np.float32)
    keep = (x <= 1.0) & (np.abs(m) > eps)
    return np.sort(x[keep])


def colormap_polyline(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Built-in colormaps as exact piecewise-linear polylines
    (xs f32[K], rgb f32[K, 3])."""
    if name == "grays":
        xs = np.array([0.0, 1.0], np.float32)
        rgb = np.array([[0, 0, 0], [1, 1, 1]], np.float32)
    elif name == "hot":
        xs = np.array([0.0, 1 / 3, 2 / 3, 1.0], np.float32)
        rgb = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [1, 1, 1]],
                       np.float32)
    elif name == "jet":
        xs = np.linspace(0.0, 1.0, 9, dtype=np.float32)
        r = np.clip(1.5 - np.abs(4 * xs - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * xs - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * xs - 1), 0, 1)
        rgb = np.stack([r, g, b], -1).astype(np.float32)
    elif name == "viridis":
        # 11-anchor approximation of matplotlib viridis
        rgb = np.array([
            [0.267, 0.005, 0.329], [0.283, 0.141, 0.458],
            [0.254, 0.265, 0.530], [0.207, 0.372, 0.553],
            [0.164, 0.471, 0.558], [0.128, 0.567, 0.551],
            [0.135, 0.659, 0.518], [0.267, 0.749, 0.441],
            [0.478, 0.821, 0.318], [0.741, 0.873, 0.150],
            [0.993, 0.906, 0.144]], np.float32)
        xs = np.linspace(0.0, 1.0, len(rgb), dtype=np.float32)
    else:
        raise ValueError(f"unknown colormap {name!r}")
    return xs, rgb


def colormap_lut(name: str, n: int = LUT_SIZE) -> np.ndarray:
    """Dense f32[n, 3] sampling of a built-in colormap (host-side users:
    particle splat colour tables, previews)."""
    xs, rgb = colormap_polyline(name)
    x = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return np.stack([np.interp(x, xs, rgb[:, c]) for c in range(3)],
                    -1).astype(np.float32)


# Per-dataset transfer functions: (alpha control points or ramp, colormap),
# the same tables the reference keeps.
_POINTS, _RAMP = "points", "ramp"
DATASET_TRANSFER_FUNCTIONS = {
    "kingsnake": (_POINTS, [(0.0, 0.0), (0.43, 0.0), (0.5, 0.005)], "grays"),
    "beechnut": (_POINTS, [(0.0, 0.0), (0.43, 0.0), (0.457, 0.321),
                           (0.494, 0.0), (1.0, 0.0)], "grays"),
    "simulation": (_POINTS, [(0.0, 0.0), (0.1, 0.0), (0.15, 0.1),
                             (0.22, 0.05), (1.0, 0.1)], "hot"),
    "rayleigh_taylor": (_POINTS, [(0.0, 0.3), (0.3, 0.05), (0.5, 0.0),
                                  (0.7, 0.05), (1.0, 0.3)], "jet"),
    "rotstrat": (_RAMP, (0.0, 1.0, 0.4), "jet"),
    "procedural": (_RAMP, (0.05, 0.8, 0.5), "hot"),
    "gray_scott": (_POINTS, [(0.0, 0.0), (0.12, 0.0), (0.3, 0.12),
                             (0.65, 0.3), (1.0, 0.5)], "viridis"),
    "vortex": (_RAMP, (0.0, 1.0, 0.4), "jet"),
    "hybrid": (_RAMP, (0.0, 1.0, 0.4), "jet"),
    "lennard_jones": (_RAMP, (0.05, 0.8, 0.5), "hot"),
    "sho": (_RAMP, (0.05, 0.8, 0.5), "hot"),
}


def for_dataset(name: str, device=None) -> TransferFunction:
    """The tuned transfer function of a dataset; an unknown name renders
    with the generic gray ramp, with a warning."""
    entry = DATASET_TRANSFER_FUNCTIONS.get(name.lower())
    if entry is None:
        warnings.warn(f"no tuned transfer function for dataset {name!r} "
                      f"(known: {sorted(DATASET_TRANSFER_FUNCTIONS)}); "
                      f"using the gray ramp")
        return TransferFunction.ramp(0.05, 0.8, 0.5, "grays", device=device)
    kind, args, cmap = entry
    if kind == _RAMP:
        return TransferFunction.ramp(*args, colormap=cmap, device=device)
    return TransferFunction.points(args, cmap, device=device)

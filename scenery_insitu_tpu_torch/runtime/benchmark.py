"""Render benchmark harness and camera-path tools.

≅ the reference's benchmark machinery:
- multi-view fps sweep: 9 camera angles per dataset, fps stats cleared and
  sampled per window, written as ``avg;min;max;stddev;n`` CSV rows plus a
  screenshot per view (reference VolumeFromFileExample.kt:765-795,
  355-385; DistributedVolumes.kt singleGPUBenchmarks :527-623).
- camera flythrough recorder: interpolate a keyframed path and render every
  frame to disk / a video sink (VolumeFromFileExample.kt:631-745).

The sweep drives whichever render callable it is given, so it benchmarks
either engine (gather or MXU slice-march) and either output (plain image or
VDI) with the same stats path. The port of the reference's
``runtime/benchmark.py``: a render's time is taken after
``torch.cuda.synchronize`` when the camera lies on a CUDA device.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from scenery_insitu_tpu_torch.convert import to_numpy
from scenery_insitu_tpu_torch.core.camera import Camera, orbit
from scenery_insitu_tpu_torch.runtime.timers import PhaseStats


def benchmark_views(render: Callable[[Camera], object], cam0: Camera,
                    num_views: int = 9, frames: int = 10, warmup: int = 1,
                    pitch: float = 0.0,
                    screenshot_dir: Optional[str] = None,
                    to_image: Optional[Callable[[object], np.ndarray]] = None,
                    ) -> List[Tuple[float, PhaseStats]]:
    """Sweep ``num_views`` orbit angles; per view run ``frames`` timed
    renders (after ``warmup`` untimed ones) and collect fps stats.

    Returns [(yaw_radians, PhaseStats-of-seconds-per-frame), ...]. When
    ``screenshot_dir`` is set, saves one PNG per view (≅ the reference's
    per-view screenshot, VolumeFromFileExample.kt:793); ``to_image``
    converts the render output to an f32[4, H, W] array for saving
    (defaults to identity).
    """
    dev = cam0.eye.device
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    results = []
    for view in range(num_views):
        yaw = 2.0 * np.pi * view / num_views
        cam = orbit(cam0, float(yaw), float(pitch))
        for _ in range(warmup):
            render(cam)
            sync()
        stats = PhaseStats()
        out = None
        for _ in range(frames):
            t0 = time.perf_counter()
            out = render(cam)
            sync()
            stats.add(time.perf_counter() - t0)
        results.append((float(yaw), stats))
        if screenshot_dir is not None:
            from scenery_insitu_tpu_torch.utils.image import save_png
            os.makedirs(screenshot_dir, exist_ok=True)
            img = to_numpy(to_image(out) if to_image else out)
            save_png(os.path.join(screenshot_dir, f"view{view:02d}.png"), img)
    return results


def fps_csv(results: Sequence[Tuple[float, PhaseStats]]) -> str:
    """Render sweep results as the reference's fps CSV: one
    ``yaw_deg;avg;min;max;stddev;n`` row per view, fps units (the stats are
    inverted from seconds-per-frame; min fps = 1/max spf)."""
    lines = ["yaw_deg;avg_fps;min_fps;max_fps;stddev_spf;n"]
    for yaw, st in results:
        inv = lambda s: (1.0 / s) if s > 0 else 0.0
        lines.append(f"{np.degrees(yaw):.1f};{inv(st.avg):.3f};"
                     f"{inv(st.vmax):.3f};{inv(st.vmin):.3f};"
                     f"{st.stddev:.6f};{st.n}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- flythrough


def interpolate_path(keyframes: Sequence[Camera], frames_per_segment: int,
                     smooth: bool = True) -> List[Camera]:
    """Interpolate a camera path through pose keyframes (≅ the flythrough
    recorder's recorded-pose playback, VolumeFromFileExample.kt:631-745).
    Eye/target/up are interpolated per segment; ``smooth`` applies
    smoothstep easing inside each segment."""
    if len(keyframes) < 2:
        return list(keyframes)
    out: List[Camera] = []
    for a, b in zip(keyframes[:-1], keyframes[1:]):
        for f in range(frames_per_segment):
            t = f / frames_per_segment
            if smooth:
                t = t * t * (3.0 - 2.0 * t)
            lerp = lambda x, y: to_numpy(x) * (1 - t) + to_numpy(y) * t
            out.append(Camera.create(
                lerp(a.eye, b.eye), lerp(a.target, b.target),
                lerp(a.up, b.up), device=a.eye.device
            )._replace(fov_y=a.fov_y * (1 - t) + b.fov_y * t,
                       near=a.near, far=a.far))
    out.append(keyframes[-1])
    return out


def record_flythrough(render: Callable[[Camera], object],
                      path: Sequence[Camera], out_dir: str,
                      to_image: Optional[Callable[[object], np.ndarray]] = None,
                      video_sink=None) -> int:
    """Render every camera of ``path``; save frame PNGs to ``out_dir`` and
    optionally feed a ``runtime.streaming.video_sink``. Returns the number
    of frames rendered."""
    from scenery_insitu_tpu_torch.utils.image import save_png

    os.makedirs(out_dir, exist_ok=True)
    for i, cam in enumerate(path):
        out = render(cam)
        img = to_numpy(to_image(out) if to_image else out)
        save_png(os.path.join(out_dir, f"fly{i:05d}.png"), img)
        if video_sink is not None:
            video_sink(i, {"image": img})
    return len(path)

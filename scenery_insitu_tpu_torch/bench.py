"""The in-situ frame benchmark: the twin of the reference's ``bench.py``
measured path, on this package.

    python -m scenery_insitu_tpu_torch.bench                # one card
    python -m scenery_insitu_tpu_torch.bench --device cpu   # plain versions

It builds the temporal Gray-Scott frame (``grayscott_vdi_frame_step``,
the slice march), seeds the threshold state, runs 3 settle frames, then
times ``SITPU_BENCH_FRAMES`` frames with the eye oscillating within
+-0.35 rad of (0, 0.6, 3) (one march regime), and prints ONE JSON line in
the reference's shape: ``metric``, ``value`` (frames/s), ``unit``,
``ms_per_frame``, the ``occupancy`` block of the final field and
``config`` (with the card's name and power limit). The frame time is the
host clock around frames that end in a device synchronisation.

Knobs (environment, the reference's names and defaults; the grid and
frame count default to 512 and 25 on a card, 128 and 5 on the CPU):
``SITPU_BENCH_GRID``, ``K``, ``FRAMES``, ``SIM_STEPS``,
``ADAPTIVE_ITERS``, ``ADAPTIVE_MODE``, ``FOLD``, ``CHUNK``, ``VTILES``,
``SKIP`` (off|chunk|pyramid|sim), ``SIM_FUSED`` and ``RENDER_DTYPE``
(f32|bf16, the march's copy of the field; bf16 from a grid of 1024 up,
as the reference defaults it), each prefixed
``SITPU_BENCH_``. The knobs of parts this package does not have yet
raise, naming their ROADMAP row. There is no platform fallback: without
a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Mapping, Optional

import numpy as np
import torch

# knob -> (the value that is ported, what is not, its ROADMAP row)
_UNPORTED = {
    "ENGINE": ("mxu", "the gather engine", "queue A9"),
    "SCAN_FRAMES": ("0", "the one-launch frame loop", "queue A7"),
    "AUTOTUNE": ("0", "the fold race at warm-up", "queue A7"),
    "PROFILE": ("0", "the phase attribution", "queue A12"),
    "EXCHANGE": ("all_to_all", "the ring exchange", "queue A8b, item 1"),
    "WIRE": ("f32", "the bf16/qpack8 wire", "queue A8b, item 2"),
    "SCHEDULE": ("frame", "tile waves", "queue A8b, item 3"),
    "REBALANCE": ("even", "occupancy rebalance plans",
                  "queue A8b, item 4"),
}
BASE_EYE = (0.0, 0.6, 3.0)


def bench_config(env: Mapping[str, str], on_card: bool) -> dict:
    """The run's settings from ``env`` (the ``SITPU_BENCH_*`` knobs);
    raises on an unported knob or a bad value."""
    get = lambda name, default: env.get(f"SITPU_BENCH_{name}", default)
    for name, (ported, what, row) in _UNPORTED.items():
        value = get(name, ported)
        if name == "ENGINE" and value == "auto":
            value = ported
        if value != ported:
            raise NotImplementedError(
                f"SITPU_BENCH_{name}={value}: {what} is not ported yet "
                f"(ROADMAP {row})")
    grid = int(get("GRID", 512 if on_card else 128))
    # the march's copy of the field: bf16 from 1024^3 up, as the
    # reference defaults it; the long spellings map to the short
    render_dtype = get("RENDER_DTYPE", "bf16" if grid >= 1024 else "f32")
    render_dtype = {"bfloat16": "bf16", "float32": "f32"}.get(
        render_dtype, render_dtype)
    if render_dtype not in ("f32", "bf16"):
        raise ValueError(f"SITPU_BENCH_RENDER_DTYPE must be f32|bf16 "
                         f"(or float32|bfloat16), got {render_dtype!r}")
    skip = get("SKIP", "") or None
    if skip not in (None, "off", "chunk", "pyramid", "sim"):
        raise ValueError(f"SITPU_BENCH_SKIP must be off|chunk|pyramid|sim,"
                         f" got {skip!r}")
    return dict(
        grid=grid,
        render_dtype=render_dtype,
        k=int(get("K", 16)),
        frames=int(get("FRAMES", 25 if on_card else 5)),
        sim_steps=int(get("SIM_STEPS", 10)),
        adaptive_iters=int(get("ADAPTIVE_ITERS", 2)),
        adaptive_mode=get("ADAPTIVE_MODE", "temporal"),
        fold=get("FOLD", "auto"),
        chunk=int(get("CHUNK", 16)),
        vtiles=int(get("VTILES", -1)),
        skip=skip,
        sim_fused=bool(int(get("SIM_FUSED", 1))))


def card_power_limit() -> str:
    """The first card's power limit as ``nvidia-smi`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run(device=None, env: Optional[Mapping[str, str]] = None) -> dict:
    """Build and time the frame; returns the result line as a dict."""
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.device import resolve_device
    from scenery_insitu_tpu_torch.models.pipelines import (
        grayscott_vdi_frame_step, resolve_occupancy_cfg)
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = bench_config(os.environ if env is None else env, on_card)
    grid, k, frames = cfg["grid"], cfg["k"], cfg["frames"]
    temporal = cfg["adaptive_mode"] == "temporal"
    march_cfg = resolve_occupancy_cfg(
        SliceMarchConfig(fold=cfg["fold"], chunk=cfg["chunk"],
                         occupancy_vtiles=cfg["vtiles"]), cfg["skip"])
    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    step = grayscott_vdi_frame_step(
        sim_steps=cfg["sim_steps"],
        vdi_cfg=VDIConfig(max_supersegments=k,
                          adaptive_iters=cfg["adaptive_iters"],
                          adaptive_mode=cfg["adaptive_mode"]),
        comp_cfg=CompositeConfig(max_output_supersegments=k,
                                 adaptive_iters=cfg["adaptive_iters"]),
        engine="mxu", grid_shape=(grid,) * 3,
        axis_sign=slicer.choose_axis(base), slicer_cfg=march_cfg,
        render_dtype=cfg["render_dtype"], sim_fused=cfg["sim_fused"],
        occupancy=cfg["skip"], device=dev)
    spec = step.spec
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    eye = lambda yaw: orbit(base, yaw).eye

    st = gs.GrayScott.init((grid,) * 3, device=dev)
    u, v = st.u, st.v
    t0 = time.perf_counter()
    if temporal:
        thr = step.init_threshold(u, v, base.eye)
        for _ in range(3):
            _, _, u, v, thr = step(u, v, eye(0.0), thr)
    else:
        step(u, v, eye(0.0))
    sync()
    warmup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(frames):
        yaw = 0.35 * math.sin(0.7 * (i + 1))
        if temporal:
            _, _, u, v, thr = step(u, v, eye(yaw), thr)
        else:
            _, _, u, v = step(u, v, eye(yaw))
    sync()
    dt = (time.perf_counter() - t0) / frames

    # how sparse the measured scene was: the pyramid of the final field
    pyr = occ.pyramid_from_volume(Volume.centered(v, extent=2.0),
                                  for_dataset("gray_scott", device=dev), spec)
    clf = pyr.chunk_live_fractions().cpu().numpy()
    occupancy = {
        "mode": cfg["skip"] or ("pyramid" if spec.vtiles > 0 else
                                "chunk" if spec.skip_empty else "off"),
        "vtiles": spec.vtiles,
        "live_fraction": round(float(pyr.live_fraction()), 4),
        "chunk_live_hist": np.histogram(clf, bins=8,
                                        range=(0.0, 1.0))[0].tolist()}
    platform = "gpu" if on_card else "cpu"
    tag = "_render_only" if cfg["sim_steps"] == 0 else ""
    return {
        "metric": f"gray_scott_{grid}c_vdi_fps_{spec.ni}x{spec.nj}_"
                  f"{platform}_1chip{tag}",
        "value": round(1.0 / dt, 3),
        "unit": "frames/s",
        "ms_per_frame": round(dt * 1e3, 2),
        "occupancy": occupancy,
        "config": {
            "grid": grid, "image": [spec.ni, spec.nj], "steps": grid,
            "fold": spec.fold, "render_dtype": spec.render_dtype,
            "vtiles": spec.vtiles, "skip_empty": spec.skip_empty,
            "k": k, "frames": frames, "sim_steps": cfg["sim_steps"],
            "sim_fused": cfg["sim_fused"], "skip": cfg["skip"],
            "adaptive_iters": cfg["adaptive_iters"],
            "adaptive_mode": cfg["adaptive_mode"], "chunk": cfg["chunk"],
            "warmup_s": round(warmup_s, 1), "platform": platform,
            "device": (torch.cuda.get_device_name(dev) if on_card
                       else "cpu"),
            "power_limit": card_power_limit() if on_card else None,
            "engine": "mxu"},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

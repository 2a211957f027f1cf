"""The in-situ frame benchmark: the twin of the reference's ``bench.py``
measured path, on this package.

    python -m scenery_insitu_tpu_torch.bench                # one card
    python -m scenery_insitu_tpu_torch.bench --device cpu   # plain versions

It builds the temporal Gray-Scott frame (``grayscott_vdi_frame_step``,
the slice march; ``SITPU_BENCH_ENGINE=gather`` the gather engine's ray
march at ``WIDTH`` x ``HEIGHT`` with ``STEPS`` samples a ray, where the
temporal mode, a slice-march feature, becomes ``histogram`` on the
ledger as the reference's does), seeds the threshold state, runs 3
settle frames, then
times ``SITPU_BENCH_FRAMES`` frames with the eye oscillating within
+-0.35 rad of (0, 0.6, 3) (one march regime), and prints ONE JSON line in
the reference's shape: ``metric``, ``value`` (frames/s), ``unit``,
``ms_per_frame``, the ``occupancy`` block of the final field and
``config`` (with the card's name and power limit). The frame time is the
host clock around frames that end in a device synchronisation.

Knobs (environment, the reference's names and defaults; the grid and
frame count default to 512 and 25 on a card, 128 and 5 on the CPU):
``SITPU_BENCH_GRID``, ``K``, ``FRAMES``, ``SIM_STEPS``,
``ADAPTIVE_ITERS``, ``ADAPTIVE_MODE``, ``ENGINE`` (auto|mxu|gather;
auto is the slice march), ``STEPS``, ``FOLD``, ``CHUNK``, ``VTILES``,
``SKIP`` (off|chunk|pyramid|sim), ``SIM_FUSED``, ``RENDER_DTYPE``
(f32|bf16, the march's copy of the field; bf16 from a grid of 1024 up,
as the reference defaults it), ``EXCHANGE`` (all_to_all|ring), ``WIRE``
(f32|bf16|qpack8), ``SCHEDULE`` (frame|waves), ``WAVE_TILES``,
``REBALANCE`` (even|occupancy), ``WIDTH`` and ``HEIGHT`` (the gather
engine's image), ``PROFILE`` (1: the phase attribution) and
``PROFILE_FRAMES`` (3), each prefixed ``SITPU_BENCH_``. The frame is one card's, which has no exchange and
one z band: as in the reference, the exchange, wire, schedule and
rebalance knobs leave it unchanged and go into the JSON's ``config``
block with ``modeled_exchange_8rank``, the modeled per-rank exchange
bytes of the reference's 8-rank shape at ``WIDTH`` x ``HEIGHT``
(``ops/composite.modeled_exchange_traffic``; a model, not a
measurement), and ``rebalance``: the final field's z live profile at
the modeled 8 ranks, the plan ``slice_plan`` would adopt (min depth 4,
quantum 4), its histogram and the even and planned modeled straggler
factors. The knobs of parts this package does not have yet raise,
naming their ROADMAP row. There is no platform fallback: without a card
it raises unless ``--device cpu`` is given.

The roofline fields are the reference's: ``mfu_matmul`` (the analytic
matmul FLOPs of the slice march's resampling products over the card's
peak for the march's product dtype, ``obs/roofline.py``), and
``hbm_bytes_per_frame``, ``hbm_gbps`` and ``hbm_frac_peak`` from the
frame's cost snapshot (``obs/device.py``: the bytes every op and
kernel of one frame reads and writes, ``hbm_bytes_source``
``torch_dispatch_count``), or from the floor traffic model
(``min_traffic_model``) when the snapshot has none; ``cost_analysis``
carries the snapshot. Off the card the peaks are null, and so are
``mfu_matmul`` and ``hbm_frac_peak``. ``vs_baseline`` is fps / 30 at
the 512^3 slice-march configuration only, ``vs_baseline_unscaled``
fps / 30 always. With ``SITPU_BENCH_PROFILE=1``, `ProfileCapture`
attributes ``PROFILE_FRAMES`` more frames to the ``sitpu_*`` phases;
each of them also pays the host delivery (the VDI's copy to the host,
its CRC and its deflate, timed into the ``host`` phase), and the
result carries ``phase_attribution`` and ``roofline_verdicts``
(``divergence`` stays null: the modeled projection it is read against
belongs to the benchmark folder).
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
    "SCAN_FRAMES": ("0", "the one-launch frame loop",
                    "queue A3/A7: a CUDA graph after A3"),
    "AUTOTUNE": ("0", "the fold race at warm-up", "queue A7"),
}
BASE_EYE = (0.0, 0.6, 3.0)


def bench_config(env: Mapping[str, str], on_card: bool) -> dict:
    """The run's settings from ``env`` (the ``SITPU_BENCH_*`` knobs);
    raises on an unported knob or a bad value."""
    get = lambda name, default: env.get(f"SITPU_BENCH_{name}", default)
    for name, (ported, what, row) in _UNPORTED.items():
        value = get(name, ported)
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
    rebalance = get("REBALANCE", "even")
    if rebalance not in ("even", "occupancy"):
        raise ValueError(f"SITPU_BENCH_REBALANCE must be even|occupancy, "
                         f"got {rebalance!r}")
    skip = get("SKIP", "") or None
    if skip not in (None, "off", "chunk", "pyramid", "sim"):
        raise ValueError(f"SITPU_BENCH_SKIP must be off|chunk|pyramid|sim,"
                         f" got {skip!r}")
    from scenery_insitu_tpu_torch import obs
    from scenery_insitu_tpu_torch.config import CompositeConfig
    from scenery_insitu_tpu_torch.ops import slicer

    engine = slicer.resolve_engine(get("ENGINE", "mxu"))
    adaptive_mode = get("ADAPTIVE_MODE", "temporal")
    if adaptive_mode == "temporal" and engine != "mxu":
        obs.degrade("bench.adaptive_mode", "temporal", "histogram",
                    "temporal mode is mxu-only", warn=False)
        adaptive_mode = "histogram"
    # the sort-last settings, validated as CompositeConfig validates them
    exchange = CompositeConfig(
        exchange=get("EXCHANGE", "all_to_all"), wire=get("WIRE", "f32"),
        schedule=get("SCHEDULE", "frame"),
        wave_tiles=int(get("WAVE_TILES", 4)))
    return dict(
        exchange=exchange.exchange, wire=exchange.wire,
        schedule=exchange.schedule, wave_tiles=exchange.wave_tiles,
        rebalance=rebalance, width=int(get("WIDTH", 1280)), height=int(get("HEIGHT", 720)),
        grid=grid,
        render_dtype=render_dtype,
        k=int(get("K", 16)),
        frames=int(get("FRAMES", 25 if on_card else 5)),
        sim_steps=int(get("SIM_STEPS", 10)),
        adaptive_iters=int(get("ADAPTIVE_ITERS", 2)),
        adaptive_mode=adaptive_mode, engine=engine,
        steps=int(get("STEPS", 256)),
        fold=get("FOLD", "auto"),
        chunk=int(get("CHUNK", 16)),
        vtiles=int(get("VTILES", -1)),
        skip=skip,
        sim_fused=bool(int(get("SIM_FUSED", 1))),
        profile=bool(int(get("PROFILE", 0))),
        profile_frames=int(get("PROFILE_FRAMES", 3)))


def card_power_limit() -> str:
    """The first card's power limit as ``nvidia-smi`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def slice_march_flops(spec, grid: int, marches: int) -> float:
    """Matmul FLOPs of one frame of the slice march: ``marches`` full
    marches x grid slices x the two banded resampling products a slice
    ([nj, nv] @ [nv, nu], then @ [nu, ni]^T). Elementwise work (the
    stencil, the TF, the folds) is excluded: a matmul-only MFU."""
    nv = nu = grid  # in-plane voxel counts (cubic grid)
    per_slice = 2.0 * spec.nj * nu * (nv + spec.ni)
    return marches * grid * per_slice


def min_traffic_model(grid: int, sim_steps: int, marches: int,
                      render_bytes: int, sim_fused: bool) -> float:
    """Floor model of one frame's device-memory traffic when the cost
    count is unavailable: the sim term of ``cuda_stencil.
    modeled_sim_traffic``, the render copy written once and read once a
    march. Fold-state and stream traffic are excluded: a lower bound,
    so the GB/s derived from it is one too."""
    from scenery_insitu_tpu_torch.sim.cuda_stencil import modeled_sim_traffic

    vox = float(grid) ** 3
    sim = modeled_sim_traffic((grid,) * 3, sim_steps,
                              fused=sim_fused) if sim_steps else 0.0
    return sim + vox * render_bytes + marches * vox * render_bytes


def host_delivery(seconds: list):
    """The reference's host-delivery meter: each call copies a frame's
    VDI to the host, CRCs and deflates it (what the VDI disk sink pays)
    and adds its seconds to ``seconds[0]``."""
    import zlib

    def deliver(color, depth):
        t0 = time.perf_counter()
        for leaf in (color, depth):
            blob = leaf.cpu().numpy().tobytes()
            zlib.crc32(blob)
            zlib.compress(blob, 6)
        seconds[0] += time.perf_counter() - t0

    return deliver


def rebalance_block(field: torch.Tensor, grid: int, mode: str,
                    dev) -> dict:
    """The render-rebalance block of the result: the z live profile of
    the final field at the reference's modeled 8 ranks, the plan
    ``slice_plan`` would adopt, its histogram and the modeled straggler
    factors of the even and the planned split (max/mean per-rank march
    work). One card marches one band whatever the plan."""
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import occupancy as occ

    n_model = 8
    prof = occ.z_live_profile(field, for_dataset("gray_scott", device=dev)
                              ).cpu().numpy()
    even8 = occ.even_plan(grid, n_model)
    plan8 = occ.slice_plan(prof, grid, n_model, min_depth=4, quantum=4)
    return {
        "mode": mode,
        "modeled_ranks": n_model,
        "plan": list(plan8),
        "plan_histogram": {str(d): sum(1 for p in plan8 if p == d)
                           for d in sorted(set(plan8))},
        "straggler_even": round(occ.straggler_factor(prof, grid, even8), 3),
        "straggler_planned": round(occ.straggler_factor(prof, grid, plan8),
                                   3)}


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
    from scenery_insitu_tpu_torch import obs
    from scenery_insitu_tpu_torch.obs import roofline
    from scenery_insitu_tpu_torch.obs.device import device_cost
    from scenery_insitu_tpu_torch.ops.composite import (
        modeled_exchange_traffic)
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
                                 adaptive_iters=cfg["adaptive_iters"],
                                 exchange=cfg["exchange"], wire=cfg["wire"],
                                 schedule=cfg["schedule"],
                                 wave_tiles=cfg["wave_tiles"],
                                 rebalance=cfg["rebalance"]),
        engine=cfg["engine"], grid_shape=(grid,) * 3,
        axis_sign=slicer.choose_axis(base), slicer_cfg=march_cfg,
        render_dtype=cfg["render_dtype"], sim_fused=cfg["sim_fused"],
        occupancy=cfg["skip"], width=cfg["width"], height=cfg["height"],
        max_steps=cfg["steps"], device=dev)
    spec = step.spec
    mxu = spec is not None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    eye = lambda yaw: orbit(base, yaw).eye

    st = gs.GrayScott.init((grid,) * 3, device=dev)
    u, v = st.u, st.v
    thr = None
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
    fps = 1.0 / dt
    platform = "gpu" if on_card else "cpu"
    device_name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    power_limit = card_power_limit() if on_card else None
    matmul_dtype = spec.matmul_dtype if mxu else "f32"
    peak_tflops = roofline.peak_tflops(device_name, platform, matmul_dtype)
    peak_bw = roofline.kind_lookup(roofline.PEAK_HBM_GBPS, device_name,
                                   platform, 3350.0)
    marches = (1 if temporal else
               2 if cfg["adaptive_mode"] == "histogram"
               else cfg["adaptive_iters"] + 1)
    mfu = None
    if mxu and peak_tflops:
        mfu = round(slice_march_flops(spec, grid, marches) * fps
                    / (peak_tflops * 1e12), 5)

    # the frame's bytes: its cost count (one more frame, counted, on
    # the same state), else the floor model on the slice march (the
    # gather engine's traffic is sample-driven: no model there)
    frame_args = (u, v, eye(0.0)) + ((thr,) if temporal else ())
    cost_snap = device_cost(step, *frame_args)
    hbm_bytes = cost_snap.get("bytes_accessed")
    hbm_src = cost_snap["source"] if hbm_bytes else None
    if hbm_bytes is None and mxu:
        rb = 2 if spec.render_dtype == "bf16" else 4
        hbm_bytes = min_traffic_model(grid, cfg["sim_steps"], marches, rb,
                                      cfg["sim_fused"])
        hbm_src = "min_traffic_model"
    hbm_gbps = hbm_bytes / dt / 1e9 if hbm_bytes else None

    profile_attr = profile_roofline = None
    if cfg["profile"]:
        from scenery_insitu_tpu_torch.obs.profiler import (
            ProfileCapture, publish_attribution)

        # the frame threads its state through a closure; each profiled
        # frame also pays the host delivery, timed into the host phase
        pstate = {"u": u, "v": v, "thr": thr}
        host_s = [0.0]
        deliver = host_delivery(host_s)

        def profile_step():
            args = (pstate["u"], pstate["v"], eye(0.0))
            if temporal:
                c_, d_, pstate["u"], pstate["v"], pstate["thr"] = step(
                    *args, pstate["thr"])
            else:
                c_, d_, pstate["u"], pstate["v"] = step(*args)
            deliver(c_, d_)
            return c_

        cap = ProfileCapture(frames=cfg["profile_frames"],
                             host_time_fn=lambda: host_s[0])
        profile_attr = cap.capture(step, step=profile_step)
        u, v = pstate["u"], pstate["v"]
        if profile_attr is not None:
            publish_attribution(profile_attr)
            profile_roofline = roofline.roofline_verdicts(
                profile_attr, cost_snap, roofline.peaks_for(
                    device_name, platform, matmul_dtype, power_limit))

    # how sparse the measured scene was: the pyramid of the final field
    # (the slice march's structure; the gather engine has none)
    occupancy = None
    if mxu:
        pyr = occ.pyramid_from_volume(Volume.centered(v, extent=2.0),
                                      for_dataset("gray_scott", device=dev),
                                      spec)
        clf = pyr.chunk_live_fractions().cpu().numpy()
        occupancy = {
            "mode": cfg["skip"] or ("pyramid" if spec.vtiles > 0 else
                                    "chunk" if spec.skip_empty else "off"),
            "vtiles": spec.vtiles,
            "live_fraction": round(float(pyr.live_fraction()), 4),
            "chunk_live_hist": np.histogram(clf, bins=8,
                                            range=(0.0, 1.0))[0].tolist()}
        render = {"image": [spec.ni, spec.nj], "steps": grid,
                  "fold": spec.fold, "render_dtype": spec.render_dtype,
                  "vtiles": spec.vtiles, "skip_empty": spec.skip_empty}
    else:
        render = {"image": [cfg["width"], cfg["height"]],
                  "steps": cfg["steps"]}
    w_img, h_img = render["image"]
    tag = "_render_only" if cfg["sim_steps"] == 0 else ""
    # fps / 30 only at the 512^3 slice-march configuration: the render
    # work scales ~grid^4 and the sim ~grid^3, so no single exponent
    # converts a smaller grid's fps honestly
    matched = mxu and grid == 512 and cfg["sim_steps"] > 0
    return {
        "metric": f"gray_scott_{grid}c_vdi_fps_{w_img}x{h_img}_"
                  f"{platform}_1chip{tag}",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 4) if matched else None,
        "vs_baseline_unscaled": round(fps / 30.0, 4),
        "vs_baseline_note": (
            "fps/30 at the config-matched 512^3 mxu primary scale"
            if matched else
            "null: not the 512^3 mxu primary config — see "
            "vs_baseline_unscaled (raw fps/30)"),
        "ms_per_frame": round(dt * 1e3, 2),
        "mfu_matmul": mfu,
        "hbm_gbps": round(hbm_gbps, 2) if hbm_gbps else None,
        "hbm_frac_peak": (round(hbm_gbps / peak_bw, 4)
                          if hbm_gbps and peak_bw else None),
        "hbm_bytes_per_frame": round(hbm_bytes) if hbm_bytes else None,
        "hbm_bytes_source": hbm_src,
        "cost_analysis": {
            (f"regime={slicer.choose_axis(base)}" if mxu else "gather"):
                cost_snap},
        # what the wire would ship per rank at the reference's 8-rank
        # shape of this configuration: a model (one card has no exchange)
        "modeled_exchange_8rank": modeled_exchange_traffic(
            8, k, cfg["height"], cfg["width"], k_out=k,
            mode=cfg["exchange"], wire=cfg["wire"],
            schedule=cfg["schedule"], wave_tiles=cfg["wave_tiles"]),
        "occupancy": occupancy,
        "rebalance": rebalance_block(v, grid, cfg["rebalance"], dev),
        "phase_attribution": profile_attr,
        "roofline_verdicts": profile_roofline,
        "divergence": None,
        "divergence_note": ("null: the divergence report reads the "
                            "modeled projection of the benchmark folder, "
                            "which is not ported"),
        "degradations": obs.ledger(),
        "config": {
            "grid": grid, **render,
            "k": k, "frames": frames, "sim_steps": cfg["sim_steps"],
            "sim_fused": cfg["sim_fused"], "exchange": cfg["exchange"],
            "wire": cfg["wire"], "schedule": cfg["schedule"],
            "wave_tiles": cfg["wave_tiles"], "skip": cfg["skip"],
            "rebalance": cfg["rebalance"],
            "adaptive_iters": cfg["adaptive_iters"],
            "adaptive_mode": cfg["adaptive_mode"], "chunk": cfg["chunk"],
            "warmup_s": round(warmup_s, 1), "platform": platform,
            "device": device_name, "power_limit": power_limit,
            "assumed_peak_tflops": peak_tflops,
            "assumed_peak_hbm_gbps": peak_bw,
            "matmul_dtype": matmul_dtype,
            "engine": cfg["engine"]},
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

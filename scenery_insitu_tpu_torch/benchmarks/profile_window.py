"""How often a profiled window loses or gains a device event, with and
without `ProfileCapture`'s margins at the window's edges.

    python -m scenery_insitu_tpu_torch.benchmarks.profile_window \\
        [--captures 40] [--margins 0,0.05] [--grid 512]

It runs the Gray-Scott VDI frame step (``chip_smoke.py`` phase 3's
frame: 10 sim steps, K = 16, 16 bins, chunk 16, the temporal
threshold) under ``obs.profiler.ProfileCapture`` (one warm-up frame,
two measured), ``--captures`` captures for each margin, the margins
taken in turns. For each capture it compares K3's launches in the
measured frames (``kernels.launches()``) with its kernel rows in the
trace, and takes the least gap between a kernel's timestamp and that
of the call that launched it: a kernel cannot start before its launch,
so a negative gap is the trace's clock error. One JSON row a capture,
then one a margin (captures whose rows differ from the launches, the
least gap); exits 1 if a capture under the last margin differs.

Needs a card: the clock error is that of a device trace.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile

K3_ENTRY = "grayscott_fused"
K3_KERNEL = "grayscott_stream_kernel"
BASE_EYE = (0.0, 0.6, 3.0)


def _least_gap_us(path: str) -> float:
    with open(path) as f:
        xs = [e for e in json.load(f).get("traceEvents", [])
              if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in (e.get("args") or {})}
    gaps = [float(e["ts"]) - launch[e["args"]["correlation"]] for e in xs
            if e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in launch]
    return min(gaps) if gaps else math.nan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--captures", type=int, default=40)
    ap.add_argument("--margins", default="0,0.05",
                    help="comma-separated WINDOW_MARGIN_S values, seconds")
    ap.add_argument("--grid", type=int, default=512)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_window: needs a card (the clock error is "
                         "that of a device trace)")

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.obs import profiler
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    dev = torch.device("cuda")
    n = args.grid
    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    step = grayscott_vdi_frame_step(
        sim_steps=10, grid_shape=(n,) * 3, axis_sign=slicer.choose_axis(base),
        vdi_cfg=VDIConfig(max_supersegments=16, adaptive_iters=2,
                          adaptive_mode="temporal", histogram_bins=16),
        comp_cfg=CompositeConfig(max_output_supersegments=16,
                                 adaptive_iters=2),
        slicer_cfg=SliceMarchConfig(chunk=16), device=dev)
    st = gs.GrayScott.init((n,) * 3, seed=0, device=dev)
    count = [0]

    def eye():
        count[0] += 1
        return orbit(base, 0.35 * math.sin(0.7 * (count[0] + 1))).eye

    state = [st.u, st.v, step.init_threshold(st.u, st.v, eye())]

    def frame():
        _, _, state[0], state[1], state[2] = step(state[0], state[1], eye(),
                                                  state[2])

    frame()
    margins = [float(m) for m in args.margins.split(",")]
    summary = {m: {"captures": 0, "differ": 0, "least_gap_us": math.inf}
               for m in margins}
    trace_dir = tempfile.mkdtemp(prefix="sitpu_profile_window_")
    for i in range(args.captures):
        for m in margins:
            calls = [0]

            def counted():
                calls[0] += 1
                if calls[0] == 2:          # the first measured frame
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                frame()

            profiler.WINDOW_MARGIN_S = m
            cap = profiler.ProfileCapture(frames=2, warmup=1,
                                          trace_dir=trace_dir)
            if cap.capture(None, step=counted) is None:
                raise RuntimeError("profile_window: the capture failed")
            launches = kernels.launches()[K3_ENTRY]
            rows = sum(1 for name, _, _ in cap.rows if K3_KERNEL in name)
            gap = _least_gap_us(os.path.join(trace_dir, "trace.json"))
            print(json.dumps({"capture": i, "margin_s": m,
                              "launches": launches, "rows": rows,
                              "least_gap_us": gap}), flush=True)
            s = summary[m]
            s["captures"] += 1
            s["differ"] += rows != launches
            s["least_gap_us"] = min(s["least_gap_us"], gap)
    shutil.rmtree(trace_dir, ignore_errors=True)
    for m in margins:
        print(json.dumps({"margin_s": m, **summary[m]}), flush=True)
    return 1 if summary[margins[-1]]["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())

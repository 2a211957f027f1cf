"""Growing-host weak scaling of the two-level composite's host path: the
twin of the reference's ``benchmarks/scaling_bench.py --mode hosts``.

    python -m scenery_insitu_tpu_torch.benchmarks.scaling_bench \\
        --mode hosts [--max-hosts 2] [--ranks-per-host 2] [--frames 10] \\
        [--dcn-wire f32|qpack8] [--device cpu]

For each host count h in 1, 2, 4, 8 (up to ``--max-hosts``) it starts
one fleet of h processes through the harness (``testing/multiproc.py``,
gloo; on a card every process on the same card) at a FIXED volume a
rank (weak scaling): each process marches its slab block on its own
in-process mesh of ``--ranks-per-host`` ranks and runs level 1 there
(``parallel/hier.domain_partial_vdi_step``), ships its partial as tile
streams over loopback, and the head merges them and resegments once
(``hier.run_host_path``). One JSON row a fleet: ms a frame and fps
(barrier to the head's assembled frame, host clock, frame 0 dropped),
the DCN bytes a host sent and the head received a frame, measured, and
the ``modeled_dcn_traffic`` model beside them; then the sweep's JSON
with the weak efficiency (fps over the one-host fps).

The reference's ``strong``, ``weak`` and ``hier-device`` modes (the
1-to-N rank sweep and the device-path A/B) raise: they are the
benchmark twins item of ROADMAP A11.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HOSTS_G = 24          # in-plane grid of the weak-scaling scene
HOSTS_GPR = 6         # z slices a RANK (fixed: weak scaling)
HOSTS_K = 6
HOSTS_KOUT = 8
HOSTS_W = HOSTS_H = 16
HOSTS_STEPS = 24

ENTRY = "scenery_insitu_tpu_torch.benchmarks.scaling_bench:_entry_weak"


def _entry_weak(ctx) -> None:
    """Harness worker of ``--mode hosts``: ``frames`` + 1 host-path
    frames at a fixed volume a rank; the head writes the fleet's row."""
    import numpy as np
    import torch

    from scenery_insitu_tpu_torch import obs
    from scenery_insitu_tpu_torch.config import CompositeConfig, VDIConfig
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.parallel.hier import (modeled_dcn_traffic,
                                                        run_host_path)
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    frames, dcn_wire = int(ctx.args[0]), ctx.args[1]
    pid, nproc, dev = ctx.process_id, ctx.num_processes, ctx.device
    ranks = ctx.ranks_per_proc
    obs.set_recorder(obs.Recorder(enabled=True, rank=pid))
    gz, g = HOSTS_GPR * nproc * ranks, HOSTS_G
    # the same seeded state in every process; each reads its own block
    field = gs.GrayScott.init((gz, g, g), n_seeds=4, device="cpu").v.numpy()
    tf = for_dataset("gray_scott", device=dev)
    cam = Camera.create((0.0, 0.4, 3.0), fov_y_deg=50.0, near=0.5,
                        far=20.0, device=dev)
    origin = torch.tensor([-1.0, -1.0, -1.0], device=dev)
    spacing = torch.tensor([2.0 / g, 2.0 / g, 2.0 / gz], device=dev)
    vcfg = VDIConfig(max_supersegments=HOSTS_K, adaptive_iters=2)
    ccfg = CompositeConfig(max_output_supersegments=HOSTS_KOUT,
                           adaptive_iters=2)
    out = run_host_path(pid, nproc, field, tf, cam, origin, spacing,
                        HOSTS_W, HOSTS_H, vcfg, ccfg, ranks, dev,
                        max_steps=HOSTS_STEPS, frames=frames + 1,
                        codec="zlib",
                        precision="qpack8" if dcn_wire == "qpack8"
                        else "f32")
    if pid != 0:
        return
    assert all(c is not None and not deg for c, _, deg in out["frames"])
    ms = float(np.mean(out["ms"][1:]))        # frame 0 builds, dropped
    row = {
        "hosts": nproc, "ranks_per_host": ranks, "n_ranks": nproc * ranks,
        "grid": [gz, g, g], "frames": frames, "dcn_wire": dcn_wire,
        "device": str(dev), "ms_per_frame": round(ms, 2),
        "fps": round(1000.0 / ms, 3),
        "head_merge_ms_per_frame": round(float(np.mean(
            out["merge_ms"][1:])), 3),
        "dcn_bytes_sent_per_host_measured": int(np.mean(out["sent"][1:])),
        "dcn_bytes_received_head_measured": int(np.mean(
            out["received"][1:])),
        "modeled": modeled_dcn_traffic(nproc, ranks, HOSTS_K, HOSTS_H,
                                       HOSTS_W, dcn_wire=dcn_wire),
    }
    with open(os.path.join(ctx.workdir, f"ws_hosts_{nproc}.json"),
              "w") as fp:
        json.dump(row, fp)


def hosts_mode(max_hosts: int = 2, ranks_per_host: int = 2,
               frames: int = 10, dcn_wire: str = "f32", device=None
               ) -> dict:
    """One harness fleet a host count; returns the sweep's record (the
    JSON ``main`` prints). ``device`` None means CUDA."""
    from scenery_insitu_tpu_torch.device import resolve_device
    from scenery_insitu_tpu_torch.testing import multiproc

    dev = resolve_device(device)
    sweep = []
    with tempfile.TemporaryDirectory() as workdir:
        for hosts in [h for h in (1, 2, 4, 8) if h <= max_hosts]:
            t0 = time.perf_counter()
            results = multiproc.run_multiproc(
                ENTRY, hosts, ranks_per_host, workdir=workdir,
                args=(frames, dcn_wire), timeout_s=600.0, device=dev)
            bad = [r for r in results if not r.ok]
            if bad:
                print(f"[hier] hosts={hosts} FAILED:\n{bad[0].output}",
                      file=sys.stderr, flush=True)
                sweep.append({"hosts": hosts, "error":
                              f"worker {bad[0].process_id} rc="
                              f"{bad[0].returncode}"})
                continue
            with open(os.path.join(workdir, f"ws_hosts_{hosts}.json")) as f:
                row = json.load(f)
            row["wall_s"] = round(time.perf_counter() - t0, 1)
            sweep.append(row)
            print(f"[hier] hosts={hosts}: {row['ms_per_frame']} ms/frame "
                  f"dcn {row['dcn_bytes_sent_per_host_measured']} "
                  f"B/host/frame", file=sys.stderr, flush=True)
    base = next((r["fps"] for r in sweep
                 if r.get("hosts") == 1 and "fps" in r), None)
    for row in sweep:
        if base and "fps" in row:
            # weak scaling: the ideal keeps the fps flat
            row["weak_efficiency"] = round(row["fps"] / base, 3)
    return {
        "metric": f"hier_weak_scaling_{dev.type}",
        "value": sweep[-1].get("weak_efficiency") if sweep else None,
        "unit": "weak_parallel_efficiency",
        "sweep": sweep,
        "config": {"mode": "hosts", "per_rank_z": HOSTS_GPR,
                   "grid_inplane": HOSTS_G, "k": HOSTS_K,
                   "frames": frames, "dcn_wire": dcn_wire,
                   "ranks_per_host": ranks_per_host, "backend": "gloo",
                   "note": ("host-path two-level composite through the "
                            "subprocess harness: per-host local-mesh "
                            "domain partials, tile streams over loopback, "
                            "incremental head assembly; ms/frame "
                            "includes the head merge")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("strong", "weak", "hosts",
                                       "hier-device"), default="hosts")
    ap.add_argument("--max-hosts", type=int, default=2,
                    help="the largest process count of the sweep")
    ap.add_argument("--ranks-per-host", type=int, default=2)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--dcn-wire", default="f32",
                    choices=("f32", "bf16", "qpack8"),
                    help="wire of the inter-host hop (bf16 ships f32 "
                         "tiles, as the reference's does)")
    ap.add_argument("--device", default=None,
                    help="the fleet's device (default: CUDA)")
    args = ap.parse_args(argv)
    if args.mode != "hosts":
        raise NotImplementedError(
            f"--mode {args.mode} (the 1-to-N rank sweep and the "
            "device-path A/B) is the benchmark twins item of ROADMAP A11; "
            "this twin runs --mode hosts")
    rec = hosts_mode(args.max_hosts, args.ranks_per_host, args.frames,
                     args.dcn_wire, args.device)
    print(json.dumps(rec, indent=2), flush=True)
    return 0 if all("error" not in r for r in rec["sweep"]) else 1


if __name__ == "__main__":
    sys.exit(main())

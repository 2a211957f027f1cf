"""Standalone in-situ loop on the port: built-in Gray-Scott sim -> VDI frame
over the session's rank mesh -> PNG frames (+ optional checkpoints).

The twin of the reference's ``examples/insitu_grayscott.py``:

    python -m scenery_insitu_tpu_torch.examples.insitu_grayscott \\
        --frames 20 --out out/ --grid 64              # on the card
    python -m scenery_insitu_tpu_torch.examples.insitu_grayscott \\
        --frames 3 --grid 16 --device cpu --checkpoint-every 2
    ... --resume out/ckpt_00004.npz                   # continue a run

``--device`` defaults to CUDA. The reference's streaming options
(``--publish``, ``--steer-bind``, ``--movie``, ``--live-udp``) are
ROADMAP A11 and raise.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the in-process mesh (0 = one)")
    ap.add_argument("--out", default="out")
    ap.add_argument("--orbit", type=float, default=0.03,
                    help="camera radians/frame")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--prewarm", action="store_true",
                    help="build every camera regime's step at startup "
                    "(see InSituSession.prewarm_regimes)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default="", help="checkpoint to resume from")
    for flag in ("--publish", "--steer-bind", "--movie"):
        ap.add_argument(flag, default="", help="not ported (ROADMAP A11)")
    ap.add_argument("--live-udp", type=int, default=0,
                    help="not ported (ROADMAP A11)")
    args = ap.parse_args(argv)
    for name in ("publish", "steer_bind", "movie", "live_udp"):
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} (VDI streaming, steering and "
                f"video) is not ported yet (ROADMAP A11)")

    from scenery_insitu_tpu_torch.config import FrameworkConfig
    from scenery_insitu_tpu_torch.runtime.checkpoint import (checkpoint_sink,
                                                             load_session)
    from scenery_insitu_tpu_torch.runtime.session import (InSituSession,
                                                          png_sink)

    g = args.grid
    cfg = FrameworkConfig().with_overrides(
        f"sim.grid=[{g},{g},{g}]", f"mesh.num_devices={args.ranks}",
        "slicer.engine=mxu", "vdi.adaptive_mode=temporal",
        "runtime.dataset=gray_scott")
    sess = InSituSession(cfg, sinks=[png_sink(args.out)], device=args.device)
    sess.orbit_rate = args.orbit
    if args.checkpoint_every:
        sess.sinks.append(checkpoint_sink(
            args.out, every=args.checkpoint_every).bind(sess))
    if args.resume:
        load_session(sess, args.resume)
        print(f"resumed at frame {sess.frame_index}")
    if args.prewarm:
        times = sess.prewarm_regimes()
        print("prewarmed regimes:", {k: f"{v}s" for k, v in times.items()})
    sess.run(args.frames)
    print(f"wrote {args.frames} frames to {args.out}/ "
          f"(engine={sess.engine}, mode={sess.mode}, "
          f"device={sess.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

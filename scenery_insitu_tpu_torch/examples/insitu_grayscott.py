"""Standalone in-situ loop on the port: built-in Gray-Scott sim -> VDI frame
over the session's rank mesh -> PNG frames (+ optional ZMQ VDI stream,
steering, movie, live video and checkpoints).

The twin of the reference's ``examples/insitu_grayscott.py``:

    python -m scenery_insitu_tpu_torch.examples.insitu_grayscott \\
        --frames 20 --out out/ --grid 64              # on the card
    python -m scenery_insitu_tpu_torch.examples.insitu_grayscott \\
        --frames 3 --grid 16 --device cpu --checkpoint-every 2
    ... --resume out/ckpt_00004.npz                   # continue a run
    ... --publish 'tcp://*:6655' --steer-bind 'tcp://*:6656'  # + stream
    ... --movie out/run.h264 --live-udp 3337          # + video

``--device`` defaults to CUDA. ``--publish`` and ``--steer-bind`` need
pyzmq and msgpack, ``--live-udp`` and a ``--movie`` path not ending in
``.h264`` need cv2 (``.h264`` writes the I_PCM H.264 stream with numpy).
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
    ap.add_argument("--publish", default="",
                    help="ZMQ bind address to stream VDIs (e.g. tcp://*:6655)")
    ap.add_argument("--steer-bind", default="",
                    help="ZMQ bind address accepting camera steering "
                         "messages (runtime.streaming.SteeringPublisher)")
    ap.add_argument("--movie", default="",
                    help="also write a movie of the run (.h264: the I_PCM "
                         "H.264 stream; else cv2's writer)")
    ap.add_argument("--live-udp", type=int, default=0,
                    help="also stream frames live over UDP on this port "
                         "(view with runtime.streaming.VideoReceiver)")
    args = ap.parse_args(argv)

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
    sinks = [png_sink(args.out)]
    movie = None
    if args.publish:
        from scenery_insitu_tpu_torch.runtime.streaming import (VDIPublisher,
                                                                stream_sink)
        sinks.append(stream_sink(VDIPublisher(args.publish)))
    if args.movie:
        from scenery_insitu_tpu_torch.runtime.streaming import video_sink
        movie = video_sink(args.movie, codec="h264_ipcm"
                           if args.movie.endswith(".h264") else "auto")
        sinks.append(movie)
    if args.live_udp:
        from scenery_insitu_tpu_torch.runtime.streaming import (
            VideoStreamer, live_video_sink)
        sinks.append(live_video_sink(VideoStreamer(port=args.live_udp)))
    sess = InSituSession(cfg, sinks=sinks, device=args.device)
    if args.steer_bind:
        from scenery_insitu_tpu_torch.runtime.streaming import (
            SteeringEndpoint)
        sess.steering = SteeringEndpoint(args.steer_bind)
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
    try:
        sess.run(args.frames)
    finally:
        if movie is not None:   # finalize the movie even on interrupt
            movie.release()
    print(f"wrote {args.frames} frames to {args.out}/ "
          f"(engine={sess.engine}, mode={sess.mode}, "
          f"device={sess.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

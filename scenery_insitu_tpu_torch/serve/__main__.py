"""``python -m scenery_insitu_tpu_torch.serve`` — run the VDI
edge-serving process (docs/SERVING.md) on CUDA, or with ``--device cpu``.

Pair with any VDI publisher, e.g.::

    python -m scenery_insitu_tpu_torch.examples.insitu_grayscott \
        --publish 'tcp://*:6655' &
    python -m scenery_insitu_tpu_torch.serve \
        --connect tcp://localhost:6655 --bind 'tcp://*:6657'

then point `ViewerClient` (or several) at the bind address.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="VDI edge server: subscribe to a composited VDI "
                    "stream, answer N client cameras per frame from one "
                    "batched render (docs/SERVING.md)")
    ap.add_argument("--connect", default=None,
                    help="upstream VDI stream (default serve.connect)")
    ap.add_argument("--bind", default=None,
                    help="client-facing endpoint (default serve.bind)")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="serve this long then exit (0 = forever)")
    ap.add_argument("--stats-every", type=float, default=10.0,
                    help="seconds between stats lines")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="config override, e.g. serve.max_viewers=128 "
                         "(repeatable)")
    ap.add_argument("--device", default=None,
                    help="torch device of the renders (default: cuda)")
    args = ap.parse_args(argv)

    from scenery_insitu_tpu_torch.config import FrameworkConfig
    from scenery_insitu_tpu_torch.serve.server import ViewerServer

    cfg = FrameworkConfig.load(overrides=tuple(args.override))
    srv = ViewerServer(cfg, connect=args.connect, bind=args.bind,
                       device=args.device)
    print(f"serving on {srv.endpoint} (device {srv.device}, upstream "
          f"{args.connect or cfg.serve.connect}, tiers exact/proxy/wire, "
          f"max_viewers={cfg.serve.max_viewers})", flush=True)
    deadline = None if args.seconds <= 0 else time.monotonic() + args.seconds
    next_stats = time.monotonic() + args.stats_every
    try:
        while deadline is None or time.monotonic() < deadline:
            srv.run_once(timeout_ms=50)
            if time.monotonic() >= next_stats:
                print(json.dumps({"clients": len(srv.clients),
                                  **srv.stats}), flush=True)
                next_stats = time.monotonic() + args.stats_every
    except KeyboardInterrupt:
        pass
    finally:
        print(json.dumps({"final": True, "clients": len(srv.clients),
                          **srv.stats}), file=sys.stdout, flush=True)
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Inspect and recover a shm channel (the reference's
``ingest/shm_tool.py``).

Usage (``python -m scenery_insitu_tpu_torch.ingest.shm_tool``):
  shm_tool NAME             # inspect the channel's control block
  shm_tool NAME --reset     # clear stale reader pins
  shm_tool NAME --unlink    # remove the channel
  shm_tool NAME --json      # the same, as one JSON object

A channel that does not exist exits with status 1 and a message.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("channel", help="channel name, e.g. /sitpu_vol")
    p.add_argument("--reset", action="store_true",
                   help="clear stale reader pins (crashed-consumer recovery)")
    p.add_argument("--unlink", action="store_true",
                   help="remove the channel from the shm namespace")
    p.add_argument("--json", action="store_true", help="machine output")
    args = p.parse_args(argv)

    from scenery_insitu_tpu_torch.ingest import shm

    try:
        stats = shm.channel_stats(args.channel)
    except FileNotFoundError:
        raise SystemExit(f"no channel {args.channel!r}") from None

    if args.reset:
        stats["pins_cleared"] = shm.reset_readers(args.channel)
    if args.unlink:
        stats["unlinked"] = shm.unlink(args.channel)

    if args.json:
        print(json.dumps(stats))
    else:
        slots = stats.pop("slots")
        for k, v in stats.items():
            print(f"{k:16}: {v}")
        for i, s in enumerate(slots):
            print(f"slot {i}: readers={s['readers']} seq={s['seq']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

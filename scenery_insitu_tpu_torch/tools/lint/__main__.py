"""CLI: ``python -m scenery_insitu_tpu_torch.tools.lint [options] [paths...]``

Exit 0 when every finding is baselined (``tools/lint/baseline.json``) or
suppressed inline; exit 1 on new findings: the gate fails on
regressions, never on the accepted debt listed with its reasons in the
baseline.

Options:
  --baseline PATH    baseline file (default: tools/lint/baseline.json
                     next to this package)
  --no-baseline      ignore the baseline (show everything)
  --write-baseline   rewrite the baseline from the current findings,
                     keeping existing reasons and stamping new entries
                     "TODO: justify or fix" (then exit 1 until edited)
  --report PATH      write the full JSON report (findings and the
                     baseline's accounting)
  --fail-on-stale    exit 1 when baseline entries match no finding
                     (paid-off debt is pruned, not left as a dead row
                     that could absorb a regression)
  paths              .py and .cu files or directories to scan (default:
                     the port's package minus tools/, bench.py and
                     benchmarks/, plus csrc/*.cu)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from scenery_insitu_tpu_torch.tools.lint.core import (
    Baseline, find_repo_root, load_sources_with_diags)
from scenery_insitu_tpu_torch.tools.lint.runner import (
    collect_paths, default_baseline_path, run_checks)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="sitpu-lint", description=__doc__)
    ap.add_argument("--baseline", default=default_baseline_path())
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--report", default=None)
    ap.add_argument("--fail-on-stale", action="store_true")
    ap.add_argument("paths", nargs="*")
    args = ap.parse_args(argv)

    root = find_repo_root()
    srcs, parse_diags = load_sources_with_diags(
        root, collect_paths(root, args.paths))
    diags = parse_diags + run_checks(srcs)

    if args.write_baseline:
        old = Baseline.load(args.baseline) if os.path.exists(args.baseline) \
            else Baseline([])
        reasons = {(e["code"], e["path"], e["message"]): e["reason"]
                   for e in old.entries}
        entries = [Baseline.entry_for(
            d, reasons.get(d.key(), "TODO: justify or fix"))
            for d in diags]
        Baseline(entries).save(args.baseline)
        todo = sum(1 for e in entries
                   if e["reason"] == "TODO: justify or fix")
        print(f"wrote {len(entries)} baseline entries to {args.baseline}"
              f" ({todo} need a reason)")
        return 1 if todo else 0

    bl = Baseline([]) if args.no_baseline else Baseline.load(args.baseline)
    new, accepted, stale = bl.split(diags)

    for d in new:
        print(d.render())
    if accepted:
        print(f"# {len(accepted)} finding(s) accepted by baseline "
              f"({os.path.relpath(args.baseline, root)})")
    for e in stale:
        print(f"# stale baseline entry (no longer matches): "
              f"{e['code']} {e['path']} — consider removing")

    if args.report:
        report = {
            "tool": "sitpu-lint",
            "counts": {"new": len(new), "baselined": len(accepted),
                       "stale_baseline": len(stale),
                       "files_scanned": len(srcs)},
            "new": [d.__dict__ for d in new],
            "baselined": [d.__dict__ for d in accepted],
            "stale_baseline": stale,
        }
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    if new:
        print(f"sitpu-lint: {len(new)} new finding(s) "
              f"({len(accepted)} baselined)")
        return 1
    if stale and args.fail_on_stale:
        print(f"sitpu-lint: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} — prune them "
              f"(--fail-on-stale)")
        return 1
    print(f"sitpu-lint: clean ({len(accepted)} baselined finding(s), "
          f"{len(srcs)} files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

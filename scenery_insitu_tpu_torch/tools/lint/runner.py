"""sitpu-lint runner: path collection, checker dispatch, the gate.

Shared by the CLI (``__main__``) and the tests (``run_lint``), kept out
of ``__main__`` so importing the package never shadows the ``python -m``
entry module.
"""

from __future__ import annotations

import os
from typing import List, Optional

from scenery_insitu_tpu_torch.tools.lint import (counters, cuda, knobs,
                                                 ledger, thread)
from scenery_insitu_tpu_torch.tools.lint.core import (
    Baseline, Diagnostic, SourceFile, default_scan_paths, find_repo_root,
    load_sources_with_diags)

CHECKERS = (ledger, counters, thread, cuda, knobs)
_SUFFIXES = (".py", ".cu")


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def collect_paths(repo_root: str, args_paths: List[str]) -> List[str]:
    """The default scan, or the ``.py`` and ``.cu`` files of the given
    files and directories."""
    if not args_paths:
        return default_scan_paths(repo_root)
    out = []
    for p in args_paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                out.extend(os.path.join(dirpath, f) for f in filenames
                           if f.endswith(_SUFFIXES))
        else:
            out.append(p)
    return out


def run_checks(sources: List[SourceFile]) -> List[Diagnostic]:
    """Every checker over the sources, inline suppressions applied,
    in a stable order."""
    by_path = {s.path: s for s in sources}
    diags: List[Diagnostic] = []
    for checker in CHECKERS:
        diags.extend(checker.check(sources))
    diags = [d for d in diags
             if d.path not in by_path
             or not by_path[d.path].suppressed(d.line, d.code)]
    return sorted(diags, key=lambda d: (d.path, d.line, d.code, d.message))


def run_lint(paths: Optional[List[str]] = None,
             baseline_path: Optional[str] = None,
             repo_root: Optional[str] = None):
    """Library entry: (new, accepted, stale, all_diags). Files that do
    not parse are SITPU-PARSE findings."""
    root = repo_root or find_repo_root()
    srcs, parse_diags = load_sources_with_diags(
        root, collect_paths(root, paths or []))
    diags = parse_diags + run_checks(srcs)
    bl = Baseline.load(baseline_path or default_baseline_path())
    new, accepted, stale = bl.split(diags)
    return new, accepted, stale, diags

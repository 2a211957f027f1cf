"""sitpu-lint core: loading sources, inline suppressions, the baseline
gate.

The suite is pure stdlib ``ast`` over the Python sources and plain text
over the CUDA sources (``csrc/*.cu``): it imports no torch and runs none
of the code it reads. Checkers receive :class:`SourceFile` objects and
return :class:`Diagnostic` records; this module owns what surrounds
them:

- **inline suppressions**: a ``# sitpu-lint: disable=CODE[,CODE...]``
  comment (``// sitpu-lint: ...`` in a ``.cu`` file) on the finding's
  line, or ``disable=all``, silences it at the source, for true
  positives the code cannot express otherwise; the surrounding comment
  says why.
- **the baseline** (``tools/lint/baseline.json``): the committed list
  of accepted findings, each with a mandatory ``reason``. The gate fails
  only on findings not in it. Entries match on ``(code, path,
  message)``, never on line numbers, and entries that no longer match a
  finding are reported as stale so the baseline shrinks as debts are
  paid.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_SUPPRESS_RE = re.compile(r"sitpu-lint:\s*disable=([A-Za-z0-9_,\- ]+)")
PACKAGE = "scenery_insitu_tpu_torch"


@dataclass(frozen=True)
class Diagnostic:
    """One finding: ``path:line  CODE  message`` (path repo-relative)."""

    path: str
    line: int
    code: str
    message: str
    symbol: str = ""          # enclosing function, for readers and baseline

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}  {self.code}  {self.message}{sym}"

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers churn, messages are stable."""
        return (self.code, self.path, self.message)


class SourceFile:
    """One loaded file: a Python source's AST, or a CUDA source's text
    (``is_cuda``, an empty AST), with its per-line suppression sets."""

    def __init__(self, abspath: str, relpath: str, text: str):
        self.abspath = abspath
        self.path = relpath            # repo-relative, '/' separators
        self.text = text
        self.is_cuda = relpath.endswith((".cu", ".cuh"))
        if self.is_cuda:
            self.tree = ast.Module(body=[], type_ignores=[])
            self.suppressions = _cuda_suppressions(text)
        else:
            self.tree = ast.parse(text, filename=relpath)
            self.suppressions = _parse_suppressions(text)

    def suppressed(self, line: int, code: str) -> bool:
        codes = self.suppressions.get(line)
        return bool(codes) and (code in codes or "all" in codes)


def _codes(match) -> Set[str]:
    return {c.strip() for c in match.group(1).split(",") if c.strip()}


def _parse_suppressions(text: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                m = _SUPPRESS_RE.search(tok.string)
                if m:
                    out.setdefault(tok.start[0], set()).update(_codes(m))
    except tokenize.TokenError:
        pass
    return out


def _cuda_suppressions(text: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        _, sep, comment = line.partition("//")
        m = _SUPPRESS_RE.search(comment) if sep else None
        if m:
            out.setdefault(i, set()).update(_codes(m))
    return out


def _relpath(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def load_sources(root: str, paths: Iterable[str]) -> List[SourceFile]:
    """Load ``paths`` (absolute) into SourceFiles; raises on a Python
    syntax error (the gate uses :func:`load_sources_with_diags`)."""
    out = []
    for p in sorted(set(paths)):
        with open(p, "r", encoding="utf-8") as f:
            out.append(SourceFile(p, _relpath(root, p), f.read()))
    return out


def load_sources_with_diags(root: str, paths: Iterable[str]
                            ) -> Tuple[List[SourceFile], List[Diagnostic]]:
    """Like :func:`load_sources`, but a file that does not parse becomes
    a ``SITPU-PARSE`` finding instead of ending the run, so the gate
    fails and still writes its report."""
    out, diags = [], []
    for p in sorted(set(paths)):
        rel = _relpath(root, p)
        with open(p, "r", encoding="utf-8") as f:
            text = f.read()
        try:
            out.append(SourceFile(p, rel, text))
        except SyntaxError as e:
            diags.append(Diagnostic(rel, e.lineno or 1, "SITPU-PARSE",
                                    f"file does not parse: {e.msg}"))
    return out, diags


def package_paths(repo_root: str, skip: Sequence[str] = ()) -> List[str]:
    """Every ``.py`` of the port's package but those under the package
    directories or files ``skip`` (package-relative)."""
    pkg = os.path.join(repo_root, PACKAGE)
    skips = tuple(os.path.join(pkg, s) for s in skip)
    paths = []
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in filenames:
            p = os.path.join(dirpath, name)
            if name.endswith(".py") and not any(
                    p == s or p.startswith(s + os.sep) for s in skips):
                paths.append(p)
    return paths


def default_scan_paths(repo_root: str) -> List[str]:
    """The surface the invariants cover: the port's package minus the
    linter itself (host tooling with no degrade semantics), the bench
    twin and the benchmark twins, plus the kernels' CUDA sources
    ``csrc/*.cu``."""
    paths = package_paths(repo_root, ("tools", "bench.py", "benchmarks"))
    csrc = os.path.join(repo_root, PACKAGE, "csrc")
    paths += [os.path.join(csrc, n) for n in sorted(os.listdir(csrc))
              if n.endswith(".cu")]
    return paths


def find_repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    # tools/lint -> tools -> the package -> the repository
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


# ------------------------------------------------------------------ AST util

def iter_calls(node: ast.AST) -> Iterable[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def call_name(call: ast.Call) -> str:
    """Rightmost name of the called expression: ``obs.degrade`` ->
    ``degrade``, ``a.b.c()`` -> ``c``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def dotted_name(expr: ast.AST) -> str:
    """``kernels.launch`` -> "kernels.launch"; "" when not a pure name
    chain."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return ""


# functions that mint a ledger entry, with the positional index of their
# literal component argument (the LEDGER checker and the registry
# round trip both use it)
DEGRADE_WRAPPERS = {"degrade": 0}


def calls_degrade(node: ast.AST) -> bool:
    """Does ``node`` contain a ledger mint (``obs.degrade(...)``)?"""
    return any(call_name(c) in DEGRADE_WRAPPERS for c in iter_calls(node))


def enclosing_fn_of(tree: ast.Module, node: ast.AST):
    """Nearest function lexically containing ``node`` (None: module)."""
    best = None
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if n.lineno <= node.lineno <= (n.end_lineno or n.lineno):
                if best is None or n.lineno > best.lineno:
                    best = n
    return best


def func_params(fn) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


# ----------------------------------------------------------------- baseline

class Baseline:
    """The committed list of accepted findings. Every entry carries a
    mandatory ``reason``: a baseline without reasons is a muted linter."""

    def __init__(self, entries: Optional[List[dict]] = None):
        self.entries = entries or []
        bad = [e for e in self.entries
               if not str(e.get("reason", "")).strip()]
        if bad:
            raise ValueError(
                f"baseline entries without a reason string: "
                f"{[(e.get('code'), e.get('path')) for e in bad]}")
        self._index = {(e["code"], e["path"], e["message"]): e
                       for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([])
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f).get("entries", []))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "entries": self.entries}, f, indent=2)
            f.write("\n")

    def split(self, diags: Sequence[Diagnostic]):
        """(new, accepted, stale_entries)."""
        new, accepted = [], []
        hit: Set[Tuple[str, str, str]] = set()
        for d in diags:
            if d.key() in self._index:
                accepted.append(d)
                hit.add(d.key())
            else:
                new.append(d)
        stale = [e for k, e in self._index.items() if k not in hit]
        return new, accepted, stale

    @staticmethod
    def entry_for(d: Diagnostic, reason: str) -> dict:
        return {"code": d.code, "path": d.path, "message": d.message,
                "symbol": d.symbol, "reason": reason}

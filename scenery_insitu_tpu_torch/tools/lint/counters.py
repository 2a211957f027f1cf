"""SITPU-COUNTER: every counter name is in the catalog.

The contract (``obs/recorder.py``): every counter name a
``Recorder.count(...)`` site can bump is registered in
``obs.counter_registry()`` with a one-line meaning; the ledger contract
(SITPU-LEDGER) applied to the other half of the obs surface.

Discovery covers the two shapes counter names take:

- ``rec.count("name")`` / ``obs.count("name", n)`` with a **string
  literal** name;
- names threaded through ``*_counter``-suffixed **parameters** (a shared
  builder relabelled by its callers): the string default of such a
  parameter and every string literal passed to one are counter names.

Flagged:

- **C1**: a discovered name that is not in ``obs.counter_registry()``;
- **C2**: a ``.count(x)`` whose name is a plain variable that is not a
  ``*_counter`` parameter of the enclosing function (a dynamic name the
  catalog cannot see).

The registry's other direction (a row with no live site) is the round
trip test's: it sees the whole package.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from scenery_insitu_tpu_torch.tools.lint.core import (Diagnostic, SourceFile,
                                                      call_name,
                                                      enclosing_fn_of,
                                                      func_params,
                                                      iter_calls)

CODE = "SITPU-COUNTER"

_COUNTER_PARAM_SUFFIX = "_counter"


def _counter_params(fn) -> List[str]:
    return [p for p in func_params(fn)
            if p.endswith(_COUNTER_PARAM_SUFFIX)]


def _param_defaults(fn) -> List[Tuple[str, ast.expr]]:
    """(param_name, default_expr) pairs, positional and keyword-only."""
    a = fn.args
    out = []
    pos = a.posonlyargs + a.args
    for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        out.append((p.arg, d))
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            out.append((p.arg, d))
    return out


def discover_counters(sources) -> Dict[str, List[str]]:
    """Statically discovered counter names -> their sites. Three
    sources: literal ``.count("name")`` args, string defaults of
    ``*_counter`` parameters, and string literals passed to
    ``*_counter=`` keywords. Held equal to ``obs.counter_registry()``
    (both directions) by the round-trip test."""
    out: Dict[str, List[str]] = {}

    def add(name: str, src: SourceFile, line: int) -> None:
        out.setdefault(name, []).append(f"{src.path}:{line}")

    for src in sources:
        for c in iter_calls(src.tree):
            if call_name(c) == "count" and c.args:
                a = c.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value,
                                                              str):
                    add(a.value, src, c.lineno)
            for kw in c.keywords:
                if kw.arg and kw.arg.endswith(_COUNTER_PARAM_SUFFIX) \
                        and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    add(kw.value.value, src, c.lineno)
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for p, d in _param_defaults(node):
                    if p.endswith(_COUNTER_PARAM_SUFFIX) \
                            and isinstance(d, ast.Constant) \
                            and isinstance(d.value, str):
                        add(d.value, src, d.lineno)
    return out


def check(sources: List[SourceFile]) -> List[Diagnostic]:
    # imported here: the lint package itself imports no obs (nor torch)
    from scenery_insitu_tpu_torch.obs import counter_registry

    registry = counter_registry()
    diags: List[Diagnostic] = []
    discovered = discover_counters(sources)
    by_site: Dict[str, List[Tuple[str, int]]] = {}
    for name, sites in discovered.items():
        for s in sites:
            path, _, line = s.rpartition(":")
            by_site.setdefault(name, []).append((path, int(line)))
    for name in sorted(discovered):
        if name in registry:
            continue
        for path, line in by_site[name]:
            diags.append(Diagnostic(
                path, line, CODE,
                f"counter name {name!r} is not registered in "
                f"obs.counter_registry() — add it with a one-line "
                f"meaning (obs/recorder.py)",
                ""))
    # C2: dynamic name arguments
    for src in sources:
        for c in iter_calls(src.tree):
            if call_name(c) != "count" or not c.args:
                continue
            a = c.args[0]
            if isinstance(a, ast.Constant):
                # str literals are C1's job; non-str constants are not
                # Recorder calls (itertools.count(1))
                continue
            if not isinstance(a, ast.Name):
                continue          # attribute/expr: out of scope
            fn = enclosing_fn_of(src.tree, c)
            if fn is not None and a.id in _counter_params(fn):
                continue          # the *_counter-parameter pattern
            diags.append(Diagnostic(
                src.path, c.lineno, CODE,
                f"counter name is the dynamic variable {a.id!r} — "
                f"thread it through a '*_counter'-suffixed parameter "
                f"(with a registered string default) so the catalog "
                f"can see it",
                fn.name if fn is not None else "<module>"))
    return diags

"""SITPU-LEDGER: every fallback mints a ledger entry.

The contract (``obs/recorder.py``): every configured-but-degraded path
mints an ``obs.degrade(component, from, to, reason)`` entry, so a run
ends with a machine-readable list of everything that did not run as
configured. This checker finds the two shapes of silent degradation:

**R1, behaviour-changing except handlers.** An ``except`` handler that
returns an alternate result, swaps a value the ``try`` body also
assigns, talks to stdout/stderr/warnings instead of the ledger, or
absorbs a missing optional dependency (``ImportError``) must call
``obs.degrade`` on that path. Handlers that raise or exit are exempt
(the failure propagates), and so are probe predicates (``have_*``,
``*_available``, ``*_ok`` ... returning constants): the probe reports a
capability and its caller owns the fallback and its entry.

**R2, unledgered probe consultations.** A function that consults a
probe predicate of the scanned sources makes a capability-dependent
choice and must mint an entry on some path, unless the probe mints its
own, the function raises instead, or it is a probe itself.

Both rules are heuristics: a true positive that is fine belongs in
``baseline.json`` with a reason, or under an inline suppression.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from scenery_insitu_tpu_torch.tools.lint.core import (
    DEGRADE_WRAPPERS, Diagnostic, SourceFile, call_name, calls_degrade,
    enclosing_fn_of, iter_calls)

CODE = "SITPU-LEDGER"

# probe predicates: capability reporters whose callers own the fallback
PROBE_NAME_RE = re.compile(
    r"(^_?have_|probe|compile.*ok|_supported$|(^|_)available$|_ok$)")

_IMPORT_ERRORS = {"ImportError", "ModuleNotFoundError"}
_TALK_FUNCS = {"print", "warn", "warning", "error", "info", "debug",
               "print_exc"}


def _handler_exc_names(h: ast.ExceptHandler) -> Set[str]:
    t = h.type
    if t is None:
        return {"BaseException"}
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = set()
    for e in elts:
        if isinstance(e, ast.Attribute):
            out.add(e.attr)
        elif isinstance(e, ast.Name):
            out.add(e.id)
    return out


def _assigned_names(node: ast.AST) -> Set[str]:
    """Simple-Name assignment targets in ``node`` (incl. aug-assign and
    subscript/attribute roots: ``d[k] = ...`` counts as touching ``d``)."""
    out: Set[str] = set()
    for n in ast.walk(node):
        targets = []
        if isinstance(n, ast.Assign):
            targets = n.targets
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets = [n.target]
        for t in targets:
            for leaf in ast.walk(t):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
    return out


def _returns_only_constants(node: ast.AST) -> bool:
    rets = [n for n in ast.walk(node) if isinstance(n, ast.Return)]
    return all(r.value is None or isinstance(r.value, ast.Constant)
               for r in rets)


def _is_probe_predicate(fn) -> bool:
    return bool(PROBE_NAME_RE.search(fn.name))


def _talks(node: ast.AST) -> bool:
    return any(call_name(c) in _TALK_FUNCS for c in iter_calls(node))


def _check_handlers(src: SourceFile) -> List[Diagnostic]:
    diags = []
    tree = src.tree
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        try_assigned = _assigned_names(ast.Module(body=node.body,
                                                  type_ignores=[]))
        for h in node.handlers:
            body = ast.Module(body=h.body, type_ignores=[])
            if any(isinstance(n, ast.Raise) for n in ast.walk(body)):
                continue                      # propagates — not a fallback
            if any(call_name(c) in ("exit", "_exit", "abort")
                   for c in iter_calls(body)):
                continue                      # dies loudly — not a fallback
            if calls_degrade(body):
                continue                      # ledgered
            fn = enclosing_fn_of(tree, h)
            if fn is not None and _is_probe_predicate(fn) \
                    and _returns_only_constants(body):
                continue                      # probe predicate: caller owns it
            exc = _handler_exc_names(h)
            evidence = []
            if any(isinstance(n, ast.Return) for n in ast.walk(body)):
                evidence.append("returns an alternate result")
            if exc & _IMPORT_ERRORS:
                evidence.append("absorbs a missing optional dependency")
            if _talks(body):
                evidence.append("reports via stdout/warnings only")
            swapped = sorted(_assigned_names(body) & try_assigned)
            if swapped:
                evidence.append(f"swaps {', '.join(swapped)} assigned in "
                                f"the try body")
            if not evidence:
                continue                      # inert handler (cleanup etc.)
            sym = fn.name if fn is not None else "<module>"
            diags.append(Diagnostic(
                src.path, h.lineno, CODE,
                f"except {'/'.join(sorted(exc))} fallback "
                f"({'; '.join(evidence)}) never mints an obs.degrade "
                f"ledger entry", sym))
    return diags


def _functions_with_degrade(sources) -> Set[str]:
    out: Set[str] = set()
    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and calls_degrade(node):
                out.add(node.name)
    return out


def _check_probe_consumers(src: SourceFile,
                           degrading_fns: Set[str],
                           known_fns: Set[str]) -> List[Diagnostic]:
    diags = []
    for node in src.tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if _is_probe_predicate(node):
            continue                          # obligation stays downstream
        if calls_degrade(node):
            continue
        if any(isinstance(n, ast.Raise) for n in ast.walk(node)):
            continue                  # fails loudly instead of degrading
        for c in iter_calls(node):
            name = call_name(c)
            if not name or not PROBE_NAME_RE.search(name):
                continue
            if name in degrading_fns:
                continue                      # the probe ledgers itself
            if name not in known_fns:
                continue                      # external — out of scope
            diags.append(Diagnostic(
                src.path, c.lineno, CODE,
                f"consults feature probe {name}() (which does not ledger "
                f"internally) but mints no obs.degrade entry on any path",
                node.name))
    return diags


def check(sources: List[SourceFile]) -> List[Diagnostic]:
    degrading = _functions_with_degrade(sources)
    known: Set[str] = set()
    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                known.add(node.name)
    diags: List[Diagnostic] = []
    for src in sources:
        diags.extend(_check_handlers(src))
        diags.extend(_check_probe_consumers(src, degrading, known))
    return diags


# ------------------------------------------------- registry cross-validation

def discover_degrade_components(sources) -> Dict[str, List[str]]:
    """Statically discovered ledger components: every ``degrade(...)``
    call whose component argument is a string literal, mapped to its
    sites. The
    round-trip test holds this equal to ``obs.ledger_registry()``: a new
    degrade site registers its component, and a registry entry has a
    live site."""
    out: Dict[str, List[str]] = {}
    for src in sources:
        for c in iter_calls(src.tree):
            idx = DEGRADE_WRAPPERS.get(call_name(c))
            if idx is None or len(c.args) <= idx:
                continue
            a = c.args[idx]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                out.setdefault(a.value, []).append(f"{src.path}:{c.lineno}")
    return out

"""SITPU-THREAD: the CompositeConfig knobs thread through every
distributed step builder and the session.

A builder that drops a ``CompositeConfig`` knob (``exchange``, ``wire``,
``k_budget``, ``schedule``, ...) still renders: it quietly ignores the
configuration. The knob matrix is derived from ``config.py``'s
``CompositeConfig`` fields, minus the ones the composite itself consumes
(``max_output_supersegments``, ``adaptive``, ``adaptive_iters``,
``backend``, ``k_budget_min``), so a new field is enforced on every
builder until it is threaded (or baselined where it cannot apply).

Rules, per builder (top-level ``distributed_*step*`` / ``_build_mxu_step``
in ``parallel/pipeline.py``):

- every builder accepts and forwards ``topology`` (the
  ``TopologyConfig``: a builder that drops it composites flat on a
  two-level mesh);
- **whole-object builders** (a ``comp_cfg`` parameter) forward the
  object as a call argument somewhere in the body; rebuilding it
  (``dataclasses.replace`` or a ``CompositeConfig(...)`` with fields)
  there is flagged;
- **explicit-knob builders** (no ``comp_cfg``) accept every knob under
  its own name and forward it;
- **session plumbing** (``runtime/session.py``): every call of a builder
  binds ``topology`` and ``comp_cfg`` (whole-object) or each accepted
  knob by name (explicit-knob).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from scenery_insitu_tpu_torch.tools.lint.core import (Diagnostic, SourceFile,
                                                      func_params,
                                                      iter_calls)

CODE = "SITPU-THREAD"

BUILDER_RE = re.compile(r"^(distributed_.*step.*|_build_mxu_step)$")
COMPOSITE_CLASS = "CompositeConfig"
COMP_PARAM = "comp_cfg"
# the two-level plane: every distributed step builder accepts and
# forwards the TopologyConfig (its own config object, not a
# CompositeConfig field), and the session binds it at every builder call
TOPO_PARAM = "topology"

# consumed inside the composite itself (ops/composite.py), not threaded
# through builder signatures; every other CompositeConfig field is a knob
NON_THREADED_FIELDS = {"max_output_supersegments", "adaptive",
                       "adaptive_iters", "backend", "k_budget_min"}


def derive_knobs(config_src: SourceFile) -> List[str]:
    """CompositeConfig dataclass fields -> the threaded knob matrix."""
    for node in config_src.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == COMPOSITE_CLASS:
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            knobs = [f for f in fields if f not in NON_THREADED_FIELDS]
            if knobs:
                return knobs
            raise ValueError(
                f"{COMPOSITE_CLASS} in {config_src.path} has no threaded "
                f"knob fields — NON_THREADED_FIELDS is stale")
    raise ValueError(f"no {COMPOSITE_CLASS} dataclass in {config_src.path}")


def _name_used_as_call_arg(fn: ast.AST, name: str) -> bool:
    """Is ``name`` forwarded — a bare-Name argument (positional, keyword
    value, or *args) of any call inside ``fn`` (nested defs included)?"""
    for c in iter_calls(fn):
        for a in c.args:
            if isinstance(a, ast.Starred):
                a = a.value
            if isinstance(a, ast.Name) and a.id == name:
                return True
        for kw in c.keywords:
            if isinstance(kw.value, ast.Name) and kw.value.id == name:
                return True
    return False


def _builders(pipeline_src: SourceFile) -> List[ast.FunctionDef]:
    return [n for n in pipeline_src.tree.body
            if isinstance(n, ast.FunctionDef) and BUILDER_RE.match(n.name)]


def _check_builder(src: SourceFile, fn: ast.FunctionDef,
                   knobs: List[str]) -> List[Diagnostic]:
    diags = []
    params = func_params(fn)
    if TOPO_PARAM not in params:
        diags.append(Diagnostic(
            src.path, fn.lineno, CODE,
            f"does not accept '{TOPO_PARAM}' (TopologyConfig; every "
            f"distributed builder must thread the mesh topology)",
            fn.name))
    elif not _name_used_as_call_arg(fn, TOPO_PARAM):
        diags.append(Diagnostic(
            src.path, fn.lineno, CODE,
            f"accepts '{TOPO_PARAM}' but never consumes it — the "
            f"hierarchical composite is silently dropped", fn.name))
    if COMP_PARAM in params:
        if not _name_used_as_call_arg(fn, COMP_PARAM):
            diags.append(Diagnostic(
                src.path, fn.lineno, CODE,
                f"accepts {COMP_PARAM} but never forwards it — the whole "
                f"knob matrix ({', '.join(knobs)}) is dropped", fn.name))
        for c in iter_calls(fn):
            callee = c.func
            # a bare CompositeConfig() is the `comp_cfg or
            # CompositeConfig()` default fill — only a RE-construction
            # with explicit fields (or dataclasses.replace on the
            # threaded object) can drop knobs
            rebuilt = (isinstance(callee, ast.Name)
                       and callee.id == COMPOSITE_CLASS
                       and (c.args or c.keywords)) or \
                      (isinstance(callee, ast.Attribute)
                       and callee.attr == "replace"
                       and any(isinstance(a, ast.Name)
                               and a.id == COMP_PARAM for a in c.args))
            if rebuilt:
                diags.append(Diagnostic(
                    src.path, c.lineno, CODE,
                    f"rebuilds {COMPOSITE_CLASS} inside a whole-object "
                    f"builder — knobs not restated here are silently "
                    f"dropped; forward {COMP_PARAM} itself", fn.name))
        return diags
    for knob in knobs:
        if knob not in params:
            diags.append(Diagnostic(
                src.path, fn.lineno, CODE,
                f"does not accept knob '{knob}' "
                f"(CompositeConfig field; explicit-knob builder must take "
                f"the full matrix or baseline the gap)", fn.name))
        elif not _name_used_as_call_arg(fn, knob):
            diags.append(Diagnostic(
                src.path, fn.lineno, CODE,
                f"accepts knob '{knob}' but never forwards it",
                fn.name))
    return diags


def _param_index(fn: ast.FunctionDef, name: str) -> Optional[int]:
    a = fn.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    return pos.index(name) if name in pos else None


def _check_session_calls(session_src: SourceFile,
                         builders: Dict[str, ast.FunctionDef],
                         knobs: List[str],
                         pipeline_path: str) -> List[Diagnostic]:
    diags = []
    for c in iter_calls(session_src.tree):
        f = c.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", "")
        fn = builders.get(name)
        if fn is None:
            continue
        params = func_params(fn)
        kw_names = {k.arg for k in c.keywords if k.arg}
        has_doublestar = any(k.arg is None for k in c.keywords)
        if TOPO_PARAM in params:
            idx = _param_index(fn, TOPO_PARAM)
            bound = (TOPO_PARAM in kw_names or has_doublestar
                     or (idx is not None and len(c.args) > idx))
            if not bound:
                diags.append(Diagnostic(
                    session_src.path, c.lineno, CODE,
                    f"call to {name} does not bind '{TOPO_PARAM}' — the "
                    f"session must thread cfg.topology (a hierarchical "
                    f"mesh would silently composite flat)", "session"))
        if COMP_PARAM in params:
            idx = _param_index(fn, COMP_PARAM)
            bound = (COMP_PARAM in kw_names or has_doublestar
                     or (idx is not None and len(c.args) > idx))
            if not bound:
                diags.append(Diagnostic(
                    session_src.path, c.lineno, CODE,
                    f"call to {name} (defined {pipeline_path}) does not "
                    f"bind {COMP_PARAM} — the session must thread "
                    f"cfg.composite, not the builder default", "session"))
            continue
        for knob in knobs:
            if knob not in params:
                continue            # the builder-side rule owns that gap
            idx = _param_index(fn, knob)
            bound = (knob in kw_names or has_doublestar
                     or (idx is not None and len(c.args) > idx))
            if not bound:
                diags.append(Diagnostic(
                    session_src.path, c.lineno, CODE,
                    f"call to {name} does not forward knob '{knob}' "
                    f"(builder defaults mask cfg.composite.{knob})",
                    "session"))
    return diags


def check(sources: List[SourceFile],
          config_path: str = "scenery_insitu_tpu_torch/config.py",
          pipeline_path: str =
          "scenery_insitu_tpu_torch/parallel/pipeline.py",
          session_paths: tuple = (
              "scenery_insitu_tpu_torch/runtime/session.py",)
          ) -> List[Diagnostic]:
    by_path = {s.path: s for s in sources}
    config_src = by_path.get(config_path)
    pipeline_src = by_path.get(pipeline_path)
    if config_src is None or pipeline_src is None:
        return []            # custom path sets without the core files
    knobs = derive_knobs(config_src)
    diags: List[Diagnostic] = []
    builders = {}
    for fn in _builders(pipeline_src):
        builders[fn.name] = fn
        diags.extend(_check_builder(pipeline_src, fn, knobs))
    for sp in session_paths:
        if sp in by_path:
            diags.extend(_check_session_calls(by_path[sp], builders, knobs,
                                              pipeline_path))
    return diags

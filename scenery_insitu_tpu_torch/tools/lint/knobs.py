"""SITPU-KNOB: every march-path config knob appears in the LOD bench's
``KNOB_MATRIX``.

The LOD ladder (``benchmarks/lod_bench.py``) is the committed PSNR
against FLOPs against ms evidence for the multi-resolution march, and
its ``KNOB_MATRIX`` lists which march-path knobs that evidence covers
(swept, pinned, or argued irrelevant). A knob added to
``SliceMarchConfig`` or ``LODConfig`` without a matrix entry is a claim
the ladder silently stops covering; this makes that drift a finding on
the config field's own line.

1. collect the ``slicer.<field>`` / ``lod.<field>`` knob names of the
   annotated fields of ``SliceMarchConfig`` / ``LODConfig`` in the port's
   ``config.py`` (the names of the overrides grammar);
2. collect the string keys of the module-level ``KNOB_MATRIX`` dict
   literal of the port's ``benchmarks/lod_bench.py``;
3. flag config knobs missing from the matrix, and matrix keys that name
   no config knob.

When either file is outside the scan the checker emits nothing: the
invariant spans both. The port has no ``lod_bench.py`` twin yet, so on
the port it emits nothing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from scenery_insitu_tpu_torch.tools.lint.core import Diagnostic, SourceFile

CODE = "SITPU-KNOB"

CONFIG_PATH = "scenery_insitu_tpu_torch/config.py"
BENCH_PATH = "scenery_insitu_tpu_torch/benchmarks/lod_bench.py"

# config classes whose fields are march-path knobs, with the overrides
# prefix each is addressed by (config.py's dotted-override grammar)
_KNOB_CLASSES = {"SliceMarchConfig": "slicer", "LODConfig": "lod"}


def _config_knobs(src: SourceFile) -> Dict[str, Tuple[int, str]]:
    """``"slicer.fold" -> (lineno, "SliceMarchConfig")`` for every
    annotated field of the march-path config classes."""
    out: Dict[str, Tuple[int, str]] = {}
    for node in src.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        prefix = _KNOB_CLASSES.get(node.name)
        if prefix is None:
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and not stmt.target.id.startswith("_"):
                out[f"{prefix}.{stmt.target.id}"] = (stmt.lineno, node.name)
    return out


def _matrix_keys(src: SourceFile) -> Optional[Dict[str, int]]:
    """String keys (with lines) of the module-level KNOB_MATRIX dict
    literal; None when the bench has no parseable matrix (that absence
    is itself a finding — the coverage ledger is the contract)."""
    for node in src.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "KNOB_MATRIX":
                if not isinstance(value, ast.Dict):
                    return None
                return {k.value: k.lineno for k in value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
    return None


def check(sources: List[SourceFile]) -> List[Diagnostic]:
    cfg_src = next((s for s in sources if s.path == CONFIG_PATH), None)
    bench_src = next((s for s in sources if s.path == BENCH_PATH), None)
    if cfg_src is None or bench_src is None:
        return []
    knobs = _config_knobs(cfg_src)
    matrix = _matrix_keys(bench_src)
    if matrix is None:
        return [Diagnostic(
            bench_src.path, 1, CODE,
            "no module-level KNOB_MATRIX dict literal — the LOD bench "
            "must declare which march-path knobs its ladder covers")]
    diags: List[Diagnostic] = []
    for knob, (line, cls) in sorted(knobs.items()):
        if knob not in matrix:
            diags.append(Diagnostic(
                cfg_src.path, line, CODE,
                f"march-path knob `{knob}` has no {BENCH_PATH} "
                f"KNOB_MATRIX entry — the committed LOD ladder silently "
                f"stops covering it; add a coverage note (swept, pinned, "
                f"or why it cannot move the ladder)", cls))
    for key, line in sorted(matrix.items()):
        if key not in knobs:
            diags.append(Diagnostic(
                bench_src.path, line, CODE,
                f"KNOB_MATRIX key `{key}` names no SliceMarchConfig/"
                f"LODConfig field — stale coverage claim (knob renamed "
                f"or removed?)"))
    return diags

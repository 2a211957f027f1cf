"""SITPU-CUDA: the port's kernel contracts, checked at every
``kernels.launch`` site and every launch in a ``.cu`` source. The
counterpart of the reference's SITPU-PALLAS (its P1-P3 on Mosaic).

**P1, a plain version on the CPU only, no fallback.** Where the
reference wants a compile probe that degrades, the port's contract is
the reverse: a kernel that does not build or launch raises. A wrapper
that launches (a function calling ``kernels.launch``, with the
functions of its module that reach it) has a plain version in the same
module (a function named ``*plain*``) and runs it only under a test for
a ``"cpu"`` device (``if x.device.type == "cpu": return f_plain(...)``,
``ops/cuda_seg.py``'s pattern), never elsewhere; and no ``try`` holds a
``kernels.build``, ``kernels._library`` or ``kernels.launch``.

**P2, tile divisibility declared.** A grid of ``n / tile`` silently
leaves the last tile unwritten when the division floors. Every ``.cu``
launch's grid (its names resolved through their definitions in the
launching function) divides only as a ceiling, ``(n + tile - 1) /
tile``, or every wrapper that launches an entry of that file raises on
a ``%`` guard (``if h % TILE: raise``) before it launches.

**P3, dynamic shared memory above 48 KiB is opted into.** Hopper gives
a block more than 48 KiB of shared memory only as dynamic shared memory
after ``cudaFuncSetAttribute(fn,
cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)``; without it the
launch is refused. A launch whose dynamic size is not a constant of at
most 48 KiB calls that first, in the launching function or in a
function of the same file that it calls before the launch (the Hopper
resource rule where Mosaic's was the ``(1, 1)`` SMEM block).

Launches are ``kernel<<<grid, block, smem, stream>>>`` and
``cudaLaunchKernel(fn, grid, block, args, smem, stream)``. The ``.cu``
text is read with its comments and strings blanked; nothing is built.
"""

from __future__ import annotations

import ast
import bisect
import re
from typing import Dict, List, Optional, Set, Tuple

from scenery_insitu_tpu_torch.tools.lint.core import (Diagnostic, SourceFile,
                                                      call_name, dotted_name,
                                                      iter_calls)

CODE = "SITPU-CUDA"
SMEM_DEFAULT = 48 * 1024          # bytes a block has without the opt-in
_GUARDED = ("kernels.launch", "kernels.build", "kernels._library")
_OPT_IN = re.compile(r"cudaFuncSetAttribute\s*\([^;]*"
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize")
# a C entry (the port's convention: ``extern "C" int name(``), in text
# whose string literals are blanked
_ENTRY = re.compile(r'extern\s+"\s*"\s+(?:int|cudaError_t)\s+(\w+)\s*\(')


# ------------------------------------------------------------ Python side

def _top_fns(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _launch_calls(fn) -> List[ast.Call]:
    return [c for c in iter_calls(fn)
            if dotted_name(c.func).endswith("kernels.launch")]


def _callers(fns: Dict[str, ast.FunctionDef], name: str) -> Set[str]:
    """``name`` and every module function that reaches it by calls."""
    reach = {name}
    grew = True
    while grew:
        grew = False
        for f, node in fns.items():
            if f not in reach and any(call_name(c) in reach
                                      for c in iter_calls(node)):
                reach.add(f)
                grew = True
    return reach


def _is_plain(name: str) -> bool:
    return "plain" in name


def _cpu_test(test: ast.AST) -> bool:
    """``... == "cpu"`` somewhere in an ``if`` test."""
    return any(isinstance(n, ast.Compare)
               and any(isinstance(o, ast.Eq) for o in n.ops)
               and any(isinstance(e, ast.Constant) and e.value == "cpu"
                       for e in [n.left] + n.comparators)
               for n in ast.walk(test))


def _cpu_branches(fn) -> List[ast.If]:
    return [n for n in ast.walk(fn)
            if isinstance(n, ast.If) and _cpu_test(n.test)]


def _in_body(node: ast.AST, branches: List[ast.If]) -> bool:
    return any(node in set(ast.walk(ast.Module(body=b.body,
                                               type_ignores=[])))
               for b in branches)


def _has_mod_guard(fn) -> bool:
    """An ``if`` on a ``%`` that raises, or an ``assert`` on a ``%``."""
    def has_mod(e):
        return any(isinstance(n, ast.Mod) for n in ast.walk(e))

    for n in ast.walk(fn):
        if isinstance(n, ast.If) and has_mod(n.test) \
                and any(isinstance(b, ast.Raise) for b in ast.walk(n)):
            return True
        if isinstance(n, ast.Assert) and has_mod(n.test):
            return True
    return False


def _entries(fns, fn, call: ast.Call) -> Set[str]:
    """The C entry names a ``kernels.launch`` call can launch: its
    literal first argument, or the literals passed for that parameter
    by the module's callers of ``fn``."""
    if not call.args:
        return set()
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return {a.value}
    if not isinstance(a, ast.Name):
        return set()
    params = [p.arg for p in fn.args.posonlyargs + fn.args.args]
    if a.id not in params:
        return set()
    i = params.index(a.id)
    out = set()
    for node in fns.values():
        for c in iter_calls(node):
            if call_name(c) == fn.name and len(c.args) > i \
                    and isinstance(c.args[i], ast.Constant):
                out.add(c.args[i].value)
    return out


def _python_sites(src: SourceFile, diags: List[Diagnostic]
                  ) -> List[Tuple[Set[str], bool]]:
    """P1 on one module; returns (entries, guarded by %) per launching
    function, for P2."""
    fns = _top_fns(src.tree)
    out = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Try) and any(
                dotted_name(c.func).endswith(_GUARDED)
                for c in iter_calls(ast.Module(body=node.body,
                                               type_ignores=[]))):
            fn = next((f for f in fns.values()
                       if f.lineno <= node.lineno <= f.end_lineno), None)
            diags.append(Diagnostic(
                src.path, node.lineno, CODE,
                "P1: a try holds a kernel build or launch: a kernel that "
                "does not build or launch must raise, not fall back",
                fn.name if fn else "<module>"))
    plain = [f for f in fns if _is_plain(f)]
    for name, fn in fns.items():
        calls = _launch_calls(fn)
        if not calls:
            continue
        wrappers = [fns[w] for w in sorted(_callers(fns, name))]
        if not plain:
            diags.append(Diagnostic(
                src.path, calls[0].lineno, CODE,
                f"P1: {name}() launches a kernel but {src.path} has no "
                f"plain version (a *plain* function) beside it", name))
        elif not any(any(call_name(c) in plain or _is_plain(call_name(c))
                         for b in _cpu_branches(w)
                         for c in iter_calls(ast.Module(
                             body=b.body, type_ignores=[])))
                     for w in wrappers):
            diags.append(Diagnostic(
                src.path, calls[0].lineno, CODE,
                f"P1: {name}() launches a kernel and nothing on its way "
                f"runs the plain version for a CPU tensor (if "
                f"x.device.type == \"cpu\": return ..._plain(...))", name))
        for w in wrappers:
            branches = _cpu_branches(w)
            for c in iter_calls(w):
                if _is_plain(call_name(c)) and not _in_body(c, branches):
                    diags.append(Diagnostic(
                        src.path, c.lineno, CODE,
                        f"P1: {w.name}() runs the plain version "
                        f"{call_name(c)}() off the CPU branch: a CUDA "
                        f"tensor launches the kernel or raises", w.name))
        for call in calls:
            out.append((_entries(fns, fn, call),
                        any(_has_mod_guard(w) for w in wrappers)))
    return out


# -------------------------------------------------------------- CUDA side

def _blank(text: str) -> str:
    """Comments as spaces, string and char literals as their quotes
    around spaces (newlines kept, offsets unchanged)."""
    pat = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"'
                     r"|'(?:\\.|[^'\\\n])*'", re.S)

    def sub(m):
        s = m.group(0)
        if s[0] in "\"'":
            return s[0] + re.sub(r"[^\n]", " ", s[1:-1]) + s[-1]
        return re.sub(r"[^\n]", " ", s)

    return pat.sub(sub, text)


class _Fn:
    def __init__(self, name: str, start: int, end: int):
        self.name, self.start, self.end = name, start, end


def _functions(code: str) -> List[_Fn]:
    """The outermost brace blocks that are not ``namespace`` or
    ``extern "C"`` blocks (function bodies), each with the name before
    its parameter list."""
    out, stack, last = [], [], 0
    for i, ch in enumerate(code):
        if ch == "{":
            head = code[last:i]
            if re.search(r'(\bnamespace\b[\w\s:]*|\bextern\s+"\s*"\s*)$',
                         head):
                kind = "ns"
            elif any(k == "fn" for _, k, _ in stack):
                kind = "block"
            else:
                kind = "fn"
            stack.append((i, kind, head))
            last = i + 1
        elif ch == "}":
            if stack:
                start, kind, head = stack.pop()
                if kind == "fn":
                    out.append(_Fn(_name_of(head), start, i))
            last = i + 1
        elif ch == ";":
            last = i + 1
    return out


def _name_of(head: str) -> str:
    prev = None
    while prev != head:
        prev, head = head, re.sub(r"\([^()]*\)", "()", head)
    names = [n for n in re.findall(r"(\w+)\s*\(\)", head)
             if n != "__launch_bounds__"]
    return names[-1] if names else ""


def _split_args(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        depth += ch in "([{"
        depth -= ch in ")]}"
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur).strip())
    return out


def _closing(code: str, open_at: int) -> int:
    depth = 0
    for i in range(open_at, len(code)):
        depth += code[i] == "("
        depth -= code[i] == ")"
        if depth == 0:
            return i
    return len(code)


def _launches(code: str) -> List[Tuple[int, str, Optional[str]]]:
    """(offset, grid, dynamic shared bytes or None) of every launch."""
    out = []
    for m in re.finditer(r"<<<(.*?)>>>", code, re.S):
        args = _split_args(m.group(1))
        out.append((m.start(), args[0], args[2] if len(args) > 2 else None))
    for m in re.finditer(r"\bcudaLaunchKernel\s*\(", code):
        open_at = m.end() - 1
        # fn, grid, block, args, smem, stream
        args = _split_args(code[open_at + 1:_closing(code, open_at)])
        if len(args) > 4:
            out.append((m.start(), args[1], args[4]))
    return out


def _resolve(expr: str, before: str, depth: int = 4) -> str:
    """``expr`` with each name replaced by its last definition in
    ``before`` (``name = ...;`` or ``dim3 name(...);``), recursively."""
    if depth == 0:
        return expr

    def sub(m):
        name = m.group(0)
        defs = [d.group(1) for d in re.finditer(
            rf"(?<![\w.])\b{name}\s*=\s*([^;=][^;]*);", before)]
        defs += [d.group(1) for d in re.finditer(
            rf"\bdim3\s+{name}\s*\(([^;]*)\)\s*;", before)]
        if not defs:
            return name
        return "(" + _resolve(defs[-1], before, depth - 1) + ")"

    return re.sub(r"(?<![\w.])[A-Za-z_]\w*", sub, expr)


def _floors(expr: str) -> bool:
    """A ``/`` in ``expr`` whose dividend is not ``(... - 1)``."""
    for i, ch in enumerate(expr):
        if ch != "/":
            continue
        left = expr[:i].rstrip()
        if not left.endswith(")"):
            return True
        depth, j = 0, len(left) - 1
        while j >= 0:
            depth += left[j] == ")"
            depth -= left[j] == "("
            if depth == 0:
                break
            j -= 1
        if not re.search(r"-\s*1\s*$", left[j + 1:-1]):
            return True
    return False


def _const_bytes(expr: str) -> Optional[int]:
    e = re.sub(r"sizeof\s*\(\s*(float|int|unsigned|uint32_t|int32_t)\s*\)",
               "4", expr)
    e = re.sub(r"(\d+)[uUlL]+\b", r"\1", e)
    if not re.fullmatch(r"[\d\s*+()-]+", e):
        return None
    return int(eval(e, {"__builtins__": {}}))      # digits and + - * ( )


def _cuda_file(src: SourceFile, guarded: Dict[str, bool],
               diags: List[Diagnostic]) -> None:
    code = _blank(src.text)
    fns = _functions(code)
    by_name = {f.name: f for f in fns}
    entries = set(_ENTRY.findall(code))
    starts = [0] + [m.end() for m in re.finditer(r"\n", code)]

    def line(off):
        return bisect.bisect_right(starts, off)

    for off, grid, smem in _launches(code):
        fn = next((f for f in fns if f.start <= off <= f.end), None)
        if fn is None:
            continue
        before = code[fn.start:off]
        g = _resolve(grid, before)
        mine = [guarded[e] for e in entries if e in guarded]
        if _floors(g) and not (mine and all(mine)):
            diags.append(Diagnostic(
                src.path, line(off), CODE,
                f"P2: the grid {' '.join(grid.split())} floors a division "
                f"and no wrapper of {sorted(entries) or 'its entries'} "
                f"raises on a % guard: the last tile would go unwritten",
                fn.name))
        if smem is None:
            continue
        size = _const_bytes(_resolve(smem, before))
        if size is not None and size <= SMEM_DEFAULT:
            continue
        helpers = [by_name[n] for n in re.findall(r"\b(\w+)\s*\(", before)
                   if n in by_name and n != fn.name]
        if _OPT_IN.search(before) or any(
                _OPT_IN.search(code[h.start:h.end]) for h in helpers):
            continue
        diags.append(Diagnostic(
            src.path, line(off), CODE,
            f"P3: dynamic shared memory {' '.join(smem.split())} can exceed "
            f"48 KiB but no cudaFuncSetAttribute(..., "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, ...) precedes "
            f"the launch: Hopper refuses it", fn.name))


def check(sources: List[SourceFile]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    guarded: Dict[str, bool] = {}
    for src in sources:
        if src.is_cuda:
            continue
        for entries, ok in _python_sites(src, diags):
            for e in entries:
                guarded[e] = guarded.get(e, True) and ok
    for src in sources:
        if src.is_cuda:
            _cuda_file(src, guarded, diags)
    return diags

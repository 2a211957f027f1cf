"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, into
``build/torch_kernels/`` at the repository root (listed in
``.gitignore``). The library name carries a hash of the source and the
flags, so an edited source is never served a stale build. `build`
starts one ``nvcc`` per missing library and waits for all of them, so
the kernels compile in parallel.

The libraries are loaded with ``ctypes``: every pointer and the stream
are passed as ``c_void_p``, every int as ``c_int`` and every float as
``c_float``; every C entry returns ``cudaGetLastError()`` and `launch`
raises when it is not 0. Nothing here falls back: a kernel
that does not build or does not launch raises.

Every wrapper calls `launch`, which adds one to the kernel's launch
count and the bytes the wrapper says the launch moves (`operand_bytes`:
each operand read once, each output written once) to its byte count;
`reset_launches` and `launches` let a run show that its main path went
through the kernels, and `launched_bytes` lets a cost count see the
bytes of launches that bypass PyTorch's dispatch. `register_library` serves a library built
from a source outside ``csrc/`` (the lint fixture's kernel) the same way.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

# -fmad=false: the kernels repeat their plain versions' arithmetic
# operation for operation (the K2 counts must match exactly, and the
# stencil and fold stay within an ulp-level tolerance); contracting a
# multiply and an add into one FMA would round differently
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (library, argtypes); each returns cudaError_t
ENTRIES = {
    # rgba, length, thr, sk0, sk1, color, depth, small, C, K, H, W, stream
    "seg_fold_compact": ("seg_fold", [_P] * 8 + [_I] * 4 + [_P]),
    # rgba, t0, t1, thr, color, depth, small, C, K, H, W, stream
    "seg_fold_planes": ("seg_fold", [_P] * 7 + [_I] * 4 + [_P]),
    # rgba, t0, t1, thr, color, depth, small, count (or NULL), C, K, H, W,
    # gap_eps, stream
    "fold_chunk": ("fold_chunk", [_P] * 8 + [_I] * 4 + [_F, _P]),
    # rgba, t0, t1, thr, color, depth, small, C, K, H, W, stream
    "events_fold_chunk": ("fold_chunk", [_P] * 7 + [_I] * 4 + [_P]),
    # as events_fold_chunk with the threads per block after W
    "scratch_fold_chunk": ("fold_chunk", [_P] * 7 + [_I] * 5 + [_P]),
    # val, length, ratio, thr, sk0, sk1, knots, color, depth, small, C, K,
    # H, W, stream
    "fused_fold_chunk": ("fused_fold", [_P] * 10 + [_I] * 4 + [_P]),
    # as fused_fold_chunk with S, chunk in place of C
    "fused_stream_fold": ("fused_fold", [_P] * 10 + [_I] * 5 + [_P]),
    # rgba, tvec, count, prev, fe, C, B, H, W, stream
    "count_multi": ("count_multi", [_P] * 5 + [_I] * 4 + [_P]),
    # u, v, params, u_out, v_out, D, H, W, T, stream
    "grayscott_fused": ("stencil", [_P] * 5 + [_I] * 4 + [_P]),
    # u, v, params, u_out, v_out, lo, hi, D, H, W, T, nzb, nyb, stream
    "grayscott_fused_ranges": ("stencil", [_P] * 7 + [_I] * 6 + [_P]),
    # sc, sd, thr, color, depth, thr_out (or NULL), NK, K_out, H, W,
    # iters, gap_eps, thr_max, stream
    "resegment_sorted": ("resegment", [_P] * 6 + [_I] * 5 + [_F] * 2
                         + [_P]),
}
LIBRARIES = tuple(sorted({lib for lib, _ in ENTRIES.values()}))
# C functions that launch nothing: name -> (library, argtypes); each
# returns cudaError_t and writes its answer through its last pointer
QUERIES = {
    # which (0 B7, 1 B8, 2 B9), C, K, out int[3]: registers, local-memory
    # bytes, the largest block
    "fold_chunk_attributes": ("fold_chunk", [_I] * 3 + [_P]),
    # which (0 B7, 1 B8, 2 B9), C, K, B9's threads a block, out int[6]:
    # registers, local-memory bytes, shared bytes a block, resident blocks
    # an SM, threads a block, close events a thread holds
    "fold_chunk_occupancy": ("fold_chunk", [_I] * 4 + [_P]),
    # T, ranges (0 K3, 1 B4b), out int[8]: registers, local-memory bytes,
    # shared bytes a block, resident blocks an SM, threads a block, the
    # core's x and y extent, the z segment's planes
    "stencil_attributes": ("stencil", [_I] * 2 + [_P]),
    # C (16, 1, or any other for the generic build), planes (0 K1, 1
    # B1b), out int[6]: registers, local-memory bytes, shared bytes a
    # block, resident blocks an SM, threads a block, slices held at once
    "seg_fold_attributes": ("seg_fold", [_I] * 2 + [_P]),
    # C (16, 1, or any other for the generic build; B5 and B6 share it),
    # out int[6]: registers, local-memory bytes, shared bytes a block,
    # resident blocks an SM, threads a block, slices a stage holds
    "fused_fold_attributes": ("fused_fold", [_I, _P]),
    # NK, K_out, iters, out int[7]: registers, local-memory bytes, shared
    # bytes a block, resident blocks an SM, threads a block, the search
    # list's entries, 1 where the list lives in registers
    "resegment_attributes": ("resegment", [_I] * 3 + [_P]),
    # C (16, 1, or any other for the generic build), B, out int[6]:
    # registers, local-memory bytes, shared bytes a block, resident blocks
    # an SM, threads a block, slices whose loads go out together
    "count_multi_attributes": ("count_multi", [_I] * 2 + [_P]),
}

_LAUNCHES: collections.Counter = collections.Counter()
_BYTES: collections.Counter = collections.Counter()
_LOADED: Dict[str, ctypes.CDLL] = {}   # by source path
_SOURCES: Dict[str, str] = {}          # `source_override`'s sources
_REGISTERED: Dict[str, str] = {}       # `register_library`'s sources


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH); the port's kernels are "
                           "built from csrc/ with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source_path(name: str) -> str:
    """The CUDA source library ``name`` is built from: ``csrc/<name>.cu``
    unless `source_override` serves another."""
    return _SOURCES.get(name) or _REGISTERED.get(
        name, os.path.join(CSRC_DIR, f"{name}.cu"))


def register_library(name: str, source: str, entries) -> None:
    """Serve library ``name`` from the CUDA source at ``source`` (a file
    outside ``csrc/``) with the C entries ``entries`` (name -> argtypes,
    the stream last, as in `ENTRIES`): hashed and built with `NVCC_FLAGS`
    at first use, launched through `launch` and counted in `launches`
    like the package's own. Registering builds nothing."""
    clash = [e for e in entries if ENTRIES.get(e, (name,))[0] != name]
    if name in LIBRARIES or clash:
        raise ValueError(f"library {name!r} or entries {clash} are the "
                         f"package's own")
    _REGISTERED[name] = os.path.abspath(source)
    for entry, argtypes in entries.items():
        ENTRIES[entry] = (name, list(argtypes))


@contextlib.contextmanager
def source_override(name: str, path: str):
    """Within the block, build and load library ``name`` from the source
    at ``path`` (another design of ``csrc/<name>.cu`` with the same C
    entries), so that the same wrappers launch it and count its launches:
    how two designs are timed against each other in one process."""
    _SOURCES[name] = os.path.abspath(path)
    try:
        yield
    finally:
        del _SOURCES[name]


def library_path(name: str) -> str:
    src = source_path(name)
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library of ``names`` (default: all) with one
    ``nvcc`` each, all started together. Returns the wall seconds; raises
    with the compiler's output when any build fails."""
    names = LIBRARIES if names is None else tuple(names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(n)]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {source_path(n)} "
                          f"(exit {p.returncode}):\n{log.decode()}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def _library(name: str) -> ctypes.CDLL:
    src = source_path(name)
    lib = _LOADED.get(src)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        for entry, (owner, argtypes) in {**ENTRIES, **QUERIES}.items():
            # an overriding source may predate a query; calling it raises
            if owner == name and (entry in ENTRIES or hasattr(lib, entry)):
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LOADED[src] = lib
    return lib


def operand_bytes(reads=(), writes=()) -> int:
    """The bytes a launch moves: each tensor of ``reads`` read once and
    each of ``writes`` written once (a state updated in place is in
    both); None entries are skipped."""
    return sum(t.numel() * t.element_size()
               for t in (*reads, *writes) if t is not None)


def launch(entry: str, *args, nbytes: int = 0) -> None:
    """Call C entry ``entry`` on PyTorch's current stream and count the
    launch and its ``nbytes`` (`operand_bytes`); raises when the launch
    was refused."""
    import torch

    owner = ENTRIES[entry][0]
    fn = getattr(_library(owner), entry)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError {err}")
    _LAUNCHES[entry] += 1
    _BYTES[entry] += nbytes


def query(name: str, *args, nout: int) -> tuple:
    """Call the query ``name`` of `QUERIES` (no launch, nothing counted)
    with ``args`` and an int[nout] it fills; raises when it fails."""
    owner = QUERIES[name][0]
    out = (ctypes.c_int * nout)()
    err = getattr(_library(owner), name)(*args, out)
    if err != 0:
        raise RuntimeError(f"{name}{args} failed: cudaError {err}")
    return tuple(out)


def check_operands(want, anchor: str) -> None:
    """Raise unless every operand of ``want`` (name -> (tensor, shape,
    dtype)) lies on the device of operand ``anchor``, has its dtype and
    shape, and is contiguous: what a kernel's C entry assumes."""
    dev = want[anchor][0].device
    for name, (t, shape, dtype) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {anchor} on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def reset_launches() -> None:
    _LAUNCHES.clear()
    _BYTES.clear()


def launches() -> Dict[str, int]:
    """Launch count of every C entry since the last `reset_launches`."""
    return {name: _LAUNCHES[name] for name in ENTRIES}


def launched_bytes() -> int:
    """The bytes every counted launch moved since the last
    `reset_launches` (what each wrapper passed as ``nbytes``)."""
    return sum(_BYTES.values())

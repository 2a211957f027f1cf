"""SITPU-CUDA good fixture, and the port of B10 (the Pallas lint
fixture's kernel, ``tests/lint_fixtures/good_pallas.py``'s
``double_chunk``): ``2 x`` of ``f32[H, W]`` and each 8-row tile's max
into ``f32[H/8, 1]``.

The wrapper guards ``H % 8`` before it launches, runs its plain version
only for a CPU tensor, and launches ``good_double.cu`` (built with the
port's ``nvcc`` flags at first use, its launches counted) on a CUDA
tensor. Checked by the lint and imported by the tests and
``chip_smoke.py``.
"""

import ctypes
import os

import torch

from scenery_insitu_tpu_torch import kernels

TILE_H = 8
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "good_double.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, y, m, h, w, stream
kernels.register_library("good_double", SOURCE,
                         {"double_chunk": [_P] * 3 + [_I] * 2 + [_P]})


def double_chunk(x: torch.Tensor):
    """(2 x, each 8-row tile's max as ``[H/8, 1]``) of ``x f32[H, W]``,
    H a multiple of 8. NaN propagates into a tile's max."""
    h, w = x.shape
    if h % TILE_H:
        raise ValueError(f"height {h} not a multiple of {TILE_H}")
    kernels.check_operands({"x": (x, (h, w), torch.float32)}, "x")
    if x.device.type == "cpu":
        return double_chunk_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = torch.empty_like(x)
    m = torch.empty((h // TILE_H, 1), dtype=torch.float32, device=x.device)
    kernels.launch("double_chunk", x.data_ptr(), y.data_ptr(), m.data_ptr(),
                   h, w)
    return y, m


def double_chunk_plain(x: torch.Tensor):
    """Plain version of B10: ``x * 2`` and ``amax`` over each tile's
    rows."""
    h, _ = x.shape
    return x * 2.0, x.view(h // TILE_H, -1).amax(1, keepdim=True)

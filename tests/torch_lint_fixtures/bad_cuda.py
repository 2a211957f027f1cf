"""SITPU-CUDA bad fixture: ``double_chunk`` with no tile-divisibility
guard and a ``try`` that returns the plain version when the launch
fails. Parsed by the linter only, never imported or built."""

import ctypes
import os

import torch

from scenery_insitu_tpu_torch import kernels

TILE_H = 8
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "bad_double.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
kernels.register_library("bad_double", SOURCE, {
    "bad_double_chunk": [_P] * 3 + [_I] * 2 + [_P],
    "bad_double_chunk_staged": [_P] * 3 + [_I] * 2 + [_P]})


def double_chunk(x: torch.Tensor, staged: bool = False):
    # no % guard: a height that is not a multiple of TILE_H floors the grid
    h, w = x.shape
    if x.device.type == "cpu":
        return double_chunk_plain(x)
    y = torch.empty_like(x)
    m = torch.empty((h // TILE_H, 1), dtype=torch.float32, device=x.device)
    entry = "bad_double_chunk_staged" if staged else "bad_double_chunk"
    try:
        kernels.launch(entry, x.data_ptr(), y.data_ptr(), m.data_ptr(), h, w)
    except RuntimeError:
        # a launch the card refused (the staged build's shared memory)
        # silently becomes the plain version
        return double_chunk_plain(x)
    return y, m


def double_chunk_plain(x: torch.Tensor):
    h, _ = x.shape
    return x * 2.0, x.view(h // TILE_H, -1).amax(1, keepdim=True)

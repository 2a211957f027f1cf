"""Carry state between the JAX reference package and this port.

The reference's values arrive as numpy arrays (``np.asarray`` of each
field) or dicts of them; these functions build the port's tensors on a
given device. `to_numpy` is the reverse for any port value: a tensor, a
NamedTuple of tensors, or a dict/list/tuple of them. Nothing here
imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.ops.delta import DeltaRecord, ReuseState
from scenery_insitu_tpu_torch.ops.occupancy import FieldRanges
from scenery_insitu_tpu_torch.ops.slicer import AxisCamera, AxisSpec
from scenery_insitu_tpu_torch.ops.supersegments import ThresholdState
from scenery_insitu_tpu_torch.sim.grayscott import GrayScott, GrayScottParams
from scenery_insitu_tpu_torch.sim.particles import (CellSpec, LJParams,
                                                    ParticleState, SHOParams)
from scenery_insitu_tpu_torch.sim.vortex import VortexFlow, VortexParams


def _fields(value, names):
    """Field values by name from a mapping, a NamedTuple-like object or a
    sequence in field order."""
    if isinstance(value, Mapping):
        return [value[n] for n in names]
    if all(hasattr(value, n) for n in names):
        return [getattr(value, n) for n in names]
    return list(value)


def _tensor(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype), device=dev)


def gray_scott(u, v, params, device=None) -> GrayScott:
    """``params``: f, k, du, dv, dt (mapping, NamedTuple or sequence)."""
    dev = resolve_device(device)
    p = GrayScottParams(*(_tensor(x, np.float32, dev) for x in
                          _fields(params, GrayScottParams._fields)))
    return GrayScott(_tensor(u, np.float32, dev),
                     _tensor(v, np.float32, dev), p)


def vortex_params(params, device=None) -> VortexParams:
    """``params``: viscosity, dt."""
    dev = resolve_device(device)
    return VortexParams(*(_tensor(x, np.float32, dev) for x in
                          _fields(params, VortexParams._fields)))


def vortex_flow(u, params, device=None) -> VortexFlow:
    """The velocity ``u f32[3, D, H, W]`` (voxel units) and its params."""
    dev = resolve_device(device)
    return VortexFlow(_tensor(u, np.float32, dev),
                      vortex_params(params, dev))


def tracers(pos, device=None) -> torch.Tensor:
    """Tracer positions ``f32[N, 3]`` in voxel coordinates (x, y, z)."""
    return _tensor(pos, np.float32, resolve_device(device))


def particle_state(state, device=None) -> ParticleState:
    """``pos, vel f32[N, 3]`` and the box side ``box f32[]``."""
    dev = resolve_device(device)
    return ParticleState(*(_tensor(x, np.float32, dev) for x in
                           _fields(state, ParticleState._fields)))


def sho_params(params, device=None) -> SHOParams:
    """``params``: omega2, dt."""
    dev = resolve_device(device)
    return SHOParams(*(_tensor(x, np.float32, dev) for x in
                       _fields(params, SHOParams._fields)))


def lj_params(params, device=None) -> LJParams:
    """``params``: epsilon, sigma, cutoff, dt."""
    dev = resolve_device(device)
    return LJParams(*(_tensor(x, np.float32, dev) for x in
                      _fields(params, LJParams._fields)))


def cell_spec(spec) -> CellSpec:
    """The static cell-list geometry (host ints)."""
    return CellSpec(*(int(x) for x in _fields(spec, CellSpec._fields)))


def transfer_function(tf, device=None) -> TransferFunction:
    """The knot form: alpha_x, alpha_m, alpha_b, color_x, color_m,
    color_b."""
    dev = resolve_device(device)
    return TransferFunction(*(_tensor(x, np.float32, dev) for x in
                              _fields(tf, TransferFunction._fields)))


def threshold_state(state, device=None) -> ThresholdState:
    """thr, lo, hi f32[H, W]; for the distributed temporal step, the
    rank-stacked maps f32[n*nj, ni] (rank r's rows r*nj:(r+1)*nj)."""
    dev = resolve_device(device)
    return ThresholdState(*(_tensor(x, np.float32, dev) for x in
                            _fields(state, ThresholdState._fields)))


def field_ranges(ranges, device=None) -> FieldRanges:
    """Per-brick value ranges ``lo, hi f32[nzb, nyb]`` (the reference's
    ``occupancy.FieldRanges``)."""
    dev = resolve_device(device)
    return FieldRanges(*(_tensor(x, np.float32, dev) for x in
                         _fields(ranges, FieldRanges._fields)))


def vdi(value, device=None) -> VDI:
    """color f32[K,4,H,W], depth f32[K,2,H,W]; a distributed step's VDI
    is the global one, every rank's column block side by side (what the
    reference's W-sharded output holds)."""
    dev = resolve_device(device)
    return VDI(*(_tensor(x, np.float32, dev) for x in
                 _fields(value, VDI._fields)))


def packed_state(packed, device=None):
    """A reference fold's packed state triple ``(color f32[K,4,H,W],
    depth f32[K,2,H,W], small f32[R,H,W])`` as port tensors: the seg
    fold's (``pallas_seg.init_seg_packed``, R = 5) or the machine's
    (``pallas_march.init_packed``, R = 12). Raises on another layout."""
    dev = resolve_device(device)
    color, depth, small = (_tensor(x, np.float32, dev) for x in packed)
    k, _, h, w = color.shape
    if tuple(depth.shape) != (k, 2, h, w) or small.dim() != 3 \
            or small.shape[0] not in (5, 12) \
            or tuple(small.shape[1:]) != (h, w):
        raise ValueError(f"not a packed fold state: color "
                         f"{tuple(color.shape)}, depth {tuple(depth.shape)}"
                         f", small {tuple(small.shape)} (5 or 12 rows)")
    return color, depth, small


def reuse_state(state, device=None) -> ReuseState:
    """The rank-stacked fragment reuse carry: ``sig f32[n*S]``, ``color
    f32[n*K, 4, H, W]`` and ``depth f32[n*K, 2, H, W]`` on ``device``;
    ``valid`` and ``dirty i32[n]`` on the host, where the port's step
    decides."""
    dev = resolve_device(device)
    sig, color, depth, valid, dirty = _fields(state, ReuseState._fields)
    return ReuseState(_tensor(sig, np.float32, dev),
                      _tensor(color, np.float32, dev),
                      _tensor(depth, np.float32, dev),
                      _tensor(valid, np.int32, "cpu"),
                      _tensor(dirty, np.int32, "cpu"))


def delta_record(rec) -> DeltaRecord:
    """A P-frame codec record (the reference's ``ops/delta.DeltaRecord``,
    numpy payloads) as the port's; the payload arrays are copied."""
    vals = dict(zip(DeltaRecord._fields,
                    _fields(rec, DeltaRecord._fields)))
    for k in ("c_payload", "d_payload"):
        vals[k] = tuple(np.array(x) for x in vals[k])
    for k in ("gen", "base_gen", "full_bytes", "wire_bytes"):
        vals[k] = int(vals[k])
    vals["scale"] = tuple(float(x) for x in vals["scale"])
    return DeltaRecord(**vals)


def axis_spec(spec) -> AxisSpec:
    """The static slice-march spec, field by field (a host value)."""
    names = [f.name for f in dataclasses.fields(AxisSpec)]
    return AxisSpec(**dict(zip(names, _fields(spec, names))))


def axis_camera(axcam, device=None) -> AxisCamera:
    """The virtual axis camera: eye_uvw, view, proj, u_grid, v_grid, zp,
    w0, dwm, far (f32)."""
    dev = resolve_device(device)
    return AxisCamera(*(_tensor(x, np.float32, dev) for x in
                        _fields(axcam, AxisCamera._fields)))


_META_DTYPES = {"window_dims": np.int32, "index": np.int32,
                "precision": np.int32}


def vdi_metadata(meta, device=None) -> VDIMetadata:
    """The 8 fields of ``VDIMetadata``; integer fields stay int32."""
    dev = resolve_device(device)
    vals = _fields(meta, VDIMetadata._fields)
    return VDIMetadata(*(_tensor(x, _META_DTYPES.get(n, np.float32), dev)
                         for n, x in zip(VDIMetadata._fields, vals)))


def to_numpy(value: Any):
    """Port value -> numpy: tensors become arrays (bf16 as f32),
    NamedTuples keep their type with numpy fields, and dicts, lists and
    tuples are converted element by element."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_numpy(x) for x in value))
    if isinstance(value, Mapping):
        return {k: to_numpy(x) for k, x in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_numpy(x) for x in value)
    return value

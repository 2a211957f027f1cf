"""Configuration dataclasses of the frame and the distributed frame.

The port's own copy of the reference's ``config.py`` classes that the
frames read: same field names, defaults and validation messages. Of the
sort-last exchange settings only the ``all_to_all`` exchange, the
``f32`` wire and the ``frame`` schedule are accepted; the others are a
later slice of the port (ROADMAP queue A8b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# The in-plane occupancy tile count the pyramid mode asks for.
OCCUPANCY_VTILES_DEFAULT = 16


@dataclass(frozen=True)
class VDIConfig:
    """Supersegment (VDI) generation settings."""

    max_supersegments: int = 20     # K
    # fixed color-difference threshold for closing a supersegment (used
    # when adaptive is False)
    threshold: float = 0.0
    adaptive: bool = True
    adaptive_iters: int = 6         # binary search iterations ("search")
    adaptive_delta: float = 0.15    # accept counts in [K*(1-delta), K]
    # "search": adaptive_iters counting marches; "histogram": one counting
    # march over histogram_bins candidate thresholds; "temporal": the
    # threshold is carried across frames and nudged from the write
    # march's own segment count.
    adaptive_mode: str = "search"
    histogram_bins: int = 16
    temporal_track: float = 0.9
    thr_min: float = 1e-3
    thr_max: float = 2.0

    def __post_init__(self):
        if self.adaptive_mode not in ("search", "histogram", "temporal"):
            raise ValueError(
                f"adaptive_mode must be 'search', 'histogram' or "
                f"'temporal', got {self.adaptive_mode!r}")
    occupancy_cell: int = 8


@dataclass(frozen=True)
class SliceMarchConfig:
    """Slice-march raycaster settings (ops/slicer.py)."""

    engine: str = "auto"
    # intermediate grid resolution multiplier over the in-plane voxel count
    scale: float = 1.25
    # slices folded per chunk
    chunk: int = 16
    # resampling matmul operand dtype; this port resamples in f32 (bf16 is
    # ROADMAP queue A1), so make_spec resolves "bf16" to "f32" as the
    # reference does off the TPU
    matmul_dtype: str = "bf16"
    # storage dtype of the marched volume copy
    render_dtype: str = "f32"
    # minimum eye-depth ratio; slices closer to the eye plane are dropped
    s_floor: float = 1e-3
    # skip slice chunks whose value range maps to zero alpha
    skip_empty: bool = True
    # in-plane occupancy tiles: -1 resolves to 0 (chunk-level skipping)
    occupancy_vtiles: int = -1
    # Supersegment-fold schedule for the VDI marches (the reference's
    # names; the kernels are ops/cuda_*.py):
    #   "xla"          sequential supersegments.push machine, state
    #                  round-tripped per slice (the reference schedule);
    #   "pallas"       the same machine in kernel B7 (ops/cuda_march.py),
    #                  the temporal count riding along;
    #   "seg"          segmented-scan fold (ops/seg_fold.py): start flags,
    #                  segment ids and transmittance data-parallel, [K]
    #                  state touched once per chunk;
    #   "pallas_seg"   the seg fold in kernel K1 (ops/cuda_seg.py);
    #   "pallas_fused" shade-in-kernel: the TF, opacity correction and
    #                  depths move into the fold, kernel B5
    #                  (ops/cuda_fused.py), fed the raw value planes;
    #   "fused_stream" the whole-march fused fold: the value planes of
    #                  every chunk gathered into one f32[S, Nj, Ni] buffer,
    #                  then one launch of kernel B6;
    #   "auto"         pallas_seg on CUDA, xla on the CPU.
    fold: str = "auto"

    def __post_init__(self):
        if self.matmul_dtype not in ("bf16", "f32"):
            raise ValueError(f"matmul_dtype must be 'bf16' or 'f32', "
                             f"got {self.matmul_dtype!r}")
        if self.render_dtype not in ("bf16", "f32"):
            raise ValueError(f"render_dtype must be 'bf16' or 'f32', "
                             f"got {self.render_dtype!r}")


@dataclass(frozen=True)
class CompositeConfig:
    """Sort-last VDI compositing."""

    max_output_supersegments: int = 20
    adaptive: bool = True
    adaptive_iters: int = 6
    # merge-fold schedule: "xla" (the sequential machine over the slots),
    # "pallas" (the fused resegment, kernel K4 in ops/cuda_composite.py;
    # its plain version on a CPU tensor) or "auto" (K4 on a CUDA tensor,
    # "xla" on the CPU)
    backend: str = "auto"
    exchange: str = "all_to_all"
    wire: str = "f32"
    schedule: str = "frame"

    def __post_init__(self):
        if self.exchange not in ("all_to_all", "ring"):
            raise ValueError(f"exchange must be 'all_to_all' or 'ring', "
                             f"got {self.exchange!r}")
        if self.wire not in ("f32", "bf16", "qpack8"):
            raise ValueError(f"wire must be 'f32', 'bf16' or 'qpack8', "
                             f"got {self.wire!r}")
        if self.schedule not in ("frame", "waves"):
            raise ValueError(f"schedule must be 'frame' or 'waves', "
                             f"got {self.schedule!r}")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"backend must be 'auto', 'xla' or 'pallas', "
                             f"got {self.backend!r}")
        ported = (("exchange", "all_to_all"), ("wire", "f32"),
                  ("schedule", "frame"))
        for name, value in ported:
            if getattr(self, name) != value:
                raise ValueError(
                    f"{name}={getattr(self, name)!r} is a distributed "
                    f"composite setting this port does not run yet "
                    f"(ROADMAP queue A8b); the ported value is {value!r}")


@dataclass(frozen=True)
class SimConfig:
    """Built-in simulation settings."""

    kind: str = "gray_scott"
    grid: Tuple[int, int, int] = (128, 128, 128)
    steps_per_frame: int = 10
    dt: float = 1.0
    gs_f: float = 0.037
    gs_k: float = 0.060
    gs_du: float = 0.16
    gs_dv: float = 0.08
    num_particles: int = 100_000
    particle_radius: float = 0.35
    fused_stencil: bool = True

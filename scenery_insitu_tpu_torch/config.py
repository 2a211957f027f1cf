"""Configuration: one tree of frozen dataclasses, overridable from
environment variables, a JSON file or ``section.key=value`` strings.

The port's own copy of the reference's ``config.py``: the same sections,
field names, defaults, validation messages and parser, so one JSON file
configures either package. A value the port cannot run yet still parses
and raises where it is used, naming its ROADMAP row.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

ENV_PREFIX = "SITPU_"

# The in-plane occupancy tile count the pyramid mode asks for.
OCCUPANCY_VTILES_DEFAULT = 16


@dataclass(frozen=True)
class RenderConfig:
    """Plain raycast / framebuffer settings; the session reads the width
    and height for its frame metadata."""

    width: int = 1280
    height: int = 720
    max_steps: int = 512           # samples along each ray
    step_scale: float = 1.0        # multiplies the nominal 1-voxel step
    gamma: float = 2.2             # display gamma applied at host boundary
    background: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    early_exit_alpha: float = 0.999
    ao_strength: float = 0.0       # ambient occlusion; 0 disables
    ao_radius: int = 4             # occlusion neighborhood radius, voxels


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
    # resampling matmul operand dtype: make_spec resolves "bf16" to bf16
    # on a CUDA device (f32 accumulation) and to "f32" on the CPU, as the
    # reference does on and off the TPU
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
    # sort-last exchange: "all_to_all" (every rank receives its column
    # block of every fragment, then sorts N·K slots) or "ring" (n-1 hops,
    # each arriving fragment merged into a sorted accumulator); one rank
    # takes the all_to_all path
    exchange: str = "all_to_all"
    # ring accumulator cap, slots per pixel (0 = lossless; > 0 drops the
    # farthest segments of overfull pixels at every merge)
    ring_slots: int = 0
    # supersegment wire format of the exchange (ops/wire.py): "f32"
    # (24 B a slot, exact), "bf16" (12 B) or "qpack8" (6 B); the merge
    # and resegment run in f32
    wire: str = "f32"
    # frame schedule: "frame" (one march, one exchange, one composite) or
    # "waves" (each rank marches one column-block wave at a time and
    # every wave is exchanged and composited; one rank degrades to
    # "frame" on the ledger)
    schedule: str = "frame"
    wave_tiles: int = 4            # column-block waves per rank
    # per-rank supersegment budget: "static" or "occupancy" (A8b)
    k_budget: str = "static"
    k_budget_min: int = 4
    # render decomposition: "even" z-slabs, or "occupancy" bands and
    # "bricks" maps re-planned every rebalance_period frames from the
    # field's live profile (parallel/pipeline.py, the session's replan)
    rebalance: str = "even"
    # temporal fragment reuse: "off" or "ranges" (A8b)
    temporal_reuse: str = "off"
    rebalance_period: int = 8
    rebalance_hysteresis: float = 0.25
    rebalance_min_depth: int = 4
    rebalance_quantum: int = 4
    rebalance_bricks: int = 0      # 0 = auto
    rebalance_max_moves: int = 2

    def __post_init__(self):
        if self.exchange not in ("all_to_all", "ring"):
            raise ValueError(f"exchange must be 'all_to_all' or 'ring', "
                             f"got {self.exchange!r}")
        if self.ring_slots < 0:
            raise ValueError(f"ring_slots must be >= 0 (0 = lossless), "
                             f"got {self.ring_slots}")
        if self.wire not in ("f32", "bf16", "qpack8"):
            raise ValueError(f"wire must be 'f32', 'bf16' or 'qpack8', "
                             f"got {self.wire!r}")
        if self.schedule not in ("frame", "waves"):
            raise ValueError(f"schedule must be 'frame' or 'waves', "
                             f"got {self.schedule!r}")
        if self.wave_tiles < 1:
            raise ValueError(f"wave_tiles must be >= 1, "
                             f"got {self.wave_tiles}")
        if self.k_budget not in ("static", "occupancy"):
            raise ValueError(f"k_budget must be 'static' or 'occupancy', "
                             f"got {self.k_budget!r}")
        if self.k_budget_min < 1:
            raise ValueError(f"k_budget_min must be >= 1, "
                             f"got {self.k_budget_min}")
        if self.rebalance not in ("even", "occupancy", "bricks"):
            raise ValueError(f"rebalance must be 'even', 'occupancy' or "
                             f"'bricks', got {self.rebalance!r}")
        if self.temporal_reuse not in ("off", "ranges"):
            raise ValueError(f"temporal_reuse must be 'off' or 'ranges', "
                             f"got {self.temporal_reuse!r}")
        if self.rebalance_period < 1:
            raise ValueError(f"rebalance_period must be >= 1, "
                             f"got {self.rebalance_period}")
        if self.rebalance_hysteresis < 0.0:
            raise ValueError(f"rebalance_hysteresis must be >= 0, "
                             f"got {self.rebalance_hysteresis}")
        if self.rebalance_min_depth < 1:
            raise ValueError(f"rebalance_min_depth must be >= 1, "
                             f"got {self.rebalance_min_depth}")
        if self.rebalance_quantum < 1:
            raise ValueError(f"rebalance_quantum must be >= 1, "
                             f"got {self.rebalance_quantum}")
        if self.rebalance_bricks < 0:
            raise ValueError(f"rebalance_bricks must be >= 0 (0 = auto), "
                             f"got {self.rebalance_bricks}")
        if self.rebalance_max_moves < 1:
            raise ValueError(f"rebalance_max_moves must be >= 1, "
                             f"got {self.rebalance_max_moves}")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"backend must be 'auto', 'xla' or 'pallas', "
                             f"got {self.backend!r}")


@dataclass(frozen=True)
class LODConfig:
    """Multi-resolution brick marching on the brick render decomposition:
    the session's brick replan also picks a level a brick
    (``parallel/lod.select_levels``); without ``composite.rebalance =
    "bricks"`` it is inert, on the ledger."""

    enabled: bool = False
    max_level: int = 2
    error_px: float = 1.0
    coarsen_empty: bool = True
    live_eps: float = 1e-3
    tf_edge_eps: float = 1e-4
    hysteresis: float = 0.2

    def __post_init__(self):
        if not 0 <= self.max_level <= 8:
            raise ValueError(f"max_level must be in [0, 8], "
                             f"got {self.max_level}")
        if self.error_px <= 0.0:
            raise ValueError(f"error_px must be > 0, "
                             f"got {self.error_px}")
        if self.live_eps < 0.0:
            raise ValueError(f"live_eps must be >= 0, "
                             f"got {self.live_eps}")
        if self.tf_edge_eps < 0.0:
            raise ValueError(f"tf_edge_eps must be >= 0, "
                             f"got {self.tf_edge_eps}")
        if not 0.0 <= self.hysteresis < 1.0:
            raise ValueError(f"hysteresis must be in [0, 1), "
                             f"got {self.hysteresis}")


@dataclass(frozen=True)
class TopologyConfig:
    """Mesh topology. ``num_hosts == 1`` is the flat mesh; more hosts
    build the two-level ``(hosts, ranks)`` mesh of ``num_hosts`` domains
    of ``domain_size`` ranks (``parallel/topology.py``), whose composite
    crosses domains on the ``dcn_wire`` codec (``parallel/hier.py``)."""

    domain_size: int = 0           # devices per domain; 0 = auto
    num_hosts: int = 1
    hosts_axis: str = "hosts"
    dcn_wire: str = "f32"

    def __post_init__(self):
        if self.domain_size < 0:
            raise ValueError(f"domain_size must be >= 0 (0 = auto), "
                             f"got {self.domain_size}")
        if self.num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, "
                             f"got {self.num_hosts}")
        if not self.hosts_axis:
            raise ValueError("hosts_axis must be a non-empty axis name")
        if self.dcn_wire not in ("f32", "bf16", "qpack8"):
            raise ValueError(f"dcn_wire must be 'f32', 'bf16' or "
                             f"'qpack8', got {self.dcn_wire!r}")


@dataclass(frozen=True)
class MeshConfig:
    """The rank mesh. The port's ranks run in-process on one device
    (``parallel/mesh.py``): ``num_devices`` is the rank count, 0 meaning
    one rank."""

    num_devices: int = 0
    axis_name: str = "ranks"


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


@dataclass(frozen=True)
class RuntimeConfig:
    """Session-loop, dump and benchmark flags."""

    generate_vdis: bool = True     # False: plain images
    save_final: bool = False
    dump_dir: str = "dumps"
    benchmark: bool = False
    benchmark_frames: int = 100
    stats_window: int = 100         # frames between timer-stat dumps
    dataset: str = "procedural"
    # frames rolled into one launch (0/1 = eager per-frame dispatch; more
    # is ROADMAP A3/A7)
    scan_frames: int = 0
    # device->host pipeline depth of the session loop: how many
    # dispatched frames may have their host copies in flight before the
    # loop waits on the oldest
    pipeline_depth: int = 1

    def __post_init__(self):
        if self.pipeline_depth < 1:
            raise ValueError(f"runtime.pipeline_depth must be >= 1, "
                             f"got {self.pipeline_depth}")


@dataclass(frozen=True)
class ObsConfig:
    """Observability: structured spans, counters and the fallback ledger
    (``obs/``). Disabled, the recorder only feeds the per-phase timers."""

    enabled: bool = False
    trace_path: str = ""           # Chrome-trace JSON ("" = don't write)
    metrics_path: str = ""         # JSONL events + summary ("" = don't)
    window: int = 0                # timer window; 0 = runtime.stats_window
    # fleet telemetry side-channel endpoints (obs/collector.py)
    collector: str = ""
    collector_hb: str = ""
    collector_interval_s: float = 0.25

    def __post_init__(self):
        if self.collector_interval_s <= 0:
            raise ValueError(f"collector_interval_s must be > 0, "
                             f"got {self.collector_interval_s}")


@dataclass(frozen=True)
class SLOConfig:
    """Live service-level objectives (``obs/slo.py``): rolling p50/p99
    estimators checked on the run; a budget of 0 disables its gate."""

    enabled: bool = False
    window: int = 128
    min_samples: int = 16
    frame_p99_ms: float = 0.0
    staleness_p99_frames: float = 0.0
    camera_to_pixel_p99_ms: float = 0.0
    phase_p99_ms: float = 0.0
    delivery_lag_p99_ms: float = 0.0

    def __post_init__(self):
        if self.window < 8:
            raise ValueError(f"slo.window must be >= 8, got {self.window}")
        if self.min_samples < 1 or self.min_samples > self.window:
            raise ValueError(f"need 1 <= min_samples <= window, got "
                             f"{self.min_samples} (window {self.window})")
        for k in ("frame_p99_ms", "staleness_p99_frames",
                  "camera_to_pixel_p99_ms", "phase_p99_ms",
                  "delivery_lag_p99_ms"):
            if getattr(self, k) < 0:
                raise ValueError(f"slo.{k} must be >= 0 (0 = no gate), "
                                 f"got {getattr(self, k)}")


@dataclass(frozen=True)
class FaultConfig:
    """Failure-isolation knobs; the session reads ``max_sink_failures``
    (``runtime/failsafe.SinkGuard``), the stream endpoints the rest
    (``runtime/streaming.py``, ``serve/``)."""

    heartbeat_period_s: float = 2.0
    liveness_timeout_s: float = 10.0
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 30.0
    max_sink_failures: int = 3
    assembler_window: int = 4
    max_message_bytes: int = 1 << 20

    def __post_init__(self):
        if self.heartbeat_period_s <= 0:
            raise ValueError(f"heartbeat_period_s must be > 0, "
                             f"got {self.heartbeat_period_s}")
        if self.backoff_base_s <= 0 or self.backoff_cap_s < self.backoff_base_s:
            raise ValueError(
                f"need 0 < backoff_base_s <= backoff_cap_s, got "
                f"{self.backoff_base_s}, {self.backoff_cap_s}")
        if self.max_sink_failures < 1:
            raise ValueError(f"max_sink_failures must be >= 1, "
                             f"got {self.max_sink_failures}")
        if self.assembler_window < 1:
            raise ValueError(f"assembler_window must be >= 1, "
                             f"got {self.assembler_window}")
        if self.max_message_bytes < 1024:
            raise ValueError(f"max_message_bytes must be >= 1024, "
                             f"got {self.max_message_bytes}")


@dataclass(frozen=True)
class DeltaConfig:
    """Temporal-delta plane: the P-frame wire codec and the reuse
    tolerance (ROADMAP A8b item 6)."""

    enabled: bool = False
    iframe_period: int = 8
    range_tol: float = 0.0

    def __post_init__(self):
        if self.iframe_period < 1:
            raise ValueError(f"iframe_period must be >= 1, "
                             f"got {self.iframe_period}")
        if self.range_tol < 0.0:
            raise ValueError(f"range_tol must be >= 0, "
                             f"got {self.range_tol}")


@dataclass(frozen=True)
class DeliveryConfig:
    """Asynchronous delivery plane (``runtime/delivery.py``): with
    ``enabled`` a background worker runs the sinks off the loop thread,
    draining a bounded FIFO whose ``overflow`` policy is ``block``
    (lossless) or ``drop_oldest`` (latest wins, ledgered)."""

    enabled: bool = False
    queue_frames: int = 4
    overflow: str = "block"
    encode_workers: int = 1
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        if self.queue_frames < 1:
            raise ValueError(f"delivery.queue_frames must be >= 1, "
                             f"got {self.queue_frames}")
        if self.overflow not in ("block", "drop_oldest"):
            raise ValueError(f"delivery.overflow must be 'block' or "
                             f"'drop_oldest', got {self.overflow!r}")
        if self.encode_workers < 1:
            raise ValueError(f"delivery.encode_workers must be >= 1, "
                             f"got {self.encode_workers}")
        if self.drain_timeout_s <= 0:
            raise ValueError(f"delivery.drain_timeout_s must be > 0, "
                             f"got {self.drain_timeout_s}")


@dataclass(frozen=True)
class ServeConfig:
    """VDI edge-serving tier (``serve/``)."""

    bind: str = "tcp://*:6657"
    connect: str = "tcp://localhost:6655"
    max_viewers: int = 64
    queue_cap: int = 64
    batch_size: int = 16
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)
    staleness_frames: int = 4
    default_tier: str = "proxy"
    cam_tol: float = 1e-6
    width: int = 128
    height: int = 96
    num_slices: int = 0
    march_scale: float = 1.0
    client_timeout_s: float = 10.0
    supervise_stream: bool = False

    def __post_init__(self):
        if self.max_viewers < 1:
            raise ValueError(f"max_viewers must be >= 1, "
                             f"got {self.max_viewers}")
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, "
                             f"got {self.batch_size}")
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be a strictly ascending ladder, "
                             f"got {self.buckets}")
        if self.staleness_frames < 0:
            raise ValueError(f"staleness_frames must be >= 0, "
                             f"got {self.staleness_frames}")
        if self.default_tier not in ("exact", "proxy", "wire"):
            raise ValueError(f"default_tier must be 'exact', 'proxy' or "
                             f"'wire', got {self.default_tier!r}")
        if self.cam_tol < 0.0:
            raise ValueError(f"cam_tol must be >= 0, got {self.cam_tol}")
        if self.width < 8 or self.height < 8:
            raise ValueError(f"served size must be >= 8x8, "
                             f"got {self.width}x{self.height}")
        if self.num_slices < 0:
            raise ValueError(f"num_slices must be >= 0 (0 = heuristic), "
                             f"got {self.num_slices}")
        if self.march_scale <= 0.0:
            raise ValueError(f"march_scale must be > 0, "
                             f"got {self.march_scale}")
        if self.client_timeout_s <= 0:
            raise ValueError(f"client_timeout_s must be > 0, "
                             f"got {self.client_timeout_s}")


@dataclass(frozen=True)
class StreamConfig:
    """Steering / streaming endpoints (``runtime/streaming.py``)."""

    steer_bind: str = "tcp://*:6655"
    steer_connect: str = "tcp://localhost:6655"
    video_port: int = 3337
    compress: str = "zstd"          # zstd | zlib | lzma | none (io.vdi_io)


@dataclass(frozen=True)
class FrameworkConfig:
    render: RenderConfig = field(default_factory=RenderConfig)
    slicer: SliceMarchConfig = field(default_factory=SliceMarchConfig)
    vdi: VDIConfig = field(default_factory=VDIConfig)
    composite: CompositeConfig = field(default_factory=CompositeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    fault: FaultConfig = field(default_factory=FaultConfig)
    delta: DeltaConfig = field(default_factory=DeltaConfig)
    delivery: DeliveryConfig = field(default_factory=DeliveryConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    lod: LODConfig = field(default_factory=LODConfig)

    # ------------------------------------------------------------------ IO
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "FrameworkConfig":
        return _merge_into(cls(), d)

    @classmethod
    def from_json_file(cls, path: str) -> "FrameworkConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def with_overrides(self, *assignments: str) -> "FrameworkConfig":
        """Apply ``section.key=value`` strings, e.g. ``render.width=512``."""
        cfg = self
        for a in assignments:
            key, _, raw = a.partition("=")
            if not _:
                raise ValueError(f"override must look like section.key=value: {a!r}")
            cfg = _assign(cfg, key.strip().split("."), _parse_value(raw.strip()))
        return cfg

    @classmethod
    def load(cls, path: Optional[str] = None,
             overrides: Tuple[str, ...] = ()) -> "FrameworkConfig":
        """File < env (SITPU_SECTION_KEY=value) < explicit overrides."""
        cfg = cls.from_json_file(path) if path else cls()
        for name, raw in os.environ.items():
            if not name.startswith(ENV_PREFIX):
                continue
            parts = name[len(ENV_PREFIX):].lower().split("_", 1)
            if len(parts) != 2 or not hasattr(cfg, parts[0]):
                # not a config section: other SITPU_* variables (e.g.
                # SITPU_BENCH_*) share the prefix
                continue
            if tuple(parts) in _REMOVED_KEYS:
                from scenery_insitu_tpu_torch import obs
                obs.degrade("config.removed_key", name, "ignored",
                            _REMOVED_KEYS[tuple(parts)])
                continue
            try:
                cfg = _assign(cfg, parts, _parse_value(raw))
            except (ValueError, AttributeError) as e:
                raise ValueError(
                    f"bad config override {name}={raw!r}: {e}") from e
        return cfg.with_overrides(*overrides)


# removed config keys -> deprecation note (accepted-and-warned, not fatal)
_REMOVED_KEYS = {
    ("mesh", "decomposition"): "decomposition is 1-D over z; multi-grid "
                               "layouts go through core.scene.MultiGridScene",
}


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def _assign(cfg: Any, path: list, value: Any) -> Any:
    head = path[0]
    if not hasattr(cfg, head):
        raise AttributeError(f"no config field {head!r} on {type(cfg).__name__}")
    if len(path) == 1:
        current = getattr(cfg, head)
        if current is not None and not isinstance(value, type(current)):
            if isinstance(current, tuple):
                value = tuple(value)
            elif isinstance(current, float) and isinstance(value, int):
                value = float(value)
            elif isinstance(current, bool) and isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
            elif isinstance(current, (int, float)) and isinstance(value, str):
                value = type(current)(value)
        return dataclasses.replace(cfg, **{head: value})
    return dataclasses.replace(cfg, **{head: _assign(getattr(cfg, head), path[1:], value)})


def _merge_into(cfg: Any, d: dict) -> Any:
    updates = {}
    for k, v in d.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"no config field {k!r} on {type(cfg).__name__}")
        current = getattr(cfg, k)
        if dataclasses.is_dataclass(current) and isinstance(v, dict):
            updates[k] = _merge_into(current, v)
        elif isinstance(current, tuple) and isinstance(v, list):
            updates[k] = tuple(v)
        else:
            updates[k] = v
    return dataclasses.replace(cfg, **updates)


def check_brick_count(cc: CompositeConfig, depth: int) -> None:
    """Reject at session build a ``composite.rebalance_bricks`` that does
    not divide the volume depth: impossible geometry fails here, not at
    the first replan, and the message names the knob."""
    if cc.rebalance == "bricks" and cc.rebalance_bricks \
            and int(depth) % cc.rebalance_bricks:
        raise ValueError(
            f"composite.rebalance_bricks={cc.rebalance_bricks} does not "
            f"divide the volume depth {int(depth)} (use 0 for auto, or a "
            f"divisor)")

"""The in-situ session loop: per-frame orchestration of sim advance, VDI
generation, device-to-host delivery and sinks.

The port of the reference's ``runtime/session.py``. Each frame advances
the sim, dispatches the distributed step over the session's in-process
rank mesh (``parallel/pipeline.py``; one rank is the single-card frame),
and hands the result to the sinks. The volume sims (``sim.kind``
``gray_scott`` or ``vortex``) render in four modes, as the reference's
(``slicer.engine``, where "auto" is the slice march on every device, and
``runtime.generate_vdis``):

- VDIs on the slice march (``mxu``): the step of the camera's march
  regime, built once a regime, with its carried thresholds and reuse;
- VDIs on the gather engine: one ``distributed_vdi_step`` at the
  render width, height and ``max_steps``, no regime, no carried state
  (``vdi.adaptive_mode`` "search" or "histogram");
- plain images on the slice march: the regime's
  ``distributed_plain_step_mxu`` and the homography warp to the display
  camera, which blends ``render.background``;
- plain images on the gather engine: one ``distributed_plain_step``.

Two more modes follow from the sim, as in the reference:

- ``particles`` (``sim.kind`` ``lennard_jones`` or ``sho``): the
  sort-first sphere render of ``parallel/particles.
  distributed_particle_step`` at the render width and height, the
  particles sharded over the ranks (a hierarchical topology is inert
  there and goes on the ledger);
- ``hybrid`` (``sim.kind`` ``hybrid``: the vortex flow and its tracers):
  the regime's ``distributed_hybrid_step_mxu`` on the slice march, with
  carried thresholds under ``adaptive_mode="temporal"`` keyed
  ``("hybrid", axis, sign)``, warped to the display camera.

A VDI payload is ``{"vdi_color", "vdi_depth", "frame", "meta"}``, a
plain or hybrid one ``{"image", "frame", "meta"}``, a particle one
``{"image", "depth", "frame", "meta"}``: the PNG sink writes the image
as it is, the VDI sinks pass it by, the checkpoint sink saves the
session as in any mode. The loop
keeps ``runtime.pipeline_depth`` frames in flight: a frame's VDI is
copied into pinned host buffers on a side stream as soon as it is
dispatched, and the frame retires (fetch, sinks, device tensors dropped)
once ``pipeline_depth`` newer frames are in flight. Per-phase spans
(sim, dispatch, fetch, sinks) feed the recorder's timers and the SLO
engine.

Runs standalone with a built-in sim, or with a caller's volume sim
adapter (anything with ``kind``, ``advance(n)`` and ``.field``).

Steering: ``steer_session`` applies one message of the steering protocol
(``runtime/streaming.py``): a ``camera`` message moves the camera, any
other goes to the ``on_steer`` callbacks behind the sink guard. A ``tf``
message swaps the transfer function; the steps built for the outgoing
TF are kept under its identity (``_tf_fingerprint``), and a TF seen
before restores its steps instead of rebuilding them (``_tf_invalidate``;
the ``tf_updates`` and ``tf_steps_reused`` counters). The scenario zoo
(``scenarios/``) drives this consumer in-process; a viewer's messages
reach it through ``sess.steering`` (a ``runtime/streaming.
SteeringEndpoint``), drained at the top of every frame.

Observability (``obs/``): with ``obs.collector`` set the session builds
an ``obs.collector.ObsPublisher`` and pumps it after every frame (and,
forced, at the end of a run and on its crash path); ``run(profile_dir=
...)`` runs the loop under ``torch.profiler`` and writes its Chrome
trace into that directory; ``device_snapshot()`` is the per-regime cost
snapshot of the steps the session holds (``obs/device.py``).

Frame blocks in one launch (``runtime.scan_frames > 1``) are a later
slice of the port and raise ``NotImplementedError`` naming their
ROADMAP row (A3/A7).

``composite.k_budget="occupancy"`` re-targets every rank's adaptive
threshold in the steps themselves. ``composite.temporal_reuse="ranges"``
makes each regime's step carry its ranks' last marched fragments
(``ops/delta.ReuseState``, seeded by ``distributed_initial_reuse_mxu``)
beside the temporal thresholds; a rank whose occupancy ranges and
camera did not move marches nothing. The carry is dropped when the
camera re-enters a regime and when the steps rebuild (a new plan), and
with ``obs.enabled`` each frame counts the previous frame's skipped
marches (``delta_march_skipped``, ``delta_dirty_tiles``) from the carry
it receives, which is already on the host. A brick map carries no
fragment (the step ledgers ``delta.reuse``).

A hierarchical ``topology`` (``num_hosts > 1``) builds the two-level
``(hosts, ranks)`` mesh of ``mesh.num_devices`` ranks
(``parallel/topology.make_topology_mesh``) and every step composites in
two levels (``parallel/hier.py``); ``_n_ranks`` is the total rank
count, which the checkpoint records.

With ``composite.rebalance`` ``"occupancy"`` or ``"bricks"`` the session
re-plans the render decomposition every ``rebalance_period`` frames,
before the frame's sim advance, from the live profile of every rank's
even slab: a band plan (``ops/occupancy.slice_plan``) or a brick map
stolen toward balance (``parallel/bricks.steal_plan``), with
``lod.enabled`` also a level a brick (``parallel/lod.select_levels``).
A plan, owners or levels that change rebuild the steps (and re-seed the
thresholds), and nothing else does; one rank (without LOD) ledgers the
knob inert, as ``lod.enabled`` does without bricks.

The composite's exchange, wire and schedule come from
``cfg.composite`` (``parallel/pipeline.py``). With
``composite.schedule="waves"`` every fetched VDI frame is also cut into
its ``n_ranks * wave_tiles`` column-block tiles, and each tile payload
goes to ``tile_sinks`` in ascending column order before the frame's own
sinks run (through the delivery worker when ``delivery.enabled``).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import (FrameworkConfig,
                                             check_brick_count)
from scenery_insitu_tpu_torch.core.camera import (Camera, orbit,
                                                  projection_matrix,
                                                  view_matrix)
from scenery_insitu_tpu_torch.core.transfer import (TransferFunction,
                                                    for_dataset)
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.ops import slicer as _slicer
from scenery_insitu_tpu_torch.ops.splat import SplatOutput
from scenery_insitu_tpu_torch.parallel import multihost
from scenery_insitu_tpu_torch.parallel.mesh import Mesh, shard_volume
from scenery_insitu_tpu_torch.parallel.particles import shard_particles
from scenery_insitu_tpu_torch.parallel.topology import (
    make_topology_mesh, resolve_mesh_topology)
from scenery_insitu_tpu_torch.runtime.failsafe import SinkGuard
from scenery_insitu_tpu_torch.sim import grayscott as gs
from scenery_insitu_tpu_torch.sim import particles as pt
from scenery_insitu_tpu_torch.sim import vortex as vx

Sink = Callable[[int, dict], None]

_PARTICLE_SIMS = ("lennard_jones", "sho")


def _unported(what: str, row: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {row})")


def check_ported(cfg: FrameworkConfig) -> None:
    """Raise for a configuration the port's session cannot run yet,
    naming the ROADMAP row that ports it."""
    if cfg.runtime.scan_frames > 1:
        _unported(f"runtime.scan_frames={cfg.runtime.scan_frames} (frame "
                  "blocks in one launch)", "A3/A7: a CUDA graph after A3")
    _slicer.resolve_engine(cfg.slicer.engine)


def steer_session(sess, msg: dict) -> None:
    """Apply ONE steering-protocol message to ``sess``: a camera update
    in place, any other kind to the ``on_steer`` callbacks. The socket
    drain (`drain_steering`) and the scenario zoo's in-process hooks
    route through this same consumer.

    The callbacks run behind the session's SinkGuard: an exception in
    one must not kill the run — a callback failing
    ``fault.max_sink_failures`` consecutive times is quarantined on the
    ``session.sink`` ledger."""
    from scenery_insitu_tpu_torch.runtime.streaming import apply_steering

    sess.camera, other = apply_steering(sess.camera, msg)
    for kind_msg in other.values():
        sess._sink_guard.run(sess.on_steer, kind_msg,
                             kind="on_steer callback")


def drain_steering(sess) -> None:
    """Apply all pending messages of the session's steering endpoint
    (``sess.steering``, anything with ``drain()`` yielding message
    dicts). Shared by InSituSession and SceneSession so the steering
    protocol has ONE consumer (`steer_session`)."""
    if sess.steering is None:
        return
    with sess.obs.span("steer", frame=sess.frame_index):
        for msg in sess.steering.drain():
            steer_session(sess, msg)


def apply_tf_steering(sess, msg: dict, invalidate) -> None:
    """Shared handler of ``tf`` steering messages (the reference's
    updateVis TF path, DistributedVolumeRenderer.kt:747-774): swap
    ``sess.tf`` (built on the session's device) and call
    ``invalidate()`` to drop or swap the steps built with the old TF.
    A malformed payload is logged and IGNORED — a buggy viewer must not
    be able to kill an in-situ run mid-simulation."""
    if msg.get("type") != "tf":
        return
    from scenery_insitu_tpu_torch.runtime.streaming import tf_from_message

    try:
        tf = tf_from_message(msg, device=sess.device)
    except Exception as e:
        sess.log(f"ignoring malformed tf steering message: {e!r}")
        return
    sess.tf = tf
    invalidate()


def _tf_fingerprint(tf: TransferFunction) -> str:
    """Content identity of a TransferFunction (a sha1 over its knot
    tensors' bytes): the key of the steered-TF step cache, so two
    messages describing the same polyline map to the same steps."""
    import hashlib

    h = hashlib.sha1()
    for leaf in tf:
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def regime_camera(cam0: Camera, regime) -> Camera:
    """Synthetic camera that resolves to ``regime`` under choose_axis:
    eye on the regime's axis at the original distance with a small
    off-axis bias. Raises on invalid regimes."""
    a, s = regime
    if a not in (0, 1, 2) or s not in (1, -1):
        raise ValueError(f"invalid march regime {regime!r} "
                         "(expected (axis in 0..2, sign ±1))")
    eye = cam0.eye.detach().cpu().numpy().astype(np.float64)
    tgt = cam0.target.detach().cpu().numpy().astype(np.float64)
    dist = float(np.linalg.norm(eye - tgt)) or 2.5
    off = np.full(3, 0.2 * dist)
    off[a] = 0.0
    new_eye = tgt.copy() - off
    new_eye[a] = tgt[a] - s * dist
    cam = cam0._replace(eye=torch.as_tensor(new_eye.astype(np.float32),
                                            device=cam0.eye.device))
    if _slicer.choose_axis(cam) != (a, s):
        raise RuntimeError(
            f"regime_camera drifted from choose_axis for {regime!r}")
    return cam


def drop_on_regime_reentry(sess, store: dict, key) -> None:
    """When the camera enters another regime key than the previous
    frame's, drop that key's carried threshold state so it re-seeds: a
    map frozen while the camera was elsewhere is stale. The tracker is
    restored verbatim by a checkpoint, so a resumed run makes the same
    decisions."""
    if key != getattr(sess, "_last_regime_key", key):
        store.pop(key, None)
    sess._last_regime_key = key


def advance_camera_and_index(sess) -> None:
    """Orbit the camera by ``orbit_rate`` (rounded to f32, as the
    reference's ``jnp.float32(rate)``) and bump the frame index."""
    if sess.orbit_rate:
        sess.camera = orbit(sess.camera, np.float32(sess.orbit_rate))
    sess.frame_index += 1


class VolumeSimAdapter:
    """Facade over the built-in volume sims: ``kind``, ``state``,
    ``advance(n)`` and ``field``. Gray-Scott advances through
    ``gs.multi_step_fast`` (kernel K3 on a card) with
    ``sim.fused_stencil``, else through the roll formulation; the vortex
    flow (``sim/vortex.py``) with ``sim.dt`` as its time step renders
    its normalised vorticity."""

    def __init__(self, cfg: FrameworkConfig, seed: int = 0, device=None):
        kind = cfg.sim.kind
        self.kind = kind
        if kind == "gray_scott":
            self.state = gs.GrayScott.from_config(cfg.sim, seed=seed,
                                                  device=device)
            self._advance = (gs.multi_step_fast if cfg.sim.fused_stencil
                             else gs.multi_step)
        elif kind == "vortex":
            self.state = vx.VortexFlow.init_ring(
                tuple(cfg.sim.grid),
                vx.VortexParams.create(dt=cfg.sim.dt, device=device))
            self._advance = vx.multi_step
        else:
            raise ValueError(f"unknown volume sim kind {cfg.sim.kind!r}")

    def advance(self, n: int) -> None:
        self.state = self._advance(self.state, n)

    @property
    def field(self) -> torch.Tensor:
        return self.state.field


class ParticleSimAdapter:
    """Facade over the built-in particle sims (``lennard_jones``, the MD
    workload rendered as spheres, and ``sho``, the reference's oscillator
    toy): ``kind``, ``state``, its ``params`` (and for Lennard-Jones the
    cell list's ``spec``), ``advance(n)``, ``pos`` and ``vel``. The state
    is drawn from ``seed`` (``sim.num_particles`` particles)."""

    def __init__(self, cfg: FrameworkConfig, seed: int = 0, device=None):
        kind = cfg.sim.kind
        self.kind = kind
        n = cfg.sim.num_particles
        self.spec = None
        if kind == "lennard_jones":
            self.state, self.params, self.spec = pt.lj_init(
                n, seed=seed, device=device)
        elif kind == "sho":
            self.state, self.params = pt.sho_init(n, seed=seed,
                                                  device=device)
        else:
            raise ValueError(f"unknown particle sim kind {kind!r}")

    def advance(self, n: int) -> None:
        if self.kind == "lennard_jones":
            self.state = pt.lj_multi_step(self.state, self.params,
                                          self.spec, n)
        else:
            self.state = pt.sho_multi_step(self.state, self.params, n)

    @property
    def pos(self) -> torch.Tensor:
        return self.state.pos

    @property
    def vel(self) -> torch.Tensor:
        return self.state.vel


class HybridSimAdapter:
    """The vortex flow and its passive tracers for the hybrid mode (the
    reference's BASELINE Config 5): ``flow``, ``tracers`` (voxel
    coordinates, ``sim.num_particles`` of them seeded from ``seed``),
    ``advance(n)`` (each step advects the tracers through the current
    flow, then steps the flow) and the flow's ``field``."""

    def __init__(self, cfg: FrameworkConfig, seed: int = 0, device=None):
        grid = tuple(cfg.sim.grid)
        self.kind = "hybrid"
        self.flow = vx.VortexFlow.init_ring(
            grid, vx.VortexParams.create(dt=cfg.sim.dt, device=device))
        self.tracers = vx.seed_tracers(grid, cfg.sim.num_particles,
                                       seed=seed, device=device)

    def advance(self, n: int) -> None:
        flow, pos = self.flow, self.tracers
        for _ in range(n):
            pos = vx.advect_tracers(flow.u, pos, flow.params.dt)
            flow = vx.step(flow)
        self.flow, self.tracers = flow, pos

    @property
    def field(self) -> torch.Tensor:
        return self.flow.field


class _HostCopy(NamedTuple):
    """A frame's pinned host buffers and the event its copy recorded."""

    bufs: Dict[str, torch.Tensor]
    copied: torch.cuda.Event


class InSituSession:
    """The in-situ loop over one device: ``device=None`` means CUDA and
    raises without a card, unless the caller passes ``device="cpu"``
    (or a ``mesh`` on the CPU)."""

    def __init__(self, cfg: Optional[FrameworkConfig] = None,
                 mesh: Optional[Mesh] = None,
                 camera: Optional[Camera] = None,
                 tf: Optional[TransferFunction] = None,
                 sim: Optional[VolumeSimAdapter] = None,
                 sinks: Sequence[Sink] = (), log=None, device=None):
        self.cfg = cfg or FrameworkConfig()
        self.log = log or (lambda s: None)
        check_ported(self.cfg)
        particles = (isinstance(sim, ParticleSimAdapter)
                     or (sim is None and self.cfg.sim.kind in _PARTICLE_SIMS))
        if mesh is not None:
            if device is not None and \
                    resolve_device(device) != mesh.device:
                raise ValueError(f"device {device!r} differs from the "
                                 f"mesh's {mesh.device}")
            self.mesh = mesh
        else:
            # mesh.num_devices ranks in-process on the one device (0 is
            # one rank), two-level under a hierarchical topology. A
            # particle session composites sort-first: it has no
            # two-level sort-last composite, so a hierarchy is inert
            topo_cfg = self.cfg.topology
            if particles and topo_cfg.num_hosts > 1:
                _obs.degrade(
                    "topology.hier", f"num_hosts={topo_cfg.num_hosts}",
                    "flat", "particle sessions composite sort-first — "
                    "no two-level sort-last composite to run", warn=False)
                topo_cfg = None
            self.mesh, _ = make_topology_mesh(topo_cfg, self.cfg.mesh,
                                              device=device)
        self.device = self.mesh.device
        # the flat axis view and the total rank count every mesh consumer
        # uses; a flat mesh ignores the topology, as the reference's does
        self._flat_axis, self._n_ranks, self._topo = resolve_mesh_topology(
            self.mesh, topology=(self.cfg.topology
                                 if len(self.mesh.axis_names) > 1
                                 else None))
        # the recorder feeds the per-phase Timers; it takes over the
        # process slot whether enabled or not, so a finished session's
        # recorder stops absorbing this one's events
        self.obs = _obs.Recorder.from_config(
            self.cfg.obs, rank=multihost.process_index(), log=self.log,
            window=self.cfg.runtime.stats_window)
        self.timers = self.obs.timers
        _obs.set_recorder(self.obs)
        from scenery_insitu_tpu_torch.obs.slo import SLOEngine
        self.slo = SLOEngine(self.cfg.slo, recorder=self.obs)
        # the fleet telemetry side-channel: batched, non-blocking event
        # publish on the frame loop, drops ledgered
        self._obs_pub = None
        if self.cfg.obs.collector:
            from scenery_insitu_tpu_torch.obs.collector import ObsPublisher
            self._obs_pub = ObsPublisher(
                self.cfg.obs.collector, self.cfg.obs.collector_hb,
                rank=self.obs.rank,
                interval_s=self.cfg.obs.collector_interval_s)
        if sim is not None:
            self.sim = sim
        elif particles:
            self.sim = ParticleSimAdapter(self.cfg, device=self.device)
        elif self.cfg.sim.kind == "hybrid":
            self.sim = HybridSimAdapter(self.cfg, device=self.device)
        else:
            self.sim = VolumeSimAdapter(self.cfg, device=self.device)
        self.tf = tf or for_dataset(
            self.cfg.sim.kind if self.cfg.runtime.dataset == "procedural"
            else self.cfg.runtime.dataset, device=self.device)
        self.camera = camera or Camera.create(
            (0.0, 0.6, 3.0), fov_y_deg=50.0, near=0.3, far=20.0,
            device=self.device)
        self.sinks: List[Sink] = list(sinks)
        # every frame sink and tile sink runs behind this guard: one
        # failing fault.max_sink_failures consecutive times is
        # quarantined instead of killing the run
        self._sink_guard = SinkGuard(self.cfg.fault.max_sink_failures,
                                     log=self.log)
        # tile-granular delivery: with composite.schedule == "waves"
        # every VDI frame is also cut into its n_ranks * wave_tiles
        # column-block tiles, and each tile payload ({vdi_color,
        # vdi_depth, tile, tiles, col0, frame, meta}) goes to these sinks
        # in column order before the frame sinks see the whole frame
        self.tile_sinks: List[Sink] = []
        self._delivery = None
        if self.cfg.delivery.enabled:
            from scenery_insitu_tpu_torch.runtime.delivery import (
                DeliveryExecutor)
            self._delivery = DeliveryExecutor(
                self.cfg.delivery, self._sink_guard, self.tile_sinks,
                self.sinks, recorder=self.obs, slo=self.slo,
                log=self.log)
        self.frame_index = 0
        self.orbit_rate = 0.0  # radians/frame camera sweep
        self.steering = None   # optional streaming.SteeringEndpoint
        self.on_steer: List[Callable[[dict], None]] = [
            self._apply_tf_message]
        # steered-TF recompile-or-reuse: the step sets built for a TF,
        # stashed under (its fingerprint, the decomposition) when the TF
        # is steered away, restored when it returns (_tf_invalidate)
        self._step_cache = {}
        self._pending_meta = {}  # frame index -> VDIMetadata at dispatch
        self._slicer = _slicer
        # the render decomposition: the planned band depths (None = the
        # even split) or the brick map (None = slabs), and the frame of
        # the last replan (_maybe_replan)
        self._plan = None
        self._bricks = None
        self._plan_frame = None
        # "auto" is the slice march on every device (the reference
        # picks it on its accelerator only)
        self.engine = _slicer.resolve_engine(self.cfg.slicer.engine)
        self._build_steps()

        # world placement: sim grid centered, largest side = 2 world
        # units; a particle step centres the box [0, box) itself
        if self.mode == "particles":
            d = h = w = 1
            vox = 1.0
            self._origin = torch.zeros(3, dtype=torch.float32,
                                       device=self.device)
        else:
            d, h, w = (tuple(self.cfg.sim.grid) if sim is None
                       else tuple(int(x) for x in self.sim.field.shape))
            check_brick_count(self.cfg.composite, d)
            vox = 2.0 / max(d, h, w)
            self._origin = torch.tensor(
                [-w * vox / 2, -h * vox / 2, -d * vox / 2],
                dtype=torch.float32, device=self.device)
        self._vox = vox
        self._spacing = torch.full((3,), vox, dtype=torch.float32,
                                   device=self.device)
        # device -> host copies: a side stream and pinned host buffers,
        # pipeline_depth + 1 sets reused (the frames in flight and the
        # one being dispatched)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._free_sets: List[Dict[str, torch.Tensor]] = []

    def _build_steps(self) -> None:
        """(Re)build the steps for the current mode, engine and TF: the
        gather engine's one step now, the slice march's per-regime
        caches empty (filled on first use)."""
        self.obs.count("build_steps")
        self._mxu_steps = {}   # regime key -> distributed step
        self._mxu_thr = {}     # regime key -> temporal threshold state
        self._mxu_reuse = {}   # regime key -> fragment reuse carry
        self._tf_key = _tf_fingerprint(self.tf)
        r, cc = self.cfg.render, self.cfg.composite
        self.mode = "vdi" if self.cfg.runtime.generate_vdis else "plain"
        self._step = None
        if isinstance(self.sim, ParticleSimAdapter):
            # sort-first sphere rendering
            from scenery_insitu_tpu_torch.parallel.particles import (
                distributed_particle_step)
            self.mode = "particles"
            self._step = distributed_particle_step(
                self.mesh, r.width, r.height,
                radius=self.cfg.sim.particle_radius)
        elif isinstance(self.sim, HybridSimAdapter):
            # the particle layer shares the slice march's virtual camera
            # rays, so the hybrid mode runs that engine whatever the knob
            self.mode = "hybrid"
            self.engine = "mxu"
        elif self.engine == "gather" and self.mode == "vdi":
            from scenery_insitu_tpu_torch.parallel.pipeline import (
                distributed_vdi_step)
            self._step = distributed_vdi_step(
                self.mesh, self.tf, r.width, r.height, self.cfg.vdi, cc,
                max_steps=r.max_steps, plan=self._plan,
                bricks=self._bricks, topology=self.cfg.topology)
        elif self.engine == "gather":
            from scenery_insitu_tpu_torch.parallel.pipeline import (
                distributed_plain_step)
            self._step = distributed_plain_step(
                self.mesh, self.tf, r.width, r.height, r, cc,
                plan=self._plan, bricks=self._bricks,
                topology=self.cfg.topology)
        self._temporal = (self.cfg.vdi.adaptive
                          and self.cfg.vdi.adaptive_mode == "temporal"
                          and self.mode in ("vdi", "hybrid")
                          and self.engine == "mxu")
        # fragment reuse rides the slice march's slab and plan VDI
        # steps; the other builders (a brick map's, gather, plain,
        # hybrid) ledger the inert knob (delta.reuse) and take no carry,
        # and a particle session marches no fragment at all
        self._reuse = (cc.temporal_reuse == "ranges" and self.mode == "vdi"
                       and self.engine == "mxu" and self._bricks is None)
        if cc.temporal_reuse == "ranges" and self.mode == "particles":
            _obs.degrade("delta.reuse", "ranges", "off",
                         "particle sessions march no volume fragments",
                         warn=False)
        if (self.cfg.vdi.adaptive and self.cfg.vdi.adaptive_mode ==
                "temporal" and not self._temporal and self.mode == "vdi"):
            raise ValueError(
                "adaptive_mode='temporal' is carried threshold state of "
                "the MXU VDI pipeline — this session resolved to mode="
                f"{self.mode!r} engine={self.engine!r}; use 'histogram' "
                "there")

    def _apply_tf_message(self, msg: dict) -> None:
        """'tf' steering: swap the TF and rebuild or restore the steps
        (`apply_tf_steering`, `_tf_invalidate`)."""
        apply_tf_steering(self, msg, self._tf_invalidate)

    def _tf_invalidate(self) -> None:
        """Steered-TF recompile-or-reuse keyed on the TF's identity: the
        outgoing TF's steps are stashed under its fingerprint and the
        render decomposition, and a steered TF seen before (same knots,
        same decomposition) restores them instead of rebuilding — a TF
        schedule cycling through k looks builds k step sets, not one an
        update. The carried thresholds and reuse carry re-seed either
        way (they track the scene under the OLD TF)."""
        if self.cfg.lod.enabled:
            # the level planner's TF-straddle gate depends on the TF: the
            # replan re-runs before the next march, so a brick whose
            # range straddles a NEW opacity edge refines on that frame
            self._plan_frame = None
        old_key = (self._tf_key,) + self._decomp_key()
        self._step_cache[old_key] = (self._mxu_steps, self._step)
        while len(self._step_cache) > 8:        # bound the kept step sets
            self._step_cache.pop(next(iter(self._step_cache)))
        new_fp = _tf_fingerprint(self.tf)
        self.obs.count("tf_updates")
        entry = self._step_cache.get((new_fp,) + self._decomp_key())
        if entry is not None:
            self._mxu_steps, self._step = entry
            self._mxu_thr = {}
            self._mxu_reuse = {}
            self._tf_key = new_fp
            self.obs.count("tf_steps_reused")
            self.obs.event("tf_update", frame=self.frame_index,
                           reused=True, key=new_fp)
            return
        self.obs.event("tf_update", frame=self.frame_index, reused=False,
                       key=new_fp)
        _obs.degrade("scenario.tf_update", "compiled steps", "recompile",
                     "a steered transfer function not seen before "
                     "rebuilds the compiled steps (TF knots are "
                     "compile-time constants)", warn=False)
        self._build_steps()

    # ------------------------------------------------------------- frames

    def render_frame(self):
        """Advance the sim and dispatch one frame's step; returns its
        device VDI, its plain or hybrid image, or its particle
        ``SplatOutput``."""
        drain_steering(self)
        self._maybe_replan()
        with self.obs.span("sim", frame=self.frame_index,
                           kind=self.sim.kind):
            self.sim.advance(self.cfg.sim.steps_per_frame)
        with self.obs.span("dispatch", frame=self.frame_index,
                           mode=self.mode, engine=self.engine):
            if self.mode == "particles":
                centered = self.sim.pos - self.sim.state.box / 2.0
                out = self._step(shard_particles(centered, self.mesh),
                                 shard_particles(self.sim.vel, self.mesh),
                                 self.camera)
                meta = self.frame_metadata(self.frame_index)
            elif self.mode == "hybrid":
                out, meta = self._hybrid_dispatch()
                meta = meta._replace(index=torch.tensor(
                    self.frame_index, dtype=torch.int32))
            elif self._step is not None:
                field = shard_volume(self.sim.field, self.mesh)
                out = self._step(field, self._origin, self._spacing,
                                 self.camera)
                meta = self.frame_metadata(self.frame_index)
            elif self.mode == "plain":
                out = self._plain_mxu_dispatch(
                    shard_volume(self.sim.field, self.mesh))
                meta = self.frame_metadata(self.frame_index)
            else:
                field = shard_volume(self.sim.field, self.mesh)
                out, meta = self._mxu_step()(field, self._origin,
                                             self._spacing, self.camera)
                # a host scalar: no copy to the device on the dispatch
                # path
                meta = meta._replace(index=torch.tensor(
                    self.frame_index, dtype=torch.int32))
        # metadata snapshot BEFORE the camera advances
        self._pending_meta[self.frame_index] = meta
        for k in [k for k in self._pending_meta
                  if k < self.frame_index
                  - self.cfg.runtime.pipeline_depth]:
            del self._pending_meta[k]
        self.obs.count("frames_eager_dispatch")
        advance_camera_and_index(self)
        return out

    def run(self, frames: int, fetch: bool = True,
            profile_dir: Optional[str] = None) -> dict:
        """Run ``frames`` frames with the depth-k device-to-host pipeline;
        returns the last fetched payload (``vdi_color``, ``vdi_depth``:
        host numpy arrays; ``frame``; ``meta``).

        ``profile_dir``: run the loop under ``torch.profiler`` (the
        card's kernels and copies too, on a card) and write its Chrome
        trace to ``<profile_dir>/trace.json`` (open it at
        ``ui.perfetto.dev``); the ``sitpu_*`` phase scopes of the steps
        are in it."""
        depth = self.cfg.runtime.pipeline_depth
        prof = None
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        try:
            # the deque holds the in-flight frames, newest last; a frame
            # retires (fetch + sinks, device refs dropped) once `depth`
            # newer dispatches are in flight
            pending = deque()
            payload = {}
            last = frames - 1
            for i in range(frames):
                t_f = time.perf_counter()
                out = self.render_frame()
                done = self._record_done()
                host = None
                consume = False
                if fetch:
                    # copy to the host only when somebody consumes the
                    # frame (sinks, or the caller's final payload)
                    consume = bool(self.sinks or self.tile_sinks) \
                        or i == last
                    if consume:
                        host = self._start_host_copy(out, done)
                pending.append((self.frame_index - 1, out, consume, done,
                                host))
                out = None      # the deque holds the only device ref
                while len(pending) > depth:
                    payload = self._retire(pending.popleft(), fetch,
                                           payload)
                self.timers.frame_done()
                self.slo.observe("frame_ms",
                                 (time.perf_counter() - t_f) * 1e3,
                                 frame=self.frame_index - 1)
                if self._obs_pub is not None:
                    self._obs_pub.pump(self.obs)
            while pending:
                payload = self._retire(pending.popleft(), fetch, payload)
        except BaseException:
            # drain the delivery queue (frames the device already paid
            # for), dump the last obs window, keep raising
            if self._delivery is not None:
                self._delivery.drain()
            _obs.flight_flush(self.obs, where="run")
            if self._obs_pub is not None:
                self._obs_pub.pump(self.obs, force=True)
            raise
        finally:
            if prof is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(profile_dir, "trace.json"))
        if self._delivery is not None:
            self._delivery.drain()
        self.timers.dump_totals()
        self.obs.flush()
        if self._obs_pub is not None:
            self._obs_pub.pump(self.obs, force=True)
        return payload

    def _record_done(self) -> Optional[torch.cuda.Event]:
        """An event on the compute stream after a frame's dispatch (None
        on the CPU, where the dispatch ran to its end)."""
        if self._copy_stream is None:
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    def _take_set(self, leaves: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """A free pinned set shaped like ``leaves``; sets of another shape
        (another march regime) are dropped."""
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in leaves.items()}
        while self._free_sets:
            bufs = self._free_sets.pop()
            if {k: (tuple(v.shape), v.dtype)
                    for k, v in bufs.items()} == shapes:
                return bufs
        return {k: torch.empty(s, dtype=dt, pin_memory=True)
                for k, (s, dt) in shapes.items()}

    @staticmethod
    def _leaves(out) -> Dict[str, torch.Tensor]:
        """A frame's device tensors by payload key: a VDI's colour and
        depth, a particle frame's image and depth, or a plain (or
        hybrid) image."""
        if isinstance(out, VDI):
            return {"vdi_color": out.color, "vdi_depth": out.depth}
        if isinstance(out, SplatOutput):
            return {"image": out.image, "depth": out.depth}
        return {"image": out}

    def _start_host_copy(self, out, done: Optional[torch.cuda.Event]
                         ) -> Optional[_HostCopy]:
        """Start the frame's device-to-host copy without blocking: the
        side stream waits on ``done`` and copies the VDI (or the plain
        image) into a pinned set. The caller keeps ``out`` alive until
        the frame retires, so the device buffers outlive the copy. None
        on the CPU (the frame already lies on the host)."""
        if self._copy_stream is None:
            return None
        leaves = self._leaves(out)
        bufs = self._take_set(leaves)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(done)
            for k, v in leaves.items():
                bufs[k].copy_(v, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return _HostCopy(bufs, copied)

    def _retire(self, entry, fetch: bool, payload: dict) -> dict:
        """Retire one pipelined frame: fetch and deliver it when it has
        consumers, else pace the loop on its completion. The caller has
        dropped the deque's reference, so the frame's device tensors free
        when this returns."""
        index, out, consume, done, host = entry
        if fetch and consume:
            return self._fetch(index, out, host)
        if fetch:
            self._sync_nofetch(index, done)
        return payload

    def _sync_nofetch(self, index: int,
                      done: Optional[torch.cuda.Event]) -> None:
        """Retire a frame nobody consumes: drop its metadata and wait for
        its dispatch to finish, without a host copy."""
        self._pending_meta.pop(index, None)
        with self.obs.span("fetch", frame=index, host_copy=False):
            if done is not None:
                done.synchronize()

    def _fetch(self, index: int, out, host: Optional[_HostCopy]) -> dict:
        meta = self._pending_meta.pop(index, None)
        if meta is None:
            meta = self.frame_metadata(index)
        tiles = ()
        with self.obs.span("fetch", frame=index):
            if host is not None:
                # wait on this frame's copy only, then take the bytes out
                # of the pinned set (which the next frames reuse), so
                # the payload owns its arrays as the reference's do
                host.copied.synchronize()
                payload = {k: v.numpy().copy()
                           for k, v in host.bufs.items()}
                self._free_sets.append(host.bufs)
            else:
                payload = {k: v.detach().cpu().numpy()
                           for k, v in self._leaves(out).items()}
            if "vdi_color" in payload and self.tile_sinks \
                    and self.cfg.composite.schedule == "waves":
                color, depth = payload["vdi_color"], payload["vdi_depth"]
                if self._delivery is not None:
                    # the worker delivers these views in the same order
                    tiles = self._tile_payloads(index, meta, color, depth)
                else:
                    # every tile goes out before the frame's sinks run
                    self._deliver_tiles(index, meta, color, depth)
            payload.update(frame=index, meta=meta)
        if self._delivery is not None:
            self._delivery.submit(index, payload, tiles)
        else:
            with self.obs.span("sinks", frame=index):
                self._sink_guard.run(self.sinks, index, payload)
        return payload

    def _tile_payloads(self, index: int, meta, color: np.ndarray,
                       depth: np.ndarray) -> list:
        """One composited VDI frame cut into its column-block tile
        payloads, ascending global column order (tile t covers columns
        [t*wb, (t+1)*wb)). The tiles are the wave schedule's unit,
        n_ranks * wave_tiles blocks; a width the tiling does not divide
        falls back to per-rank blocks. The slices are views."""
        n = self._n_ranks
        tiles = n * self.cfg.composite.wave_tiles
        w_total = color.shape[-1]
        if w_total % tiles:
            tiles = n                       # waves degraded to frame
        wb = w_total // tiles
        return [{
            "vdi_color": color[..., t * wb:(t + 1) * wb],
            "vdi_depth": depth[..., t * wb:(t + 1) * wb],
            "frame": index, "tile": t, "tiles": tiles,
            "col0": t * wb, "meta": meta,
        } for t in range(tiles)]

    def _deliver_tiles(self, index: int, meta, color: np.ndarray,
                       depth: np.ndarray) -> None:
        """Hand every column-block tile of one frame to the tile sinks in
        ascending column order: tile t arrives before tile t+1 and
        before the frame's own sinks."""
        for payload in self._tile_payloads(index, meta, color, depth):
            with self.obs.span("tile", frame=index, tile=payload["tile"]):
                self.obs.count("tiles_delivered")
                self._sink_guard.run(self.tile_sinks, index, payload,
                                     kind="tile sink")

    def _enter_regime(self, key) -> None:
        if key != getattr(self, "_last_regime_key", key):
            self.obs.count("regime_switches")
            # a carried fragment is as stale as the carried thresholds:
            # the field moved on while the camera was elsewhere, and the
            # re-entered regime's signature could hide that
            self._mxu_reuse.pop(key, None)
        drop_on_regime_reentry(self, self._mxu_thr, key)

    def _note_dirty(self, ru) -> None:
        """The accounting of the reuse carry's LAST decision:
        ``delta_march_skipped`` counts the tiles whose march did not run
        and the ``delta_dirty_tiles`` event carries the ranks' dirty
        bits. It reads the incoming carry, whose bits the previous frame
        decided on the host, so it copies nothing from the device."""
        if not bool(ru.valid.any()):
            return                       # the seed: nothing decided yet
        d = ru.dirty.numpy()
        cc = self.cfg.composite
        n = d.size
        tiles_per_rank = (cc.wave_tiles
                          if cc.schedule == "waves" and n > 1 else 1)
        clean = int((d == 0).sum())
        if clean:
            self.obs.count("delta_march_skipped", clean * tiles_per_rank)
        self.obs.event("delta_dirty_tiles", frame=self.frame_index - 1,
                       dirty=[int(x) for x in d],
                       tiles_per_rank=tiles_per_rank,
                       skipped_tiles=clean * tiles_per_rank,
                       total_tiles=n * tiles_per_rank)

    def prewarm_regimes(self, regimes=None) -> dict:
        """Build and run the step of each (axis, sign) march regime once,
        before the camera path reaches it, on the current field and a
        synthetic camera on that regime's axis. The camera, the carried
        thresholds and the regime tracker are restored; the sim, frame
        index and sinks are never touched. Returns {(axis, sign):
        seconds}; {} on the gather engine and in the particle mode, whose
        one step has no regime."""
        if regimes is None:
            regimes = [(a, s) for a in (0, 1, 2) for s in (1, -1)]
        cam0 = self.camera
        thr0 = dict(self._mxu_thr)
        reuse0 = dict(self._mxu_reuse)
        had_last = hasattr(self, "_last_regime_key")
        last0 = getattr(self, "_last_regime_key", None)
        if self._step is not None:
            return {}                   # the gather engine has no regimes
        times = {}
        try:
            for regime in regimes:
                a, s = regime
                cam = regime_camera(cam0, regime)
                self.camera = cam
                t0 = time.perf_counter()
                with self.obs.span("prewarm", regime=str(regime)):
                    if self.mode == "hybrid":
                        self._hybrid_dispatch()
                    elif self.mode == "plain":
                        self._plain_mxu_dispatch(
                            shard_volume(self.sim.field, self.mesh))
                    else:
                        self._mxu_step()(shard_volume(self.sim.field,
                                                      self.mesh),
                                         self._origin, self._spacing, cam)
                    done = self._record_done()
                    if done is not None:
                        done.synchronize()
                times[(a, s)] = round(time.perf_counter() - t0, 2)
        finally:
            self.camera = cam0
            self._mxu_thr = thr0
            self._mxu_reuse = reuse0
            if had_last:
                self._last_regime_key = last0
            elif hasattr(self, "_last_regime_key"):
                del self._last_regime_key
        return times

    def _hybrid_dispatch(self):
        """One distributed hybrid frame: the regime's
        ``distributed_hybrid_step_mxu`` (built once a regime, key
        ``("hybrid", axis, sign)``; spheres of ``sim.particle_radius``
        voxels) on the flow's field and the tracers' world positions and
        velocities, with the regime's carried thresholds in temporal
        mode (seeded on first use), warped to the display camera, which
        blends ``render.background``. Returns (image, meta)."""
        from scenery_insitu_tpu_torch.parallel.pipeline import (
            distributed_hybrid_step_mxu, distributed_initial_threshold_mxu)

        regime = self._slicer.choose_axis(self.camera)
        key = ("hybrid",) + regime
        if self._temporal:
            self._enter_regime(key)
        entry = self._mxu_steps.get(key)
        if entry is None:
            self.obs.count("compile_step")
            self.obs.event("compile", frame=self.frame_index,
                           what="hybrid_step", regime=str(regime))
            spec = self._slicer.make_spec(
                self.camera, self.sim.field.shape, self.cfg.slicer,
                axis_sign=regime, multiple_of=self._n_ranks)
            step = distributed_hybrid_step_mxu(
                self.mesh, self.tf, spec, self.cfg.vdi, self.cfg.composite,
                radius=self.cfg.sim.particle_radius * self._vox, stamp=5,
                temporal=self._temporal, plan=self._plan,
                bricks=self._bricks, topology=self.cfg.topology)
            seed = (distributed_initial_threshold_mxu(
                        self.mesh, self.tf, spec, self.cfg.vdi,
                        plan=self._plan)
                    if self._temporal else None)
            entry = (step, seed, spec)
            self._mxu_steps[key] = entry
        step, seed, spec = entry
        field = self.sim.field
        flow, tracers = self.sim.flow, self.sim.tracers
        args = (shard_volume(field, self.mesh), self._origin, self._spacing,
                shard_particles(vx.tracers_to_world(
                    tracers, self._origin, self._spacing), self.mesh),
                shard_particles(vx.tracer_velocities(flow.u, tracers),
                                self.mesh), self.camera)
        if self._temporal:
            thr = self._mxu_thr.get(key)
            if thr is None:
                thr = seed(*args[:3], self.camera)
            (img, meta), self._mxu_thr[key] = step(*args, thr)
        else:
            img, meta = step(*args)
        r = self.cfg.render
        axcam = self._slicer.make_axis_camera(
            Volume(field, self._origin, self._spacing), self.camera, spec)
        return self._slicer.warp_to_camera(img, axcam, spec, self.camera,
                                           r.width, r.height,
                                           r.background), meta

    def _plain_mxu_dispatch(self, field: torch.Tensor) -> torch.Tensor:
        """One plain frame on the slice march: the regime's
        ``distributed_plain_step_mxu`` (built once a regime) and the
        homography warp of its intermediate image to the display camera,
        which blends ``render.background``."""
        from scenery_insitu_tpu_torch.parallel.pipeline import (
            distributed_plain_step_mxu)

        regime = self._slicer.choose_axis(self.camera)
        key = ("plain",) + regime
        entry = self._mxu_steps.get(key)
        if entry is None:
            self.obs.count("compile_step")
            self.obs.event("compile", frame=self.frame_index,
                           what="plain_step", regime=str(regime))
            spec = self._slicer.make_spec(
                self.camera, self.sim.field.shape, self.cfg.slicer,
                axis_sign=regime, multiple_of=self._n_ranks)
            step = distributed_plain_step_mxu(
                self.mesh, self.tf, spec, self.cfg.render,
                self.cfg.composite, plan=self._plan, bricks=self._bricks,
                topology=self.cfg.topology)
            entry = (step, spec)
            self._mxu_steps[key] = entry
        step, spec = entry
        r = self.cfg.render
        img, axcam = step(field, self._origin, self._spacing, self.camera)
        return self._slicer.warp_to_camera(img, axcam, spec, self.camera,
                                           r.width, r.height, r.background)

    def _mxu_step(self):
        """The distributed step of the camera's march regime, built once
        per (axis, sign). In temporal mode, and with fragment reuse, the
        returned callable seeds and carries the regime's threshold state
        and reuse carry itself, so callers see one 4-argument
        signature."""
        from scenery_insitu_tpu_torch.parallel.pipeline import (
            distributed_initial_reuse_mxu,
            distributed_initial_threshold_mxu, distributed_vdi_step_mxu,
            distributed_vdi_step_mxu_temporal)

        regime = self._slicer.choose_axis(self.camera)
        if self._temporal or self._reuse:
            self._enter_regime(regime)
        step = self._mxu_steps.get(regime)
        if step is None:
            self.obs.count("compile_step")
            self.obs.event("compile", frame=self.frame_index,
                           what="vdi_step", regime=str(regime),
                           decomp=str(self._decomp_key()))
            n = self._n_ranks
            spec = self._slicer.make_spec(self.camera, self.sim.field.shape,
                                          self.cfg.slicer, axis_sign=regime,
                                          multiple_of=n)
            decomp = dict(plan=self._plan, bricks=self._bricks)
            tol = self.cfg.delta.range_tol
            rseed = (distributed_initial_reuse_mxu(
                         self.mesh, self.tf, spec, self.cfg.vdi,
                         self.cfg.composite, plan=self._plan)
                     if self._reuse else None)
            if self._temporal:
                inner = distributed_vdi_step_mxu_temporal(
                    self.mesh, self.tf, spec, self.cfg.vdi,
                    self.cfg.composite, topology=self.cfg.topology,
                    reuse_tol=tol, **decomp)
                seed = distributed_initial_threshold_mxu(
                    self.mesh, self.tf, spec, self.cfg.vdi, **decomp)

                def step(field, origin, spacing, cam, _regime=regime,
                         _inner=inner, _seed=seed, _rseed=rseed):
                    thr = self._mxu_thr.get(_regime)
                    if thr is None:
                        thr = _seed(field, origin, spacing, cam)
                    if _rseed is None:
                        out, self._mxu_thr[_regime] = _inner(
                            field, origin, spacing, cam, thr)
                        return out
                    ru = self._carried_reuse(_regime, _rseed, field, origin,
                                             spacing, cam)
                    out, self._mxu_thr[_regime], \
                        self._mxu_reuse[_regime] = _inner(
                            field, origin, spacing, cam, thr, ru)
                    return out
            elif self._reuse:
                inner = distributed_vdi_step_mxu(
                    self.mesh, self.tf, spec, self.cfg.vdi,
                    self.cfg.composite, topology=self.cfg.topology,
                    plan=self._plan, reuse_tol=tol)

                def step(field, origin, spacing, cam, _regime=regime,
                         _inner=inner, _rseed=rseed):
                    ru = self._carried_reuse(_regime, _rseed, field, origin,
                                             spacing, cam)
                    out, self._mxu_reuse[_regime] = _inner(
                        field, origin, spacing, cam, ru)
                    return out
            else:
                step = distributed_vdi_step_mxu(
                    self.mesh, self.tf, spec, self.cfg.vdi,
                    self.cfg.composite, topology=self.cfg.topology,
                    **decomp)
            self._mxu_steps[regime] = step
        return step

    def _carried_reuse(self, regime, rseed, field, origin, spacing, cam):
        """The regime's reuse carry (seeded on first use or after a
        drop), noted on the recorder when it is enabled."""
        ru = self._mxu_reuse.get(regime)
        if ru is None:
            ru = rseed(field, origin, spacing, cam)
        if self.obs.enabled:
            self._note_dirty(ru)
        return ru

    # ------------------------------------------------ render rebalancing

    def _decomp_key(self):
        """The render decomposition the cached steps were built for: the
        plan, or the brick owners and levels (a level change pools other
        volumes, so it rebuilds like an ownership change)."""
        return (self._plan,
                None if self._bricks is None
                else (self._bricks.owner, self._bricks.level))

    def _even_slabs(self) -> torch.Tensor:
        return shard_volume(self.sim.field, self.mesh)

    def _replan_profile(self) -> np.ndarray:
        """The global per-z-bin live profile of the current field (host
        numpy): `ops/occupancy.z_live_profile` of every rank's even slab,
        the profiles concatenated in rank order."""
        from scenery_insitu_tpu_torch.ops import occupancy as _occ

        slabs = self._even_slabs()
        nzb = _occ._cap_divisor(slabs.shape[1], 32)
        return torch.cat([_occ.z_live_profile(x, self.tf, nzb=nzb)
                          for x in slabs]).cpu().numpy()

    def _replan_ranges(self):
        """The global per-z-bin value range of the current field (host
        numpy): `ops/occupancy.z_range_profile` of every rank's even
        slab, concatenated in rank order — the LOD planner's TF-straddle
        input."""
        from scenery_insitu_tpu_torch.ops import occupancy as _occ

        slabs = self._even_slabs()
        nzb = _occ._cap_divisor(slabs.shape[1], 32)
        parts = [_occ.z_range_profile(x, nzb=nzb) for x in slabs]
        return (torch.cat([lo for lo, _ in parts]).cpu().numpy(),
                torch.cat([hi for _, hi in parts]).cpu().numpy())

    def _maybe_replan(self) -> None:
        """Re-plan the render decomposition every ``rebalance_period``
        frames (``composite.rebalance`` "occupancy" or "bricks"): fetch
        the live profile, run ``ops/occupancy.slice_plan`` (quantum and
        hysteresis keep the plan stable), and when the plan changes,
        rebuild the steps on the new band split — one rebuild an adopted
        plan, on the ledger (``occupancy.replan``) with a
        ``rebalance_plan`` event carrying the modeled straggler
        factors."""
        cc = self.cfg.composite
        if self.cfg.lod.enabled and cc.rebalance != "bricks":
            # levels live on the brick map: without it there is nothing
            # to carry them
            _obs.degrade(
                "lod.inert", "lod", "off",
                f"lod.enabled needs composite.rebalance='bricks' to "
                f"carry levels (got {cc.rebalance!r}); every march "
                "samples at level 0", warn=False)
        if cc.rebalance not in ("occupancy", "bricks"):
            return
        n = self._n_ranks
        # an LOD session replans on one rank too: a level changes what
        # that rank marches
        lod_on = (self.cfg.lod.enabled and cc.rebalance == "bricks"
                  and self.mode == "vdi")
        if self.mode == "particles" or (n == 1 and not lod_on):
            _obs.degrade("occupancy.rebalance", "occupancy", "even",
                         ("single-rank mesh has one band" if n == 1 else
                          f"mode {self.mode!r} renders no volume field to "
                          "rebalance"), warn=False)
            return
        if cc.rebalance == "bricks" and self.mode != "vdi":
            # only the VDI builders march a brick map: replanning would
            # rebuild plain steps that render even slabs regardless
            _obs.degrade(
                "bricks.partition", "bricks", "slabs",
                f"mode {self.mode!r} has no brick march (gather/MXU VDI "
                "steps only); the even z-slab decomposition renders",
                warn=False)
            return
        if self._plan_frame is not None and \
                self.frame_index - self._plan_frame < cc.rebalance_period:
            return
        if cc.rebalance == "bricks":
            self._replan_bricks(cc, n)
            return
        from scenery_insitu_tpu_torch.ops import occupancy as _occ

        d = int(self.sim.field.shape[0])
        with self.obs.span("replan", frame=self.frame_index):
            profile = self._replan_profile()
            even = _occ.even_plan(d, n)
            prev = self._plan if self._plan is not None else even
            plan = _occ.slice_plan(
                profile, d, n, min_depth=cc.rebalance_min_depth,
                quantum=cc.rebalance_quantum, prev=prev,
                hysteresis=cc.rebalance_hysteresis)
        self._plan_frame = self.frame_index
        if plan == prev:
            return                      # stable: nothing rebuilds
        self.obs.count("rebalance_replans")
        self.obs.event(
            "rebalance_plan", frame=self.frame_index, plan=list(plan),
            straggler_even=round(_occ.straggler_factor(profile, d, even),
                                 3),
            straggler_planned=round(_occ.straggler_factor(profile, d,
                                                          plan), 3))
        _obs.degrade("occupancy.replan", f"plan{tuple(prev)}",
                     f"plan{tuple(plan)}",
                     "render bands re-planned from fetched live "
                     "fractions; affected steps recompile", warn=False)
        self._plan = plan if plan != even else None
        self._build_steps()

    def _replan_bricks(self, cc, n: int) -> None:
        """Brick-stealing replan: bin the live profile into per-brick
        work and move at most ``rebalance_max_moves`` bricks from the
        most- to the least-loaded rank (``parallel/bricks.steal_plan``,
        hysteresis-stable). With ``lod.enabled`` also select a level a
        brick (``parallel/lod.select_levels``) and scale the work into
        level units (``level_work_scale``) before stealing. A change of
        owners or levels rebuilds the steps; a map that converges back
        to the even-convex one restores the slab path."""
        from scenery_insitu_tpu_torch.parallel import bricks as _bk

        lod = self.cfg.lod
        d = int(self.sim.field.shape[0])
        with self.obs.span("replan", frame=self.frame_index):
            profile = self._replan_profile()
            nb = cc.rebalance_bricks or _bk.auto_nbricks(d, n)
            work = _bk.brick_work(profile, d, nb)
            seed = _bk.BrickMap.contiguous(d, n, nb)
            prev = (self._bricks if self._bricks is not None
                    and self._bricks.nbricks == nb else seed)
            if lod.enabled:
                from scenery_insitu_tpu_torch.core.transfer import (
                    opacity_edges)
                from scenery_insitu_tpu_torch.parallel import lod as _lod

                lo, hi = self._replan_ranges()
                shp = self.sim.field.shape                  # (D, H, W)
                dims = (int(shp[2]), int(shp[1]), int(shp[0]))
                cam = self.camera
                levels = _lod.select_levels(
                    _lod.per_brick(profile, nb, red="mean"),
                    _lod.per_brick(lo, nb, red="min"),
                    _lod.per_brick(hi, nb, red="max"),
                    opacity_edges(self.tf, lod.tf_edge_eps),
                    dims=dims, origin=self._origin.cpu().numpy(),
                    spacing=self._spacing.cpu().numpy(),
                    eye=cam.eye.detach().cpu().numpy(),
                    fov_y=float(cam.fov_y),
                    height_px=self.cfg.render.height, cfg=lod,
                    prev=(self._bricks.level
                          if self._bricks is not None
                          and self._bricks.nbricks == nb else None))
                prev = prev.with_levels(levels)
                work = work * _lod.level_work_scale(
                    levels, dims, self.cfg.render.width,
                    self.cfg.render.height)
            bm = _bk.steal_plan(prev, work,
                                max_moves=cc.rebalance_max_moves,
                                hysteresis=cc.rebalance_hysteresis)
        self._plan_frame = self.frame_index
        new = None if bm.is_even_convex() else bm
        cur = self._bricks
        if (new is None) == (cur is None) and \
                (new is None or (new.owner == cur.owner
                                 and new.level == cur.level)):
            return                      # stable: nothing rebuilds
        self.obs.count("rebalance_replans")
        levels_now = list(bm.level)
        self.obs.event(
            "rebalance_plan", frame=self.frame_index, kind="bricks",
            nbricks=nb, owner=list(bm.owner), level=levels_now,
            max_level=int(max(levels_now)) if levels_now else 0,
            straggler_even=round(_bk.straggler_factor(seed, work), 3),
            straggler_planned=round(_bk.straggler_factor(bm, work), 3))
        _obs.degrade("occupancy.replan",
                     f"bricks{tuple(prev.owner)}",
                     f"bricks{tuple(bm.owner)}",
                     "brick ownership re-planned from fetched live "
                     "fractions; affected steps recompile", warn=False)
        self._bricks = new
        self._build_steps()

    def frame_metadata(self, index: int,
                       camera: Optional[Camera] = None) -> VDIMetadata:
        """VDIMetadata for the current (or the given) camera and volume
        placement; call before the camera advances."""
        camera = camera if camera is not None else self.camera
        r = self.cfg.render
        shape = (np.asarray(self.sim.field.shape) if self.mode != "particles"
                 else np.zeros(3, np.int32))
        return VDIMetadata.create(
            projection=projection_matrix(camera, r.width, r.height),
            view=view_matrix(camera),
            volume_dims=np.asarray(shape[::-1], np.float32),   # (x, y, z)
            window_dims=(r.width, r.height), nw=self._vox, index=index)

    def device_snapshot(self) -> dict:
        """Per-regime cost snapshot (bytes and FLOPs, ``obs/device.
        cost_snapshot``) of every step this session holds, keyed as the
        reference keys its step caches: ``gather``/``plain`` for the
        gather engine's step, ``str(regime key)`` for a slice-march one.
        Each step runs once on the current field and camera. A step that
        carries the session's temporal thresholds or reuse carry (a
        host-side closure over the session's state) and the particle and
        hybrid modes' steps report as unavailable, with the reference's
        texts, rather than running. The snapshot is also recorded as an
        obs event."""
        from scenery_insitu_tpu_torch.obs import device as _dev

        snaps = {}
        if self.mode in ("vdi", "plain"):
            field = shard_volume(self.sim.field, self.mesh)
            args = (field, self._origin, self._spacing, self.camera)
            if self._step is not None:
                snaps["gather" if self.mode == "vdi" else "plain"] = \
                    _dev.cost_snapshot(self._step, *args)
            for key, entry in self._mxu_steps.items():
                if isinstance(entry, tuple):
                    # a plain regime's step returns (image, axcam) on
                    # the intermediate grid; its warp is not counted
                    snaps[str(key)] = _dev.cost_snapshot(entry[0], *args)
                elif self._temporal or self._reuse:
                    snaps[str(key)] = {"source": "unavailable",
                                       "error": "host-side closure "
                                                "(temporal step)"}
                else:
                    snaps[str(key)] = _dev.cost_snapshot(entry, *args)
        else:
            keys = (list(self._mxu_steps) if self._mxu_steps
                    else ([self.mode] if self._step is not None else []))
            for key in keys:
                snaps[str(key)] = {"source": "unavailable",
                                   "error": f"mode {self.mode!r} operands "
                                            "not snapshotted"}
        if snaps:
            self.obs.event("device_snapshot", frame=self.frame_index,
                           regimes=list(snaps))
        return snaps


def _vdi_numpy(payload: dict) -> VDI:
    return VDI(np.asarray(payload["vdi_color"]),
               np.asarray(payload["vdi_depth"]))


def vdi_sink(directory: str, dataset: str = "session", every: int = 1,
             codec: str = "zstd", workers: int = 1) -> Sink:
    """Dump composited VDIs as .npz artifacts (``io/vdi_io.py``).
    ``workers`` threads the per-member compression (byte-identical
    artifacts)."""
    from scenery_insitu_tpu_torch.io.vdi_io import dump_path, save_vdi

    def sink(index: int, payload: dict) -> None:
        if index % every or "vdi_color" not in payload:
            return
        save_vdi(dump_path(directory, dataset, index, "vdi"),
                 _vdi_numpy(payload), codec=codec, workers=workers)

    return sink


def vdi_tile_sink(directory: str, dataset: str = "session", every: int = 1,
                  codec: str = "zstd", workers: int = 1) -> Sink:
    """Tile-granular twin of `vdi_sink`: each column-block tile payload
    (``tile``, ``tiles``, ``col0``) is dumped as its own .npz carrying
    its placement (``io.vdi_io.load_vdi_tile`` reads it back)."""
    from scenery_insitu_tpu_torch.io.vdi_io import dump_path, save_vdi

    def sink(index: int, payload: dict) -> None:
        if index % every or "vdi_color" not in payload \
                or "tile" not in payload:
            return
        save_vdi(dump_path(directory, dataset, index,
                           f"vditile{payload['tile']:02d}"),
                 _vdi_numpy(payload), payload.get("meta"), codec=codec,
                 tile=(payload["tile"], payload["tiles"],
                       payload["col0"]), workers=workers)

    return sink


def png_sink(directory: str, gamma: float = 2.2, every: int = 1) -> Sink:
    """Dump frames as PNGs: an image payload as it is, a VDI payload
    decoded from its own view (`render_vdi_same_view`, on the host)."""
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.utils.image import save_png
    os.makedirs(directory, exist_ok=True)

    def sink(index: int, payload: dict) -> None:
        if index % every:
            return
        if "image" in payload:
            img = payload["image"]
        else:
            img = render_vdi_same_view(VDI(
                torch.as_tensor(payload["vdi_color"]),
                torch.as_tensor(payload["vdi_depth"]))).numpy()
        save_png(os.path.join(directory, f"frame{index:05d}.png"), img, gamma)

    return sink

"""The scenario zoo — named, steered, benched workloads through ONE
in-situ pipeline.

The port of the reference's ``scenarios/``. The system serves many
scenario families through one in-situ renderer (Gray-Scott reaction-
diffusion, vortex-in-cell flow, MD particle clouds). A `Scenario` names
a simulation family, the config overrides that select it, a per-frame
STEERING hook (driven through the consumer a network viewer's messages
take, ``runtime.session.steer_session``), and a bench recipe (sizes and
a frame count). Sessions are built on ``device`` (None: CUDA), passed
through ``session_kw``.

Built-ins:

- ``gray_scott``  the flagship reaction-diffusion VDI pipeline, with a
                  TIME-VARYING multi-channel transfer function driven
                  over steering (a ``tf`` message per period —
                  the session rebuilds-or-reuses its steps keyed on TF
                  identity, so a cycling schedule pays k builds for k
                  distinct looks).
- ``vortex``      the incompressible vortex-ring flow (|curl u|
                  rendered as a VDI), steered between two jet-ramp
                  transfer functions.
- ``hybrid``      the MULTI-VOLUME scene: the vortex grid field
                  composited with sort-first particle splats (passive
                  tracers) in one frame — the ops/hybrid.py path,
                  reachable by name.
- ``lennard_jones`` the MD particle cloud (sort-first sphere splats),
                  steered by a slow camera dolly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

Steer = Callable[[object, int], Optional[dict]]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registered workload: config overrides select the sim family
    and tuned defaults, ``steering`` (optional) returns at most one
    steering-protocol message per frame (applied through
    `runtime.session.steer_session`), and ``bench`` is the recipe of a
    timed run (size overrides and a frame count, small enough for the
    CPU)."""

    name: str
    description: str
    overrides: Tuple[str, ...] = ()
    steering: Optional[Steer] = None
    # bench recipe: extra overrides (sizes) + frames for one timed run
    bench_overrides: Tuple[str, ...] = ()
    bench_frames: int = 6
    # volume scenarios hold brick-permutation composite parity in a
    # bench run; particle scenarios have no brick decomposition
    brick_parity: bool = True


_REGISTRY: Dict[str, Scenario] = {}


def register(scn: Scenario) -> Scenario:
    if scn.name in _REGISTRY:
        raise ValueError(f"scenario {scn.name!r} already registered")
    _REGISTRY[scn.name] = scn
    return scn


def get(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(registered: {names()})") from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_config(name: str, cfg=None, extra_overrides: Sequence[str] = ()):
    """FrameworkConfig of a scenario: its registered overrides applied
    over ``cfg`` (default FrameworkConfig), then ``extra_overrides``."""
    from scenery_insitu_tpu_torch.config import FrameworkConfig

    scn = get(name)
    cfg = cfg or FrameworkConfig()
    return cfg.with_overrides(*scn.overrides, *extra_overrides)


def make_session(name: str, cfg=None, extra_overrides: Sequence[str] = (),
                 **session_kw):
    """Build an `InSituSession` running scenario ``name``
    (``session_kw``: the session's own arguments, ``device`` among
    them — None means CUDA)."""
    from scenery_insitu_tpu_torch.runtime.session import InSituSession

    return InSituSession(make_config(name, cfg, extra_overrides),
                         **session_kw)


def run_steered(sess, scn: Scenario, frames: int, fetch: bool = True):
    """Drive ``frames`` through ``sess`` with the scenario's steering
    hook injected per frame (the in-process twin of a viewer's steering
    drain — the same `steer_session` consumer). Each frame is fetched
    through the session's own copy path (its side-stream copy into a
    pinned set on a card). Returns the last fetched payload."""
    from scenery_insitu_tpu_torch.runtime.session import steer_session

    payload = {}
    for _ in range(frames):
        if scn.steering is not None:
            msg = scn.steering(sess, sess.frame_index)
            if msg:
                steer_session(sess, msg)
        out = sess.render_frame()
        if fetch:
            host = sess._start_host_copy(out, sess._record_done())
            payload = sess._fetch(sess.frame_index - 1, out, host)
        sess.timers.frame_done()
    sess.timers.dump_totals()
    sess.obs.flush()
    return payload


def run(name: str, frames: int, cfg=None,
        extra_overrides: Sequence[str] = (), fetch: bool = True,
        **session_kw):
    """One-call scenario run: build the session, drive it steered."""
    scn = get(name)
    sess = make_session(name, cfg, extra_overrides, **session_kw)
    return run_steered(sess, scn, frames, fetch=fetch)


# ------------------------------------------------------- steering hooks


def tf_schedule(tf_messages: Sequence[dict], period: int) -> Steer:
    """Time-varying transfer function over steering: every ``period``
    frames the next prebuilt ``tf`` message fires (wrapping). Cycling
    through k distinct TFs exercises the session's rebuild-or-reuse —
    after one full cycle every further update restores cached steps
    (the ``tf_steps_reused`` counter)."""
    msgs = list(tf_messages)
    if not msgs or period < 1:
        raise ValueError("tf_schedule needs >= 1 message and period >= 1")

    def steer(sess, frame: int) -> Optional[dict]:
        if frame and frame % period == 0:
            return msgs[(frame // period) % len(msgs)]
        return None

    return steer


def camera_dolly(rate: float = 0.02) -> Steer:
    """Slow per-frame camera dolly toward the target — exercises the
    camera half of the steering protocol (every frame moves)."""
    import numpy as np

    def steer(sess, frame: int) -> Optional[dict]:
        eye = sess.camera.eye.detach().cpu().numpy().astype(np.float64)
        tgt = sess.camera.target.detach().cpu().numpy().astype(np.float64)
        eye = eye + (tgt - eye) * rate
        return {"type": "camera", "eye": [float(x) for x in eye]}

    return steer


def _tf_msgs(specs) -> list:
    from scenery_insitu_tpu_torch.runtime.streaming import make_tf_message

    return [make_tf_message(points, colormap=cm) for points, cm in specs]


# ----------------------------------------------------------- built-ins

register(Scenario(
    name="gray_scott",
    description="Gray-Scott reaction-diffusion VDI pipeline (the "
                "flagship workload) with a time-varying multi-channel "
                "TF driven over steering",
    overrides=("sim.kind=gray_scott", "runtime.dataset=gray_scott"),
    steering=tf_schedule(_tf_msgs([
        ([(0.0, 0.0), (0.12, 0.0), (0.3, 0.12), (0.65, 0.3),
          (1.0, 0.5)], "viridis"),
        ([(0.0, 0.0), (0.2, 0.02), (0.5, 0.4), (1.0, 0.6)], "hot"),
    ]), period=4),
    bench_overrides=("sim.grid=[32,32,32]", "sim.steps_per_frame=2",
                     "render.width=64", "render.height=64"),
))

register(Scenario(
    name="vortex",
    description="Incompressible vortex-ring flow; |curl u| rendered as "
                "a VDI, steered between two jet-ramp TFs",
    overrides=("sim.kind=vortex", "runtime.dataset=vortex"),
    steering=tf_schedule(_tf_msgs([
        ([(0.0, 0.0), (0.15, 0.05), (1.0, 0.4)], "jet"),
        ([(0.0, 0.0), (0.4, 0.0), (0.7, 0.5), (1.0, 0.7)], "jet"),
    ]), period=3),
    bench_overrides=("sim.grid=[32,32,32]", "sim.steps_per_frame=1",
                     "render.width=64", "render.height=64"),
))

register(Scenario(
    name="hybrid",
    description="Multi-volume scene: vortex grid field + sort-first "
                "particle splats (passive tracers) composited in one "
                "frame (ops/hybrid.py)",
    overrides=("sim.kind=hybrid", "runtime.dataset=hybrid"),
    steering=tf_schedule(_tf_msgs([
        ([(0.0, 0.0), (0.2, 0.1), (1.0, 0.4)], "jet"),
    ]), period=4),
    bench_overrides=("sim.grid=[32,32,32]", "sim.num_particles=512",
                     "sim.steps_per_frame=1",
                     "render.width=64", "render.height=64"),
    brick_parity=False,   # hybrid builders ledger bricks inert
))

register(Scenario(
    name="lennard_jones",
    description="Lennard-Jones MD particle cloud (sort-first sphere "
                "splats), steered by a slow camera dolly",
    overrides=("sim.kind=lennard_jones",),
    steering=camera_dolly(0.02),
    bench_overrides=("sim.num_particles=2048", "sim.steps_per_frame=1",
                     "render.width=64", "render.height=64"),
    brick_parity=False,   # particle sessions have no volume bricks
))

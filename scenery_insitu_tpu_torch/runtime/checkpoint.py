"""Session checkpoint / resume: the simulation state, frame index, camera
pose, transfer function and the carried temporal-threshold state, so an
in-situ run can stop and resume bit for bit.

Format (the reference's ``runtime/checkpoint.py``): one ``.npz`` with a
``__header__`` JSON entry and the arrays ``sim/<name>``,
``camera/<field>``, ``tf/<field>`` and ``thr/<axis>_<sign>/<field>``
(``thr/hybrid_<axis>_<sign>/<field>`` in the hybrid mode). The sim
arrays are the sim's state: ``u``, ``v`` (Gray-Scott), ``u`` (vortex),
``pos``, ``vel``, ``box`` (the particle sims), ``u``, ``tracers``
(hybrid). A checkpoint written by either package loads in the other:
this is how a JAX session's state carries over into the port. Arrays
are copied to the host on save and placed on the session's device on
load.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from scenery_insitu_tpu_torch.convert import to_numpy
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.ops.supersegments import ThresholdState

if TYPE_CHECKING:   # pragma: no cover
    from scenery_insitu_tpu_torch.runtime.session import InSituSession

_VERSION = 1
_CAMERA_FIELDS = ("eye", "target", "up", "fov_y", "near", "far")


def _sim_arrays(sim) -> dict:
    """The state arrays of a sim adapter."""
    kind = sim.kind
    if kind == "gray_scott":
        return {"u": sim.state.u, "v": sim.state.v}
    if kind == "vortex":
        return {"u": sim.state.u}
    if kind in ("lennard_jones", "sho"):
        return {"pos": sim.state.pos, "vel": sim.state.vel,
                "box": sim.state.box}
    if kind == "hybrid":
        return {"u": sim.flow.u, "tracers": sim.tracers}
    raise ValueError(f"unknown sim kind {kind!r}")


def _restore_sim(sim, a: dict) -> None:
    """Put the state arrays ``a`` (tensors on the session's device) into
    a sim adapter."""
    kind = sim.kind
    if kind == "gray_scott":
        sim.state = sim.state._replace(u=a["u"], v=a["v"])
    elif kind == "vortex":
        sim.state = sim.state._replace(u=a["u"])
    elif kind in ("lennard_jones", "sho"):
        sim.state = sim.state._replace(pos=a["pos"], vel=a["vel"],
                                       box=a["box"])
    elif kind == "hybrid":
        sim.flow = sim.flow._replace(u=a["u"])
        sim.tracers = a["tracers"]
    else:
        raise ValueError(f"unknown sim kind {kind!r}")


def _thr_tag(regime) -> str:
    # every key part joined, so both signs of an axis keep distinct tags
    return "thr/" + "_".join(str(p) for p in regime)


def save_session(sess: "InSituSession", path: str) -> None:
    """Checkpoint a session to ``path`` (.npz)."""
    header = {
        "version": _VERSION,
        "sim_kind": sess.sim.kind,
        "mode": sess.mode,
        "engine": sess.engine,
        "temporal": bool(getattr(sess, "_temporal", False)),
        "mesh_devices": int(sess._n_ranks),
        "frame_index": sess.frame_index,
        "orbit_rate": float(sess.orbit_rate),
        "thr_regimes": sorted(sess._mxu_thr.keys()),
        "last_regime": getattr(sess, "_last_regime_key", None),
    }
    arrays = {f"sim/{k}": to_numpy(v)
              for k, v in _sim_arrays(sess.sim).items()}
    for name, val in zip(_CAMERA_FIELDS, sess.camera):
        arrays[f"camera/{name}"] = to_numpy(val)
    for name, val in zip(type(sess.tf)._fields, sess.tf):
        arrays[f"tf/{name}"] = to_numpy(val)
    for regime, thr in sess._mxu_thr.items():
        tag = _thr_tag(regime)
        for field in ThresholdState._fields:
            arrays[f"{tag}/{field}"] = to_numpy(getattr(thr, field))
    with open(path, "wb") as f:
        np.savez(f, __header__=np.frombuffer(
            json.dumps(header).encode(), np.uint8), **arrays)


def load_session(sess: "InSituSession", path: str) -> None:
    """Restore a checkpoint into a session built from the same config
    (sim kind and grid, engine, adaptive mode and mesh size must match;
    checked)."""
    dev = sess.device

    def place(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a), device=dev)

    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["version"] != _VERSION:
            raise ValueError(f"checkpoint version {header['version']} != "
                             f"{_VERSION}")
        if header["sim_kind"] != sess.sim.kind:
            raise ValueError(
                f"checkpoint sim kind {header['sim_kind']!r} does not "
                f"match session {sess.sim.kind!r}")
        if header["mode"] != sess.mode:
            raise ValueError(
                f"checkpoint mode {header['mode']!r} does not match "
                f"session {sess.mode!r}")
        # a bit-exact resume needs the same step: engine, adaptive regime
        # and mesh size all change what the resumed run computes
        for key, have in (("engine", sess.engine),
                          ("temporal", bool(getattr(sess, "_temporal",
                                                    False))),
                          ("mesh_devices", int(sess._n_ranks))):
            want = header.get(key)
            if want is not None and want != have:
                raise ValueError(
                    f"checkpoint {key}={want!r} does not match session "
                    f"{have!r} — same config required")
        sim_arrays = {k.split("/", 1)[1]: z[k]
                      for k in z.files if k.startswith("sim/")}
        for k, cur in _sim_arrays(sess.sim).items():
            if k not in sim_arrays:
                raise ValueError(f"checkpoint missing sim array {k!r}")
            if tuple(sim_arrays[k].shape) != tuple(cur.shape):
                raise ValueError(
                    f"sim array {k!r} shape {sim_arrays[k].shape} does "
                    f"not match session {tuple(cur.shape)} — same config "
                    "required")
        _restore_sim(sess.sim, {k: place(v) for k, v in sim_arrays.items()})
        sess.camera = Camera(*(place(z[f"camera/{n}"])
                               for n in _CAMERA_FIELDS))
        tf_fields = type(sess.tf)._fields
        present = [n for n in tf_fields if f"tf/{n}" in z.files]
        if present and len(present) != len(tf_fields):
            raise ValueError(
                f"checkpoint tf/ keys {present} do not match the session "
                f"TransferFunction fields {list(tf_fields)} — checkpoint "
                "and session versions differ")
        if present:
            new_tf = type(sess.tf)(*(place(z[f"tf/{n}"])
                                     for n in tf_fields))
            changed = any(not np.array_equal(to_numpy(a), to_numpy(b))
                          for a, b in zip(new_tf, sess.tf))
            sess.tf = new_tf
            if changed:
                # the steps were built around the old TF
                sess._build_steps()
        sess.frame_index = int(header["frame_index"])
        sess.orbit_rate = header["orbit_rate"]
        sess._mxu_thr = {}
        for regime in header.get("thr_regimes", []):
            regime = tuple(regime)
            tag = _thr_tag(regime)
            state = ThresholdState(*(place(z[f"{tag}/{f}"])
                                     for f in ThresholdState._fields))
            expect = _thr_shape(sess, regime)
            if expect is not None and tuple(state.thr.shape) != expect:
                raise ValueError(
                    f"threshold state for regime {regime} has shape "
                    f"{tuple(state.thr.shape)}, session expects {expect} "
                    "— same slicer/mesh config required")
            sess._mxu_thr[regime] = state
        # the regime tracker verbatim: the resumed run must make the same
        # drop/keep decisions as the uninterrupted one
        last = header.get("last_regime")
        if last is not None:
            sess._last_regime_key = tuple(last)
        elif hasattr(sess, "_last_regime_key"):
            del sess._last_regime_key


def _thr_shape(sess, regime):
    """Expected [n*nj, ni] of a regime's rank-stacked threshold maps (a
    hybrid key is ``("hybrid", axis, sign)``); None for a session without
    a slice-march VDI pass."""
    if sess.engine != "mxu" or sess.mode not in ("vdi", "hybrid"):
        return None
    n = sess._n_ranks
    axis_sign = tuple(regime[1:]) if regime[0] == "hybrid" else tuple(regime)
    spec = sess._slicer.make_spec(sess.camera, sess.sim.field.shape,
                                  sess.cfg.slicer, axis_sign=axis_sign,
                                  multiple_of=n)
    return (n * spec.nj, spec.ni)


def checkpoint_sink(directory: str, every: int = 50):
    """Session sink: checkpoint every ``every`` frames. It needs the
    session, so bind it: ``sess.sinks.append(checkpoint_sink(d).bind(
    sess))``. The file is named by the session's CURRENT frame index
    (the state it holds), which runs ahead of the payload index the sink
    fires on by the pipeline's depth plus one."""

    class _Sink:
        def __init__(self):
            self.sess = None

        def bind(self, sess):
            self.sess = sess
            return self

        def __call__(self, index: int, payload: dict) -> None:
            if self.sess is not None and every and index % every == 0:
                os.makedirs(directory, exist_ok=True)
                save_session(self.sess, os.path.join(
                    directory, f"ckpt_{self.sess.frame_index:05d}.npz"))

    return _Sink()

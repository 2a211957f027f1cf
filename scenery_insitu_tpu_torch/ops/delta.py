"""Temporal deltas of a VDI stream, in two parts.

**The P-frame wire codec (host, numpy).** The qpack8 quantizer
(``ops/wire.qpack8_quantize_np``) is monotone and deterministic, so two
frames of one tile compare exactly in code space: equal codes and an
equal [near, far] scale dequantize to the same tile bit for bit. Per
published tile, `DeltaEncoder` keeps the previous frame's code arrays
and emits one record of three modes:

- ``SKIP``: codes and scale unchanged; the record carries no payload;
- ``P``: the runs of changed code slots (start, length) and their new
  codes, chosen only when they are smaller than the full tile;
- ``I``: the full code arrays: on first contact, every
  ``iframe_period`` frames (forced, so a subscriber that joins or lost
  a record is whole again within one period), after ``reset()``, on a
  shape change, and whenever a residual would not pay.

`DeltaDecoder` mirrors the per-tile state and rebuilds the codes bit for
bit. A P or SKIP record names the generation it patches; a record whose
base is not the retained generation (a lost record broke the chain)
gives ``None``, and the decoder waits for the next I record.

**Fragment reuse (device, torch).** ``CompositeConfig.temporal_reuse =
"ranges"`` carries each rank's last marched VDI fragment across frames
(`ReuseState`) with a signature: the occupancy pyramid's per-cell
[lo, hi] value ranges followed by the camera's leaves. A rank whose
ranges moved by at most ``delta.range_tol`` under a bit-unchanged camera
skips its march and feeds the carried fragment to the exchange. The
detector sees ranges, not data: a change that keeps every cell's range
is invisible to it, and ``range_tol = 0`` with a still camera makes
reuse exact for every change it can see.

A copy of the reference's ``ops/delta.py``; the records and the counters
are the reference's, so its tests hold both packages to the same bytes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

DELTA_MODES = ("I", "P", "SKIP")

# wire cost of one changed-slot run: u32 start + u32 length
_RUN_BYTES = 8


# ------------------------------------------------ code-space residuals


def diff_runs(prev: np.ndarray, cur: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The changed-slot runs of ``cur`` against ``prev`` (same shape and
    dtype, compared flat): ``(starts u32[R], lengths u32[R], values[N])``
    with ``values`` ``cur``'s codes at the changed slots in flat order
    (``N == lengths.sum()``). Integer codes compare exactly."""
    if prev.shape != cur.shape or prev.dtype != cur.dtype:
        raise ValueError(f"delta operands disagree: {prev.shape}/"
                         f"{prev.dtype} vs {cur.shape}/{cur.dtype}")
    p, c = prev.ravel(), cur.ravel()
    changed = p != c
    idx = np.flatnonzero(changed)
    if idx.size == 0:
        return (np.zeros(0, np.uint32), np.zeros(0, np.uint32),
                np.zeros(0, cur.dtype))
    brk = np.flatnonzero(np.diff(idx) > 1)
    starts = idx[np.concatenate([[0], brk + 1])]
    ends = idx[np.concatenate([brk, [idx.size - 1]])]
    return (starts.astype(np.uint32),
            (ends - starts + 1).astype(np.uint32), c[changed])


def apply_runs(base: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
               values: np.ndarray) -> np.ndarray:
    """Inverse of `diff_runs`: ``base`` (the retained tile) patched with
    the residual, bit for bit the current tile."""
    out = base.copy().ravel()
    if starts.size:
        total = int(lengths.sum())
        if total != values.size:
            raise ValueError(f"residual says {total} changed slots but "
                             f"carries {values.size} values")
        off = np.cumsum(lengths) - lengths      # value offset of each run
        idx = (np.repeat(starts.astype(np.int64), lengths)
               + np.arange(total) - np.repeat(off.astype(np.int64),
                                              lengths))
        if idx.size and idx[-1] >= out.size:
            raise ValueError("residual run exceeds the tile extent")
        out[idx] = values
    return out.reshape(base.shape)


def runs_wire_bytes(starts: np.ndarray, values: np.ndarray) -> int:
    """Wire bytes of one residual before the codec: the (start, length)
    pairs and the changed codes."""
    return starts.size * _RUN_BYTES + values.size * values.dtype.itemsize


class DeltaRecord(NamedTuple):
    """One encoded tile, as `DeltaEncoder.encode` hands it to the
    transport (``io/vdi_io.pack_delta_blobs`` serializes it).
    ``c_payload``/``d_payload``: ``(codes,)`` for I, ``(starts, lengths,
    values)`` for P, ``()`` for SKIP. ``full_bytes``/``wire_bytes``: code
    bytes before the codec."""

    mode: str
    gen: int
    base_gen: int            # the generation this record patches (I: -1)
    c_payload: tuple
    d_payload: tuple
    scale: Tuple[float, float]
    full_bytes: int
    wire_bytes: int
    reason: str              # why this mode ("periodic", "reset", ...)


def _full_bytes(ccodes: np.ndarray, dcodes: np.ndarray) -> int:
    return ccodes.nbytes + dcodes.nbytes


class DeltaEncoder:
    """The publisher's P-frame state machine: one a stream, keyed by tile
    index (``-1`` for whole frames). Keeps the previous frame's qpack8
    codes a tile and picks SKIP, P or I a call; bumps the counters
    ``delta_tiles_skipped``, ``delta_bytes_saved`` and
    ``iframe_forced``."""

    def __init__(self, iframe_period: int = 8):
        if iframe_period < 1:
            raise ValueError(f"iframe_period must be >= 1, "
                             f"got {iframe_period}")
        self.iframe_period = int(iframe_period)
        # key -> [gen, ccodes, dcodes, (near, far), frames_since_i]
        self._state = {}
        self.stats = {"i": 0, "p": 0, "skip": 0, "forced_i": 0,
                      "bytes_full": 0, "bytes_wire": 0}
        self._reset_keys = set()

    def reset(self) -> None:
        """Scene cut: drop every retained tile, so each one's next record
        is a forced I (``reason="reset"``). A second reset before the next
        publish keeps the pending forced I's."""
        self._reset_keys |= set(self._state)
        self._state.clear()

    def _mint(self, rec: DeltaRecord) -> DeltaRecord:
        from scenery_insitu_tpu_torch import obs as _obs

        self.stats["bytes_full"] += rec.full_bytes
        self.stats["bytes_wire"] += rec.wire_bytes
        recorder = _obs.get_recorder()
        if rec.mode == "SKIP":
            self.stats["skip"] += 1
            recorder.count("delta_tiles_skipped")
        elif rec.mode == "P":
            self.stats["p"] += 1
        else:
            self.stats["i"] += 1
            if rec.reason in ("periodic", "reset"):
                self.stats["forced_i"] += 1
                recorder.count("iframe_forced")
        if rec.wire_bytes < rec.full_bytes:
            recorder.count("delta_bytes_saved",
                           rec.full_bytes - rec.wire_bytes)
        return rec

    def encode(self, key, ccodes: np.ndarray, dcodes: np.ndarray,
               near: float, far: float) -> DeltaRecord:
        """Encode one quantized tile (``ccodes`` u32, ``dcodes`` u16: the
        ``qpack8_quantize_np`` outputs) against the tile retained under
        ``key``."""
        full = _full_bytes(ccodes, dcodes)
        st = self._state.get(key)
        scale = (float(near), float(far))

        def itile(gen: int, reason: str, first: bool) -> DeltaRecord:
            # a tile's forced-I phase is staggered on first contact by
            # its index, so the tiles of one frame do not all re-ship in
            # the same frame every period (the first interval shortens,
            # the later ones are the full period)
            off = 0
            if first and isinstance(key, int) and key >= 0:
                off = key % self.iframe_period
            self._state[key] = [gen, ccodes.copy(), dcodes.copy(),
                                scale, off]
            return self._mint(DeltaRecord(
                "I", gen, -1, (ccodes,), (dcodes,), scale, full, full,
                reason))

        if st is None:
            reason = "reset" if key in self._reset_keys else "first"
            self._reset_keys.discard(key)
            return itile(1, reason, first=True)
        gen, pc, pd, pscale, since_i = st
        if ccodes.shape != pc.shape or dcodes.shape != pd.shape:
            return itile(gen + 1, "shape_change", first=False)
        if since_i + 1 >= self.iframe_period:
            return itile(gen + 1, "periodic", first=False)
        # one comparison pass: an empty residual is the SKIP decision
        cs, cl, cv = diff_runs(pc, ccodes)
        ds, dl, dv = diff_runs(pd, dcodes)
        if scale == pscale and cs.size == 0 and ds.size == 0:
            st[0] = gen + 1
            st[4] = since_i + 1
            return self._mint(DeltaRecord(
                "SKIP", gen + 1, gen, (), (), scale, full, 0, "unchanged"))
        wire = runs_wire_bytes(cs, cv) + runs_wire_bytes(ds, dv)
        if wire >= full:
            return itile(gen + 1, "dense_residual", first=False)
        self._state[key] = [gen + 1, ccodes.copy(), dcodes.copy(), scale,
                            since_i + 1]
        return self._mint(DeltaRecord(
            "P", gen + 1, gen, (cs, cl, cv), (ds, dl, dv), scale, full,
            wire, "residual"))


class DeltaDecoder:
    """The subscriber's mirror of `DeltaEncoder`: keeps the last rebuilt
    codes a tile and applies SKIP, P and I records. ``apply`` gives
    ``None`` when the record's base generation is not the retained one;
    the caller drops it and waits for the next I record."""

    def __init__(self):
        self._state = {}     # key -> [gen, ccodes, dcodes, (near, far)]
        self.stats = {"i": 0, "p": 0, "skip": 0, "resync": 0}

    def reset(self) -> None:
        """Publisher restart (a new epoch): drop every retained tile."""
        self._state.clear()

    def apply(self, key, mode: str, gen: int, base_gen: int,
              c_payload: tuple, d_payload: tuple,
              scale: Tuple[float, float]
              ) -> Optional[Tuple[np.ndarray, np.ndarray, float, float]]:
        """One record -> the rebuilt (ccodes, dcodes, near, far), equal
        bit for bit to the encoder's input, or None (resync needed)."""
        if mode == "I":
            ccodes, dcodes = c_payload[0], d_payload[0]
            self._state[key] = [gen, ccodes, dcodes, scale]
            self.stats["i"] += 1
            return ccodes, dcodes, scale[0], scale[1]
        st = self._state.get(key)
        if st is None or st[0] != base_gen:
            self.stats["resync"] += 1
            return None
        if mode == "SKIP":
            st[0] = gen
            self.stats["skip"] += 1
            ccodes, dcodes, scale = st[1], st[2], st[3]
            return ccodes, dcodes, scale[0], scale[1]
        if mode != "P":
            raise ValueError(f"unknown delta mode {mode!r}; "
                             f"have {DELTA_MODES}")
        ccodes = apply_runs(st[1], *c_payload)
        dcodes = apply_runs(st[2], *d_payload)
        self._state[key] = [gen, ccodes, dcodes, scale]
        self.stats["p"] += 1
        return ccodes, dcodes, scale[0], scale[1]


# ------------------------------------------------------- fragment reuse


class ReuseState(NamedTuple):
    """The carried state of ``temporal_reuse = "ranges"``, rank-stacked
    as the reference's: ``sig f32[n*S]`` the signature of each rank's
    last MARCHED frame (so drift under a nonzero ``range_tol``
    accumulates against it), ``color f32[n*K, 4, nj, ni]`` and ``depth
    f32[n*K, 2, nj, ni]`` each rank's last pre-exchange fragment,
    ``valid i32[n]`` 0 only in the seed (the first frame marches) and
    ``dirty i32[n]`` the last frame's decision. ``valid`` and ``dirty``
    live on the host: the step decides there, from one copy of the
    ranks' moved bits a frame, and the session's accounting reads them
    with no copy from the device."""

    sig: torch.Tensor
    color: torch.Tensor
    depth: torch.Tensor
    valid: torch.Tensor
    dirty: torch.Tensor


def reuse_signature(pyramid, cam) -> torch.Tensor:
    """A rank's flat signature: the pyramid's per-cell ``lo`` then ``hi``
    ranges (the first ``2 * pyramid.lo.numel()`` slots), then the
    camera's leaves in field order (eye, target, up, fov_y, near, far),
    all f32."""
    parts = [pyramid.lo.reshape(-1).to(torch.float32),
             pyramid.hi.reshape(-1).to(torch.float32)]
    dev = parts[0].device
    parts += [torch.as_tensor(x, dtype=torch.float32,
                              device=dev).reshape(-1) for x in cam]
    return torch.cat(parts)


def reuse_moved(sig: torch.Tensor, prev_sig: torch.Tensor,
                range_tol: float, n_ranges: int) -> torch.Tensor:
    """bool[] on the signature's device: did the range prefix move by
    more than ``range_tol`` (``0``: any difference; NaN moves), or any
    camera leaf change bit for bit?"""
    cur_r, cur_c = sig[:n_ranges], sig[n_ranges:]
    prev_r, prev_c = prev_sig[:n_ranges], prev_sig[n_ranges:]
    if range_tol > 0.0:
        moved = ~(torch.amax(torch.abs(cur_r - prev_r)) <= range_tol)
    else:
        moved = ~torch.all(cur_r == prev_r)
    return moved | ~torch.all(cur_c == prev_c)


def reuse_dirty(sig: torch.Tensor, prev_sig: torch.Tensor, valid,
                range_tol: float, n_ranges: int) -> torch.Tensor:
    """bool[]: must this rank march? True for the seed (``valid[0] ==
    0``), a moved range prefix or a changed camera (`reuse_moved`)."""
    moved = reuse_moved(sig, prev_sig, range_tol, n_ranges)
    return moved | bool(int(valid[0]) == 0)


def init_reuse_like(sig: torch.Tensor, k: int, nj: int, ni: int,
                    n: int = 1) -> ReuseState:
    """The seed carry of ``n`` ranks whose signatures are each shaped
    like ``sig`` and whose fragments are ``[k, 4|2, nj, ni]``: zeros,
    ``valid = 0``."""
    dev = sig.device
    return ReuseState(
        sig=torch.zeros((n * sig.numel(),), dtype=torch.float32,
                        device=dev),
        color=torch.zeros((n * k, 4, nj, ni), dtype=torch.float32,
                          device=dev),
        depth=torch.zeros((n * k, 2, nj, ni), dtype=torch.float32,
                          device=dev),
        valid=torch.zeros((n,), dtype=torch.int32),
        dirty=torch.zeros((n,), dtype=torch.int32))


# ----------------------------------------------------------- traffic


def modeled_delta_traffic(k: int, h: int, w: int, *,
                          skip_frac: float, p_frac: float = 0.0,
                          residual_frac: float = 0.1,
                          iframe_period: int = 8) -> dict:
    """Steady-state publish bytes a frame of ONE delta stream of ``k x h
    x w`` slots against qpack8 alone (code bytes before the codec, the
    unit `DeltaEncoder` counts). ``skip_frac``/``p_frac``: the tile
    shares that SKIP and P in steady state (the rest ship I);
    ``residual_frac``: the changed-slot share of a P tile. The forced I
    every ``iframe_period`` frames re-ships each tile once a period."""
    if not (0.0 <= skip_frac <= 1.0 and 0.0 <= p_frac <= 1.0
            and skip_frac + p_frac <= 1.0):
        raise ValueError("skip_frac/p_frac must be fractions summing "
                         "to <= 1")
    full = k * h * w * 6                       # qpack8: 6 B a slot
    # a P tile: its values (6 B a changed slot) and the runs, modelled as
    # one run a 4 changed slots
    p_tile = full * residual_frac * (1.0 + _RUN_BYTES / (6.0 * 4.0))
    steady = ((1.0 - skip_frac - p_frac) * full + p_frac * p_tile)
    forced = (skip_frac + p_frac) * full / iframe_period
    per_frame = steady + forced
    return {
        "qpack8_bytes_per_frame": full,
        "delta_bytes_per_frame": per_frame,
        "reduction_vs_qpack8": (full / per_frame if per_frame else
                                float("inf")),
        "skip_frac": skip_frac, "p_frac": p_frac,
        "residual_frac": residual_frac, "iframe_period": iframe_period,
    }

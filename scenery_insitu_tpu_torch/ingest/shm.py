"""The shared-memory frame transport: an external simulation drives the
renderer (the reference's ``ingest/shm.py``, its operator boundary).

ctypes maps the C ABI of ``native/shm_transport.cpp`` (the reference's
source, copied byte for byte): a producer publishes fixed-shape f32
frames into an N-slot ring in POSIX shared memory and never blocks; a
consumer takes the newest frame strictly newer than the last it saw and
pins its slot until it releases it. The consumer exposes a slot as a
zero-copy numpy view.

``ShmVolumeSource`` adapts a channel to the session's sim protocol
(``kind``, ``advance(n)``, ``.field``): ``.field`` is an f32 tensor on
the source's device, copied straight from the pinned slot; the slot is
released only once that copy has completed, so the producer's next
publish cannot tear the frame. ``ShmShardedVolumeSource`` feeds a mesh
from one channel per rank (z-slab order) into one ``f32[n, D/n, H, W]``
tensor, the layout ``parallel/mesh.shard_volume`` gives. Both mark a
silent producer as a stall (the ``ingest.stall`` ledger row, the
``ingest_stalls`` and ``ingest_stall_recoveries`` counters and the
``ingest_recovered`` event) and keep rendering the last good frame.

The native sources are built with ``g++`` at first use into
``build/torch_native/`` at the repository root (listed in
``.gitignore``); each artifact's name carries a hash of its sources and
flags, so an edited source is never served a stale build. The demo
producer is linked with the transport's source into one executable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.device import resolve_device

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "torch_native")
# the reference Makefile's flags; -lrt: glibc < 2.34 keeps shm_open and
# shm_unlink in librt (a stub on newer glibc)
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")
# artifact -> (sources, flags before the output, flags after the sources)
NATIVE = {
    "libshm_transport.so": (("shm_transport.cpp",), ("-shared",),
                            ("-lrt",)),
    "liblz4block.so": (("lz4_block.cpp",), ("-shared",), ()),
    "demo_producer": (("demo_producer.cpp", "shm_transport.cpp"), (),
                      ("-lrt",)),
}

_lib = None


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the shared-memory transport, the "
                           "demo producer and the LZ4 codec are built from "
                           "ingest/native/*.cpp with g++")
    return gxx


def native_path(name: str) -> str:
    """Where artifact ``name`` of `NATIVE` is built: its file name carries
    a hash of its sources and flags."""
    sources, pre, post = NATIVE[name]
    h = hashlib.sha256()
    for src in sources:
        with open(os.path.join(NATIVE_DIR, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS + pre + post).encode())
    stem, ext = os.path.splitext(name)
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}{ext}")


def ensure_built(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build every missing artifact of ``names`` (default: all), one
    ``g++`` each, all started together; returns name -> path. Raises
    with the compiler's output when a build fails, and naming ``g++``
    when it is missing."""
    names = tuple(NATIVE if names is None else names)
    paths = {n: native_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if todo:
        gxx = _gxx()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for n in todo:
            sources, pre, post = NATIVE[n]
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            cmd = [gxx, *CXX_FLAGS, *pre, "-o", tmp,
                   *(os.path.join(NATIVE_DIR, s) for s in sources), *post]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for n, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"g++ failed for {n} (exit {p.returncode}):"
                              f"\n{log.decode()}")
            else:
                os.replace(tmp, paths[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def demo_producer() -> str:
    """The demo simulation producer's executable (built at first use):
    ``demo_producer <channel> <field|particles|slab> <size> <frames>
    [period_ms=5] [rank=0] [nranks=1]``."""
    return ensure_built(["demo_producer"])["demo_producer"]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built(["libshm_transport.so"])[
        "libshm_transport.so"])
    P, U64, U32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32
    sig = {
        "shm_channel_create": (P, [ctypes.c_char_p, U64, U32]),
        "shm_producer_acquire": (P, [P]),
        "shm_producer_publish": (U64, [P]),
        "shm_channel_frames_dropped": (U64, [P]),
        "shm_consumer_open": (P, [ctypes.c_char_p]),
        "shm_channel_slot_size": (U64, [P]),
        "shm_channel_nslots": (U32, [P]),
        "shm_consumer_latest": (ctypes.c_int32,
                                [P, ctypes.c_int64, ctypes.POINTER(P),
                                 ctypes.POINTER(U64)]),
        "shm_consumer_release": (None, [P, ctypes.c_int32]),
        "shm_channel_close": (None, [P]),
        "shm_channel_unlink": (ctypes.c_int, [ctypes.c_char_p]),
        "shm_channel_stats": (U32, [P, ctypes.POINTER(U64), U32]),
        "shm_channel_reset_readers": (U32, [P]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def _open(channel: str):
    lib = _load()
    h = lib.shm_consumer_open(channel.encode())
    if not h:
        raise FileNotFoundError(f"no shm channel {channel!r}")
    return lib, h


def channel_stats(channel: str) -> dict:
    """A live channel's control block: slot count and bytes, the last
    sequence number, the latest slot (-1: none), waiters, whether a
    writer is attached, frames dropped, and each slot's reader pins and
    sequence number. Raises FileNotFoundError if the channel does not
    exist."""
    lib, h = _open(channel)
    try:
        need = 7 + 2 * int(lib.shm_channel_nslots(h))
        buf = (ctypes.c_uint64 * need)()
        n = lib.shm_channel_stats(h, buf, need)
        if n == 0:
            raise OSError(f"shm_channel_stats returned no data for "
                          f"{channel!r} (buffer of {need} u64)")
        vals = [int(x) for x in buf[:n]]
        return {
            "channel": channel, "nslots": vals[0], "slot_bytes": vals[1],
            "last_seq": vals[2], "latest_slot": vals[3] - 1,
            "waiters": vals[4], "writer_attached": bool(vals[5]),
            "frames_dropped": vals[6],
            "slots": [{"readers": vals[7 + 2 * i], "seq": vals[8 + 2 * i]}
                      for i in range(vals[0])],
        }
    finally:
        lib.shm_channel_close(h)


def reset_readers(channel: str) -> int:
    """Clear the reader pins crashed consumers left behind; returns how
    many were cleared."""
    lib, h = _open(channel)
    try:
        return int(lib.shm_channel_reset_readers(h))
    finally:
        lib.shm_channel_close(h)


def unlink(channel: str) -> bool:
    """Remove a channel from the namespace (open handles keep their
    maps)."""
    return _load().shm_channel_unlink(channel.encode()) == 0


class ShmProducer:
    """Publish fixed-shape f32 frames (the simulation's side)."""

    def __init__(self, channel: str, shape: Sequence[int], nslots: int = 3):
        self.lib = _load()
        self.shape = tuple(int(s) for s in shape)
        self.nbytes = int(np.prod(self.shape)) * 4
        self.channel = channel
        self.handle = self.lib.shm_channel_create(channel.encode(),
                                                  self.nbytes, nslots)
        if not self.handle:
            raise OSError(f"could not create shm channel {channel!r}")

    def publish(self, frame: np.ndarray) -> int:
        """Copy one frame in and publish it; returns its sequence number,
        or 0 when it was dropped because readers pinned every writable
        slot (the producer never blocks)."""
        frame = np.ascontiguousarray(frame, np.float32)
        if frame.shape != self.shape:
            raise ValueError(f"frame shape {frame.shape} != {self.shape}")
        ptr = self.lib.shm_producer_acquire(self.handle)
        if not ptr:
            return 0
        ctypes.memmove(ptr, frame.ctypes.data, self.nbytes)
        return int(self.lib.shm_producer_publish(self.handle))

    @property
    def frames_dropped(self) -> int:
        return int(self.lib.shm_channel_frames_dropped(self.handle))

    def close(self, unlink: bool = True) -> None:
        if self.handle:
            self.lib.shm_channel_close(self.handle)
            self.handle = None
            if unlink:
                self.lib.shm_channel_unlink(self.channel.encode())


class _Pinned(np.ndarray):
    """A read-only view of a pinned slot; ``.slot`` is what to release."""


class ShmConsumer:
    """Receive frames (the renderer's side). Waits up to ``timeout_ms``
    for the producer to create the channel."""

    def __init__(self, channel: str, shape: Sequence[int],
                 timeout_ms: int = 5000, poll_interval_ms: int = 20):
        self.lib = _load()
        self.channel = channel
        self.shape = tuple(int(s) for s in shape)
        deadline = time.monotonic() + timeout_ms / 1000.0
        self.handle = None
        while True:
            self.handle = self.lib.shm_consumer_open(channel.encode())
            if self.handle or time.monotonic() >= deadline:
                break
            time.sleep(poll_interval_ms / 1000.0)
        if not self.handle:
            raise TimeoutError(f"shm channel {channel!r} never appeared")
        slot = int(self.lib.shm_channel_slot_size(self.handle))
        want = int(np.prod(self.shape)) * 4
        if slot != want:
            self.close()
            raise ValueError(f"channel slot size {slot} != expected {want}")

    def _latest_view(self, timeout_ms: int
                     ) -> Optional[Tuple[np.ndarray, int, int]]:
        """(writable view of the pinned slot, seq, slot), or None on
        timeout. The caller releases the slot."""
        data = ctypes.c_void_p()
        seq = ctypes.c_uint64()
        idx = self.lib.shm_consumer_latest(self.handle, timeout_ms,
                                           ctypes.byref(data),
                                           ctypes.byref(seq))
        if idx < 0:
            return None
        buf = (ctypes.c_float * int(np.prod(self.shape))).from_address(
            data.value)
        return (np.frombuffer(buf, np.float32).reshape(self.shape),
                int(seq.value), int(idx))

    def latest(self, timeout_ms: int = -1, copy: bool = True
               ) -> Optional[Tuple[np.ndarray, int]]:
        """The newest frame strictly newer than the last one seen, with
        its sequence number, or None on timeout (0: poll once, < 0: wait
        forever). ``copy=False`` returns the zero-copy view and keeps its
        slot pinned: call ``release(view.slot)`` when done with it."""
        got = self._latest_view(timeout_ms)
        if got is None:
            return None
        view, seq, idx = got
        if copy:
            out = view.copy()
            self.release(idx)
            return out, seq
        pinned = view.view(_Pinned)
        pinned.flags.writeable = False
        pinned.slot = idx
        return pinned, seq

    def release(self, slot: int) -> None:
        self.lib.shm_consumer_release(self.handle, slot)

    def close(self) -> None:
        if self.handle:
            self.lib.shm_channel_close(self.handle)
            self.handle = None


def _copy_stream(device: torch.device):
    """A side stream for a source's copies on a card (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _upload(views: List[np.ndarray], device: torch.device,
            side) -> torch.Tensor:
    """Copy host frames (slot views) into one new f32 tensor
    ``[len(views), *shape]`` on ``device`` and return it once the copy
    has read them: the caller may release their slots then. On a card
    the copy runs on the side stream ``side``, the host waits for its
    event alone (not for the frames in flight), and the current stream
    waits for it before it reads the tensor."""
    shape = (len(views),) + tuple(views[0].shape)
    if side is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
        for i, v in enumerate(views):
            out[i].copy_(torch.from_numpy(v))
        return out
    main = torch.cuda.current_stream(device)
    with torch.cuda.stream(side):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        for i, v in enumerate(views):
            out[i].copy_(torch.from_numpy(v))
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    main.wait_event(done)
    out.record_stream(main)
    return out


def _stall(frame_timeout_ms: int, what: str) -> None:
    _obs.get_recorder().count("ingest_stalls")
    _obs.degrade("ingest.stall", "live producer frames",
                 "re-rendering last-good frame",
                 f"no strictly-newer {what} within frame_timeout_ms="
                 f"{frame_timeout_ms}; a producer stalled or died",
                 warn=False)


class ShmVolumeSource:
    """The session's sim adapter over one shm channel: ``advance(n)``
    takes the newest frame (the first call waits up to ``timeout_ms``
    for one), ``.field`` is it as an f32 tensor on ``device`` (None:
    CUDA), or the host array with ``device_put=False``.

    Stall supervision: when no strictly-newer frame arrives within
    ``frame_timeout_ms`` (default ``timeout_ms``) the source marks itself
    stalled (once an episode: the ``ingest.stall`` ledger row and the
    ``ingest_stalls`` counter) and keeps rendering the last good frame;
    while stalled, ``advance`` polls without blocking. Frames resuming
    clear the stall (``ingest_stall_recoveries``, ``ingest_recovered``).
    ``upload_ms`` holds each copy to the device, host clock, with its
    wait for completion."""

    def __init__(self, channel: str, grid: Sequence[int],
                 timeout_ms: int = 10000, device_put: bool = True,
                 frame_timeout_ms: Optional[int] = None, device=None):
        self.kind = "external"
        self.device = resolve_device(device)
        self._side = _copy_stream(self.device)
        self.consumer = ShmConsumer(channel, grid, timeout_ms=timeout_ms)
        self.timeout_ms = timeout_ms
        self.frame_timeout_ms = (timeout_ms if frame_timeout_ms is None
                                 else frame_timeout_ms)
        self._device_put = device_put
        self._field = None
        self.stalled = False
        self.stall_count = 0
        self.last_seq: Optional[int] = None
        self.frames = 0
        self.upload_ms: List[float] = []

    def advance(self, n: int = 1) -> None:   # n means nothing here
        wait = (self.timeout_ms if self._field is None
                else 0 if self.stalled else self.frame_timeout_ms)
        got = self.consumer._latest_view(wait)
        if got is None:
            if self._field is None:
                raise TimeoutError("no frame from the external simulation "
                                   f"on {self.consumer.channel!r}")
            if not self.stalled:
                self.stalled = True
                self.stall_count += 1
                _stall(self.frame_timeout_ms, "shm frame")
            return
        view, seq, slot = got
        try:
            if self._device_put:
                t0 = time.perf_counter()
                field = _upload([view], self.device, self._side)[0]
                self.upload_ms.append((time.perf_counter() - t0) * 1e3)
            else:
                field = view.copy()
        finally:
            self.consumer.release(slot)     # the copy has read the slot
        if self.stalled:
            self.stalled = False
            _obs.get_recorder().count("ingest_stall_recoveries")
            _obs.get_recorder().event("ingest_recovered", seq=seq)
        self.last_seq = seq
        self.frames += 1
        self._field = field

    @property
    def field(self):
        if self._field is None:
            self.advance(1)
        return self._field

    def close(self) -> None:
        self.consumer.close()


class ShmShardedVolumeSource:
    """A mesh's external feed: one shm channel per rank (z-slab order,
    each ``slab_shape`` = ``[D/n, H, W]``), copied straight from the
    pinned slots into one ``f32[n, D/n, H, W]`` tensor on the mesh's
    device (``shard_volume``'s layout); ``.field`` is its ``[D, H, W]``
    view, so the session's ``shard_volume`` is a reshape.

    ``coherent=True`` (default) assembles only frame sets whose ranks'
    sequence numbers match: the renderer never mixes timesteps across
    slabs (lockstep producers; ``coherent=False`` takes whatever each
    rank last delivered). Before the first set a timeout raises naming
    the ranks' sequence numbers; after it ``advance`` waits up to
    ``frame_timeout_ms`` (default ``timeout_ms``) for a strictly newer
    set, then stalls onto the last one as `ShmVolumeSource` does.
    ``timeout_ms`` bounds the channels' appearance and the first set."""

    def __init__(self, channels: Sequence[str], slab_shape: Sequence[int],
                 mesh, timeout_ms: int = 10000, coherent: bool = True,
                 poll_interval_ms: int = 5,
                 frame_timeout_ms: Optional[int] = None):
        if mesh.spans_processes:
            from scenery_insitu_tpu_torch.parallel.pipeline import (
                _PROCESS_SCOPE)

            raise NotImplementedError(_PROCESS_SCOPE.format(
                what="the sharded shm feed"))
        self.kind = "external"
        n = mesh.n
        if len(channels) != n:
            raise ValueError(f"{len(channels)} channels for a mesh of {n} "
                             "ranks: one channel per rank, z order")
        self.channels = list(channels)
        self.device = mesh.device
        self._side = _copy_stream(self.device)
        self.slab_shape = tuple(int(s) for s in slab_shape)
        self.global_shape = ((self.slab_shape[0] * n,)
                             + self.slab_shape[1:])
        self.timeout_ms = timeout_ms
        self.frame_timeout_ms = (timeout_ms if frame_timeout_ms is None
                                 else frame_timeout_ms)
        self.coherent = coherent
        self.poll_interval_ms = poll_interval_ms
        self.consumers = [ShmConsumer(c, self.slab_shape,
                                      timeout_ms=timeout_ms)
                          for c in channels]
        self._held: List[Optional[Tuple[np.ndarray, int, int]]] = [None] * n
        self._slabs: Optional[torch.Tensor] = None
        self.last_seqs: Tuple[int, ...] = ()
        self.stalled = False
        self.frames = 0
        self.upload_ms: List[float] = []

    def _refresh(self, wait_ms: int) -> None:
        for r, con in enumerate(self.consumers):
            got = con._latest_view(wait_ms)
            if got is not None:
                if self._held[r] is not None:
                    con.release(self._held[r][2])
                self._held[r] = got

    def _aligned(self) -> bool:
        if any(h is None for h in self._held):
            return False
        return not self.coherent or len({h[1] for h in self._held}) == 1

    def advance(self, n: int = 1) -> None:   # n means nothing here
        wait_ms = (self.timeout_ms if self._slabs is None
                   else 0 if self.stalled else self.frame_timeout_ms)
        deadline = time.monotonic() + wait_ms / 1000.0
        first = True
        while True:
            # the first pass polls; later ones wait a poll interval
            self._refresh(0 if first else self.poll_interval_ms)
            first = False
            # only a strictly newer aligned set ends the wait
            if self._aligned():
                seqs = tuple(h[1] for h in self._held)
                if seqs != self.last_seqs:
                    t0 = time.perf_counter()
                    self._slabs = _upload([h[0] for h in self._held],
                                          self.device, self._side)
                    self.upload_ms.append((time.perf_counter() - t0) * 1e3)
                    self.last_seqs = seqs
                    self.frames += 1
                    if self.stalled:
                        self.stalled = False
                        _obs.get_recorder().count("ingest_stall_recoveries")
                        _obs.get_recorder().event(
                            "ingest_recovered", seqs=list(seqs))
                    return
            if time.monotonic() > deadline:
                if self._slabs is not None:
                    if not self.stalled:
                        self.stalled = True
                        _stall(self.frame_timeout_ms,
                               "coherent shm frame set")
                    return
                held = [None if h is None else h[1] for h in self._held]
                raise TimeoutError(
                    f"no {'coherent ' if self.coherent else ''}frame set "
                    f"from {self.channels} within {wait_ms} ms (per-rank "
                    f"seqs: {held})")

    @property
    def slabs(self) -> torch.Tensor:
        """The assembled ``f32[n, D/n, H, W]`` tensor."""
        if self._slabs is None:
            self.advance(1)
        return self._slabs

    @property
    def field(self) -> torch.Tensor:
        return self.slabs.view(self.global_shape)

    def stats(self) -> list:
        """Each rank's channel control block."""
        return [channel_stats(c) for c in self.channels]

    def close(self) -> None:
        for con, h in zip(self.consumers, self._held):
            if h is not None and con.handle:
                con.release(h[2])
            con.close()
        self._held = [None] * len(self.consumers)

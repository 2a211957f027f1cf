"""The multi-process fleet: the reference's 8-node MPI deployment shape
(one renderer a node, MPI between the nodes) on ``torch.distributed``,
the twin of the reference's ``parallel/multihost.py``.

- `initialize` is MPI_Init: process 0 hosts a ``TCPStore`` at the
  coordinator address and every process joins one process group over
  it, on the backend the caller names: ``"nccl"`` where each process
  has its own card, ``"gloo"`` for CPU processes and for several
  processes sharing one card (NCCL refuses two ranks on one card).
- The host plane: the store's key-value pairs (`kv_put_bytes`,
  `kv_get_bytes`), named barriers (`barrier`), and `_allgather_blobs`,
  the variable-length blob allgather under the compressed VDI gather
  (`gather_vdi_tiles`, `gather_vdi_compressed`) and the obs-event merge
  (`gather_obs_events`).
- The process mesh: `global_mesh` is the 1-D compositing mesh over every
  process's ranks (``parallel/mesh.Mesh`` with this process's first
  global rank and its rank count), and `shard_global` places this
  process's slabs on it; the global volume never lives in one process.
  ``parallel/pipeline.py`` runs its gather-engine step and its MXU
  steps on such a mesh, flat on even slabs: each process marches its
  own ranks; the all_to_all exchange is one ``all_to_all_single``
  (`all_to_all`), the ring one message a process pair a hop
  (`ring_hop`), the K budget's live fractions one `all_gather`; the
  halo's seam slices cross process boundaries point to point
  (`neighbour_slices`). A block on the bf16 or qpack8 wire travels as
  one ``uint8`` view of its encoded tensors with its scale, so no
  collective sees those dtypes and the exchange is bit-exact.

A CUDA tensor given to a collective of a group whose backend is not
NCCL crosses through an explicit host copy (the NCCL branch, one
process a card, takes it on the card; it is written the same way but
unchecked, since NCCL refuses two ranks on one card); `wire_bytes`
counts those copies and the bytes each process sent and received, in
all and by collective.

Smoke test (one machine, 2 processes, 2 ranks each):

    python -m scenery_insitu_tpu_torch.parallel.multihost --launch 2 \\
        [--device cpu]

Each worker runs one ``distributed_vdi_step`` over the 4-rank process
mesh (``MULTIHOST_OK norm=...``), the temporal MXU chain (the threshold
seed and two carried-state frames, ``MULTIHOST_MXU_OK norm=...``), the
compressed host gather (``MULTIHOST_GATHER_OK`` on process 0) and the
host path of the two-level composite (``MULTIHOST_HIER_OK`` on process
0, its frame equal to the gathered one). The launcher prints
``LAUNCH_OK`` when every worker succeeded and the norms agree to 4
decimals, else ``LAUNCH_FAILED``, and exits 0 or 1. The workers run on
gloo, on the CPU or all on one card.
"""

from __future__ import annotations

import collections
import datetime
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.parallel.mesh import DEFAULT_AXIS, Mesh

# the live fleet of this process: the store, this process's place in
# it, the backend and the device its ranks run on
_STATE: dict = {}
_KV_AG_SEQ = [0]          # collective call counter (same order everywhere)
_KV_SENT: dict = {}       # this process's blob length by call, two back
_BARRIERS: collections.Counter = collections.Counter()
_WIRE: collections.Counter = collections.Counter()
# the bound of every collective of the group: a worker that dies leaves
# its peers waiting this long
_COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, timeout_s: float = 300.0,
               attempt_timeout_s: float = 60.0, fault=None,
               backend: str = "gloo", device=None) -> None:
    """MPI_Init: join the fleet of ``num_processes`` processes whose
    coordinator (process 0) hosts the key-value store at
    ``coordinator_address`` (``host:port``).

    Wrapped in the bounded-backoff ladder of ``utils/retry.Backoff``: a
    coordinator that is still starting or a peer not yet scheduled does
    not hang the fleet silently. Each attempt gets ``attempt_timeout_s``,
    every retry lands on the fallback ledger as ``multihost.connect``,
    and the ladder raises a ``RuntimeError`` naming the process and the
    address once ``timeout_s`` has run out. ``fault`` (a
    ``config.FaultConfig``) supplies the backoff base and cap; None uses
    the retry defaults. ``device`` is where this process's ranks run
    (None means CUDA and raises without a card); under ``"nccl"`` a
    device without an index becomes the card ``process_id`` modulo the
    card count."""
    import torch.distributed as dist

    from scenery_insitu_tpu_torch.utils.retry import Backoff

    dev = resolve_device(device)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device; CPU "
                             "processes run gloo")
        if dev.index is None:
            dev = torch.device("cuda",
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    host, _, port = coordinator_address.rpartition(":")
    bo = (Backoff(fault.backoff_base_s, fault.backoff_cap_s)
          if fault is not None else Backoff())
    deadline = time.monotonic() + timeout_s
    attempt = 0
    while True:
        budget = deadline - time.monotonic()
        t = datetime.timedelta(seconds=max(1.0, min(attempt_timeout_s,
                                                    max(budget, 1.0))))
        try:
            store = dist.TCPStore(host, int(port), num_processes,
                                  is_master=process_id == 0, timeout=t,
                                  wait_for_workers=False)
            dist.init_process_group(
                backend, store=store, world_size=num_processes,
                rank=process_id, timeout=_COLLECTIVE_TIMEOUT)
            break
        except Exception as e:
            if dist.is_initialized():     # drop a half-built group
                dist.destroy_process_group()
            attempt += 1
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    f"multihost.initialize: process {process_id} could "
                    f"not reach the coordinator at {coordinator_address} "
                    f"within {timeout_s:.0f}s ({attempt} attempts)") from e
            _obs.degrade("multihost.connect", "first-attempt connect",
                         f"retry (attempt {attempt})",
                         f"{type(e).__name__}: {e}", warn=False)
            time.sleep(min(bo.next_delay(), max(0.0, remaining)))
    _STATE.update(store=store, pid=process_id, nproc=num_processes,
                  backend=backend, device=dev)
    _KV_AG_SEQ[0] = 0
    _KV_SENT.clear()
    _BARRIERS.clear()


def shutdown() -> None:
    """Leave the fleet: destroy the process group and drop the store."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def process_index() -> int:
    """This process's place in the fleet; 0 without one."""
    return _STATE.get("pid", 0)


def process_count() -> int:
    """The processes of the fleet; 1 without one."""
    return _STATE.get("nproc", 1)


def _store():
    """The coordinator's key-value store every process holds: the
    host-side side channel (endpoint exchange, barriers, the blob
    allgather's store transport)."""
    store = _STATE.get("store")
    if store is None:
        raise RuntimeError("multihost.initialize has not run: the "
                           "coordinator's store exists only in a fleet")
    return store


# the store refuses a value above 8 MiB, far below a frame's column
# block, so a blob goes in parts of this size: its later parts under
# ``key/<i>``, then its first part under ``key`` behind the part count
# (set last, so a reader who sees ``key`` finds every part)
_KV_PART = 4 << 20


def _kv_parts(nbytes: int) -> int:
    return max(1, -(-nbytes // _KV_PART))


def kv_put_bytes(key: str, value: bytes) -> None:
    """Publish a blob under ``key`` in the coordinator's store."""
    store = _store()
    n = _kv_parts(len(value))
    for i in range(1, n):
        store.set(f"{key}/{i}", value[i * _KV_PART:(i + 1) * _KV_PART])
    store.set(key, n.to_bytes(4, "little") + value[:_KV_PART])


def kv_get_bytes(key: str, timeout_ms: int = 60_000) -> bytes:
    """Blocking fetch of a `kv_put_bytes` blob: waits up to
    ``timeout_ms`` for the key."""
    store = _store()
    store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
    head = store.get(key)
    n = int.from_bytes(head[:4], "little")
    return b"".join([head[4:]] + [store.get(f"{key}/{i}")
                                  for i in range(1, n)])


def _kv_delete(key: str, nbytes: int) -> None:
    """Retire a `kv_put_bytes` blob of ``nbytes`` bytes, every part."""
    store = _store()
    store.delete_key(key)
    for i in range(1, _kv_parts(nbytes)):
        store.delete_key(f"{key}/{i}")


def barrier(name: str, timeout_ms: int = 60_000) -> None:
    """Every process waits here until all have arrived (MPI_Barrier on
    the host plane; no collective of the process group). A store has no
    named barrier, so each arrival adds one to the name's counter and
    the last one sets its release key; a name may be reused, each use a
    generation of its own (every process passes its barriers in the same
    order)."""
    store = _store()
    _BARRIERS[name] += 1
    key = f"sitpu/barrier/{name}/{_BARRIERS[name]}"
    if store.add(key, 1) == process_count():
        store.set(key + "/go", b"1")
    store.wait([key + "/go"], datetime.timedelta(milliseconds=timeout_ms))


# ------------------------------------------------- tensors over the group


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the group's collectives take it: a CUDA tensor crosses a
    backend other than NCCL through an explicit host copy (counted)."""
    if x.device.type == "cuda" and _STATE.get("backend") != "nccl":
        _WIRE["host_copy_bytes"] += x.numel() * x.element_size()
        return x.cpu()
    return x


def _unwire(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if x.device != device:
        _WIRE["host_copy_bytes"] += x.numel() * x.element_size()
        return x.to(device)
    return x


def _count(op: str, sent: int, received: int) -> None:
    """Add one collective's bytes to other processes (``sent``) and from
    them (``received``) to the totals and to ``op``'s own."""
    _WIRE["sent_bytes"] += sent
    _WIRE["received_bytes"] += received
    _WIRE[f"{op}_sent_bytes"] += sent


def wire_bytes() -> dict:
    """Bytes this process moved through the group since the last
    `reset_wire_bytes`: ``sent``, ``received`` (other processes' blocks
    only), ``host_copy`` (both directions of the host copies) and
    ``by_op``, the bytes sent by each collective (``all_to_all``,
    ``all_gather``, ``ring``, ``neighbours``)."""
    ops = ("all_to_all", "all_gather", "ring", "neighbours")
    return {"sent": _WIRE["sent_bytes"], "received": _WIRE["received_bytes"],
            "host_copy": _WIRE["host_copy_bytes"],
            "by_op": {op: _WIRE[f"{op}_sent_bytes"] for op in ops}}


def reset_wire_bytes() -> None:
    _WIRE.clear()


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The all_to_all of the process group: ``x [P, ...]`` holds block
    p for process p; returns ``[P, ...]`` holding block p from process
    p, on ``x``'s device."""
    import torch.distributed as dist

    wire = _wire(x.contiguous())
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    others = (x.shape[0] - 1) * wire[0].numel() * wire.element_size()
    _count("all_to_all", others, others)
    return _unwire(out, x.device)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The all_gather of a small tensor over a process ``mesh``: ``x
    [n_local, ...]`` holds this process's ranks' values; returns ``[n,
    ...]``, every rank's in global rank order (process p holds ranks
    ``p * n_local ..``), on ``x``'s device. Without a process mesh it is
    ``x`` itself."""
    if not mesh.spans_processes:
        return x
    import torch.distributed as dist

    wire = _wire(x.contiguous())
    parts = [torch.empty_like(wire) for _ in range(mesh.n // mesh.n_local)]
    dist.all_gather(parts, wire, group=mesh.group)
    nbytes = wire.numel() * wire.element_size()
    _count("all_gather", (len(parts) - 1) * nbytes,
           (len(parts) - 1) * nbytes)
    return _unwire(torch.cat(parts), x.device)


def ring_hop(send, s: int, mesh: Mesh, pack, unpack):
    """Hop ``s`` of the ring over a process ``mesh``: ``send[q - first]``
    is the block that this process's rank q addresses to rank ``(q - s)
    mod n``; returns, for every local rank r, the block that rank ``(r +
    s) mod n`` addressed to it. A peer in this process hands its block
    over by reference. A block bound for another process is packed
    (``pack(block)``: ``uint8[m]``, every block of one size); the blocks
    between two processes travel as one message a process pair
    (`dist.batch_isend_irecv`), in ascending destination rank, and each
    is unpacked on receipt (``unpack(uint8[m])``)."""
    n, first, nl = mesh.n, mesh.first_rank, mesh.n_local
    out = [None] * nl
    to_proc, from_proc = {}, {}
    for ql in range(nl):
        r = (first + ql - s) % n
        if first <= r < first + nl:
            out[r - first] = send[ql]
        else:
            to_proc.setdefault(r // nl, []).append((r, send[ql]))
    for rl in range(nl):
        q = (first + rl + s) % n
        if not first <= q < first + nl:
            from_proc.setdefault(q // nl, []).append(rl)
    if not to_proc and not from_proc:
        return out
    import torch.distributed as dist

    ops, bufs, sent, m, dev = [], {}, 0, None, None
    for p, items in sorted(to_proc.items()):
        items.sort(key=lambda it: it[0])
        packed = [pack(b) for _, b in items]
        m, dev = packed[0].numel(), packed[0].device
        buf = _wire(torch.cat(packed))
        ops.append(dist.P2POp(dist.isend, buf, p, mesh.group))
        sent += buf.numel()
    for p, rls in sorted(from_proc.items()):
        bufs[p] = torch.empty(len(rls) * m, dtype=torch.uint8,
                              device=dev if _STATE.get("backend") == "nccl"
                              else "cpu")
        ops.append(dist.P2POp(dist.irecv, bufs[p], p, mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    got = 0
    for p, rls in from_proc.items():
        buf = _unwire(bufs[p], dev)
        got += buf.numel()
        for i, rl in enumerate(rls):
            out[rl] = unpack(buf[i * m:(i + 1) * m])
    _count("ring", sent, got)
    return out


def neighbour_slices(first: torch.Tensor, last: torch.Tensor, group=None
                     ) -> Tuple[Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """The seam exchange of the z decomposition: this process sends
    ``first`` (its lowest rows) to the previous process and ``last`` (its
    highest) to the next, point to point. Returns (the previous
    process's ``last``, the next process's ``first``), None at the
    global edges."""
    import torch.distributed as dist

    p, nproc = dist.get_rank(group), dist.get_world_size(group)
    wf, wl = _wire(first.contiguous()), _wire(last.contiguous())
    ops, prev, nxt = [], None, None
    if p > 0:
        prev = torch.empty_like(wl)
        ops += [dist.P2POp(dist.irecv, prev, p - 1, group),
                dist.P2POp(dist.isend, wf, p - 1, group)]
        _count("neighbours", wf.numel() * wf.element_size(),
               wl.numel() * wl.element_size())
    if p < nproc - 1:
        nxt = torch.empty_like(wf)
        ops += [dist.P2POp(dist.irecv, nxt, p + 1, group),
                dist.P2POp(dist.isend, wl, p + 1, group)]
        _count("neighbours", wl.numel() * wl.element_size(),
               wf.numel() * wf.element_size())
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return (None if prev is None else _unwire(prev, first.device),
            None if nxt is None else _unwire(nxt, last.device))


def all_sum(value: float) -> float:
    """Sum a host float over every process (f64; the value itself
    without a fleet)."""
    if process_count() == 1:
        return float(value)
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t.item())


# ------------------------------------------------------------ process mesh


def global_mesh(ranks_per_process: int, device=None,
                axis_name: str = DEFAULT_AXIS) -> Mesh:
    """The 1-D compositing mesh over every process's ranks (call after
    `initialize`): ``ranks_per_process`` consecutive global ranks a
    process, this process's from ``process_index() *
    ranks_per_process``, on ``device`` (None: the fleet's device, or CUDA
    without a fleet, which raises without a card). Without a fleet it is
    the in-process mesh of ``ranks_per_process`` ranks."""
    if ranks_per_process < 1:
        raise ValueError(f"a process holds at least one rank, got "
                         f"{ranks_per_process}")
    dev = resolve_device(_STATE.get("device") if device is None
                         else device)
    nproc = process_count()
    return Mesh(nproc * ranks_per_process, dev, (axis_name,),
                first_rank=process_index() * ranks_per_process,
                local_ranks=ranks_per_process)


def shard_global(local_block, mesh: Mesh) -> torch.Tensor:
    """This process's slabs on the process mesh from its contiguous
    z block ``f32[n_local * D/n, H, W]`` (the in-situ case: every node's
    simulation produces its own slab; no process holds the whole
    volume): ``f32[n_local, D/n, H, W]`` on the mesh's device."""
    block = torch.as_tensor(local_block, device=mesh.device)
    nl = mesh.n_local
    if block.shape[0] % nl:
        raise ValueError(f"local block depth {block.shape[0]} not "
                         f"divisible by this process's {nl} ranks")
    return block.reshape((nl, block.shape[0] // nl)
                         + tuple(block.shape[1:])).contiguous()


# ------------------------------------------------------ the blob allgather


def _device_collectives_ok() -> bool:
    """Does the blob allgather ride the process group? In a one-process
    world, or where the group is NCCL; a gloo group takes the store, as
    the reference's multi-process CPU runs do."""
    return process_count() == 1 or _STATE.get("backend") == "nccl"


def _allgather_blobs(blob: bytes, timeout_ms: int = 120_000,
                     transport: Optional[str] = None):
    """Allgather of one variable-length blob a process: returns (blobs
    uint8[P, 1, maxlen], lengths int64[P, 1]), the shared transport of
    the compressed VDI gather and the obs-event merge. Every byte is
    counted on the ``dcn_bytes_sent`` / ``dcn_bytes_received`` obs
    counters and the hop spans as ``dcn_allgather`` with its
    ``transport``.

    ``"device"``: two allgathers over the process group, the lengths and
    the blobs padded to the longest (on the card under NCCL, on the
    host under gloo). ``"kv"``: the coordinator's store, each blob under
    ``sitpu/ag/<seq>/<pid>``, each process retiring its own blob of two
    calls back. None picks as the reference does
    (`_device_collectives_ok`), a store route going on the ledger as
    ``multihost.transport``."""
    rec = _obs.get_recorder()
    rec.count("dcn_bytes_sent", len(blob))
    nproc, pid = process_count(), process_index()
    if transport is None:
        transport = "device" if _device_collectives_ok() else "kv"
        if transport == "kv":
            _obs.degrade(
                "multihost.transport", "device-allgather", "coordinator-kv",
                "this backend cannot run cross-process device collectives; "
                "host gathers ride the coordination-service KV store",
                warn=False)
    if transport == "kv":
        seq = _KV_AG_SEQ[0]
        _KV_AG_SEQ[0] += 1
        with rec.span("dcn_allgather", transport="kv", seq=seq):
            kv_put_bytes(f"sitpu/ag/{seq}/{pid}", blob)
            # a bounded store over long runs: any process at call s has
            # finished call s-1's gets, and it started call s-1 only
            # after finishing call s-2's, so no reader still needs the
            # blob of two calls back
            if seq >= 2:
                _kv_delete(f"sitpu/ag/{seq - 2}/{pid}", _KV_SENT[seq - 2])
            _KV_SENT[seq] = len(blob)
            _KV_SENT.pop(seq - 2, None)
            parts = [blob if p == pid else kv_get_bytes(
                f"sitpu/ag/{seq}/{p}", timeout_ms) for p in range(nproc)]
        maxlen = max(len(b) for b in parts)
        blobs = np.zeros((nproc, 1, max(maxlen, 1)), np.uint8)
        lengths = np.zeros((nproc, 1), np.int64)
        for p, b in enumerate(parts):
            blobs[p, 0, :len(b)] = np.frombuffer(b, np.uint8)
            lengths[p, 0] = len(b)
            if p != pid:
                rec.count("dcn_bytes_received", len(b))
        return blobs, lengths
    if transport != "device":
        raise ValueError(f"transport must be 'device' or 'kv', got "
                         f"{transport!r}")
    with rec.span("dcn_allgather", transport="device"):
        if nproc == 1:
            lengths = np.array([[len(blob)]], np.int64)
            blobs = np.frombuffer(blob, np.uint8).reshape(1, 1, -1).copy()
        else:
            import torch.distributed as dist

            dev = (torch.device("cuda", torch.cuda.current_device())
                   if _STATE.get("backend") == "nccl"
                   else torch.device("cpu"))
            ln = torch.tensor([len(blob)], dtype=torch.int64, device=dev)
            lens = [torch.empty_like(ln) for _ in range(nproc)]
            dist.all_gather(lens, ln)
            lengths = torch.stack(lens).cpu().numpy().reshape(-1, 1)
            buf = torch.zeros(max(int(lengths.max()), 1), dtype=torch.uint8,
                              device=dev)
            buf[:len(blob)] = torch.from_numpy(
                np.frombuffer(blob, np.uint8).copy()).to(dev)
            outs = [torch.empty_like(buf) for _ in range(nproc)]
            dist.all_gather(outs, buf)
            blobs = torch.stack(outs).cpu().numpy().reshape(nproc, 1, -1)
    received = int(lengths.sum() - len(blob))
    if received > 0:
        rec.count("dcn_bytes_received", received)
    return blobs, lengths


def gather_vdi_tiles(vdi, codec: str = "zstd"):
    """Tile-granular host gather: compress this process's contiguous
    column block (``vdi``, the block a process-mesh step returns) and,
    on process 0, YIELD every process's block as ``(col0, color,
    depth)`` in ascending column order, each decompressed lazily under
    a ``dcn_decompress`` span as the consumer reaches it. Returns a
    generator on process 0, None elsewhere.

    Wire format: one dense blob a process (raw colour bytes then depth
    bytes, compressed with ``codec``; zstd degrades to zlib where the
    zstandard package is missing, as every writer does) with its byte
    count, through `_allgather_blobs`."""
    from scenery_insitu_tpu_torch.io.vdi_io import (compress, decompress,
                                                    resolve_codec)
    from scenery_insitu_tpu_torch.runtime.streaming import _host

    codec = resolve_codec(codec)
    local_c = np.ascontiguousarray(_host(vdi.color), np.float32)
    local_d = np.ascontiguousarray(_host(vdi.depth), np.float32)
    blobs, lengths = _allgather_blobs(
        compress(local_c.tobytes() + local_d.tobytes(), codec))
    if process_index() != 0:
        return None
    k, ch, h, _ = local_c.shape
    ch_d = local_d.shape[1]

    def tiles():
        rec = _obs.get_recorder()
        col0 = 0
        for p in range(len(lengths)):
            with rec.span("dcn_decompress", source_rank=p,
                          bytes=int(lengths[p, 0])):
                raw = decompress(bytes(blobs[p, 0, :int(lengths[p, 0])]),
                                 codec)
            arr = np.frombuffer(raw, np.float32)
            wseg = arr.size // (k * (ch + ch_d) * h)
            nc = k * ch * h * wseg
            yield (col0, arr[:nc].reshape(k, ch, h, wseg),
                   arr[nc:].reshape(k, ch_d, h, wseg))
            col0 += wseg

    return tiles()


def gather_vdi_compressed(vdi, codec: str = "zstd"
                          ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The whole frame on process 0 (None elsewhere): `gather_vdi_tiles`'
    blocks concatenated in column order, as host arrays."""
    tiles = gather_vdi_tiles(vdi, codec)
    if tiles is None:
        return None
    cols, deps = [], []
    for _, c, d in tiles:
        cols.append(c)
        deps.append(d)
    return np.concatenate(cols, -1), np.concatenate(deps, -1)


def gather_obs_events(recorder) -> Optional[list]:
    """Process 0's merge of every process's obs events: the events and
    summary of each process's ``recorder`` (the rank is in every event),
    each process's ``ts`` rebased on the earliest ``epoch_unix`` and the
    whole sorted by it, then one summary record a process. Returns the
    list on process 0, None elsewhere; in a one-process world the local
    events, no collective. The blob is zlib JSON through
    `_allgather_blobs`."""
    import json as _json
    import zlib

    payload = {"events": recorder.events, "summary": recorder.summary(),
               "epoch_unix": recorder.epoch_unix}
    if process_count() == 1:
        return sorted(payload["events"], key=lambda e: e.get("ts", 0.0)) \
            + [{"type": "summary", **payload["summary"]}]
    blobs, lengths = _allgather_blobs(
        zlib.compress(_json.dumps(payload).encode()))
    if process_index() != 0:
        return None
    payloads = [_json.loads(zlib.decompress(
        bytes(blobs[p, 0, :int(lengths[p, 0])])))
        for p in range(process_count())]
    base = min(d["epoch_unix"] for d in payloads)
    events, summaries = [], []
    for d in payloads:
        shift = d["epoch_unix"] - base
        for ev in d["events"]:
            ev = dict(ev)
            ev["ts"] = ev.get("ts", 0.0) + shift
            events.append(ev)
        summaries.append({"type": "summary", **d["summary"]})
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events + summaries


# --------------------------------------------------------------- smoke test

SMOKE_ENTRY = "scenery_insitu_tpu_torch.parallel.multihost:_smoke_entry"


def _smoke_entry(ctx) -> None:
    """One smoke worker (a harness entry): the reference's scene of 8 z
    slices a rank on a 16 x 16 plane, the same seeded state in every
    process, each process slicing out its own slab."""
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import hier
    from scenery_insitu_tpu_torch.parallel.pipeline import (
        distributed_initial_threshold_mxu, distributed_vdi_step,
        distributed_vdi_step_mxu_temporal)
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    pid, nproc, dev = ctx.process_id, ctx.num_processes, ctx.device
    mesh = global_mesh(ctx.ranks_per_proc, dev)
    n = mesh.n
    print(f"[mh {pid}] processes={nproc} global_ranks={n}", flush=True)
    grid = (8 * n, 16, 16)
    width, height = 8 * n, 16
    st = gs.GrayScott.init(grid, n_seeds=4, device="cpu")
    field = st.v.numpy()
    z0 = pid * 8 * mesh.n_local
    local = field[z0:z0 + 8 * mesh.n_local]
    slabs = shard_global(local, mesh)

    tf = for_dataset("gray_scott", device=dev)
    cam = Camera.create((0.0, 0.4, 3.0), fov_y_deg=50.0, near=0.5,
                        far=20.0, device=dev)
    origin = torch.tensor([-1.0, -1.0, -1.0], device=dev)
    spacing = torch.tensor([2.0 / 16, 2.0 / 16, 2.0 / grid[0]], device=dev)
    vcfg = VDIConfig(max_supersegments=4, adaptive_iters=2)
    ccfg = CompositeConfig(max_output_supersegments=6, adaptive_iters=2)
    vdi = distributed_vdi_step(mesh, tf, width, height, vcfg, ccfg,
                               max_steps=24)(slabs, origin, spacing, cam)
    # every process reports the global norm: one sum over the fleet
    norm = all_sum(float((vdi.color.double() ** 2).sum())) ** 0.5
    print(f"MULTIHOST_OK pid={pid} norm={norm:.6f}", flush=True)

    spec = slicer.make_spec(cam, grid, SliceMarchConfig(matmul_dtype="f32"),
                            multiple_of=n)
    cfg_t = VDIConfig(max_supersegments=4, adaptive_mode="temporal")
    thr = distributed_initial_threshold_mxu(mesh, tf, spec, cfg_t)(
        slabs, origin, spacing, cam)
    step_t = distributed_vdi_step_mxu_temporal(mesh, tf, spec, cfg_t, ccfg)
    for _ in range(2):
        (vdi_t, _), thr = step_t(slabs, origin, spacing, cam, thr)
    norm_t = all_sum(float((vdi_t.color.double() ** 2).sum())) ** 0.5
    print(f"MULTIHOST_MXU_OK pid={pid} norm={norm_t:.6f}", flush=True)

    gathered = gather_vdi_compressed(vdi, codec="zlib")
    if pid == 0:
        color, depth = gathered
        assert color.shape == (6, 4, height, width), color.shape
        assert np.isfinite(color).all()
        print(f"MULTIHOST_GATHER_OK shape={color.shape} "
              f"norm={np.linalg.norm(color):.6f}", flush=True)

    # the host path: this process's ranks as a local mesh, its domain
    # partial shipped to the head as f32 tiles over loopback
    hp = hier.run_host_path(pid, nproc, field, tf, cam, origin, spacing,
                            width, height, vcfg, ccfg, mesh.n_local, dev,
                            max_steps=24)
    if pid == 0:
        c, d, degraded = hp["frames"][0]
        same = (not degraded and c is not None
                and np.array_equal(c, gathered[0])
                and np.array_equal(np.isinf(d), np.isinf(gathered[1]))
                and np.array_equal(d[np.isfinite(d)],
                                   gathered[1][np.isfinite(gathered[1])]))
        assert same, "the host path's frame differs from the gathered one"
        print(f"MULTIHOST_HIER_OK shape={c.shape} equal=True", flush=True)


def _launch(nproc: int, ranks_per_proc: int = 2, device=None,
            entry: str = SMOKE_ENTRY, timeout_s: float = 600.0) -> int:
    """Spawn ``nproc`` workers on this machine (mpirun -np N) through the
    harness on gloo, and check that every one succeeded and that their
    norms agree to 4 decimals."""
    from scenery_insitu_tpu_torch.testing import multiproc

    results = multiproc.run_multiproc(entry, nproc, ranks_per_proc,
                                      timeout_s=timeout_s, device=device)
    norms, mxu_norms = {}, {}
    ok = True
    for r in results:
        print(r.output)
        ok = ok and r.ok
        for line in r.output.splitlines():
            if line.startswith("MULTIHOST_OK"):
                norms[r.process_id] = float(line.rsplit("norm=", 1)[1])
            elif line.startswith("MULTIHOST_MXU_OK"):
                mxu_norms[r.process_id] = float(line.rsplit("norm=", 1)[1])

    def agree(d):
        return len(d) == nproc and len({round(v, 4)
                                        for v in d.values()}) == 1

    if ok and agree(norms) and agree(mxu_norms):
        print(f"LAUNCH_OK processes={nproc} norm={norms[0]:.6f} "
              f"mxu_norm={mxu_norms[0]:.6f}", flush=True)
        return 0
    print("LAUNCH_FAILED", [(r.process_id, r.returncode) for r in results],
          norms, mxu_norms, flush=True)
    return 1


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launch", type=int, required=True,
                    help="spawn N single-machine worker processes, 2 "
                         "ranks each")
    ap.add_argument("--device", default=None,
                    help="the workers' device (default: CUDA, all on "
                         "the first card)")
    args = ap.parse_args(argv)
    return _launch(args.launch, device=args.device)


if __name__ == "__main__":
    sys.exit(main())

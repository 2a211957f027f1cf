"""Seeded, deterministic fault injection for the delivery plane: a copy
of the reference's ``testing/faults.py`` against this package's
endpoints, with the same scenarios, names and ledger components.

Every seam where bytes cross a failure domain — the zmq VDI/steering
streams, the UDP video stream, the shm ingest ring — gets an injector
that perturbs the SEND side, so the receive-side hardening
(runtime/streaming.py integrity validation, runtime/head.py rank
liveness, ingest/shm.py stall supervision) can be exercised in tier-1
without real network flakes:

- ``ChaosSocket`` wraps a zmq/UDP send socket behind a ``FaultSpec``
  (drop, corrupt bytes, truncate multipart, reorder, duplicate, delay),
  driven by one seeded ``random.Random`` — same seed, same faults,
  every run.
- ``SilentRank`` wraps a ``RankImageSender`` that goes silent after N
  frames (the dead-render-rank scenario for ``HeadNode``).
- ``kill_producer`` ends an external shm producer process (the
  dead-simulation scenario for ``ShmVolumeSource``).
- ``run_matrix`` executes the whole injector x endpoint matrix
  in-process and returns a machine-readable chaos report: every
  scenario must end with the endpoint alive, the expected ledger
  component minted, and zero unhandled exceptions. ``device`` is where
  the serving scenarios render (None means CUDA).

``python -m scenery_insitu_tpu_torch.testing.faults --seed 7 --out
chaos_report.json`` writes the report and exits non-zero if any
scenario failed (``--device cpu`` off the card).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

FAULT_KINDS = ("drop", "corrupt", "truncate", "reorder", "duplicate",
               "delay")


@dataclass(frozen=True)
class FaultSpec:
    """Per-message fault probabilities (0..1) for one chaos run. All
    zero = transparent passthrough (the clean-path parity control)."""

    drop: float = 0.0       # message vanishes
    corrupt: float = 0.0    # bytes flipped in the payload blob
    truncate: float = 0.0   # last part of a multipart message removed
    reorder: float = 0.0    # message held and sent after its successor
    duplicate: float = 0.0  # message sent twice
    delay: float = 0.0      # message sent late (sleep delay_s first)
    delay_s: float = 0.002
    corrupt_bytes: int = 8  # how many byte positions each corruption flips


@dataclass
class FaultReport:
    """What the injector actually did — seeded, so a failing test can be
    replayed exactly."""

    seed: int = 0
    injected: Dict[str, int] = field(default_factory=dict)
    sent: int = 0

    def record(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def to_dict(self) -> dict:
        return {"seed": self.seed, "sent": self.sent,
                "injected": dict(self.injected)}


class ChaosSocket:
    """Wraps the SEND side of a zmq socket (``send`` /
    ``send_multipart``) or a UDP socket (``sendto``); every outgoing
    message rolls against the ``FaultSpec`` with the seeded RNG. The
    receive side and every other attribute pass through untouched, so
    ``endpoint.sock = ChaosSocket(endpoint.sock, spec, seed)`` (or the
    ``inject`` helper) is the whole integration."""

    def __init__(self, sock, spec: FaultSpec, seed: int = 0,
                 report: Optional[FaultReport] = None):
        self.sock = sock
        self.spec = spec
        self.rng = random.Random(seed)
        self.report = report if report is not None else FaultReport(seed)
        self._held = None         # (send_fn_name, msg, extra) reorder slot

    # --------------------------------------------------- send interface
    def send(self, data, *args, **kw):
        self._dispatch("send", data, args)

    def send_multipart(self, parts, *args, **kw):
        self._dispatch("send_multipart", list(parts), args)

    def sendto(self, data, *addr):
        self._dispatch("sendto", data, addr)
        return len(data)          # socket.sendto contract: bytes "sent"

    def close(self, *args, **kw):
        self.flush()
        return self.sock.close(*args, **kw)

    def flush(self) -> None:
        """Release a held (reordered) message; call at end of a drill so
        the last message is never lost to the reorder buffer."""
        if self._held is not None:
            name, msg, extra = self._held
            self._held = None
            getattr(self.sock, name)(msg, *extra)

    def __getattr__(self, name):
        return getattr(self.sock, name)

    # ----------------------------------------------------------- faults
    def _dispatch(self, name, msg, extra) -> None:
        spec, rng = self.spec, self.rng
        self.report.sent += 1
        if spec.delay and rng.random() < spec.delay:
            self.report.record("delay")
            time.sleep(spec.delay_s)
        if spec.drop and rng.random() < spec.drop:
            self.report.record("drop")
            self.flush()          # the held predecessor still goes out
            return
        if spec.corrupt and rng.random() < spec.corrupt:
            msg = self._corrupt(name, msg)
            self.report.record("corrupt")
        if name == "send_multipart" and len(msg) > 1 \
                and spec.truncate and rng.random() < spec.truncate:
            msg = msg[:-1]
            self.report.record("truncate")
        if spec.reorder and self._held is None \
                and rng.random() < spec.reorder:
            self._held = (name, msg, extra)
            self.report.record("reorder")
            return
        getattr(self.sock, name)(msg, *extra)
        if spec.duplicate and rng.random() < spec.duplicate:
            self.report.record("duplicate")
            getattr(self.sock, name)(msg, *extra)
        self.flush()              # held message follows its successor

    def _corrupt(self, name, msg):
        """Flip ``corrupt_bytes`` seeded byte positions in the payload —
        the LAST part of a multipart message (a compressed blob), the
        whole datagram/message otherwise."""
        rng = self.rng
        target = bytearray(msg[-1] if name == "send_multipart" else msg)
        for _ in range(self.spec.corrupt_bytes):
            if not target:
                break
            target[rng.randrange(len(target))] ^= 0xFF
        if name == "send_multipart":
            return list(msg[:-1]) + [bytes(target)]
        return bytes(target)


def inject(endpoint, spec: FaultSpec, seed: int = 0) -> FaultReport:
    """Swap ``endpoint.sock`` (VDIPublisher, SteeringPublisher,
    RankImageSender, VideoStreamer ...) for a ChaosSocket; returns the
    FaultReport the injector will fill."""
    chaos = ChaosSocket(endpoint.sock, spec, seed)
    endpoint.sock = chaos
    return chaos.report


class SilentRank:
    """Wrap a ``RankImageSender``: frames below ``after`` pass through,
    later ones are swallowed — the silent-rank scenario for HeadNode's
    per-rank liveness. ``resume_at`` (optional) lets the rank come back
    so re-admission can be exercised."""

    def __init__(self, sender, after: int,
                 resume_at: Optional[int] = None):
        self.sender = sender
        self.after = after
        self.resume_at = resume_at
        self.swallowed = 0

    def send(self, frame: int, image, depth) -> None:
        silent = frame >= self.after and (self.resume_at is None
                                          or frame < self.resume_at)
        if silent:
            self.swallowed += 1
            return
        self.sender.send(frame, image, depth)

    def close(self) -> None:
        self.sender.close()


def kill_producer(proc, timeout_s: float = 5.0) -> int:
    """End an external shm producer process (the kill-the-producer
    scenario for ShmVolumeSource's stall supervision); returns the exit
    code."""
    proc.kill()
    return proc.wait(timeout=timeout_s)


# ---------------------------------------------------------- chaos matrix

def _index(i: int):
    import torch

    return torch.tensor(i, dtype=torch.int32)


def _pump_stream(pub, sub, vdi, meta, frames: int, seed: int):
    """Publish ``frames`` frames through whatever chaos wraps ``pub``
    and drain the subscriber; returns (received tuples, drop records)."""
    from scenery_insitu_tpu_torch.runtime.streaming import StreamDrop

    received, drops = [], []
    for i in range(frames):
        pub.publish(vdi, meta._replace(index=_index(i)))
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        got = sub.receive_tile(timeout_ms=100)
        if got is None:
            break
        if isinstance(got, StreamDrop):
            drops.append(got)
        else:
            received.append(got)
    return received, drops


def run_matrix(seed: int = 0, frames: int = 12, device=None) -> dict:
    """The seeded injector x endpoint chaos matrix, in one process.

    Each scenario builds a fresh publisher/subscriber pair (ephemeral
    ports), injects one fault kind at a deterministic rate, runs the
    stream, and records: endpoint alive (no unhandled exception), the
    ledger components minted, and the injector/validator tallies. The
    serving scenarios render on ``device`` (None means CUDA and raises
    without a card). The returned report is the chaos artifact."""
    import numpy as np
    import torch

    from scenery_insitu_tpu_torch.device import resolve_device

    from scenery_insitu_tpu_torch import obs
    from scenery_insitu_tpu_torch.config import FaultConfig
    from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
    from scenery_insitu_tpu_torch.runtime.streaming import (FrameAssembler,
                                                      SteeringEndpoint,
                                                      SteeringPublisher,
                                                      VDIPublisher,
                                                      VDISubscriber)

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K, H, W = 4, 12, 16
    vdi = VDI(torch.from_numpy(rng.random((K, 4, H, W)).astype(np.float32)),
              torch.from_numpy(rng.random((K, 2, H, W)).astype(np.float32)))
    meta = VDIMetadata.create(torch.eye(4), torch.eye(4),
                              volume_dims=(8, 8, 8), window_dims=(W, H),
                              nw=0.1, index=0)
    scenarios: List[dict] = []

    def scenario(name: str, expect_components, fn) -> None:
        obs.clear_ledger()
        entry = {"scenario": name, "alive": True,
                 "expected_components": sorted(expect_components)}
        try:
            entry.update(fn() or {})
        except Exception as e:   # sitpu-lint: disable=SITPU-LEDGER
            # reporting-only capture: an exception here IS the chaos
            # verdict ("endpoint died"), recorded in the artifact — the
            # run itself must keep going to finish the matrix
            entry["alive"] = False
            entry["error"] = repr(e)
        minted = {e["component"] for e in obs.ledger()}
        entry["ledger_components"] = sorted(minted)
        entry["ok"] = entry["alive"] and \
            set(expect_components) <= minted
        scenarios.append(entry)

    def stream_drill(kind: str, expect, **spec_kw):
        def fn():
            pub = VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
            sub = VDISubscriber(pub.endpoint)
            try:
                time.sleep(0.2)
                report = inject(pub, FaultSpec(**spec_kw), seed)
                received, drops = _pump_stream(pub, sub, vdi, meta,
                                               frames, seed)
                # whatever survived must decode exactly (integrity means
                # corrupt frames NEVER decode wrong — they drop)
                for r, _, _ in received:
                    assert np.isfinite(np.asarray(r.color)).all()
                return {"injected": report.to_dict(),
                        "frames_received": len(received),
                        "drops": len(drops),
                        "subscriber_stats": dict(sub.stats)}
            finally:
                pub.close()
                sub.close()
        scenario(f"vdi_stream/{kind}", expect, fn)

    # --- VDI stream × every byte-level injector -------------------------
    stream_drill("drop", ["stream.gap"], drop=0.5)
    stream_drill("corrupt", ["stream.integrity"], corrupt=0.7)
    stream_drill("truncate", ["stream.integrity"], truncate=0.7)
    stream_drill("reorder", ["stream.gap"], reorder=0.9)
    stream_drill("duplicate", ["stream.gap"], duplicate=1.0)
    stream_drill("delay", [], delay=1.0, delay_s=0.001)

    # --- clean-path parity control --------------------------------------
    def clean():
        pub = VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
        sub = VDISubscriber(pub.endpoint)
        try:
            time.sleep(0.2)
            received, drops = _pump_stream(pub, sub, vdi, meta, 4, seed)
            assert drops == [] and len(received) == 4
            for r, _, _ in received:
                np.testing.assert_array_equal(np.asarray(vdi.color),
                                              r.color)
            hdr = pub.last_bytes["header"]
            raw = (np.asarray(vdi.color).nbytes
                   + np.asarray(vdi.depth).nbytes)
            return {"frames_received": len(received),
                    "header_bytes": hdr, "frame_bytes": raw,
                    "header_overhead": round(hdr / raw, 4)}
        finally:
            pub.close()
            sub.close()
    scenario("vdi_stream/clean_parity", [], clean)

    # --- tile stream + assembler under tile loss ------------------------
    def tiles():
        from scenery_insitu_tpu_torch.runtime.streaming import StreamDrop

        pub = VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
        sub = VDISubscriber(pub.endpoint)
        try:
            time.sleep(0.2)
            report = inject(pub, FaultSpec(drop=0.3), seed)
            asm = FrameAssembler(window=2)
            ntiles, wb = 4, W // 4
            for f in range(frames):
                for t in range(ntiles):
                    tv = VDI(vdi.color[..., t * wb:(t + 1) * wb],
                             vdi.depth[..., t * wb:(t + 1) * wb])
                    pub.publish_tile(
                        tv, meta._replace(index=_index(f)),
                        t, ntiles, t * wb)
            done = []
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                got = sub.receive_tile(timeout_ms=100)
                if got is None:
                    break
                if isinstance(got, StreamDrop):
                    continue
                out = asm.add(*got)
                if out is not None:
                    done.append(out)
            for v, _ in done:     # complete frames must be bit-exact
                np.testing.assert_array_equal(np.asarray(vdi.color),
                                              v.color)
            assert asm.stats["abandoned"] > 0
            return {"injected": report.to_dict(),
                    "frames_assembled": len(done),
                    "assembler_stats": dict(asm.stats)}
        finally:
            pub.close()
            sub.close()
    scenario("tile_stream/drop_assembler", ["stream.gap"], tiles)

    # --- steering endpoint under garbage --------------------------------
    def steering():
        ep = SteeringEndpoint("tcp://127.0.0.1:0",
                              fault=FaultConfig(max_message_bytes=4096))
        viewer = SteeringPublisher(ep.endpoint)
        try:
            time.sleep(0.2)
            good = []
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not good:
                viewer.sock.send(b"\xc1\x00\xff garbage not msgpack")
                viewer.sock.send(b"\x00" * 8192)       # oversized
                viewer.send({"type": "camera", "eye": [0, 0, 9]})
                time.sleep(0.02)
                good.extend(ep.drain())
            assert good and good[-1]["type"] == "camera"
            assert ep.stats["dropped"] > 0
            return {"drained": len(good),
                    "endpoint_stats": dict(ep.stats)}
        finally:
            viewer.close()
            ep.close()
    scenario("steering/malformed_oversized", ["stream.steering"],
             steering)

    # --- serving tier: churn, backpressure, delta mid-join -------------
    def _serve_fixture():
        """A tiny REAL slice-march VDI (the matrix's synthetic identity
        matrices are not a renderable camera) + a loopback server's
        config; both render on ``dev``."""
        from scenery_insitu_tpu_torch.config import (FrameworkConfig,
                                               SliceMarchConfig,
                                               VDIConfig)
        from scenery_insitu_tpu_torch.core.camera import Camera
        from scenery_insitu_tpu_torch.core.transfer import for_dataset
        from scenery_insitu_tpu_torch.core.volume import procedural_volume
        from scenery_insitu_tpu_torch.ops import slicer

        vol = procedural_volume(16, kind="blobs", seed=seed, device=dev)
        cam0 = Camera.create((0.1, 0.3, 2.8), fov_y_deg=45.0, near=0.3,
                             far=10.0, device=dev)
        spec = slicer.make_spec(
            cam0, tuple(vol.data.shape), SliceMarchConfig(matmul_dtype="f32"))
        svdi, smeta, _ = slicer.generate_vdi_mxu(
            vol, for_dataset("procedural", device=dev), cam0, spec,
            VDIConfig(max_supersegments=4, adaptive_iters=1))
        cfg = FrameworkConfig().with_overrides(
            "serve.width=24", "serve.height=20", "serve.num_slices=8",
            "serve.batch_size=4", "serve.buckets=[1,2,4]")
        return svdi, smeta, cam0, cfg

    def _pump_serve(srv, clients, secs):
        import time as _t

        from scenery_insitu_tpu_torch.serve import ViewerFrame

        deadline = _t.monotonic() + secs
        answers = 0
        while _t.monotonic() < deadline:
            srv.run_once(timeout_ms=10)
            for c in clients:
                got = c.poll(timeout_ms=0)
                if isinstance(got, ViewerFrame):
                    answers += 1
        return answers

    def serve_churn():
        """Clients joining and leaving MID-FRAME while the server
        answers: admissions beyond max_viewers shed typed, leavers are
        forgotten, the server never raises."""
        from scenery_insitu_tpu_torch.core.camera import orbit
        from scenery_insitu_tpu_torch.runtime.streaming import VDIPublisher
        from scenery_insitu_tpu_torch.serve import ViewerClient, ViewerServer

        svdi, smeta, cam0, cfg = _serve_fixture()
        cfg = cfg.with_overrides("serve.max_viewers=2")
        pub = VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
        srv = ViewerServer(cfg, connect=pub.endpoint,
                           bind="tcp://127.0.0.1:0", device=dev)
        churned = []
        try:
            time.sleep(0.2)
            pub.publish(svdi, smeta)
            deadline = time.monotonic() + 20
            while srv.frame is None and time.monotonic() < deadline:
                srv.pump_stream(timeout_ms=100)
            assert srv.frame is not None
            answers = 0
            for round_ in range(3):
                batch = [ViewerClient(srv.endpoint, tier="proxy")
                         for _ in range(4)]        # 4 > max_viewers=2
                churned.extend(batch)
                for i, c in enumerate(batch):
                    c.request(orbit(cam0, 0.05 * i + 0.02 * round_))
                answers += _pump_serve(srv, batch, 1.0)
                for c in batch[:2]:                # leavers mid-stream
                    c.bye()
                srv.pump_clients()
            assert answers > 0
            assert srv.stats["sheds"] > 0
            return {"answers": answers, "server_stats": dict(srv.stats)}
        finally:
            for c in churned:
                c.close()
            srv.close()
            pub.close()
    scenario("serve/client_churn", ["serve.shed"], serve_churn)

    def serve_backpressure():
        """A slow/flooding client vs admission control: its own requests
        coalesce latest-wins, and distinct clients beyond queue_cap shed
        typed — the serve loop never blocks on the slow consumer."""
        from scenery_insitu_tpu_torch.core.camera import orbit
        from scenery_insitu_tpu_torch.runtime.streaming import VDIPublisher
        from scenery_insitu_tpu_torch.serve import (ServeDrop, ViewerClient,
                                              ViewerServer)

        svdi, smeta, cam0, cfg = _serve_fixture()
        cfg = cfg.with_overrides("serve.max_viewers=4",
                                 "serve.queue_cap=1")
        pub = VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
        srv = ViewerServer(cfg, connect=pub.endpoint,
                           bind="tcp://127.0.0.1:0", device=dev)
        flooder = ViewerClient(srv.endpoint, tier="proxy")
        other = ViewerClient(srv.endpoint, tier="proxy")
        try:
            time.sleep(0.2)
            pub.publish(svdi, smeta)
            deadline = time.monotonic() + 20
            while srv.frame is None and time.monotonic() < deadline:
                srv.pump_stream(timeout_ms=100)
            # the flooder never reads; its burst coalesces to one slot
            for i in range(6):
                flooder.request(orbit(cam0, 0.03 * i))
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not srv.queue:
                srv.pump_clients()
                time.sleep(0.01)
            srv.pump_clients()
            assert len(srv.queue) <= 1
            # a second client against the full queue: typed shed
            other.request(orbit(cam0, 0.5))
            shed = None
            deadline = time.monotonic() + 10
            while shed is None and time.monotonic() < deadline:
                srv.pump_clients()
                got = other.poll(timeout_ms=10)
                if isinstance(got, ServeDrop) and got.kind == "shed":
                    shed = got
            assert shed is not None and shed.reason == "queue_cap"
            return {"server_stats": dict(srv.stats),
                    "coalesced": srv.stats["coalesced"]}
        finally:
            flooder.close()
            other.close()
            srv.close()
            pub.close()
    scenario("serve/slow_client_backpressure", ["serve.shed"],
             serve_backpressure)

    def serve_delta_midjoin():
        """The serve subscriber joins a temporal-delta stream
        mid-flight: P/SKIP records before the first I-frame are typed
        resync drops, and the server is whole within iframe_period."""
        from scenery_insitu_tpu_torch.config import DeltaConfig
        from scenery_insitu_tpu_torch.runtime.streaming import VDIPublisher
        from scenery_insitu_tpu_torch.serve import ViewerServer

        svdi, smeta, cam0, cfg = _serve_fixture()
        # iframe_period is generous so MANY P records precede the forced
        # I: the subscriber's SUB join settles while P-frames flow, and
        # the scenario's resync-drop assertion never races the first
        # I-frame on a loaded runner
        pub = VDIPublisher("tcp://127.0.0.1:0", codec="zlib",
                           precision="qpack8", epoch=seed + 1,
                           delta=DeltaConfig(enabled=True,
                                             iframe_period=16))
        # the stream is already past its first I-frame when we join
        pub.publish(svdi, smeta._replace(index=_index(0)))
        pub.publish(svdi, smeta._replace(index=_index(1)))
        srv = ViewerServer(cfg, connect=pub.endpoint,
                           bind="tcp://127.0.0.1:0", device=dev)
        try:
            time.sleep(0.2)
            deadline = time.monotonic() + 20
            i = 2
            while srv.frame is None and time.monotonic() < deadline:
                pub.publish(svdi, smeta._replace(index=_index(i)))
                i += 1
                srv.pump_stream(timeout_ms=300)
            assert srv.frame is not None, "never recovered on an I-frame"
            assert srv.stats["stream_drops"] > 0    # the resync waits
            return {"frames_published": i,
                    "server_stats": dict(srv.stats),
                    "subscriber_stats": dict(srv.sub.stats)}
        finally:
            srv.close()
            pub.close()
    scenario("serve/delta_resync_midjoin", ["stream.delta_resync"],
             serve_delta_midjoin)

    # --- async delivery plane under a slow sink -------------------------
    def delivery_backpressure():
        """A deliberately slow frame sink behind the bounded delivery
        queue in ``drop_oldest`` mode: the submitting loop never blocks
        on the sink, the stalest undelivered frames shed typed
        (``delivery.shed`` ledger + ``delivery_sheds`` counter), the
        survivors arrive strictly FIFO, and drain() leaves nothing in
        flight."""
        import threading

        from scenery_insitu_tpu_torch.config import DeliveryConfig
        from scenery_insitu_tpu_torch.runtime.delivery import DeliveryExecutor
        from scenery_insitu_tpu_torch.runtime.failsafe import SinkGuard

        sink_s = 0.05
        done, lock = [], threading.Lock()

        def slow_sink(index, payload):
            time.sleep(sink_s)
            with lock:
                done.append(index)

        cfg = DeliveryConfig(enabled=True, queue_frames=2,
                             overflow="drop_oldest")
        ex = DeliveryExecutor(cfg, SinkGuard(), [], [slow_sink])
        try:
            t0 = time.monotonic()
            for i in range(frames):
                ex.submit(i, {"frame": i})
            submit_s = time.monotonic() - t0
            # the loop thread must never serialize on the slow sink
            assert submit_s < 0.5 * frames * sink_s, submit_s
            assert ex.drain(timeout_s=30.0)
        finally:
            ex.close()
        with lock:
            got = list(done)
        assert got == sorted(got) and len(set(got)) == len(got)
        assert ex.sheds > 0 and ex.delivered == len(got)
        assert ex.delivered + ex.sheds == ex.enqueued
        return {"submitted": frames, "delivered": ex.delivered,
                "sheds": ex.sheds, "submit_s": round(submit_s, 4)}
    scenario("delivery/slow_sink_backpressure", ["delivery.shed"],
             delivery_backpressure)

    # --- telemetry collector dies mid-run --------------------------------
    def collector_death():
        """The fleet-telemetry collector is killed halfway through the
        run: every frame still crosses the delivery plane (telemetry is
        a side-channel, never on the frame path), and the presumed-lost
        batches are counted and ledgered ``obs.collector``."""
        from scenery_insitu_tpu_torch.obs.collector import (Collector,
                                                      ObsPublisher)
        from scenery_insitu_tpu_torch.runtime.streaming import (StreamDrop,
                                                          VDIPublisher,
                                                          VDISubscriber)

        saved_rec = obs.get_recorder()
        rec = obs.Recorder(enabled=True)
        obs.set_recorder(rec)
        col = Collector()
        opub = ObsPublisher(col.endpoint, col.hb_endpoint, rank=0,
                            interval_s=0.0)
        pub = VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
        sub = VDISubscriber(pub.endpoint)
        killed_at = frames // 2
        try:
            time.sleep(0.2)
            alive_batches = 0
            for i in range(frames):
                if i == killed_at:
                    col.close()          # mid-run, no goodbye
                pub.publish(vdi, meta._replace(index=_index(i)))
                opub.pump(rec, force=True)
                if i < killed_at:
                    alive_batches += col.poll(20)
            received = []
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                got = sub.receive_tile(timeout_ms=100)
                if got is None:
                    break
                if not isinstance(got, StreamDrop):
                    received.append(got)
            # the delivery plane never noticed: EVERY frame arrived
            assert len(received) == frames, \
                f"delivery impacted: {len(received)}/{frames}"
            assert alive_batches > 0          # telemetry flowed before
            assert opub.drops > 0             # ...and was ledgered after
            assert rec.counters.get("obs_batch_drops", 0) > 0
            return {"frames_received": len(received),
                    "batches_before_kill": alive_batches,
                    "publisher": {"batches": opub.batches,
                                  "drops": opub.drops}}
        finally:
            obs.set_recorder(saved_rec)
            opub.close()
            pub.close()
            sub.close()
    scenario("obs/collector_death_midrun", ["obs.collector"],
             collector_death)

    # --- subscriber liveness reconnect ----------------------------------
    def liveness():
        sub = VDISubscriber(
            "tcp://127.0.0.1:1",     # nothing listens: pure silence
            fault=FaultConfig(liveness_timeout_s=0.05,
                              backoff_base_s=0.01, backoff_cap_s=0.05))
        try:
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline \
                    and sub.stats["reconnects"] < 2:
                sub.receive(timeout_ms=30)
            assert sub.stats["reconnects"] >= 2
            return {"subscriber_stats": dict(sub.stats)}
        finally:
            sub.close()
    scenario("vdi_stream/liveness_reconnect", ["stream.liveness"],
             liveness)

    report = {
        "seed": seed,
        "frames_per_scenario": frames,
        "scenarios": scenarios,
        "ok": all(s["ok"] for s in scenarios),
    }
    return report


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        description="seeded delivery-plane chaos matrix")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default=None, help="chaos report JSON path")
    ap.add_argument("--device", default=None,
                    help="where the serving scenarios render: cuda (the "
                         "default) or cpu")
    args = ap.parse_args(argv)
    report = run_matrix(seed=args.seed, frames=args.frames,
                        device=args.device)
    blob = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    print(blob if not args.out else
          f"chaos matrix {'OK' if report['ok'] else 'FAILED'}: "
          f"{sum(s['ok'] for s in report['scenarios'])}/"
          f"{len(report['scenarios'])} scenarios -> {args.out}",
          file=sys.stdout, flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

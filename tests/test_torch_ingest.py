"""Parity of the port's shared-memory ingest (``ingest/shm.py`` over its
own build of ``ingest/native/*.cpp``) with the JAX package's, on the CPU.

The two packages' transports interoperate on one channel: the port's
consumer reads the reference's built ``demo_producer`` and the
reference's consumer reads the port's producer and demo producer, bit
for bit. The port's ``ShmVolumeSource`` releases its slot only after the
copy, stalls and recovers with the ``ingest.stall`` ledger row, the
``ingest_stalls``/``ingest_stall_recoveries`` counters and the
``ingest_recovered`` event; the port's ``InSituSession`` fed by it at
16^3 matches the reference's session fed by the same producer within
1e-5; ``ShmShardedVolumeSource`` assembles 4 slab producers into the
whole producer's field exactly (and its session equals the whole
field's bit for bit); the CLI inspects, resets and unlinks. Producers
that ran to completion leave their final frame in the ring, so both
packages see one static frame. Channel names are unique per test
(``uuid``): the suite runs several workers. Skips without a C++
toolchain, as the reference's ``tests/test_ingest.py`` does."""

import json
import shutil
import subprocess
import uuid

import numpy as np
import pytest
import torch

from scenery_insitu_tpu.config import FrameworkConfig as JConfig
from scenery_insitu_tpu.ingest import shm as jshm
from scenery_insitu_tpu.runtime import session as jses
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.config import FrameworkConfig as TConfig
from scenery_insitu_tpu_torch.ingest import shm as tshm
from scenery_insitu_tpu_torch.ingest import shm_tool
from scenery_insitu_tpu_torch.parallel.mesh import Mesh, make_mesh
from scenery_insitu_tpu_torch.runtime import session as tses
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, one_torch_thread)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain (g++)")

CPU = "cpu"
D = 16


def _chan():
    return f"/sitpu_torch_test_{uuid.uuid4().hex[:12]}"


def _run(producer, *args):
    """Run a demo producer to completion (its last frame stays)."""
    out = subprocess.run([producer, *map(str, args)], capture_output=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr


def _overrides(n):
    over = {"slicer.engine": "mxu", "slicer.scale": "1.0",
            "sim.steps_per_frame": "1", "vdi.max_supersegments": "6",
            "vdi.adaptive_mode": "temporal",
            "composite.max_output_supersegments": "8",
            "mesh.num_devices": str(n)}
    return [f"{k}={v}" for k, v in over.items()]


@pytest.fixture(scope="module")
def whole_field():
    """A 16^3 field channel from the port's demo producer, run to its
    end (frame 2 stays in the ring); yields (channel, frame)."""
    ch = _chan()
    _run(tshm.demo_producer(), ch, "field", D, 3, 0)
    con = jshm.ShmConsumer(ch, (D,) * 3, timeout_ms=2000)
    frame, _ = con.latest(timeout_ms=2000)
    con.close()
    yield ch, frame
    tshm.unlink(ch)


def test_port_consumer_reads_reference_producer(whole_field):
    """The reference's built demo producer into the port's consumer; the
    frame equals the port's demo producer's bit for bit."""
    jshm.ensure_built()
    ch = _chan()
    _run(jshm.DEMO_PRODUCER, ch, "field", D, 3, 0)
    try:
        con = tshm.ShmConsumer(ch, (D,) * 3, timeout_ms=2000)
        view, seq = con.latest(timeout_ms=2000, copy=False)
        assert seq == 3 and not view.flags.writeable
        np.testing.assert_array_equal(view, whole_field[1])
        assert tshm.channel_stats(ch)["slots"][view.slot]["readers"] == 1
        con.release(view.slot)
        assert con.latest(timeout_ms=0) is None       # nothing newer
        con.close()
        assert whole_field[1].max() > 0.5              # the blob's peak
    finally:
        tshm.unlink(ch)


def test_reference_consumer_reads_port_producers():
    """The port's ShmProducer and slab-mode demo producer into the
    reference's consumer, bit for bit; a producer never blocks."""
    rng = np.random.default_rng(0)
    ch = _chan()
    prod = tshm.ShmProducer(ch, (4, 5, 6), nslots=3)
    con = jshm.ShmConsumer(ch, (4, 5, 6), timeout_ms=2000)
    try:
        for i in range(4):
            frame = rng.random((4, 5, 6), dtype=np.float32)
            assert prod.publish(frame) == i + 1
            got, seq = con.latest(timeout_ms=1000)
            assert seq == i + 1
            np.testing.assert_array_equal(got, frame)
        pinned, _ = con.latest(timeout_ms=0, copy=False) or (None, None)
        assert pinned is None
        prod.publish(np.zeros((4, 5, 6), np.float32))
        pinned, _ = con.latest(timeout_ms=1000, copy=False)
        for _ in range(3):        # the pinned and latest slots are skipped
            prod.publish(np.ones((4, 5, 6), np.float32))
        np.testing.assert_array_equal(pinned, 0.0)
        con.release(pinned.slot)
        assert prod.frames_dropped == 0
    finally:
        con.close()
        prod.close()
    slabs = [_chan() for _ in range(2)]
    try:
        for r, c in enumerate(slabs):
            _run(tshm.demo_producer(), c, "slab", 8, 2, 0, r, 2)
        whole = np.concatenate([
            jshm.ShmConsumer(c, (4, 8, 8), timeout_ms=2000).latest(
                timeout_ms=2000)[0] for c in slabs])
        ch = _chan()
        _run(jshm.DEMO_PRODUCER, ch, "field", 8, 2, 0)
        want, _ = tshm.ShmConsumer(ch, (8,) * 3).latest(timeout_ms=2000)
        tshm.unlink(ch)
        np.testing.assert_array_equal(whole, want)
    finally:
        for c in slabs:
            tshm.unlink(c)


def test_volume_source_stall_and_recover():
    """The source copies the frame and then releases its slot; a quiet
    producer stalls it once (ledger row, counter), it keeps the last
    frame and polls without blocking; frames resuming recover it
    (counter, event)."""
    shape = (6, 6, 6)
    ch = _chan()
    prod = tshm.ShmProducer(ch, shape)
    prod.publish(np.full(shape, 1.0, np.float32))
    rec = tobs.Recorder(enabled=True)
    prev = tobs.set_recorder(rec)
    tobs.clear_ledger()
    src = tshm.ShmVolumeSource(ch, shape, timeout_ms=2000,
                               frame_timeout_ms=100, device=CPU)
    try:
        src.advance(1)
        assert src.field.dtype == torch.float32
        assert src.field.device.type == "cpu"
        assert all(s["readers"] == 0 for s in tshm.channel_stats(ch)["slots"])
        prod.publish(np.full(shape, 5.0, np.float32))
        prod.publish(np.full(shape, 6.0, np.float32))  # reuses the old slot
        np.testing.assert_array_equal(src.field.numpy(), 1.0)
        src.advance(1)                    # takes 6.0, skips 5.0
        assert float(src.field[0, 0, 0]) == 6.0 and src.last_seq == 3
        src.advance(1)                    # the producer went quiet
        assert src.stalled and src.stall_count == 1
        assert [e["component"] for e in tobs.ledger()] == ["ingest.stall"]
        assert set(tobs.ledger_registry()) >= {"ingest.stall"}
        for _ in range(5):
            src.advance(1)                # no new wait, no new episode
        assert src.stall_count == 1 and tobs.ledger()[0]["count"] == 1
        prod.publish(np.full(shape, 2.0, np.float32))
        src.advance(1)
        assert not src.stalled and float(src.field[0, 0, 0]) == 2.0
        assert rec.counters["ingest_stalls"] == 1
        assert rec.counters["ingest_stall_recoveries"] == 1
        assert [e["attrs"] for e in rec.events
                if e.get("name") == "ingest_recovered"] == [{"seq": 4}]
        quiet = tshm.ShmProducer(_chan(), shape)
        host = tshm.ShmVolumeSource(quiet.channel, shape, timeout_ms=0,
                                    device_put=False, device=CPU)
        with pytest.raises(TimeoutError):
            host.advance(1)               # its first frame never comes
        quiet.publish(np.full(shape, 3.0, np.float32))
        assert isinstance(host.field, np.ndarray)
        assert host.field[0, 0, 0] == 3.0
        host.close()
        quiet.close()
    finally:
        tobs.set_recorder(prev)
        src.close()
        prod.close()


def test_session_matches_reference(whole_field):
    """The port's InSituSession over ShmVolumeSource on the CPU, 2 ranks,
    against the reference's session on the same channel (the port's
    producer's final frame): each frame's VDI within 1e-5."""
    ch = whole_field[0]
    got, want = {}, {}
    tsrc = tshm.ShmVolumeSource(ch, (D,) * 3, timeout_ms=2000,
                                frame_timeout_ms=20, device=CPU)
    tsess = tses.InSituSession(TConfig().with_overrides(*_overrides(2)),
                               sim=tsrc, device=CPU,
                               sinks=[lambda i, p: got.update({i: p})])
    tsess.run(2)
    jsrc = jshm.ShmVolumeSource(ch, (D,) * 3, timeout_ms=2000,
                                frame_timeout_ms=20)
    jsess = jses.InSituSession(JConfig().with_overrides(*_overrides(2)),
                               sim=jsrc)
    jsess.sinks.append(lambda i, p: want.update({i: p}))
    jsess.run(2)
    tsrc.close()
    jsrc.consumer.close()
    assert sorted(got) == sorted(want) == [0, 1]
    for i in want:
        assert_vdi_close(got[i]["vdi_color"], got[i]["vdi_depth"],
                         want[i]["vdi_color"], want[i]["vdi_depth"],
                         rtol=1e-5, atol=1e-5)
    assert got[1]["vdi_color"].max() > 0.0
    assert tsrc.frames == 1 and tsrc.stall_count == 1


def test_sharded_source_equals_whole_field(whole_field):
    """4 slab producers into ShmShardedVolumeSource on a 4-rank CPU
    mesh: the assembled slabs equal the whole producer's field exactly,
    coherent, in shard_volume's layout; a session over it equals the
    session over the whole field's channel bit for bit. A process mesh
    refuses the feed."""
    n = 4
    chans = [_chan() for _ in range(n)]
    try:
        for r, c in enumerate(chans):
            _run(tshm.demo_producer(), c, "slab", D, 3, 0, r, n)
        mesh = make_mesh(n, device=CPU)
        src = tshm.ShmShardedVolumeSource(chans, (D // n, D, D), mesh,
                                          timeout_ms=2000,
                                          frame_timeout_ms=20)
        assert tuple(src.slabs.shape) == (n, D // n, D, D)
        assert src.last_seqs == (3,) * n
        np.testing.assert_array_equal(src.field.numpy(), whole_field[1])
        assert src.field.data_ptr() == src.slabs.data_ptr()
        payloads = []
        for sim in (src, tshm.ShmVolumeSource(whole_field[0], (D,) * 3,
                                              timeout_ms=2000,
                                              frame_timeout_ms=20,
                                              device=CPU)):
            sess = tses.InSituSession(TConfig().with_overrides(
                *_overrides(n)), sim=sim, device=CPU)
            payloads.append(sess.run(2))
            sim.close()
        for key in ("vdi_color", "vdi_depth"):
            np.testing.assert_array_equal(payloads[0][key], payloads[1][key])
        assert src.stalled and src.frames == 1
        with pytest.raises(NotImplementedError, match="A8b item 9"):
            tshm.ShmShardedVolumeSource(chans, (D // n, D, D),
                                        Mesh(n, torch.device(CPU),
                                             local_ranks=2))
        with pytest.raises(ValueError, match="one channel per rank"):
            tshm.ShmShardedVolumeSource(chans[:2], (D // n, D, D), mesh)
    finally:
        for c in chans:
            tshm.unlink(c)


def test_shm_tool(capsys):
    """Inspect (JSON), clear pins, unlink; a missing channel exits 1."""
    ch = _chan()
    prod = tshm.ShmProducer(ch, (4,))
    prod.publish(np.arange(4, dtype=np.float32))
    con = tshm.ShmConsumer(ch, (4,))
    con.latest(timeout_ms=1000, copy=False)        # pinned, never released
    assert shm_tool.main([ch, "--json"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["last_seq"] == 1 and stats["nslots"] == 3
    assert stats == jshm.channel_stats(ch)
    assert shm_tool.main([ch, "--reset", "--unlink", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["pins_cleared"] == 1 and out["unlinked"]
    with pytest.raises(SystemExit) as exc:
        shm_tool.main([ch])
    assert exc.value.code == f"no channel {ch!r}"
    con.close()
    prod.close(unlink=False)

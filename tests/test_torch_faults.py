"""The port's chaos matrix (``testing/faults.py``) against the JAX
package's, on the CPU.

- ``run_matrix(seed=7)`` of both packages (the port's serving
  scenarios rendering on the CPU): the same 15 scenario names in the
  same order, every one alive and ok, the same expected and minted
  ledger components, and the same injected tallies wherever a scenario
  reports them (the injectors roll one seeded ``random.Random`` a
  message, so equal sends give equal faults).
- ``ChaosSocket`` is deterministic as the reference's own test holds
  it, and the port's and the reference's sockets send the same bytes
  and report the same faults for one seed.
- ``SilentRank`` silences a port ``RankImageSender`` against the port's
  ``HeadNode``: the frames degrade, ledger ``head.rank_down``, and
  complete again when the rank resumes.
- ``kill_producer`` ends a running port shm demo producer; the source
  keeps serving its last frame and then stalls on ``ingest.stall``.
- The CLI writes the report and exits 0.
"""

import json
import random
import shutil
import subprocess
import time
import uuid

import numpy as np
import pytest
import torch

from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu.testing import faults as jfaults
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.testing import faults as tfaults
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

SEED = 7
SCENARIOS = 15


@pytest.fixture(scope="module")
def reports():
    """Both packages' matrices at seed 7, each run once."""
    pytest.importorskip("zmq")
    prev_t, prev_j = tobs.get_recorder(), jobs.get_recorder()
    try:
        ref = jfaults.run_matrix(seed=SEED)
        port = tfaults.run_matrix(seed=SEED, device="cpu")
    finally:
        tobs.set_recorder(prev_t)
        jobs.set_recorder(prev_j)
        tobs.clear_ledger()
        jobs.clear_ledger()
    return ref, port


def test_matrix_matches_reference(reports):
    ref, port = reports
    assert port["ok"] and ref["ok"]
    assert port["seed"] == ref["seed"] == SEED
    assert port["frames_per_scenario"] == ref["frames_per_scenario"]
    names = [s["scenario"] for s in port["scenarios"]]
    assert names == [s["scenario"] for s in ref["scenarios"]]
    assert len(names) == SCENARIOS
    for got, want in zip(port["scenarios"], ref["scenarios"]):
        name = got["scenario"]
        assert got["alive"] and got["ok"], got
        for key in ("alive", "ok", "expected_components",
                    "ledger_components"):
            assert got[key] == want[key], (name, key, got, want)


def test_matrix_injected_tallies_equal_reference(reports):
    ref, port = reports
    seen = 0
    for got, want in zip(port["scenarios"], ref["scenarios"]):
        assert ("injected" in got) == ("injected" in want), got["scenario"]
        if "injected" in want:
            assert got["injected"] == want["injected"], got["scenario"]
            seen += 1
    assert seen == 7          # the six stream injectors and the tiles


def test_chaos_socket_deterministic_and_equal_to_reference():
    def run(mod, seed):
        sent = []

        class FakeSock:
            def send_multipart(self, parts):
                sent.append(tuple(parts))

        cs = mod.ChaosSocket(FakeSock(), mod.FaultSpec(drop=0.4,
                                                       corrupt=0.3),
                             seed=seed)
        for i in range(20):
            cs.send_multipart([b"h", bytes([i] * 8), b"d"])
        cs.flush()
        return sent, dict(cs.report.injected)

    a_msgs, a_rep = run(tfaults, 11)
    b_msgs, b_rep = run(tfaults, 11)
    c_msgs, c_rep = run(tfaults, 12)
    assert a_msgs == b_msgs and a_rep == b_rep   # same seed, same faults
    assert a_rep != c_rep or a_msgs != c_msgs    # another seed differs
    assert a_rep.get("drop", 0) > 0 and a_rep.get("corrupt", 0) > 0
    assert (a_msgs, a_rep) == run(jfaults, 11)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


@pytest.mark.parametrize("kind", ["sendto", "send"])
def test_chaos_socket_single_part_sends_equal_reference(kind):
    """Datagram and single-part sends: corruption flips the whole
    message, reorder holds one back, duplicates go twice."""
    spec = dict(corrupt=0.3, reorder=0.3, duplicate=0.3, drop=0.1)

    def run(mod):
        sent = []

        class FakeSock:
            def send(self, data, *a):
                sent.append(bytes(data))

            def sendto(self, data, *addr):
                sent.append((bytes(data), addr))

        cs = mod.ChaosSocket(FakeSock(), mod.FaultSpec(**spec), seed=3)
        rng = random.Random(0)
        for i in range(30):
            msg = bytes(rng.randrange(256) for _ in range(16))
            if kind == "sendto":
                cs.sendto(msg, ("127.0.0.1", 9))
            else:
                cs.send(msg)
        cs.flush()
        return sent, cs.report.to_dict()

    assert run(tfaults) == run(jfaults)


def test_silent_rank_degrades_head_and_readmits():
    pytest.importorskip("zmq")
    from scenery_insitu_tpu_torch.runtime.head import (HeadNode,
                                                       RankImageSender)

    tobs.clear_ledger()
    got = []
    head = HeadNode(2, bind="tcp://*:0", stale_frames=2,
                    sinks=(lambda i, p: got.append((i, p)),))
    s0 = s1 = None
    try:
        ep = head.endpoint.replace("*", "localhost")
        s0 = RankImageSender(0, ep)
        s1 = tfaults.SilentRank(RankImageSender(1, ep), after=2,
                                resume_at=8)
        h, w = 8, 12
        img = np.zeros((4, h, w), np.float32)
        img[3] = 1.0
        dep = np.ones((h, w), np.float32)
        time.sleep(0.2)
        for f in range(12):
            s0.send(f, img, dep)
            s1.send(f, img, dep)
            head.pump(timeout_ms=50)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and head.frames_composited < 10:
            head.pump(timeout_ms=100)
        frames = {i for i, _ in got}
        degraded = {i for i, p in got if p.get("degraded")}
        complete = {i for i, p in got if not p.get("degraded")}
        assert degraded, got
        assert s1.swallowed == 6
        assert all(p["missing_ranks"] == [1]
                   for i, p in got if p.get("degraded"))
        assert any(e["component"] == "head.rank_down"
                   for e in tobs.ledger())
        assert complete & {f for f in frames if f >= 8}
        assert head.frames_degraded == len(degraded)
    finally:
        for s in (s0, s1):
            if s is not None:
                s.close()
        head.close()


def test_kill_producer_ends_a_running_shm_producer():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain (g++) for the demo producer")
    from scenery_insitu_tpu_torch.ingest import shm as tshm

    tobs.clear_ledger()
    ch = f"/sitpu_torch_faults_{uuid.uuid4().hex[:12]}"
    d = 12
    proc = subprocess.Popen([tshm.demo_producer(), ch, "field", str(d),
                             "100000", "2"], stdout=subprocess.DEVNULL)
    src = None
    try:
        src = tshm.ShmVolumeSource(ch, (d, d, d), timeout_ms=5000,
                                   frame_timeout_ms=200, device="cpu")
        src.advance(1)
        before = src.field.clone()
        assert torch.isfinite(before).all()
        code = tfaults.kill_producer(proc)
        assert code != 0 and proc.poll() is not None
        for _ in range(3):                 # the ring holds the last frame
            src.advance(1)
        assert torch.isfinite(src.field).all()
        assert any(e["component"] == "ingest.stall" for e in tobs.ledger())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        if src is not None:
            src.close()
        tshm.unlink(ch)


def test_cli_writes_the_report(reports, tmp_path, monkeypatch, capsys):
    _, port = reports
    calls = []

    def fake(seed, frames, device):
        calls.append((seed, frames, device))
        return port

    monkeypatch.setattr(tfaults, "run_matrix", fake)
    out = tmp_path / "r.json"
    assert tfaults.main(["--seed", "7", "--device", "cpu", "--out",
                         str(out)]) == 0
    assert calls == [(7, 12, "cpu")]
    assert json.loads(out.read_text()) == json.loads(json.dumps(port))
    assert f"15/{SCENARIOS} scenarios" in capsys.readouterr().out

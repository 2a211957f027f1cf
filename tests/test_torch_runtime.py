"""Parity of the port's runtime plumbing with the JAX package's, on the
CPU: ``Timers``, ``Recorder`` (spans, counters, events, the fallback
ledger, the exporters and the flight recorder), ``SLOEngine``,
``SinkGuard`` quarantine and ``DeliveryExecutor`` order and overflow.
Each is driven by one script through both packages and their outcomes
compared; wall-clock durations are left out, counts and orders compared
exactly. The port's ledger and counter registries are held equal to the
``degrade`` and ``count`` sites of its own modules."""

import ast
import json
import os
import threading

import pytest

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu.obs import slo as jslo
from scenery_insitu_tpu.runtime import delivery as jdel
from scenery_insitu_tpu.runtime import failsafe as jfs
from scenery_insitu_tpu.runtime import timers as jtim
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.obs import slo as tslo
from scenery_insitu_tpu_torch.runtime import delivery as tdel
from scenery_insitu_tpu_torch.runtime import failsafe as tfs
from scenery_insitu_tpu_torch.runtime import timers as ttim
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (timers, obs, slo, failsafe, delivery, config) of each package
PACKAGES = {"jax": (jtim, jobs, jslo, jfs, jdel, jcfg),
            "port": (ttim, tobs, tslo, tfs, tdel, tcfg)}


def _both(script):
    """``script(*modules)`` through both packages, each with an empty
    ledger and its own recorder installed."""
    out = {}
    for name, mods in PACKAGES.items():
        obs = mods[1]
        obs.clear_ledger()
        prev = obs.set_recorder(obs.Recorder(enabled=False))
        try:
            out[name] = script(*mods)
        finally:
            obs.set_recorder(prev)
            obs.clear_ledger()
    return out["port"], out["jax"]


def _ledger(obs):
    return [{k: v for k, v in e.items() if k != "t"} for e in obs.ledger()]


def test_timers_match():
    def script(tim, *_):
        lines = []
        t = tim.Timers(window=2, log=lines.append, rank=3)
        for name, secs in [("sim", 0.01), ("dispatch", 0.02),
                           ("sim", 0.03), ("fetch", 0.0)]:
            t.record(name, secs)
        t.marker("COMP", 4, 0.5)
        t.dump_window()
        t.record("sinks", 0.25)
        t.dump_totals()
        frames = tim.Timers(window=2)
        for _ in range(3):
            frames.frame_done()
        return (t.csv(), lines, t.fps("sim"), t.fps("nosuch"),
                frames.frames, frames.stats["frame"].n,
                tim.PhaseStats().csv())

    got, want = _both(script)
    assert got == want


def test_recorder_matches():
    def script(_, obs, *__):
        lines = []
        rec = obs.Recorder(enabled=True, rank=2, window=2, log=lines.append)
        obs.set_recorder(rec)
        with rec.span("sim", frame=0, kind="gray_scott"):
            with rec.span("inner"):
                pass
        rec.count("frames_eager_dispatch")
        rec.count("frames_eager_dispatch", 2)
        rec.event("compile", frame=1, what="vdi_step")
        obs.degrade("io.vdi_codec", "zstd", "zlib", "why", warn=False)
        obs.degrade("io.vdi_codec", "zstd", "zlib", "why", warn=False)
        rec.frame_done()
        summary = rec.summary()
        phases = {k: v["n"] for k, v in summary.pop("phases").items()}
        summary["degradations"] = [{k: v for k, v in e.items() if k != "t"}
                                   for e in summary["degradations"]]
        trace = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                 for e in rec.chrome_trace_events()]
        for e in trace:
            e.get("args", {}).pop("t", None)
        off = obs.Recorder(enabled=False)
        with off.span("sim"):
            pass
        off.count("x")
        off.event("e")
        return (summary, phases, trace, [e["type"] for e in rec.events],
                obs.get_recorder() is rec, off.events, off.counters,
                off.timers.stats["sim"].n)

    got, want = _both(script)
    assert got == want


def test_recorder_exporters_and_flight_flush(tmp_path):
    def script(_, obs, *__):
        d = tmp_path / obs.__name__.split(".")[0]
        d.mkdir()
        rec = obs.Recorder(enabled=True, trace_path=str(d / "t.json"),
                           metrics_path=str(d / "m.jsonl"))
        with rec.span("fetch", frame=3):
            pass
        rec.count("sink_failures")
        rec.flush()
        trace = json.loads((d / "t.json").read_text())
        lines = [json.loads(x) for x in
                 (d / "m.jsonl").read_text().splitlines()]
        dumped = obs.flight_flush(rec, where="run")
        quiet = obs.flight_flush(obs.Recorder(enabled=False))
        return ([(e["ph"], e["name"]) for e in trace["traceEvents"]],
                trace["displayTimeUnit"], [x["type"] for x in lines],
                lines[-1]["counters"], dumped, quiet, rec.counters,
                _ledger(obs))

    got, want = _both(script)
    assert got == want


def test_slo_engine_matches():
    samples = [5.0, 12.0, 15.0, 3.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
               30.0, 1.0]

    def script(_, obs, slo, __, ___, cfg):
        rec = obs.Recorder(enabled=True)
        eng = slo.SLOEngine(cfg.SLOConfig(enabled=True, window=8,
                                          min_samples=2, frame_p99_ms=10.0,
                                          phase_p99_ms=1.0), recorder=rec)
        states = []
        for i, x in enumerate(samples):
            eng.observe("frame_ms", x, frame=i)
            states.append(eng.breached("frame_ms"))
        eng.observe_phase("sim", 0.002)
        eng.observe_phase("sim", 0.0005)
        eng.observe("custom", 7.0)
        off = slo.SLOEngine(cfg.SLOConfig())
        off.observe("frame_ms", 99.0)
        return (states, eng.snapshot(), eng.quantile("frame_ms", 0.5),
                eng.breached(), rec.counters,
                [e["attrs"] for e in rec.events if e["type"] == "instant"],
                _ledger(obs), off.snapshot())

    got, want = _both(script)
    assert got == want
    assert got[1]["metrics"]["frame_ms"]["breaches"] == 2


def test_sink_guard_quarantine_matches():
    def script(_, obs, __, fs, *___):
        calls = []
        rec = obs.Recorder(enabled=False)
        obs.set_recorder(rec)

        def ok(i, p):
            calls.append(("ok", i))

        def bad(i, p):
            calls.append(("bad", i))
            raise RuntimeError("disk full")

        state = {"n": 0}

        def flaky(i, p):
            state["n"] += 1
            calls.append(("flaky", i))
            if state["n"] == 1:
                raise OSError("once")

        logs = []
        guard = fs.SinkGuard(max_failures=2, log=logs.append)
        counts = [guard.run([ok, bad, flaky], i, {}) for i in range(4)]
        out = (counts, calls, guard.quarantined_names,
               guard.is_quarantined(bad), guard.is_quarantined(flaky),
               rec.counters, _ledger(obs), len(logs))
        was = guard.reset(bad)
        return out + (was, guard.is_quarantined(bad), guard.reset(ok),
                      _ledger(obs))

    got, want = _both(script)
    assert got == want
    with pytest.raises(ValueError):
        tfs.SinkGuard(max_failures=0)


def test_delivery_order_matches():
    def script(_, obs, __, fs, dl, cfg):
        seen = []
        rec = obs.Recorder(enabled=True)
        ex = dl.DeliveryExecutor(
            cfg.DeliveryConfig(enabled=True, queue_frames=2),
            fs.SinkGuard(), [lambda i, p: seen.append(("tile", i,
                                                       p["tile"]))],
            [lambda i, p: seen.append(("frame", i))], recorder=rec)
        for i in range(5):
            ex.submit(i, {"frame": i},
                      [{"tile": t, "frame": i} for t in range(2)])
        assert ex.drain(timeout_s=30.0)
        ex.close()
        return (seen, ex.enqueued, ex.delivered, ex.sheds, rec.counters,
                sorted({e["name"] for e in rec.events}))

    got, want = _both(script)
    assert got == want
    assert got[0][:3] == [("tile", 0, 0), ("tile", 0, 1), ("frame", 0)]


def test_delivery_drop_oldest_matches():
    """A wedged worker holds frame 0; frames 1 and 2 are shed latest-wins
    as 3 arrives behind them; drain delivers 0 and 3."""
    def script(_, obs, __, fs, dl, cfg):
        seen, entered, gate = [], threading.Event(), threading.Event()

        def sink(i, p):
            if i == 0:
                entered.set()
                gate.wait(30.0)
            seen.append(i)

        rec = obs.Recorder(enabled=False)
        ex = dl.DeliveryExecutor(
            cfg.DeliveryConfig(enabled=True, queue_frames=1,
                               overflow="drop_oldest"),
            fs.SinkGuard(), [], [sink], recorder=rec)
        ok = [ex.submit(0, {})]
        assert entered.wait(30.0)
        ok += [ex.submit(i, {}) for i in (1, 2, 3)]
        gate.set()
        assert ex.drain(timeout_s=30.0)
        ex.close()
        with pytest.raises(RuntimeError, match="closed"):
            ex.submit(9, {})
        return (ok, seen, ex.sheds, ex.delivered, rec.counters,
                [e["component"] for e in _ledger(obs)])

    got, want = _both(script)
    assert got == want
    assert got[1] == [0, 3]


def test_delivery_drain_timeout_matches():
    def script(_, obs, __, fs, dl, cfg):
        gate = threading.Event()
        ex = dl.DeliveryExecutor(cfg.DeliveryConfig(enabled=True),
                                 fs.SinkGuard(), [],
                                 [lambda i, p: gate.wait(30.0)])
        ex.submit(0, {})
        ex.submit(1, {})
        clean = ex.drain(timeout_s=0.2)
        gate.set()
        ex.close()
        return clean, [e["component"] for e in _ledger(obs)]

    got, want = _both(script)
    assert got == want == (False, ["delivery.drain"])


def _sites(call: str):
    """String literals passed first to ``call(...)`` (a name or an
    attribute) in the port's modules."""
    found = set()
    pkg = os.path.join(ROOT, "scenery_insitu_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else \
                    getattr(fn, "id", None)
                arg = node.args[0]
                if name == call and isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    found.add(arg.value)
    return found


def test_registries_match_the_sites():
    """Every component a ``degrade`` site of the port mints and every
    counter a ``count`` site bumps is registered, and every registry row
    has a live site; each row's meaning is the reference's where the
    reference has the same row."""
    assert _sites("degrade") == set(tobs.ledger_registry())
    assert _sites("count") == set(tobs.counter_registry())
    jled, jcnt = jobs.ledger_registry(), jobs.counter_registry()
    for k, v in tobs.ledger_registry().items():
        assert v == jled[k], k
    for k in tobs.counter_registry():
        assert k in jcnt, k

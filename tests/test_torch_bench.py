"""The port's user entries on the CPU: the benchmark twin of the
reference's ``bench.py`` (``python -m scenery_insitu_tpu_torch.bench``)
and the twin of ``__graft_entry__.entry()``."""

import json

import pytest
import torch

from scenery_insitu_tpu_torch import bench
from scenery_insitu_tpu_torch.entry import entry
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401


def test_bench_prints_one_json_line(monkeypatch, capsys):
    """A 16^3 run with the sim-fused occupancy: one JSON line in the
    reference's shape."""
    for name, value in (("GRID", "16"), ("SKIP", "sim"), ("FRAMES", "2"),
                        ("K", "6")):
        monkeypatch.setenv(f"SITPU_BENCH_{name}", value)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "gray_scott_16c_vdi_fps_24x24_cpu_1chip"
    assert out["unit"] == "frames/s" and out["value"] > 0
    assert out["ms_per_frame"] > 0
    occ = out["occupancy"]
    assert occ["mode"] == "sim" and occ["vtiles"] == 8
    assert 0.0 <= occ["live_fraction"] <= 1.0
    assert sum(occ["chunk_live_hist"]) == 1        # one chunk of 16 slices
    cfg = out["config"]
    assert (cfg["grid"], cfg["k"], cfg["frames"], cfg["skip"]) == \
        (16, 6, 2, "sim")
    assert cfg["platform"] == "cpu" and cfg["power_limit"] is None
    # the modeled 8-rank render plan of the final field (one card marches
    # one band whatever the plan)
    assert cfg["rebalance"] == "even"
    reb = out["rebalance"]
    assert reb["mode"] == "even" and reb["modeled_ranks"] == 8
    assert sum(reb["plan"]) == 16 and reb["straggler_planned"] > 0


# knobs that raised once and are ported now: value -> resolved setting
PORTED_KNOBS = {"ENGINE": {"gather": "gather"},
                "RENDER_DTYPE": {"bf16": "bf16"},
                "EXCHANGE": {"ring": "ring"}, "WIRE": {"qpack8": "qpack8"},
                "SCHEDULE": {"waves": "waves"},
                "REBALANCE": {"occupancy": "occupancy"},
                "PROFILE": {"1": True}}


@pytest.mark.parametrize("knob,value", [
    ("ENGINE", "gather"), ("SCAN_FRAMES", "1"), ("RENDER_DTYPE", "bf16"),
    ("AUTOTUNE", "1"), ("PROFILE", "1"), ("EXCHANGE", "ring"),
    ("WIRE", "qpack8"), ("SCHEDULE", "waves"), ("REBALANCE", "occupancy")])
def test_bench_unported_knobs_raise(knob, value):
    """Each knob of a part not yet ported raises, naming its ROADMAP row;
    a knob ported since (the gather engine; the render dtype, the bf16
    march copy; the exchange, the wire, the schedule and the rebalance
    plans; the phase attribution) takes the value instead."""
    env = {f"SITPU_BENCH_{knob}": value}
    if knob in PORTED_KNOBS:
        cfg = bench.bench_config(env, on_card=False)
        assert cfg[knob.lower()] == PORTED_KNOBS[knob][value]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        bench.bench_config(env, on_card=False)



@pytest.mark.parametrize("grid,want", [(128, "f32"), (512, "f32"),
                                       (1024, "bf16"), (2048, "bf16")])
def test_bench_render_dtype_defaults_by_grid(grid, want):
    """As the reference's bench.py: the bf16 march copy from 1024^3 up."""
    cfg = bench.bench_config({"SITPU_BENCH_GRID": str(grid)}, on_card=True)
    assert cfg["render_dtype"] == want


@pytest.mark.parametrize("value,want", [("bfloat16", "bf16"),
                                        ("float32", "f32"), ("f32", "f32")])
def test_bench_render_dtype_long_spellings(value, want):
    cfg = bench.bench_config({"SITPU_BENCH_RENDER_DTYPE": value,
                              "SITPU_BENCH_GRID": "1024"}, on_card=False)
    assert cfg["render_dtype"] == want


@pytest.mark.parametrize("value", ["f16", "fp8", "BF16", ""])
def test_bench_render_dtype_bad_value_raises(value):
    with pytest.raises(ValueError, match="RENDER_DTYPE"):
        bench.bench_config({"SITPU_BENCH_RENDER_DTYPE": value},
                           on_card=False)


def test_bench_bf16_run_reports_render_dtype(monkeypatch, capsys):
    """A 16^3 CPU run with the bf16 march copy: the frame step gets the
    dtype and the JSON line's config reports it from the step's spec."""
    for name, value in (("GRID", "16"), ("FRAMES", "1"), ("K", "4"),
                        ("RENDER_DTYPE", "bf16")):
        monkeypatch.setenv(f"SITPU_BENCH_{name}", value)
    assert bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config"]["render_dtype"] == "bf16"
    assert out["value"] > 0


def test_bench_defaults_and_bad_values():
    cfg = bench.bench_config({"SITPU_BENCH_ENGINE": "auto"}, on_card=True)
    assert (cfg["grid"], cfg["frames"], cfg["skip"]) == (512, 25, None)
    assert bench.bench_config({}, on_card=False)["grid"] == 128
    with pytest.raises(ValueError, match="SKIP"):
        bench.bench_config({"SITPU_BENCH_SKIP": "bricks"}, on_card=False)


def test_bench_and_entry_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (bench.run, entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_entry_on_cpu():
    """The reference entry's frame: 64^3, 5 sim steps, the z march from
    +z; one call of the step on its example arguments."""
    step, (u, v, eye) = entry(device="cpu")
    assert tuple(u.shape) == tuple(v.shape) == (64, 64, 64)
    assert eye.tolist() == pytest.approx([0.0, 0.5, 3.2])
    spec = step.spec
    assert (spec.axis, spec.sign, spec.ni, spec.nj) == (2, -1, 80, 80)
    color, depth, u2, v2 = step(u, v, eye)
    assert tuple(color.shape) == (8, 4, 80, 80)
    assert tuple(depth.shape) == (8, 2, 80, 80)
    assert bool(torch.isfinite(color).all())
    assert bool(torch.isfinite(depth[:, 0]).any())
    assert not torch.equal(v2, v)


def test_bench_exchange_knobs_report_the_model(monkeypatch, capsys):
    """The exchange, wire and schedule knobs resolve as the reference's
    bench resolves them, go into the config block, and the JSON carries
    the reference's modeled 8-rank exchange traffic; the one-card frame
    runs unchanged."""
    from scenery_insitu_tpu.ops.composite import modeled_exchange_traffic

    for name, value in (("GRID", "16"), ("FRAMES", "1"), ("K", "4"),
                        ("EXCHANGE", "ring"), ("WIRE", "qpack8"),
                        ("SCHEDULE", "waves"), ("WAVE_TILES", "2")):
        monkeypatch.setenv(f"SITPU_BENCH_{name}", value)
    assert bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = out["config"]
    assert (cfg["exchange"], cfg["wire"], cfg["schedule"],
            cfg["wave_tiles"]) == ("ring", "qpack8", "waves", 2)
    assert out["modeled_exchange_8rank"] == modeled_exchange_traffic(
        8, 4, 720, 1280, k_out=4, mode="ring", wire="qpack8",
        schedule="waves", wave_tiles=2)
    assert out["value"] > 0
    defaults = bench.bench_config({}, on_card=False)
    assert (defaults["exchange"], defaults["wire"], defaults["schedule"],
            defaults["wave_tiles"], defaults["width"],
            defaults["height"]) == ("all_to_all", "f32", "frame", 4, 1280,
                                    720)


@pytest.mark.parametrize("knob,value", [("EXCHANGE", "mesh"),
                                        ("WIRE", "f16"),
                                        ("SCHEDULE", "tiles"),
                                        ("WAVE_TILES", "0")])
def test_bench_exchange_knobs_bad_values_raise(knob, value):
    with pytest.raises(ValueError, match=knob.lower()):
        bench.bench_config({f"SITPU_BENCH_{knob}": value}, on_card=False)

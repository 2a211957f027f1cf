"""The port's user entries on the CPU: the benchmark twin of the
reference's ``bench.py`` (``python -m scenery_insitu_tpu_torch.bench``)
and the twin of ``__graft_entry__.entry()``."""

import json

import pytest
import torch

from scenery_insitu_tpu_torch import bench
from scenery_insitu_tpu_torch.entry import entry


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


@pytest.mark.parametrize("knob,value", [
    ("ENGINE", "gather"), ("SCAN_FRAMES", "1"), ("RENDER_DTYPE", "bf16"),
    ("AUTOTUNE", "1"), ("PROFILE", "1"), ("EXCHANGE", "ring"),
    ("WIRE", "qpack8"), ("SCHEDULE", "waves"), ("REBALANCE", "occupancy")])
def test_bench_unported_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        bench.bench_config({f"SITPU_BENCH_{knob}": value}, on_card=False)


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

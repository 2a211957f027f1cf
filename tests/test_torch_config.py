"""Parity of the port's ``FrameworkConfig`` with the JAX package's: every
section's defaults, the JSON round trip in both directions, and the
override parser (``with_overrides``, ``load`` with ``SITPU_*``
environment variables), which must give equal configs or raise the same
error type. The port alone rejects the sort-last exchange settings it
does not run (ROADMAP A8b)."""

import contextlib
import dataclasses
import json
import os

import pytest

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

SECTIONS = [f.name for f in dataclasses.fields(jcfg.FrameworkConfig)]


def test_sections_match():
    assert SECTIONS == [f.name for f in
                        dataclasses.fields(tcfg.FrameworkConfig)]
    assert tcfg.ENV_PREFIX == jcfg.ENV_PREFIX == "SITPU_"
    assert tcfg._REMOVED_KEYS == jcfg._REMOVED_KEYS


@pytest.mark.parametrize("section", SECTIONS)
def test_section_defaults_match(section):
    """Every field of every section, in the reference's order, with the
    reference's default."""
    jsec = type(getattr(jcfg.FrameworkConfig(), section))
    tsec = type(getattr(tcfg.FrameworkConfig(), section))
    assert [f.name for f in dataclasses.fields(tsec)] == \
        [f.name for f in dataclasses.fields(jsec)]
    assert dataclasses.asdict(tsec()) == dataclasses.asdict(jsec())


def test_json_round_trip_both_ways(tmp_path):
    over = ("render.width=320", "vdi.adaptive_mode=temporal",
            "sim.grid=[16,24,32]", "mesh.num_devices=4",
            "runtime.pipeline_depth=2", "serve.buckets=[1,4]",
            "composite.rebalance=bricks", "slo.enabled=true")
    jc = jcfg.FrameworkConfig().with_overrides(*over)
    tc = tcfg.FrameworkConfig().with_overrides(*over)
    assert jc.to_json() == tc.to_json()
    assert tcfg.FrameworkConfig.from_dict(json.loads(jc.to_json())) == tc
    assert jcfg.FrameworkConfig.from_dict(json.loads(tc.to_json())) == jc
    path = tmp_path / "cfg.json"
    path.write_text(jc.to_json())
    assert tcfg.FrameworkConfig.from_json_file(str(path)) == tc
    path.write_text(tc.to_json())
    assert jcfg.FrameworkConfig.from_json_file(str(path)) == jc


OVERRIDES = [
    ("render.width=512", "render.background=[1,1,1,1]"),
    ("sim.grid=[8,8,8]", "sim.dt=1", "sim.fused_stencil=false"),
    ("vdi.threshold=0.5", "vdi.adaptive=no"),
    ("slicer.scale=1", "slicer.fold=pallas_seg", "slicer.engine=mxu"),
    ("runtime.scan_frames=4", "runtime.generate_vdis=false"),
    ("obs.enabled=true", "obs.trace_path=t.json"),
    ("delivery.enabled=1", "delivery.overflow=drop_oldest"),
    ("lod.enabled=true", "lod.max_level=3"),
    ("topology.num_hosts=2",),
    ("fault.max_sink_failures=5", "stream.compress=zlib"),
    # errors: unknown section or key, bad value, missing '='
    ("nosuch.key=1",),
    ("render.nosuch=1",),
    ("vdi.adaptive_mode=nope",),
    ("runtime.pipeline_depth=0",),
    ("slo.window=4",),
    ("render.width",),
    ("render.width=abc",),
]


def _outcome(mod, over):
    try:
        return mod.FrameworkConfig().with_overrides(*over).to_dict()
    except Exception as e:      # the error type is the comparison
        return type(e)


@pytest.mark.parametrize("over", OVERRIDES, ids=lambda o: o[0])
def test_with_overrides_match(over):
    assert _outcome(tcfg, over) == _outcome(jcfg, over)


@pytest.mark.parametrize("over", [("composite.exchange=ring",),
                                  ("composite.wire=bf16",),
                                  ("composite.wire=qpack8",),
                                  ("composite.schedule=waves",)],
                         ids=lambda o: o[0])
def test_port_rejects_unported_composite(over):
    """The sort-last settings the port's CompositeConfig once rejected at
    construction (ROADMAP A8b items 1-3): the port now gives the
    reference's outcome, the same composite section, JSON included."""
    want = jcfg.FrameworkConfig().with_overrides(*over)
    got = tcfg.FrameworkConfig().with_overrides(*over)
    assert dataclasses.asdict(got.composite) == \
        dataclasses.asdict(want.composite)
    assert json.loads(got.to_json())["composite"] == \
        json.loads(want.to_json())["composite"]


ENVS = [
    {"SITPU_RENDER_WIDTH": "640", "SITPU_SIM_STEPS_PER_FRAME": "3",
     "SITPU_BENCH_GRID": "32", "SITPU_NOSECTION": "1"},
    {"SITPU_VDI_ADAPTIVE_MODE": "histogram",
     "SITPU_RUNTIME_PIPELINE_DEPTH": "2"},
    {"SITPU_MESH_DECOMPOSITION": "z"},
    {"SITPU_RENDER_NOSUCH": "1"},
    {"SITPU_VDI_ADAPTIVE_MODE": "nope"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: sorted(e)[0])
def test_load_from_env_matches(env, monkeypatch, tmp_path):
    """File < env < explicit overrides, in both packages."""
    for k in [k for k in os.environ if k.startswith("SITPU_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"render": {"width": 100, "height": 50}}))

    def outcome(mod):
        try:
            return mod.FrameworkConfig.load(
                str(path), overrides=("render.height=60",)).to_dict()
        except Exception as e:
            return type(e)

    removed = "SITPU_MESH_DECOMPOSITION" in env

    def warns():
        return pytest.warns(UserWarning) if removed \
            else contextlib.nullcontext()

    jobs.clear_ledger()
    with warns():
        want = outcome(jcfg)
    tobs.clear_ledger()
    with warns():
        got = outcome(tcfg)
    assert got == want
    if removed:
        assert [e["component"] for e in tobs.ledger()] == \
            ["config.removed_key"]


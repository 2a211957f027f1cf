"""The port's attribution plane (``obs/profiler.py``, ``obs/roofline.py``,
``obs/device.py``) against the JAX package's, on the CPU.

- Scope sets: the five distributed steps of ``tests/test_profiler.py``
  (frame schedule, tile waves, the gather ring, the two-level
  ``dcn_hop`` composite, the plain step) at its shapes (16^3 volume,
  16 x 16 image, N = 8) run in the port under a CPU ``torch.profiler``;
  each holds the phase subset the reference test asserts, and its set
  equals the reference's compiled scope set for the same step but
  for the differences named in `SCOPE_DIFFERENCES`.
- ``phase()`` enters no ``record_function`` without a profiler.
- Capture accounting as the reference's tests hold it: the phases sum
  to the wall within 15 %, scoped ops are joined, a disabled capture is
  inert, a failure degrades without raising; on a synthetic CUDA trace
  a kernel joins its launching call's scope by correlation (not by its
  own timestamps), ``External id`` where the call is missing.
- Roofline: the port's ``roofline_verdicts`` equals the reference's
  exactly on the reference tests' synthetic attributions, costs and
  explicit peaks; the H100 peaks follow the product dtype.
- The cost snapshot counts a matmul's bytes and FLOPs exactly (the bf16
  product's ``aten::bmm.dtype`` too, a broadcast operand by its own
  elements).
- The attribution rides the fleet trace (Perfetto tracks and an
  instant event).
- The bench twin with ``SITPU_BENCH_PROFILE=1`` at 32^3 prints the
  reference ``bench.py``'s keys with its CPU nulls.
"""

import json

import numpy as np
import pytest
import torch

from scenery_insitu_tpu import obs as jobs
from scenery_insitu_tpu.obs import profiler as jprof
from scenery_insitu_tpu.obs import roofline as jroof
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch.core.camera import Camera as TCamera
from scenery_insitu_tpu_torch.core.transfer import TransferFunction as TTF
from scenery_insitu_tpu_torch.core.volume import procedural_volume as tvol
from scenery_insitu_tpu_torch.obs import device as tdev
from scenery_insitu_tpu_torch.obs import profiler as tprof
from scenery_insitu_tpu_torch.obs import roofline as troof
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.parallel import topology as ttopo
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

CPU = "cpu"
W = H = 16
STEPS = 48
N = 8


@pytest.fixture(autouse=True)
def _isolate_obs():
    prev_t, prev_j = tobs.get_recorder(), jobs.get_recorder()
    tobs.clear_ledger()
    yield
    tobs.set_recorder(prev_t)
    jobs.set_recorder(prev_j)
    tobs.clear_ledger()


# ------------------------------------------------------------ scope sets

def _port_scene():
    cam = TCamera.create((0.0, 0.2, 4.0), fov_y_deg=50.0, near=0.5,
                         far=20.0, device=CPU)
    tf = TTF.ramp(0.05, 0.8, 0.7, device=CPU)
    vol = tvol(16, kind="blobs", device=CPU)
    spec = tsl.make_spec(cam, tuple(vol.data.shape),
                         tcfg.SliceMarchConfig(matmul_dtype="f32",
                                               scale=2.0), multiple_of=N)
    return cam, tf, vol, spec


def _vcfg(cfg):
    return cfg.VDIConfig(max_supersegments=6, adaptive_iters=2)


def _comp(cfg, **kw):
    return cfg.CompositeConfig(max_output_supersegments=8, adaptive_iters=2,
                               **kw)


def _port_step(name):
    """(step, mesh) of step ``name`` in the port."""
    cam, tf, vol, spec = _port_scene()
    mesh = tmesh.make_mesh(N, device=CPU)
    v = _vcfg(tcfg)
    if name == "frame":
        return tpipe.distributed_vdi_step_mxu(mesh, tf, spec, v,
                                              _comp(tcfg)), mesh
    if name == "waves":
        return tpipe.distributed_vdi_step_mxu(
            mesh, tf, spec, v, _comp(tcfg, schedule="waves", wave_tiles=2,
                                     exchange="ring")), mesh
    if name == "gather_ring":
        return tpipe.distributed_vdi_step(mesh, tf, W, H, v,
                                          _comp(tcfg, exchange="ring"),
                                          max_steps=STEPS), mesh
    if name == "hier":
        topo = tcfg.TopologyConfig(num_hosts=2)
        mesh, _ = ttopo.make_topology_mesh(
            topo, tcfg.MeshConfig(num_devices=N), device=CPU)
        return tpipe.distributed_vdi_step(mesh, tf, W, H, v,
                                          _comp(tcfg, exchange="ring"),
                                          max_steps=STEPS,
                                          topology=topo), mesh
    return tpipe.distributed_plain_step(
        mesh, tf, W, H, tcfg.RenderConfig(max_steps=STEPS)), mesh


def _reference_scopes(name):
    """The reference's compiled scope set of step ``name``, as
    ``tests/test_profiler.py`` computes it."""
    from scenery_insitu_tpu import config as jcfg
    from scenery_insitu_tpu.parallel.mesh import make_mesh
    from scenery_insitu_tpu.parallel.pipeline import (
        distributed_plain_step, distributed_vdi_step,
        distributed_vdi_step_mxu)
    from scenery_insitu_tpu.parallel.topology import make_topology_mesh
    from tests.test_profiler import (_cam, _compiled_scopes, _mxu_spec, _tf,
                                     _vol)

    vol, cam = _vol(), _cam()
    mesh = make_mesh(N)
    v = _vcfg(jcfg)
    if name == "frame":
        step = distributed_vdi_step_mxu(mesh, _tf(), _mxu_spec(cam, vol), v,
                                        _comp(jcfg))
    elif name == "waves":
        step = distributed_vdi_step_mxu(
            mesh, _tf(), _mxu_spec(cam, vol), v,
            _comp(jcfg, schedule="waves", wave_tiles=2, exchange="ring"))
    elif name == "gather_ring":
        step = distributed_vdi_step(mesh, _tf(), W, H, v,
                                    _comp(jcfg, exchange="ring"),
                                    max_steps=STEPS)
    elif name == "hier":
        topo = jcfg.TopologyConfig(num_hosts=2)
        mesh, _ = make_topology_mesh(topo)
        step = distributed_vdi_step(mesh, _tf(), W, H, v,
                                    _comp(jcfg, exchange="ring"),
                                    max_steps=STEPS, topology=topo)
    else:
        step = distributed_plain_step(mesh, _tf(), W, H,
                                      jcfg.RenderConfig(max_steps=STEPS))
    return _compiled_scopes(step, vol, mesh, cam)


def _port_scopes(name):
    """The phase scopes one profiled call of the port's step enters."""
    from torch.profiler import ProfilerActivity, profile

    cam, _, vol, _ = _port_scene()
    step, mesh = _port_step(name)
    data = tmesh.shard_volume(vol.data, mesh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(data, vol.origin, vol.spacing, cam)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return {n[len(tprof.SCOPE_PREFIX):] for n in names
            if n.startswith(tprof.SCOPE_PREFIX)} & set(tprof.PHASES)


# what the reference test asserts of each step: (required subset,
# phases of which at least one must be present)
ASSERTED = {
    "frame": ({"march", "exchange", "merge", "resegment"}, set()),
    "waves": ({"wave", "march", "merge"}, {"exchange", "wire_encode"}),
    "gather_ring": ({"march", "exchange", "merge", "resegment"}, set()),
    "hier": ({"dcn_hop", "march", "merge", "resegment"}, set()),
    "plain": ({"march"}, {"merge", "exchange"}),
}
# phase -> why the port's set holds it and the reference's compiled one
# does not
_F32_CODEC = ("the f32 wire's codec is the identity in both packages: "
              "XLA drops the empty wire_encode scope from the compiled "
              "program, while the port's record_function still enters it")
SCOPE_DIFFERENCES = {
    "frame": {},
    "waves": {"wire_encode": _F32_CODEC},
    "gather_ring": {"wire_encode": _F32_CODEC},
    "hier": {"wire_encode": _F32_CODEC},
    "plain": {},
}


@pytest.mark.parametrize("name", sorted(ASSERTED))
def test_scope_sets_match_reference(name):
    port = _port_scopes(name)
    need, any_of = ASSERTED[name]
    assert need <= port, (name, port)
    assert not any_of or port & any_of, (name, port)
    ref = _reference_scopes(name) & set(tprof.PHASES)
    assert port - ref == set(SCOPE_DIFFERENCES[name]), (name, port, ref)
    assert ref - port == set(), (name, port, ref)


def test_phase_enters_no_record_function_without_profiler(monkeypatch):
    """An unprofiled frame pays no ``record_function``: ``phase`` hands
    back one shared null context; under a profiler it opens one a
    scope."""
    from torch.autograd import profiler as ap
    from torch.profiler import ProfilerActivity, profile

    made = []
    real = ap.record_function

    def counting(name, *a, **kw):
        made.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(ap, "record_function", counting)
    step, mesh = _port_step("frame")
    cam, _, vol, _ = _port_scene()
    data = tmesh.shard_volume(vol.data, mesh)
    step(data, vol.origin, vol.spacing, cam)
    assert made == []
    assert tprof.phase("march") is tprof.phase("merge")
    with profile(activities=[ProfilerActivity.CPU]):
        step(data, vol.origin, vol.spacing, cam)
    assert "sitpu_march" in made and "sitpu_resegment" in made


@pytest.mark.parametrize("path", [
    "jit(step)/sitpu_wave/while/sitpu_march/dot", "jit(step)/transpose",
    "sitpu_exchange/ppermute", "sitpu_dcn_hop/sitpu_wire_encode", ""])
def test_scope_of_matches_reference(path):
    assert tprof.scope_of(path) == jprof.scope_of(path)
    assert tprof.scope_names(path) == jprof.scope_names(path)
    assert tprof.PHASES == jprof.PHASES
    assert tprof.EXTRA_PHASES == jprof.EXTRA_PHASES


# ------------------------------------------------------ capture accounting

def _two_phase(x):
    with tprof.phase("march"):
        y = x @ x
    with tprof.phase("merge"):
        return torch.tanh(y).sum()


def test_capture_sum_matches_wall():
    """The per-phase ms (scoped + unattributed + host) sum to the
    measured wall clock within 15 % (by construction: the host gap and
    the normalization), and every phase is in the catalog."""
    x = torch.ones((256, 256))
    attr = tprof.ProfileCapture(frames=3, warmup=1, devices=1).capture(
        _two_phase, x)
    assert attr is not None
    assert attr["type"] == "phase_attribution"
    assert attr["backend"] == "cpu" and attr["hlo_module"] is None
    total = sum(p["ms"] for p in attr["phases"].values())
    wall = attr["wall_ms_per_frame"]
    assert abs(total - wall) <= max(0.15 * wall, 0.05), (total, wall)
    for name in attr["phases"]:
        assert name in tprof.PHASES or name in tprof.EXTRA_PHASES, name
    assert attr["coverage"] is not None and attr["coverage"] <= 1.0
    assert attr["phases"]["host"]["ms"] >= 0.0
    assert set(attr) == {
        "type", "backend", "device_kind", "hlo_module", "frames",
        "devices", "wall_ms_per_frame", "device_ms_per_frame",
        "host_hook_ms_per_frame", "coverage", "op_parallelism",
        "normalized", "scoped_ops", "events_total", "events_joined",
        "phases"}


def test_capture_joins_scoped_ops():
    x = torch.ones((512, 512))

    def f(x):
        with tprof.phase("march"):
            return (x @ x).sum()

    rec = tobs.Recorder(enabled=True)
    tobs.set_recorder(rec)
    attr = tprof.ProfileCapture(frames=2, devices=1).capture(f, x)
    assert attr is not None
    assert attr["scoped_ops"] == 1
    assert attr["events_joined"] > 0
    assert attr["phases"]["march"]["events"] > 0
    assert rec.counters.get("profile_captures") == 1


def test_capture_of_a_port_frame_step():
    """The 16^3 temporal frame step under the capture: the sim, the
    march and the composite land in their phases and the sum holds."""
    from scenery_insitu_tpu_torch.core.camera import orbit
    from scenery_insitu_tpu_torch.models.pipelines import (
        grayscott_vdi_frame_step)
    from scenery_insitu_tpu_torch.sim import grayscott as tgs

    base = TCamera.create((0.0, 0.6, 3.0), device=CPU)
    step = grayscott_vdi_frame_step(
        sim_steps=2, grid_shape=(16,) * 3, axis_sign=tsl.choose_axis(base),
        vdi_cfg=tcfg.VDIConfig(max_supersegments=4, adaptive_mode="temporal",
                               histogram_bins=8),
        comp_cfg=tcfg.CompositeConfig(max_output_supersegments=4),
        device=CPU)
    st = tgs.GrayScott.init((16,) * 3, seed=0, device=CPU)
    state = [st.u, st.v, step.init_threshold(st.u, st.v, base.eye)]

    def one():
        _, _, state[0], state[1], state[2] = step(
            state[0], state[1], orbit(base, 0.1).eye, state[2])

    attr = tprof.ProfileCapture(frames=2).capture(step, step=one)
    assert attr is not None and attr["devices"] == 1
    assert {"sim_step", "march", "merge"} <= set(attr["phases"])
    total = sum(p["ms"] for p in attr["phases"].values())
    wall = attr["wall_ms_per_frame"]
    assert abs(total - wall) <= 0.15 * wall, (total, wall)


def test_capture_disabled_is_inert():
    calls = []
    out = tprof.ProfileCapture(enabled=False).capture(
        lambda: calls.append(1), step=lambda: calls.append(2))
    assert out is None and not calls


def test_capture_failure_degrades_not_raises():
    class NotCallable:
        pass

    out = tprof.ProfileCapture().capture(NotCallable())
    assert out is None
    assert any(e["component"] == "obs.profiler" for e in tobs.ledger())


def test_join_trace_links_kernels_through_their_launch():
    """A synthetic CUDA trace: kernels run after the host scope closed,
    so each joins its launching runtime call's innermost scope by
    ``args.correlation``; a memcpy whose call is missing joins through
    ``External id``; a kernel launched outside any scope is
    unattributed."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "sitpu_wave",
         "pid": 1, "tid": 7, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "sitpu_march",
         "pid": 1, "tid": 7, "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 12.0, "dur": 1.0,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 50.0, "dur": 1.0,
         "args": {"correlation": 6}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 150.0, "dur": 1.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 1,
         "tid": 7, "ts": 14.0, "dur": 2.0, "args": {"External id": 40}},
        # device events, all after the scopes closed
        {"ph": "X", "cat": "kernel", "name": "seg_fold_kernel<16>",
         "pid": 0, "tid": 9, "ts": 500.0, "dur": 30.0,
         "args": {"correlation": 5, "device": 0}},
        {"ph": "X", "cat": "kernel", "name": "resegment_kernel",
         "pid": 0, "tid": 9, "ts": 600.0, "dur": 10.0,
         "args": {"correlation": 6, "device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD",
         "pid": 0, "tid": 9, "ts": 700.0, "dur": 4.0,
         "args": {"correlation": 99, "External id": 40, "device": 0}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "pid": 0,
         "tid": 9, "ts": 800.0, "dur": 6.0,
         "args": {"correlation": 7, "device": 0}},
    ]
    rows, scopes, devices = tprof.join_trace(ev)
    assert scopes == {"wave", "march"} and devices == 1
    assert rows == [("seg_fold_kernel<16>", "march", 30.0),
                    ("resegment_kernel", "wave", 10.0),
                    ("Memcpy DtoD", "march", 4.0),
                    ("elementwise", None, 6.0)]


def test_join_trace_counts_cpu_ops_by_self_time():
    """A CPU trace: ``aten::matmul`` contains ``aten::mm``; each counts
    its self time only."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "sitpu_march",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "pid": 1,
         "tid": 1, "ts": 10.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 12.0, "dur": 40.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "pid": 1,
         "tid": 1, "ts": 120.0, "dur": 5.0},
    ]
    rows, _, devices = tprof.join_trace(ev)
    assert devices == 0
    assert sorted(rows) == [("aten::matmul", "march", 10.0),
                            ("aten::mm", "march", 40.0),
                            ("aten::sum", None, 5.0)]


# ------------------------------------------------------ roofline verdicts

def _attr(phases, wall=None, devices=1):
    total = sum(phases.values())
    wall = wall if wall is not None else total
    return {"type": "phase_attribution", "backend": "cpu",
            "device_kind": "cpu", "frames": 1, "devices": devices,
            "wall_ms_per_frame": wall, "device_ms_per_frame": total,
            "coverage": min(1.0, total / wall),
            "phases": {k: {"ms": v, "events": 1}
                       for k, v in phases.items()}}


_PEAKS = {"tflops": 100.0, "hbm_gbps": 100.0, "ici_gbps": 45.0,
          "dcn_gbps": 3.125, "device_kind": "synthetic",
          "platform": "tpu", "peaks_source": "test"}
ROOFLINE_CASES = {
    "hbm": (_attr({"march": 100.0}),
            {"source": "xla_cost_analysis", "bytes_accessed": 8.2e9,
             "flops": 1e9}, _PEAKS, None),
    "mxu": (_attr({"march": 1000.0}),
            {"source": "xla_cost_analysis", "bytes_accessed": 1e9,
             "flops": 9e13}, {**_PEAKS, "hbm_gbps": 1000.0}, None),
    "comm_and_host": (
        _attr({"march": 1.0, "exchange": 5.0, "dcn_hop": 5.0,
               "host": 10.0}),
        {"source": "xla_cost_analysis", "bytes_accessed": 1e6,
         "flops": 1e6}, _PEAKS,
        {"ici_bytes_per_frame": 200e6, "dcn_bytes_per_frame": 10e6}),
    "cpu_relative": (_attr({"march": 1.0}),
                     {"source": "xla_cost_analysis", "bytes_accessed": 1e6,
                      "flops": 1e6}, jroof.peaks_for("cpu", "cpu"), None),
    "no_cost": (_attr({"march": 2.0, "merge": 1.0, "unattributed": 0.5},
                      wall=4.0), None, _PEAKS, None),
}


@pytest.mark.parametrize("case", sorted(ROOFLINE_CASES))
def test_roofline_verdicts_equal_reference(case):
    attr, cost, peaks, modeled = ROOFLINE_CASES[case]
    got = troof.roofline_verdicts(attr, cost, peaks, modeled=modeled)
    want = jroof.roofline_verdicts(attr, cost, peaks, modeled=modeled)
    assert got == want
    assert troof.COMM_PHASES == jroof.COMM_PHASES


def test_h100_peaks_follow_the_product_dtype():
    kind = "NVIDIA H100 80GB HBM3"
    bf16 = troof.peaks_for(kind, "gpu", "bf16", "700.00 W")
    f32 = troof.peaks_for(kind, "gpu", "f32", "700.00 W")
    assert (bf16["tflops"], f32["tflops"]) == (989.0, 67.0)
    assert bf16["hbm_gbps"] == f32["hbm_gbps"] == 3350.0
    assert bf16["ici_gbps"] == 900.0 and bf16["dcn_gbps"] is None
    assert bf16["power_limit"] == "700.00 W"
    assert "H100" in bf16["peaks_source"] and "700 W" in \
        bf16["peaks_source"]
    cpu = troof.peaks_for("cpu", "cpu")
    assert "relative" in cpu["peaks_source"]
    assert troof.peak_tflops("cpu", "cpu") is None
    # no inter-node peak: a dcn_hop verdict carries no fraction
    v = troof.roofline_verdicts(
        _attr({"march": 1.0, "dcn_hop": 2.0}),
        {"source": "torch_dispatch_count", "bytes_accessed": 1e9,
         "flops": 1e9}, bf16, modeled={"dcn_bytes_per_frame": 1e6})
    assert v["verdicts"]["dcn_hop"]["bound"] == "ici-dcn"
    assert "link_frac_peak" not in v["verdicts"]["dcn_hop"]
    assert v["verdicts"]["dcn_hop"]["achieved_gbps"] == 0.5


# ----------------------------------------------------------- cost snapshot

def test_cost_snapshot_counts_bytes_and_flops():
    """One [64, 64] matmul and a sum: operands and outputs once each,
    the view moves nothing, 2 m n k FLOPs."""
    x = torch.ones((64, 64))

    def f(x):
        return (x @ x).view(-1).sum()

    snap = tdev.cost_snapshot(f, x)
    el = 64 * 64 * 4
    assert snap == {"source": "torch_dispatch_count",
                    "bytes_accessed": float(3 * el + el + 4),
                    "kernel_bytes": 0.0, "flops": 2.0 * 64 ** 3}
    # the bf16 product's overload, aten::bmm.dtype (its out_dtype is
    # a positional operand the formula does not take), on meta tensors:
    # the CPU has no kernel for it
    a = torch.empty((2, 8, 4), dtype=torch.bfloat16, device="meta")
    b = torch.empty((2, 4, 3), dtype=torch.bfloat16, device="meta")
    snap = tdev.cost_snapshot(
        lambda: torch.bmm(a, b, out_dtype=torch.float32))
    assert snap == {"source": "torch_dispatch_count",
                    "bytes_accessed": float(2 * (32 + 12) * 2 + 48 * 4),
                    "kernel_bytes": 0.0, "flops": 2.0 * 2 * 8 * 4 * 3}
    # a broadcast operand counts its own elements: [64, 1] expanded
    # along 64 columns is 64 floats read, not 4096
    col = torch.ones((64, 1))
    snap = tdev.cost_snapshot(lambda: x + col.expand(64, 64))
    assert snap["bytes_accessed"] == float(el + 64 * 4 + el)
    bad = tdev.device_cost(lambda: 1 / 0)
    assert bad["source"] == "unavailable" and "ZeroDivision" in bad["error"]
    assert any(e["component"] == "bench.cost_analysis"
               for e in tobs.ledger())


# ------------------------------------------------------ fleet-trace export

def test_attribution_rides_fleet_trace(tmp_path):
    rec = tobs.Recorder(enabled=True)
    tobs.set_recorder(rec)
    attr = _attr({"march": 2.0, "exchange": 1.0})
    tprof.publish_attribution(attr, frame=0)
    path = str(tmp_path / "trace.json")
    rec.export_chrome_trace(path)
    tprof.append_to_chrome_trace(attr, path)
    doc = json.load(open(path))
    names = [e.get("name") for e in doc["traceEvents"]]
    assert "phase_attribution" in names
    assert "march" in names and "exchange" in names
    procs = [e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M"]
    assert "device phases (attributed)" in procs
    assert tprof.attribution_chrome_events(attr) == \
        jprof.attribution_chrome_events(attr)
    assert np.isclose(sum(e.get("dur", 0) for e in
                          tprof.attribution_chrome_events(attr)), 3000.0)


# ------------------------------------------------------------- bench twin

def _reference_bench_keys():
    """The keys of the JSON line the reference's ``bench.py`` prints (the
    dict literal its ``main`` dumps, read from the source)."""
    import ast
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = ast.parse(open(os.path.join(root, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "metric" in keys and "phase_attribution" in keys:
                return keys
    raise AssertionError("no result dict in bench.py")


def test_bench_twin_profile_prints_reference_keys(monkeypatch, capsys):
    """``SITPU_BENCH_PROFILE=1`` at 32^3 on the CPU: the reference's keys,
    with its CPU nulls (no peaks off the card: ``mfu_matmul`` and
    ``hbm_frac_peak``; ``vs_baseline`` off the 512^3 configuration),
    the attribution and the verdicts filled, the bytes from the count."""
    from scenery_insitu_tpu_torch import bench

    for name, value in (("GRID", "32"), ("FRAMES", "2"), ("PROFILE", "1"),
                        ("PROFILE_FRAMES", "1")):
        monkeypatch.setenv(f"SITPU_BENCH_{name}", value)
    rec = tobs.Recorder(enabled=True)
    tobs.set_recorder(rec)
    assert bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _reference_bench_keys()
    assert set(want) <= set(out), set(want) - set(out)
    for key in ("vs_baseline", "mfu_matmul", "hbm_frac_peak", "divergence"):
        assert out[key] is None, key
    assert out["vs_baseline_unscaled"] > 0
    assert out["hbm_bytes_source"] == "torch_dispatch_count"
    assert out["hbm_bytes_per_frame"] > 0 and out["hbm_gbps"] > 0
    (snap,) = out["cost_analysis"].values()
    assert snap["source"] == "torch_dispatch_count"
    attr = out["phase_attribution"]
    assert attr["type"] == "phase_attribution" and attr["frames"] == 1
    assert attr["host_hook_ms_per_frame"] > 0       # the host delivery
    assert {"sim_step", "march", "host"} <= set(attr["phases"])
    verdicts = out["roofline_verdicts"]
    assert verdicts["assumptions"]["peaks_source"].startswith("cpu_nominal")
    assert verdicts["verdicts"]["host"]["bound"] == "host"
    assert out["config"]["assumed_peak_tflops"] is None
    assert any(e["name"] == "phase_attribution" for e in rec.events)

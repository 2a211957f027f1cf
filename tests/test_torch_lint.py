"""The port's lint (``scenery_insitu_tpu_torch/tools/lint``) against the
reference's, and the port's kernel contracts, on the CPU.

On the reference's fixtures (``tests/lint_fixtures``) the port's ledger,
counter and thread checkers give the reference's findings: the same
code, line and symbol. One difference, with its cause: the good counter
fixture's ``frame_scan_builds`` is not in the port's counter registry
(the port has no scan-block dispatch: ``runtime.scan_frames > 1``
raises, ROADMAP A3/A7), so the port's checker flags it where the
reference's does not. The knob checker's derived knob set equals the
reference's derivation from its own ``config.py``. The port's tree is
clean against its baseline with ``--fail-on-stale``; its registries hold
every ledger component and counter name its sources mint (the new
ingest's among them) and nothing else. The CUDA fixtures
(``tests/torch_lint_fixtures``) are flagged P1, P2 and P3 (bad) and
clean (good); the port's real wrappers and ``csrc/*.cu`` pass all
three. B10's plain version equals the reference's ``double_chunk`` run
in Pallas interpret mode bit for bit (32 x 128 with NaN and +-0 tiles;
NaN positions equal). Pure host work: no device, a few seconds."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scenery_insitu_tpu.tools.lint import counters as jC
from scenery_insitu_tpu.tools.lint import knobs as jK
from scenery_insitu_tpu.tools.lint import ledger as jL
from scenery_insitu_tpu.tools.lint import thread as jTH
from scenery_insitu_tpu.tools.lint.core import load_sources as jload
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.tools.lint import counters as C
from scenery_insitu_tpu_torch.tools.lint import cuda as CU
from scenery_insitu_tpu_torch.tools.lint import knobs as K
from scenery_insitu_tpu_torch.tools.lint import ledger as L
from scenery_insitu_tpu_torch.tools.lint import thread as TH
from scenery_insitu_tpu_torch.tools.lint.__main__ import main as cli
from scenery_insitu_tpu_torch.tools.lint.core import (Baseline, find_repo_root,
                                                      load_sources,
                                                      package_paths)
from scenery_insitu_tpu_torch.tools.lint.runner import (
    default_baseline_path, run_checks, run_lint)
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

ROOT = find_repo_root()
FIX = os.path.join(ROOT, "tests", "lint_fixtures")
TFIX = os.path.join(ROOT, "tests", "torch_lint_fixtures")
THREAD_KW = dict(config_path="tests/lint_fixtures/thread_config.py",
                 session_paths=("tests/lint_fixtures/thread_session.py",))


def _paths(base, *names):
    return [os.path.join(base, n) for n in names]


def _key(diags):
    return sorted((d.code, d.line, d.symbol) for d in diags)


def _load_fixture(name, base):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(base, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------- the reference's fixtures

@pytest.mark.parametrize("checker,names", [
    ("ledger", ("bad_ledger.py",)), ("ledger", ("good_ledger.py",)),
    ("counter", ("bad_counter.py",)), ("counter", ("good_counter.py",)),
    ("thread", ("thread_config.py", "bad_thread.py")),
    ("thread", ("thread_config.py", "good_thread.py")),
    ("thread", ("thread_config.py", "good_thread.py", "thread_session.py")),
], ids=lambda v: v if isinstance(v, str) else "+".join(v))
def test_checkers_match_reference_on_its_fixtures(checker, names):
    paths = _paths(FIX, *names)
    ours, theirs = load_sources(ROOT, paths), jload(ROOT, paths)
    if checker == "thread":
        pipe = f"tests/lint_fixtures/{names[1]}"
        kw = dict(THREAD_KW, pipeline_path=pipe)
        if len(names) == 2:
            kw["session_paths"] = ()
        got, want = TH.check(ours, **kw), jTH.check(theirs, **kw)
    else:
        mod, jmod = {"ledger": (L, jL), "counter": (C, jC)}[checker]
        got, want = mod.check(ours), jmod.check(theirs)
    if names == ("good_counter.py",):
        # the one difference: the port registers no scan-block counter
        extra = [d for d in got if "'frame_scan_builds'" in d.message]
        assert _key(extra) == [("SITPU-COUNTER", 8, "")]
        got = [d for d in got if d not in extra]
    assert _key(got) == _key(want)
    if checker == "ledger":       # the others' messages name the port's files
        assert [d.message for d in got] == [d.message for d in want]


def test_discovery_matches_reference():
    for name, mod, jmod, fn in (
            ("good_ledger.py", L, jL, "discover_degrade_components"),
            ("good_counter.py", C, jC, "discover_counters")):
        paths = _paths(FIX, name)
        assert getattr(mod, fn)(load_sources(ROOT, paths)) == \
            getattr(jmod, fn)(jload(ROOT, paths))


def test_derived_knobs_match_reference():
    """The thread checker's knob matrix and the knob checker's march-path
    knob set from the port's config.py equal the reference checkers'
    from the reference's; the knob checker emits nothing without the
    LOD bench twin."""
    ours = load_sources(ROOT, [os.path.join(ROOT, K.CONFIG_PATH)])[0]
    theirs = jload(ROOT, [os.path.join(ROOT, jK.CONFIG_PATH)])[0]
    assert set(K._config_knobs(ours)) == set(jK._config_knobs(theirs))
    assert len(K._config_knobs(ours)) > 10
    assert TH.derive_knobs(ours) == jTH.derive_knobs(theirs)
    assert K.check([ours]) == []


def test_thread_checker_clean_on_the_port():
    """Every distributed builder of the port threads comp_cfg and the
    topology, and the session binds them (the reference's plain builders'
    explicit-knob gaps do not exist: the port's take comp_cfg)."""
    paths = [os.path.join(ROOT, "scenery_insitu_tpu_torch", p) for p in
             ("config.py", "parallel/pipeline.py", "runtime/session.py")]
    srcs = load_sources(ROOT, paths)
    assert len(TH._builders(srcs[1])) >= 7
    assert TH.check(srcs) == []


# --------------------------------------------------------- the port's tree

def test_tree_clean_against_baseline():
    new, accepted, stale, _ = run_lint()
    assert new == [], [d.render() for d in new]
    assert stale == [], stale
    assert cli(["--fail-on-stale"]) == 0
    bl = Baseline.load(default_baseline_path())
    assert len(accepted) == len(bl.entries) == 4
    assert all(len(e["reason"]) > 20 for e in bl.entries)


def test_registries_hold_every_minted_name():
    """Every ledger component and counter name a source of the port's
    package mints is registered, and every registry row has a site; the
    new ingest mints ``ingest.stall``, ``ingest_stalls`` and
    ``ingest_stall_recoveries``."""
    srcs = load_sources(ROOT, package_paths(ROOT, ("tools",)))
    comps = L.discover_degrade_components(srcs)
    names = C.discover_counters(srcs)
    assert set(comps) == set(tobs.ledger_registry())
    assert set(names) == set(tobs.counter_registry())
    ingest = [s for s in srcs if s.path.endswith("ingest/shm.py")]
    assert set(L.discover_degrade_components(ingest)) == {"ingest.stall"}
    assert set(C.discover_counters(ingest)) == {"ingest_stalls",
                                                "ingest_stall_recoveries"}
    assert all(len(v) > 10 for v in tobs.ledger_registry().values())
    assert all(len(v) > 10 for v in tobs.counter_registry().values())


def test_gate_mechanics(tmp_path, capsys):
    """Stale entries fail only under --fail-on-stale; reasons are
    mandatory; --write-baseline stamps new entries and keeps reasons;
    --report writes the accounting; a file that does not parse is a
    finding; a .cu suppression comment is honoured."""
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    bl = tmp_path / "bl.json"
    Baseline([{"code": "SITPU-LEDGER", "path": "gone.py",
               "message": "long since fixed", "symbol": "f",
               "reason": "a debt that was paid off and never pruned"}]
             ).save(str(bl))
    args = ["--baseline", str(bl), str(clean)]
    assert cli(args) == 0
    assert cli(["--fail-on-stale"] + args) == 1
    with pytest.raises(ValueError, match="without a reason"):
        Baseline([{"code": "X", "path": "p", "message": "m", "reason": ""}])
    bad = _paths(TFIX, "bad_cuda.py", "bad_double.cu")
    wb = tmp_path / "wb.json"
    assert cli(["--write-baseline", "--baseline", str(wb)] + bad) == 1
    entries = Baseline.load(str(wb)).entries
    assert entries and all(e["reason"] == "TODO: justify or fix"
                           for e in entries)
    report = tmp_path / "r.json"
    assert cli(["--baseline", str(wb), "--report", str(report)] + bad) == 0
    assert '"baselined"' in report.read_text()
    broken = tmp_path / "broken.py"
    broken.write_text("def oops(:\n")
    new, _, _, diags = run_lint(paths=[str(broken)],
                                repo_root=str(tmp_path))
    assert [d.code for d in diags] == ["SITPU-PARSE"] and new == diags
    cu = tmp_path / "k.cu"
    text = open(bad[1]).read().replace(
        "double_kernel<<<blocks, kThreads, 0, stream>>>(x, y, m, w);",
        "double_kernel<<<blocks, kThreads, 0, stream>>>(x, y, m, w);"
        "  // sitpu-lint: disable=SITPU-CUDA")
    cu.write_text(text)
    codes = [d.message[:3] for d in run_checks(
        load_sources(str(tmp_path), [str(cu)]))]
    assert codes == ["P3:"]
    capsys.readouterr()


# ------------------------------------------------------ SITPU-CUDA and B10

def test_cuda_fixtures():
    """The bad pair: P1 (a try around the launch, the plain version off
    the CPU branch), P2 (a floored grid no wrapper guards), P3 (64 KiB
    of dynamic shared memory at W = 2048 with no opt-in); the good pair
    is clean, its floored grid covered by the wrapper's % guard."""
    bad = CU.check(load_sources(ROOT, _paths(TFIX, "bad_cuda.py",
                                             "bad_double.cu")))
    got = sorted((d.path.rsplit("/", 1)[1], d.message[:3], d.symbol)
                 for d in bad)
    assert got == [("bad_cuda.py", "P1:", "double_chunk"),
                   ("bad_cuda.py", "P1:", "double_chunk"),
                   ("bad_double.cu", "P2:", "bad_double_chunk"),
                   ("bad_double.cu", "P3:", "bad_double_chunk_staged")]
    good = _paths(TFIX, "good_cuda.py", "good_double.cu")
    assert run_checks(load_sources(ROOT, good)) == []
    # the good kernel's grid floors: without its wrapper it is flagged
    alone = CU.check(load_sources(ROOT, good[1:]))
    assert [d.message[:3] for d in alone] == ["P2:"]


def test_port_kernels_keep_the_contracts():
    """Every kernels.launch site of the package (the benchmark twins
    too) and every csrc/*.cu launch pass P1-P3; the scan sees them."""
    paths = package_paths(ROOT, ("tools",))
    csrc = os.path.join(ROOT, "scenery_insitu_tpu_torch", "csrc")
    cus = sorted(os.path.join(csrc, n) for n in os.listdir(csrc)
                 if n.endswith(".cu"))
    srcs = load_sources(ROOT, paths + cus)
    assert CU.check(srcs) == []
    sites = sum(len(CU._launch_calls(f)) for s in srcs
                for f in CU._top_fns(s.tree).values())
    launches = sum(len(CU._launches(CU._blank(s.text))) for s in srcs
                   if s.is_cuda)
    assert sites >= 10 and launches >= 8 and len(cus) == 6


def test_b10_plain_matches_reference_interpret():
    """B10's plain version against the reference's Pallas double_chunk
    in interpret mode: 2 x and each 8-row tile's max, bit for bit (NaN
    positions equal), with a NaN tile, a -0 tile and a +0 tile; a height
    that is not a multiple of 8 raises before any launch."""
    good = _load_fixture("good_cuda", TFIX)
    gp = _load_fixture("good_pallas", FIX)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 128)).astype(np.float32)
    x[9, 5] = np.nan
    x[16:24] = -np.abs(x[16:24])
    x[16] = -0.0
    x[24:32] = -np.abs(x[24:32])
    x[27] = 0.0
    with pltpu.force_tpu_interpret_mode():
        jo, js = gp.double_chunk(jnp.asarray(x))
    to, ts = good.double_chunk(torch.from_numpy(x))
    for a, b in ((to.numpy(), np.asarray(jo)), (ts.numpy(), np.asarray(js))):
        assert a.shape == b.shape
        nan = np.isnan(b)
        np.testing.assert_array_equal(np.isnan(a), nan)
        np.testing.assert_array_equal(a[~nan].view(np.int32),
                                      b[~nan].view(np.int32))
    tile_max = ts.numpy()[:, 0]
    assert np.isnan(tile_max[1]) and np.signbit(tile_max[2])
    assert tile_max[3] == 0 and not np.signbit(tile_max[3])
    with pytest.raises(ValueError, match="not a multiple of 8"):
        good.double_chunk(torch.zeros((12, 128)))


def test_register_library_serves_a_source_outside_csrc():
    """``kernels.register_library`` (how B10 is built and counted): the
    source path and a hashed library name, the entry counted in
    ``launches``; nothing is built until a launch; the package's own
    libraries and entries cannot be taken over."""
    from scenery_insitu_tpu_torch import kernels

    good = _load_fixture("good_cuda", TFIX)
    assert kernels.source_path("good_double") == good.SOURCE
    path = kernels.library_path("good_double")
    assert os.path.basename(path).startswith("libgood_double-")
    assert "double_chunk" in kernels.launches()
    assert kernels.ENTRIES["double_chunk"][0] == "good_double"
    assert "good_double" not in kernels.LIBRARIES
    with pytest.raises(ValueError, match="package's own"):
        kernels.register_library("seg_fold", good.SOURCE, {})
    with pytest.raises(ValueError, match="package's own"):
        kernels.register_library("x", good.SOURCE, {"count_multi": []})

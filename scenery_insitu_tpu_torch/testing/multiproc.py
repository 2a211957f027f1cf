"""Subprocess multi-process harness: real ``torch.distributed`` fleets on
one machine, the twin of the reference's ``testing/multiproc.py``.

It spawns one coordinator's worth of workers, each a fresh interpreter
(``python -m scenery_insitu_tpu_torch.testing.multiproc ...``; no fork,
so a parent that already holds a CUDA context can spawn them), joins
each to the fleet through `multihost.initialize` on gloo (CPU
processes, or several processes sharing one card), runs an ENTRY FUNCTION in every worker and tears the group
down in ``finally``. A CPU worker runs with one torch thread
(``OMP_NUM_THREADS=1``), so a fleet does not oversubscribe the host.

Usage (from a test)::

    from scenery_insitu_tpu_torch.testing import multiproc

    results = multiproc.run_multiproc(
        "tests.test_torch_multihost:_entry_all", n_procs=2,
        ranks_per_proc=2, workdir=tmp_path, device="cpu")
    assert all(r.ok for r in results), results

The entry is ``module:function`` taking one `MPContext`. Workers share
``workdir`` for artifacts; the parent collects exit codes and output,
and assertions live in the entry (a failed assert is a nonzero exit)
and in the parent over the artifacts.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import List, NamedTuple, Optional

from scenery_insitu_tpu_torch.device import resolve_device


class MPContext(NamedTuple):
    """What an entry function gets: its place in the fleet, the ranks it
    holds and their device, the shared scratch directory and the extra
    arguments."""

    process_id: int
    num_processes: int
    workdir: str
    args: tuple = ()
    ranks_per_proc: int = 1
    device: str = "cuda"


class ProcResult(NamedTuple):
    process_id: int
    returncode: int
    output: str

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multiproc(entry: str, n_procs: int, ranks_per_proc: int = 2,
                  workdir: Optional[str] = None, args: tuple = (),
                  timeout_s: float = 420.0, device=None
                  ) -> List[ProcResult]:
    """Spawn ``n_procs`` worker processes on this machine, each holding
    ``ranks_per_proc`` ranks on ``device`` (None means CUDA, all workers
    on the current card, and raises without one), joined on gloo (the
    workers share one card or the CPU, where NCCL cannot run), and run
    ``entry`` (``module:function``) in each.
    Returns one `ProcResult` a worker. A worker that wedges past
    ``timeout_s`` is killed, its siblings too (they would block on the
    dead peer), and reported with returncode -9."""
    dev = resolve_device(device)
    coordinator = f"127.0.0.1:{free_port()}"
    workdir = str(workdir or os.getcwd())
    env = dict(os.environ)
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [_repo_root()] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    # each worker writes to a file of its own: a pipe the parent is not
    # yet reading could fill and block a worker its siblings wait for
    logs = [tempfile.TemporaryFile() for _ in range(n_procs)]
    procs = []
    for pid in range(n_procs):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "scenery_insitu_tpu_torch.testing."
             "multiproc", "--entry", entry, "--coordinator", coordinator,
             "--processes", str(n_procs), "--process-id", str(pid),
             "--ranks-per-proc", str(ranks_per_proc), "--device", str(dev),
             "--workdir", workdir]
            + [str(a) for a in args],
            env=env, stdout=logs[pid], stderr=subprocess.STDOUT,
            cwd=_repo_root()))

    deadline = time.monotonic() + timeout_s
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.1, deadline
                                            - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    if None in codes:
        for q in procs:
            if q.poll() is None:
                q.kill()
        for q in procs:         # reap: SIGKILL delivery is asynchronous
            try:
                q.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
    results: List[ProcResult] = []
    for pid, (code, log) in enumerate(zip(codes, logs)):
        log.seek(0)
        out = log.read().decode("utf-8", "replace")
        log.close()
        if code is None:
            code = -9
            out += (f"\n[harness] worker {pid} timed out after "
                    f"{timeout_s:.0f}s and was killed")
        results.append(ProcResult(pid, code, out))
    return results


def _child_main(argv=None) -> int:
    import argparse
    import importlib

    ap = argparse.ArgumentParser()
    ap.add_argument("--entry", required=True,
                    help="module:function taking one MPContext")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--ranks-per-proc", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=".")
    args, extra = ap.parse_known_args(argv)

    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)
    from scenery_insitu_tpu_torch.parallel import multihost

    multihost.initialize(args.coordinator, args.processes, args.process_id,
                         timeout_s=120.0, attempt_timeout_s=30.0,
                         backend="gloo", device=args.device)
    mod_name, _, fn_name = args.entry.partition(":")
    if not fn_name:
        raise SystemExit(f"--entry must be module:function, "
                         f"got {args.entry!r}")
    ctx = MPContext(process_id=args.process_id,
                    num_processes=args.processes, workdir=args.workdir,
                    args=tuple(extra), ranks_per_proc=args.ranks_per_proc,
                    device=args.device)
    rc = 0
    try:
        getattr(importlib.import_module(mod_name), fn_name)(ctx)
        print(f"[mp {args.process_id}] ENTRY_OK", flush=True)
    # any failure, an interrupt too: the exit code is the verdict
    except BaseException as e:      # noqa: B036
        import traceback

        traceback.print_exc()
        print(f"[mp {args.process_id}] ENTRY_FAILED "
              f"{type(e).__name__}: {e}", flush=True)
        rc = 1
    finally:
        multihost.shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(_child_main())

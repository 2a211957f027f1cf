"""sitpu-lint for the port: invariant checkers over its sources.

Run ``python -m scenery_insitu_tpu_torch.tools.lint``. The reference's
suite (``scenery_insitu_tpu/tools/lint``) with the port's kernel
contracts in place of Mosaic's:

- ``SITPU-LEDGER`` (ledger.py): behaviour-changing fallback branches
  mint ``obs.degrade`` entries.
- ``SITPU-COUNTER`` (counters.py): every counter name is registered in
  ``obs.counter_registry()``.
- ``SITPU-THREAD`` (thread.py): the CompositeConfig knob matrix, derived
  from the dataclass fields, threads through every distributed step
  builder and the session.
- ``SITPU-KNOB`` (knobs.py): every march-path knob is in the LOD bench's
  ``KNOB_MATRIX`` (silent while the port has no ``lod_bench.py``).
- ``SITPU-CUDA`` (cuda.py): a kernel's plain version runs only on the
  CPU and nothing falls back; grids declare their tile divisibility;
  dynamic shared memory above 48 KiB is opted into.

The reference's ``SITPU-TRACE`` (host syncs inside traced JAX bodies)
has no counterpart: the port traces nothing yet.

Pure stdlib ``ast`` and text: nothing it reads is run.
"""

from scenery_insitu_tpu_torch.tools.lint.core import (  # noqa: F401
    Baseline, Diagnostic, SourceFile, default_scan_paths, find_repo_root,
    load_sources)
from scenery_insitu_tpu_torch.tools.lint.runner import (  # noqa: F401
    run_checks, run_lint)

__all__ = ["Baseline", "Diagnostic", "SourceFile", "default_scan_paths",
           "find_repo_root", "load_sources", "run_checks", "run_lint"]

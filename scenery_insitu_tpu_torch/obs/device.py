"""Device-side enrichment: what a step moves and computes. Host spans
time the wall clock; the cost snapshot of a step says how many
device-memory bytes and FLOPs one frame moves, so that a benchmark delta
is attributable (compute-bound, bandwidth-bound or dispatch-bound).

There is no compiler cost analysis here, so the snapshot counts what
the step does: `cost_snapshot` runs the step once under a
``TorchDispatchMode`` that adds up every aten op's operand and output
bytes (XLA's "bytes accessed" notion: each distinct element once, a
broadcast operand by its own elements; views and fresh allocations move
nothing and are skipped) and its FLOPs by
``torch.utils.flop_counter``'s formulas (the matrix products and
convolutions). A hand-written kernel's launch goes through ``ctypes``
past the dispatcher, so its wrapper reports its own operand and output
bytes to ``kernels.py`` (``launch(..., nbytes=...)``) and the snapshot
adds them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# allocations and views: no bytes move
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "detach", "alias"}


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of a tensor's distinct elements: a broadcast (expanded)
    operand, stride 0 along a dim, is read once, not once an element of
    the output it broadcasts into."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return (n if t.numel() else 0) * t.element_size()


class _Count(TorchDispatchMode):
    """Adds up the bytes and FLOPs of every aten op dispatched inside."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet.__name__ in _NO_TRAFFIC:
            return out
        leaves = tree_flatten((args, kwargs))[0] + tree_flatten(out)[0]
        self.bytes += sum(_distinct_bytes(t) for t in leaves
                          if isinstance(t, torch.Tensor))
        formula = flop_registry.get(packet)
        if formula is not None:
            try:
                flops = formula(*args, **kwargs, out_val=out)
            except TypeError:  # sitpu-lint: disable=SITPU-LEDGER (a call convention)
                # an overload with more positional operands than the
                # formula's (aten::bmm.dtype's out_dtype, the bf16
                # product): the formula reads the operands' shapes only
                flops = formula(*(a for a in args
                                  if isinstance(a, torch.Tensor)),
                                out_val=out)
            self.flops += int(flops)
        return out


def cost_snapshot(step, *args) -> Optional[Dict[str, Any]]:
    """Cost snapshot of one call ``step(*args)``: ``bytes_accessed`` (the
    aten ops' operand and output bytes plus the hand-written kernels'
    own) and ``flops`` (matrix products), with ``kernel_bytes`` the
    kernels' share. Runs the step once: call it on a step without
    carried state, or accept the state it advances. Returns None when
    the step counted nothing, and an ``{"source": "unavailable",
    "error": ...}`` record when it raises."""
    from scenery_insitu_tpu_torch import kernels

    try:
        count = _Count()
        b0 = kernels.launched_bytes()
        with count:
            step(*args)
        kbytes = kernels.launched_bytes() - b0
        snap = {"source": "torch_dispatch_count"}
        total = count.bytes + kbytes
        if total > 0:
            snap["bytes_accessed"] = float(total)
            snap["kernel_bytes"] = float(kbytes)
        if count.flops > 0:
            snap["flops"] = float(count.flops)
        return snap if len(snap) > 1 else None
    except Exception as e:   # sitpu-lint: disable=SITPU-LEDGER
        # best-effort: the caller's device_cost ledgers the unavailable
        # snapshot (bench.cost_analysis)
        return {"source": "unavailable",
                "error": f"{type(e).__name__}: {str(e)[:120]}"}


def device_cost(step, *args) -> Dict[str, Any]:
    """The ONE cost join every consumer reads (the bench twin, the
    roofline verdicts): `cost_snapshot` normalized to an always-a-dict
    record, and the unavailable case minted through the
    ``bench.cost_analysis`` degrade component so artifacts carry WHY
    the bytes/flops are missing.

    Returns ``{"source": "torch_dispatch_count", "bytes_accessed": ...,
    "flops": ..., ...}`` on success; ``{"source": "unavailable",
    "error": ...}`` (degrade minted) otherwise."""
    from scenery_insitu_tpu_torch.obs.recorder import degrade

    snap = cost_snapshot(step, *args)
    if snap is None or "bytes_accessed" not in snap:
        err = (snap or {}).get("error", "no cost count")
        degrade("bench.cost_analysis", "torch_dispatch_count",
                "traffic_model",
                f"the step's cost count is unavailable ({err})",
                warn=False)
        return {"source": "unavailable", "error": err}
    return snap

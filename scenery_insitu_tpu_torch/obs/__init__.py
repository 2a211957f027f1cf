"""Observability: structured spans, counters, the fallback ledger, the
Perfetto/JSONL exporters (``obs.recorder``) and the live SLO engine
(``obs.slo``). Torch-free, so any module may import it at load."""

from scenery_insitu_tpu_torch.obs.recorder import (Recorder, clear_ledger,
                                                   counter_registry,
                                                   degrade, flight_flush,
                                                   get_recorder, ledger,
                                                   ledger_registry,
                                                   set_recorder)

__all__ = ["Recorder", "degrade", "ledger", "ledger_registry",
           "counter_registry", "clear_ledger", "flight_flush",
           "get_recorder", "set_recorder"]

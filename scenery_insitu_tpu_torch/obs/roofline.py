"""Roofline verdicts: per-phase achieved-vs-peak fractions and a bound
classification over a phase attribution (``obs/profiler.py``) joined
with the step's device-cost snapshot (``obs/device.py``).

A copy of the reference's ``obs/roofline.py``: the verdict logic and
schema are the reference's, device-neutral; only the peak tables are
this package's card's. Torch-free, so any module may import it.

The verdict model, stated so the artifact can carry its own assumptions:

- **Peaks** are the NVIDIA H100 SXM's public figures (NVIDIA's data
  sheet, dense rates, at the card's full 700 W power limit; a card set
  below it runs slower under load, so callers pass the measured
  ``power_limit`` and it rides in the assumptions): HBM3 3,350 GB/s;
  matmul 989 TFLOP/s in bf16 and 67 TFLOP/s in f32 (the package turns
  TF32 off, so an f32 product runs outside the tensor cores). The
  matmul peak follows the march's product dtype (``matmul_dtype``): an
  f32 frame held against the bf16 peak would read 15x too low. The
  intra-node link peak (``ici_gbps``) is NVLink's 900 GB/s; there is no
  inter-node peak (``dcn_gbps`` None), so a ``dcn_hop`` verdict carries
  no fraction. Off the card a stated ``cpu_nominal`` peak gives
  *relative* verdicts only.
- **Apportionment**: the cost snapshot counts whole-step bytes/flops,
  not per-phase, so compute phases split the step totals proportionally
  to their measured ms share (communication and host phases excluded
  from the split). That is an assumption, written into the artifact.
- **Bound classification** per phase: ``host`` for the host-gap phase
  or any compute phase whose best achieved fraction sits under
  ``host_floor`` (nothing on the device explains the time), ``ici-dcn``
  for the exchange/DCN-hop phases, else the larger of the achieved HBM
  and matmul fractions (``hbm`` / ``mxu``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# The card the peaks are published for, and its power limit then.
PEAK_CARD = "NVIDIA H100 SXM (80 GB HBM3)"
PEAK_POWER_LIMIT_W = 700.0

# Dense matmul peak TFLOP/s by device-kind substring, per product dtype.
PEAK_TFLOPS = (("h100", 989.0),)            # bf16 tensor cores
PEAK_TFLOPS_F32 = (("h100", 67.0),)         # f32, outside the tensor cores

# Device memory bandwidth GB/s by device-kind substring.
PEAK_HBM_GBPS = (("h100", 3350.0),)

# Link peaks: NVLink between the cards of one host; no inter-node peak.
ICI_GBPS_DEFAULT = 900.0
DCN_GBPS_DEFAULT = None

# Stated nominal peaks for CPU captures (one modern core's FMA rate and a
# laptop-class memory bus): absolute fractions are meaningless on the
# CPU, but the RELATIVE ordering of phases still is; the artifact's
# peaks_source says which regime produced the verdicts.
CPU_NOMINAL_TFLOPS = 0.1
CPU_NOMINAL_HBM_GBPS = 20.0

# Phases whose time is a link transfer, not compute: classified ici-dcn
# against the matching link peak instead of the HBM/matmul roofline.
COMM_PHASES = {"exchange": "ici", "dcn_hop": "dcn"}


def kind_lookup(table, device_kind: str, platform: str,
                default: Optional[float]):
    """Device-kind substring lookup of a peak table; None off the card
    (the caller decides its CPU story), the table default when the kind
    is unrecognized (assume the H100)."""
    if platform != "gpu":
        return None
    kind = (device_kind or "").lower()
    for sub, val in table:
        if sub in kind:
            return val
    return default


def peak_tflops(device_kind: str, platform: str,
                matmul_dtype: str = "bf16") -> Optional[float]:
    """The matmul peak of ``matmul_dtype`` (``bf16`` or ``f32``)."""
    if matmul_dtype in ("f32", "float32"):
        return kind_lookup(PEAK_TFLOPS_F32, device_kind, platform, 67.0)
    return kind_lookup(PEAK_TFLOPS, device_kind, platform, 989.0)


def peaks_for(device_kind: str, platform: str,
              matmul_dtype: str = "bf16",
              power_limit: Optional[str] = None,
              ici_gbps: Optional[float] = ICI_GBPS_DEFAULT,
              dcn_gbps: Optional[float] = DCN_GBPS_DEFAULT
              ) -> Dict[str, Any]:
    """The peak-assumption block of one capture: device memory and
    matmul peaks for the card (the matmul one of ``matmul_dtype``;
    stated nominal figures off the card) and the link peaks, with the
    card the table is published for and the measured ``power_limit``.
    Every verdict artifact embeds this verbatim so the numbers can be
    re-judged when assumptions move."""
    tflops = peak_tflops(device_kind, platform, matmul_dtype)
    hbm = kind_lookup(PEAK_HBM_GBPS, device_kind, platform, 3350.0)
    if tflops is None or hbm is None:
        return {"tflops": CPU_NOMINAL_TFLOPS,
                "hbm_gbps": CPU_NOMINAL_HBM_GBPS,
                "ici_gbps": ici_gbps, "dcn_gbps": dcn_gbps,
                "device_kind": device_kind, "platform": platform,
                "peaks_source": "cpu_nominal (relative verdicts only)"}
    return {"tflops": tflops, "hbm_gbps": hbm,
            "ici_gbps": ici_gbps, "dcn_gbps": dcn_gbps,
            "device_kind": device_kind, "platform": platform,
            "matmul_dtype": matmul_dtype, "power_limit": power_limit,
            "peaks_source": (f"public data sheet: {PEAK_CARD}, dense, at "
                             f"{PEAK_POWER_LIMIT_W:.0f} W")}


def roofline_verdicts(attribution: Dict[str, Any],
                      cost: Optional[Dict[str, Any]] = None,
                      peaks: Optional[Dict[str, Any]] = None,
                      modeled: Optional[Dict[str, Any]] = None,
                      host_floor: float = 0.05) -> Dict[str, Any]:
    """Join a ``phase_attribution`` record (obs/profiler.py) with the
    step's cost snapshot into one verdict per phase: achieved-vs-peak
    HBM and MXU fractions and a bound classification (hbm / mxu /
    ici-dcn / host).

    ``modeled`` optionally supplies per-frame link bytes for the
    communication phases (``{"ici_bytes_per_frame": ...,
    "dcn_bytes_per_frame": ...}`` — e.g. from the modeled exchange
    traffic the step build minted) so the ici-dcn verdicts carry an
    achieved-GB/s figure too."""
    peaks = peaks or peaks_for("", "cpu")
    cost = cost if isinstance(cost, dict) else {}
    modeled = modeled or {}
    phases = attribution.get("phases") or {}
    wall = float(attribution.get("wall_ms_per_frame") or 0.0)
    step_bytes = float(cost.get("bytes_accessed") or 0.0)
    step_flops = float(cost.get("flops") or 0.0)
    compute_ms = sum(
        float(p.get("ms") or 0.0) for name, p in phases.items()
        if name not in COMM_PHASES and name != "host")
    verdicts: Dict[str, Any] = {}
    for name, p in phases.items():
        ms = float(p.get("ms") or 0.0)
        v: Dict[str, Any] = {
            "ms": round(ms, 4),
            "frac_of_wall": round(ms / wall, 4) if wall > 0 else None}
        if name == "host":
            v["bound"] = "host"
        elif name in COMM_PHASES:
            link = COMM_PHASES[name]
            peak_gbps = peaks.get(f"{link}_gbps")
            link_bytes = modeled.get(f"{link}_bytes_per_frame")
            if link_bytes and ms > 0:
                ach = float(link_bytes) / (ms / 1e3) / 1e9
                v["achieved_gbps"] = round(ach, 3)
                if peak_gbps:
                    v["link_frac_peak"] = round(ach / peak_gbps, 4)
            v["bound"] = "ici-dcn"
        else:
            share = ms / compute_ms if compute_ms > 0 else 0.0
            b_est = step_bytes * share
            f_est = step_flops * share
            hbm_frac = mxu_frac = None
            if ms > 0:
                if peaks.get("hbm_gbps"):
                    hbm_frac = (b_est / (ms / 1e3) / 1e9
                                ) / peaks["hbm_gbps"]
                if peaks.get("tflops"):
                    mxu_frac = (f_est / (ms / 1e3) / 1e12
                                ) / peaks["tflops"]
            v["bytes_est"] = round(b_est)
            v["flops_est"] = round(f_est)
            v["hbm_frac_peak"] = (round(hbm_frac, 4)
                                  if hbm_frac is not None else None)
            v["mxu_frac_peak"] = (round(mxu_frac, 4)
                                  if mxu_frac is not None else None)
            best = max(hbm_frac or 0.0, mxu_frac or 0.0)
            if best < host_floor:
                v["bound"] = "host"
            else:
                v["bound"] = ("hbm" if (hbm_frac or 0.0)
                              >= (mxu_frac or 0.0) else "mxu")
        verdicts[name] = v
    return {
        "type": "roofline_verdicts",
        "assumptions": {
            **peaks,
            "host_floor_frac": host_floor,
            "apportionment": (
                "whole-step cost-analysis bytes/flops split across "
                "compute phases proportionally to measured ms "
                "(communication + host phases excluded)"),
        },
        "step": {"bytes_accessed": step_bytes or None,
                 "flops": step_flops or None,
                 "wall_ms_per_frame": wall or None,
                 "cost_source": cost.get("source")},
        "verdicts": verdicts,
    }

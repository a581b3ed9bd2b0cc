"""Device-to-host link speed, for the link-aware policies.

Counterpart of kmer_tpu/utils/linkspeed.py, with kmer_tpu's breakeven
constants and env switches.  Three choices hang on the link: mode="auto"
picks dense (a device-resident 4**k table, one readback a corpus) for
k <= 8 only behind a slow link; dense k = 9..12 scatters into a device
table instead of adding on the host; and device_merge="auto" keeps the
sort-mode table on the device (pipeline/count._devmerge_ok).  On a
fast link the per-batch readback is cheap and each policy stays off.
The probe runs at the first policy decision, never when a KmerConfig is
built.
"""

from __future__ import annotations

import os
import time

import torch

_cache: dict = {}

# the sort path reads back ~12 B a lane where dense spends ~2.25 ns more
# device time a lane: equal cost near 5.3 GB/s (kmer_tpu's constant)
DENSE_BREAKEVEN_GBPS = 5.0
# dense k = 9..12: a device scatter at ~10 ns a lane against the hybrid's
# 5 B a lane of readback: equal cost near 0.49 GB/s (kmer_tpu's constant)
SCATTER_BREAKEVEN_GBPS = 0.49


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def d2h_gbps(device=None, probe_mb: int = 4) -> float:
    """Device-to-host bandwidth in GB/s, measured once per process and
    device.  KMER_TPU_D2H_GBPS overrides it; a CPU device (the default
    where there is no GPU) has no link and gives inf.  On a GPU: the best
    of two timed copies of a fresh `probe_mb` MiB device buffer into
    pinned host memory, after one warm-up copy."""
    env = os.environ.get("KMER_TPU_D2H_GBPS")
    if env:
        return float(env)
    dev = torch.device(device) if device is not None else _default_device()
    if dev.type != "cuda":
        return float("inf")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _cache:
        n = probe_mb << 20
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        best = float("inf")
        for rep in range(3):
            # a fresh buffer each time: the host has never seen its bytes
            x = torch.full((n,), rep, dtype=torch.uint8, device=dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            host.copy_(x)
            torch.cuda.synchronize(dev)
            if rep:
                best = min(best, time.perf_counter() - t0)
        _cache[dev] = n / best / 1e9
    return _cache[dev]


def dense_auto_ok(device=None) -> bool:
    """mode="auto": dense only behind a link slower than
    KMER_TPU_DENSE_LINK_GBPS (default DENSE_BREAKEVEN_GBPS)."""
    thr = float(os.environ.get("KMER_TPU_DENSE_LINK_GBPS",
                               DENSE_BREAKEVEN_GBPS))
    return d2h_gbps(device) < thr


def dense_scatter_ok(device=None) -> bool:
    """Dense k = 9..12: accumulate the 4**k table on the device (no
    per-batch readback) only behind a link slower than
    KMER_TPU_SCATTER_LINK_GBPS (default SCATTER_BREAKEVEN_GBPS);
    KMER_TPU_DENSE_SCATTER=1 forces it on, =0 off."""
    env = os.environ.get("KMER_TPU_DENSE_SCATTER")
    if env in ("0", "1"):
        return env == "1"
    thr = float(os.environ.get("KMER_TPU_SCATTER_LINK_GBPS",
                               SCATTER_BREAKEVEN_GBPS))
    return d2h_gbps(device) < thr

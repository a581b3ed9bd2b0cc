"""Profiler traces and the minimum-traffic (roofline) model.

  * `trace(dir)` records a torch.profiler trace of the block it wraps
    (host activity, and the card's kernels when CUDA is available) and
    writes it into `dir` as a Chrome trace JSON that chrome://tracing,
    Perfetto or TensorBoard's profiler plugin opens;
  * `detect_hbm_bw` gives the card's peak DRAM bandwidth, from a table of
    cards by name: None for a card not in it and for the CPU;
  * `Roofline` is kmer_tpu's minimum-traffic model of one count step,
    its byte formulas unchanged, so that a roofline share counts the same
    work whatever implements the step.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

# Peak DRAM bandwidth, bytes/s, by torch.cuda.get_device_name: NVIDIA's
# data sheet for the H100 SXM (HBM3, 3.35 TB/s at its 700 W limit)
PEAK_DRAM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def detect_hbm_bw(device=None) -> float | None:
    """Peak DRAM bandwidth of `device` (default: the current CUDA
    device), or None where it is not known: the CPU, no CUDA, or a card
    missing from PEAK_DRAM_BYTES_PER_S."""
    import torch
    if not torch.cuda.is_available():
        return None
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return PEAK_DRAM_BYTES_PER_S.get(torch.cuda.get_device_name(device))


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the block into `log_dir` (made if needed)
    as one `*.pt.trace.json` file; a no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"kmer_tpu_torch_{os.getpid()}_{time.time_ns()}"
                 ".pt.trace.json"))


@dataclass
class Roofline:
    """Minimum-traffic model for one count step (kmer_tpu's, unchanged):
    the packed code batch in, one read and one write of the keys for the
    sort, the run-length outputs."""
    batch_bytes: int      # packed code batch in
    key_bytes: int        # N * W * 4, one read + one write for the sort
    out_bytes: int        # run-length outputs

    @property
    def total_bytes(self) -> int:
        return self.batch_bytes + 2 * self.key_bytes + self.out_bytes

    def seconds_at_roofline(self, hbm_bytes_per_s: float | None = None
                            ) -> float:
        """total_bytes at the given bandwidth, else detect_hbm_bw()'s;
        ValueError when neither is known."""
        bw = hbm_bytes_per_s or detect_hbm_bw()
        if bw is None:
            raise ValueError("peak DRAM bandwidth unknown for this device; "
                             "pass hbm_bytes_per_s")
        return self.total_bytes / bw

    def fraction(self, measured_seconds: float,
                 hbm_bytes_per_s: float | None = None) -> float:
        """Achieved fraction of the bandwidth roofline (1.0 = the bound)."""
        return self.seconds_at_roofline(hbm_bytes_per_s) / measured_seconds

    @staticmethod
    def for_sort_step(B: int, L: int, k: int, W: int) -> "Roofline":
        N = B * (L - k + 1)
        return Roofline(batch_bytes=B * L,
                        key_bytes=N * W * 4,
                        out_bytes=N * (W * 4 + 4 + 1))

    @staticmethod
    def for_fused_step(B: int, L: int, k: int, W: int,
                       cnt_bytes: int = 4) -> "Roofline":
        """The fused single-kernel step: codes in once, keys and counts
        out once, no sort round trip (key_bytes = 0)."""
        N = B * (L - k + 1)
        return Roofline(batch_bytes=B * L, key_bytes=0,
                        out_bytes=N * (W * 4 + cnt_bytes))

    @staticmethod
    def for_dense_step(B: int, L: int, k: int) -> "Roofline":
        N = B * (L - k + 1)
        hist = 4 ** k * 4
        return Roofline(batch_bytes=B * L, key_bytes=N * 2,
                        out_bytes=2 * hist)

"""The card a run uses: the few calls the harness and the control make of
it, all of them here."""

from __future__ import annotations

import concurrent.futures as cf
import importlib
import subprocess

import torch

DEVICE = "cuda"
PLATFORM = "gpu"


class NoCard(RuntimeError):
    """The machine lacks the cards a cell asks for."""


def require(chips: int) -> None:
    """Raise NoCard unless `chips` CUDA devices are present."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"needs {chips} CUDA device(s); "
                     f"torch.cuda.is_available()="
                     f"{torch.cuda.is_available()}, "
                     f"device_count={torch.cuda.device_count()}")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def build(libraries) -> None:
    """Build, where they are missing, and load the named libraries at
    once, one compiler process each (the first run in a checkout
    compiles; later ones only load).  libraries: "module:function"
    names of the program's loaders."""
    loaders = []
    for name in libraries:
        mod, fn = name.split(":")
        loaders.append(getattr(importlib.import_module(mod), fn))
    if not loaders:
        return
    with cf.ThreadPoolExecutor(len(loaders)) as ex:
        for fut in [ex.submit(fn) for fn in loaders]:
            fut.result()


def open_card(libraries) -> dict:
    """Make card 0 current, open its context, build the libraries;
    returns its name and power limit."""
    torch.cuda.set_device(0)
    torch.zeros(1, device=DEVICE)
    build(libraries)
    return {"name": torch.cuda.get_device_name(0),
            "power_limit": power_limit()}


def sync() -> None:
    torch.cuda.synchronize()


def free() -> None:
    torch.cuda.empty_cache()


def reset_peak() -> None:
    torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated()


def activities() -> list:
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

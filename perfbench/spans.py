"""What the readers of the program's child stages share: a stage the
program may lack (a checkout older than the stage) is read as nothing,
not as zero seconds."""

from __future__ import annotations

from perfbench.readers import stage_per_job


def stage_if_present(record: dict, name: str) -> float | None:
    """stage_per_job of the stage `name`, or None where the window's
    stages do not hold it."""
    if name not in (record.get("stages") or {}):
        return None
    return stage_per_job(record, name)

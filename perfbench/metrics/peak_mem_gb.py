"""The card's peak allocated memory over the window (torch's
max_memory_allocated after reset_peak_memory_stats), GB."""


def read(record):
    peak = record.get("peak_mem_bytes", 0)
    return peak / 1e9 if peak else None

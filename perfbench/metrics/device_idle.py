"""Share of the traced window in which no kernel, copy or set ran on the
card, in percent; nothing where the trace saw no device work."""


def read(record):
    act = record.get("activity")
    if not act or act["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - act["busy_s"] / act["window_s"])

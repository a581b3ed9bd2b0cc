"""The device merge's rows sorted a lane taken in over the window: the
program's counters `devmerge.rows_sorted` (C + N of every merge, the
state's padded rows and its lanes) over `devmerge.lanes` (N of every
merge).  Each merge sorts and scans the whole state to take in its
lanes, so this is the merge's work a lane."""

PROBES = ["counters"]


def read(record):
    counters = record.get("counters") or {}
    lanes = counters.get("devmerge.lanes")
    if not lanes:
        return None
    return counters["devmerge.rows_sorted"] / lanes

"""The program's own counters over the window (kmer_tpu_torch's
`stagetime.count`, such as DeviceMerge's `devmerge.*` at each job's
end), summed under the record's `counters`.  A program without
`stagetime.counting` counts nothing, and the record has no `counters`."""

import contextlib


@contextlib.contextmanager
def probe(patch):
    from kmer_tpu_torch.utils import stagetime
    counting = getattr(stagetime, "counting", None)
    if counting is None:
        yield dict
        return
    counts: dict = {}
    with counting(counts):
        yield lambda: {"counters": counts}

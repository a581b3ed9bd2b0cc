"""The device merges' sort, K6 (`ops/devmerge.sort_words`), opens a
`bench::K6` range; nothing is counted (the merges probe counts its
rows)."""

import contextlib

from torch.profiler import record_function


@contextlib.contextmanager
def probe(patch):
    from kmer_tpu_torch.ops import devmerge
    sort0 = devmerge.sort_words

    def sort_words(*a, **kw):
        with record_function("bench::K6"):
            return sort0(*a, **kw)

    patch(devmerge, "sort_words", sort_words)
    yield dict

"""Each device merge (`ops/devmerge.merge_batch`) opens a
`bench::merge_batch` range; its shape is counted under the record's
`merges`: W key words, C state rows, N lanes, the bytes of a lane, and
the live rows before and after it."""

import contextlib

from torch.profiler import record_function


@contextlib.contextmanager
def probe(patch):
    from kmer_tpu_torch.ops import devmerge
    merge0 = devmerge.merge_batch
    merges = []

    def merge_batch(state_words, state_counts, batch_words, batch_counts,
                    *a, **kw):
        before = (state_counts > 0).sum()
        with record_function("bench::merge_batch"):
            out = merge0(state_words, state_counts, batch_words,
                         batch_counts, *a, **kw)
        merges.append(dict(
            W=len(state_words), C=state_counts.numel(),
            N=batch_counts.numel(),
            lane_bytes=(sum(w.element_size() for w in batch_words)
                        + batch_counts.element_size()),
            before=before, after=out[2]))
        return out

    patch(devmerge, "merge_batch", merge_batch)
    # the live rows are device scalars: read once the window has closed
    yield lambda: {"merges": [{**m, "before": int(m["before"]),
                               "after": int(m["after"])} for m in merges]}

"""The host's conversion of the drained rows, which no stage of the
program covers: the device merge's parts made into fused keys
(`pipeline/table.plane_run_pairs`, called by `to_part`) and the table's
key words made from them (`pipeline/table.unfuse_words`), both as
`pipeline/count` calls them.  Each call opens a `stage::convert` range;
their seconds are summed under the record's `convert_s`."""

import contextlib
import time

from torch.profiler import record_function


@contextlib.contextmanager
def probe(patch):
    from kmer_tpu_torch.pipeline import count
    seconds = [0.0]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                with record_function("stage::convert"):
                    return fn(*a, **kw)
            finally:
                seconds[0] += time.perf_counter() - t0
        return call

    patch(count, "plane_run_pairs", timed(count.plane_run_pairs))
    patch(count, "unfuse_words", timed(count.unfuse_words))
    yield lambda: {"convert_s": seconds[0]}

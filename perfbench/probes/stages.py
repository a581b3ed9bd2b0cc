"""Each stage of kmer_tpu_torch.utils.stagetime opens a `stage::<name>`
range, and the window's stage seconds are collected: the seconds the
jobs' thread was blocked in each stage, summed over the window, under
the record's `stages`."""

import contextlib

from torch.profiler import record_function


@contextlib.contextmanager
def probe(patch):
    from kmer_tpu_torch.utils import stagetime
    stage0, stage_iter0 = stagetime.stage, stagetime.stage_iter

    @contextlib.contextmanager
    def stage(name):
        with record_function(f"stage::{name}"), stage0(name):
            yield

    def stage_iter(name, it):
        def ranged():
            inner = iter(it)
            while True:
                with record_function(f"stage::{name}"):
                    try:
                        item = next(inner)
                    except StopIteration:
                        return
                yield item
        return stage_iter0(name, ranged())

    patch(stagetime, "stage", stage)
    patch(stagetime, "stage_iter", stage_iter)
    seconds: dict = {}
    with stagetime.collect(seconds):
        yield lambda: {"stages": seconds}

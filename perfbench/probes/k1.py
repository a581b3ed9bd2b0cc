"""The fused count step, K1 (`pipeline/count.fused_extract_count`), opens
a `bench::K1` range; each launch's shape is counted under the record's
`k1_launches`: (B, L, P_pad, W, packed)."""

import contextlib

from torch.profiler import record_function


@contextlib.contextmanager
def probe(patch):
    from kmer_tpu_torch.pipeline import count
    k1_0 = count.fused_extract_count
    launches = []

    def fused_extract_count(codes, *a, **kw):
        with record_function("bench::K1"):
            keys, counts = k1_0(codes, *a, **kw)
        pw = kw.get("packed_width", 0)
        launches.append((codes.shape[0], pw or codes.shape[1],
                         counts.shape[0],
                         len(keys) if isinstance(keys, tuple) else 1,
                         bool(pw)))
        return keys, counts

    patch(count, "fused_extract_count", fused_extract_count)
    yield lambda: {"k1_launches": [list(x) for x in launches]}

"""Command-line interface.

  count     FASTA/FASTQ -> sorted "kmer\\tcount" TSV on stdout
  parity    FASTA -> the reference's exact sorted chunk dump on stdout
  card      estimate DISTINCT k-mers (HyperLogLog) without a table

The flags are kmer_tpu's for the options this port carries, plus
--device.  The output is byte for byte the one `python -m kmer_tpu`
writes for the same input and flags.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kmer_tpu_torch", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    from . import __version__
    ap.add_argument("--version", action="version",
                    version=f"kmer-tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("count", help="count k-mers")
    pc.add_argument("fasta", nargs="+",
                    help="input FASTA/FASTQ file(s), auto-detected")
    pc.add_argument("-k", type=int, default=21)
    pc.add_argument("--canonical", action="store_true")
    pc.add_argument("--skip-invalid", action="store_true",
                    help="accept N/IUPAC bases and drop windows containing "
                         "them (default: error)")
    pc.add_argument("--min-qual", type=int, default=0,
                    help="FASTQ only: mask bases below this Phred+33 "
                         "quality and drop windows containing them "
                         "(implies --skip-invalid)")
    pc.add_argument("--batch-reads", type=int, default=2048)
    pc.add_argument("--max-read-len", type=int, default=256)
    pc.add_argument("--min-count", type=int, default=1,
                    help="suppress k-mers with count below this")
    pc.add_argument("--max-count", type=int, default=None,
                    help="suppress k-mers with count above this")
    pc.add_argument("--out-npz", default=None,
                    help="also save the table as a .npz (KmerTable.load)")
    pc.add_argument("--stats", action="store_true",
                    help="JSONL per-batch stats on stderr")
    pc.add_argument("--gapped", action="store_true",
                    help="gapped L+R chunks (the reference's window "
                         "semantics) instead of contiguous k-mers; -k is "
                         "then ignored")
    pc.add_argument("--l-len", type=int, default=27,
                    help="gapped left window length")
    pc.add_argument("--r-len", type=int, default=27,
                    help="gapped right window length")
    pc.add_argument("--c-min", type=int, default=80,
                    help="gapped minimum chunk span")
    pc.add_argument("--c-max", type=int, default=140,
                    help="gapped maximum chunk span")
    pc.add_argument("--seed-mask", default=None,
                    help="spaced seed: 0/1 match mask (e.g. 1101011); the "
                         "key is the bases at the '1' offsets per window "
                         "(-k is then ignored; canonical needs a "
                         "palindromic mask)")
    pc.add_argument("--compact", action="store_true",
                    help="on-device compaction: device->host transfer "
                         "scales with distinct k-mers (sort mode)")
    pc.add_argument("--device-merge", choices=("auto", "on", "off"),
                    default="auto",
                    help="device-resident table: the table stays on the "
                         "device and only distinct rows are read back "
                         "(auto: on when the probed device->host link is "
                         "slow)")
    pc.add_argument("--mode", choices=["auto", "dense", "sort"],
                    default="auto",
                    help="dense: a 4^k table (k <= 12); auto: dense for "
                         "k <= 8 when the probed device->host link is "
                         "slow, else sort")
    _add_device(pc)

    pp = sub.add_parser("parity", help="reference-parity sorted chunk dump")
    pp.add_argument("fasta")
    pp.add_argument("--batch-reads", type=int, default=256)
    pp.add_argument("--max-read-len", type=int, default=512)
    pp.add_argument("--bounded", action="store_true",
                    help="bounded-memory streaming dump: spill "
                         "per-partition line runs, sort one partition at "
                         "a time; byte-identical output")
    pp.add_argument("--spill-dir", default=None,
                    help="spill directory for --bounded (default: a temp "
                         "dir, removed afterwards)")
    pp.add_argument("--partitions", type=int, default=64,
                    help="spill partitions for --bounded")
    _add_device(pp)

    pe = sub.add_parser("card", help="estimate DISTINCT k-mers (F0 "
                                     "cardinality, HyperLogLog) without "
                                     "building a table")
    pe.add_argument("fasta", nargs="+",
                    help="input FASTA/FASTQ file(s), auto-detected")
    pe.add_argument("--batch-reads", type=int, default=2048)
    pe.add_argument("--max-read-len", type=int, default=256)
    pe.add_argument("--stats", action="store_true",
                    help="JSONL per-batch stats on stderr")
    pe.add_argument("-k", type=int, action="append", default=None,
                    help="k value; repeatable (-k 17 -k 21 -k 31): all "
                         "ks are sketched in ONE ingest pass (default: 21)")
    pe.add_argument("--canonical", action="store_true")
    pe.add_argument("--skip-invalid", action="store_true")
    pe.add_argument("--min-qual", type=int, default=0)
    pe.add_argument("--seed-mask", default=None,
                    help="estimate distinct SPACED keys (0/1 mask; "
                         "exclusive with -k)")
    pe.add_argument("--buckets-log2", type=int, default=10,
                    help="HLL precision b: 2^b buckets, relative error "
                         "~1.04/sqrt(2^b) (default 10: ~3.3%%)")
    _add_device(pe)

    args = ap.parse_args(argv)
    run = {"count": _count, "parity": _parity, "card": _card}[args.cmd]
    try:
        return run(args)
    except (ValueError, OSError, NotImplementedError) as e:
        print(f"kmer_tpu_torch: error: {e}", file=sys.stderr)
        return 1


def _add_device(p) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the Hopper kernels (default); cpu: their "
                        "plain torch versions")


def _count(args) -> int:
    from .config import KmerConfig
    from .pipeline.count import count_files
    if args.gapped and args.seed_mask:
        raise ValueError("--seed-mask and --gapped are exclusive")
    if args.gapped and args.canonical:
        raise ValueError("--canonical applies to contiguous k-mers (gapped "
                         "chunks have no reverse-complement contract)")
    kw = dict(batch_reads=args.batch_reads,
              skip_invalid=args.skip_invalid or args.min_qual > 0,
              min_qual=args.min_qual, stats=args.stats, compact=args.compact,
              device_merge=args.device_merge)
    if args.gapped:
        cfg = KmerConfig(gapped=True, l_len=args.l_len, r_len=args.r_len,
                         c_min=args.c_min, c_max=args.c_max,
                         max_read_len=max(args.max_read_len, args.c_max),
                         **kw)
    else:
        span = len(args.seed_mask) if args.seed_mask else args.k
        cfg = KmerConfig(k=args.k, canonical=args.canonical, mode=args.mode,
                         max_read_len=max(args.max_read_len, span),
                         seed_mask=args.seed_mask, **kw)
    table = count_files(args.fasta, cfg, device=args.device)
    if args.min_count > 1 or args.max_count is not None:
        table = table.filter_count_range(args.min_count, args.max_count)
    if args.out_npz:
        table.save(args.out_npz)
    table.write_tsv(sys.stdout)
    return 0


def _card(args) -> int:
    from .config import KmerConfig
    from .pipeline.sketch import estimate_distinct_multi_k
    if args.seed_mask and args.k:
        raise ValueError("--seed-mask selects its own key width (the mask "
                         "popcount); -k cannot be combined with it")
    ks = list(dict.fromkeys(args.k or [21]))
    span = len(args.seed_mask) if args.seed_mask else max(ks)
    cfg = KmerConfig(k=max(ks), canonical=args.canonical,
                     batch_reads=args.batch_reads,
                     max_read_len=max(args.max_read_len, span),
                     skip_invalid=args.skip_invalid or args.min_qual > 0,
                     seed_mask=args.seed_mask, min_qual=args.min_qual,
                     stats=args.stats)
    res = estimate_distinct_multi_k(args.fasta, ks, cfg,
                                    b=args.buckets_log2, device=args.device)
    for kk, (est, total) in zip(ks, res):
        prefix = f"k={kk}\t" if len(ks) > 1 else ""
        sys.stdout.write(f"{prefix}distinct_estimate\t{round(est)}\n"
                         f"{prefix}total_kmers\t{total}\n")
    return 0


def _parity(args) -> int:
    from .config import KmerConfig
    from .pipeline.parity import parity_dump, parity_dump_stream
    cfg = KmerConfig(gapped=True, batch_reads=args.batch_reads,
                     max_read_len=args.max_read_len)
    if args.bounded:
        parity_dump_stream(args.fasta, sys.stdout.buffer, cfg,
                           spill_dir=args.spill_dir,
                           partitions=args.partitions, device=args.device)
    else:
        sys.stdout.buffer.write(parity_dump(args.fasta, cfg,
                                            device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Command-line interface.

  count     FASTA/FASTQ -> sorted "kmer\\tcount" TSV on stdout

The flags are kmer_tpu's for the options this port carries, plus
--device.  The TSV is byte for byte the one `python -m kmer_tpu count`
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
    pc.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the Hopper kernel (default); cpu: the "
                         "plain torch version")

    args = ap.parse_args(argv)
    try:
        return _count(args)
    except (ValueError, OSError, NotImplementedError) as e:
        print(f"kmer_tpu_torch: error: {e}", file=sys.stderr)
        return 1


def _count(args) -> int:
    from .config import KmerConfig
    from .pipeline.count import count_files
    cfg = KmerConfig(k=args.k, canonical=args.canonical,
                     batch_reads=args.batch_reads,
                     max_read_len=max(args.max_read_len, args.k),
                     skip_invalid=args.skip_invalid or args.min_qual > 0,
                     min_qual=args.min_qual, stats=args.stats)
    table = count_files(args.fasta, cfg, device=args.device)
    if args.min_count > 1 or args.max_count is not None:
        table = table.filter_count_range(args.min_count, args.max_count)
    if args.out_npz:
        table.save(args.out_npz)
    table.write_tsv(sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--only 17|26|27|28|30]

Run from the root of a checkout.  Phases, each printing one line (or a
few) to stdout:

  1. environment: torch/CUDA versions, the card's name and power limit,
     nvcc, and the kernels and native host libraries, all built at once
     (one compiler process each), with their build times; the probed
     device-to-host link rate behind the "auto" policies;
  2. kernel K1 (kmer_tpu_torch/csrc/fused_extract.cu) against its plain
     torch version on the card, bit-exact lane for lane, at the main
     path's shape (B=8192, L=160, k=21, canonical, seg=2, packed rows)
     and at edge cases (k = 32 and 63 on u8 rows with ambiguous codes
     among them); both timed on the device with CUDA events (the median
     of 20 samples of 10 back-to-back calls, after warm-up), and as a
     caller sees one synchronised call; the timed launch's geometry
     (threads, blocks, shared bytes, registers, spills, blocks an SM);
  3. kernel K3 (kmer_tpu_torch/csrc/fused_gapped.cu) the same way, at the
     parity path's shape (B=256, L=416, l=r=27, c in [80, 140], packed
     rows) and at edge cases (asymmetric windows, u8 rows with ambiguous
     codes, short lengths and limits, c_max > L, L < c_min, seg 2-16, a
     ragged flat tail, rows much shorter than a warp's piece, rows of
     12,288 bases packed and u8, too many wide rows to stage); the timed
     launch's geometry;
  4. the k=21 path end to end through kmer_tpu_torch.count_fasta(...,
     device="cuda"), canonical, the default KmerConfig, on a seeded E.
     coli-sized corpus (1M reads of 150 bases from a 4.6 Mbase genome,
     0.2% base errors, ~32x coverage): the table total, K1's launch count
     against the batch count, and an independent numpy oracle on the
     first 50,000 reads;
  5. the reference's parity dump of tests/data/sample.fasta on the card:
     its md5 by count + expand (the GPU default, compacted by K4), by the
     per-batch multiset sort and bounded-memory with 7 spill partitions
     (both sorted by K6, which must launch), each timed;
  6. the gapped path end to end: count_fasta(..., KmerConfig(gapped=True,
     batch_reads=256, max_read_len=512), device="cuda") on
     reference_style_fasta(n_records=4000) (400-base records, ~71.0 M
     chunks): the table total, K3's launch count against the batch
     count, sorted unique keys, and the card's table against the CPU's
     on the first 300 records;
  7. kernel K4 (kmer_tpu_torch/csrc/compact.cu) against its plain
     version on the card, bit for bit (records in lane order and the
     total), on K1's output at the main shape and K3's at the parity
     shape, and at edge cases (no live lane, every lane live, a ragged
     last tile, a one-uint64 gapped record, no lanes at all) and the
     look-back's (one lane; a tile and a lane either side of it; every
     lane live over 40 tiles; one live lane in the last tile; live lanes
     in every other tile; an int32 tail no multiple of 4), then sixteen
     calls back to back on different inputs; timed beside
     torch.masked_select of one key plane (a yardstick);
  8. kernel K5 (kmer_tpu_torch/csrc/histogram.cu) the same way, bit for
     bit, each case timed with its grid (clusters x blocks), shared bytes
     a block and registers a thread: bits = 8, 15 and 16 over a stream
     the size of one k=21 batch (beside torch.bincount), HyperLogLog
     classes at b = 10 and 11 on K1's main-shape k = 21 output, at b = 10
     on one `card` batch of 2048 reads and on k = 55 (hi, lo) pairs; then
     a hot bin past 2**31 (17 M lanes in bin 0 at weight 127), unaligned
     views of keys and weights, and an empty stream;
  9. the k=21 run of phase 4 again with compact=True: its table equals
     phase 4's, K1 and K4 launch once a batch; the stage breakdown;
 10. the gapped run of phase 6 again with compact=True: its table equals
     phase 6's (the parity runs of phase 5 already took the GPU default,
     compact=True);
 11. dense mode on phase 4's corpus: k=8 through K5 and k=12 through the
     host hybrid, each table equal to the sort-mode table at that k and
     its total equal to sum(len - k + 1); then k=12 again with
     KMER_TPU_DENSE_SCATTER=1 (a device index_add_ table): equal to the
     hybrid's;
 12. `card -k 21 --canonical` on phase 4's corpus: the class histogram
     equals the plain version's on the first 50,000 reads, and the
     estimate falls within 15% of phase 4's exact distinct count;
 13. kernel K6 (kmer_tpu_torch/csrc/sort.cu, the hybrid MSD radix
     sort) against its plain version, bit for bit, payload order
     included: the
     k = 21 device merge as merge_batch calls it (a 2**24-row state plus
     2**23 lanes of K1 output: one 42-bit key word, counts as payload),
     the same rows with the counts keyed at 32 bits and with every word
     a 64-bit key (the parent's work), the k = 55 merge (hi, lo at 62
     and 48 bits, counts), k = 63 lo words (64 bits: negatives, a real
     INT64_MAX), the span-55 mask's sort_group_keys=0 lanes, the parity
     shape (K3's live (hi, lo, counts) at B=256, L=416) with and without
     bits, edge cases (N = 1, N around the 4096-row tile, an odd
     pass count, a non-power-of-two N, all sentinels, all equal rows,
     W = 4) and the MSD levels' hard cases (a key repeated over 3 M of
     5 M rows, every row in one top-level bucket, presorted and
     reversed input, the device merge with half the rows sentinel,
     6 planes of 5 keys, 240 planes, near-duplicate pairs for the local
     sort's run fix-up and 6000 ties for its fallback); each caller's
     shape timed beside
     the plain version and torch.sort of one word at the same N, with
     K6's plan and launch geometry (levels, local rows, grids);
 14. phase 4's run with device_merge="on" (the table on the card, merged
     by K6): its table equals phase 4's, K6 launches once a merge, the
     stage breakdown and wall beside phase 4's host-merge wall; then the
     same run under torch.profiler: device time by kernel and the
     device's busy share;
 15. phase 6's run with device_merge="on": its table equals phase 6's;
 16. kernel K7 (kmer_tpu_torch/csrc/extract.cu) against its plain version,
     lane for lane, at the main shape (canonical, packed rows) and at
     k = 1, 16, 17, 31, 32 and 63 (u8 rows with ambiguous codes, short
     lengths and limits); both timed, with the launch's geometry;
 17. kernels K2a, K2b and K2c (kmer_tpu_torch/csrc/grouped_count.cu)
     against their plain versions, bit for bit (sorted planes and
     counts): on K7's output of one main batch (1,146,880 keys, m = 256,
     G = 4480; m = 16 for K2c), on W = 2 and W = 4 rows with many
     duplicates and sentinels, and at edge cases (m = 2, 128, the largest
     K2b m, G = 1, all sentinels, one run filling a group); each body of
     K2b and K2c at its edges (the column body at m = 1, 16 and 32, G
     odd, W = 4; the warp body at m = 32, 64 and 1024; the block body at
     m = 512, W = 4; planes that are not 16-byte aligned; rows that tie
     in every word but the last; the index bodies: K2b's warp index body
     at m = 2, 16, 256 and 512, W = 4, 5, 7 and 13 (its widest at m =
     512), K2c's column index body at m = 1, 2 and 16, W = 5, 7 and 29
     (its widest at m = 16), G odd, word 0 from two values so that later
     words decide, dead rows whose last word varies, unaligned planes),
     each with the body its launch takes;
     K2a alone at m = 1, 3, 33, 128, 1000 and 4096 for W = 1 to 4, a run
     filling a group, a run over a tile's end and groups of sentinels
     only; each timed (also at W = 2 on the k = 55 unfused step's
     groups: K2a and K2b at (3392, 256), K2c at (16, 54272)), K2b and
     K2c beside torch.sort of one word at the same shape as a sort-only
     yardstick, with each timed launch's body, geometry, registers and
     spills;
 18. the unfused route at full depth, right after phase 4: phase 4's run
     with KMER_TPU_STEP=legacy (K7, the grouped torch.sort and K2a a
     batch): its table equals phase 4's, K7 and K2a launch once a batch,
     the stage breakdown and wall beside phase 4's and beside the fused
     run once more;
 19. the unfused route on the 50,000-read oracle file, each table against
     the numpy oracle: KMER_TPU_GROUPED=pallas (K2b), KMER_TPU_STEP=t
     (K2c), sort_group_keys=0 (K7 + K6 + run lengths), compact=True (K7,
     K2a, K4 on int32 counts) and device_merge="on" (K7, K2a, K6) under
     KMER_TPU_STEP=legacy; each run's kernels must launch;
 20. kernels K1 and K7 on keys of 32 to 63 bases (the (hi, lo) int64
     pair) and on spaced seeds against their plain versions, lane for
     lane, at B=8192, L=160: k = 32, 45, 48, 55, 63 and the masks
     1110111...0111 of span 31 (24 selected) and 55 (42 selected),
     canonical and not, packed rows and u8 rows with ambiguous codes
     and short rows; each variant timed at k = 55 (or the span-55 mask),
     canonical, packed, with its launch's geometry; phases 7 and 8 also
     hold K4 on K1's pairs (k = 55, and k = 63 whose lo carries a flipped
     top bit) and K5's HyperLogLog classes on k = 55 pairs;
 21. k = 55 canonical on phase 4's corpus (96 M k-mers): the default
     (host merge), compact=True (K1 -> K4), device_merge="on" (K1 -> K6
     at two key words) and KMER_TPU_STEP=legacy with the grouped sort
     (K7 -> torch.sort -> K2a): equal tables, the total sum(len - k +
     1), the table on the first 50,000 reads equal to a numpy oracle of
     (hi, lo) rows; walls and stage breakdowns;
 22. the span-55 mask, canonical, on the same corpus: the default,
     device_merge="on" and sort_group_keys=0 (K7 -> K6): equal tables,
     equal to the oracle on 50,000 reads;
 23. `card -k 55 --canonical` and `card --seed-mask <span-55 mask>
     --canonical`: each estimate within 15% of the exact distinct count
     of phases 21 and 22;
24. streaming two-pass with checkpoint/resume (pipeline/streaming), each
     run paused mid-pass-1, its counter dropped, the card's cache emptied
     and pass 1 resumed by a fresh counter, then pass 2; each prints its
     pass-1 and pass-2 walls and stage breakdowns, its launches, drains
     and spill bytes, and deletes its spill directory after its check:
     (a) the per-batch spill path on phase 4's corpus (device_merge="off",
     16 partitions, three ingest chunks of 2**26 bases, paused past the
     first): its table equals phase 4's, K1 launches once a batch;
     (c) phase 6's gapped corpus through the per-batch path (K3) and the
     device merge (K3 -> K6): both equal phase 6's table;
     (b) BASELINE.json's "large corpus streaming" at 10M reads of 150
     bases (one seeded 4.6 Mbase genome at 0.2% errors, written a slice
     of 1M reads at a time, ~1.6 GB) through the device merge: first
     count_fasta(..., device_merge="on") in memory, then the streaming
     run (six ingest chunks, a drain-commit each, paused in the second):
     equal tables, the total sum(len - k + 1), K1 once a batch, K6 at
     least once a drain, peak device memory beside the state's bytes;
 25. the saved-table surface through kmer_tpu_torch.cli.main in process,
     stdout captured, each run's launches printed:
     (a) phase 4's corpus written as BGZF by io/bgzf.write_bgzf on
     every CPU core (its seconds), then `count --device cuda
     --device-merge on -k 21 --canonical --threads 8 --batch-reads 8192
     --out-npz` (phase 4's batches): block-parallel BGZF ingest, the
     saved table equal to phase 4's, K1 once a batch and K6; the CLI's
     stages (utils/stagetime, save_npz and write_tsv among them) and
     what they leave unattributed;
     (b) `count --profile-dir` on the 50,000-read file: the trace file
     holds device events of K1's kernel by name, the three kernels with
     the most device time in it, and the TSV equals the untraced run's;
     (c) the 50,000-read file counted whole and as two halves at k = 21
     and k = 55, each saved with --out-npz: `tools union` of the halves
     writes the whole table's TSV; `intersect`, `subtract`,
     `kmers-subtract` and `compare` equal a numpy oracle over the halves' keys
     (np.intersect1d, the arithmetic by hand); `dump --histo` equals
     `histo`; `dump --top 10` a numpy top 10 of the whole TSV;
     (d) `query` of 1000 k-mers of the whole table, then their reverse
     complements and 1000 random k-mers with --canonical: the table's
     counts, 0 where absent; the stages of (c)'s counts and tools;
     (e) `generate --format fastq` counts to sum(len - k + 1), and
     io/generator.random_reads_fastq(..., qual_range=(2, 41)) counted
     at k = 9 with --min-qual 20 to the windows with no base below
     Phred 20, from a numpy oracle on the same text;
 26. multi-GPU counting (kmer_tpu_torch.parallel) on one card: a mesh of
     positions on cuda:0, its collectives tensor moves (or, in (e), a
     one-rank NCCL group's calls); every part prints its seconds, its
     launches, the bytes the exchange and the halo moved and the rows
     each owner took with the largest over the mean (routing skew).
     Four positions share one card, so no wall here is a scaling figure:
     (a) count_fasta_multihost over a (4, 1) mesh, k = 21 canonical, on
     phase 4's corpus: phase 4's table, K1 and K6's owner partition four
     times a global batch, the wall beside phases 4 and 14;
     (b) the 50,000-read file over a (2, 2) mesh (a seq halo) and a (1,
     4) mesh whose 48-base shards are narrower than the 64-base halo of
     k = 55 and the span-55 mask (several hops), at k = 21, 55 and the
     mask: each table equals the single-device one;
     (c) the gapped pairs step (K3) over a (2, 1) mesh on phase 6's
     corpus (phase 6's table); KMER_TPU_MULTIHOST_STEP=legacy (K7, K6,
     the exchange, K6) on the 50,000-read file, exact, its owners'
     streams globally sorted; dense k = 8 (K1 + K5) over a (4, 1) mesh
     by all-reduce and by reduce-scatter, each phase 11's table;
     (d) 200,000 poly-A reads with substitutions only in their last
     k - 4 bases, every key owned by owner 0, over a (4, 1) mesh: the
     numpy oracle's table, owner 0 taking every routed row;
     (e) a one-rank NCCL group: count_fasta_multihost and `count
     --multihost` (cli.main) on the 50,000-read file through the group's
     all_to_all_single, each equal to the single-device table;
     (f) StreamingCounter over a (2, 1) mesh paused after 3 batches and
     resumed over a (4, 1) mesh: the in-memory table;
 27. keys of any width (contiguous keys over 63 bases in W int64 words,
     gapped windows over 31 bases, the gapped unfused route):
     (a) K7's multi-word entry at k = 64, 101 and 125 and its gapped
     entry at (27, 27) and (40, 40), c in [80, 140], canonical or not,
     on packed rows and on u8 rows with ambiguous codes and short rows,
     B = 8192, L = 160, and the multi-word entry at its edges (tiles
     ending inside rows, B P no multiple of 32, one window a row, P
     below a block, rows shorter than k, W = 3, 4, 5 and 7, rows too
     wide to stage, which take its row body); K6 at the k = 101 device
     merge's 5 planes; K2a, K2b and K2c at W = 4 and 5 (K2b and K2c
     also at W = 5 and 7 on word-0 ties and unaligned planes, and timed
     on K7's k = 130 keys of one main batch, under `k130`); K4 on 3- and
     4-word records: each bit for bit against its plain version, timed
     with CUDA events, with its launch geometry (the multi-word entry
     also at `card`'s batch of 2048 reads);
     (b) k = 101 canonical on phase 4's corpus (50 M k-mers) by the
     default route (K7, the grouped dedup, the host merge) and the
     device merge (K6 on 5 planes): the tables equal, the total
     sum(len - 100), the first 50,000 reads against the numpy oracle,
     walls, stage breakdowns and the device merge's peak memory beside
     its state (compact and sort_group_keys = 0 run in (e));
     (c) gapped l = r = 40, c in [80, 140] on the first 1000 of phase 6's
     records (17.8 M chunks) by the default route, compact, the device
     merge and sort_group_keys = 0: the tables equal, the first 300
     records' table the CPU's;
     (d) phase 6's 27/27 corpus under KMER_TPU_GAPPED_STEP=legacy: phase
     6's table, and the parity md5 on that route;
     (e) on the 50,000-read file, each against the numpy oracle: k = 101
     and 130 (W = 4, 5) under KMER_TPU_GROUPED=hybrid (K2a), pallas
     (K2b) and KMER_TPU_STEP=t (K2c); k = 64 and 101 compacted (K4 on
     3- and 4-word records); k = 101 at sort_group_keys = 0;
 28. wide keys on streaming, `card` and the mesh (k = 101 canonical,
     gapped 40/40):
     (a) K5's plane mode on K7's keys of one `card` batch (2048 reads)
     at k = 64, 101 and 130 (W = 3, 4, 5), bit for bit against its plain
     version, timed, with its grid and registers; sentinel lanes only
     and an empty stream; random keys and weights at lane counts no
     multiple of 32, W = 3 to 6 and 9; the class histogram of the
     50,000-read file at
     k = 101 equal to the plain version's; `card -k 101` on phase 4's
     corpus (489 batches of K7 -> K5) within 15% of phase 27's exact
     distinct count; `card -k 21 -k 101` through cli.main;
     (b) streaming at k = 101 on phase 4's corpus through the device
     merge, paused after a third of the batches and resumed by a fresh
     counter: phase 27b's table by digest, each pass's wall, stages and
     spill bytes; the per-batch route at k = 101 on the 50,000-read file
     against the numpy oracle, and `count --two-pass -k 101` through
     cli.main (its TSV); gapped 40/40 by both routes on phase 27c's 1000
     records: 27c's table;
     (c) positions on one card at k = 101: (4, 1) on the first 200,000
     reads of phase 4's corpus against the single-device device merge of
     that file, with route_sync, exchange and the exchange's bytes; (2,
     2) and (1, 4) on the 50,000-read file (multi-hop halos), `count
     --multihost -k 101` through cli.main (its TSV) and the legacy sorted
     stream; gapped 40/40 over (2, 1) on 27c's records;
     StreamingCounter paused on (2, 1) and resumed on (4, 1);
 30. the device merge's run totals and compaction
     (kmer_tpu_torch/csrc/merge_reduce.cu) against its plain twin, the
     state byte for byte and distinct, at the k = 21 merge shape (a
     2**24-row state of ~10 M distinct 42-bit keys and a C/2 batch of
     keys partly from the state, a tenth dead, sorted by K6 as
     merge_batch sorts them) and at W = 2 (a k = 55 merge) and W = 5;
     each timed in turns beside the twin (CUDA events), one JSON line a
     shape with its ms, bound ms, plain ms and launches; phase 14 checks
     that every merge of the k = 21 run launched it;
 29. one JSON line with every kernel of the paths (with its bound and,
     where one PyTorch call computes the same function, that call's
     time; K1 and K7 with a row for each of their two-word and spaced
     variants, a row for each variant phase 27 widened and K5's plane
     mode; K7's multi-word row with `card`'s batch under `cases`), then
     the result line {"ok": true, "device": {...}} last.

--only 17 runs phase 1, then phase 17 (the grouped kernels), prints its
kernel rows and "chip_smoke --only 17: done"; --only 30 likewise phase
30.
--only 26 runs phase 1, then phase 26 and the phases whose tables and
walls it reads (4, 14, 6, 11), in about a quarter of the whole run, and
prints "chip_smoke --only 26: done" in place of phase 29: a quick check
of the multi-GPU path, not the whole script's result.  --only 27 runs
phase 1, then phases 4, 6 and 27, prints phase 27's kernel rows and
"chip_smoke --only 27: done"; --only 28 runs phases 1, 4, 6, 27 and 28
and prints their kernel rows and "chip_smoke --only 28: done".

Every device-merge run prints the card's peak memory
(torch.cuda.max_memory_allocated) beside the state's own bytes:
KMER_TPU_DEVMERGE_MAX_MB bounds the state alone.

Any failed check raises, so the script exits non-zero and prints no
result line.  Without a CUDA device it fails at once.

Bounds: the larger of the bytes a kernel must move (each input read
once, each output written once) over the card's peak DRAM bandwidth
(utils/profiling.detect_hbm_bw: HBM3's 3.35 TB/s on an H100 SXM,
NVIDIA's data sheet; an unknown card fails the run) and the thread
instructions its function needs over the card's issue ceiling: four warp
instructions an SM a clock, one from each scheduler of its four
partitions (the H100 white paper), whatever pipe they go to -- SMs x 128
x the maximum SM clock that nvidia-smi reads, 33.5 T/s on an H100 SXM,
half the data sheet's 67 TFLOP/s float32, which counts a fused
multiply-add as two.
"""

from __future__ import annotations

import argparse
import bisect
import concurrent.futures as cf
import contextlib
import functools
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K = 21
MAIN_B, MAIN_L, SEG = 8192, 160, 2
N_READS, READ_LEN, GENOME_LEN, ERROR_RATE = 1_000_000, 150, 4_600_000, 0.002
ORACLE_READS = 50_000
# the gapped path: the reference's windows, parity batches, 400-base
# records in tight 416-base rows
GAP = dict(l_len=27, r_len=27, c_min=80, c_max=140)
GAP_B, GAP_L, GAP_LEN = 256, 416, 400
GAP_RECORDS, GAP_ORACLE_RECORDS = 4000, 300
# streaming two-pass: 16 spill partitions; the per-batch path at 1M reads
# in three ingest chunks of 2**26 bases; the device-merge path at
# BASELINE.json's 10M reads ("large corpus streaming"), written in slices
# of 1M reads, in six chunks of the default 2**28 bases
STREAM_PARTS, STREAM_CHUNK_BASES = 16, 1 << 26
BIG_READS, BIG_SLICE_READS = 10_000_000, 1_000_000
# keys of 32 to 63 bases and spaced seeds: k = 55, and two palindromic
# masks, span 31 with 24 selected (one key word) and span 55 with 42
# selected (a (hi, lo) pair); phase 20 also checks the edges of the rolled
# spaced window (spans of exactly 32 and 64, a 32-base key in a 32-base
# span, a 32-base run that makes lo's flipped top bit, single-base runs, a
# mask that is no palindrome) and a span over 64 (the gathered window)
WIDE_K = 55
SHORT_MASK = "1110111011101110111011101110111"
WIDE_MASK = "1110111011101110111011101110111011101110111011101110111"
EDGE_MASKS = ("1111" + "0" * 24 + "1111", "1" * 32,
              "1" * 20 + "0" * 24 + "1" * 20, "1" * 31 + "0" + "1" * 32,
              "10" * 31 + "1", "110100101011")
GATHER_MASK = "1" * 10 + "0" * 80 + "1" * 10
# keys of any width (phase 27): k = 101 (4 int64 words) on phase 4's
# corpus, K7 also at k = 64 (3 words) and 125 (4 words, the last holding
# 32 bases); gapped windows of 40 bases (the string L||R in 3 words) on
# phase 6's records
ANY_K, ANY_KS = 101, (64, 101, 125)
GAP_WIDE = dict(l_len=40, r_len=40, c_min=80, c_max=140)
# phase 27c counts the first quarter of phase 6's records: each of its
# host-merge routes sorts every chunk's 3-word key on the host
# (np.lexsort), ~50-70 s on the whole corpus
GAP_WIDE_RECORDS = GAP_RECORDS // 4
REPO = os.path.dirname(os.path.abspath(__file__))
# thread instructions a second: an SM issues at most four warp
# instructions a clock, one from each of its four schedulers (NVIDIA H100
# white paper), whichever pipe takes them; main() sets it from the card's
# SM count and maximum SM clock (132 x 128 x 1.98 GHz = 33.5 T/s on an
# H100 SXM)
OPS_PER_S = 132 * 128 * 1.98e9


def hbm_bytes_per_s(dev=None) -> float:
    """The card's peak DRAM bandwidth, bytes/s, from
    utils/profiling.detect_hbm_bw; AssertionError for a card it does not
    know."""
    from kmer_tpu_torch.utils.profiling import detect_hbm_bw
    bw = detect_hbm_bw(dev)
    if bw is None:
        raise AssertionError(f"{torch.cuda.get_device_name(dev)}: peak DRAM "
                             "bandwidth unknown (utils/profiling."
                             "PEAK_DRAM_BYTES_PER_S)")
    return bw


def issue_ops_per_s(dev) -> float:
    """SMs x 4 schedulers x 32 lanes x the card's maximum SM clock."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(_tool(["nvidia-smi", "--query-gpu=clocks.max.sm",
                       "--format=csv,noheader,nounits"]).splitlines()[0])
    return sms * 128 * mhz * 1e6


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    thread instructions over the issue ceiling, whichever is larger."""
    t_bytes = n_bytes / hbm_bytes_per_s() * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _say(*parts) -> None:
    print(*parts, flush=True)


def _tool(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout.strip()


def kernel_batch(rng, B, L, k, *, packed, amb, short, amb_share=None):
    """Random codes + lengths + limits as tensors (host side); packed
    rows cross as the int32 view of the 2-bit packed words.  With amb,
    a fifth of the codes are ambiguous (4), or amb_share of them."""
    from kmer_tpu_torch.io.fasta import pack_batch_codes
    codes = rng.integers(0, 5 if amb and amb_share is None else 4, (B, L),
                         dtype=np.uint8)
    if amb and amb_share is not None:
        codes[rng.random((B, L)) < amb_share] = 4
    if short:
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        limits = rng.integers(1, L + 1, B).astype(np.int32)
    else:                       # full 150-base reads, as the main path
        lengths = np.full(B, min(READ_LEN, L), np.int32)
        limits = np.full(B, L, np.int32)
    c = pack_batch_codes(codes).view(np.int32) if packed else codes
    return [torch.from_numpy(np.ascontiguousarray(c)),
            torch.from_numpy(lengths), torch.from_numpy(limits)]


def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call: the median over `reps` samples, each the
    CUDA-event time of `inner` back-to-back calls divided by `inner`,
    after warm-up.  A sleep kernel queued ahead of each sample holds the
    stream while the host enqueues the calls, so the events time device
    work alone, not the host's per-call launch cost."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)        # ~30 ms of GPU cycles
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / inner)
    return float(np.median(ts))


def time_host_ms(fn, reps: int = 20) -> float:
    """Median wall time of one synchronised call, as a caller sees it
    (host launch cost included)."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def launch_line(label: str, mod, B: int, L: int, k: int, **kw) -> None:
    """Print the launch K1's or K7's wrapper makes for a (B, L) batch:
    threads a block, blocks, threads launched, shared bytes a block,
    registers a thread, spill bytes and resident blocks an SM."""
    info = mod.launch_info(B, L, k, **kw)
    _say(f"launch kernel={label} B={B} L={L} n_bases={k} "
         + " ".join(f"{key}={v}" for key, v in info.items())
         + f" threads_launched={info['threads'] * info['blocks']}")


def phase_kernel(dev, seed: int) -> dict:
    """Kernel == plain version, lane for lane, on `dev`; returns the
    kernel's JSON record (without the main-path launch count)."""
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    rng = np.random.default_rng(seed)
    cases = [  # (B, L, k, canonical, packed, ambiguous, short, seg)
        (MAIN_B, MAIN_L, K, True, True, False, False, SEG),
        (4096, 150, 5, True, True, False, True, 2),
        (4096, 150, 15, True, True, False, True, 8),
        (4096, 150, 16, True, True, False, True, 2),
        (4096, 150, 31, True, True, False, True, 4),
        (4096, 150, 21, False, True, False, True, 2),
        (4096, 150, 21, True, False, True, True, 2),
        (999, 77, 31, False, False, True, True, 16),
        (4096, 150, 32, True, False, True, True, 2),
        (4096, 150, 63, True, False, True, True, 4),
    ]
    max_err = 0
    for B, L, k, canon, packed, amb, short, seg in cases:
        # 1% ambiguous codes for pairs, so that a 63-base window can be
        # live
        host = kernel_batch(rng, B, L, k, packed=packed, amb=amb,
                            short=short, amb_share=0.01 if k > 31 else None)
        kw = dict(canonical=canon, mask_ambiguous=amb, seg=seg,
                  packed_width=L if packed else 0)
        on_dev = [t.to(dev) for t in host]
        keys, counts = fe.fused_extract_count(*on_dev, k, **kw)
        want_keys, want_counts = fe.fused_extract_count_ref(*on_dev, k, **kw)
        torch.cuda.synchronize()
        err = max(exact_err(keys, want_keys),
                  exact_err(counts, want_counts))
        live = int((counts > 0).sum())
        _say(f"kernel_check B={B} L={L} k={k} canonical={canon} "
             f"packed={packed} ambiguous={amb} short={short} seg={seg} "
             f"live_lanes={live} max_abs_err={err}")
        if err != 0 or live == 0:
            raise AssertionError(f"kernel != plain version (k={k}, "
                                 f"max_abs_err={err}, live={live})")
        max_err = max(max_err, err)
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, K,
                                            packed=True, amb=False,
                                            short=False)]
    kw = dict(canonical=True, seg=SEG, packed_width=MAIN_L)
    kernel = functools.partial(fe.fused_extract_count, *main, K, **kw)
    plain = functools.partial(fe.fused_extract_count_ref, *main, K, **kw)
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    host_ms, plain_host_ms = time_host_ms(kernel), time_host_ms(plain)
    lanes = (MAIN_L - K + 1) * MAIN_B
    out_bytes = kernel()[1].numel() * 9            # int64 key + int8 count
    # packed codes, lengths and limits in; ~16 integer operations a lane
    # (the key and its reverse complement, min, validity, collapse)
    b = bound(main[0].numel() * 4 + MAIN_B * 8 + out_bytes, lanes * 16)
    launch_line("fused_extract_count", fe, MAIN_B, MAIN_L, K, canonical=True,
                seg=SEG)
    _say(f"kernel_time B={MAIN_B} L={MAIN_L} k={K} kernel_ms={ms} "
         f"plain_ms={plain_ms} speedup={plain_ms / ms} "
         f"lanes_per_s={lanes / (ms * 1e-3)} "
         f"out_GB_per_s={out_bytes / (ms * 1e-3) / 1e9} "
         f"kernel_call_ms={host_ms} plain_call_ms={plain_host_ms} "
         f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
         f"library_ms=None (no single PyTorch call extracts k-mers) "
         f"(tolerance: exact, max_abs_err must be 0)")
    return {"name": "fused_extract_count", "route": "cuda",
            "source": fe.SOURCE, "replaces": fe.REPLACES,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def oracle_table(path: str, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer counts of an equal-length-read FASTA by sliding
    windows + np.unique: (sorted uint64 key values, counts)."""
    lut = np.full(256, 255, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    seqs = [ln for ln in lines if ln and not ln.startswith(b">")]
    codes = lut[np.frombuffer(b"".join(seqs), np.uint8)].reshape(
        len(seqs), -1).astype(np.int64)
    if codes.max() > 3:
        raise ValueError(f"{path}: oracle takes A/C/G/T reads only")
    win = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1)
    win = win.reshape(-1, k)
    pw = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    fwd = win @ pw
    rc = (3 - win[:, ::-1]) @ pw
    vals, counts = np.unique(np.minimum(fwd, rc), return_counts=True)
    return vals.astype(np.uint64), counts.astype(np.int64)


def table_values(table) -> np.ndarray:
    """KmerTable (M, W<=2) uint32 key words -> (M,) uint64 values."""
    v = table.keys[:, 0].astype(np.uint64)
    if table.keys.shape[1] == 2:
        v = (v << np.uint64(32)) | table.keys[:, 1].astype(np.uint64)
    return v


def exact_err(got, want) -> int:
    """The largest |got - want| over the lanes of one key layout (an
    int64 plane or a (hi, lo) pair of them), in exact integers; 0 when
    every lane is equal."""
    from kmer_tpu_torch.ops.encode import key_planes
    err = 0
    for g, w in zip(key_planes(got), key_planes(want)):
        g, w = g.reshape(-1).to(torch.int64), w.reshape(-1).to(torch.int64)
        if g.shape != w.shape:
            return 1 << 64
        bad = (g != w).nonzero().reshape(-1)[:1000]
        if bad.numel():
            err = max(err, max(abs(a - b) for a, b in zip(
                g[bad].tolist(), w[bad].tolist())))
    return err


def oracle_keys(path: str, positions, canonical: bool):
    """The keys of the bases at window offsets `positions` (contiguous
    k-mers: range(k)) of every window of an equal-length-read FASTA, by
    numpy shift-or over the selected columns, strand-min when canonical,
    counted by lexsort: (sorted unique (M, max(W, 2)) int64 rows in the
    port's word layout -- 31 bases a word, the rest in the last with its
    top bit flipped at 32 bases; a second column of 0 for keys of at most
    31 bases -- counts)."""
    from kmer_tpu_torch.ops.encode import word_bases
    lut = np.full(256, 255, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    with open(path, "rb") as f:
        seqs = [ln for ln in f.read().split(b"\n")
                if ln and not ln.startswith(b">")]
    codes = lut[np.frombuffer(b"".join(seqs), np.uint8)].reshape(
        len(seqs), -1)
    if codes.max() > 3:
        raise ValueError(f"{path}: oracle takes A/C/G/T reads only")
    P = codes.shape[1] - positions[-1]

    def pack(cols):
        words, q = [], 0
        for b in word_bases(len(cols)):
            w = np.zeros((len(seqs), P), np.uint64)
            for c in cols[q:q + b]:
                w = (w << np.uint64(2)) | c
            if b == 32:
                w ^= np.uint64(1 << 63)
            words.append(w.view(np.int64).reshape(-1))
            q += b
        if len(words) == 1:
            words.append(np.zeros_like(words[0]))
        return words

    c64 = codes.astype(np.uint64)
    keys = pack([c64[:, j:j + P] for j in positions])
    if canonical:
        rc = pack([np.uint64(3) - c64[:, j:j + P]
                   for j in reversed(positions)])
        take = np.zeros(len(keys[0]), bool)
        tied = np.ones(len(keys[0]), bool)
        for a, r in zip(keys, rc):
            take |= tied & (r < a)
            tied &= r == a
        keys = [np.where(take, r, a) for a, r in zip(keys, rc)]
    order = np.lexsort(keys[::-1])
    keys = [w[order] for w in keys]
    start = np.ones(len(keys[0]), bool)
    start[1:] = np.any([w[1:] != w[:-1] for w in keys], axis=0)
    idx = np.flatnonzero(start)
    counts = np.diff(np.append(idx, len(keys[0])))
    return np.stack([w[idx] for w in keys], 1), counts


def table_pairs(table) -> np.ndarray:
    """KmerTable -> its keys as (M, max(W, 2)) int64 rows of oracle_keys'
    layout."""
    from kmer_tpu_torch.ops.encode import (keys_u32_to_i64, u32_to_planes,
                                           word_bases)
    if table.k <= 31:
        return np.stack([keys_u32_to_i64(table.keys, table.k),
                         np.zeros(table.num_distinct, np.int64)], 1)
    return np.stack(u32_to_planes(table.keys, word_bases(table.k)), 1)


def phase_end_to_end(dev, seed: int, tmp: str, n_reads: int = N_READS,
                     genome_len: int = GENOME_LEN,
                     oracle_reads: int = ORACLE_READS) -> int:
    """count_fasta on `dev` at the main path's configuration; returns the
    kernel launches counted in the timed run."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.io.generator import genome_reads_fasta
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.utils import stagetime
    t0 = time.perf_counter()
    text = genome_reads_fasta(n_reads, READ_LEN, genome_len=genome_len,
                              seed=seed, error_rate=ERROR_RATE)
    path = os.path.join(tmp, "corpus.fasta")
    with open(path, "w") as f:
        f.write(text)
    lines = text.split("\n", 2 * oracle_reads)
    small = os.path.join(tmp, "oracle.fasta")
    with open(small, "w") as f:
        f.write("\n".join(lines[:2 * oracle_reads]) + "\n")
    del text, lines
    _say(f"corpus reads={n_reads} read_len={READ_LEN} "
         f"genome_len={genome_len} error_rate={ERROR_RATE} seed={seed} "
         f"bytes={os.path.getsize(path)} "
         f"make_s={time.perf_counter() - t0}")

    cfg = KmerConfig(k=K, canonical=True)
    # oracle check (also warms the pinned-memory pool and the allocator)
    want_v, want_c = oracle_table(small, K)
    got = count_fasta(small, cfg, device=dev)
    if not (np.array_equal(table_values(got), want_v)
            and np.array_equal(got.counts, want_c)):
        raise AssertionError("count_fasta != numpy oracle on the first "
                             f"{oracle_reads} reads")
    _say(f"oracle_check reads={oracle_reads} distinct={got.num_distinct} "
         f"total={got.total} equal=True")

    # the timed main-path run; a single ingest chunk holds every read
    if os.path.getsize(path) > cfg.ingest_chunk_bases:
        raise AssertionError("corpus spans several ingest chunks")
    want_batches = -(-n_reads // cfg.batch_reads)
    times: dict[str, float] = {}
    torch.cuda.synchronize()
    fe.launches = 0
    with stagetime.collect(times):
        table = count_fasta(path, cfg, device=dev)
    launches = fe.launches
    total_kmers = n_reads * (READ_LEN - K + 1)
    if table.total != total_kmers:
        raise AssertionError(f"table total {table.total} != "
                             f"sum(len - k + 1) = {total_kmers}")
    if launches != want_batches:
        raise AssertionError(f"K1 launches {launches} != batches "
                             f"{want_batches}")
    if not (np.all(np.diff(table_values(table)) > 0)
            and table.counts.min() > 0):
        raise AssertionError("table keys not sorted-unique / counts <= 0")
    wall = times["total"]
    _say(f"end_to_end reads={n_reads} kmers={total_kmers} "
         f"distinct={table.num_distinct} batches={want_batches} "
         f"k1_launches={launches} wall_s={wall} "
         f"reads_per_s={n_reads / wall} kmers_per_s={total_kmers / wall}")
    _say("stages_s " + json.dumps(times, sort_keys=True))
    return launches, table, path, small, wall


def gapped_batch(rng, B, L, *, packed, amb, short, full_len=GAP_LEN):
    """kernel_batch for K3: 1% ambiguous codes (a 54-base window must
    stay clean often enough to count), full rows of full_len bases."""
    from kmer_tpu_torch.io.fasta import pack_batch_codes
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.01] = 4
    if short:
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        limits = rng.integers(1, L + 1, B).astype(np.int32)
    else:
        lengths = np.full(B, min(full_len, L), np.int32)
        limits = np.full(B, L, np.int32)
    c = pack_batch_codes(codes).view(np.int32) if packed else codes
    return [torch.from_numpy(np.ascontiguousarray(c)),
            torch.from_numpy(lengths), torch.from_numpy(limits)]


def phase_gapped_kernel(dev, seed: int) -> dict:
    """K3 == plain version, lane for lane, on `dev`; returns K3's JSON
    record (without the main-path launch count)."""
    from kmer_tpu_torch.ops.kernels import fused_gapped as fg
    rng = np.random.default_rng(seed + 1)
    asym = dict(l_len=13, r_len=9, c_min=30, c_max=40)
    one_chunk = dict(l_len=31, r_len=31, c_min=12240, c_max=12288)
    cases = [  # (B, L, windows, packed, ambiguous, short, seg)
        (GAP_B, GAP_L, GAP, True, False, False, 2),
        (1024, 160, asym, True, False, True, 4),
        (512, GAP_L, GAP, False, True, True, 2),
        (512, GAP_L, GAP, True, False, True, 8),
        (512, 120, GAP, False, True, True, 16),      # c_max > L
        (300, 64, asym, False, True, True, 16),
        (64, 70, GAP, True, False, False, 2),        # L < c_min: no lanes
        # a ragged flat tail (B T_pad no multiple of a 512-lane piece)
        (5, 100, dict(l_len=5, r_len=4, c_min=10, c_max=90), True, False,
         True, 2),
        # rows much shorter than a piece: a piece spans hundreds of rows
        (700, 12, dict(l_len=3, r_len=2, c_min=11, c_max=14), False, True,
         True, 2),
        # 12,288-base rows: packed, u8 staged, u8 with ambiguity words
        (2, 12288, GAP, True, False, False, 2),
        (2, 12288, GAP, False, False, False, 4),
        (2, 12288, GAP, False, True, True, 16),
        # one chunk size near the end of wide rows: too many rows to stage
        (9, 12250, one_chunk, False, True, False, 4),
        # seg 16 through the out slots, u8 rows with ambiguity
        (GAP_B, GAP_L, GAP, False, True, False, 16),
    ]
    max_err = 0
    for B, L, win, packed, amb, short, seg in cases:
        host = gapped_batch(rng, B, L, packed=packed, amb=amb, short=short,
                            full_len=L if L > GAP_L else GAP_LEN)
        kw = dict(win, mask_ambiguous=amb, seg=seg,
                  packed_width=L if packed else 0)
        on_dev = [t.to(dev) for t in host]
        before = fg.launches
        got = fg.fused_gapped_count(*on_dev, **kw)
        want = fg.fused_gapped_count_ref(*on_dev, **kw)
        torch.cuda.synchronize()
        launched = fg.launches - before
        err = max((int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                   if g.numel() else 0) for g, w in zip(got, want))
        shapes_ok = all(g.shape == w.shape for g, w in zip(got, want))
        live = int((got[2] > 0).sum())
        no_lanes = L < win["c_min"]
        _say(f"gapped_kernel_check B={B} L={L} l={win['l_len']} "
             f"r={win['r_len']} c=[{win['c_min']},{win['c_max']}] "
             f"packed={packed} ambiguous={amb} short={short} seg={seg} "
             f"T_pad={got[0].shape[1]} live_lanes={live} launches="
             f"{launched} max_abs_err={err}")
        if (err != 0 or not shapes_ok
                or launched != (0 if no_lanes else 1)
                or (live == 0) != no_lanes):
            raise AssertionError(f"K3 != plain version (B={B}, L={L}, "
                                 f"max_abs_err={err}, live={live})")
        max_err = max(max_err, err)
    main = [t.to(dev) for t in gapped_batch(rng, GAP_B, GAP_L, packed=True,
                                            amb=False, short=False)]
    kw = dict(GAP, seg=SEG, packed_width=GAP_L)
    kernel = functools.partial(fg.fused_gapped_count, *main, **kw)
    plain = functools.partial(fg.fused_gapped_count_ref, *main, **kw)
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    host_ms, plain_host_ms = time_host_ms(kernel), time_host_ms(plain)
    T_pad = kernel()[0].shape[1]
    lanes = T_pad * GAP_B
    info = fg.launch_info(GAP_B, GAP_L, **GAP, seg=SEG)
    _say(f"launch kernel=K3 B={GAP_B} L={GAP_L} seg={SEG} "
         + " ".join(f"{key}={v}" for key, v in info.items())
         + f" threads_launched={info['threads'] * info['blocks']}")
    # packed codes, lengths and limits in, (hi, lo, count) out; ~8
    # integer operations a lane (two window cuts, validity, collapse)
    b = bound(main[0].numel() * 4 + GAP_B * 8 + lanes * 17, lanes * 8)
    _say(f"gapped_kernel_time B={GAP_B} L={GAP_L} T_pad={T_pad} "
         f"kernel_ms={ms} plain_ms={plain_ms} speedup={plain_ms / ms} "
         f"lanes_per_s={lanes / (ms * 1e-3)} "
         f"out_GB_per_s={lanes * 17 / (ms * 1e-3) / 1e9} "
         f"kernel_call_ms={host_ms} plain_call_ms={plain_host_ms} "
         f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
         f"library_ms=None (no single PyTorch call forms gapped chunks) "
         f"(tolerance: exact, max_abs_err must be 0)")
    return {"name": "fused_gapped_count", "route": "cuda",
            "source": fg.SOURCE, "replaces": fg.REPLACES,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def phase_parity(dev) -> None:
    """The sample.fasta md5 on `dev` by every parity mode."""
    import io
    from kmer_tpu_torch.ops.kernels import sort as sk
    from kmer_tpu_torch.pipeline.parity import (SAMPLE_FASTA_MD5,
                                                parity_dump,
                                                parity_dump_stream)
    path = os.path.join(REPO, "tests", "data", "sample.fasta")
    dumps = {}
    for mode in ("count_expand", "multiset", "bounded"):
        torch.cuda.synchronize()
        sk.launches = 0
        t0 = time.perf_counter()
        if mode == "bounded":
            buf = io.BytesIO()
            parity_dump_stream(path, buf, partitions=7, device=dev)
            dumps[mode] = buf.getvalue()
        else:
            os.environ["KMER_TPU_PARITY"] = mode
            try:
                dumps[mode] = parity_dump(path, device=dev)
            finally:
                del os.environ["KMER_TPU_PARITY"]
        wall = time.perf_counter() - t0
        md5 = hashlib.md5(dumps[mode]).hexdigest()
        _say(f"parity mode={mode} compact={mode == 'count_expand'} "
             f"lines={dumps[mode].count(10)} md5={md5} "
             f"k6_launches={sk.launches} wall_s={wall}")
        if md5 != SAMPLE_FASTA_MD5 or dumps[mode] != dumps["count_expand"]:
            raise AssertionError(f"parity {mode}: md5 {md5} != "
                                 f"{SAMPLE_FASTA_MD5}")
        if (sk.launches > 0) != (mode != "count_expand"):
            raise AssertionError(f"parity {mode}: K6 launched "
                                 f"{sk.launches} times")


def phase_gapped_end_to_end(dev, seed: int, tmp: str):
    """count_fasta(gapped) on `dev`; returns K3's launches in the timed
    run, the table, the corpus and the wall."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.io.fasta import parse_seqs
    from kmer_tpu_torch.io.generator import reference_style_fasta
    from kmer_tpu_torch.ops.kernels import fused_gapped as fg
    from kmer_tpu_torch.pipeline.table import fuse_words
    from kmer_tpu_torch.utils import stagetime
    t0 = time.perf_counter()
    text = reference_style_fasta(n_records=GAP_RECORDS, seed=seed)
    path = os.path.join(tmp, "gapped.fasta")
    with open(path, "w") as f:
        f.write(text)
    small = os.path.join(tmp, "gapped_small.fasta")
    with open(small, "w") as f:
        f.write(reference_style_fasta(n_records=GAP_ORACLE_RECORDS,
                                      seed=seed))
    lens = np.diff(parse_seqs(path)[1])
    c = np.arange(GAP["c_min"], GAP["c_max"] + 1)
    want_total = int(np.maximum(lens[:, None] - c[None, :] + 1, 0).sum())
    _say(f"gapped_corpus records={len(lens)} bases={int(lens.sum())} "
         f"chunks={want_total} bytes={os.path.getsize(path)} seed={seed} "
         f"make_s={time.perf_counter() - t0}")

    cfg = KmerConfig(gapped=True, batch_reads=GAP_B, max_read_len=512)
    # the card's table against the plain version's on the CPU (also warms
    # the pinned-memory pool)
    got = count_fasta(small, cfg, device=dev)
    if not (got == count_fasta(small, cfg, device="cpu") and got.total):
        raise AssertionError("gapped count_fasta on the card != on the CPU "
                             f"({GAP_ORACLE_RECORDS} records)")
    _say(f"gapped_cpu_check records={GAP_ORACLE_RECORDS} "
         f"distinct={got.num_distinct} total={got.total} equal=True")

    want_batches = -(-len(lens) // cfg.batch_reads)
    times: dict[str, float] = {}
    torch.cuda.synchronize()
    fg.launches = 0
    with stagetime.collect(times):
        table = count_fasta(path, cfg, device=dev)
    launches = fg.launches
    if table.total != want_total:
        raise AssertionError(f"gapped table total {table.total} != "
                             f"sum max(len - c + 1, 0) = {want_total}")
    if launches != want_batches:
        raise AssertionError(f"K3 launches {launches} != batches "
                             f"{want_batches}")
    f = fuse_words(table.keys, table.k)                # (M, 2) [hi, lo]
    ascending = (f[1:, 0] > f[:-1, 0]) | ((f[1:, 0] == f[:-1, 0])
                                          & (f[1:, 1] > f[:-1, 1]))
    if not (ascending.all() and table.counts.min() > 0):
        raise AssertionError("gapped keys not sorted-unique / counts <= 0")
    wall = times["total"]
    _say(f"gapped_end_to_end records={len(lens)} chunks={want_total} "
         f"distinct={table.num_distinct} batches={want_batches} "
         f"k3_launches={launches} wall_s={wall} "
         f"chunks_per_s={want_total / wall}")
    _say("gapped_stages_s " + json.dumps(times, sort_keys=True))

    # phase 10: the same run compacted on the device
    from kmer_tpu_torch.ops.kernels import compact as ck
    ctimes: dict[str, float] = {}
    torch.cuda.synchronize()
    fg.launches = ck.launches = 0
    with stagetime.collect(ctimes):
        ctable = count_fasta(path, cfg.replace(compact=True), device=dev)
    if not (ctable == table and fg.launches == ck.launches == want_batches):
        raise AssertionError("gapped compact table != the uncompacted one "
                             f"(K3 {fg.launches}, K4 {ck.launches} launches)")
    _say(f"gapped_compact_end_to_end equal=True k3_launches={fg.launches} "
         f"k4_launches={ck.launches} wall_s={ctimes['total']} "
         f"chunks_per_s={want_total / ctimes['total']}")
    _say("gapped_compact_stages_s " + json.dumps(ctimes, sort_keys=True))
    return launches, table, path, wall


def phase_sort_kernel(dev, seed: int) -> dict:
    """K6 == plain version on `dev`, bit for bit (payload order within
    equal keys included), at the shapes its callers give it and at edge
    cases; returns K6's JSON record (without the main-path launch
    count), timed at the k = 21 device merge as merge_batch calls it."""
    from kmer_tpu_torch.ops.encode import plane_bits
    from kmer_tpu_torch.ops.extract import parse_seed_mask
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.ops.kernels import fused_gapped as fg
    from kmer_tpu_torch.ops.kernels import sort as sk
    rng = np.random.default_rng(seed + 4)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sent = sk.SENTINEL
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, K,
                                            packed=True, amb=False,
                                            short=False)]

    def rand(n, hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)

    def merge_rows(state, batch, counts):
        # a device merge: a 2**24-row state, sorted unique and padded
        # with sentinel rows, and 2**23 lanes of step output, dead lanes
        # made sentinel rows
        reps = -(-(1 << 23) // counts.numel())
        bc = counts.reshape(-1).to(torch.int64).repeat(reps)[:1 << 23]
        rows = []
        for s_w, b_w in zip(state, batch):
            pad = torch.full(((1 << 24) - s_w.numel(),), sent, device=dev)
            b_w = b_w.reshape(-1).repeat(reps)[:1 << 23]
            rows.append(torch.cat([s_w, pad, torch.where(bc > 0, b_w, sent)]))
        live = state[0].numel()
        return rows + [torch.cat([rand(live, 50) + 1,
                                  torch.zeros((1 << 24) - live,
                                              dtype=torch.int64, device=dev),
                                  bc])]

    # k = 21: K1's keys and counts into a state of unique 42-bit keys
    keys, counts = fe.fused_extract_count(*main, K, canonical=True, seg=SEG,
                                          packed_width=MAIN_L)
    k21 = merge_rows([torch.unique(rand(1 << 24, 4 ** K))], [keys], counts)
    # k = 55: K1's (hi, lo) pairs into a state of sorted pairs
    wide = [t.to(dev) for t in gapped_batch(rng, MAIN_B, MAIN_L, packed=True,
                                            amb=False, short=False,
                                            full_len=READ_LEN)]
    (hi, lo), counts55 = fe.fused_extract_count(
        *wide, WIDE_K, canonical=True, seg=SEG, packed_width=MAIN_L)
    bits55 = plane_bits(WIDE_K)
    state55 = sk.sort_words_ref([rand(1 << 24, 1 << bits55[0]),
                                 rand(1 << 24, 1 << bits55[1])])
    k55 = merge_rows(state55, [hi, lo], counts55)
    # k = 63: lo carries its flipped top bit (negatives), and a real lo of
    # INT64_MAX (a key ending in 32 T's) beside sentinel rows
    (hi63, lo63), c63 = fe.fused_extract_count(
        *wide, 63, canonical=False, seg=SEG, packed_width=MAIN_L)
    live63 = c63.reshape(-1) > 0
    lo63 = torch.where(live63, lo63.reshape(-1), sent)
    lo63[::97] = sent
    k63 = [torch.where(live63, hi63.reshape(-1), sent), lo63,
           c63.reshape(-1).to(torch.int64)]
    # the span-55 mask under sort_group_keys=0: K7's (hi, lo) lanes
    mask_pos = parse_seed_mask(WIDE_MASK)
    mask = list(ek.extract_keys(*wide, len(mask_pos), canonical=True,
                                packed_width=MAIN_L, positions=mask_pos))
    mask = [w.reshape(-1) for w in mask]
    # the parity path: K3's live (hi, lo, counts) of one batch
    ghi, glo, gc = fg.fused_gapped_count(
        *(t.to(dev) for t in gapped_batch(rng, GAP_B, GAP_L, packed=True,
                                          amb=False, short=False)),
        **GAP, seg=SEG, packed_width=GAP_L)
    live = gc.reshape(-1) > 0
    parity = [ghi.reshape(-1)[live], glo.reshape(-1)[live],
              gc.reshape(-1)[live].to(torch.int64)]
    parity_bits = (2 * GAP["l_len"], 2 * GAP["r_len"], 31)

    def with_sentinels(words, share=0.2):
        dead = torch.rand(words[0].numel(), generator=gen, device=dev) < share
        return [torch.where(dead, sent, w) for w in words]

    def payload(n):
        return torch.randperm(n, generator=gen, device=dev)

    def near_duplicates(n):
        hi, lo = rand(n, 1 << 62), rand(n, 1 << 48)
        twin = torch.rand(n, generator=gen, device=dev) < 0.2
        hi[1:] = torch.where(twin[1:], hi[:-1], hi[1:])
        dup = torch.rand(n, generator=gen, device=dev) < 0.05
        hi, lo = torch.where(dup, hi[0], hi), torch.where(dup, lo[0], lo)
        return with_sentinels([hi, lo], 0.1) + [payload(n)], 2, (62, 48)

    def fix_fallback(n):
        hi, lo, count = rand(n, 1 << 54), rand(n, 1 << 54), rand(n, 1000) + 1
        hot = payload(n)[:6000]
        hi[hot], lo[hot] = 12345, 678
        return [hi, lo, count], 3, (54, 54, 31)

    # (words, num_keys, bits): None is every word at 64 bits
    cases = {
        "k21_merge": (k21, 1, (2 * K,)),                  # merge_batch
        "k21_merge_counts_keyed": (k21, 2, (2 * K, 32)),
        "devmerge": (k21, None, None),                    # the parent's work
        "k55_merge": (k55, 2, bits55),
        "k63_lo": (k63, 2, plane_bits(63)),
        "mask_sort_group_keys0": (mask, None, plane_bits(len(mask_pos))),
        "parity_bits": (parity, 3, parity_bits),
        "parity": (parity, None, None),
        "n1": ([rand(1, 100), rand(1, 100)], None, None),
        "tile": (with_sentinels([rand(sk.TILE_ROWS, 1 << 62)]), None, None),
        "tile_plus_1": (with_sentinels([rand(sk.TILE_ROWS + 1, 50)])
                        + [payload(sk.TILE_ROWS + 1)], 1, (6,)),
        "odd_passes": (with_sentinels([rand(1_000_003, 1 << 16)])
                       + [payload(1_000_003)], 1, (16,)),
        "odd_n": (with_sentinels([rand(1_000_003, 1 << 42),
                                  rand(1_000_003, 1 << 20),
                                  rand(1_000_003, 7)]), None, None),
        "all_sentinels": ([torch.full((100_000,), sent, device=dev),
                           payload(100_000)], 1, (42,)),
        "all_equal": ([torch.full((70_000,), 7, device=dev)] * 3, None,
                      None),
        "w4": (with_sentinels([rand(300_001, 4) for _ in range(4)]), None,
               None),
        "w4_keys2": (with_sentinels([rand(300_001, 4), rand(300_001, 4)])
                     + [payload(300_001), payload(300_001)], 2, (3, 64)),
    }
    # the MSD levels' hard cases: a bucket that stays large, one bucket
    # for every row, order already there or reversed, the sentinel
    # padding of a device-merge state, lineages down to the fifth key
    # word, the most planes
    n = 3_000_000
    repeated = rand(5_000_000, 1 << 42)
    repeated[:3_000_000] = 123_456_789
    repeated = repeated[payload(5_000_000)]
    ordered = torch.sort(rand(n, 1 << 42)).values
    state = torch.unique(rand(1 << 23, 1 << 42))
    half = torch.cat([state, torch.full(((1 << 24) - state.numel(),), sent,
                                        device=dev),
                      with_sentinels([rand(1 << 23, 1 << 42)], 0.5)[0]])
    b130 = (62, 62, 62, 62, 12)
    cases.update({
        "msd_key_repeated": ([repeated, payload(5_000_000)], 1, (42,)),
        "msd_one_top_bucket": ([rand(n, 1 << 20), payload(n)], 1, (42,)),
        "msd_presorted": ([ordered, payload(n)], 1, (42,)),
        "msd_reversed": ([ordered.flip(0).contiguous(), payload(n)], 1,
                         (42,)),
        "msd_devmerge_half_sentinel": ([half, payload(half.numel())], 1,
                                       (42,)),
        "msd_planes6_keys5": (with_sentinels(
            [rand(n, 8 if q < 3 else 1 << b) for q, b in enumerate(b130)])
            + [payload(n)], 5, b130),
        "msd_planes240": ([rand(50_000, 5), rand(50_000, 3),
                           rand(50_000, 1 << 16)]
                          + [payload(50_000) for _ in range(237)], 3,
                          (3, 2, 16)),
        # ties on the first key word: the local sort's run fix-up
        # (near-duplicate k = 55 pairs) and its fallback (6000 rows of one
        # (hi, lo) with varying counts, as parity rows)
        "msd_near_duplicates": near_duplicates(n),
        "msd_fix_fallback": fix_fallback(1_000_000),
    })
    max_err = 0
    for name, (words, num_keys, bits) in cases.items():
        before = sk.launches
        got = sk.sort_words([w.clone() for w in words], num_keys, bits)
        want = sk.sort_words_ref(words, num_keys, bits)
        torch.cuda.synchronize()
        err = max(exact_err(g, w) for g, w in zip(got, want))
        launched = sk.launches - before
        _say(f"sort_check case={name} W={len(words)} N={words[0].numel()} "
             f"num_keys={num_keys or len(words)} bits={bits} "
             f"launches={launched} max_abs_err={err}")
        if err != 0 or launched != 1 or not all(
                torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K6 != plain version ({name}: "
                                 f"max_abs_err={err})")
        max_err = max(max_err, err)
    del got, want

    def kernel_ms(words, num_keys, bits, reps, inner):
        # K6 sorts in place: every call gets its own unsorted copy
        copies = iter([[w.clone() for w in words]
                       for _ in range(5 + reps * inner)])
        return time_ms(lambda: sk.sort_words(next(copies), num_keys, bits),
                       reps=reps, inner=inner)

    rec = {"name": "sort_words", "route": "cuda", "source": sk.SOURCE,
           "replaces": sk.REPLACES, "max_abs_err": max_err, "cases": {}}
    for name, reps, inner in (("k21_merge", 5, 2), ("devmerge", 5, 2),
                              ("k21_merge_counts_keyed", 5, 2),
                              ("k55_merge", 5, 2), ("k63_lo", 10, 2),
                              ("mask_sort_group_keys0", 10, 2),
                              ("parity_bits", 10, 2)):
        words, num_keys, bits = cases[name]
        n, W = words[0].numel(), len(words)
        plain = functools.partial(sk.sort_words_ref, words, num_keys, bits)
        p1 = time_ms(plain, reps=reps, inner=inner)
        k1_ = kernel_ms(words, num_keys, bits, reps, inner)
        k2_ = kernel_ms(words, num_keys, bits, reps, inner)
        p2 = time_ms(plain, reps=reps, inner=inner)
        ms, plain_ms = min(k1_, k2_), min(p1, p2)
        library_ms = time_ms(functools.partial(torch.sort, words[0]),
                             reps=reps, inner=inner)
        # one read and one write of N rows of W words; N log2 N row
        # comparisons of num_keys words each
        b = bound(2 * n * W * 8,
                  n * math.ceil(math.log2(n)) * (num_keys or W))
        _say(f"sort_launch case={name} "
             + json.dumps(sk.launch_info(n, W, num_keys, bits)))
        _say(f"sort_time case={name} W={W} N={n} "
             f"num_keys={num_keys or W} bits={bits} kernel_ms={ms} "
             f"plain_ms={plain_ms} speedup={plain_ms / ms} "
             f"library_ms={library_ms} (torch.sort, one word) "
             f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
             f"GB_per_s={2 * n * W * 8 / (ms * 1e-3) / 1e9} "
             f"(tolerance: exact, max_abs_err must be 0)")
        if name == "k21_merge":
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)
        else:
            rec["cases"][name] = {"ms": ms, "plain_ms": plain_ms,
                                  "library_ms": library_ms,
                                  "bound_ms": b["bound_ms"]}
    # where K6's time goes at the k = 21 merge, beside torch.sort's
    words, num_keys, bits = cases["k21_merge"]
    _say("sort_profile case=k21_merge " + json.dumps(device_kernel_ms(
        lambda: (sk.sort_words([w.clone() for w in words], num_keys, bits),
                 torch.sort(words[0])))))
    return rec


class _merge_probe:
    """For a block: counts ops/devmerge.merge_batch's calls and records
    the state's bytes at each (8 (W + 1) bytes a row), after resetting
    the card's peak-memory counter.  KMER_TPU_DEVMERGE_MAX_MB bounds the
    state alone; line() puts the measured peak beside it."""

    def __enter__(self):
        from kmer_tpu_torch.ops import devmerge
        self.mod, self.orig, self.states = devmerge, devmerge.merge_batch, []

        def counted(state_words, state_counts, *rest, **kw):
            self.states.append(state_counts.numel() * 8
                               * (len(state_words) + 1))
            return self.orig(state_words, state_counts, *rest, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        devmerge.merge_batch = counted
        return self

    def __exit__(self, *exc):
        self.mod.merge_batch = self.orig

    def line(self) -> str:
        peak, state = torch.cuda.max_memory_allocated(), max(self.states)
        return (f"merges={len(self.states)} peak_device_GB={peak / 1e9} "
                f"state_GB={state / 1e9} peak_over_state={peak / state}")


def phase_devmerge(dev, path: str, cfg, want_table, host_wall: float,
                   label: str) -> tuple[int, float]:
    """The run of `cfg` with device_merge="on" against its host-merge
    table and wall from the same run of this script; returns K6's
    launches, one a merge, and the run's wall."""
    from kmer_tpu_torch import count_fasta
    from kmer_tpu_torch.ops.kernels import merge_reduce as mr
    from kmer_tpu_torch.ops.kernels import sort as sk
    from kmer_tpu_torch.utils import stagetime
    times: dict[str, float] = {}
    with _merge_probe() as probe:
        sk.launches = mr.launches = 0
        with stagetime.collect(times):
            table = count_fasta(path, cfg.replace(device_merge="on"),
                                device=dev)
    launches = sk.launches
    if not (table == want_table
            and launches == mr.launches == len(probe.states) > 0):
        raise AssertionError(f"{label} device-merge table != the host-merge "
                             f"table, or K6 launches {launches} or "
                             f"merge_reduce launches {mr.launches} != "
                             f"merges {len(probe.states)}")
    wall = times["total"]
    _say(f"{label}_devmerge equal_to_host_merge=True k6_launches={launches} "
         f"merge_reduce_launches={mr.launches} "
         f"distinct={table.num_distinct} wall_s={wall} "
         f"host_merge_wall_s={host_wall} {probe.line()}")
    _say(f"{label}_devmerge_stages_s " + json.dumps(times, sort_keys=True))
    return launches, wall


def profile_devmerge(dev, path: str, cfg) -> None:
    """The k=21 device-merge run once more under torch.profiler: device
    time by kernel and the device's busy share of the wall (kernel time
    summed over the run's kernels, which share one stream)."""
    from kmer_tpu_torch import count_fasta
    t0 = time.perf_counter()
    by_kernel = device_kernel_ms(
        lambda: count_fasta(path, cfg.replace(device_merge="on"), device=dev))
    wall = time.perf_counter() - t0
    rows = sorted(((ms, key, n) for key, (ms, n) in by_kernel.items()
                   if ms > 0), reverse=True)
    if not rows:
        _say("k21_devmerge_profile device time not measured (the profiler "
             "saw no device events)")
        return
    busy = sum(ms for ms, _, _ in rows) / 1e3
    _say(f"k21_devmerge_profile wall_s={wall} device_busy_s={busy} "
         f"device_busy_share={busy / wall} (wall under the profiler)")
    _say("k21_devmerge_profile_top " + json.dumps(
        [{"kernel": key, "ms": ms, "calls": n} for ms, key, n in rows[:8]]))


def device_kernel_ms(fn) -> dict:
    """{kernel name: [device ms, calls]} of one run of fn under
    torch.profiler: the device's own events only (a host op's row would
    repeat the time of the kernels it launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: [getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) / 1e3,
                         e.count]
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def time_pair(kernel, plain) -> tuple[float, float]:
    """Device ms of the kernel and of its plain version, in turns
    (plain, kernel, kernel, plain); the smaller reading of each."""
    p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                      time_ms(plain))
    return min(k1, k2), min(p1, p2)


def phase_merge_reduce_kernel(dev, seed: int) -> dict:
    """Phase 30: the device merge's run totals and compaction
    (csrc/merge_reduce.cu) against its plain twin at three merge shapes;
    returns the kernel's JSON record (without the main-path launch
    count)."""
    from kmer_tpu_torch.ops.kernels import merge_reduce as mr
    from kmer_tpu_torch.ops.kernels import sort as sk
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    sent = sk.SENTINEL

    def rand(n, bits):
        return torch.randint(0, 1 << bits, (n,), generator=gen, device=dev)

    def merge_rows(C, bits, live):
        # a sorted unique state of about `live` keys padded with sentinel
        # rows to C, and C / 2 lanes: half keys of the state, the rest
        # new, a tenth dead (sentinel, count 0); concatenated and sorted
        # by K6 as merge_batch sorts them
        W, N = len(bits), C // 2
        state = sk.sort_words([rand(live, b) for b in bits])
        keep = torch.ones(live, dtype=torch.bool, device=dev)
        keep[1:] = torch.stack([w[1:] != w[:-1] for w in state]).any(0)
        state = [w[keep] for w in state]
        d0 = state[0].numel()
        pick = torch.randint(0, d0, (N,), generator=gen, device=dev)
        old = torch.rand(N, generator=gen, device=dev) < 0.5
        dead = torch.rand(N, generator=gen, device=dev) < 0.1
        batch = [torch.where(dead, sent, torch.where(old, w[pick], rand(N, b)))
                 for w, b in zip(state, bits)]
        pad = torch.full((C - d0,), sent, dtype=torch.int64, device=dev)
        counts = torch.cat([
            torch.randint(1, 50, (d0,), generator=gen, device=dev),
            torch.zeros(C - d0, dtype=torch.int64, device=dev),
            torch.where(dead, 0, torch.randint(1, 4, (N,), generator=gen,
                                               device=dev))])
        *words, counts = sk.sort_words(
            [torch.cat([w, pad, b]) for w, b in zip(state, batch)] + [counts],
            num_keys=W, bits=list(bits))
        return words, counts

    rec = {"name": "merge_reduce", "route": "cuda", "source": mr.SOURCE,
           "replaces": mr.REPLACES, "max_abs_err": 0, "library_ms": None,
           "cases": {}}
    for name, C, bits, live in (("k21_merge", 1 << 24, (42,), 10_000_000),
                                ("k55_merge", 1 << 24, (62, 48), 10_000_000),
                                ("w5_merge", 1 << 22, (62,) * 5, 2_500_000)):
        words, counts = merge_rows(C, bits, live)
        W, R = len(bits), counts.numel()
        before = mr.launches
        got = mr.merge_reduce(words, counts, C)
        torch.cuda.synchronize()
        want = mr.merge_reduce_ref(words, counts, C)
        same = (all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
                and torch.equal(got[1], want[1])
                and int(got[2]) == int(want[2]))
        if not same:
            raise AssertionError(f"merge_reduce != its plain twin ({name})")
        launched = mr.launches - before
        kernel = functools.partial(mr.merge_reduce, words, counts, C)
        plain = functools.partial(mr.merge_reduce_ref, words, counts, C)
        # in turns (plain, kernel, kernel, plain); the twin takes ~0.1 s a
        # call, so fewer samples of it
        p1 = time_ms(plain, reps=5, inner=2)
        ms = min(time_ms(kernel), time_ms(kernel))
        plain_ms = min(p1, time_ms(plain, reps=5, inner=2))
        # each row's words and count read once, the C-row state written
        # once; a compare a word and a scan step a row
        b = bound(8 * (W + 1) * (R + C), (W + 2) * R)
        line = {"merge_reduce": name, "W": W, "C": C, "R": R,
                "distinct": int(want[2]), "equal_to_plain": True,
                "ms": ms, "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "over_bound": ms / b["bound_ms"],
                "plain_ms": plain_ms, "launches": launched}
        _say(json.dumps(line))
        case = {k: line[k] for k in ("W", "C", "R", "ms", "bound_ms",
                                     "plain_ms")}
        if name == "k21_merge":
            rec.update(ms=ms, plain_ms=plain_ms, **b)
        rec["cases"][name] = case
        del words, counts, got, want
    return rec


def phase_compact_kernel(dev, seed: int) -> dict:
    """K4 == plain version on `dev`, records in lane order and the total;
    returns K4's JSON record (without the main-path launch count)."""
    from kmer_tpu_torch.ops.kernels import compact as ck
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.ops.kernels import fused_gapped as fg
    rng = np.random.default_rng(seed + 2)

    def k1_out(B, L, k, short=False, lengths=None):
        host = kernel_batch(rng, B, L, k, packed=True, amb=False,
                            short=short)
        if lengths is not None:
            host[1].fill_(lengths)
        return fe.fused_extract_count(*(t.to(dev) for t in host), k,
                                      canonical=True, seg=SEG,
                                      packed_width=L)

    def k3_out(B, L, win, short=False):
        host = gapped_batch(rng, B, L, packed=True, amb=False, short=short)
        return fg.fused_gapped_count(*(t.to(dev) for t in host), **win,
                                     seg=SEG, packed_width=L)

    def unfused_out():
        # K7 -> the grouped torch.sort -> K2a at the main shape: flat
        # keys and int32 counts
        from kmer_tpu_torch.ops import count as count_ops
        from kmer_tpu_torch.ops.kernels import extract as ek
        host = kernel_batch(rng, MAIN_B, MAIN_L, K, packed=True, amb=False,
                            short=False)
        keys = ek.extract_keys(*(t.to(dev) for t in host), K,
                               canonical=True, packed_width=MAIN_L)
        (flat,), counts = count_ops.grouped_count([keys], 256,
                                                  backend="hybrid")
        return flat, counts

    small = dict(l_len=5, r_len=5, c_min=12, c_max=20)
    cases = {  # name -> (planes, counts, kwargs, expect a launch)
        "k1_main": (*k1_out(MAIN_B, MAIN_L, K), {}),
        "unfused_int32": (*unfused_out(), {}),
        "k3_parity": (*k3_out(GAP_B, GAP_L, GAP), dict(r_len=27,
                                                        n_bases=54)),
        "k1_short_k5": (*k1_out(4096, 150, 5, short=True), {}),
        "k1_ragged_k31": (*k1_out(999, 77, 31, short=True), {}),
        "k1_no_live_lane": (*k1_out(512, 160, K, lengths=0), {}),
        "k3_one_word": (*k3_out(512, 64, small, short=True),
                        dict(r_len=5, n_bases=10)),
        "k3_no_lanes": (*k3_out(64, 70, GAP), dict(r_len=27, n_bases=54)),
    }
    cases["all_live"] = (torch.arange(70_000, dtype=torch.int64,
                                      device=dev),
                         torch.ones(70_000, dtype=torch.int8, device=dev),
                         {})
    # K1's (hi, lo) pairs: k = 55 (two uint64 halves) and k = 63 (r_len =
    # 32: lo's flip taken off)
    for k in (WIDE_K, 63):
        keys, counts = k1_out(MAIN_B, MAIN_L, k)
        cases[f"k1_pair_k{k}"] = (*keys, counts, dict(r_len=k - 31,
                                                      n_bases=k))
    # what only the look-back can get wrong: one lane, a tile and a lane
    # either side of it, every lane live over many tiles, one live lane in
    # the last tile, live lanes in every other tile, an int32 stream whose
    # tail is no multiple of 4
    T = ck.TILE

    def lanes(n, share, dtype=np.int8):
        c = (rng.random(n) < share) * rng.integers(1, 100, n)
        return (torch.from_numpy(rng.integers(0, 1 << 62, n)).to(dev),
                torch.from_numpy(c.astype(dtype)).to(dev), {})

    cases["one_lane"] = lanes(1, 1.0)
    for name, n in (("tile_minus_1", T - 1), ("tile", T),
                    ("tile_plus_1", T + 1)):
        cases[name] = lanes(n, 0.5)
    cases["all_live_40_tiles"] = lanes(40 * T, 1.0)
    keys, counts, _ = lanes(10 * T + 37, 0.0)
    counts[-5] = 3
    cases["one_live_in_last_tile"] = (keys, counts, {})
    keys, counts, _ = lanes(21 * T, 0.7)
    counts.view(21, T)[1::2] = 0
    cases["every_other_tile"] = (keys, counts, {})
    cases["int32_tail"] = lanes(12345, 0.6, np.int32)
    expect = {"k1_no_live_lane": 0, "k3_no_lanes": 0, "all_live": 70_000,
              "one_lane": 1, "all_live_40_tiles": 40 * T,
              "one_live_in_last_tile": 1}

    def k4_err(got, want):
        t = int(want[2][0])
        err = abs(int(got[2][0]) - t)
        if t:
            err = max(err, int((got[0][:t] - want[0][:t]).abs().max()),
                      int((got[1][:t] - want[1][:t]).abs().max()))
        return err, t

    max_err = 0
    for name, case in cases.items():
        *planes, counts, kw = case
        before = ck.launches
        got = ck.compact(planes, counts, **kw)
        want = ck.compact_ref(planes, counts, **kw)
        torch.cuda.synchronize()
        err, t = k4_err(got, want)
        launched = ck.launches - before
        max_err = max(max_err, err)
        _say(f"compact_check case={name} lanes={counts.numel()} total={t} "
             f"launches={launched} max_abs_err={err}")
        expect_total = expect.get(name)
        if (err != 0 or launched != int(counts.numel() > 0)
                or (expect_total is not None and t != expect_total)
                or (expect_total is None and t == 0)):
            raise AssertionError(f"K4 != plain version ({name}: "
                                 f"max_abs_err={err}, total={t})")
    # back to back on different inputs with no sync between: a status word
    # or tile counter left over from the call before would show
    seq = ["k1_main", "tile_plus_1", "all_live_40_tiles", "one_lane",
           "unfused_int32", "k3_parity", "one_live_in_last_tile",
           "k1_pair_k63"] * 2
    outs = []
    for name in seq:
        *planes, counts, kw = cases[name]
        outs.append(ck.compact(planes, counts, **kw))
    torch.cuda.synchronize()
    for name, got in zip(seq, outs):
        *planes, counts, kw = cases[name]
        err, _ = k4_err(got, ck.compact_ref(planes, counts, **kw))
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"K4 back to back != plain version ({name})")
    _say(f"compact_check case=back_to_back calls={len(seq)} "
         f"max_abs_err={max_err}")
    rec = {"name": "compact", "route": "cuda", "source": ck.SOURCE,
           "replaces": ck.REPLACES, "max_abs_err": max_err}
    # bytes a lane in (its count and key planes) and a live lane's record
    # out; two operations a lane (test, prefix)
    for name, lane_bytes, record_bytes in (("k1_main", 9, 16),
                                           ("k3_parity", 17, 24),
                                           ("unfused_int32", 12, 16)):
        *planes, counts, kw = cases[name]
        ms, plain_ms = time_pair(
            functools.partial(ck.compact, planes, counts, **kw),
            functools.partial(ck.compact_ref, planes, counts, **kw))
        n = counts.numel()
        live = int((counts > 0).sum())
        b = bound(n * lane_bytes + live * record_bytes + 8, n * 2)
        # the library yardstick: torch.masked_select of the one key plane
        # (of two, for a pair) by counts > 0, CUB's select underneath; its
        # device kernels' time a call (it syncs the host for its size)
        yard = device_kernel_ms(lambda: [torch.masked_select(
            planes[0], counts > 0) for _ in range(10)])
        yard_ms = sum(v[0] for v in yard.values()) / 10
        _say(f"compact_time case={name} lanes={n} live={live} "
             f"kernel_ms={ms} plain_ms={plain_ms} yardstick_ms={yard_ms} "
             f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
             f"speedup={plain_ms / ms} "
             f"in_GB_per_s={n * lane_bytes / (ms * 1e-3) / 1e9} "
             f"(yardstick: masked_select(keys, counts > 0) of one key "
             f"plane, device kernels only; library_ms=None: no single "
             f"PyTorch call packs key and count records; tolerance: exact, "
             f"max_abs_err must be 0)")
        if name == "k1_main":
            rec.update(ms=ms, plain_ms=plain_ms, yardstick_ms=yard_ms, **b,
                       library_ms=None)
        else:
            key = {"k3_parity": "gapped", "unfused_int32": "int32"}[name]
            rec[key] = {"ms": ms, "plain_ms": plain_ms,
                        "yardstick_ms": yard_ms,
                        "bound_ms": b["bound_ms"]}
    return rec


def phase_histogram_kernel(dev, seed: int) -> dict:
    """K5 == plain version on `dev`, bit for bit, in both modes, timed at
    each caller's shape (with its grid, shared bytes and registers), and
    at edge cases; returns K5's JSON record (without the main-path launch
    counts)."""
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.ops.kernels import histogram as hk
    rng = np.random.default_rng(seed + 3)
    n = (MAIN_L - K + 1) * MAIN_B            # one k=21 batch of lanes
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w = torch.from_numpy(rng.integers(0, 3, n).astype(np.int8)).to(dev)

    def k1_out(B, k):
        host = kernel_batch(rng, B, MAIN_L, k, packed=True, amb=False,
                            short=False)
        return fe.fused_extract_count(*(t.to(dev) for t in host), k,
                                      canonical=True, seg=SEG,
                                      packed_width=MAIN_L)

    # name -> (keys, weights, bits, k for HLL classes or 0, b)
    cases = {}
    for bits in (8, 15, 16):
        idx = torch.from_numpy(rng.integers(0, 1 << bits, n)).to(dev)
        cases[f"index_b{bits}"] = (idx, w, bits, 0, 0)
    keys, counts = k1_out(MAIN_B, K)
    cases["hll_k21_b10"] = (keys, counts, 15, K, 10)
    cases["hll_k21_b11"] = (keys, counts, 16, K, 11)
    # one batch of `card` (batch_reads=2048), the shape it launches 489
    # times a run
    keys, counts = k1_out(2048, K)
    cases["card_k21_b10"] = (keys, counts, 15, K, 10)
    keys, counts = k1_out(MAIN_B, WIDE_K)
    cases["pair_k55_b10"] = (keys, counts, 15, WIDE_K, 10)

    def call(fn_index, fn_hll, keys, wt, bits, k, b, out=None):
        if k:
            return fn_hll(keys, wt, k=k, b=b, out=out)
        return fn_index(keys, wt, bits, out=out)

    kernel = functools.partial(call, hk.index_histogram,
                               hk.hll_class_histogram)
    plain = functools.partial(call, hk.index_histogram_ref,
                              hk.hll_class_histogram_ref)
    rec = {"name": "index_histogram", "route": "cuda", "source": hk.SOURCE,
           "replaces": hk.REPLACES, "max_abs_err": 0, "cases": {}}
    for name, (keys, wt, bits, k, b) in cases.items():
        before = hk.launches
        got = kernel(keys, wt, bits, k, b)
        want = plain(keys, wt, bits, k, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if (err != 0 or hk.launches != before + 1
                or int(got.sum()) != int(wt.sum())):
            raise AssertionError(f"K5 != plain version ({name})")
        ms, plain_ms = time_pair(
            functools.partial(kernel, keys, wt, bits, k, b),
            functools.partial(plain, keys, wt, bits, k, b))
        library_ms = None
        if not k:
            # the yardstick: torch.bincount with the weights (as floats:
            # it takes no integer weights)
            library_ms = time_ms(functools.partial(
                torch.bincount, keys, weights=wt.to(torch.float32),
                minlength=1 << bits))
        # lanes (keys and weights) in, 2**bits int64 bins out; one add a
        # lane, and for an HLL class the hash of each live lane's key
        # words (9 operations a 32-bit word: the combine's xor, multiply
        # and add, the finaliser's two multiplies and three shift-xors
        # counted as one each), 6 for bucket and rho, 4 to assemble a
        # (hi, lo) pair's words
        planes = keys if isinstance(keys, tuple) else (keys,)
        lanes, live = wt.numel(), int((wt != 0).sum())
        words = (2 * k + 1 + 31) // 32 if k else 0
        ops = lanes + live * (9 * words + (6 if k else 0)
                              + (4 if k > 31 else 0))
        bd = bound(lanes * (1 + 8 * len(planes)) + (8 << bits), ops)
        grid = hk.plan(lanes, bits, sms)
        regs, spill = hk.attributes(2 if k > 31 else int(k > 0))
        case = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    lanes=lanes, grid=f"{grid.clusters}x{grid.cluster}",
                    smem_bytes=grid.smem, regs=regs, spill_bytes=spill, **bd)
        rec["cases"][name] = case
        _say(f"histogram_check case={name} lanes={lanes} bits={bits} "
             f"sum={int(got.sum())} max_abs_err={err} kernel_ms={ms} "
             f"plain_ms={plain_ms} library_ms={library_ms} "
             f"speedup={plain_ms / ms} bound_ms={bd['bound_ms']} "
             f"bound_by={bd['bound_by']} grid={case['grid']} "
             f"(clusters x blocks) smem_bytes={grid.smem} regs={regs} "
             f"spill_bytes={spill} (tolerance: exact)")
    main = rec["cases"]["index_b16"]
    rec.update({key: main[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
    for label, name in (("hll", "hll_k21_b10"), ("card", "card_k21_b10"),
                        ("hll_pair", "pair_k55_b10")):
        case = rec["cases"][name]
        rec.update({f"{label}_ms": case["ms"],
                    f"{label}_plain_ms": case["plain_ms"],
                    f"{label}_bound_ms": case["bound_ms"]})

    # edge cases, untimed: a hot bin that passes 2**31 across clusters,
    # views whose alignment differs from the allocation's (and keys not
    # aligned with their weights), an empty stream
    hot = 17_000_000
    idx = torch.zeros(hot, dtype=torch.int64, device=dev)
    wt = torch.full((hot,), 127, dtype=torch.int8, device=dev)
    got = hk.index_histogram(idx, wt, 16)
    want = hk.index_histogram_ref(idx, wt, 16)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and int(got[0]) == 127 * hot):
        raise AssertionError("K5 on a hot bin past 2**31 != plain version")
    _say(f"histogram_check case=hot_bin lanes={hot} bin0={int(got[0])} "
         f"grid={hk.plan(hot, 16, sms).clusters}x"
         f"{hk.plan(hot, 16, sms).cluster} equal=True")
    del idx, wt
    idx, _, _, _, _ = cases["index_b16"]
    k21, c21 = cases["hll_k21_b10"][:2]
    kp, cp = cases["pair_k55_b10"][:2]
    for ks, ws in ((slice(1, None), slice(1, None)),
                   (slice(3, -5), slice(3, -5)),
                   (slice(1, None), slice(0, -1))):
        for name, keys, wt, bits, k in (
                ("index_b16", idx[ks], w[ws], 16, 0),
                ("hll_k21_b10", k21.reshape(-1)[ks], c21.reshape(-1)[ws], 15,
                 K),
                ("pair_k55_b10", tuple(p.reshape(-1)[ks] for p in kp),
                 cp.reshape(-1)[ws], 15, WIDE_K)):
            got = kernel(keys, wt, bits, k, 10)
            want = plain(keys, wt, bits, k, 10)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K5 != plain version on the view "
                                     f"keys[{ks}], weights[{ws}] ({name})")
    _say("histogram_check case=unaligned_views views=3 cases=3 equal=True")
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    before = hk.launches
    got = hk.index_histogram(empty, empty.to(torch.int8), 8)
    if hk.launches != before or int(got.abs().sum()) != 0:
        raise AssertionError("K5 on an empty stream launched or was not 0")
    _say("histogram_check empty launches=0 zeros=True")
    return rec


def phase_compact_end_to_end(dev, path: str, want_table) -> int:
    """Phase 4's run with compact=True; returns K4's launches."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.ops.kernels import compact as ck
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.utils import stagetime
    cfg = KmerConfig(k=K, canonical=True, compact=True)
    want_batches = -(-N_READS // cfg.batch_reads)
    times: dict[str, float] = {}
    torch.cuda.synchronize()
    fe.launches = ck.launches = 0
    with stagetime.collect(times):
        table = count_fasta(path, cfg, device=dev)
    launches = ck.launches
    if not (table == want_table
            and fe.launches == launches == want_batches):
        raise AssertionError("compact k=21 table != the sort table, or "
                             f"K1 {fe.launches} / K4 {launches} launches != "
                             f"{want_batches} batches")
    wall = times["total"]
    total_kmers = N_READS * (READ_LEN - K + 1)
    _say(f"compact_end_to_end reads={N_READS} distinct={table.num_distinct} "
         f"equal_to_sort=True k1_launches={fe.launches} "
         f"k4_launches={launches} wall_s={wall} "
         f"reads_per_s={N_READS / wall} kmers_per_s={total_kmers / wall}")
    _say("compact_stages_s " + json.dumps(times, sort_keys=True))
    return launches


def phase_dense(dev, path: str):
    """Dense k=8 (K5) and k=12 (host hybrid) against sort mode at the
    same k; returns K5's launches in the k=8 run and its table."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.ops.kernels import histogram as hk
    from kmer_tpu_torch.utils import stagetime
    launches = 0
    for k in (8, 12):
        sort_table = count_fasta(path, KmerConfig(k=k, canonical=True),
                                 device=dev)
        cfg = KmerConfig(k=k, canonical=True, mode="dense")
        want_batches = -(-N_READS // cfg.batch_reads)
        times: dict[str, float] = {}
        torch.cuda.synchronize()
        hk.launches = 0
        with stagetime.collect(times):
            table = count_fasta(path, cfg, device=dev)
        want_total = N_READS * (READ_LEN - k + 1)
        want_launches = want_batches if k == 8 else 0
        if not (table == sort_table and table.total == want_total
                and hk.launches == want_launches):
            raise AssertionError(f"dense k={k} != sort table, total "
                                 f"{table.total} != {want_total}, or K5 "
                                 f"launches {hk.launches}")
        if k == 8:
            launches, dense8 = hk.launches, table
        _say(f"dense k={k} path={'K5' if k == 8 else 'hybrid'} "
             f"distinct={table.num_distinct} total={table.total} "
             f"equal_to_sort=True k5_launches={hk.launches} "
             f"wall_s={times['total']} "
             f"kmers_per_s={want_total / times['total']}")
        _say(f"dense_k{k}_stages_s " + json.dumps(times, sort_keys=True))
    # k = 12 again on the device: index_add_ into a 4**12 int64 table
    stimes: dict[str, float] = {}
    os.environ["KMER_TPU_DENSE_SCATTER"] = "1"
    try:
        with stagetime.collect(stimes):
            scatter = count_fasta(path, cfg, device=dev)
    finally:
        del os.environ["KMER_TPU_DENSE_SCATTER"]
    if scatter != table:
        raise AssertionError("dense k=12 scatter table != the hybrid's")
    _say(f"dense k=12 path=scatter distinct={scatter.num_distinct} "
         f"equal_to_hybrid=True wall_s={stimes['total']} "
         f"kmers_per_s={want_total / stimes['total']}")
    _say("dense_k12_scatter_stages_s " + json.dumps(stimes, sort_keys=True))
    return launches, dense8


def phase_card(dev, path: str, small: str, exact_distinct: int) -> int:
    """`card -k 21 --canonical` through the CLI's estimator; returns K5's
    launches in the run."""
    from kmer_tpu_torch import KmerConfig
    from kmer_tpu_torch.ops.kernels import histogram as hk
    from kmer_tpu_torch.pipeline.sketch import (estimate_distinct_multi_k,
                                                sketch_histograms)
    cfg = KmerConfig(k=K, canonical=True, batch_reads=2048)
    got, _ = sketch_histograms(small, [K], cfg, device=dev)
    want, _ = sketch_histograms(small, [K], cfg, device="cpu")
    if not np.array_equal(got[K], want[K]):
        raise AssertionError("card class histogram on the card != the "
                             f"plain version's ({ORACLE_READS} reads)")
    _say(f"card_check reads={ORACLE_READS} histogram_equal=True "
         f"sum={int(got[K].sum())}")
    torch.cuda.synchronize()
    hk.launches = 0
    t0 = time.perf_counter()
    [(est, total)] = estimate_distinct_multi_k(path, [K], cfg, device=dev)
    wall = time.perf_counter() - t0
    rel = est / exact_distinct - 1
    want_batches = -(-N_READS // cfg.batch_reads)
    _say(f"card k={K} canonical=True b=10 estimate={est} "
         f"exact_distinct={exact_distinct} rel_err={rel} total={total} "
         f"k5_launches={hk.launches} wall_s={wall} "
         f"kmers_per_s={total / wall}")
    if (abs(rel) > 0.15 or total != N_READS * (READ_LEN - K + 1)
            or hk.launches != want_batches):
        raise AssertionError(f"card estimate {est} not within 15% of "
                             f"{exact_distinct}, or total/launches wrong")
    return hk.launches


def phase_extract_kernel(dev, seed: int) -> dict:
    """K7 == plain version, lane for lane, on `dev`; returns K7's JSON
    record (without the main-path launch count)."""
    from kmer_tpu_torch.ops.encode import SENTINEL_KEY, key_planes
    from kmer_tpu_torch.ops.kernels import extract as ek
    rng = np.random.default_rng(seed + 5)
    cases = [  # (B, L, k, canonical, packed, ambiguous, short)
        (MAIN_B, MAIN_L, K, True, True, False, False),
        (4096, 150, 1, False, False, True, True),
        (4096, 150, 16, False, False, True, True),
        (4096, 150, 17, False, False, True, True),
        (4096, 150, 31, False, False, True, True),
        (999, 77, 31, True, True, False, True),
        (4096, 150, 32, True, False, True, True),
        (4096, 150, 63, True, False, True, True),
    ]
    max_err = 0
    for B, L, k, canon, packed, amb, short in cases:
        host = kernel_batch(rng, B, L, k, packed=packed, amb=amb,
                            short=short, amb_share=0.01 if k > 31 else None)
        kw = dict(canonical=canon, mask_ambiguous=amb,
                  packed_width=L if packed else 0)
        on_dev = [t.to(dev) for t in host]
        before = ek.launches
        keys = ek.extract_keys(*on_dev, k, **kw)
        want = ek.extract_keys_ref(*on_dev, k, **kw)
        torch.cuda.synchronize()
        err = exact_err(keys, want)
        live = int((key_planes(keys)[0] != SENTINEL_KEY).sum())
        launched = ek.launches - before
        _say(f"extract_check B={B} L={L} k={k} canonical={canon} "
             f"packed={packed} ambiguous={amb} short={short} "
             f"live_lanes={live} launches={launched} max_abs_err={err}")
        if err != 0 or live == 0 or launched != 1:
            raise AssertionError(f"K7 != plain version (k={k}, "
                                 f"max_abs_err={err}, live={live})")
        max_err = max(max_err, err)
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, K,
                                            packed=True, amb=False,
                                            short=False)]
    kw = dict(canonical=True, packed_width=MAIN_L)
    ms, plain_ms = time_pair(
        functools.partial(ek.extract_keys, *main, K, **kw),
        functools.partial(ek.extract_keys_ref, *main, K, **kw))
    lanes = (MAIN_L - K + 1) * MAIN_B
    # packed codes, lengths and limits in, one int64 key a lane out; ~8
    # integer operations a lane (the key and its reverse complement, min,
    # validity)
    b = bound(main[0].numel() * 4 + MAIN_B * 8 + lanes * 8, lanes * 8)
    launch_line("extract_keys", ek, MAIN_B, MAIN_L, K, canonical=True)
    _say(f"extract_time B={MAIN_B} L={MAIN_L} k={K} kernel_ms={ms} "
         f"plain_ms={plain_ms} speedup={plain_ms / ms} "
         f"out_GB_per_s={lanes * 8 / (ms * 1e-3) / 1e9} "
         f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
         f"library_ms=None (no single PyTorch call extracts k-mers) "
         f"(tolerance: exact, max_abs_err must be 0)")
    return {"name": "extract_keys", "route": "cuda", "source": ek.SOURCE,
            "replaces": ek.REPLACES, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, **b, "library_ms": None}


def phase_grouped_kernels(dev, seed: int) -> tuple[dict, dict, dict]:
    """K2a, K2b and K2c == their plain versions on `dev`, bit for bit;
    returns their JSON records (without the main-path launch counts)."""
    from kmer_tpu_torch.ops.encode import SENTINEL_KEY
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import grouped_count as gk
    rng = np.random.default_rng(seed + 6)
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, K,
                                            packed=True, amb=False,
                                            short=False)]
    route = ek.extract_keys(*main, K, canonical=True,
                            packed_width=MAIN_L).reshape(-1)
    n = route.numel()                          # 1,146,880 keys
    m_t = 16

    def rows(shape, W, hi=8, dead=0.2):
        planes = [torch.randint(0, hi, shape, generator=gen, device=dev)
                  for _ in range(W)]
        gone = torch.rand(shape, generator=gen, device=dev) < dead
        return [torch.where(gone, SENTINEL_KEY, p) for p in planes]

    big = gk.max_group_rows(1)
    unaligned = [p.reshape(-1)[1:1 + 515 * 32].view(515, 32)
                 for p in rows((516, 32), 2)]
    tie_last = rows((333, 16), 4, hi=2, dead=0.0)
    tie_last[:3] = [torch.zeros_like(tie_last[0])] * 3
    word0_ties = rows((301, 256), 5, hi=3, dead=0.1)
    word0_ties[0] = torch.randint(0, 2, (301, 256), generator=gen,
                                  device=dev)
    dead_last = rows((300, 256), 5, hi=1 << 62)
    dead_last[-1] = torch.randint(0, 1 << 14, (300, 256), generator=gen,
                                  device=dev)
    unaligned5 = [p.reshape(-1)[1:1 + 1001 * 16].view(1001, 16)
                  for p in rows((1002, 16), 5, hi=3)]
    # name -> (planes in the (G, m) row layout, m)
    cases = {
        "route": ([route.view(n // 256, 256)], 256),
        "w2": (rows((2048, 256), 2), 256),
        "w4": (rows((256, 512), 4), 512),
        "m2": (rows((50_000, 2), 1), 2),
        "m128": (rows((1000, 128), 2, hi=1 << 40), 128),
        f"m{big}": (rows((8, big), 1, hi=1000), big),
        "m4096_w4": (rows((4, 4096), 4), 4096),
        "g1": (rows((1, 1024), 3), 1024),
        "all_sentinels": (rows((64, 256), 2, dead=1.0), 256),
        "one_run": ([torch.full((16, 1024), 7, device=dev)], 1024),
        # each body of K2b/K2c at its edges
        "m1_g_odd": (rows((50_001, 1), 2), 1),
        "m16_g_odd": (rows((4099, 16), 1, hi=5), 16),
        "m16_w4": (rows((2000, 16), 4, hi=3), 16),
        "m32_w2": (rows((3001, 32), 2, hi=9), 32),
        "m64": (rows((4000, 64), 1, hi=30), 64),
        "m1024_w1": (rows((300, 1024), 1, hi=200), 1024),
        "m512_w3": (rows((64, 512), 3, hi=4), 512),
        "unaligned_m32_w2": (unaligned, 32),
        "tie_last_w4": (tie_last, 16),
        # the index bodies (rows over four words, or over a lane's
        # registers): their edges, word-0 ties out of order in a later
        # word, dead rows whose last word varies, unaligned planes
        "w5_m16_g_odd": (rows((4099, 16), 5, hi=3), 16),
        "w7_m2": (rows((5001, 2), 7, hi=3), 2),
        "w5_m1": (rows((3001, 1), 5), 1),
        "w4_m512": (rows((33, 512), 4, hi=4), 512),
        "w13_m512": (rows((9, 512), 13, hi=4), 512),
        "w29_m16": (rows((1001, 16), 29, hi=3), 16),
        "ties_w5_m256": (word0_ties, 256),
        "dead_last_w5_m256": (dead_last, 256),
        "unaligned_w5_m16": (unaligned5, 16),
    }
    max_err = {"a": 0, "b": 0, "c": 0}

    def check(got, want, counter, before):
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            err = max(err, int((g.to(torch.int64)
                                - w.to(torch.int64)).abs().max()))
        launched = getattr(gk, counter) - before
        return err, launched

    for name, (planes, m) in cases.items():
        W = len(planes)
        sorted_rows = gk.sort_groups(planes)
        before = gk.run_lengths_launches
        got = gk.run_lengths_grouped(sorted_rows)
        err_a, la = check([got], [gk.run_lengths_grouped_ref(
            sorted_rows)], "run_lengths_launches", before)
        before = gk.grouped_launches
        gs, gc = gk.grouped_count(planes)
        ws, wc = gk.grouped_count_ref(planes)
        err_b, lb = check(gs + [gc], ws + [wc], "grouped_launches",
                          before)
        # K2c: the same lanes as (m_c, G_c) columns (m = 16 on the route)
        mc = m_t if name == "route" else m
        cols = [p.reshape(mc, -1) for p in planes]
        before = gk.strided_launches
        cs, cc = gk.grouped_count_strided(cols)
        ws, wc = gk.grouped_count_strided_ref(cols)
        err_c, lc = check(cs + [cc], ws + [wc], "strided_launches",
                          before)
        live = int((gc > 0).sum())
        G = planes[0].shape[0]
        bodies = (gk.launch_info(G, m, W)["body"],
                  gk.launch_info(cols[0].shape[1], mc, W,
                                 strided=True)["body"])
        _say(f"grouped_check case={name} W={W} G={G} m={m} k2c_m={mc} "
             f"bodies={bodies[0]},{bodies[1]} live_runs={live} "
             f"launches={la},{lb},{lc} max_abs_err={err_a},{err_b},{err_c}")
        want_live = name != "all_sentinels"
        if (max(err_a, err_b, err_c) or (la, lb, lc) != (1, 1, 1)
                or (live > 0) != want_live):
            raise AssertionError(f"K2a/K2b/K2c != plain versions ({name})")
        for key, err in zip("abc", (err_a, err_b, err_c)):
            max_err[key] = max(max_err[key], err)

    # K2a alone (K2b and K2c take powers of two): any m, W = 1 to 4, a run
    # filling a whole group, a run over a tile's end, groups of sentinels
    # only
    only_a = {}
    for m in (1, 3, 33, 128, 1000, 4096):
        for W in (1, 2, 3, 4):
            only_a[f"m{m}_w{W}"] = rows((max(1, 200_000 // (m * W)), m), W,
                                        hi=3)
    only_a["fill_group_w2"] = [torch.full((8, 4096), 5, device=dev)] * 2
    over = torch.full((6, 4096), 9, device=dev)
    over[:, 1000:3100] = 11                  # over the ends of 1024-row tiles
    over[:, 3100:] = SENTINEL_KEY
    only_a["run_over_tile_end"] = [over]
    only_a["sentinel_groups_w3"] = rows((100, 1000), 3, dead=1.0)
    for name, planes in only_a.items():
        sorted_rows = gk.sort_groups(planes)
        before = gk.run_lengths_launches
        got = gk.run_lengths_grouped(sorted_rows)
        err, la = check([got], [gk.run_lengths_grouped_ref(sorted_rows)],
                        "run_lengths_launches", before)
        live = int((got > 0).sum())
        G, m = planes[0].shape
        _say(f"grouped_check case=k2a_{name} W={len(planes)} G={G} m={m} "
             f"live_runs={live} launches={la} max_abs_err={err}")
        if err or la != 1 or (live > 0) != ("sentinel" not in name):
            raise AssertionError(f"K2a != plain version ({name})")
        max_err["a"] = max(max_err["a"], err)

    # timings at the route's shapes
    rows2d = cases["route"][0]
    G = n // 256
    sorted_route = gk.sort_groups(rows2d)
    cols = [route.view(m_t, n // m_t)]

    def stages(m):                 # bitonic stages of an m-row group
        return int(math.log2(m)) * (int(math.log2(m)) + 1) // 2

    def odd_even(m):               # Batcher's odd-even merge sort of m rows
        p = int(math.log2(m))
        return (p * p - p + 4) * 2 ** p // 4 - 1 if p else 0

    def launch(shape, W, strided):
        G, m = (shape[1], shape[0]) if strided else shape
        info = gk.launch_info(G, m, W, strided=strided)
        _say(f"launch kernel=K2{'c' if strided else 'b'} shape={shape} "
             f"W={W} " + " ".join(f"{k}={v}" for k, v in info.items())
             + f" threads_launched={info['threads'] * info['blocks']}")
        return info

    recs = []
    for key, kernel, plain, shape_note, sort_only, replaces, name, m in (
            ("a", functools.partial(gk.run_lengths_grouped, sorted_route),
             functools.partial(gk.run_lengths_grouped_ref, sorted_route),
             f"({G}, 256)", None, gk.REPLACES_RUN_LENGTHS,
             "run_lengths_grouped", 256),
            ("b", functools.partial(gk.grouped_count, rows2d),
             functools.partial(gk.grouped_count_ref, rows2d),
             f"({G}, 256)",
             functools.partial(torch.sort, rows2d[0], dim=1),
             gk.REPLACES_GROUPED, "grouped_count", 256),
            ("c", functools.partial(gk.grouped_count_strided, cols),
             functools.partial(gk.grouped_count_strided_ref, cols),
             f"({m_t}, {n // m_t})",
             functools.partial(torch.sort, cols[0], dim=0),
             gk.REPLACES_STRIDED, "grouped_count_strided", m_t)):
        ms, plain_ms = time_pair(kernel, plain)
        if key == "a":
            # sorted keys in, int32 counts out; one compare a lane
            b = bound(n * 8 + n * 4, n)
        elif key == "b":
            # keys in, sorted keys and int32 counts out; the bitonic
            # network's compare-exchanges of one word
            b = bound(2 * n * 8 + n * 4, n // 2 * stages(m))
        else:
            # the same bytes; the odd-even network's compare-exchanges
            b = bound(2 * n * 8 + n * 4, n // m * odd_even(m))
        sort_ms = time_ms(sort_only) if sort_only else None
        _say(f"grouped_time kernel=K2{key} shape={shape_note} W=1 "
             f"kernel_ms={ms} plain_ms={plain_ms} speedup={plain_ms / ms} "
             f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
             f"sort_only_ms={sort_ms} (torch.sort of one word at the same "
             f"shape, no run lengths: a yardstick, not the same function) "
             f"library_ms=None (no single PyTorch call gives grouped run "
             f"lengths) (tolerance: exact, max_abs_err must be 0)")
        rec = {"name": name, "route": "cuda", "source": gk.SOURCE,
               "replaces": replaces, "max_abs_err": max_err[key], "ms": ms,
               "plain_ms": plain_ms, **b, "library_ms": None}
        if sort_ms is not None:
            rec["sort_only_ms"] = sort_ms
            rec["launch"] = launch(tuple((rows2d if key == "b" else cols)[0]
                                         .shape), 1, key == "c")
        recs.append(rec)
    # K2a at W = 2: the k = 55 unfused step's groups of 256 (K7's pairs,
    # sentinel-padded to whole groups, each group sorted)
    wide = [w.reshape(-1) for w in ek.extract_keys(
        *main, WIDE_K, canonical=True, packed_width=MAIN_L)]
    pad = -wide[0].numel() % 256
    wide_raw = [torch.cat([w, torch.full((pad,), SENTINEL_KEY,
                                         device=dev)]).view(-1, 256)
                for w in wide]
    wide = gk.sort_groups(wide_raw)
    ms, plain_ms = time_pair(
        functools.partial(gk.run_lengths_grouped, wide),
        functools.partial(gk.run_lengths_grouped_ref, wide))
    nw = wide[0].numel()
    b = bound(nw * 16 + nw * 4, nw)
    _say(f"grouped_time kernel=K2a shape={tuple(wide[0].shape)} W=2 "
         f"kernel_ms={ms} plain_ms={plain_ms} speedup={plain_ms / ms} "
         f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
         f"library_ms=None (tolerance: exact, max_abs_err must be 0)")
    recs[0]["w2"] = {"shape": list(wide[0].shape), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b["bound_ms"]}
    # K2b and K2c at W = 2 on the same keys unsorted: (3392, 256) and
    # (16, 54272)
    cols2 = [w.reshape(m_t, -1) for w in wide_raw]
    for rec, strided, planes, m in ((recs[1], False, wide_raw, 256),
                                    (recs[2], True, cols2, m_t)):
        fn = gk.grouped_count_strided if strided else gk.grouped_count
        ref = (gk.grouped_count_strided_ref if strided
               else gk.grouped_count_ref)
        ms, plain_ms = time_pair(functools.partial(fn, planes),
                                 functools.partial(ref, planes))
        axis = 0 if strided else 1
        sort_ms = time_ms(functools.partial(torch.sort, planes[0], dim=axis))
        nw = planes[0].numel()
        ops = (nw // 2 * stages(m) if not strided
               else nw // m * odd_even(m))
        b = bound(2 * nw * 16 + nw * 4, 2 * ops)
        shape = tuple(planes[0].shape)
        _say(f"grouped_time kernel=K2{'c' if strided else 'b'} "
             f"shape={shape} W=2 kernel_ms={ms} plain_ms={plain_ms} "
             f"speedup={plain_ms / ms} bound_ms={b['bound_ms']} "
             f"bound_by={b['bound_by']} sort_only_ms={sort_ms} "
             f"library_ms=None (tolerance: exact, max_abs_err must be 0)")
        rec["w2"] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b["bound_ms"], "sort_only_ms": sort_ms,
                     "launch": launch(shape, 2, strided)}
    return tuple(recs)


def phase_unfused_end_to_end(dev, path: str, small: str, want_table,
                             fused_wall: float) -> tuple[int, int]:
    """Phase 4's run with KMER_TPU_STEP=legacy (K7 + the grouped torch.sort
    + K2a), right after phase 4, then the fused run once more, so that
    the two fused walls bracket the unfused one; returns K7's and K2a's
    launches."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.ops.kernels import grouped_count as gk
    from kmer_tpu_torch.utils import stagetime
    cfg = KmerConfig(k=K, canonical=True)
    want_batches = -(-N_READS // cfg.batch_reads)
    times: dict[str, float] = {}
    with _env(KMER_TPU_STEP="legacy"):
        # warm the route (allocator, pinned pool) on the small file
        count_fasta(small, cfg, device=dev)
        torch.cuda.synchronize()
        ek.launches = gk.run_lengths_launches = fe.launches = 0
        with stagetime.collect(times):
            table = count_fasta(path, cfg, device=dev)
    k7, k2a = ek.launches, gk.run_lengths_launches
    if not (table == want_table and k7 == k2a == want_batches
            and fe.launches == 0):
        raise AssertionError(f"unfused k=21 table != the fused one, or K7 "
                             f"{k7} / K2a {k2a} / K1 {fe.launches} launches "
                             f"!= {want_batches} batches")
    wall = times["total"]
    again: dict[str, float] = {}
    with stagetime.collect(again):
        if count_fasta(path, cfg, device=dev) != want_table:
            raise AssertionError("the second fused k=21 table differs")
    total_kmers = N_READS * (READ_LEN - K + 1)
    _say(f"unfused_end_to_end step=legacy grouped=auto(hybrid) m=256 "
         f"reads={N_READS} distinct={table.num_distinct} equal_to_fused=True "
         f"k7_launches={k7} k2a_launches={k2a} wall_s={wall} "
         f"fused_wall_s={fused_wall} fused_again_wall_s={again['total']} "
         f"kmers_per_s={total_kmers / wall}")
    _say("unfused_stages_s " + json.dumps(times, sort_keys=True))
    _say("fused_again_stages_s " + json.dumps(again, sort_keys=True))
    return k7, k2a


class _env:
    """Set environment variables for a block, restoring them after."""

    def __init__(self, **kw):
        self.kw, self.old = kw, {}

    def __enter__(self):
        for key, value in self.kw.items():
            self.old[key] = os.environ.get(key)
            os.environ[key] = value

    def __exit__(self, *exc):
        for key, value in self.old.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value


def phase_unfused_small(dev, small: str) -> tuple[int, int]:
    """The other unfused settings on the 50,000-read oracle file, each
    table against the numpy oracle; returns K2b's and K2c's launches."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.ops.kernels import compact as ck
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import grouped_count as gk
    from kmer_tpu_torch.ops.kernels import sort as sk
    want_v, want_c = oracle_table(small, K)
    cfg = KmerConfig(k=K, canonical=True)
    batches = -(-ORACLE_READS // cfg.batch_reads)
    runs = [  # (label, environment, config, {counter: expected launches})
        ("grouped=pallas", dict(KMER_TPU_STEP="legacy",
                                KMER_TPU_GROUPED="pallas"), cfg,
         {"k7": batches, "k2b": batches}),
        ("step=t", dict(KMER_TPU_STEP="t"), cfg,
         {"k7": batches, "k2c": batches}),
        ("sort_group_keys=0", {}, cfg.replace(sort_group_keys=0),
         {"k7": batches, "k6": batches}),
        ("compact", dict(KMER_TPU_STEP="legacy"), cfg.replace(compact=True),
         {"k7": batches, "k2a": batches, "k4": batches}),
        ("device_merge", dict(KMER_TPU_STEP="legacy"),
         cfg.replace(device_merge="on"), {"k7": batches, "k2a": batches}),
    ]
    counters = {"k7": (ek, "launches"), "k2a": (gk, "run_lengths_launches"),
                "k2b": (gk, "grouped_launches"),
                "k2c": (gk, "strided_launches"), "k6": (sk, "launches"),
                "k4": (ck, "launches")}
    seen = {}
    for label, env, run_cfg, want in runs:
        with _env(**env), _merge_probe() as probe:
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            table = count_fasta(small, run_cfg, device=dev)
            wall = time.perf_counter() - t0
        got = {name: getattr(mod, attr)
               for name, (mod, attr) in counters.items()}
        equal = (np.array_equal(table_values(table), want_v)
                 and np.array_equal(table.counts, want_c))
        _say(f"unfused_small run={label} reads={ORACLE_READS} "
             f"equal_to_oracle={equal} launches="
             f"{json.dumps(got, sort_keys=True)} wall_s={wall}"
             + (f" {probe.line()}" if probe.states else ""))
        if not equal:
            raise AssertionError(f"unfused {label}: table != numpy oracle")
        for name, n in want.items():
            # the device merge sorts once a merge, not once a batch
            if got[name] != n and not (label == "device_merge"
                                       and name == "k6"):
                raise AssertionError(f"unfused {label}: {name} launched "
                                     f"{got[name]} times, want {n}")
        if label == "device_merge" and got["k6"] == 0:
            raise AssertionError("unfused device merge: K6 never launched")
        seen[label] = got
    return seen["grouped=pallas"]["k2b"], seen["step=t"]["k2c"]


def window_ops(positions, span: int, lanes: int,
               canonical: bool = True) -> int:
    """Thread instructions that K1's or K7's window function needs over
    `lanes` windows, from the key's shape alone (span, runs, n), not from
    the kernels' tiles.  Contiguous (positions None, two words): the key's
    two words and their reverse complement (~16) and the compare, split
    and collapse (~8).
    A spaced seed: one push a window into its span's ceil(span / 16)
    32-bit words -- 2 to take the code from its packed word, a funnel shift
    a word forward and, canonical, a word and the complement's insert
    backward --; a shift and a three-input and-or per run of the mask on
    each strand; with canonical, the compare and select of the two keys (2
    a 32-bit key word); ~12 for the split, validity, stores and
    collapse."""
    from kmer_tpu_torch.ops.extract import seed_runs
    if positions is None:
        return lanes * 24
    n, sw = len(positions), -(-span // 16)
    push = 2 + sw + (sw + 1 if canonical else 0)
    cut = 2 * (2 if canonical else 1) * len(seed_runs(positions))
    select = 2 * -(-n // 16) if canonical else 0
    return lanes * (push + cut + select + 12)


def phase_wide_kernels(dev, seed: int) -> list[dict]:
    """K1 and K7 on keys of 32 to 63 bases and on spaced seeds == their
    plain versions, lane for lane, at B=8192, L=160: k = 32, 45, 48, 55
    and 63, the two masks, the rolled window's edge masks and a span over
    64 bases, canonical (palindromic masks) and not, packed rows and u8
    rows with 1% ambiguous codes and short rows, one launch each; then
    each variant timed at k = 55 (or the 55-span mask), canonical, packed,
    and the spaced kernels also at the span-31 mask and the span-100
    gathered window.  Returns the JSON records of the four variants
    (without the main-path launch counts)."""
    from kmer_tpu_torch.ops.encode import key_planes
    from kmer_tpu_torch.ops.extract import (mask_from_positions,
                                            parse_seed_mask,
                                            seed_mask_palindromic)
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    rng = np.random.default_rng(seed + 7)
    variants = {
        "two_word": [(k, None) for k in (32, 45, 48, WIDE_K, 63)],
        "spaced": [(m.count("1"), parse_seed_mask(m))
                   for m in (SHORT_MASK, WIDE_MASK, *EDGE_MASKS,
                             GATHER_MASK)]}
    max_err = {}
    for variant, shapes in variants.items():
        e1 = e7 = 0
        for k, pos in shapes:
            span = k if pos is None else pos[-1] + 1
            palindrome = pos is None or seed_mask_palindromic(
                mask_from_positions(pos))
            for canon in (False, True) if palindrome else (False,):
                for packed, amb, short in ((True, False, False),
                                           (False, True, True)):
                    host = gapped_batch(rng, MAIN_B, MAIN_L, packed=packed,
                                        amb=amb, short=short,
                                        full_len=READ_LEN)
                    on_dev = [t.to(dev) for t in host]
                    kw = dict(canonical=canon, mask_ambiguous=amb,
                              packed_width=MAIN_L if packed else 0,
                              positions=pos)
                    b1, b7 = fe.launches, ek.launches
                    keys, counts = fe.fused_extract_count(*on_dev, k,
                                                          seg=SEG, **kw)
                    want_keys, want_counts = fe.fused_extract_count_ref(
                        *on_dev, k, seg=SEG, **kw)
                    got7 = ek.extract_keys(*on_dev, k, **kw)
                    want7 = ek.extract_keys_ref(*on_dev, k, **kw)
                    torch.cuda.synchronize()
                    err1 = max(exact_err(keys, want_keys),
                               exact_err(counts, want_counts))
                    err7 = exact_err(got7, want7)
                    live = int((counts > 0).sum())
                    launched = (fe.launches - b1, ek.launches - b7)
                    _say(f"wide_kernel_check variant={variant} B={MAIN_B} "
                         f"L={MAIN_L} n_bases={k} span={span} "
                         f"canonical={canon} packed={packed} ambiguous={amb} "
                         f"short={short} planes={len(key_planes(keys))} "
                         f"live_lanes={live} launches={launched} "
                         f"max_abs_err_k1={err1} max_abs_err_k7={err7}")
                    if err1 or err7 or live == 0 or launched != (1, 1):
                        raise AssertionError(
                            f"K1/K7 {variant} != plain version (k={k}, "
                            f"span={span}, errors {err1}, {err7}, live "
                            f"{live})")
                    e1, e7 = max(e1, err1), max(e7, err7)
        max_err[variant] = (e1, e7)

    recs = []
    for variant, k, pos in (
            ("two_word", WIDE_K, None),
            ("spaced", WIDE_MASK.count("1"), parse_seed_mask(WIDE_MASK)),
            ("spaced_span31", SHORT_MASK.count("1"),
             parse_seed_mask(SHORT_MASK)),
            ("spaced_gather", GATHER_MASK.count("1"),
             parse_seed_mask(GATHER_MASK))):
        span = k if pos is None else pos[-1] + 1
        main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, span,
                                                packed=True, amb=False,
                                                short=False)]
        kw = dict(canonical=True, packed_width=MAIN_L, positions=pos)
        P = MAIN_L - span + 1
        P_pad = -(-P // SEG) * SEG
        lanes = P * MAIN_B
        in_bytes = main[0].numel() * 4 + MAIN_B * 8
        ops = window_ops(pos, span, lanes)
        wide = k > 31
        for name, mod, fn, ref, out_bytes, extra in (
                ("fused_extract_count", fe, fe.fused_extract_count,
                 fe.fused_extract_count_ref,
                 P_pad * MAIN_B * (17 if wide else 9), dict(seg=SEG)),
                ("extract_keys", ek, ek.extract_keys, ek.extract_keys_ref,
                 lanes * (16 if wide else 8), {})):
            ms, plain_ms = time_pair(
                functools.partial(fn, *main, k, **kw, **extra),
                functools.partial(ref, *main, k, **kw, **extra))
            b = bound(in_bytes + out_bytes, ops)
            launch_line(f"{name}[{variant}]", mod, MAIN_B, MAIN_L, k,
                        canonical=True, positions=pos, **extra)
            _say(f"wide_kernel_time kernel={name} variant={variant} "
                 f"B={MAIN_B} L={MAIN_L} n_bases={k} span={span} "
                 f"canonical=True packed=True kernel_ms={ms} "
                 f"plain_ms={plain_ms} speedup={plain_ms / ms} "
                 f"out_GB_per_s={out_bytes / (ms * 1e-3) / 1e9} "
                 f"ops={ops} "
                 f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
                 f"library_ms=None (no single PyTorch call extracts k-mers) "
                 f"(tolerance: exact, max_abs_err must be 0)")
            if variant not in max_err:
                continue        # timed only: not a row of the JSON line
            err = max_err[variant][0 if mod is fe else 1]
            recs.append({"name": f"{name}[{variant}]", "route": "cuda",
                         "source": mod.SOURCE, "replaces": mod.REPLACES,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **b, "library_ms": None})
    return recs


def _counters():
    """The launch counters of every kernel module, by short name."""
    from kmer_tpu_torch.ops.kernels import compact as ck
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.ops.kernels import fused_gapped as fg
    from kmer_tpu_torch.ops.kernels import grouped_count as gk
    from kmer_tpu_torch.ops.kernels import histogram as hk
    from kmer_tpu_torch.ops.kernels import sort as sk
    return {"k1": (fe, "launches"), "k1_wide": (fe, "wide_launches"),
            "k1_spaced": (fe, "spaced_launches"),
            "k7": (ek, "launches"), "k7_wide": (ek, "wide_launches"),
            "k7_spaced": (ek, "spaced_launches"),
            "k7_multi": (ek, "multi_launches"),
            "k7_gapped": (ek, "gapped_launches"),
            "k2a": (gk, "run_lengths_launches"),
            "k2b": (gk, "grouped_launches"),
            "k2c": (gk, "strided_launches"), "k3": (fg, "launches"),
            "k4": (ck, "launches"),
            "k5": (hk, "launches"), "k6": (sk, "launches")}


def _run_counted(fn):
    """fn() with every kernel's count set to 0 just before and read just
    after: (result, {short name: launches})."""
    counters = _counters()
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(mod, attr)
                 for name, (mod, attr) in counters.items()}


def phase_wide_end_to_end(dev, path: str, small: str, label: str, cfg,
                          runs) -> tuple[dict, object]:
    """`cfg` (k = 55 or the 55-span seed mask, canonical) on phase 4's
    corpus in each of `runs` -- (name, environment, config changes,
    {counter: launches wanted, -1 for "at least one"}) -- the first the
    reference: every table equal, the total sum(len - span + 1), the
    table on the first 50,000 reads equal to oracle_keys; each wall and
    stage breakdown, and the device merge's peak memory beside its state.
    Returns ({run: launches}, the reference table)."""
    from kmer_tpu_torch import count_fasta
    from kmer_tpu_torch.utils import stagetime
    span = cfg.window_span
    positions = cfg.seed_positions or tuple(range(cfg.k))
    want_keys, want_counts = oracle_keys(small, positions, cfg.canonical)
    small_table = count_fasta(small, cfg, device=dev)
    if not (np.array_equal(table_pairs(small_table), want_keys)
            and np.array_equal(small_table.counts, want_counts)):
        raise AssertionError(f"{label} count_fasta != numpy oracle on the "
                             f"first {ORACLE_READS} reads")
    _say(f"{label}_oracle_check reads={ORACLE_READS} "
         f"distinct={small_table.num_distinct} total={small_table.total} "
         "equal=True")
    batches = -(-N_READS // cfg.batch_reads)
    total = N_READS * (READ_LEN - span + 1)
    ref, seen = None, {}
    for name, env, change, want in runs:
        times: dict[str, float] = {}
        run_cfg = cfg.replace(**change)
        with _env(**env), _merge_probe() as probe:
            with stagetime.collect(times):
                table, got = _run_counted(
                    lambda: count_fasta(path, run_cfg, device=dev))
        ref = table if ref is None else ref
        bad = {c: got[c] for c, n in want.items()
               if (got[c] == 0 if n < 0 else got[c] != n)}
        if probe.states and got["k6"] != len(probe.states):
            bad["k6_per_merge"] = got["k6"]
        if table != ref or table.total != total or bad:
            raise AssertionError(f"{label} {name}: table differs from the "
                                 f"first run, total {table.total} != "
                                 f"{total}, or launches {bad} wrong")
        seen[name] = got
        wall = times["total"]
        _say(f"{label}_end_to_end run={name} reads={N_READS} kmers={total} "
             f"distinct={table.num_distinct} batches={batches} "
             f"equal_to_first=True launches="
             f"{json.dumps({c: n for c, n in got.items() if n})} "
             f"wall_s={wall} kmers_per_s={total / wall}"
             + (f" {probe.line()}" if probe.states else ""))
        _say(f"{label}_{name}_stages_s " + json.dumps(times, sort_keys=True))
    return seen, ref


def phase_wide_card(dev, path: str, label: str, cfg, exact_distinct: int,
                    variant_counter: str) -> int:
    """`card` at cfg's key (k = 55 or the 55-span mask, canonical): the
    estimate within 15% of the exact distinct count of the same corpus;
    returns K5's launches in the run."""
    from kmer_tpu_torch.pipeline.sketch import estimate_distinct_multi_k
    cfg = cfg.replace(batch_reads=2048)
    t0 = time.perf_counter()
    [(est, total)], got = _run_counted(
        lambda: estimate_distinct_multi_k(path, [cfg.n_bases], cfg,
                                          device=dev))
    wall = time.perf_counter() - t0
    rel = est / exact_distinct - 1
    batches = -(-N_READS // cfg.batch_reads)
    want_total = N_READS * (READ_LEN - cfg.window_span + 1)
    _say(f"card {label} canonical={cfg.canonical} b=10 estimate={est} "
         f"exact_distinct={exact_distinct} rel_err={rel} total={total} "
         f"k5_launches={got['k5']} {variant_counter}_launches="
         f"{got[variant_counter]} wall_s={wall} kmers_per_s={total / wall}")
    if (abs(rel) > 0.15 or total != want_total or got["k5"] != batches
            or got[variant_counter] != batches):
        raise AssertionError(f"card {label}: estimate {est} not within 15% "
                             f"of {exact_distinct}, or total/launches wrong")
    return got["k5"]


def write_genome_reads(path: str, n_reads: int, read_len: int,
                       genome_len: int, seed: int, error_rate: float,
                       slice_reads: int = BIG_SLICE_READS) -> None:
    """A FASTA of n_reads reads sampled from one seeded random genome,
    written a slice of reads at a time so that only one slice's
    temporaries are in memory: uniform start positions, substitutions at
    error_rate (a base replaced by one of the other three) and a
    reverse-complement strand for half the reads, as
    io.generator.genome_reads_fasta samples them (its draws differ).
    Headers are ">r" and a 10-digit read number."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    ascii_codes = np.frombuffer(b"ACGT", np.uint8)
    head = 13                                       # ">r" 10 digits "\n"
    cols = np.arange(read_len, dtype=np.int32)
    with open(path, "wb") as f:
        for first in range(0, n_reads, slice_reads):
            n = min(slice_reads, n_reads - first)
            starts = rng.integers(0, genome_len - read_len + 1, n,
                                  dtype=np.int32)
            codes = genome[starts[:, None] + cols[None, :]]
            flat = codes.reshape(-1)
            hit = rng.integers(0, flat.size, rng.binomial(flat.size,
                                                          error_rate))
            flat[hit] = (flat[hit] + rng.integers(1, 4, hit.size,
                                                  dtype=np.uint8)) % 4
            flip = rng.random(n) < 0.5
            codes[flip] = (3 - codes[flip])[:, ::-1]
            rec = np.empty((n, head + read_len + 1), np.uint8)
            rec[:, 0], rec[:, 1], rec[:, 12] = ord(">"), ord("r"), ord("\n")
            num = np.arange(first, first + n, dtype=np.int64)
            for j in range(10):
                rec[:, 11 - j] = 48 + (num // 10 ** j) % 10
            rec[:, head:head + read_len] = ascii_codes[codes]
            rec[:, -1] = ord("\n")
            f.write(rec.tobytes())


class _drain_probe:
    """For a block: counts the device merge's drains of a live state
    (pipeline/count.DeviceMerge.drain)."""

    def __enter__(self):
        from kmer_tpu_torch.pipeline import count as pc
        self.cls, self.orig, self.drains = pc.DeviceMerge, \
            pc.DeviceMerge.drain, 0
        probe = self

        def counted(dm):
            probe.drains += dm.words is not None
            return probe.orig(dm)
        self.cls.drain = counted
        return self

    def __exit__(self, *exc):
        self.cls.drain = self.orig


def stream_run(dev, path: str, cfg, spill: str, pause_after: int):
    """StreamingCounter over `path` on `dev`: pass 1 paused after
    `pause_after` batches, the counter dropped and the card's cache
    emptied, pass 1 resumed by a fresh counter, then pass 2; every
    kernel's count set to 0 just before pass 1 and read just after it.
    The spill directory is deleted after the final table is read.
    Returns (the final table, a record of the run)."""
    from kmer_tpu_torch import StreamingCounter
    from kmer_tpu_torch.utils import stagetime
    pass1: dict[str, float] = {}
    pass2: dict[str, float] = {}

    def run_pass1():
        sc = StreamingCounter(path, cfg, spill, device=dev)
        with stagetime.collect(pass1):
            sc.run_pass1(max_batches=pause_after)
        paused = dict(batch=sc.state["pass1_next_batch"],
                      cursor=sc.state["pass1_cursor"],
                      done=sc.state["pass1_done"])
        del sc
        torch.cuda.empty_cache()
        sc = StreamingCounter(path, cfg, spill, device=dev)
        with stagetime.collect(pass1):
            sc.run_pass1()
        return sc, paused

    with _merge_probe() as probe, _drain_probe() as drains:
        (sc, paused), launches = _run_counted(run_pass1)
    if paused["done"] or paused["batch"] != pause_after:
        raise AssertionError(f"the pause did not stop pass 1 at batch "
                             f"{pause_after}: {paused}")
    with stagetime.collect(pass2):
        sc.run_pass2()
    t0 = time.perf_counter()
    table = sc.final_table()
    rec = dict(batches=sc.state["pass1_next_batch"], paused=paused,
               launches={c: n for c, n in launches.items() if n},
               drains=drains.drains, merges=len(probe.states),
               spill_bytes=sum(sc.state["part_bytes"]),
               pass1_s=pass1["total"], pass2_s=pass2["total"],
               final_table_s=time.perf_counter() - t0,
               pass1_stages_s=pass1, pass2_stages_s=pass2,
               memory=probe.line() if probe.states else None)
    shutil.rmtree(spill)
    return table, rec


def _stream_say(label: str, rec: dict, **extra) -> None:
    _say(f"{label} " + json.dumps({**extra, **{k: v for k, v in rec.items()
                                              if not k.endswith("stages_s")}},
                                  sort_keys=True))
    _say(f"{label}_pass1_stages_s "
         + json.dumps(rec["pass1_stages_s"], sort_keys=True))
    _say(f"{label}_pass2_stages_s "
         + json.dumps(rec["pass2_stages_s"], sort_keys=True))


def phase_stream_batches(dev, path: str, want_table, host_wall: float,
                         tmp: str) -> None:
    """Phase 24a: the per-batch spill path on phase 4's corpus (k = 21,
    canonical, device_merge="off", three ingest chunks), paused past the
    first chunk and resumed: its table equals phase 4's, K1 launches once
    a batch."""
    from kmer_tpu_torch import KmerConfig
    cfg = KmerConfig(k=K, canonical=True, device_merge="off",
                     partitions=STREAM_PARTS,
                     ingest_chunk_bases=STREAM_CHUNK_BASES)
    first_chunk = STREAM_CHUNK_BASES // READ_LEN // cfg.batch_reads
    table, rec = stream_run(dev, path, cfg, os.path.join(tmp, "spill_a"),
                            pause_after=first_chunk + 8)
    if not (table == want_table
            and rec["launches"].get("k1") == rec["batches"]
            and rec["paused"]["cursor"] > 0):
        raise AssertionError(f"streaming (per batch) table != phase 4's, or "
                             f"K1 launches != batches, or the pause was not "
                             f"past a chunk: {rec}")
    _stream_say("stream_batches", rec, equal_to_phase4=True,
                reads=N_READS, distinct=table.num_distinct,
                phase4_host_merge_wall_s=host_wall,
                pass1_over_phase4=rec["pass1_s"] / host_wall)


def phase_stream_devmerge(dev, tmp: str, seed: int) -> None:
    """Phase 24b: BASELINE.json's 10M-read streaming corpus through the
    device merge (six chunks, a drain-commit each), paused mid-pass-1 and
    resumed; its table equals the in-memory device merge's on the same
    corpus, the total is sum(len - k + 1), K6 launches at least once a
    drain and K1 once a batch."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.utils import stagetime
    t0 = time.perf_counter()
    big = os.path.join(tmp, "big.fasta")
    write_genome_reads(big, BIG_READS, READ_LEN, GENOME_LEN, seed + 1,
                       ERROR_RATE)
    _say(f"stream_corpus reads={BIG_READS} read_len={READ_LEN} "
         f"genome_len={GENOME_LEN} error_rate={ERROR_RATE} seed={seed + 1} "
         f"bytes={os.path.getsize(big)} make_s={time.perf_counter() - t0}")
    cfg = KmerConfig(k=K, canonical=True, device_merge="on",
                     partitions=STREAM_PARTS)
    total = BIG_READS * (READ_LEN - K + 1)
    times: dict[str, float] = {}
    with _merge_probe() as probe:
        with stagetime.collect(times):
            want, got = _run_counted(lambda: count_fasta(big, cfg,
                                                         device=dev))
    if want.total != total:
        raise AssertionError(f"in-memory 10M table total {want.total} != "
                             f"{total}")
    _say(f"big_devmerge_in_memory reads={BIG_READS} kmers={total} "
         f"distinct={want.num_distinct} launches="
         f"{json.dumps({c: n for c, n in got.items() if n})} "
         f"wall_s={times['total']} kmers_per_s={total / times['total']} "
         f"{probe.line()}")
    _say("big_devmerge_in_memory_stages_s " + json.dumps(times,
                                                          sort_keys=True))
    torch.cuda.empty_cache()
    chunk_batches = cfg.ingest_chunk_bases // READ_LEN // cfg.batch_reads
    table, rec = stream_run(dev, big, cfg, os.path.join(tmp, "spill_b"),
                            pause_after=chunk_batches + chunk_batches // 2)
    os.remove(big)
    launches = rec["launches"]
    if not (table == want and table.total == total
            and launches.get("k1") == rec["batches"]
            and launches.get("k6", 0) >= rec["drains"] >= 6):
        raise AssertionError(f"streaming (device merge) 10M table != the "
                             f"in-memory one, or launches wrong: {rec}")
    _stream_say("stream_devmerge", rec, equal_to_in_memory=True,
                reads=BIG_READS, kmers=total, distinct=table.num_distinct,
                in_memory_wall_s=times["total"],
                pass1_over_in_memory=rec["pass1_s"] / times["total"],
                pass2_over_pass1=rec["pass2_s"] / rec["pass1_s"],
                kmers_per_s_both_passes=total / (rec["pass1_s"]
                                                 + rec["pass2_s"]))


def phase_stream_gapped(dev, gpath: str, want_table, tmp: str) -> None:
    """Phase 24c: phase 6's gapped corpus through the per-batch path (K3)
    and the device merge (K3 -> K6), each paused and resumed: both equal
    phase 6's table."""
    from kmer_tpu_torch import KmerConfig
    cfg = KmerConfig(gapped=True, batch_reads=GAP_B, max_read_len=512,
                     partitions=STREAM_PARTS)
    batches = -(-GAP_RECORDS // GAP_B)
    for route in ("off", "on"):
        table, rec = stream_run(dev, gpath, cfg.replace(device_merge=route),
                                os.path.join(tmp, f"spill_c_{route}"),
                                pause_after=batches // 3)
        launches = rec["launches"]
        if not (table == want_table and launches.get("k3") == batches
                and (route == "off") == ("k6" not in launches)):
            raise AssertionError(f"streaming gapped ({route}) table != phase "
                                 f"6's, or launches wrong: {rec}")
        _stream_say(f"stream_gapped_devmerge_{route}", rec,
                    equal_to_phase6=True, chunks=want_table.total)



def _cli(argv: list[str], out: str | None = None, stdin: str | None = None):
    """kmer_tpu_torch.cli.main(argv) in process, its stdout captured into
    the file `out` (returned as None) or a string; any exit code but 0
    fails the run.  The caller's KMER_TPU_PARSE_THREADS (which --threads
    sets) is restored after."""
    from kmer_tpu_torch.cli import main as cli_main
    threads = os.environ.get("KMER_TPU_PARSE_THREADS")
    old_stdin = sys.stdin
    with contextlib.ExitStack() as stack:
        sink = (stack.enter_context(open(out, "w")) if out
                else io.StringIO())
        stack.enter_context(contextlib.redirect_stdout(sink))
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            rc = cli_main(argv)
        finally:
            sys.stdin = old_stdin
            if threads is None:
                os.environ.pop("KMER_TPU_PARSE_THREADS", None)
            else:
                os.environ["KMER_TPU_PARSE_THREADS"] = threads
        text = None if out else sink.getvalue()
    if rc != 0:
        raise AssertionError(f"kmer_tpu_torch {' '.join(argv[:2])} exited "
                             f"{rc}")
    return text


def _launched(launches: dict) -> dict:
    return {name: n for name, n in launches.items() if n}


def _pair_ids(table) -> np.ndarray:
    """A table's keys as (M,) void16 ids (its (hi, lo) int64 rows), for
    np.intersect1d."""
    return np.ascontiguousarray(table_pairs(table)).view(
        np.dtype((np.void, 16))).reshape(-1)


def _tsv_columns(text: str, k: int) -> tuple[list[str], np.ndarray]:
    """A k-mer TSV's (k-mers, int64 counts), in row order."""
    lines = text.splitlines()
    counts = np.fromstring(" ".join(ln[k + 1:] for ln in lines),
                           dtype=np.int64, sep=" ")
    return [ln[:k] for ln in lines], counts


def _with_rest(times: dict) -> dict:
    """A stagetime collector's stages with "unattributed": its total less
    the stages' sum (CLI set-up, parsing of arguments, the table build
    outside a marked section)."""
    rest = times.get("total", 0.0) - sum(v for n, v in times.items()
                                         if n != "total")
    return {**times, "unattributed": rest}


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def surface_bgzf(dev, path: str, want_table, host_wall: float,
                 tmp: str) -> None:
    """Phase 25a: phase 4's corpus as BGZF, counted with --threads 8 and
    the device merge through the CLI."""
    from kmer_tpu_torch import KmerConfig
    from kmer_tpu_torch.io.bgzf import write_bgzf
    from kmer_tpu_torch.pipeline.table import KmerTable
    from kmer_tpu_torch.utils import stagetime
    gz = path + ".gz"
    threads = os.cpu_count()                # write_bgzf's threads
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        write_bgzf(gz, f.read())
    write_s = time.perf_counter() - t0
    npz = os.path.join(tmp, "bgzf_k21.npz")
    times: dict[str, float] = {}     # the CLI's stages; "total" its wall
    t0 = time.perf_counter()
    with stagetime.collect(times):
        _, launches = _run_counted(lambda: _cli(
            ["count", gz, "--device", "cuda", "--device-merge", "on", "-k",
             str(K), "--canonical", "--threads", "8", "--batch-reads",
             str(KmerConfig().batch_reads), "--out-npz", npz],
            out=os.path.join(tmp, "bgzf_k21.tsv")))
    cli_wall = time.perf_counter() - t0
    got = KmerTable.load(npz)
    batches = -(-N_READS // KmerConfig().batch_reads)
    if got != want_table:
        raise AssertionError("BGZF --threads 8 table != phase 4's")
    if launches["k1"] != batches or launches["k6"] < 1:
        raise AssertionError(f"BGZF count launches {launches}: want K1 "
                             f"{batches} and K6")
    _say("surface_bgzf " + json.dumps({
        "plain_bytes": os.path.getsize(path),
        "bgzf_bytes": os.path.getsize(gz), "write_s": write_s,
        "write_threads": threads, "cli_wall_s": cli_wall,
        "phase4_wall_s": host_wall,
        "distinct": got.num_distinct, "equal_to_phase4": True,
        "launches": _launched(launches)}, sort_keys=True))
    _say("surface_bgzf_stages_s " + json.dumps(_with_rest(times),
                                               sort_keys=True))
    for p in (gz, npz, os.path.join(tmp, "bgzf_k21.tsv")):
        os.remove(p)


def surface_profile(dev, small: str, tmp: str) -> None:
    """Phase 25b: count --profile-dir on the 50,000-read file."""
    base = ["count", small, "--device", "cuda", "-k", str(K), "--canonical"]
    plain = _cli(base)
    prof = os.path.join(tmp, "profile")
    traced, launches = _run_counted(
        lambda: _cli(base + ["--profile-dir", prof]))
    if traced != plain:
        raise AssertionError("count --profile-dir TSV != the untraced run's")
    files = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"--profile-dir wrote {files}")
    with open(os.path.join(prof, files[0])) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict[str, float] = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    k1 = [n for n in by_name if "fused_cut_kernel" in n]
    if not k1:
        raise AssertionError("the trace holds no device event of K1's "
                             f"fused_cut_kernel: {sorted(by_name)[:10]}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    _say("surface_profile " + json.dumps({
        "trace_bytes": os.path.getsize(os.path.join(prof, files[0])),
        "device_kernels": len(by_name), "k1_names": k1,
        "k1_device_us": sum(by_name[n] for n in k1),
        "top3_device_us": top, "tsv_equal": True,
        "launches": _launched(launches)}, sort_keys=True))
    shutil.rmtree(prof)


def surface_tools(dev, small: str, tmp: str, k: int) -> None:
    """Phases 25c and 25d at one k: the 50,000-read file whole and as two
    halves through count --out-npz, then tools, dump and query."""
    from kmer_tpu_torch.pipeline.table import KmerTable
    from kmer_tpu_torch.utils import stagetime
    with open(small) as f:
        lines = f.read().splitlines(keepends=True)
    half = len(lines) // 4 * 2
    halves = [os.path.join(tmp, f"half{i}.fasta") for i in (1, 2)]
    for p, part in zip(halves, (lines[:half], lines[half:])):
        with open(p, "w") as f:
            f.writelines(part)
    npz = {name: os.path.join(tmp, f"{name}_k{k}.npz")
           for name in ("whole", "h1", "h2")}
    count = ["count", "--device", "cuda", "-k", str(k), "--canonical"]
    count_stages: dict[str, float] = {}     # "total": the three CLI walls
    with stagetime.collect(count_stages):
        whole_tsv, launches = _run_counted(
            lambda: _cli(count + [small, "--out-npz", npz["whole"]]))
        a_tsv = _cli(count + [halves[0], "--out-npz", npz["h1"]])
        # no oracle reads half 2's TSV
        _cli(count + [halves[1], "--out-npz", npz["h2"]], out=os.devnull)
    whole, a, b = (KmerTable.load(npz[n]) for n in ("whole", "h1", "h2"))

    tools_stages: dict[str, float] = {}     # "total": the five CLI walls
    with stagetime.collect(tools_stages):
        # the union's TSV equal to the whole's is the table equal to it
        if _cli(["tools", "union", npz["h1"], npz["h2"]]) != whole_tsv:
            raise AssertionError(f"k={k}: tools union of the halves != the "
                                 "whole table")
        outs = {op: _cli(["tools", op, npz["h1"], npz["h2"]])
                for op in ("intersect", "subtract", "kmers-subtract")}
        cmp = json.loads(_cli(["tools", "compare", npz["h1"], npz["h2"]]))
    # the oracle on half 1's rows, in its key order: kept rows, counts
    va, vb = _pair_ids(a), _pair_ids(b)
    common, ia, ib = np.intersect1d(va, vb, assume_unique=True,
                                    return_indices=True)
    in_b = np.isin(va, vb)
    inter = np.zeros(len(va), np.int64)
    inter[ia] = np.minimum(a.counts[ia], b.counts[ib])
    diff = a.counts.copy()
    diff[ia] -= b.counts[ib]
    km_a, _ = _tsv_columns(a_tsv, k)
    for op, keep, counts in (("intersect", in_b, inter),
                             ("subtract", diff > 0, diff),
                             ("kmers-subtract", ~in_b, a.counts)):
        idx = np.flatnonzero(keep)
        want = "".join(f"{km_a[i]}\t{c}\n"
                       for i, c in zip(idx.tolist(), counts[idx].tolist()))
        if outs[op] != want:
            raise AssertionError(f"k={k}: tools {op} != numpy oracle "
                                 f"({outs[op].count(chr(10))} vs "
                                 f"{len(idx)} rows)")
    shared, na, nb = len(common), len(va), len(vb)
    want_cmp = {"k": k, "distinct_a": na, "distinct_b": nb,
                "distinct_shared": shared,
                "jaccard": shared / (na + nb - shared),
                "containment_a_in_b": shared / na,
                "containment_b_in_a": shared / nb}
    if cmp != want_cmp:
        raise AssertionError(f"k={k}: tools compare {cmp} != {want_cmp}")

    # dump: the spectrum equals histo's, the top 10 a numpy top 10
    histo = _cli(["histo", small, "--device", "cuda", "-k", str(k),
                  "--canonical"])
    if _cli(["dump", npz["whole"], "--histo"]) != histo:
        raise AssertionError(f"k={k}: dump --histo != histo")
    km_w, cw = _tsv_columns(whole_tsv, k)
    top = np.argsort(-cw, kind="stable")[:10]
    want_top = "".join(f"{km_w[i]}\t{cw[i]}\n" for i in top)
    if _cli(["dump", npz["whole"], "--top", "10"]) != want_top:
        raise AssertionError(f"k={k}: dump --top 10 != numpy top 10")

    # query: k-mers of the table, their reverse complements, random ones;
    # the TSV's k-mers are sorted (ACGT's ASCII order is the key order)
    def lookup(q: str) -> int:
        i = bisect.bisect_left(km_w, q)
        return int(cw[i]) if i < len(km_w) and km_w[i] == q else 0

    rng = np.random.default_rng(k)
    kmers = [km_w[i] for i in rng.choice(len(km_w), 1000, replace=False)]
    rand = ["".join("ACGT"[c] for c in row)
            for row in rng.integers(0, 4, (1000, k))]
    absent = 0
    for qs, extra, want in (
            (kmers, [], [lookup(q) for q in kmers]),
            ([_revcomp(q) for q in kmers] + rand, ["--canonical"],
             [lookup(q) for q in kmers]
             + [lookup(min(q, _revcomp(q))) for q in rand])):
        got = _cli(["query", npz["whole"], *extra], stdin="\n".join(qs))
        if got != "".join(f"{q}\t{c}\n" for q, c in zip(qs, want)):
            raise AssertionError(f"k={k}: query {extra} != the table")
        absent = want[len(kmers):].count(0)
    _say(f"surface_tools k={k} " + json.dumps({
        "whole": whole.num_distinct, "half1": na, "half2": nb,
        "shared": shared, "subtract": int((diff > 0).sum()),
        "kmers_subtract": int(keep.sum()), "jaccard": cmp["jaccard"],
        "query_absent_random": absent, "equal_to_oracle": True,
        "launches_whole": _launched(launches)}, sort_keys=True))
    _say(f"surface_tools_stages_s k={k} " + json.dumps({
        "counts": _with_rest(count_stages),
        "tools": _with_rest(tools_stages)}, sort_keys=True))
    for p in list(npz.values()) + halves:
        os.remove(p)


def surface_fastq(dev, tmp: str, seed: int) -> None:
    """Phase 25e: generated FASTQ through count, with and without
    --min-qual (at k = 9 there: a window of 21 bases drawn from Phred 2
    to 40 has all of them at 20 or more once in ~400,000)."""
    from kmer_tpu_torch.io.generator import random_reads_fastq
    n, L, kq = 20_000, 150, 9
    fq = os.path.join(tmp, "gen.fastq")
    with open(fq, "w") as f:
        f.write(_cli(["generate", "--format", "fastq", "--seed", str(seed),
                      "--n-records", str(n), "--read-len", str(L)]))
    tsv, launches = _run_counted(lambda: _cli(
        ["count", fq, "--device", "cuda", "-k", str(K)]))
    total = int(_tsv_columns(tsv, K)[1].sum())
    if total != n * (L - K + 1):
        raise AssertionError(f"generated FASTQ total {total} != "
                             f"{n * (L - K + 1)}")
    text = random_reads_fastq(n, L, seed=seed, qual_range=(2, 41))
    with open(fq, "w") as f:
        f.write(text)
    qual = np.frombuffer("".join(text.split("\n")[3::4]).encode(),
                         np.uint8).reshape(n, L).astype(np.int64) - 33
    win = np.lib.stride_tricks.sliding_window_view(qual >= 20, kq, axis=1)
    want = int(win.all(axis=2).sum())
    tsv, qlaunches = _run_counted(lambda: _cli(
        ["count", fq, "--device", "cuda", "-k", str(kq), "--min-qual",
         "20"]))
    got = int(_tsv_columns(tsv, kq)[1].sum())
    if got != want or want == 0:
        raise AssertionError(f"--min-qual 20 total {got} != oracle {want}")
    _say("surface_fastq " + json.dumps({
        "reads": n, "read_len": L, "total": total, "min_qual_k": kq,
        "min_qual20_total": got,
        "equal_to_oracle": True, "launches": _launched(launches),
        "launches_min_qual": _launched(qlaunches)}, sort_keys=True))
    os.remove(fq)


def phase_surface(dev, path: str, small: str, want_table, host_wall: float,
                  tmp: str, seed: int) -> None:
    """Phase 25: the saved-table surface through the CLI, in process."""
    t0 = time.perf_counter()
    surface_bgzf(dev, path, want_table, host_wall, tmp)
    surface_profile(dev, small, tmp)
    for k in (K, WIDE_K):
        surface_tools(dev, small, tmp, k)
    surface_fastq(dev, tmp, seed)
    _say(f"surface_wall_s={time.perf_counter() - t0}")


# phase 26: multi-GPU counting on one card -- a mesh of positions, each
# on cuda:0, whose collectives are tensor moves (or a one-rank NCCL
# group's calls); four positions share one card, so no time here is a
# scaling figure
SKEW_READS = 200_000


def table_digest(table) -> str:
    """md5 of a table's k, keys and counts (a table compared after its
    arrays are freed)."""
    h = hashlib.md5(str(table.k).encode())
    h.update(np.ascontiguousarray(table.keys).tobytes())
    h.update(np.ascontiguousarray(table.counts).tobytes())
    return h.hexdigest()


def _mesh(dev, n_data: int, n_seq: int):
    from kmer_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n_data, n_seq, devices=[dev] * (n_data * n_seq))


def _mesh_line(mesh) -> str:
    """What a mesh's collectives moved: routed bytes (all, and those that
    changed position), halo bytes, rows each owner took and the largest
    owner's rows over the mean (the routing skew)."""
    st = mesh.stats
    rows = st["owner_rows"]
    skew = float(rows.max() / rows.mean()) if rows.sum() else 0.0
    return (f"exchange_bytes={st['exchange_bytes']} "
            f"exchange_cross_bytes={st['exchange_cross_bytes']} "
            f"halo_bytes={st['halo_bytes']} owner_rows={rows.tolist()} "
            f"owner_skew_max_over_mean={skew}")


def mesh_full_width(dev, path: str, want_table, host_wall: float,
                    devmerge_wall: float) -> None:
    """Phase 26a: count_fasta_multihost over a (4, 1) mesh on the card,
    k = 21 canonical, on phase 4's corpus: phase 4's table, K1 four times
    a global batch (a quarter batch each), K6's owner partition as
    often."""
    from kmer_tpu_torch import KmerConfig
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    from kmer_tpu_torch.utils import stagetime
    cfg = KmerConfig(k=K, canonical=True)
    mesh = _mesh(dev, 4, 1)
    times: dict[str, float] = {}

    def run():
        with stagetime.collect(times):
            return count_fasta_multihost(path, cfg, mesh=mesh)
    table, launches = _run_counted(run)
    batches = -(-N_READS // cfg.batch_reads)
    if not (table == want_table and launches["k1"] == 4 * batches
            and launches["k6"] == 4 * batches):
        raise AssertionError(f"(4, 1) mesh table != phase 4's, or launches "
                             f"{_launched(launches)} != 4 x {batches}")
    wall = times["total"]
    _say(f"mesh_full_width mesh=(4, 1) device={dev} equal_to_phase4=True "
         f"batches={batches} k1_launches={launches['k1']} "
         f"partition_sort_k6_launches={launches['k6']} wall_s={wall} "
         f"phase4_wall_s={host_wall} phase14_wall_s={devmerge_wall} "
         f"wall_over_phase4={wall / host_wall} "
         f"kmers_per_s={N_READS * (READ_LEN - K + 1) / wall} "
         + _mesh_line(mesh))
    _say("mesh_full_width_stages_s " + json.dumps(times, sort_keys=True))


def mesh_seq_axis(dev, small: str) -> dict:
    """Phase 26b: the 50,000-read file over a (2, 2) mesh (a seq halo) and
    a (1, 4) mesh whose shards are narrower than the k = 55 and span-55
    halos (several ring hops), at k = 21, k = 55 and the span-55 mask:
    each table equals the single-device one.  Returns the k = 21 table."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    from kmer_tpu_torch.pipeline.count import batch_width
    from kmer_tpu_torch.io.fasta import scan_record_offsets
    width = batch_width(scan_record_offsets(small), KmerConfig())
    wants = {}
    for label, cfg in (("k21", KmerConfig(k=K, canonical=True)),
                       (f"k{WIDE_K}", KmerConfig(k=WIDE_K, canonical=True)),
                       ("mask55", KmerConfig(seed_mask=WIDE_MASK,
                                             canonical=True))):
        want = wants[label] = count_fasta(small, cfg, device=dev)
        span = cfg.window_span
        for shape in ((2, 2), (1, 4)):
            mesh = _mesh(dev, *shape)
            t0 = time.perf_counter()
            got, launches = _run_counted(
                lambda: count_fasta_multihost(small, cfg, mesh=mesh))
            secs = time.perf_counter() - t0
            if not (got == want and launches["k1"] > 0 and launches["k6"]):
                raise AssertionError(f"{label} over a {shape} mesh != the "
                                     f"single-device table, or launches "
                                     f"{_launched(launches)}")
            unit = 16 * shape[1]
            shard = -(-width // unit) * unit // shape[1]
            halo = -(-(span - 1) // 16) * 16
            _say(f"mesh_seq {label} mesh={shape} row_bases={width} "
                 f"shard_bases={shard} halo_bases={halo} "
                 f"hops={-(-halo // shard)} equal_to_single_device=True "
                 f"launches={json.dumps(_launched(launches))} s={secs} "
                 + _mesh_line(mesh))
    return wants["k21"]


def mesh_other_steps(dev, path: str, small: str, gpath: str, want_small,
                     gapped_digest: str, dense8) -> None:
    """Phase 26c: the gapped pairs step (K3) over a (2, 1) mesh on phase
    6's corpus; the sorted-stream step (KMER_TPU_MULTIHOST_STEP=legacy:
    K7, K6, exchange, K6) on the 50,000-read file, its owners' streams
    concatenated globally sorted; dense k = 8 (K1 + K5) over a (4, 1) mesh
    by all-reduce and by reduce-scatter, each equal to phase 11's table."""
    from kmer_tpu_torch import KmerConfig, KmerTable
    from kmer_tpu_torch.io.fasta import iter_batches, parse_seqs
    from kmer_tpu_torch.parallel import distributed
    from kmer_tpu_torch.parallel.mesh import split_batch
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    cfg = KmerConfig(gapped=True, batch_reads=GAP_B, max_read_len=512)
    mesh = _mesh(dev, 2, 1)
    t0 = time.perf_counter()
    got, launches = _run_counted(
        lambda: count_fasta_multihost(gpath, cfg, mesh=mesh))
    secs = time.perf_counter() - t0
    if table_digest(got) != gapped_digest or not launches["k3"]:
        raise AssertionError("gapped (2, 1) mesh table != phase 6's, or K3 "
                             f"launches {_launched(launches)}")
    _say(f"mesh_gapped mesh=(2, 1) equal_to_phase6=True "
         f"launches={json.dumps(_launched(launches))} s={secs} "
         + _mesh_line(mesh))

    k21 = KmerConfig(k=K, canonical=True)
    mesh = _mesh(dev, 4, 1)
    os.environ["KMER_TPU_MULTIHOST_STEP"] = "legacy"
    try:
        t0 = time.perf_counter()
        got, launches = _run_counted(
            lambda: count_fasta_multihost(small, k21, mesh=mesh))
        secs = time.perf_counter() - t0
    finally:
        del os.environ["KMER_TPU_MULTIHOST_STEP"]
    codes, offsets = parse_seqs(small)
    b = next(iter_batches(codes, offsets, batch_reads=k21.batch_reads,
                          max_len=160, overlap=K - 1, packed=True))
    one = _mesh(dev, 4, 1)
    out = distributed.make_distributed_count(one, k=K, canonical=True)(
        split_batch(one, torch.from_numpy(b.codes.view(np.int32)),
                    b.lengths, b.start_limits, b.packed_width))
    stream = torch.cat([w[0][c > 0] for w, c in out])
    ordered = bool((stream[1:] > stream[:-1]).all())
    if not (got == want_small and launches["k7"] and launches["k6"]
            and not launches["k1"] and ordered):
        raise AssertionError(f"legacy mesh table != the single-device one, "
                             f"stream sorted {ordered}, or launches "
                             f"{_launched(launches)}")
    _say(f"mesh_legacy mesh=(4, 1) equal_to_single_device=True "
         f"first_batch_stream_rows={stream.numel()} globally_sorted=True "
         f"launches={json.dumps(_launched(launches))} s={secs} "
         + _mesh_line(mesh))

    dcfg = KmerConfig(k=8, canonical=True, mode="dense")
    t0 = time.perf_counter()
    got, launches = _run_counted(
        lambda: count_fasta_multihost(path, dcfg, mesh=_mesh(dev, 4, 1)))
    secs = time.perf_counter() - t0

    def scatter():
        dense = distributed.make_distributed_dense(mesh, k=8, canonical=True,
                                                   scatter=True)
        codes, offsets = parse_seqs(path)
        for b in iter_batches(codes, offsets, batch_reads=dcfg.batch_reads,
                              max_len=160, overlap=7, packed=True):
            dense.add(split_batch(mesh, torch.from_numpy(
                b.codes.view(np.int32)), b.lengths, b.start_limits,
                b.packed_width))
        shards = dense.reduce()
        return KmerTable.from_dense(torch.cat(shards).cpu().numpy(), 8), [
            s.numel() for s in shards]
    t1 = time.perf_counter()
    (sgot, sizes), slaunch = _run_counted(scatter)
    ssecs = time.perf_counter() - t1
    if not (got == dense8 and sgot == dense8 and launches["k5"]
            and slaunch["k5"]):
        raise AssertionError(f"dense k=8 over a (4, 1) mesh != phase 11's "
                             f"(all-reduce {got == dense8}, reduce-scatter "
                             f"{sgot == dense8})")
    _say(f"mesh_dense k=8 mesh=(4, 1) all_reduce_equal_to_phase11=True "
         f"launches={json.dumps(_launched(launches))} s={secs} "
         f"reduce_scatter_equal_to_phase11=True shard_rows={sizes} "
         f"launches={json.dumps(_launched(slaunch))} s={ssecs}")


def mesh_skewed(dev, tmp: str, seed: int) -> None:
    """Phase 26d: poly-A reads with substitutions only in their last
    k - 4 bases, so every window (and its canonical form) starts with
    AAAA and routes to owner 0, over a (4, 1) mesh: the table equals the
    numpy oracle, and owner 0 takes every routed row."""
    from kmer_tpu_torch import KmerConfig
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    rng = np.random.default_rng(seed)
    codes = np.zeros((SKEW_READS, READ_LEN), np.uint8)
    tail = codes[:, READ_LEN - K + 4:]
    hit = rng.random(tail.shape) < 0.3
    tail[hit] = rng.integers(1, 4, int(hit.sum()))
    text = np.frombuffer(b"ACGT", np.uint8)[codes]
    lines = np.full((SKEW_READS, READ_LEN + 1), ord("\n"), np.uint8)
    lines[:, :READ_LEN] = text
    skew = os.path.join(tmp, "skew.fasta")
    with open(skew, "wb") as f:
        for i in range(0, SKEW_READS, 50_000):
            block = lines[i:i + 50_000]
            f.write(b"".join(b">r\n" + row.tobytes() for row in block))
    mesh = _mesh(dev, 4, 1)
    t0 = time.perf_counter()
    got, launches = _run_counted(lambda: count_fasta_multihost(
        skew, KmerConfig(k=K, canonical=True), mesh=mesh))
    secs = time.perf_counter() - t0
    want_v, want_c = oracle_table(skew, K)
    rows = mesh.stats["owner_rows"]
    if not (np.array_equal(table_values(got), want_v)
            and np.array_equal(got.counts, want_c)
            and rows[0] > 0 and rows[1:].sum() == 0):
        raise AssertionError(f"skewed corpus: table != numpy oracle, or "
                             f"owner rows {rows.tolist()}")
    _say(f"mesh_skewed reads={SKEW_READS} mesh=(4, 1) distinct="
         f"{got.num_distinct} total={got.total} equal_to_oracle=True "
         f"launches={json.dumps(_launched(launches))} s={secs} "
         + _mesh_line(mesh))


def mesh_nccl(dev, small: str, want_small) -> None:
    """Phase 26e: a one-rank NCCL group; count_fasta_multihost on the
    50,000-read file and `count --multihost` through cli.main both go
    through the group's collectives (all_to_all_single counted) and equal
    the single-device table."""
    import socket
    import torch.distributed as dist
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    from kmer_tpu_torch import KmerConfig
    calls = {"all_to_all_single": 0, "all_gather": 0}
    real = {n: getattr(dist, n) for n in calls}

    def spy(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    init_s = time.perf_counter() - t0
    backend = dist.get_backend()
    try:
        for n in calls:
            setattr(dist, n, spy(n))
        t0 = time.perf_counter()
        got = count_fasta_multihost(small, KmerConfig(k=K, canonical=True),
                                    device=dev)
        secs = time.perf_counter() - t0
        api_calls = dict(calls)
        t0 = time.perf_counter()
        tsv = _cli(["count", small, "-k", str(K), "--canonical",
                    "--multihost", "--device", "cuda"])
        cli_s = time.perf_counter() - t0
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)
        dist.destroy_process_group()
    want_tsv = io.StringIO()
    want_small.write_tsv(want_tsv)
    if not (got == want_small and tsv == want_tsv.getvalue()
            and api_calls["all_to_all_single"] > 0
            and calls["all_to_all_single"] > api_calls["all_to_all_single"]):
        raise AssertionError(f"one-rank NCCL group: table equal "
                             f"{got == want_small}, TSV equal "
                             f"{tsv == want_tsv.getvalue()}, calls {calls}")
    _say(f"mesh_nccl world_size=1 backend={backend} init_s={init_s} "
         f"equal_to_single_device=True s={secs} cli_tsv_equal=True "
         f"cli_s={cli_s} api_calls={json.dumps(api_calls)} "
         f"all_calls={json.dumps(calls)}")


def mesh_streaming(dev, small: str, want_small, tmp: str) -> None:
    """Phase 26f: StreamingCounter over a (2, 1) mesh paused after 3
    batches, resumed by a fresh counter over a (4, 1) mesh: the
    in-memory table."""
    from kmer_tpu_torch import KmerConfig, StreamingCounter
    cfg = KmerConfig(k=K, canonical=True)
    spill = os.path.join(tmp, "mesh_spill")
    t0 = time.perf_counter()

    def run():
        sc = StreamingCounter(small, cfg, spill, device=dev,
                              mesh=_mesh(dev, 2, 1))
        sc.run_pass1(max_batches=3)
        paused = sc.state["pass1_next_batch"]
        sc = StreamingCounter(small, cfg, spill, device=dev,
                              mesh=_mesh(dev, 4, 1))
        sc.run()
        return sc.final_table(), paused, sc.state["pass1_next_batch"]
    (got, paused, batches), launches = _run_counted(run)
    secs = time.perf_counter() - t0
    shutil.rmtree(spill)
    if not (got == want_small and paused == 3 and launches["k1"]):
        raise AssertionError(f"streaming over a mesh: table equal "
                             f"{got == want_small}, paused at {paused}")
    _say(f"mesh_streaming paused_at={paused} batches={batches} "
         f"meshes=(2, 1)->(4, 1) equal_to_in_memory=True "
         f"launches={json.dumps(_launched(launches))} s={secs}")


def phase_mesh(dev, path: str, small: str, gpath: str, tmp: str, seed: int,
               want_table, host_wall: float, devmerge_wall: float,
               gapped_digest: str, dense8) -> None:
    """Phase 26: multi-GPU counting on one card, each part timed."""
    t0 = time.perf_counter()
    parts = {}
    for name, fn in (
            ("a", lambda: mesh_full_width(dev, path, want_table, host_wall,
                                          devmerge_wall)),
            ("b", lambda: parts.setdefault("small", mesh_seq_axis(
                dev, small))),
            ("c", lambda: mesh_other_steps(dev, path, small, gpath,
                                           parts["small"], gapped_digest,
                                           dense8)),
            ("d", lambda: mesh_skewed(dev, tmp, seed)),
            ("e", lambda: mesh_nccl(dev, small, parts["small"])),
            ("f", lambda: mesh_streaming(dev, small, parts["small"], tmp))):
        t1 = time.perf_counter()
        fn()
        parts[f"{name}_s"] = time.perf_counter() - t1
    _say("mesh_parts_s " + json.dumps({k: v for k, v in parts.items()
                                       if k.endswith("_s")}, sort_keys=True)
         + f" mesh_wall_s={time.perf_counter() - t0}")


# phase 27: keys of any width -- contiguous keys over 63 bases in W int64
# words, gapped windows over 31 bases, and the gapped unfused route (K7's
# gapped lanes), with K7, K6, K2a-c and K4 widened to W planes

def _check_planes(label: str, got, want, launched: int) -> int:
    """Bit-for-bit check of a kernel's planes against its plain version's;
    raises on a difference or a launch count other than one."""
    err = max(exact_err(g, w) for g, w in zip(got, want))
    if (err or launched != 1 or len(got) != len(want)
            or not all(torch.equal(g, w) for g, w in zip(got, want))):
        raise AssertionError(f"{label}: kernel != plain version "
                             f"(max_abs_err={err}, launches={launched})")
    return err


# K7's multi-word edges (phase 27a): (B, L, k, canonical, packed,
# ambiguous, lengths) with lengths "full" (rows of L bases), "short"
# (random lengths and limits) or "below_k" (every row shorter than k):
# tiles ending inside rows and B P no multiple of 32, one window a row,
# P below a block, rows shorter than k, W = 3, 4, 5 and 7 (k = 200), and
# rows too wide to stage (k = 1000: the row body)
MULTI_EDGES = [(301, 161, ANY_K, True, True, False, "full"),
               (257, ANY_K, ANY_K, True, False, True, "full"),
               (333, 102, 100, False, True, False, "short"),
               (300, MAIN_L, ANY_K, True, True, False, "below_k"),
               (129, MAIN_L, 64, True, False, True, "short"),
               (77, MAIN_L, 130, True, True, False, "full"),
               (517, 256, 200, True, False, True, "short"),
               (300, 1000, 1000, True, True, False, "full")]


def multi_word_edges(dev, rng) -> int:
    """Phase 27a, K7's multi-word entry at MULTI_EDGES, bit for bit
    against its plain version, one launch each, with the body its plan
    takes; returns the largest error."""
    from kmer_tpu_torch.ops.encode import SENTINEL_KEY, words64
    from kmer_tpu_torch.ops.kernels import extract as ek
    err_all = 0
    for B, L, k, canon, packed, amb, lens in MULTI_EDGES:
        host = gapped_batch(rng, B, L, packed=packed, amb=amb,
                            short=lens == "short", full_len=L)
        if lens == "below_k":
            host[1] = torch.from_numpy(
                rng.integers(0, k, B).astype(np.int32))
        on_dev = [t.to(dev) for t in host]
        kw = dict(canonical=canon, mask_ambiguous=amb,
                  packed_width=L if packed else 0)
        before = ek.multi_launches
        got = ek.extract_keys(*on_dev, k, **kw)
        want = ek.extract_keys_ref(*on_dev, k, **kw)
        torch.cuda.synchronize()
        err = _check_planes(f"K7 edge B={B} L={L} k={k}", got, want,
                            ek.multi_launches - before)
        live = int((want[0] != SENTINEL_KEY).sum())
        body = ek.launch_info(B, L, k, **{key: v for key, v in kw.items()
                                          if key != "packed_width"},
                              packed=packed)
        _say(f"any_width_check kernel=extract_keys edge=True B={B} L={L} "
             f"n_bases={k} W={words64(k)} lanes={B * (L - k + 1)} "
             f"canonical={canon} packed={packed} ambiguous={amb} "
             f"lengths={lens} live_lanes={live} body={body['body']} "
             f"iters={body['iters']} blocks={body['blocks']} "
             f"max_abs_err={err}")
        if (live == 0) != (lens == "below_k") or (body["body"] == "row") != (
                k == 1000):
            raise AssertionError(f"K7 edge B={B} L={L} k={k}: live lanes "
                                 f"{live} or body {body['body']} unexpected")
        err_all = max(err_all, err)
    return err_all


def any_width_extract(dev, rng) -> list[dict]:
    """Phase 27a, K7: the multi-word entry at k = 64, 101 and 125 and the
    gapped entry at (27, 27) and (40, 40), c in [80, 140], canonical or
    not, on packed rows and on u8 rows with ambiguous codes and short
    rows, B = 8192, L = 160, and at MULTI_EDGES, bit for bit; each timed
    with its launch, the multi-word entry also at `card`'s batch of 2048
    reads."""
    from kmer_tpu_torch.ops.encode import SENTINEL_KEY, gapped_bases, words64
    from kmer_tpu_torch.ops.extract import gapped_lane_count
    from kmer_tpu_torch.ops.kernels import extract as ek
    err_multi = err_gapped = 0
    for k in ANY_KS:
        for canon in (False, True):
            for packed, amb, short in ((True, False, False),
                                       (False, True, True)):
                on_dev = [t.to(dev) for t in gapped_batch(
                    rng, MAIN_B, MAIN_L, packed=packed, amb=amb, short=short,
                    full_len=READ_LEN)]
                kw = dict(canonical=canon, mask_ambiguous=amb,
                          packed_width=MAIN_L if packed else 0)
                before = ek.multi_launches
                got = ek.extract_keys(*on_dev, k, **kw)
                want = ek.extract_keys_ref(*on_dev, k, **kw)
                torch.cuda.synchronize()
                live = int((want[0] != SENTINEL_KEY).sum())
                err = _check_planes(f"K7 k={k}", got, want,
                                    ek.multi_launches - before)
                _say(f"any_width_check kernel=extract_keys B={MAIN_B} "
                     f"L={MAIN_L} n_bases={k} W={len(got)} "
                     f"canonical={canon} packed={packed} ambiguous={amb} "
                     f"short={short} live_lanes={live} max_abs_err={err}")
                if live == 0:
                    raise AssertionError(f"K7 k={k}: no live lane")
                err_multi = max(err_multi, err)
    err_multi = max(err_multi, multi_word_edges(dev, rng))
    for lr in ((27, 27), (40, 40)):
        win = dict(l_len=lr[0], r_len=lr[1], c_min=GAP["c_min"],
                   c_max=GAP["c_max"])
        for packed, amb, short in ((True, False, False),
                                   (False, True, True)):
            on_dev = [t.to(dev) for t in gapped_batch(
                rng, MAIN_B, MAIN_L, packed=packed, amb=amb, short=short,
                full_len=READ_LEN)]
            kw = dict(mask_ambiguous=amb,
                      packed_width=MAIN_L if packed else 0, **win)
            before = ek.gapped_launches
            got = ek.extract_gapped_keys(*on_dev, **kw)
            want = ek.extract_gapped_keys_ref(*on_dev, **kw)
            torch.cuda.synchronize()
            live = int((want[0] != SENTINEL_KEY).sum())
            err = _check_planes(f"K7 gapped {lr}", got, want,
                                ek.gapped_launches - before)
            _say(f"any_width_check kernel=extract_gapped_keys B={MAIN_B} "
                 f"L={MAIN_L} l_len={lr[0]} r_len={lr[1]} "
                 f"c=[{win['c_min']}, {win['c_max']}] W={len(got)} "
                 f"packed={packed} ambiguous={amb} short={short} "
                 f"live_lanes={live} max_abs_err={err}")
            if live == 0:
                raise AssertionError(f"K7 gapped {lr}: no live lane")
            err_gapped = max(err_gapped, err)

    recs = []
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, ANY_K,
                                            packed=True, amb=False,
                                            short=False)]
    in_bytes = main[0].numel() * 4 + MAIN_B * 8
    card = [t.to(dev) for t in kernel_batch(rng, CARD_B, MAIN_L, ANY_K,
                                            packed=True, amb=False,
                                            short=False)]
    for B, k, rows in [(MAIN_B, k, main) for k in ANY_KS] + [
            (CARD_B, ANY_K, card)]:
        W = words64(k)
        lanes = B * (MAIN_L - k + 1)
        kw = dict(canonical=True, packed_width=MAIN_L)
        ms, plain_ms = time_pair(
            functools.partial(ek.extract_keys, *rows, k, **kw),
            functools.partial(ek.extract_keys_ref, *rows, k, **kw))
        # W int64 words out a lane; each word a forward and a reverse cut
        # (three words and four funnel shifts each), the compare and the
        # store: ~24 operations a word
        b = bound(rows[0].numel() * 4 + B * 8 + lanes * W * 8,
                  lanes * W * 24)
        launch_line(f"extract_keys[multi_word k={k}]", ek, B, MAIN_L, k,
                    canonical=True)
        _say(f"any_width_time kernel=extract_keys variant=multi_word "
             f"B={B} L={MAIN_L} n_bases={k} W={W} canonical=True "
             f"packed=True kernel_ms={ms} plain_ms={plain_ms} "
             f"speedup={plain_ms / ms} "
             f"out_GB_per_s={lanes * W * 8 / (ms * 1e-3) / 1e9} "
             f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
             f"library_ms=None (no single PyTorch call extracts k-mers) "
             f"(tolerance: exact, max_abs_err must be 0)")
        if B == CARD_B:            # `card`'s batch: phase 28a's launches
            recs[0]["cases"] = {f"card_batch_k{k}": dict(
                ms=ms, plain_ms=plain_ms, lanes=lanes, **b)}
        elif k == ANY_K:
            recs.append({"name": "extract_keys[multi_word]", "route": "cuda",
                         "source": ek.SOURCE, "replaces": ek.REPLACES,
                         "max_abs_err": err_multi, "ms": ms,
                         "plain_ms": plain_ms, **b, "library_ms": None})
    for lr in ((27, 27), (40, 40)):
        win = dict(l_len=lr[0], r_len=lr[1], c_min=GAP["c_min"],
                   c_max=GAP["c_max"], packed_width=MAIN_L)
        W = len(gapped_bases(*lr))
        lanes = MAIN_B * gapped_lane_count(MAIN_L, GAP["c_min"],
                                           GAP["c_max"])
        ms, plain_ms = time_pair(
            functools.partial(ek.extract_gapped_keys, *main, **win),
            functools.partial(ek.extract_gapped_keys_ref, *main, **win))
        # the lane's (c, o) (a square root and two fix-up steps), then W
        # words of one or two cuts each: ~60 + 30 W operations a lane
        b = bound(in_bytes + lanes * W * 8, lanes * (60 + 30 * W))
        info = ek.gapped_launch_info(MAIN_B, MAIN_L, **{
            k_: v for k_, v in win.items() if k_ != "packed_width"})
        _say(f"launch kernel=extract_gapped_keys[{lr[0]}/{lr[1]}] "
             f"B={MAIN_B} L={MAIN_L} "
             + " ".join(f"{k_}={v}" for k_, v in info.items())
             + f" threads_launched={info['threads'] * info['blocks']}")
        _say(f"any_width_time kernel=extract_gapped_keys l_len={lr[0]} "
             f"r_len={lr[1]} c=[{GAP['c_min']}, {GAP['c_max']}] "
             f"B={MAIN_B} L={MAIN_L} lanes={lanes} W={W} packed=True "
             f"kernel_ms={ms} plain_ms={plain_ms} "
             f"speedup={plain_ms / ms} "
             f"out_GB_per_s={lanes * W * 8 / (ms * 1e-3) / 1e9} "
             f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
             f"library_ms=None (no single PyTorch call extracts gapped "
             f"chunks) (tolerance: exact, max_abs_err must be 0)")
        if lr == (40, 40):
            recs.append({"name": "extract_gapped_keys", "route": "cuda",
                         "source": ek.SOURCE, "replaces": ek.REPLACES,
                         "max_abs_err": err_gapped, "ms": ms,
                         "plain_ms": plain_ms, **b, "library_ms": None})
    return recs


def any_width_sort(dev, rng) -> dict:
    """Phase 27a, K6 at the k = 101 device merge's 5 planes (4 key words
    with the general layout's bits and the counts as payload): a 2**23-row
    sorted unique state and 2**22 lanes of K7's output, bit for bit, timed
    beside its plain version and torch.sort of one word."""
    from kmer_tpu_torch.ops import count as count_ops
    from kmer_tpu_torch.ops.encode import plane_bits
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import sort as sk
    gen = torch.Generator(device=dev).manual_seed(101)
    sent = sk.SENTINEL
    bits = plane_bits(ANY_K)
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, ANY_K,
                                            packed=True, amb=False,
                                            short=False)]
    planes = [p.reshape(-1) for p in ek.extract_keys(
        *main, ANY_K, canonical=True, packed_width=MAIN_L)]
    words, counts = count_ops.grouped_count(planes, 256)
    n_state, n_batch = 1 << 23, 1 << 22
    reps = -(-n_batch // counts.numel())
    bc = counts.to(torch.int64).repeat(reps)[:n_batch]
    state = sk.sort_words_ref([torch.randint(0, 1 << b, (n_state // 2,),
                                             generator=gen, device=dev)
                               for b in bits])
    rows = []
    for s_w, b_w in zip(state, words):
        pad = torch.full((n_state - s_w.numel(),), sent, device=dev)
        b_w = b_w.repeat(reps)[:n_batch]
        rows.append(torch.cat([s_w, pad, torch.where(bc > 0, b_w, sent)]))
    rows.append(torch.cat([torch.randint(1, 50, (n_state // 2,),
                                         generator=gen, device=dev),
                           torch.zeros(n_state - n_state // 2,
                                       dtype=torch.int64, device=dev), bc]))
    before = sk.launches
    got = sk.sort_words([w.clone() for w in rows], len(bits), bits)
    want = sk.sort_words_ref(rows, len(bits), bits)
    torch.cuda.synchronize()
    err = _check_planes("K6 k101 merge", got, want, sk.launches - before)
    del got, want
    n, W = rows[0].numel(), len(rows)
    _say(f"any_width_check kernel=sort_words case=k101_merge W={W} N={n} "
         f"num_keys={len(bits)} bits={bits} launches=1 max_abs_err={err}")
    reps_, inner = 3, 1
    copies = iter([[w.clone() for w in rows] for _ in range(5 + reps_)])
    plain = functools.partial(sk.sort_words_ref, rows, len(bits), bits)
    p1 = time_ms(plain, reps=reps_, inner=inner)
    ms = time_ms(lambda: sk.sort_words(next(copies), len(bits), bits),
                 reps=reps_, inner=inner)
    p2 = time_ms(plain, reps=reps_, inner=inner)
    plain_ms = min(p1, p2)
    del copies
    library_ms = time_ms(functools.partial(torch.sort, rows[0]),
                         reps=reps_, inner=inner)
    # one read and one write of N rows of W words; N log2 N row
    # comparisons of the key words
    b = bound(2 * n * W * 8, n * math.ceil(math.log2(n)) * len(bits))
    info = sk.launch_info(n, W, len(bits), bits)
    _say("sort_launch case=k101_merge " + json.dumps(info))
    _say(f"any_width_time kernel=sort_words case=k101_merge W={W} N={n} "
         f"num_keys={len(bits)} bits={bits} levels={info['levels']} "
         f"kernel_ms={ms} plain_ms={plain_ms} speedup={plain_ms / ms} "
         f"library_ms={library_ms} (torch.sort, one word) "
         f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
         f"GB_per_s={2 * n * W * 8 / (ms * 1e-3) / 1e9} "
         f"(tolerance: exact, max_abs_err must be 0)")
    return {"name": "sort_words[k101_merge]", "route": "cuda",
            "source": sk.SOURCE, "replaces": sk.REPLACES,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}


def any_width_grouped(dev, rng) -> dict:
    """Phase 27a, K2a, K2b and K2c at W = 4 and 5: K7's k = 101 keys (W =
    4) and random 5-word rows, in groups of 256 rows (K2a, K2b) and in
    strided columns of 16 (K2c), bit for bit, timed with their launches;
    W = 5 takes K2a's plane loop and the index bodies.  Then the index
    bodies at W = 5 and 7 on word-0 ties and unaligned planes, and timed
    on K7's k = 130 keys of one main batch."""
    from kmer_tpu_torch.ops.encode import SENTINEL_KEY
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import grouped_count as gk
    gen = torch.Generator(device=dev).manual_seed(27)
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, ANY_K,
                                            packed=True, amb=False,
                                            short=False)]
    k101 = [p.reshape(-1) for p in ek.extract_keys(
        *main, ANY_K, canonical=True, packed_width=MAIN_L)]
    n = k101[0].numel() // 4096 * 4096        # whole groups, whole columns
    five = [p[:n] for p in k101] + [torch.randint(0, 1 << 14, (n,),
                                                  generator=gen, device=dev)]
    # every row twice, so that runs are longer than one
    five = [p.view(-1, 2)[:, :1].expand(-1, 2).reshape(-1) for p in five]
    by_w = {4: five[:4], 5: five}
    recs = {}
    for W, planes in by_w.items():
        rows2d = [p.view(-1, 256) for p in planes]
        cols = [p.view(16, -1) for p in planes]
        sorted_rows = gk.sort_groups(rows2d)
        for key, fn, ref, args, counter in (
                ("a", gk.run_lengths_grouped, gk.run_lengths_grouped_ref,
                 sorted_rows, "run_lengths_launches"),
                ("b", gk.grouped_count, gk.grouped_count_ref, rows2d,
                 "grouped_launches"),
                ("c", gk.grouped_count_strided, gk.grouped_count_strided_ref,
                 cols, "strided_launches")):
            before = getattr(gk, counter)
            got = fn(args)
            want = ref(args)
            got = list(got[0]) + [got[1]] if key != "a" else [got]
            want = list(want[0]) + [want[1]] if key != "a" else [want]
            torch.cuda.synchronize()
            err = _check_planes(f"K2{key} W={W}", got, want,
                                getattr(gk, counter) - before)
            ms, plain_ms = time_pair(functools.partial(fn, args),
                                     functools.partial(ref, args))
            m = 256 if key != "c" else 16
            # keys in (and sorted keys out for K2b/K2c) and int32 counts;
            # one W-word compare a row for K2a, the sort network's W-word
            # compare-exchanges for K2b (bitonic) and K2c (odd-even)
            lg = int(math.log2(m))
            ce = (n if key == "a" else n // 2 * lg * (lg + 1) // 2
                  if key == "b" else n // m * ((lg * lg - lg + 4) * m // 4
                                               - 1))
            b = bound((1 if key == "a" else 2) * n * W * 8 + n * 4, ce * W)
            body = ("flat" if key == "a" else gk.launch_info(
                *((args[0].shape[1], 16) if key == "c"
                  else args[0].shape), W, strided=key == "c")["body"])
            _say(f"any_width_time kernel=K2{key} W={W} shape="
                 f"{tuple(args[0].shape)} body={body} kernel_ms={ms} "
                 f"plain_ms={plain_ms} speedup={plain_ms / ms} "
                 f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
                 f"library_ms=None (no single PyTorch call gives grouped "
                 f"run lengths) max_abs_err={err} (tolerance: exact, "
                 f"max_abs_err must be 0)")
            name = {"a": "run_lengths_grouped", "b": "grouped_count",
                    "c": "grouped_count_strided"}[key]
            recs[(key, W)] = {
                "name": f"{name}[W={W}]", "route": "cuda",
                "source": gk.SOURCE,
                "replaces": {"a": gk.REPLACES_RUN_LENGTHS,
                             "b": gk.REPLACES_GROUPED,
                             "c": gk.REPLACES_STRIDED}[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                "library_ms": None, "body": body}

    def sort_case(label, key, planes, m):
        """K2b (key "b", groups of m rows) or K2c ("c", columns of m) on
        flat planes, bit for bit; returns (the launch's body, the
        kernel and the plain version as calls, the shaped planes)."""
        strided = key == "c"
        shaped = [p.view(m, -1) if strided else p.view(-1, m)
                  for p in planes]
        fn = gk.grouped_count_strided if strided else gk.grouped_count
        ref = (gk.grouped_count_strided_ref if strided
               else gk.grouped_count_ref)
        counter = "strided_launches" if strided else "grouped_launches"
        before = getattr(gk, counter)
        got_s, got_c = fn(shaped)
        want_s, want_c = ref(shaped)
        torch.cuda.synchronize()
        _check_planes(label, list(got_s) + [got_c], list(want_s) + [want_c],
                      getattr(gk, counter) - before)
        G = shaped[0].shape[1 if strided else 0]
        body = gk.launch_info(G, m, len(planes), strided=strided)["body"]
        return (body, functools.partial(fn, shaped),
                functools.partial(ref, shaped), shaped)

    # the index bodies at W = 5 and 7: word 0 from two values (the later
    # words decide), unaligned planes, G odd
    for W in (5, 7):
        for key, m in (("b", 256), ("c", 16)):
            n_e = 256 * 33
            ties = [torch.randint(0, 3, (n_e + 1,), generator=gen,
                                  device=dev) for _ in range(W)]
            ties[0] = torch.randint(0, 2, (n_e + 1,), generator=gen,
                                    device=dev)
            for label, planes in (("word0_ties", [p[:n_e] for p in ties]),
                                  ("unaligned", [p[1:] for p in ties])):
                body = sort_case(f"K2{key} W={W} {label}", key, planes,
                                 m)[0]
                _say(f"any_width_check kernel=K2{key} W={W} m={m} "
                     f"case={label} body={body} max_abs_err=0")
    # K7's k = 130 keys of one main batch (W = 5, dead lanes SENTINEL in
    # every word), in whole groups of 256 rows
    k130 = [p.reshape(-1) for p in ek.extract_keys(
        *[t.to(dev) for t in kernel_batch(np.random.default_rng(130),
                                          MAIN_B, MAIN_L, 130, packed=True,
                                          amb=False, short=False)],
        130, canonical=True, packed_width=MAIN_L)]
    pad = -k130[0].numel() % 256
    k130 = [torch.cat([p, torch.full((pad,), SENTINEL_KEY, device=dev)])
            for p in k130]
    n130 = k130[0].numel()
    for key, m in (("b", 256), ("c", 16)):
        body, kern, plain, shaped = sort_case(f"K2{key} k=130", key, k130,
                                              m)
        ms, plain_ms = time_pair(kern, plain)
        lg = int(math.log2(m))
        ce = (n130 // 2 * lg * (lg + 1) // 2 if key == "b"
              else n130 // m * ((lg * lg - lg + 4) * m // 4 - 1))
        b = bound(2 * n130 * 5 * 8 + n130 * 4, ce * 5)
        _say(f"any_width_time kernel=K2{key} W=5 k=130 shape="
             f"{tuple(shaped[0].shape)} body={body} kernel_ms={ms} "
             f"plain_ms={plain_ms} bound_ms={b['bound_ms']} "
             f"bound_by={b['bound_by']} max_abs_err=0 (tolerance: exact)")
        recs[(key, 5)]["k130"] = {"shape": list(shaped[0].shape),
                                  "body": body, "ms": ms,
                                  "plain_ms": plain_ms,
                                  "bound_ms": b["bound_ms"]}
    return recs


def any_width_compact(dev, rng) -> dict:
    """Phase 27a, K4 on records of 3 and 4 words: K7's k = 64 and k = 101
    keys, counted by the grouped dedup, bit for bit (records in lane
    order and the total), timed beside torch.masked_select of one plane."""
    from kmer_tpu_torch.ops import count as count_ops
    from kmer_tpu_torch.ops.kernels import compact as ck
    from kmer_tpu_torch.ops.kernels import extract as ek
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, 64,
                                            packed=True, amb=False,
                                            short=False)]
    recs = {}
    for k in (64, ANY_K):
        planes = [p.reshape(-1) for p in ek.extract_keys(
            *main, k, canonical=True, packed_width=MAIN_L)]
        words, counts = count_ops.grouped_count(planes, 256)
        before = ck.launches
        got = ck.compact(words, counts)
        want = ck.compact_ref(words, counts)
        torch.cuda.synchronize()
        t = int(want[2][0])
        err = _check_planes(f"K4 W={len(words)}",
                            [got[0][:t], got[1][:t], got[2]],
                            [want[0][:t], want[1][:t], want[2]],
                            ck.launches - before)
        ms, plain_ms = time_pair(functools.partial(ck.compact, words, counts),
                                 functools.partial(ck.compact_ref, words,
                                                   counts))
        live = counts > 0
        library_ms = time_ms(functools.partial(torch.masked_select, words[0],
                                               live))
        n, W = counts.numel(), len(words)
        # counts in, live keys in; records (W words and a count) out
        b = bound(n * 4 + t * W * 8 + t * (W + 1) * 8, n * 4)
        _say(f"any_width_time kernel=compact W={W} n_bases={k} lanes={n} "
             f"live={t} kernel_ms={ms} plain_ms={plain_ms} "
             f"speedup={plain_ms / ms} library_ms={library_ms} "
             f"(torch.masked_select of one key plane: a yardstick) "
             f"bound_ms={b['bound_ms']} bound_by={b['bound_by']} "
             f"max_abs_err={err} (tolerance: exact, max_abs_err must be 0)")
        recs[W] = {"name": f"compact[W={W}]", "route": "cuda",
                   "source": ck.SOURCE, "replaces": ck.REPLACES,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                   "library_ms": library_ms}
    return recs


def any_width_gapped(dev, gpath: str, gsmall: str, gtable) -> dict:
    """Phase 27c and d: gapped l = r = 40, c in [80, 140] on the first
    GAP_WIDE_RECORDS records of phase 6's corpus by the default route
    (K7's gapped lanes, the grouped dedup), the compact one (K4 on 3-word
    records), the device merge (K6 on 4 planes) and sort_group_keys = 0
    (K6 a batch): the tables equal, the total every (c, o) chunk, the
    first 300 records' table equal to the CPU's; then phase 6's 27/27
    corpus under KMER_TPU_GAPPED_STEP=legacy equal to phase 6's table,
    and the parity md5 on that route.  Returns (the launches of each run,
    the 40/40 table's digest, the file of its records)."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.io.fasta import parse_seqs
    from kmer_tpu_torch.pipeline.parity import SAMPLE_FASTA_MD5, parity_dump
    from kmer_tpu_torch.utils import stagetime
    cfg = KmerConfig(gapped=True, batch_reads=GAP_B, max_read_len=512,
                     **GAP_WIDE)
    t0 = time.perf_counter()
    want_small = count_fasta(gsmall, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    got_small = count_fasta(gsmall, cfg, device=dev)
    if not (got_small == want_small and got_small.total > 0):
        raise AssertionError("gapped 40/40 on the card != on the CPU "
                             f"({GAP_ORACLE_RECORDS} records)")
    _say(f"any_width_gapped_cpu_check records={GAP_ORACLE_RECORDS} "
         f"distinct={got_small.num_distinct} total={got_small.total} "
         f"equal=True cpu_s={cpu_s}")
    with open(gpath) as f:
        records = f.read().split(">")[1:GAP_WIDE_RECORDS + 1]
    wpath = os.path.join(os.path.dirname(gpath), "gapped_wide.fasta")
    with open(wpath, "w") as f:
        f.write("".join(">" + r for r in records))
    lens = np.diff(parse_seqs(wpath)[1])
    c = np.arange(GAP_WIDE["c_min"], GAP_WIDE["c_max"] + 1)
    want_total = int(np.maximum(lens[:, None] - c[None, :] + 1, 0).sum())
    batches = -(-GAP_WIDE_RECORDS // GAP_B)
    runs = [("default", {}, {}, {"k7_gapped": batches, "k3": 0}),
            ("compact", {}, dict(compact=True),
             {"k7_gapped": batches, "k4": batches}),
            ("device_merge", {}, dict(device_merge="on"),
             {"k7_gapped": batches, "k6": -1}),
            ("sort_group_keys=0", {}, dict(sort_group_keys=0),
             {"k7_gapped": batches, "k6": batches})]
    ref, seen = None, {}
    for name, env, change, want in runs:
        times: dict[str, float] = {}
        with _env(**env), _merge_probe() as probe:
            with stagetime.collect(times):
                table, got = _run_counted(lambda: count_fasta(
                    wpath, cfg.replace(**change), device=dev))
        ref = table if ref is None else ref
        bad = {c: got[c] for c, n in want.items()
               if (got[c] == 0 if n < 0 else got[c] != n)}
        if table != ref or bad or table.total != want_total:
            raise AssertionError(f"gapped 40/40 {name}: table differs, "
                                 f"total {table.total} != {want_total}, "
                                 f"or launches {bad} wrong")
        seen[name] = got
        wall = times["total"]
        _say(f"any_width_gapped run={name} records={GAP_WIDE_RECORDS} "
             f"l_len=40 r_len=40 chunks={table.total} "
             f"distinct={table.num_distinct} "
             f"equal_to_first=True launches="
             f"{json.dumps({c: n for c, n in got.items() if n})} "
             f"wall_s={wall} chunks_per_s={table.total / wall}"
             + (f" {probe.line()}" if probe.states else ""))
        _say(f"any_width_gapped_{name}_stages_s "
             + json.dumps(times, sort_keys=True))
    digest = table_digest(ref)
    del ref, table
    # (d) the gapped unfused route at the reference's windows
    times = {}
    with _env(KMER_TPU_GAPPED_STEP="legacy"):
        with stagetime.collect(times):
            table, got = _run_counted(lambda: count_fasta(
                gpath, KmerConfig(gapped=True, batch_reads=GAP_B,
                                  max_read_len=512), device=dev))
        if (table != gtable or got["k3"]
                or got["k7_gapped"] != -(-GAP_RECORDS // GAP_B)):
            raise AssertionError("gapped 27/27 legacy table != phase 6's, "
                                 f"or launches {got} wrong")
        _say(f"any_width_gapped run=legacy_27_27 equal_to_phase_6=True "
             f"launches={json.dumps({c: n for c, n in got.items() if n})} "
             f"wall_s={times['total']} "
             f"chunks_per_s={table.total / times['total']}")
        _say("any_width_gapped_legacy_27_27_stages_s "
             + json.dumps(times, sort_keys=True))
        path = os.path.join(REPO, "tests", "data", "sample.fasta")
        t0 = time.perf_counter()
        dump, got = _run_counted(lambda: parity_dump(path, device=dev))
        wall = time.perf_counter() - t0
        md5 = hashlib.md5(dump).hexdigest()
        _say(f"parity mode=count_expand route=legacy md5={md5} "
             f"launches={json.dumps({c: n for c, n in got.items() if n})} "
             f"wall_s={wall}")
        if md5 != SAMPLE_FASTA_MD5 or got["k3"] or not got["k7_gapped"]:
            raise AssertionError(f"parity on the unfused route: md5 {md5} "
                                 f"!= {SAMPLE_FASTA_MD5}, or launches {got}")
    seen["legacy_27_27"] = got
    return seen, digest, wpath


def any_width_unfused_small(dev, small: str) -> dict:
    """Phase 27e: the grouped kernels on the count path at W = 4 (k =
    101) and W = 5 (k = 130) on the 50,000-read oracle file --
    KMER_TPU_GROUPED=hybrid (K2a), pallas (K2b) and KMER_TPU_STEP=t
    (K2c) -- k = 64 and 101 compacted (K4 on 3- and 4-word records) and
    k = 101 at sort_group_keys = 0 (K6 a batch), each table against the
    numpy oracle.  Returns each run's launches."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    seen = {}
    for k in (ANY_K, 130, 64):
        want_keys, want_counts = oracle_keys(small, tuple(range(k)), True)
        cfg = KmerConfig(k=k, canonical=True)
        batches = -(-ORACLE_READS // cfg.batch_reads)
        # compact caps keys at 111 bases, as in kmer_tpu
        runs = [] if k > 111 else [("compact", {}, cfg.replace(compact=True),
                                    {"k7_multi": batches, "k4": batches})]
        if k == ANY_K:
            runs.append(("sort_group_keys=0", {}, cfg.replace(
                sort_group_keys=0), {"k7_multi": batches, "k6": batches}))
        runs += [] if k == 64 else [
            ("grouped=hybrid", dict(KMER_TPU_STEP="legacy",
                                    KMER_TPU_GROUPED="hybrid"), cfg,
             {"k7_multi": batches, "k2a": batches}),
            ("grouped=pallas", dict(KMER_TPU_STEP="legacy",
                                    KMER_TPU_GROUPED="pallas"), cfg,
             {"k7_multi": batches, "k2b": batches}),
            ("step=t", dict(KMER_TPU_STEP="t"), cfg,
             {"k7_multi": batches, "k2c": batches})]
        for label, env, run_cfg, want in runs:
            with _env(**env):
                t0 = time.perf_counter()
                table, got = _run_counted(
                    lambda: count_fasta(small, run_cfg, device=dev))
                wall = time.perf_counter() - t0
            equal = (np.array_equal(table_pairs(table), want_keys)
                     and np.array_equal(table.counts, want_counts))
            _say(f"any_width_small k={k} run={label} reads={ORACLE_READS} "
                 f"equal_to_oracle={equal} launches="
                 f"{json.dumps({c: n for c, n in got.items() if n})} "
                 f"wall_s={wall}")
            bad = {c: got[c] for c, n in want.items() if got[c] != n}
            if not equal or bad:
                raise AssertionError(f"k={k} {label}: table != numpy "
                                     f"oracle, or launches {bad} wrong")
            seen[(k, label)] = got
    return seen


def phase_any_width(dev, path: str, small: str, gpath: str, gtable,
                    seed: int) -> list[dict]:
    """Phase 27, keys of any width: (a) each widened kernel against its
    plain version and timed; (b) k = 101 canonical on phase 4's corpus by
    the default route and the device merge; (c, d) any_width_gapped; (e)
    any_width_unfused_small.  Returns the widened kernels' JSON rows, with
    their launches on these paths, and what phase 28 reads: the k = 101
    table's digest and distinct count, the gapped 40/40 file and its
    table's digest."""
    from kmer_tpu_torch import KmerConfig
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 27)
    k7_multi, k7_gapped = any_width_extract(dev, rng)
    k6 = any_width_sort(dev, rng)
    k2 = any_width_grouped(dev, rng)
    k4 = any_width_compact(dev, rng)
    torch.cuda.empty_cache()
    _say(f"any_width_kernels_s={time.perf_counter() - t0}")

    # (b) runs the default route and the device merge only: compact and
    # sort_group_keys = 0 are each a host merge of 50 M four-column keys
    # by np.lexsort, ~80 s of wall (PERF.md §5); the 50,000-read runs of
    # (e) take those routes
    batches = -(-N_READS // KmerConfig().batch_reads)
    runs = [("default", {}, {}, {"k7_multi": batches, "k1": 0}),
            ("device_merge", {}, dict(device_merge="on"),
             {"k7_multi": batches, "k6": -1})]
    seen, k101 = phase_wide_end_to_end(dev, path, small, f"k{ANY_K}",
                                       KmerConfig(k=ANY_K, canonical=True),
                                       runs)
    info = dict(k101_digest=table_digest(k101),
                k101_distinct=k101.num_distinct)
    del k101
    gsmall = os.path.join(os.path.dirname(gpath), "gapped_small.fasta")
    gapped, info["gwide_digest"], info["gwide_path"] = any_width_gapped(
        dev, gpath, gsmall, gtable)
    small_runs = any_width_unfused_small(dev, small)
    k7_multi["launches"] = seen["default"]["k7_multi"]
    k7_gapped["launches"] = gapped["default"]["k7_gapped"]
    k6["launches"] = seen["device_merge"]["k6"]
    k4[4]["launches"] = small_runs[(ANY_K, "compact")]["k4"]
    k4[3]["launches"] = small_runs[(64, "compact")]["k4"]
    for (key, W), rec in k2.items():
        label = {"a": "grouped=hybrid", "b": "grouped=pallas",
                 "c": "step=t"}[key]
        rec["launches"] = small_runs[({4: ANY_K, 5: 130}[W], label)][
            "k2" + key]
    _say(f"any_width_phase_s={time.perf_counter() - t0}")
    return [k7_multi, k7_gapped, k6, *k2.values(), k4[3], k4[4]], info


# phase 28: wide keys on streaming, `card` and the mesh -- contiguous keys
# over 63 bases and gapped windows over 31 on the paths that took at most
# two int64 words, with K5 hashing keys of W planes

CARD_B = 2048                 # `card`'s batch (phases 12 and 23)
WIDE_HLL_KS = (64, ANY_K, 130)
# K5's plane-mode edges (phase 28a): (lanes, k) -- lane counts no multiple
# of 32, W = 3 to 6 (the body that holds a key's words in registers) and
# W = 9 at k = 250 (the one that loads them in turn)
HLL_EDGES = [(1, 130), (31, ANY_K), (70_001, 64), (70_001, ANY_K),
             (70_001, 130), (33_333, 160), (33_333, 250)]
# phase 28c's (4, 1) run counts the first 200,000 reads of phase 4's
# corpus: its owners' pairs merge on the host, by np.lexsort past two
# fused columns (~93 s on all 1M reads, phase 27b)
MESH_WIDE_READS = 200_000


def wide_hll_kernel(dev, seed: int) -> dict:
    """Phase 28a's kernel check: K5's plane mode against its plain
    version, bit for bit, on K7's canonical keys of one `card` batch
    (2048 reads at L = 160) at k = 64, 101 and 130 (W = 3, 4, 5), each
    timed with its grid and registers; then a stream of sentinel lanes
    only and an empty one, and random keys and weights at HLL_EDGES.
    Returns the k = 101 row (the `card` path's shape) with the other
    widths under `cases`."""
    from kmer_tpu_torch.ops.encode import SENTINEL_KEY, word_bases, words64
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import histogram as hk
    rng = np.random.default_rng(seed + 28)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {"name": "hll_class_histogram_planes", "route": "cuda",
           "source": hk.SOURCE, "replaces": hk.REPLACES, "max_abs_err": 0,
           "library_ms": None, "cases": {}}
    for k in WIDE_HLL_KS:
        host = kernel_batch(rng, CARD_B, MAIN_L, k, packed=True, amb=False,
                            short=False)
        planes = ek.extract_keys(*(t.to(dev) for t in host), k,
                                 canonical=True, packed_width=MAIN_L)
        w = (planes[0] != SENTINEL_KEY).to(torch.int8)
        kernel = functools.partial(hk.hll_class_histogram, planes, w, k=k,
                                   b=10)
        plain = functools.partial(hk.hll_class_histogram_ref, planes, w,
                                  k=k, b=10)
        before = hk.launches
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if (err or hk.launches != before + 1
                or int(got.sum()) != int(w.sum())):
            raise AssertionError(f"K5 plane mode != plain version at k={k}")
        ms, plain_ms = time_pair(kernel, plain)
        # weights in, each live lane's W key words in, 2**15 int64 bins
        # out; one add a lane, and a live lane's hash: 9 operations a
        # 32-bit word (phase 8's count), 6 for bucket and rho, and 2 a
        # plane to shift it into the funnel
        W, lanes, live = len(planes), w.numel(), int(w.sum())
        words = (2 * k + 1 + 31) // 32
        bd = bound(lanes + live * 8 * W + (8 << 15),
                   lanes + live * (9 * words + 6 + 2 * W))
        grid = hk.plan(lanes, 15, sms)
        regs, spill = hk.attributes(3, W)
        case = dict(ms=ms, plain_ms=plain_ms, lanes=lanes, live=live,
                    planes=W, grid=f"{grid.clusters}x{grid.cluster}",
                    smem_bytes=grid.smem, regs=regs, spill_bytes=spill,
                    **bd)
        rec["cases"][f"card_k{k}_b10"] = case
        _say(f"histogram_planes_check k={k} planes={W} lanes={lanes} "
             f"live={live} max_abs_err={err} kernel_ms={ms} "
             f"plain_ms={plain_ms} speedup={plain_ms / ms} "
             f"bound_ms={bd['bound_ms']} bound_by={bd['bound_by']} "
             f"grid={case['grid']} (clusters x blocks) "
             f"smem_bytes={grid.smem} regs={regs} spill_bytes={spill} "
             "(tolerance: exact)")
        if W != words64(k):
            raise AssertionError(f"K7 gave {W} planes at k={k}")
    main = rec["cases"][f"card_k{ANY_K}_b10"]
    rec.update({key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by")})
    for k in WIDE_HLL_KS:
        W = words64(k)
        dead = tuple(torch.full((70_001,), SENTINEL_KEY, dtype=torch.int64,
                                device=dev) for _ in range(W))
        before = hk.launches
        got = hk.hll_class_histogram(dead, torch.zeros(
            70_001, dtype=torch.int8, device=dev), k=k, b=10)
        empty = hk.hll_class_histogram(
            tuple(p[:0] for p in dead),
            torch.zeros(0, dtype=torch.int8, device=dev), k=k, b=10)
        torch.cuda.synchronize()
        if (hk.launches != before + 1 or int(got.abs().sum())
                or int(empty.abs().sum())):
            raise AssertionError(f"K5 plane mode on sentinel lanes only or "
                                 f"an empty stream (k={k}) added or "
                                 "launched wrongly")
    _say("histogram_planes_check sentinel_only=zeros empty=no_launch "
         f"ks={list(WIDE_HLL_KS)}")
    for n, k in HLL_EDGES:
        keys = [rng.integers(0, 1 << (2 * nb), n) if nb < 32 else
                rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
                for nb in word_bases(k)]
        w = rng.integers(-3, 4, n).astype(np.int8)
        dead = rng.random(n) < 0.1
        w[dead] = 0
        for p in keys:
            p[dead] = SENTINEL_KEY
        planes = tuple(torch.from_numpy(p).to(dev) for p in keys)
        w = torch.from_numpy(w).to(dev)
        before = hk.launches
        got = hk.hll_class_histogram(planes, w, k=k, b=10)
        want = hk.hll_class_histogram_ref(planes, w, k=k, b=10)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        regs, spill = hk.attributes(3, len(planes))
        _say(f"histogram_planes_check edge=True k={k} planes={len(planes)} "
             f"lanes={n} max_abs_err={err} regs={regs} spill_bytes={spill} "
             "(tolerance: exact)")
        if err or hk.launches != before + 1 or int(got.sum()) != int(
                w.sum()):
            raise AssertionError(f"K5 plane mode != plain version at "
                                 f"{n} lanes, k={k}")
    return rec


def wide_card(dev, path: str, small: str, exact_distinct: int) -> int:
    """Phase 28a: `card` at k = 101, canonical: the class histogram on
    the 50,000-read file equal to the plain version's; phase 4's corpus
    (489 batches of K7 -> K5) within 15% of phase 27's exact distinct
    count; `card -k 21 -k 101` through cli.main on the 50,000-read file
    (K1, K7 and K5 a batch, the same numbers as the estimator).  Returns
    K5's launches in the corpus run."""
    from kmer_tpu_torch import KmerConfig
    from kmer_tpu_torch.pipeline.sketch import (estimate_distinct_multi_k,
                                                sketch_histograms)
    cfg = KmerConfig(k=ANY_K, canonical=True, batch_reads=CARD_B)
    t0 = time.perf_counter()
    got, _ = sketch_histograms(small, [ANY_K], cfg, device=dev)
    t1 = time.perf_counter()
    want, _ = sketch_histograms(small, [ANY_K], cfg, device="cpu")
    if not np.array_equal(got[ANY_K], want[ANY_K]):
        raise AssertionError(f"card k={ANY_K} class histogram on the card "
                             f"!= the plain version's ({ORACLE_READS} reads)")
    _say(f"card_check k={ANY_K} reads={ORACLE_READS} histogram_equal=True "
         f"sum={int(got[ANY_K].sum())} card_s={t1 - t0} "
         f"cpu_s={time.perf_counter() - t1}")
    k5 = phase_wide_card(dev, path, f"k={ANY_K}", cfg, exact_distinct,
                         "k7_multi")
    argv = ["card", small, "-k", str(K), "-k", str(ANY_K), "--canonical",
            "--batch-reads", str(CARD_B), "--device", "cuda"]
    t0 = time.perf_counter()
    out, got = _run_counted(lambda: _cli(argv))
    secs = time.perf_counter() - t0
    est = estimate_distinct_multi_k(small, [K, ANY_K], cfg, device=dev)
    want = "".join(f"k={kk}\tdistinct_estimate\t{round(e)}\n"
                   f"k={kk}\ttotal_kmers\t{t}\n"
                   for kk, (e, t) in zip((K, ANY_K), est))
    batches = -(-ORACLE_READS // CARD_B)
    if not (out == want and got["k1"] == batches
            and got["k7_multi"] == batches and got["k5"] == 2 * batches):
        raise AssertionError(f"card -k {K} -k {ANY_K}: {out!r} != {want!r}, "
                             f"or launches {_launched(got)} wrong")
    _say(f"card_cli ks={K},{ANY_K} reads={ORACLE_READS} "
         f"equal_to_estimator=True launches={json.dumps(_launched(got))} "
         f"s={secs} " + json.dumps(out))
    return k5


def wide_streaming(dev, path: str, small: str, k101_digest: str,
                   gwide_path: str, gwide_digest: str, tmp: str) -> None:
    """Phase 28b: streaming at k = 101 canonical on phase 4's corpus
    through the device merge (K7 -> the grouped dedup -> K6), paused
    after a third of the batches and resumed by a fresh counter: phase
    27b's table by digest; the per-batch route at k = 101 on the
    50,000-read file against the numpy oracle, and `count --two-pass` of
    it through cli.main; gapped 40/40 by both routes on phase 27c's 1000
    records: 27c's table."""
    from kmer_tpu_torch import KmerConfig
    cfg = KmerConfig(k=ANY_K, canonical=True, device_merge="on",
                     partitions=STREAM_PARTS)
    batches = -(-N_READS // cfg.batch_reads)
    table, rec = stream_run(dev, path, cfg, os.path.join(tmp, "spill_w"),
                            pause_after=batches // 3)
    launches = rec["launches"]
    digest = table_digest(table)
    total = N_READS * (READ_LEN - ANY_K + 1)
    if not (digest == k101_digest and table.total == total
            and launches.get("k7_multi") == rec["batches"] == batches
            and launches.get("k6", 0) >= rec["drains"] >= 1):
        raise AssertionError(f"streaming k={ANY_K} (device merge) table != "
                             f"phase 27b's, or launches wrong: {rec}")
    _stream_say(f"stream_k{ANY_K}_devmerge", rec, equal_to_phase27b=True,
                reads=N_READS, kmers=total, distinct=table.num_distinct,
                digest=digest)
    del table

    want_keys, want_counts = oracle_keys(small, tuple(range(ANY_K)), True)
    table, rec = stream_run(dev, small, cfg.replace(device_merge="off"),
                            os.path.join(tmp, "spill_w_small"),
                            pause_after=3)
    if not (np.array_equal(table_pairs(table), want_keys)
            and np.array_equal(table.counts, want_counts)
            and rec["launches"].get("k7_multi") == rec["batches"]):
        raise AssertionError(f"streaming k={ANY_K} per batch != numpy "
                             f"oracle ({ORACLE_READS} reads): {rec}")
    _stream_say(f"stream_k{ANY_K}_batches", rec, equal_to_oracle=True,
                reads=ORACLE_READS, distinct=table.num_distinct)
    argv = ["count", small, "-k", str(ANY_K), "--canonical", "--two-pass",
            "--spill-dir", os.path.join(tmp, "spill_w_cli"), "--device",
            "cuda"]
    _cli_tsv_equal(f"count --two-pass -k {ANY_K}", argv, table, tmp,
                   ("k7_multi",))

    gcfg = KmerConfig(gapped=True, batch_reads=GAP_B, max_read_len=512,
                      partitions=STREAM_PARTS, **GAP_WIDE)
    gbatches = -(-GAP_WIDE_RECORDS // GAP_B)
    for route in ("off", "on"):
        table, rec = stream_run(dev, gwide_path,
                                gcfg.replace(device_merge=route),
                                os.path.join(tmp, f"spill_g40_{route}"),
                                pause_after=gbatches // 2)
        launches = rec["launches"]
        if not (table_digest(table) == gwide_digest
                and launches.get("k7_gapped") == gbatches
                and not launches.get("k3")
                and (route == "off") == ("k6" not in launches)):
            raise AssertionError(f"streaming gapped 40/40 ({route}) != "
                                 f"phase 27c's table, or launches: {rec}")
        _stream_say(f"stream_g40_devmerge_{route}", rec,
                    equal_to_phase27c=True, records=GAP_WIDE_RECORDS,
                    chunks=table.total)


def _cli_tsv_equal(label: str, argv: list[str], want_table, tmp: str,
                   kernels) -> None:
    """cli.main(argv) on the card, its stdout to a file: the bytes of
    want_table's TSV, each of `kernels` launched."""
    out, want = os.path.join(tmp, "cli.tsv"), os.path.join(tmp, "want.tsv")
    t0 = time.perf_counter()
    _, got = _run_counted(lambda: _cli(argv, out=out))
    secs = time.perf_counter() - t0
    with open(want, "wb") as f:
        want_table.write_tsv(f)
    with open(out, "rb") as a, open(want, "rb") as b:
        equal = a.read() == b.read()
    os.remove(out)
    os.remove(want)
    if not equal or not all(got[k] for k in kernels):
        raise AssertionError(f"{label}: TSV equal {equal}, launches "
                             f"{_launched(got)}")
    _say(f"cli {label} reads={ORACLE_READS} tsv_equal=True "
         f"launches={json.dumps(_launched(got))} s={secs}")


def _mesh_run(label: str, fn, mesh, want, **extra) -> dict:
    """fn() -> a table over `mesh` (None: meshes fn makes), counted and
    staged: equal to `want` (a table or a digest), K7 (contiguous or
    gapped lanes) and K6 launched; prints the stages and the exchange's
    bytes.  Returns the launches."""
    from kmer_tpu_torch.utils import stagetime
    times: dict[str, float] = {}
    with stagetime.collect(times):
        got, launches = _run_counted(fn)
    equal = (table_digest(got) == want if isinstance(want, str)
             else got == want)
    k7 = launches["k7"] + launches["k7_gapped"]
    if not (equal and k7 and launches["k6"]):
        raise AssertionError(f"{label}: table != the reference, or "
                             f"launches {_launched(launches)}")
    _say(f"mesh_wide {label} equal=True "
         f"launches={json.dumps(_launched(launches))} "
         f"wall_s={times['total']} route_sync_s={times.get('route_sync', 0)}"
         f" exchange_s={times.get('exchange', 0)} "
         + " ".join(f"{k}={v}" for k, v in extra.items())
         + (" " + _mesh_line(mesh) if mesh is not None else ""))
    _say(f"mesh_wide_{label.split()[0]}_stages_s "
         + json.dumps(times, sort_keys=True))
    return launches


def wide_mesh(dev, path: str, small: str, gwide_path: str,
              gwide_digest: str, tmp: str) -> None:
    """Phase 28c, positions on one card at k = 101 canonical: (4, 1) on
    the first 200,000 reads of phase 4's corpus against the single-device
    device merge of that file; (2, 2) and (1, 4) on the 50,000-read file
    (100-base halos over 80- and 40-base shards: several hops),
    `count --multihost` through cli.main and the legacy sorted stream,
    each against the single-device table;
    gapped 40/40 over (2, 1) on phase 27c's records (27c's table);
    StreamingCounter paused on (2, 1) and resumed on (4, 1)."""
    from kmer_tpu_torch import KmerConfig, StreamingCounter, count_fasta
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    cfg = KmerConfig(k=ANY_K, canonical=True)
    mid = os.path.join(tmp, "corpus_200k.fasta")
    with open(path) as src, open(mid, "w") as dst:
        for _ in range(2 * MESH_WIDE_READS):
            dst.write(src.readline())
    t0 = time.perf_counter()
    want = count_fasta(mid, cfg.replace(device_merge="on"), device=dev)
    _say(f"mesh_wide single_device_devmerge reads={MESH_WIDE_READS} "
         f"distinct={want.num_distinct} total={want.total} "
         f"wall_s={time.perf_counter() - t0}")
    mesh = _mesh(dev, 4, 1)
    _mesh_run("(4,1) k101 reads=200000",
              lambda: count_fasta_multihost(mid, cfg, mesh=mesh), mesh,
              want, batches=-(-MESH_WIDE_READS // cfg.batch_reads))
    os.remove(mid)
    del want
    want_small = count_fasta(small, cfg, device=dev)
    for shape in ((2, 2), (1, 4)):
        mesh = _mesh(dev, *shape)
        _mesh_run(f"({shape[0]},{shape[1]}) k101 reads=50000",
                  lambda: count_fasta_multihost(small, cfg, mesh=mesh),
                  mesh, want_small)
    _cli_tsv_equal(f"count --multihost -k {ANY_K}",
                   ["count", small, "-k", str(ANY_K), "--canonical",
                    "--multihost", "--device", "cuda"], want_small, tmp,
                   ("k7_multi", "k6"))
    mesh = _mesh(dev, 4, 1)
    with _env(KMER_TPU_MULTIHOST_STEP="legacy"):
        got = _mesh_run("(4,1) k101 legacy reads=50000",
                        lambda: count_fasta_multihost(small, cfg, mesh=mesh),
                        mesh, want_small)
    if not got["k7_multi"]:
        raise AssertionError(f"legacy k={ANY_K} mesh launches {got}")
    gcfg = KmerConfig(gapped=True, batch_reads=GAP_B, max_read_len=512,
                      **GAP_WIDE)
    mesh = _mesh(dev, 2, 1)
    got = _mesh_run("(2,1) g40 records=1000",
                    lambda: count_fasta_multihost(gwide_path, gcfg,
                                                  mesh=mesh),
                    mesh, gwide_digest)
    if not got["k7_gapped"] or got["k3"]:
        raise AssertionError(f"gapped 40/40 mesh launches {got}")
    spill = os.path.join(tmp, "mesh_wide_spill")

    def stream():
        sc = StreamingCounter(small, cfg, spill, device=dev,
                              mesh=_mesh(dev, 2, 1))
        sc.run_pass1(max_batches=3)
        sc = StreamingCounter(small, cfg, spill, device=dev,
                              mesh=_mesh(dev, 4, 1))
        sc.run()
        return sc.final_table()
    _mesh_run("streaming (2,1)->(4,1) k101 reads=50000", stream, None,
              want_small)
    shutil.rmtree(spill)


def phase_wide_paths(dev, path: str, small: str, any_width: dict, tmp: str,
                     seed: int) -> dict:
    """Phase 28: (a) `card` at k = 101 and K5's plane mode; (b) streaming
    at k = 101 and gapped 40/40; (c) the mesh at k = 101 and gapped
    40/40, each part timed.  Returns K5's plane-mode row with its
    launches on the `card` path."""
    t0 = time.perf_counter()
    parts = {}
    rec = wide_hll_kernel(dev, seed)
    parts["kernel_s"] = time.perf_counter() - t0
    for name, fn in (
            ("a", lambda: rec.__setitem__("launches", wide_card(
                dev, path, small, any_width["k101_distinct"]))),
            ("b", lambda: wide_streaming(
                dev, path, small, any_width["k101_digest"],
                any_width["gwide_path"], any_width["gwide_digest"], tmp)),
            ("c", lambda: wide_mesh(dev, path, small,
                                    any_width["gwide_path"],
                                    any_width["gwide_digest"], tmp))):
        t1 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        parts[f"{name}_s"] = time.perf_counter() - t1
    _say("wide_paths_parts_s " + json.dumps(parts, sort_keys=True)
         + f" wide_paths_wall_s={time.perf_counter() - t0}")
    return rec


def card_case(k7_multi: dict, k5w: dict) -> None:
    """K7's multi-word `card` batch case takes its launches from phase
    28a's `card -k 101` run, where K7 launched once a batch, as K5 did."""
    k7_multi["cases"][f"card_batch_k{ANY_K}"]["launches"] = k5w["launches"]


def wide_paths_only(dev, seed: int) -> int:
    """--only 28: phase 28 and the phases whose tables it reads (4, 6,
    27), as main runs them."""
    with tempfile.TemporaryDirectory() as tmp:
        _, table, path, small, _ = phase_end_to_end(dev, seed, tmp)
        del table
        _, gtable, gpath, _ = phase_gapped_end_to_end(dev, seed, tmp)
        rows, info = phase_any_width(dev, path, small, gpath, gtable, seed)
        del gtable
        k5w = phase_wide_paths(dev, path, small, info, tmp, seed)
    card_case(rows[0], k5w)
    _say(json.dumps({"kernels": [*rows, k5w]}))
    _say("chip_smoke --only 28: done")
    return 0


def any_width_only(dev, seed: int) -> int:
    """--only 27: phase 27 and the phases whose tables it reads (4, 6),
    as main runs them."""
    with tempfile.TemporaryDirectory() as tmp:
        _, table, path, small, _ = phase_end_to_end(dev, seed, tmp)
        del table
        _, gtable, gpath, _ = phase_gapped_end_to_end(dev, seed, tmp)
        rows, _ = phase_any_width(dev, path, small, gpath, gtable, seed)
    _say(json.dumps({"kernels": rows}))
    _say("chip_smoke --only 27: done")
    return 0


def mesh_only(dev, seed: int) -> int:
    """--only 26: phase 26 and the phases whose tables and walls it reads,
    as main runs them."""
    from kmer_tpu_torch import KmerConfig
    with tempfile.TemporaryDirectory() as tmp:
        _, table, path, small, wall = phase_end_to_end(dev, seed, tmp)
        _, devmerge_wall = phase_devmerge(
            dev, path, KmerConfig(k=K, canonical=True), table, wall, "k21")
        _, gtable, gpath, _ = phase_gapped_end_to_end(dev, seed, tmp)
        _, dense8 = phase_dense(dev, path)
        phase_mesh(dev, path, small, gpath, tmp, seed, table, wall,
                   devmerge_wall, table_digest(gtable), dense8)
    _say("chip_smoke --only 26: done")
    return 0


def build_all() -> None:
    """Build every kernel and native library at once, one compiler
    process each."""
    from kmer_tpu_torch.io import fasta
    from kmer_tpu_torch.ops.kernels import compact as ck
    from kmer_tpu_torch.ops.kernels import extract as ek
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.ops.kernels import fused_gapped as fg
    from kmer_tpu_torch.ops.kernels import grouped_count as gk
    from kmer_tpu_torch.ops.kernels import histogram as hk
    from kmer_tpu_torch.ops.kernels import merge_reduce as mr
    from kmer_tpu_torch.ops.kernels import sort as sk
    from kmer_tpu_torch.pipeline import nativeagg
    loaders = (fe.load, fg.load, ck.load, hk.load, sk.load, ek.load,
               gk.load, mr.load, fasta.load_native, nativeagg.load)
    with cf.ThreadPoolExecutor(len(loaders)) as ex:
        for fut in [ex.submit(fn) for fn in loaders]:
            fut.result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", type=int, choices=[17, 26, 27, 28, 30],
                    help="phase 17, 26, 27, 28 or 30 alone, with the "
                         "phases it reads")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # phase 1: environment and builds
    from kmer_tpu_torch.io import fasta
    from kmer_tpu_torch.pipeline import nativeagg
    from kmer_tpu_torch.utils import build
    _say(f"python={sys.version.split()[0]} torch={torch.__version__} "
         f"cuda={torch.version.cuda} devices={torch.cuda.device_count()}")
    _say(_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0])
    global OPS_PER_S
    OPS_PER_S = issue_ops_per_s(dev)
    _say(f"hbm_bytes_per_s={hbm_bytes_per_s(dev)} (utils/profiling."
         "detect_hbm_bw: the bounds' byte rate)")
    _say(f"ops_per_s={OPS_PER_S} (SMs x 128 lanes x max SM clock: the "
         "issue ceiling, the bounds' operation rate)")
    _say("nvcc: " + _tool([build.nvcc(), "--version"]).splitlines()[-1])
    build_all()
    _say(f"native_parser_loaded={fasta.native_loaded()} "
         f"native_aggregator_loaded={nativeagg.native_loaded()} "
         f"build_s={json.dumps(build.build_seconds, sort_keys=True)}")
    from kmer_tpu_torch.utils.linkspeed import d2h_gbps
    _say(f"d2h_link_probe_GBps={d2h_gbps(dev)} (device_merge=\"auto\" is on "
         "below 0.5, mode=\"auto\" dense below 5)")
    if args.only == 17:
        _say(json.dumps({"kernels": list(phase_grouped_kernels(
            dev, args.seed))}))
        _say("chip_smoke --only 17: done")
        return 0
    if args.only == 30:
        _say(json.dumps({"kernels": [phase_merge_reduce_kernel(
            dev, args.seed)]}))
        _say("chip_smoke --only 30: done")
        return 0
    if args.only == 26:
        return mesh_only(dev, args.seed)
    if args.only == 27:
        return any_width_only(dev, args.seed)
    if args.only == 28:
        return wide_paths_only(dev, args.seed)

    # phases 2-3, 7-8, 13, 16-17, 20 and 30: each kernel against its plain
    # version
    k1 = phase_kernel(dev, args.seed)
    k3 = phase_gapped_kernel(dev, args.seed)
    k4 = phase_compact_kernel(dev, args.seed)
    k5 = phase_histogram_kernel(dev, args.seed)
    k6 = phase_sort_kernel(dev, args.seed)
    k7 = phase_extract_kernel(dev, args.seed)
    k2a, k2b, k2c = phase_grouped_kernels(dev, args.seed)
    wide = phase_wide_kernels(dev, args.seed)
    mrk = phase_merge_reduce_kernel(dev, args.seed)

    # phases 4-6, 9-12, 14-15 and 18-19: the paths end to end, each
    # kernel's count set to 0 just before its path and read just after
    from kmer_tpu_torch import KmerConfig
    with tempfile.TemporaryDirectory() as tmp:
        k1["launches"], table, path, small, wall = phase_end_to_end(
            dev, args.seed, tmp)
        k7["launches"], k2a["launches"] = phase_unfused_end_to_end(
            dev, path, small, table, wall)
        k6["launches"], devmerge_wall = phase_devmerge(
            dev, path, KmerConfig(k=K, canonical=True), table, wall, "k21")
        mrk["launches"] = k6["launches"]      # one a merge (phase 14)
        profile_devmerge(dev, path, KmerConfig(k=K, canonical=True))
        phase_parity(dev)
        k3["launches"], gtable, gpath, gwall = phase_gapped_end_to_end(
            dev, args.seed, tmp)
        phase_devmerge(dev, gpath, KmerConfig(gapped=True, batch_reads=GAP_B,
                                              max_read_len=512),
                       gtable, gwall, "gapped")
        k4["launches"] = phase_compact_end_to_end(dev, path, table)
        k5["launches"], dense8 = phase_dense(dev, path)
        card_launches = [phase_card(dev, path, small, table.num_distinct)]
        k2b["launches"], k2c["launches"] = phase_unfused_small(dev, small)

        # phases 21-23: keys of 32 to 63 bases and spaced seeds end to end
        batches = -(-N_READS // KmerConfig().batch_reads)
        wide_cfg = KmerConfig(k=WIDE_K, canonical=True)
        k55, k55_table = phase_wide_end_to_end(dev, path, small, "k55",
                                               wide_cfg, [
            ("sort", {}, {}, {"k1_wide": batches}),
            ("compact", {}, dict(compact=True),
             {"k1_wide": batches, "k4": batches}),
            ("device_merge", {}, dict(device_merge="on"),
             {"k1_wide": batches, "k6": -1}),
            ("legacy", dict(KMER_TPU_STEP="legacy", KMER_TPU_GROUPED="hybrid"),
             {}, {"k7_wide": batches, "k2a": batches, "k1": 0})])
        spaced_cfg = KmerConfig(seed_mask=WIDE_MASK, canonical=True)
        sp, sp_table = phase_wide_end_to_end(dev, path, small, "spaced",
                                             spaced_cfg, [
            ("sort", {}, {}, {"k1_spaced": batches}),
            ("device_merge", {}, dict(device_merge="on"),
             {"k1_spaced": batches, "k6": -1}),
            ("sort_group_keys=0", {}, dict(sort_group_keys=0),
             {"k7_spaced": batches, "k6": batches, "k1": 0})])
        card_launches.append(phase_wide_card(
            dev, path, f"k={WIDE_K}", wide_cfg, k55_table.num_distinct,
            "k1_wide"))
        card_launches.append(phase_wide_card(
            dev, path, f"seed_mask={WIDE_MASK}", spaced_cfg,
            sp_table.num_distinct, "k1_spaced"))

        # phase 24: streaming two-pass with a pause and a resume
        phase_stream_batches(dev, path, table, wall, tmp)
        phase_stream_gapped(dev, gpath, gtable, tmp)
        gapped_digest = table_digest(gtable)
        del k55_table, sp_table
        phase_stream_devmerge(dev, tmp, args.seed)

        # phase 25: the saved-table surface through the CLI
        phase_surface(dev, path, small, table, wall, tmp, args.seed)

        # phase 26: multi-GPU counting, a mesh of positions on one card
        phase_mesh(dev, path, small, gpath, tmp, args.seed, table, wall,
                   devmerge_wall, gapped_digest, dense8)

        # phase 27: keys of any width
        del table
        any_width, any_width_info = phase_any_width(dev, path, small, gpath,
                                                    gtable, args.seed)
        del gtable

        # phase 28: wide keys on streaming, `card` and the mesh
        k5w = phase_wide_paths(dev, path, small, any_width_info, tmp,
                               args.seed)
    # K5's launches: the dense k=8 run's, then each `card` run's (k = 21,
    # 55 and the mask)
    k5["card_launches"] = card_launches
    card_case(any_width[0], k5w)
    k1w, k7w, k1s, k7s = wide
    k1w["launches"], k7w["launches"] = (k55["sort"]["k1_wide"],
                                        k55["legacy"]["k7_wide"])
    k1s["launches"], k7s["launches"] = (sp["sort"]["k1_spaced"],
                                        sp["sort_group_keys=0"]["k7_spaced"])

    _say(json.dumps({"kernels": [k1, k1w, k1s, k2a, k2b, k2c, k3, k4, k5, k6,
                                 k7, k7w, k7s, *any_width, k5w, mrk]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

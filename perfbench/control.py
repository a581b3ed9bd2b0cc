"""The readings that the limits of `correct` are set from, on the card.

    python3 perfbench/control.py --workload k21-ecoli30x \
        --seeds 11 12 13 --control-seeds 3

For each cell and seed: the cell's corpus, one job of the program as the
window runs it, and the numbers the run compares (the lower readings);
on the first --control-seeds seeds also the control, the reference with
its keys held in the next narrower integer (reference.count_kmers with
narrow=True), compared with the reference in the same way (the upper
readings).  One JSON line a reading; the benchmark's runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def readings(workload: str, seed: int, control: bool) -> dict:
    from perfbench import card, reference
    from perfbench.spec import Spec
    spec = Spec(workload)
    entry, fields = spec.entry(), spec.config["kmer_config"]
    device = card.DEVICE
    tmp = tempfile.mkdtemp(prefix="perfbench-control-")
    try:
        path = os.path.join(tmp, "corpus")
        lengths = spec.generator().write(path, spec.traffic["params"], seed,
                                         device)
        t0 = time.perf_counter()
        table = entry.run(path, entry.make(fields), device)
        job_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = dict(zip(("mismatched_rows", "kmers_total_gap"),
                       (v for _, v, _ in entry.check([table], path, fields,
                                                     lengths, device))))
        out = {"workload": workload, "seed": seed, "job_s": job_s,
               "check_s": time.perf_counter() - t0,
               "distinct": table.num_distinct, "program": got}
        if control:
            k, canon = fields["k"], fields.get("canonical", False)
            want = reference.count_kmers(path, k, canon, device)
            t0 = time.perf_counter()
            narrow = reference.count_kmers(path, k, canon, device,
                                           narrow=True)
            out["control"] = {
                "mismatched_rows": reference.mismatched_rows(*narrow, *want),
                "kmers_total_gap": abs(int(narrow[1].sum())
                                       - entry.work(fields, lengths))}
            out["control_s"] = time.perf_counter() - t0
        card.free()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.path.dirname(here)] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    from perfbench import card
    from perfbench.spec import Spec
    try:
        card.require(1)
    except card.NoCard as exc:
        print(f"perfbench control: {exc}", file=sys.stderr)
        return 2
    for workload in args.workload:
        print(json.dumps(card.open_card(Spec(workload).entry().LIBRARIES)),
              flush=True)
        for i, seed in enumerate(args.seeds):
            print(json.dumps(readings(workload, seed,
                                      i < args.control_seeds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

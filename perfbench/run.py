"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 perfbench/run.py --workload k21-ecoli30x --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `compared`, each number compared with the reference beside its
limit; the same numbers are the last lines of standard error.  Exits 2,
printing no result, without the CUDA devices the cell asks for, and 3
where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()       # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    from perfbench import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.NoCard as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: modules loaded that no run may load: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}={c['value']} limit={c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

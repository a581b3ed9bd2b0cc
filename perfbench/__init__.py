"""The benchmark of kmer_tpu_torch on an NVIDIA GPU.

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once (run.py).  Each
configuration (configs/), traffic mix (traffic/, drawn by a generator
of generators/), entry point (entries/) and metric (metrics/) is a file
of its own, found by its name in BENCHMARK.json, and so is each probe
(probes/) that a metric's reader names; roofline/ holds the byte and
operation counts and the card's peaks, card.py the calls made of the
card, reference.py the plain reference that decides `correct`,
control.py the control's readings.
Nothing here imports JAX or the JAX package.
"""

"""The benchmark of psa_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for.  Makes the cell's inputs on the card from the seed, warms up the
cell's shapes, calls the calculator back to back for ``--seconds``, checks
a sample of the answers against the plain reference in
``benchmark/reference/``, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones read from torch.profiler over the window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard error).
Exits non-zero without a result when the cards are missing or when JAX or
the JAX package got loaded.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == '__main__':
    from pathlib import Path
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from benchmark.harness.cli import main
    sys.exit(main(sys.argv[1:], t_start=T_START))

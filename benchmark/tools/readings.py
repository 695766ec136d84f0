"""The numbers a cell's check compares, over many seeds in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 [--seconds 4] [--control]

For each seed, one run of the cell as ``benchmark/run.py`` makes it (the
cell's sizes and load, a short window), and one JSON line of the numbers
compared and whether they passed.  ``--control`` runs the check's control
in the program's place (the program at the control's precision tier, or the
reference in TF32).  The limits in ``benchmark/checks/`` are set from these
readings: above the program's largest over a dozen seeds or more, below the
control's smallest.  The benchmark's own runs never run the control.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    sys.path[0] = str(Path(__file__).resolve().parents[2])
    from benchmark.harness import cli
    from benchmark.harness.cell import ROOT, run_cell
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True, help="comma-separated seeds")
    p.add_argument('--seconds', type=float, default=4.0)
    p.add_argument('--control', action='store_true')
    args = p.parse_args(argv)
    cli.cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, device='cuda',
                     control=args.control)
        print(json.dumps({'workload': args.workload, 'seed': seed, 'control': args.control,
                          'correct': r['correct'], 'attempted': r['attempted'],
                          'checks': {n: c['value'] for n, c in r['checks'].items()},
                          'metrics': {n: m['value'] for n, m in r['metrics'].items()},
                          'seconds': time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())

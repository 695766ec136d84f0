"""Command line of the benchmark: one run of one cell, one JSON line on stdout."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

#: Top-level module names that may not be loaded in a benchmark run.
FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'psa_tpu'})


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & FORBIDDEN)


def cache_dirs(root) -> None:
    """Keep every kernel cache a run may fill inside the checkout, at fixed paths
    (the port's own nvcc library lives in ``psa_tpu_torch/_build``)."""
    base = os.path.join(str(root), '.bench_cache')
    for var, sub in (('TRITON_CACHE_DIR', 'triton'), ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'nv')):
        os.environ.setdefault(var, os.path.join(base, sub))


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on this machine's GPU.")
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    from benchmark.harness import cell as cellmod
    spec = cellmod.load_spec()
    chips = {w['name']: w['chips'] for w in spec['workloads']}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(chips)}",
              file=sys.stderr)
        return 2
    cache_dirs(cellmod.ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = cellmod.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device='cuda', t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

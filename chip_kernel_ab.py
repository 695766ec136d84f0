"""Time another version of the projection kernel against this checkout's, in turns, on one CUDA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    git show REV:psa_tpu_torch/csrc/sed_projection.cu > OTHER.cu   # e.g. a parent commit
    python3 chip_kernel_ab.py OTHER.cu [--tier parity|balanced|fast] [--rounds 8]
    python3 chip_kernel_ab.py --kernel phasors [OTHER.cu ...] [--rounds 3]

``--kernel phasors`` times the fused 'exact' mode-stack kernel
(``csrc/instant_modes.cu``, ``ops/instantaneous.fused_modes``) against the
plain chain it replaced (``accumulate_modes_plain``: float64 angles, cos,
sin and a float32 ``bmm`` per time tile of :data:`PLAIN_T_CHUNK` frames,
the plan the DSF cell's 8e9 budget gave it) and each OTHER given, a
text-edited copy of ``csrc/instant_modes.cu`` with the same entry point, at
the DSF cell's call: 32,000 atoms of an fcc liquid walking from their sites
x 10^4 frames x 128 commensurate k along x, with velocities (C = 4).  Each
round times plain, this, the others and the same in reverse with CUDA events,
while nvidia-smi samples the SM clock.  Every version goes through
``chip_smoke.modes_checks`` (against a float64 sum on eight k columns and
against the plain chain, in units of 2^-24 times the magnitudes each sum
adds; one atom's phasors at a time against the float64 functions of its
folded angle) and is reported as passing or not; this checkout's kernel
must pass, and two of its launches must give the same bits.

OTHER.cu may also be a version of ``csrc/sed_projection_tiers.cu`` (it
defines ``psa_sed_tier_product``), e.g. a text-edited copy of this one that
keeps its table layout; it then runs at --tier balanced or fast as its
table kernel and then its product kernel, on a table of its own.

The other source is compiled with the package's nvcc flags into its own
library in a temporary directory while this checkout's kernels build as the
package builds them (``psa_tpu_torch._build``, every ``csrc/*.cu``); both
are loaded side by side.  On chip_smoke.py's working chunk, (n_t, A, K) =
(10^4, 10^5, 500) with seeded velocities on the card, each round times,
with CUDA events over two calls each, the other version at the tier (its
one entry point, with its ``tier`` argument where it has one), this
checkout's ``sed_projection`` at the tier writing its output, the same
adding to it (``accumulate``), and the same three again in reverse order.
At 'parity' each output must equal this one's bit for bit (the fused
kernel's pipeline; an add to zeros is exact); at 'balanced' and 'fast',
whose sum order this checkout changed (or a tiers source may change),
within chip_smoke's TOL_KERNEL of max.  Prints the card's name and power
limit, the clusters of the 'parity' kernel the card holds at once (this
checkout's, and the other's where it has the entry point), one line per
variant with the median and quartiles in ms, and a JSON line.  An entry
point without the ``accumulate`` or ``tier`` argument (before it existed)
is called without it; one without ``tier`` runs 'parity' only.
"""
import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def entry_arguments(source: Path) -> str:
    """The argument list of the source's ``psa_sed_projection`` entry point."""
    sig = re.search(r'extern "C" int psa_sed_projection\((.*?)\)', source.read_text(), re.S)
    if sig is None:
        raise SystemExit(f"{source}: no psa_sed_projection entry point")
    return sig.group(1)


def launcher(lib_path, arguments, tier):
    """f(data, hi, lo, kv, out) launching the library's kernel at ``tier``
    (an index of the package's TIERS) on the current stream."""
    with_accumulate, with_tier = 'accumulate' in arguments, 'tier' in arguments
    if tier and not with_tier:
        raise SystemExit(f"{lib_path}: the entry point has no tier argument")
    fn = ctypes.CDLL(str(lib_path)).psa_sed_projection
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_int] * (with_accumulate + with_tier) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(data, hi, lo, kv, out):
        extra = [0] * with_accumulate + [tier] * with_tier
        err = fn(data.data_ptr(), hi.data_ptr(), lo.data_ptr(), kv.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), data.shape[0], data.shape[1], kv.shape[0], *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib_path}: CUDA error {err}")
    return run


def tier_launcher(lib_path, tier):
    """f(data, hi, lo, kv, out): the library's table kernel at ``tier``
    into a table of its own (this checkout's layout), then its product
    kernel, on the current stream."""
    from psa_tpu_torch import _build
    from psa_tpu_torch.ops.sed_projection import table_bytes
    lib = _build.bind(ctypes.CDLL(str(lib_path)), ('psa_sed_tier_table', 'psa_sed_tier_product'))
    tables = {}

    def run(data, hi, lo, kv, out):
        n_t, n_atoms, _ = data.shape
        n_bytes = table_bytes(n_atoms, kv.shape[0])
        if n_bytes not in tables:
            tables[n_bytes] = torch.empty(n_bytes, dtype=torch.uint8, device=data.device)
        table, stream = tables[n_bytes], torch.cuda.current_stream().cuda_stream
        err = lib.psa_sed_tier_table(hi.data_ptr(), lo.data_ptr(), kv.data_ptr(), table.data_ptr(),
                                     n_bytes, 0, n_atoms, kv.shape[0], tier, stream)
        err = err or lib.psa_sed_tier_product(
            data.data_ptr(), table.data_ptr(), n_bytes, out[0].data_ptr(), out[1].data_ptr(), n_t,
            n_atoms, 0, n_atoms, kv.shape[0], 0, tier, stream)
        if err:
            raise RuntimeError(f"{lib_path}: CUDA error {err}")
    return run


def smi(query):
    return subprocess.run(['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def build_others(others) -> list:
    """This checkout's kernels built as the package builds them, and each
    OTHER compiled beside them into its own library in a temporary
    directory; the libraries' paths."""
    from psa_tpu_torch import _build
    tmp = Path(tempfile.mkdtemp())
    libs = [tmp / f'libother{i}.so' for i in range(len(others))]
    procs = [subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for lib, src in zip(libs, others)]
    _build.build()   # this checkout's sources, beside the other nvcc runs
    for src, proc in zip(others, procs):
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {src}:\n{log}")
        print(f"[ab] {src}: " + "; ".join(line.strip() for line in log.splitlines()
                                         if 'registers' in line or 'spill' in line), flush=True)
    return libs


#: The DSF cell's call (``benchmark/configs/lj_liquid_32k.json``, traffic
#: ``dsf_path``): fcc 20^3 cells at reduced density 0.8442 with sigma = 3.405
#: A, 10^4 frames of a 0.1 A walk from the sites, 128 k_n = n 2 pi / L along x;
#: velocities normal at Maxwell's 1.895 A/ps per axis (T* = 1.44, argon units).
LJ_CELLS, LJ_A0, LJ_FRAMES, LJ_K, LJ_WALK = 20, (4 / 0.8442) ** (1 / 3) * 3.405, 10_000, 128, 0.1
LJ_V = 1.895
#: The plain chain's time tile at the cell's budget: 8e9 // (4 * 24) // (32,000 * 128).
PLAIN_T_CHUNK = 20


def sample_clocks():
    """A process that samples the card's SM clock and power every 100 ms
    until it is stopped; :func:`read_clocks` stops it and reads it."""
    return subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
                             '--format=csv,noheader,nounits', '-lms', '100'],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def read_clocks(proc):
    """{"sm_mhz": [min, median, max], "power_w": [...], "samples": n}."""
    proc.terminate()
    out = proc.communicate(timeout=60)[0]
    rows = [[float(x) for x in line.split(',')] for line in out.splitlines()
            if line.count(',') == 1 and 'N/A' not in line]
    if not rows:
        return {"samples": 0}
    mhz, watts = np.array(rows).T
    return {"sm_mhz": [float(mhz.min()), float(np.median(mhz)), float(mhz.max())],
            "power_w": [float(watts.min()), float(np.median(watts)), float(watts.max())],
            "samples": len(rows)}


def phasors(args):
    """``--kernel phasors`` (module docstring)."""
    from benchmark.reference.lattice import fcc_sites
    from psa_tpu_torch import _build
    from psa_tpu_torch.ops import instantaneous as inst
    print(smi('name,power.limit'), flush=True)
    others = [_build.bind(ctypes.CDLL(str(lib)), ('psa_instant_modes',
                                                  'psa_instant_modes_active_blocks',
                                                  'psa_instant_modes_tile'))
              for lib in build_others(args.other)]
    log = _build.build_log
    print(log[log.index('== instant_modes.cu'):].split('\n== ')[0], flush=True)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sites = torch.from_numpy(fcc_sites(LJ_CELLS, LJ_A0).astype(np.float32)).to(dev)
    n_a = sites.shape[0]
    pos = torch.randn((LJ_FRAMES, n_a, 3), generator=gen, device=dev)
    pos.mul_(LJ_WALK).cumsum_(0).add_(sites)
    vel = torch.randn((LJ_FRAMES, n_a, 3), generator=gen, device=dev).mul_(LJ_V)
    length = LJ_CELLS * LJ_A0
    k_host = inst.nearest_commensurate(
        np.outer(np.arange(1, LJ_K + 1) * 2 * np.pi / length, [1.0, 0.0, 0.0]), [length] * 3)
    kv = torch.from_numpy(k_host).to(dev)
    at_cell = (LJ_FRAMES, n_a, LJ_K) == cs.MODES_CELL
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def fresh():
        return [torch.zeros((LJ_FRAMES, LJ_K, 4), device=dev) for _ in range(2)]

    def other_launch(lib, src):
        """f(acc, weights=None): the library's entry point, its atom splits
        planned with its own tiles and the blocks it holds at once."""
        slots = lib.psa_instant_modes_active_blocks() * n_sm
        tiles = tuple(lib.psa_instant_modes_tile(axis) for axis in range(3))
        splits, per = inst.modes_splits(LJ_FRAMES, n_a, LJ_K, slots, tiles)

        def run(acc, weights=None):
            part = (torch.empty(2 * splits * LJ_FRAMES * LJ_K * 4, device=dev) if splits > 1
                    else None)
            err = lib.psa_instant_modes(
                pos.data_ptr(), pos.stride(0), pos.stride(1), vel.data_ptr(), vel.stride(0),
                vel.stride(1), None if weights is None else weights.data_ptr(), kv.data_ptr(),
                acc[0].data_ptr(), acc[1].data_ptr(), None if part is None else part.data_ptr(),
                LJ_FRAMES, n_a, LJ_K, 4, splits, per, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{src}: CUDA error {err}")
        return run

    launch = {'plain': lambda acc, weights=None: inst.accumulate_modes_plain(
                  *acc, pos, vel, kv, PLAIN_T_CHUNK, weights=weights),
              'this': lambda acc, weights=None: inst.fused_modes(*acc, pos, vel, kv, weights)}
    for lib, src in zip(others, args.other):
        launch[src.stem] = other_launch(lib, src)
    outs = {}
    for name, fn in launch.items():
        outs[name] = fresh()
        fn(outs[name])
    again = fresh()
    launch['this'](again)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(again, outs['this']))
    del again
    checks = cs.modes_checks(outs, {n: f for n, f in launch.items() if n != 'plain'}, pos, vel,
                             kv)
    for name, rec in checks.items():
        print(f"[ab] phasors {name}: {json.dumps(rec)}", flush=True)
    if not (same and checks['this']['passes']):
        raise SystemExit(f"the fused kernel repeats its bits {same}; checks {checks['this']}")
    ms = {name: [] for name in launch}
    order = list(launch)
    acc = fresh()
    clocks = sample_clocks()
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            ms[name].append(cs.cuda_ms(lambda: launch[name](acc), 1 if name == 'plain' else 3))
    held = read_clocks(clocks)
    stats = {}
    for name, times in ms.items():
        q1, med, q3 = (float(x) for x in np.percentile(times, [25, 50, 75]))
        stats[name] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3, "n": len(times),
                       **checks[name]}
        print(f"[ab] phasors {name}: median {med:.3f} ms, quartiles {q1:.3f}-{q3:.3f} ms over "
              f"{len(times)} timings at (n_t, A, K, C) = ({LJ_FRAMES}, {n_a}, {LJ_K}, 4); "
              f"passes the checks: {checks[name]['passes']}", flush=True)
    slots, tiles = inst._card(0)
    print(json.dumps({"kernel": "phasors", "other": [str(o) for o in args.other],
                      "shape": [LJ_FRAMES, n_a, LJ_K, 4], "the_dsf_cells_call": at_cell,
                      "rounds": args.rounds, "splits": inst.modes_splits(LJ_FRAMES, n_a, LJ_K,
                                                                         slots, tiles),
                      "slots": slots, "tiles": tiles, "bitwise_repeat": same, "variants": stats,
                      "clocks_while_timed": held,
                      "clocks_sm_power_after": smi('clocks.sm,power.draw')}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('other', type=Path, nargs='*',
                        help="another version of csrc/sed_projection.cu or of "
                        "csrc/sed_projection_tiers.cu (with --kernel phasors: none or more "
                        "versions of csrc/instant_modes.cu)")
    parser.add_argument('--kernel', default='projection', choices=['projection', 'phasors'])
    parser.add_argument('--tier', default='parity', choices=['parity', 'balanced', 'fast'])
    parser.add_argument('--rounds', type=int, default=None,
                        help="rounds of turns (default 8; 3 with --kernel phasors)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: torch.cuda.is_available() is false; needs a CUDA GPU")
    if args.kernel == 'phasors':
        args.rounds = args.rounds or 3
        return phasors(args)
    args.rounds = args.rounds or 8
    if len(args.other) != 1:
        parser.error("the projection kernel's A/B takes one OTHER")
    args.other = args.other[0]
    from psa_tpu_torch import _build
    from psa_tpu_torch.ops import sed_projection as proj
    from psa_tpu_torch.ops.spectral import split_f64
    print(smi('name,power.limit'), flush=True)

    other_lib = build_others([args.other])[0]
    clusters = {'this': _build.load().psa_sed_projection_active_clusters()}
    other_cdll = ctypes.CDLL(str(other_lib))
    if hasattr(other_cdll, 'psa_sed_projection_active_clusters'):
        clusters['other'] = other_cdll.psa_sed_projection_active_clusters()
    print(f"[ab] clusters the card holds at once (cudaOccupancyMaxActiveClusters): {clusters}",
          flush=True)
    if 'psa_sed_tier_product' in args.other.read_text():
        if args.tier == 'parity':
            raise SystemExit(f"{args.other} runs 'balanced' or 'fast'")
        other = tier_launcher(other_lib, proj.TIERS[args.tier])
    else:
        other = launcher(other_lib, entry_arguments(args.other), proj.TIERS[args.tier])

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    data = torch.randn((cs.N_T, cs.N_ATOMS, 3), generator=gen, device=dev)
    sites, _, _ = cs.si_sites(cs.N_ATOMS)
    hi, lo = (torch.from_numpy(x).to(dev) for x in split_f64(sites))
    _, k_vecs, _ = cs.working_calculator(dev)
    kv = torch.from_numpy(np.ascontiguousarray(k_vecs[:cs.K_CHUNK], np.float32)).to(dev)
    inputs = (data, hi, lo, kv)

    def fresh():
        return tuple(torch.zeros((cs.N_T, 3, cs.K_CHUNK), device=dev) for _ in range(2))
    outs = {'this': fresh(), 'other': fresh(), 'this_accumulate': fresh()}
    variants = {'other': lambda: other(*inputs, outs['other']),
                'this': lambda: proj.sed_projection(*inputs, out=outs['this'],
                                                    precision=args.tier),
                'this_accumulate': lambda: proj.sed_projection(
                    *inputs, out=outs['this_accumulate'], accumulate=True,
                    precision=args.tier)}
    for run in variants.values():                 # the accumulator: added once to zeros
        run()
    torch.cuda.synchronize()
    errs = {name: cs.rel(torch.cat(outs[name]), torch.cat(outs['this'])) for name in variants}
    same = {name: all(torch.equal(a, b) for a, b in zip(outs[name], outs['this']))
            for name in variants}
    agree = same if args.tier == 'parity' else {n: e <= cs.TOL_KERNEL for n, e in errs.items()}
    if not all(agree.values()):
        raise SystemExit(f"the versions disagree with this one at {args.tier}: bitwise {same}, "
                         f"of max {errs}")

    ms = {name: [] for name in variants}
    order = ['other', 'this', 'this_accumulate']
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            ms[name].append(cs.cuda_ms(variants[name], 2))
    clocks = smi('clocks.sm,power.draw')
    stats = {}
    for name, times in ms.items():
        q1, med, q3 = (float(x) for x in np.percentile(times, [25, 50, 75]))
        stats[name] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3, "n": len(times),
                       "bitwise_equal_to_this": same[name], "rel_err_to_this": errs[name]}
        print(f"[ab] {args.tier} {name}: median {med:.3f} ms, quartiles {q1:.3f}-{q3:.3f} ms over "
              f"{len(times)} timings of 2 calls at (n_t,A,K)=({cs.N_T},{cs.N_ATOMS},{cs.K_CHUNK}); "
              f"bitwise equal to this {same[name]}, {errs[name]:.3e} of max", flush=True)
    print(json.dumps({"other": str(args.other), "tier": args.tier,
                      "shape": [cs.N_T, cs.N_ATOMS, cs.K_CHUNK], "rounds": args.rounds,
                      "variants": stats, "active_clusters": clusters,
                      "clocks_sm_power_after": clocks}), flush=True)


if __name__ == '__main__':
    main()

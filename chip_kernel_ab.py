"""Time another version of the projection kernel against this checkout's, in turns, on one CUDA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    git show REV:psa_tpu_torch/csrc/sed_projection.cu > OTHER.cu   # e.g. a parent commit
    python3 chip_kernel_ab.py OTHER.cu [--tier parity|balanced|fast] [--rounds 8]

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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('other', type=Path, help="another version of csrc/sed_projection.cu or of "
                        "csrc/sed_projection_tiers.cu")
    parser.add_argument('--tier', default='parity', choices=['parity', 'balanced', 'fast'])
    parser.add_argument('--rounds', type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: torch.cuda.is_available() is false; needs a CUDA GPU")
    from psa_tpu_torch import _build
    from psa_tpu_torch.ops import sed_projection as proj
    from psa_tpu_torch.ops.spectral import split_f64
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        other_lib = Path(tmp) / 'libother.so'
        nvcc = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, '-o', str(other_lib),
                                 str(args.other)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        _build.build()   # this checkout's sources, beside the other nvcc run
        clusters = {'this': _build.load().psa_sed_projection_active_clusters()}
        log = nvcc.communicate(timeout=600)[0]
        if nvcc.returncode != 0:
            raise SystemExit(f"nvcc failed on {args.other}:\n{log}")
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
    clocks = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
                             '--format=csv,noheader'], capture_output=True, text=True,
                            check=True, timeout=60).stdout.strip()
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

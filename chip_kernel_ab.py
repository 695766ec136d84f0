"""Time another version of the projection kernel against this checkout's, in turns, on one CUDA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    git show REV:psa_tpu_torch/csrc/sed_projection.cu > OTHER.cu   # e.g. a parent commit
    python3 chip_kernel_ab.py OTHER.cu [--rounds 8]

Both sources are compiled with the package's nvcc flags at once, each into
its own library in a temporary directory, and loaded side by side.  On
chip_smoke.py's working chunk, (n_t, A, K) = (10^4, 10^5, 500) with seeded
velocities on the card, each round times, with CUDA events over two calls
each, the other version, this one writing its output, this one adding to
it (``accumulate``), and the same three again in reverse order.  Each
version's output must equal this one's bit for bit (the MMA pipeline is
shared; an add to zeros is exact).  Prints the card's name and power limit,
one line per variant with the median and quartiles in ms, and a JSON line.
An entry point without the ``accumulate`` or ``tier`` argument (before it
existed) is called without it; this checkout's kernel runs its 'parity'
tier.
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


def build_all(sources, out_dir):
    """Compile each source into its own library, all nvcc runs at once; the libraries."""
    from psa_tpu_torch import _build
    libs = [out_dir / f'lib{i}.so' for i in range(len(sources))]
    procs = [subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, lib in zip(sources, libs)]
    for src, proc in zip(sources, procs):
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {src}:\n{log}")
    return libs


def launcher(lib_path, arguments):
    """f(data, hi, lo, kv, out, accumulate) launching the library's kernel
    (its 'parity' tier, where it has tiers) on the current stream."""
    with_accumulate, with_tier = 'accumulate' in arguments, 'tier' in arguments
    fn = ctypes.CDLL(str(lib_path)).psa_sed_projection
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_int] * (with_accumulate + with_tier) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(data, hi, lo, kv, out, accumulate=False):
        extra = ([int(accumulate)] if with_accumulate else []) + ([0] if with_tier else [])
        err = fn(data.data_ptr(), hi.data_ptr(), lo.data_ptr(), kv.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), data.shape[0], data.shape[1], kv.shape[0], *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib_path}: CUDA error {err}")
    return run


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('other', type=Path, help="another version of csrc/sed_projection.cu")
    parser.add_argument('--rounds', type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: torch.cuda.is_available() is false; needs a CUDA GPU")
    from psa_tpu_torch.ops.spectral import split_f64
    this = Path(__file__).resolve().parent / 'psa_tpu_torch' / 'csrc' / 'sed_projection.cu'
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        other_lib, this_lib = build_all([args.other, this], Path(tmp))
        other = launcher(other_lib, entry_arguments(args.other))
        mine = launcher(this_lib, entry_arguments(this))

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
                    'this': lambda: mine(*inputs, outs['this']),
                    'this_accumulate': lambda: mine(*inputs, outs['this_accumulate'],
                                                    accumulate=True)}
        for run in variants.values():                 # the accumulator: added once to zeros
            run()
        torch.cuda.synchronize()
        same = {name: all(torch.equal(a, b) for a, b in zip(outs[name], outs['this']))
                for name in variants}
        if not all(same.values()):
            raise SystemExit(f"the versions disagree with this one: {same}")

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
                       "bitwise_equal_to_this": same[name]}
        print(f"[ab] {name}: median {med:.3f} ms, quartiles {q1:.3f}-{q3:.3f} ms over "
              f"{len(times)} timings of 2 calls at (n_t,A,K)=({cs.N_T},{cs.N_ATOMS},{cs.K_CHUNK})",
              flush=True)
    print(json.dumps({"other": str(args.other), "shape": [cs.N_T, cs.N_ATOMS, cs.K_CHUNK],
                      "rounds": args.rounds, "variants": stats, "clocks_sm_power_after": clocks}),
          flush=True)


if __name__ == '__main__':
    main()

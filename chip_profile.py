"""Where the device time of psa_tpu_torch's working-size paths goes, by torch.profiler.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_profile.py [--out DIR] [--paths msd,rdf_brute,...]

On chip_smoke.py's working-size data (10^5 atoms x 10^4 steps, seeded
velocities on the card, 50x50 k-grid) it runs, for each of ``calculate``
(k-chunks of 500), ``calculate_kgrid_peaks`` (3 peaks, k-chunks of 1,280),
``calculate_kgrid_browse`` (k-chunks of 1,280, float32 and float16
readback), and ``calculate`` and ``calculate_kgrid_peaks`` on the same
velocities copied to the host under the default device budget, so the group
streams in atom blocks (``calculate_streamed``, ``kgrid_peaks_streamed``),
``calculate_npt_peaks`` on chip_smoke.py's breathing cell (``npt_peaks``) and
``calculate_dsf`` on its thermal fixed cell (``dsf``, positions and velocities
resident), and on that cell ``calculate_msd`` (``msd``) and ``calculate_rdf`` by
the brute sweep over 2 frames (``rdf_brute``) and by the linked cells over 64
(``rdf_cells``): one warm-up call, three timed calls, then one call under
torch.profiler.  ``--paths`` runs only the named ones (and makes only their
data).  For each it prints one JSON line: the walls, the device
time and event count by category (the projection kernel, cuFFT, other
kernels, memsets, each copy direction), the device's busy time (the union
of the intervals of its kernels, copies and memsets), the idle share of the
profiled wall, the twelve kernels that took the most device time, by name, and
the SM clock and power draw read just after.  Each
chrome trace is written to DIR (default ``chiprun_out/``).  The first line
is the card's name and power limit.
"""
import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def smi(query):
    return subprocess.run(['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def category(event):
    """Bucket of one device event of a chrome trace."""
    name = event['name']
    if event['cat'] == 'gpu_memcpy':
        return f"memcpy {name}"
    if event['cat'] == 'gpu_memset':
        return 'memset'
    if 'sed_projection_kernel' in name:
        return 'sed_projection_kernel'
    low = name.lower()
    if 'fft' in low:
        return 'cuFFT'
    return 'gemm (cuBLAS)' if 'gemm' in low or 'gemv' in low else 'other kernels'


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_path(name, run, out_dir):
    """Warm-up, three timed calls and one profiled call of ``run``: the JSON record."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = out_dir / f"trace_{name}.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())['traceEvents']
              if e.get('cat') in DEVICE_CATS and 'dur' in e]
    ms, count = {}, {}
    for e in events:
        key = category(e)
        ms[key] = ms.get(key, 0.0) + e['dur'] / 1e3
        count[key] = count.get(key, 0) + 1
    by_name = {}
    for e in events:
        if e['cat'] == 'kernel':
            entry = by_name.setdefault(e['name'][:120], [0.0, 0])
            entry[0] += e['dur'] / 1e3
            entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy = busy_us((e['ts'], e['ts'] + e['dur']) for e in events) / 1e3
    span = (max(e['ts'] + e['dur'] for e in events) - min(e['ts'] for e in events)) / 1e3
    return {"run": name, "walls_s": walls, "profiled_wall_s": wall, "device_busy_ms": busy,
            "idle_share_of_profiled_wall": 1.0 - busy / (wall * 1e3),
            "device_first_to_last_ms": span, "ms_by_category": ms, "events_by_category": count,
            "top_kernels_ms_launches": [[name, round(v[0], 3), v[1]] for name, v in top],
            "clocks_sm_power": smi('clocks.sm,power.draw'), "trace": str(trace)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', default='chiprun_out', help="directory for the chrome traces")
    parser.add_argument('--paths', default='', help="comma-separated paths to run (default: all)")
    args = parser.parse_args()
    only = set(filter(None, args.paths.split(',')))

    def wanted(names):
        return [n for n in names if not only or n in only]
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch.cuda.is_available() is false; needs a CUDA GPU")
    from psa_tpu_torch import SEDCalculator
    from psa_tpu_torch.ops.spectral import split_f64
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(smi('name,power.limit'), flush=True)

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    velocities = torch.randn((cs.N_T, cs.N_ATOMS, 3), generator=gen, device=dev)
    calc, k_vecs, grid_shape = cs.working_calculator(dev)
    hi, lo = split_f64(calc.mean_positions64)
    calc.preload_device_group_data(velocities, *(torch.from_numpy(x).to(dev) for x in (hi, lo)))
    paths = {
        'calculate': lambda: calc.calculate(np.array([], np.float32), k_vecs,
                                            summation_mode='coherent', k_grid_shape=grid_shape),
        'kgrid_peaks': lambda: calc.calculate_kgrid_peaks(k_vecs, n_peaks=cs.N_PEAKS,
                                                          k_chunk_size=cs.K_CHUNK_GRID),
        'kgrid_browse': lambda: calc.calculate_kgrid_browse(k_vecs, k_chunk_size=cs.K_CHUNK_GRID),
        'kgrid_browse_f16': lambda: calc.calculate_kgrid_browse(
            k_vecs, k_chunk_size=cs.K_CHUNK_GRID, readback_dtype='float16'),
    }
    for name in wanted(paths):
        print(json.dumps(profile_path(name, paths[name], out_dir)), flush=True)
    host = velocities.cpu().numpy()
    calc.clear_device_cache()
    del velocities
    torch.cuda.empty_cache()
    scalc, _, _ = cs.working_calculator(dev, host)
    scalc.mean_positions64
    streamed = {
        'calculate_streamed': lambda: scalc.calculate(np.array([], np.float32), k_vecs,
                                                      k_grid_shape=grid_shape),
        'kgrid_peaks_streamed': lambda: scalc.calculate_kgrid_peaks(
            k_vecs, n_peaks=cs.N_PEAKS, k_chunk_size=cs.K_CHUNK_GRID),
    }
    for name in wanted(streamed):
        print(json.dumps(profile_path(name, streamed[name], out_dir)), flush=True)
    del scalc
    host_pos = np.empty_like(host)
    if wanted(['npt_peaks']):
        ncalc, miller, _, _ = cs.npt_working_data(dev, host, host_pos)
        print(json.dumps(profile_path('npt_peaks', lambda: ncalc.calculate_npt_peaks(
            miller, n_peaks=cs.N_PEAKS, k_chunk_size=cs.K_CHUNK_GRID), out_dir)), flush=True)
        del ncalc
        torch.cuda.empty_cache()
    traj, kv, side, _, _ = cs.dsf_working_data(dev, host, host_pos)
    dcalc = SEDCalculator(traj, nx=side, ny=side, nz=side, max_device_bytes=cs.DSF_BUDGET,
                          device=dev)
    rdf = dict(r_max=cs.RDF_R_MAX, n_bins=cs.RDF_BINS)
    thermal = {
        'dsf': lambda: dcalc.calculate_dsf(kv),
        'msd': dcalc.calculate_msd,
        'rdf_brute': lambda: dcalc.calculate_rdf(method='brute', max_frames=cs.RDF_BRUTE_FRAMES,
                                                 **rdf),
        'rdf_cells': lambda: dcalc.calculate_rdf(method='cells', max_frames=cs.RDF_CELLS_FRAMES,
                                                 **rdf),
    }
    for name in wanted(thermal):
        print(json.dumps(profile_path(name, thermal[name], out_dir)), flush=True)
        dcalc.clear_device_cache()
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()

"""Drive psa_tpu_torch's paths once on one CUDA GPU, and check them.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the projection kernels from ``psa_tpu_torch/csrc`` (one nvcc
process per source, all at once), checks the 'parity' kernel against its
plain PyTorch version (two ragged shapes and the
working chunk, which must also come out bit for bit the same twice, and
whose error against a float64 sum of the same float32 operands is printed
for the kernel and the plain version), checks the chain-dispersion
physics, runs ``SEDCalculator.calculate`` at the working size (10^5 atoms x
10^4 steps x 2,500 k-points, coherent, parity precision), then
``calculate_kgrid_peaks`` (3 peaks, k-chunks of 1,280) and
``calculate_kgrid_browse`` (float32 and float16 readback) on the same data
against the float64 oracle, the grid reductions' physics at small sizes
(square-lattice peak surface, chiral peaks, L/T split, Welch), each
precision tier ('parity', 'balanced', 'fast') against its plain version at
the working chunk and through ``calculate`` at the working size (phase 5d:
for 'balanced' and 'fast' the table kernel against the plain table, the
product kernel against its plain version, ragged shapes, a view off 16
bytes, ``out=``/``accumulate=``, three atom blocks past a lowered table cap,
a bitwise rerun, each stage timed beside its plain version and the product
stage beside cuBLAS, and the row-copy path at 10^5 - 1 atoms), the gridded (NUFFT) engine on the same data:
``calculate_gridded``, and ``engine='gridded'`` of ``calculate_kgrid_peaks``
and ``calculate_kgrid_browse`` against the direct engine on the 50x50 grid and
on a 200x200 grid, walls in turns, reruns bitwise equal (phase 5e; streamed
under the default budget in phase 7b), then the out-of-core and on-disk path on the same
working-size data: ``calculate``, ``calculate_kgrid_peaks`` and
``calculate_dos`` with the velocities on the host and the default device
budget, so the group streams in atom blocks (phase 7); kill-and-resume
through ``cache_dir`` (phase 8); a LAMMPS dump of 10^4 atoms x 200 frames
loaded with ``TrajectoryLoader`` and streamed with
``sed_from_dump_streaming`` (phase 9); the NPT family at the working size
in a breathing cell against a float64 NPT oracle, a drifting-cell chain and
``ised(npt=True)`` (phase 10); the instantaneous-phase family (DSF, S(k),
ISF and their self parts) at the working size against float64 oracles,
then the DSF, S(k) and self DSF under each phase engine ('exact',
'factored', 'incremental'), one warm call each, each against a float64 oracle
at the k it evaluates (phase 11c), streamed under the default budget with
the exact and the factored engine, and its physics at small sizes (phase
11), each surface's launches of the fused mode-stack kernel counted, and
that kernel against the torch chain on the same card tensors at the DSF
cell's call (phase 11d); the time correlations (``calculate_vacf``, ``calculate_msd``) on the
same working-size data, cold, warm, in other atom chunks and streamed,
against float64 direct sums, and their physics at small sizes (phase 12);
g(r) by the brute sweep (10^5 atoms x 2 frames), by the linked cells (10^5
atoms x 64 frames) and by ``method='auto'``, cells against brute bin for
bin and both against a float64 all-pairs count (phase 13); the command line
(``psa_tpu_torch.cli``) on the 10^4-atom dump with a JSON config holding
every section, in this process and as ``python -m psa_tpu_torch.cli``, its
saved SED against the library's bit for bit (phase 14); an interactive
session through the GUI's headless controller and exports
(``psa_tpu_torch.gui.controller``, ``.gui.export``; never the Tk view), every
compute on a worker thread as the view starts it: a 10^5-atom x 2,000-frame
trajectory loaded from its ``.npy`` sidecars and the 10^4-atom dump through
the C parser, k-path SED (reduced, longitudinal, Welch), a click on a peak,
the full complex spectrum, the 50x50 grid browsed and its peaks by both
engines, DOS, DSF and liquid curves, the iSED reconstruction and every
export, the NPT chain's k-path and Miller grid, two computes started at once,
the kernel against its plain version at every shape the session launched
(phase 15); the mesh sweeps of ``psa_tpu_torch.parallel`` on the one card
(phase 16): ``calculate_kgrid_peaks_sharded`` and
``calculate_kgrid_browse_sharded`` on a virtual (2, 2, 2) mesh of ``cuda:0``
in a one-rank NCCL group, from a BlockSource over the host velocities,
resident and in superchunks, against the one-device sweeps, and
``sharded_sed_spectrum`` against the f64 oracle; the gridded engine's ky
stripes; the instantaneous-phase family, MSD/VACF and g(r) over the mesh at
2,000 frames; two processes on the card over gloo, each reading only its
windows; ``python -m psa_tpu_torch.pod_sweep`` and its resumed rerun;
where four cards are visible (else skipped with a message), the working
velocities resident in atom shards on a (1, 4, 1) mesh of cards 0-3 against
a host source, the call's wall against each card's kernel, the mesh's
counters (16f); the
port's entry points (phase 17): ``bench_torch.op_sweep`` on the working data
against the float64 oracle, ``python3 bench_torch.py`` as a command at its
defaults (its JSON line and the card's name printed), stopped by SIGTERM
after its provisional headline, and with its extras, the kernel against
its plain version on those commands' inputs; each example of
``examples_torch/`` on the card, every launch against the plain version
on its inputs, its printed checks against the same example's on the CPU;
``graft_entry.entry()`` against its CPU path and ``dryrun_multichip(8)``
with and without its extended tier, every launch against the plain
version on its inputs; and the rest of the slice (incoherent groups,
chiral phase, iSED).
Each phase prints one line; any failure raises and the script exits
non-zero.  The line before the last is a JSON record of each kernel (the
'parity' kernel, the table and product kernels at 'balanced' and 'fast',
and the fused mode-stack kernel: launches on the main paths, error, times,
bounds); the last line is
``{"ok": true, "device": {...}}``.  No GPU: exits non-zero before printing
any result.  About 9 minutes on an H100 machine.

    python3 chip_smoke.py --phase 3c

runs phase 3c alone (with the build): the 'parity' kernel's clusters at
their edges (ragged and padded time tiles, ragged k-tiles, unaligned rows,
``accumulate``, an ``out=`` row slice), each against the whole call's bits
and the plain version;

    python3 chip_smoke.py --phase 11d

runs phase 11d alone (with the build) on 32,000 thermal Si atoms made on
the card: the fused mode-stack kernel against the torch chain and a
float64 sum at the DSF cell's call, one atom's phasors at a time, its
repeat, its launch and its wall beside the chain's and its bound;

    python3 chip_smoke.py --phase 16f

runs phase 16f alone (with the build), on a machine with four cards;

    python3 chip_smoke.py --phase 17

runs phase 17 alone (with the build and the working data it needs), and

    python3 chip_smoke.py --phase 18

phase 18 alone: ``calculate``'s pinned host result at the click's shape
(10^5 atoms x 10^4 steps, a 250-k path: one chunk, read back straight into
it; then three chunks), each bit for bit against the staging path that
``PINNED_RESULT_BYTES = 0`` restores, the readback counters, the two paths'
walls in turns, and the host allocations behind the cap.
"""
import contextlib
import json
import logging
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

N_T, N_ATOMS, GRID = 10_000, 100_000, 50       # the working size
K_CHUNK = 500                                   # calculate()'s default k_chunk_size
SEED = 0
TOL_KERNEL = 1e-5   # kernel vs plain: same f32 products, other sum order over 1e5 atoms
TOL_PARITY = 1e-6   # small systems vs the float64 oracle (the repo's parity bar)
TOL_SAME_OPERANDS = 5e-6   # kernel vs a float64 sum of its own float32 operands
DESIGN = "3xtf32-wgmma"   # how csrc/sed_projection.cu multiplies
K_CHUNK_GRID, N_PEAKS = 1280, 3   # bench.py's calculate_kgrid_peaks headline
NEAR_TIE = 1e-5     # oracle peak candidates this close (of the column max) may swap
F16_REL_EPS, F16_REL_FLOOR = 2.0 ** -9, 4e-9   # float16 readback bounds, tests/test_readback.py
TOL_DOS = 1e-6      # streamed vs resident DOS: the same atom chunks, the same FFTs
RESUME_K = 1000     # phase 8: the first 1,000 k of the grid, two chunks of 500
DUMP_ATOMS, DUMP_FRAMES, DUMP_CHUNK = 10_000, 200, 64   # phase 9's LAMMPS dump
TF32_PEAK, BF16_PEAK, HBM_RATE = 495e12, 989e12, 3.35e12   # H100 SXM: dense FLOP/s, HBM bytes/s
FP64_PEAK = 34e12     # H100 SXM float64 FLOP/s outside the tensor cores (NVIDIA's data sheet)
#: calculate at the working size vs the float64 oracle columns, per precision tier
TOL_TIERS = {'parity': TOL_KERNEL, 'balanced': 5e-5, 'fast': 5e-3}
TIER_PEAK = {'parity': TF32_PEAK, 'balanced': BF16_PEAK, 'fast': TF32_PEAK}
#: the tiers of csrc/sed_projection_tiers.cu: a table kernel, then a product kernel
TABLE_TIERS = ('balanced', 'fast')
TABLE_ULPS = 2        # the table kernel's cos/sin vs torch's on the card, float32 ulps of the value
TABLE_FLOP = 8        # float64 operations per angle: the dot (3 mul, 2 add) and the fold (3)
THERMAL_U = 0.05                      # Å, seeded site displacements of the NPT and DSF phases
NPT_AMP, NPT_PERIOD = 0.01, 2_500     # h(t) = h̄ (1 + NPT_AMP sin(2π t / NPT_PERIOD))
DSF_K, SELF_K = 128, 16               # k of the [100] path; of them, those of the self parts
DSF_BUDGET = int(30e9)                # max_device_bytes holding 24 GB of positions + velocities
# Phase 11d: the fused mode-stack kernel at the DSF cell's call (n_t, A, K), C = 4
MODES_CELL = (10_000, 32_000, 128)
MODES_PLAIN_T = 20                    # the torch chain's frames a tile at the cell's 8e9 budget
MODES_COLS = (0, 1, 17, 39, 63, 64, 100, 127)   # columns held to a float64 sum
MODES_HOT = (0, 5, 130, 31_999)       # atoms read one at a time: AP groups, a later stage, the end
MODES_SUM_FACTOR = 2.0                # of the torch chain's error, in units of 2^-24 sum|w|
MODES_ELEMENT_UNITS = 3.0             # sincosf's 2 ulps and the product's rounding, 2^-24|w|
#: Issue slots an element of the function needs: the float64 dot and fold
#: (6: 3 for the dot, the multiply by 1/2pi, rint, the fold), the cast to
#: float32 (1), a sincosf of CUDA's accuracy on a folded angle (21) and the
#: 8 FMAs of C = 4; at 4 warp instructions a clock an SM (PERF.md, PR 23).
MODES_SLOTS = 36
MODES_KERNELS = ('instant_modes_kernel<1>', 'instant_modes_kernel<4>', 'instant_modes_reduce_kernel')
GEN_FRAMES = 500                      # frames per block of positions made on the card
SI_A0 = 5.43                          # Å, the Si cubic cell
TOL_TIMECORR = (5e-5, 1e-4)           # rtol, atol (of max|oracle|) of MSD/VACF vs float64 direct sums
TOL_INVARIANT = 1e-5                  # other atom chunks, streamed vs resident: of max
RDF_R_MAX, RDF_BINS = 6.0, 200        # Å; the g(r) range of phases 13 and 14
RDF_BRUTE_FRAMES, RDF_CELLS_FRAMES = 2, 64
RDF_SUBSAMPLE, RDF_ORACLE_ATOMS = 20_000, 2_000
EDGE_EPS = 2e-6                       # Å: a pair this close to a bin edge may fall either side
BIG_GRID = 200                        # the 200x200 k-grid of the engines' peaks comparison
TOL_PEAK_FREQ = 1e-6                  # THz: peak frequencies of two engines, near-ties apart
TOL_TWO_ENGINES = 2e-5   # the gridded engine vs the direct one, of max: each is held to TOL_KERNEL
#                          against the float64 oracle, so to twice that against the other
PHASE_ENGINES = ('exact', 'factored', 'incremental')
SESSION_FRAMES, SESSION_MIN_FRAMES = 2_000, 500   # phase 15's trajectory; the least after a cut
SESSION_WRITE_BUDGET = 30.0           # s to write its sidecars: beyond it frames are cut, not atoms
SESSION_NK, SESSION_BZ = 250, 4.0     # the view's k-path defaults
SESSION_MODE = (40, 12.0, 0.2)        # a phonon along x on k-path column 40, THz, Å/ps, in the noise
SESSION_MAX_FREQ = 10.0               # THz kept by the session's grid browses (the view's field)
SESSION_DSF_NK = 64                   # k-path points of the DSF and S(k) steps before snapping
SESSION_ISED_FRAMES = 8
SESSION_GRID_CHUNK = 2048             # the controller's k_chunk_size for grids
SESSION_BRIGHT = 0.1   # k-columns whose highest peak reaches this share of the surface's highest
                       # hold the two grid engines' heights per column, the others of the surface
TOL_ENGINES = 5e-5   # a fast phase engine's planes vs the exact engine's, of max: the exact engine
#                      evaluates the float32 k, the factored one the lattice vector it rounds
MESH_SHAPE = (2, 2, 2)                # phase 16's virtual (t, a, k) mesh: 8 positions of MESH_DEVICE
MESH_DEVICE = 'cuda:0'
MESH_SUPERCHUNK = 2_500               # frames: 4 windows of 3 GB each, two superchunks in flight
MESH_STRIPES = 4                      # positions of the gridded engine's ky stripes
MESH_DEPTH = 2_000                    # frames of phase 16c (CUT from N_T)
TOL_MESH_PLANES = 1e-5                # a mesh sweep's planes vs the one-device sweep's, of max
RANK_ATOMS, RANK_FRAMES = 10_000, 2_000   # phase 16d's two-process trajectory
RANK_SUPERCHUNK, RANK_LAGS = 1_000, 64
MESH_CARDS = 4                        # phase 16f's (1, MESH_CARDS, 1) mesh of cards 0 … 3
KPATH_K, KPATH_COVERAGE = 250, 4.0    # phase 18: the click's k-path along x (the kpath cell's)
KPATH_CHUNK = 100                     # k_chunk_size that cuts it into three chunks
KPATH_ROUNDS = 8                      # rounds of (pinned, staging, staging, pinned) walls
HOST_SIZES = (60_000_000, 256_000_000, 1_000_000_000)   # bytes of the host allocations timed
HOST_TRIALS = 3
# Phase 3c: the 'parity' kernel's clusters at their edges.  10,016 steps are 157 time tiles (odd,
# so the last cluster holds a padded tile); 5,000 atoms give 16-byte aligned rows, 5,003 not.
CLUSTER_T, CLUSTER_ATOMS = 10_016, (5_000, 5_003)
CLUSTER_NT, CLUSTER_NK = (1, 64, 65, 129, CLUSTER_T), (1, 33, 64)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def rel(a, b):
    """max|a - b| / max|b|."""
    return float((a - b).abs().max() / b.abs().max())


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def si_sites(n_atoms):
    """Diamond-cubic Si slab sites, float64 (the repo's bench geometry)."""
    a0 = SI_A0
    side = int(np.ceil((n_atoms / 8) ** (1 / 3)))
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing='ij'), axis=-1).reshape(-1, 3)
    basis = np.array([[0, 0, 0], [.25, .25, .25], [.5, .5, 0], [.75, .75, .25],
                      [.5, 0, .5], [.75, .25, .75], [0, .5, .5], [.25, .75, .75]])
    sites = ((cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a0)[:n_atoms]
    return sites, side, a0


def working_calculator(dev, velocities=None, **kw):
    """(calc, k_vecs, grid_shape) of the working size: the Si slab's sites,
    the 50x50 k-grid, and host ``velocities``; without them, host
    placeholders, the velocities living on the card (the caller preloads
    them) under a 13e9-byte budget."""
    from psa_tpu_torch import SEDCalculator, Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    sites, side, a0 = si_sites(N_ATOMS)
    box = np.diag([sites.max() + a0] * 3).astype(np.float32)
    if velocities is None:
        velocities = np.broadcast_to(np.zeros(3, np.float32), (N_T, N_ATOMS, 3))
        kw.setdefault('max_device_bytes', int(13e9))
    traj = Trajectory(np.broadcast_to(sites.astype(np.float32), (N_T, N_ATOMS, 3)), velocities,
                      np.ones(N_ATOMS, dtype=np.int32), np.arange(N_T, dtype=np.float32),
                      box, *make_box_arrays(box), dt_ps=0.01)
    calc = SEDCalculator(traj, nx=side, ny=side, nz=side, device=dev, **kw)
    _, k_vecs, grid_shape = calc.get_k_grid('xy', (-5, 5), (-5, 5), GRID, GRID)
    return calc, k_vecs, grid_shape


def ptxas_by_kernel(log):
    """{kernel: ptxas_counts} for each kernel ``-Xptxas -v`` compiled, named
    with its template arguments, e.g. ``tier_product_kernel<2,1>``."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        found = re.search(r'\d+([a-z_]+_kernel)(I(?:L[a-z]\d+E)+E)?', mangled)
        name = found.group(1) if found else mangled
        if found and found.group(2):
            name += '<' + ','.join(re.findall(r'L[a-z](\d+)E', found.group(2))) + '>'
        out[name] = ptxas_counts(block)
    return out


def ptxas_counts(log):
    """Registers, static shared memory and spills of the first kernel in ``-Xptxas -v`` output."""
    def num(pattern):
        found = re.search(pattern, log)
        return int(found.group(1)) if found else None
    return {"registers": num(r'Used (\d+) registers'), "smem_static_bytes": num(r'(\d+) bytes smem') or 0,
            "spill_stores_bytes": num(r'(\d+) bytes spill stores'),
            "spill_loads_bytes": num(r'(\d+) bytes spill loads')}


def pair_err(got, want):
    """Max abs error and max|want| over a (re, im) pair."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err, max(float(w.abs().max()) for w in want)


def compare_kernel(proj, data, hi, lo, kv, reps):
    """Kernel vs plain on one input: (max_abs_err, rel_err, kernel ms, plain ms)."""
    kern = proj.sed_projection(data, hi, lo, kv)
    plain = proj.sed_projection_plain(data, hi, lo, kv)
    torch.cuda.synchronize()
    err_abs, scale = pair_err(kern, plain)
    del kern, plain
    return (err_abs, err_abs / scale) + time_kernel(proj, data, hi, lo, kv, reps)


def time_kernel(proj, data, hi, lo, kv, reps):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain on one card."""
    plain = [cuda_ms(lambda: proj.sed_projection_plain(data, hi, lo, kv), reps)]
    kern = [cuda_ms(lambda: proj.sed_projection(data, hi, lo, kv), reps) for _ in range(2)]
    plain.append(cuda_ms(lambda: proj.sed_projection_plain(data, hi, lo, kv), reps))
    return float(np.mean(kern)), float(np.mean(plain))


def chunk_errors(proj, data, hi, lo, k_dev, chunk):
    """Kernel vs plain over the whole output of every k-chunk of ``chunk``
    that a path gives the kernel: [((n_t, A, K), rel err), ...]."""
    out = []
    for start in range(0, len(k_dev), chunk):
        kv = k_dev[start:start + chunk]
        err_abs, scale = pair_err(proj.sed_projection(data, hi, lo, kv),
                                  proj.sed_projection_plain(data, hi, lo, kv))
        out.append(((data.shape[0], data.shape[1], len(kv)), err_abs / scale))
    worst = max(err for _, err in out)
    check(worst <= TOL_KERNEL, f"kernel vs plain at the path's chunks {out} > {TOL_KERNEL}")
    return out


def same_operand_errors(proj, data, hi, lo, kv, kern, plain, n_cols=8, atoms=5000):
    """Errors of the kernel and the plain version over the first ``n_cols``
    k-columns against a float64 sum of the same float32 operands (data and
    the float32 cos/sin table), relative to max|sum|."""
    cs = proj.phase_table(hi, lo, kv[:n_cols]).double()
    ref = torch.zeros((data.shape[0], 3, 2 * n_cols), dtype=torch.float64, device=data.device)
    for a0 in range(0, data.shape[1], atoms):
        ref += torch.einsum('tac,an->tcn', data[:, a0:a0 + atoms].double(), cs[a0:a0 + atoms])
    scale = float(ref.abs().max())

    def err(pair):
        got = torch.cat([pair[0][..., :n_cols], pair[1][..., :n_cols]], dim=2).double()
        return float((got - ref).abs().max()) / scale
    return err(kern), err(plain)


def near_tie_columns(inten, n_peaks, exclusion_bins, rel):
    """Columns of float64 planes where some step of the greedy peak search
    meets two candidates within ``rel`` of the column max (noise spectra have
    them; float32 rounding may then pick either)."""
    cur, rows = inten.copy(), np.arange(inten.shape[0])
    scale, tied = cur.max(axis=0), np.zeros(inten.shape[1], dtype=bool)
    for _ in range(n_peaks):
        top2 = np.sort(cur, axis=0)[-2:]
        tied |= top2[1] - top2[0] < rel * scale
        idx = cur.argmax(axis=0)
        cur[np.abs(rows[:, None] - idx[None]) <= exclusion_bins] = 0.0
    return tied


def count_syncs(fn):
    """(fn(), host synchronizations it made), by torch's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if 'synchroniz' in str(w.message)]
    return out, syncs


def grid_working_size(calc, proj, arrays, k_vecs, oracle, cols, dt_ps):
    """Phase 5b: calculate_kgrid_peaks (bench.py's user-headline shape) and
    calculate_kgrid_browse at the working size, held against the float64
    oracle's columns, after the kernel is held against its plain version on
    the (velocities, hi, lo) ``arrays`` at both paths' k-chunks.  Returns the
    launches of each path, the chunk checks, and the peak bins with the
    oracle columns' near-tie mask."""
    from psa_tpu_torch.core.calculator import peaks_np
    n_t, n_k = oracle.shape[0], len(k_vecs)
    freqs = np.fft.fftfreq(n_t, dt_ps)
    pos = freqs >= 0
    freqs_kept = freqs[pos].astype(np.float32)
    orc = (oracle.abs() ** 2).sum(dim=-1).cpu().numpy()[pos]            # (n_keep, 4) float64
    want_launches = -(-n_k // K_CHUNK_GRID)

    t0 = time.perf_counter()
    k_dev = torch.from_numpy(np.ascontiguousarray(k_vecs, dtype=np.float32)).to(arrays[0].device)
    chunks = chunk_errors(proj, *arrays, k_dev, K_CHUNK_GRID)
    torch.cuda.empty_cache()
    log('grid', "kernel vs plain over the whole output at the peaks/browse k-chunks: "
                + ", ".join(f"{s}: rel err {e:.3e}" for s, e in chunks)
                + f" (tol {TOL_KERNEL}); {time.perf_counter() - t0:.2f} s")

    walls, launches = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):                                  # a first call, then a warm one
        torch.cuda.synchronize()
        proj.counters['launch.parity'] = 0
        t0 = time.perf_counter()
        (pf, ph, pw), syncs = count_syncs(lambda: calc.calculate_kgrid_peaks(
            k_vecs, n_peaks=N_PEAKS, k_chunk_size=K_CHUNK_GRID))
        walls.append(time.perf_counter() - t0)
        launches.append(proj.counters['launch.parity'])
        check(launches[-1] == want_launches,
              f"kgrid_peaks launched {launches[-1]} kernels, want {want_launches}")
    peak_mem = torch.cuda.max_memory_allocated() / 1e9
    # the one synchronization of a call is the readback of the peak triplets
    check(len(syncs) == 1, f"warm kgrid_peaks synchronized the host {len(syncs)} times: {syncs}")
    check(pf.shape == (N_PEAKS, n_k) and all(np.isfinite(x).all() for x in (pf, ph, pw)),
          "kgrid_peaks shape/finite")
    want_f, want_h, _ = peaks_np(orc, freqs_kept, n_peaks=N_PEAKS)
    tied = near_tie_columns(orc, N_PEAKS, 4, NEAR_TIE)
    for j in np.flatnonzero(~tied):
        col = cols[j]
        check(np.array_equal(pf[:, col], want_f[:, j]),
              f"peak bins of k-column {col}: {pf[:, col]} != oracle {want_f[:, j]}")
        h_err = float(np.max(np.abs(ph[:, col] - want_h[:, j])) / orc[:, j].max())
        check(h_err <= TOL_KERNEL, f"peak heights of k-column {col}: {h_err:.3e} of max")
    log('grid', f"kgrid_peaks: {n_k} k, n_peaks={N_PEAKS}, k_chunk_size={K_CHUNK_GRID}: "
                f"first {walls[0]:.3f} s, warm {walls[1]:.3f} s wall, "
                f"{n_k / walls[1]:.1f} k-points/s; kernel launches {launches}; host syncs in "
                f"the warm call {len(syncs)} (the readback); peak device memory "
                f"{peak_mem:.1f} GB; {int((~tied).sum())} of {len(cols)} oracle columns checked "
                f"(bins exact, heights <= {TOL_KERNEL} of max), {int(tied.sum())} near-tied")

    out = {}
    for dtype in ('float32', 'float16'):
        proj.counters['launch.parity'] = 0
        t0 = time.perf_counter()
        freqs_b, inten, _ = calc.calculate_kgrid_browse(k_vecs, k_chunk_size=K_CHUNK_GRID,
                                                        readback_dtype=dtype)
        out[dtype] = (time.perf_counter() - t0, inten, proj.counters['launch.parity'])
        check(proj.counters['launch.parity'] == want_launches and inten.shape == (len(freqs_kept), n_k),
              f"kgrid_browse {dtype}: launches {proj.counters['launch.parity']}, shape {inten.shape}")
    exact, f16 = out['float32'][1], out['float16'][1]
    browse_err = float(np.max(np.abs(exact[:, cols] - orc)) / orc.max())
    check(np.array_equal(freqs_b, freqs_kept) and browse_err <= TOL_KERNEL,
          f"kgrid_browse vs f64 oracle {browse_err:.3e} > {TOL_KERNEL}")
    floor = F16_REL_FLOOR * exact.max()
    bright = exact >= floor
    f16_rel = float(np.max(np.abs(f16[bright] - exact[bright]) / exact[bright]))
    f16_dim = float(np.abs(f16[~bright] - exact[~bright]).max()) if (~bright).any() else 0.0
    check(f16_rel <= F16_REL_EPS and f16_dim <= floor,
          f"float16 readback: rel err {f16_rel:.3e}, dim-pixel err {f16_dim:.3e}")
    log('grid', f"kgrid_browse: float32 {out['float32'][0]:.3f} s wall, 4 k-columns vs f64 "
                f"oracle {browse_err:.3e} of max; float16 {out['float16'][0]:.3f} s wall, "
                f"per-pixel rel err {f16_rel:.3e} (<= {F16_REL_EPS:.3e} above {F16_REL_FLOOR} "
                f"of max); launches {out['float32'][2]} and {out['float16'][2]}")
    return launches[-1], out['float32'][2], chunks, (pf, tied)


def peaks_agree(calc, k_vecs, got, want, what, bright_share=0.0):
    """Hold two engines' (or two sweeps') peak triplets together: the
    frequencies within TOL_PEAK_FREQ on every k-column but near-ties, and the
    heights within TOL_TWO_ENGINES of the column's highest on every column
    whose highest reaches ``bright_share`` of the surface's highest (0: every
    column), and of the surface's highest on all.  A column whose
    frequencies differ is refused unless its direct browse planes show two
    candidates within NEAR_TIE of the column's max at some step of the
    search.  Returns (columns that differ, worst height error of the bright
    columns, (bright columns, worst error of the others as a share of their
    own highest, worst error as a share of the surface's highest))."""
    differ = np.flatnonzero((np.abs(got[0] - want[0]) > TOL_PEAK_FREQ).any(axis=0))
    if differ.size:
        check(differ.size <= 0.05 * got[0].shape[1],
              f"{what}: {differ.size} of {got[0].shape[1]} k-columns have other peak frequencies")
        _, planes, _ = calc.calculate_kgrid_browse(k_vecs[differ])
        tied = near_tie_columns(planes.astype(np.float64), N_PEAKS, 4, NEAR_TIE)
        check(bool(tied.all()), f"{what}: k-columns {differ[~tied][:8]} differ in peak frequency "
                                "and are no near-ties")
    same = np.setdiff1d(np.arange(got[0].shape[1]), differ)
    col_err = np.max(np.abs(got[1][:, same] - want[1][:, same]), axis=0)
    top = want[1][0, same]
    bright = top >= bright_share * top.max()
    h_err = float(np.max(col_err[bright] / top[bright]))
    dim_err = float(np.max(col_err[~bright] / top[~bright])) if not bright.all() else 0.0
    surface_err = float(col_err.max() / top.max())
    check(h_err <= TOL_TWO_ENGINES and surface_err <= TOL_TWO_ENGINES,
          f"{what}: peak heights {h_err:.3e} of the column's highest on {int(bright.sum())} "
          f"columns, {surface_err:.3e} of the surface's highest on all")
    return int(differ.size), h_err, (int(bright.sum()), dim_err, surface_err)


def gridded_working_size(calc, proj, k_vecs, grid_shape, oracle, cols, resident_sed):
    """Phase 5e: the gridded (NUFFT) engine at the working size, on the
    resident velocities.  ``calculate_gridded`` against the resident
    ``calculate`` and the f64 oracle columns; ``calculate_kgrid_peaks`` and
    ``calculate_kgrid_browse`` with ``engine='gridded'`` against the direct
    engine on the 50x50 grid; then the peaks of a BIG_GRID x BIG_GRID grid by
    both engines, walls in turns.  No path may launch the projection kernel.
    Returns the gridded 50x50 peaks and the projection launches of each
    gridded path."""
    n_k = len(k_vecs)
    proj.counters['launch.parity'] = 0
    (sed, wall, peak) = timed(lambda: calc.calculate_gridded(k_vecs, grid_shape))
    counts = {"calculate_gridded": proj.counters['launch.parity']}
    check(proj.counters['launch.parity'] == 0, "calculate_gridded launched the projection kernel")
    check(sed.sed.shape == (N_T, n_k, 3) and bool(np.isfinite(sed.sed).all()), "gridded SED")
    vs_direct = float(np.abs(sed.sed - resident_sed).max() / np.abs(resident_sed).max())
    got = torch.from_numpy(np.ascontiguousarray(sed.sed[:, cols, :])).to(oracle.device)
    vs_oracle = rel(got.to(torch.complex128), oracle)
    check(vs_direct <= TOL_TWO_ENGINES and vs_oracle <= TOL_KERNEL,
          f"calculate_gridded vs calculate {vs_direct:.3e}, vs f64 oracle {vs_oracle:.3e}")
    log('gridded', f"calculate_gridded: {n_k} k: {wall:.3f} s wall, {n_k / wall:.1f} k-points/s, "
                   f"peak device memory {peak:.1f} GB; vs the resident calculate {vs_direct:.3e} "
                   f"(tol {TOL_TWO_ENGINES}), 4 k-columns vs f64 oracle {vs_oracle:.3e} of max "
                   f"(tol {TOL_KERNEL})")
    del sed, got

    def direct(kv):
        return calc.calculate_kgrid_peaks(kv, n_peaks=N_PEAKS, k_chunk_size=K_CHUNK_GRID)

    def gridded(kv, shape):
        return calc.calculate_kgrid_peaks(kv, n_peaks=N_PEAKS, engine='gridded', k_grid_shape=shape)

    walls = {}
    _, big_k, big_shape = calc.get_k_grid('xy', (-5, 5), (-5, 5), BIG_GRID, BIG_GRID)
    small = None
    # in turns; the 200x200 direct sweep (32 chunks) runs once, to keep the script's time
    for name, kv, shape, turns in (
            ('50x50', k_vecs, grid_shape, ('direct', 'gridded', 'gridded', 'direct')),
            (f'{BIG_GRID}x{BIG_GRID}', big_k, big_shape, ('direct', 'gridded', 'gridded'))):
        runs = {'direct': [], 'gridded': []}
        for engine in turns:
            proj.counters['launch.parity'] = 0
            out, wall, peak = timed((lambda: direct(kv)) if engine == 'direct'
                                    else (lambda: gridded(kv, shape)))
            runs[engine].append((out, wall, peak))
            want = -(-len(kv) // K_CHUNK_GRID) if engine == 'direct' else 0
            if engine == 'gridded':
                counts["kgrid_peaks_gridded"] = proj.counters['launch.parity']
            check(proj.counters['launch.parity'] == want, f"{engine} peaks of the {name} grid launched the "
                                         f"projection kernel {proj.counters['launch.parity']} times, want {want}")
        (g1, _, g_peak), (g2, _, _) = runs['gridded']
        check(all(np.array_equal(a, b) for a, b in zip(g1, g2)),
              f"two gridded peaks sweeps of the {name} grid differ")
        n_differ, h_err, _ = peaks_agree(calc, kv, g1, runs['direct'][0][0], f"peaks {name}")
        walls[name] = {e: [r[1] for r in runs[e]] for e in runs}
        log('gridded', f"kgrid_peaks {name} ({len(kv)} k, n_peaks={N_PEAKS}), walls in turns: "
                       + "; ".join(f"{e} {' and '.join(f'{x:.3f}' for x in w)} s "
                                   f"({len(kv) / min(w):.1f} k-points/s)"
                                   for e, w in walls[name].items())
                       + f"; peak device memory direct {runs['direct'][0][2]:.1f} GB, gridded "
                       f"{g_peak:.1f} GB; gridded twice bitwise equal; peak frequencies equal "
                       f"(atol {TOL_PEAK_FREQ}) but on {n_differ} near-tied k-columns, heights "
                       f"within {h_err:.3e} of the column's highest (tol {TOL_TWO_ENGINES})")
        if small is None:
            small = g1

    proj.counters['launch.parity'] = 0
    (f_g, i_g, _), wall_g, peak_g = timed(lambda: calc.calculate_kgrid_browse(
        k_vecs, engine='gridded', k_grid_shape=grid_shape))
    counts["kgrid_browse_gridded"] = proj.counters['launch.parity']
    check(proj.counters['launch.parity'] == 0, f"the gridded browse launched the projection kernel "
                              f"{proj.counters['launch.parity']} times")
    (f_d, i_d, _), wall_d, _ = timed(lambda: calc.calculate_kgrid_browse(
        k_vecs, k_chunk_size=K_CHUNK_GRID))
    b_err = float(np.abs(i_g - i_d).max() / i_d.max())
    orc = (oracle.abs() ** 2).sum(dim=-1).cpu().numpy()[np.fft.fftfreq(N_T, calc.dt_ps) >= 0]
    o_err = float(np.abs(i_g[:, cols] - orc).max() / orc.max())
    check(np.array_equal(f_g, f_d) and b_err <= TOL_TWO_ENGINES and o_err <= TOL_KERNEL,
          f"gridded browse vs direct {b_err:.3e}, vs f64 oracle {o_err:.3e}")
    log('gridded', f"kgrid_browse 50x50: gridded {wall_g:.3f} s (peak {peak_g:.1f} GB), direct "
                   f"{wall_d:.3f} s wall; planes vs direct {b_err:.3e} (tol {TOL_TWO_ENGINES}), "
                   f"4 k-columns vs f64 oracle {o_err:.3e} of max (tol {TOL_KERNEL}); 0 projection launches on the gridded "
                   f"browse and peaks")
    return small, counts


def gridded_streamed(dev, proj, host_vel, k_vecs, grid_shape, resident_peaks):
    """Phase 7b: the gridded peaks of the 50x50 grid with the velocities on
    the host under the default device budget: the group streams through the
    NUFFT engine in time superchunks.  Against the resident gridded peaks."""
    scalc, _, _ = working_calculator(dev, host_vel)
    check(scalc._oversize(np.arange(N_ATOMS)), "the working group must exceed max_device_bytes")
    scalc.mean_positions64                           # host mean, outside the timed call
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    proj.counters['launch.parity'] = 0
    got, wall, peak = timed(lambda: scalc.calculate_kgrid_peaks(
        k_vecs, n_peaks=N_PEAKS, engine='gridded', k_grid_shape=grid_shape))
    check(proj.counters['launch.parity'] == 0 and scalc.streamed_bytes == host_vel.nbytes,
          f"streamed gridded peaks: launches {proj.counters['launch.parity']}, {scalc.streamed_bytes} bytes moved")
    n_differ, h_err, _ = peaks_agree(scalc, k_vecs, got, resident_peaks, "streamed gridded peaks")
    log('gridded', f"kgrid_peaks 50x50, engine='gridded', velocities on the host, "
                   f"max_device_bytes={scalc.max_device_bytes:.0e}: {wall:.3f} s wall, "
                   f"{len(k_vecs) / wall:.1f} k-points/s, {scalc.streamed_bytes / 1e9:.1f} GB "
                   f"host->device, peak device memory above the call's start "
                   f"{peak - base / 1e9:.2f} GB; peak frequencies equal the resident sweep's but on "
                   f"{n_differ} near-tied k-columns, heights within {h_err:.3e}")
    return proj.counters['launch.parity']


def grid_small_sizes(dev, proj, chain, ccalc, nu_max, a):
    """Phase 5c: the grid reductions' physics at small sizes on the card,
    after the kernel is held against its plain version at the k-chunks the
    square-lattice runs give it.  Returns the launches of calculate_lt and
    calculate_welch and the chunk checks."""
    from psa_tpu_torch import SEDCalculator
    from psa_tpu_torch.models import (make_chiral_chain_trajectory,
                                      make_square_lattice_trajectory, square_lattice_dispersion)
    from psa_tpu_torch.ops.spectral import split_f64
    lattice = make_square_lattice_trajectory(n_cells=12, n_frames=256, dt_ps=0.01, a=2.5,
                                             nu_max_thz=10.0, seed=4)
    lcalc = SEDCalculator(lattice, nx=12, ny=12, nz=1, device=dev)
    _, kv, _ = lcalc.get_k_grid('xy', (0.0, np.pi / 2.5), (0.0, np.pi / 2.5), 7, 7)
    arrays = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
              for x in (lattice.velocities, *split_f64(lcalc.mean_positions64), kv)]
    chunks = chunk_errors(proj, *arrays, 17)
    log('grid', "kernel vs plain over the whole output at the square lattice's k-chunks: "
                + ", ".join(f"{s}: rel err {e:.3e}" for s, e in chunks) + f" (tol {TOL_KERNEL})")
    proj.counters['launch.parity'] = 0
    pf, _, pw = lcalc.calculate_kgrid_peaks(kv, n_peaks=1, k_chunk_size=17)
    analytic = square_lattice_dispersion(kv[:, 0], kv[:, 1], a=2.5, nu_max_thz=10.0)
    df = 1.0 / (lattice.n_frames * lattice.dt_ps)
    ok = analytic > df
    miss = float(np.max(np.abs(pf[0][ok] - analytic[ok])))
    check(proj.counters['launch.parity'] > 0 and miss <= df + 1e-6 and (pw >= 0).all(),
          f"square-lattice peak surface off by {miss} THz > {df}")
    log('grid', f"square-lattice peak surface on nu(kx, ky): max miss {miss:.4f} THz <= "
                f"{df:.4f}; launches {proj.counters['launch.parity']}")

    chiral = make_chiral_chain_trajectory(n_cells=32, n_frames=250, dt_ps=0.02, a=2.5,
                                          nu_thz=5.0, mode_index=8, handedness=+1, seed=3)
    hcalc = SEDCalculator(chiral, nx=32, ny=1, nz=1, device=dev)
    kv1 = np.array([[2 * np.pi * 8 / (32 * 2.5), 0.0, 0.0]], dtype=np.float32)
    proj.counters['launch.parity'] = 0
    pf, _, _, pph = hcalc.calculate_kgrid_peaks(kv1, n_peaks=1, chiral=True, chiral_axis='x')
    check(proj.counters['launch.parity'] > 0 and abs(pf[0, 0] - 5.0) <= 1.0 / (250 * 0.02) + 1e-6
          and abs(pph[0, 0] - np.pi / 2) < 0.05, f"chiral peak {pf[0, 0]} THz, phase {pph[0, 0]}")
    log('grid', f"chiral peak at {pf[0, 0]:.3f} THz, phase {pph[0, 0]:.5f} rad (expect pi/2); "
                f"launches {proj.counters['launch.parity']}")

    proj.counters['launch.parity'] = 0
    _, i_l, i_t = lcalc.calculate_lt(kv, k_chunk_size=17)
    lt_launches = proj.counters['launch.parity']
    _, inten, _ = lcalc.calculate_kgrid_browse(kv, k_chunk_size=17)
    lt_err = float(np.max(np.abs(i_l + i_t - inten)) / inten.max())
    check(lt_launches > 0 and lt_err <= TOL_PARITY, f"I_L + I_T vs browse {lt_err:.3e}")
    log('grid', f"calculate_lt: I_L + I_T vs browse intensity {lt_err:.3e} of max "
                f"(tol {TOL_PARITY}); launches {lt_launches}")

    k_mags, k_path = ccalc.get_k_path('x', bz_coverage=0.5, n_k=chain.n_atoms // 2 + 1)
    proj.counters['launch.parity'] = 0
    welch = ccalc.calculate_welch(k_mags, k_path, segments=2)
    welch_launches = proj.counters['launch.parity']
    pos = welch.freqs >= 0
    peaks = welch.freqs[pos][np.argmax(welch.sed[pos], axis=0)]
    df_seg = 1.0 / (welch.sed.shape[0] * chain.dt_ps)
    miss = float(np.max(np.abs(peaks[1:] - nu_max * np.abs(np.sin(k_mags[1:] * a / 2)))))
    check(welch_launches > 0 and miss <= df_seg + 1e-6,
          f"Welch chain peaks off by {miss} THz > {df_seg}")
    log('grid', f"calculate_welch, 2 segments: chain peaks on nu = {nu_max}|sin(ka/2)| within "
                f"{miss:.4f} THz <= segment resolution {df_seg:.4f} THz; launches {welch_launches}")
    return lt_launches, welch_launches, chunks


def out_accumulate_checks(proj, gen, rng, dev32, velocities=None, hi_dev=None, lo_dev=None,
                          k_dev=None, precision='parity'):
    """Phase 3, continued (and 5d, per tier): ``out=`` on a row slice and
    ``accumulate=True`` against the plain version's same call, at (197,
    5003, 201), and, given the working chunk, that chunk summed over two
    atom halves.  Returns the rel errors."""
    from psa_tpu_torch.ops.spectral import split_f64
    n_t, n_a, n_k = 197, 5003, 201
    hi, lo = split_f64(rng.uniform(0, 50.0, size=(n_a, 3)))
    args = (torch.randn((n_t, n_a, 3), generator=gen, device=gen.device), dev32(hi),
            dev32(lo), dev32(rng.uniform(-3, 3, size=(n_k, 3))))
    errs = {}
    sig = [torch.full((n_t + 60, 3, n_k), 7.0, device=gen.device) for _ in range(2)]
    rows = [x[20:20 + n_t] for x in sig]
    proj.sed_projection(*args, out=rows, precision=precision)
    want = proj.sed_projection_plain(*args, precision=precision)
    outside = all(bool((x[:20] == 7.0).all() and (x[20 + n_t:] == 7.0).all()) for x in sig)
    e, scale = pair_err(rows, want)
    errs['out_row_slice'] = e / scale
    check(outside and e / scale <= TOL_KERNEL, f"out= row slice {e / scale:.3e}, outside kept {outside}")
    base = proj.sed_projection_plain(args[0].flip(0).contiguous(), *args[1:], precision=precision)
    got = proj.sed_projection(*args, out=[b.clone() for b in base], accumulate=True,
                              precision=precision)
    want = proj.sed_projection_plain(*args, out=[b.clone() for b in base], accumulate=True,
                                     precision=precision)
    e, scale = pair_err(got, want)
    errs['accumulate'] = e / scale
    check(e / scale <= TOL_KERNEL, f"accumulate=True {e / scale:.3e}")
    del sig, rows, base, got, want, args
    if velocities is None:
        return errs

    half = velocities.shape[1] // 2
    outs = {}
    for fn in (proj.sed_projection, proj.sed_projection_plain):
        out = None
        for a0, a1 in ((0, half), (half, velocities.shape[1])):
            part = velocities[:, a0:a1].contiguous()     # the kernel reads whole time steps
            out = fn(part, hi_dev[a0:a1], lo_dev[a0:a1], k_dev, out=out, accumulate=out is not None)
            del part
        outs[fn.__name__] = out
    torch.cuda.synchronize()
    e, scale = pair_err(outs['sed_projection'], outs['sed_projection_plain'])
    errs['working_chunk_two_halves'] = e / scale
    check(e / scale <= TOL_KERNEL, f"working chunk over two atom halves {e / scale:.3e}")
    return errs


def streamed_chunk_errors(scalc, proj, k_vecs):
    """Kernel vs plain through the streamed paths' own loop: every atom block
    of the working group (the ragged last one too) accumulated, as the
    paths do, into ``calculate``'s first k-chunk and into both k-chunks of
    ``calculate_kgrid_peaks``; each accumulated output compared whole.
    Returns the path_chunks_rel_err entries."""
    k_dev = torch.from_numpy(np.ascontiguousarray(k_vecs, dtype=np.float32)).to(scalc.device)
    runs = [('calculate_streamed', k_dev[:K_CHUNK])] + [
        ('kgrid_peaks_streamed', k_dev[s:s + K_CHUNK_GRID])
        for s in range(0, len(k_dev), K_CHUNK_GRID)]
    outs = [[None, None] for _ in runs]
    sizes = []
    for i, (a0, a1, data, hi, lo) in enumerate(scalc._stream_group(np.arange(N_ATOMS))):
        sizes.append(a1 - a0)
        for (_, kv), pair in zip(runs, outs):
            for j, fn in enumerate((proj.sed_projection, proj.sed_projection_plain)):
                pair[j] = fn(data, hi, lo, kv, out=pair[j], accumulate=i > 0)
    torch.cuda.synchronize()
    found = []
    for (path, kv), (kern, plain) in zip(runs, outs):
        err_abs, scale = pair_err(kern, plain)
        found.append({"path": path, "shapes": sorted({(N_T, n, len(kv)) for n in sizes}),
                      "blocks": len(sizes), "rel_err": err_abs / scale})
    worst = max(f["rel_err"] for f in found)
    check(worst <= TOL_KERNEL, f"kernel vs plain through the streamed loop {found} > {TOL_KERNEL}")
    return found


def out_of_core(velocities, calc, proj, k_vecs, grid_shape, oracle, cols, resident_sed,
                resident_peaks):
    """Phase 7: the working-size group on the host under the default device
    budget, so ``calculate``, ``calculate_kgrid_peaks`` and ``calculate_dos``
    stream it in atom blocks; held against the f64 oracle columns and the
    resident results, then the kernel against its plain version through
    the same atom-block loop.  Returns the launches of the two streamed
    paths and the loop's checks."""
    from psa_tpu_torch.core.calculator import _DEFAULT_MAX_DEVICE_BYTES
    t0 = time.perf_counter()
    host = velocities.cpu().numpy()
    t_copy = time.perf_counter() - t0
    scalc, _, _ = working_calculator(velocities.device, host)
    check(scalc.max_device_bytes == _DEFAULT_MAX_DEVICE_BYTES < host.nbytes,
          "the working group must exceed the default max_device_bytes")
    scalc.mean_positions64                           # host mean, outside the timed call
    n_k = len(k_vecs)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    proj.counters['launch.parity'], moved0 = 0, scalc.streamed_bytes
    t0 = time.perf_counter()
    sed = scalc.calculate(np.array([], np.float32), k_vecs, k_grid_shape=grid_shape,
                          k_chunk_size=K_CHUNK)
    wall = time.perf_counter() - t0
    calc_launches = proj.counters['launch.parity']
    moved = (scalc.streamed_bytes - moved0) / 1e9
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    accum = 24 * N_T * n_k / 1e9
    block = scalc.stream_block_atoms(N_ATOMS)
    check(sed.sed.shape == (N_T, n_k, 3) and bool(np.isfinite(sed.sed).all()), "streamed SED")
    got = torch.from_numpy(np.ascontiguousarray(sed.sed[:, cols, :])).to(oracle.device)
    err = rel(got.to(torch.complex128), oracle)
    vs_resident = float(np.abs(sed.sed - resident_sed).max() / np.abs(resident_sed).max())
    check(err <= TOL_KERNEL, f"streamed calculate vs f64 oracle {err:.3e}")
    check(vs_resident <= TOL_KERNEL, f"streamed vs resident calculate {vs_resident:.3e}")
    check(peak <= scalc.max_device_bytes / 1e9 + accum,
          f"streamed peak device memory {peak:.2f} GB over the budget plus accumulators")
    check(calc_launches == -(-N_ATOMS // block) * -(-n_k // K_CHUNK),
          f"streamed calculate launched {calc_launches} kernels")
    log('ooc', f"calculate, velocities on the host ({host.nbytes / 1e9:.1f} GB, copied off the card "
               f"in {t_copy:.2f} s), max_device_bytes={scalc.max_device_bytes:.0e}: {wall:.3f} s "
               f"wall, {n_k / wall:.1f} k-points/s; kernel launches {calc_launches} "
               f"({-(-N_ATOMS // block)} atom blocks of {block} x {-(-n_k // K_CHUNK)} k-chunks); "
               f"host->device {moved:.2f} GB ({moved / wall:.2f} GB/s over the wall); peak device "
               f"memory above the call's start {peak:.2f} GB (budget {scalc.max_device_bytes / 1e9:.1f} "
               f"+ accumulators {accum:.2f}); 4 k-columns vs f64 oracle {err:.3e}, vs the resident "
               f"result {vs_resident:.3e} of max (tol {TOL_KERNEL})")
    del sed, got

    pf_res, tied = resident_peaks
    proj.counters['launch.parity'] = 0
    t0 = time.perf_counter()
    pf, ph, pw = scalc.calculate_kgrid_peaks(k_vecs, n_peaks=N_PEAKS, k_chunk_size=K_CHUNK_GRID)
    peaks_wall = time.perf_counter() - t0
    peaks_launches = proj.counters['launch.parity']
    checked = [int(c) for c, t in zip(cols, tied) if not t]
    check(all(np.array_equal(pf[:, c], pf_res[:, c]) for c in checked),
          "streamed peak bins differ from the resident ones")
    check(np.isfinite(ph).all() and np.isfinite(pw).all() and peaks_launches > 0, "streamed peaks")
    log('ooc', f"kgrid_peaks (streamed into the device peak reduction): {peaks_wall:.3f} s wall, "
               f"{n_k / peaks_wall:.1f} k-points/s; launches {peaks_launches}; bins equal the "
               f"resident peaks' on {len(checked)} of {len(cols)} oracle columns (the others near-tied)")

    walls = {}
    for name, c in (('resident', calc), ('streamed', scalc)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walls[name] = (c.calculate_dos(), time.perf_counter() - t0)
    (f_r, d_r), (f_s, d_s) = walls['resident'][0], walls['streamed'][0]
    dos_err = float(np.abs(d_s - d_r).max() / np.abs(d_r).max())
    check(np.array_equal(f_r, f_s) and dos_err <= TOL_DOS, f"streamed DOS vs resident {dos_err:.3e}")
    log('ooc', f"calculate_dos: resident {walls['resident'][1]:.3f} s, streamed "
               f"{walls['streamed'][1]:.3f} s; streamed vs resident {dos_err:.3e} of max "
               f"(tol {TOL_DOS}), bitwise equal: {bool(np.array_equal(d_s, d_r))}")

    t0 = time.perf_counter()
    loop = streamed_chunk_errors(scalc, proj, k_vecs)
    log('ooc', "kernel vs plain through the streamed atom-block loop, each accumulated output "
               "whole: " + ", ".join(f"{f['path']} {f['blocks']} blocks {f['shapes']}: rel err "
                                     f"{f['rel_err']:.3e}" for f in loop)
               + f" (tol {TOL_KERNEL}); {time.perf_counter() - t0:.2f} s")
    return calc_launches, peaks_launches, loop, host


def resume(calc, proj, k_vecs):
    """Phase 8: ``cache_dir`` on the resident working-size group over the
    first RESUME_K k (two 500-k chunks): run, delete chunk 1, run again;
    the rerun launches one chunk's kernels and is bitwise equal.  The same
    for ``calculate_kgrid_peaks``.  Returns the launches of the reruns."""
    kv = k_vecs[:RESUME_K]
    reruns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (
                ('calculate', lambda d: calc.calculate(np.array([], np.float32), kv,
                                                       k_chunk_size=K_CHUNK, cache_dir=d).sed),
                ('kgrid_peaks', lambda d: np.stack(calc.calculate_kgrid_peaks(
                    kv, n_peaks=N_PEAKS, k_chunk_size=K_CHUNK, cache_dir=d)))):
            d = Path(tmp) / name
            walls, launches, outs = [], [], []
            for step in range(3):
                if step == 1:
                    next(d.glob('*/chunk_00001.npy')).unlink()
                torch.cuda.synchronize()
                proj.counters['launch.parity'] = 0
                t0 = time.perf_counter()
                outs.append(run(d))
                walls.append(time.perf_counter() - t0)
                launches.append(proj.counters['launch.parity'])
            n_chunks = -(-RESUME_K // K_CHUNK)
            check(launches == [n_chunks, 1, 0],
                  f"{name} resume launches {launches}")
            check(all(np.array_equal(o, outs[0]) for o in outs[1:]), f"{name} resume not bitwise")
            mb = sum(p.stat().st_size for p in d.glob('*/chunk_*.npy')) / 1e6
            log('resume', f"{name}(cache_dir=...), {RESUME_K} k in chunks of {K_CHUNK}: first "
                          f"{walls[0]:.3f} s ({launches[0]} launches); chunk 1 deleted, rerun "
                          f"{walls[1]:.3f} s ({launches[1]} launch); full replay {walls[2]:.3f} s "
                          f"({launches[2]}); results bitwise equal; cache {mb:.1f} MB")
            reruns[name] = launches[1]
    return reruns['calculate']


def fixed_columns(values, int_digits, decimals):
    """(..., width) ASCII bytes of ``values`` as sign, ``int_digits`` digits,
    '.', ``decimals`` digits: fixed-width text made without a Python loop."""
    width = int_digits + decimals + 2
    v = np.round(np.abs(values) * 10.0 ** decimals).astype(np.int64)
    out = np.empty(values.shape + (width,), dtype=np.uint8)
    out[..., 0] = np.where(values < 0, ord('-'), ord('+'))
    out[..., int_digits + 1] = ord('.')
    for p in range(int_digits + decimals):             # least significant digit first
        out[..., width - 1 - p if p < decimals else width - 2 - p] = ord('0') + (v // 10 ** p) % 10
    return out


def write_dump(path, seed):
    """A LAMMPS dump of DUMP_FRAMES frames of DUMP_ATOMS Si atoms with
    velocities: sites plus seeded thermal noise, N(0, 1) velocities."""
    rng = np.random.default_rng(seed)
    sites, side, a0 = si_sites(DUMP_ATOMS)
    pos = sites[None] + 0.05 * rng.standard_normal((DUMP_FRAMES, DUMP_ATOMS, 3))
    vel = rng.standard_normal((DUMP_FRAMES, DUMP_ATOMS, 3))
    ids = np.char.zfill(np.arange(1, DUMP_ATOMS + 1).astype(str), 6).astype('S6')
    cols = [np.broadcast_to(np.frombuffer(ids.tobytes(), np.uint8).reshape(DUMP_ATOMS, 6),
                            (DUMP_FRAMES, DUMP_ATOMS, 6)),
            np.full((DUMP_FRAMES, DUMP_ATOMS, 1), ord('1'), np.uint8)]
    cols += [fixed_columns(pos[..., d], 3, 6) for d in range(3)]
    cols += [fixed_columns(vel[..., d], 2, 6) for d in range(3)]
    space = np.full((DUMP_FRAMES, DUMP_ATOMS, 1), ord(' '), np.uint8)
    parts = []
    for c in cols:
        parts += [c, space]
    parts[-1] = np.full((DUMP_FRAMES, DUMP_ATOMS, 1), ord('\n'), np.uint8)
    body = np.concatenate(parts, axis=2)
    length = side * a0
    with open(path, 'wb') as f:
        for t in range(DUMP_FRAMES):
            f.write((f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{DUMP_ATOMS}\n"
                     f"ITEM: BOX BOUNDS pp pp pp\n" + f"0.0 {length:.6f}\n" * 3
                     + "ITEM: ATOMS id type x y z vx vy vz\n").encode())
            f.write(body[t].tobytes())
    return side


def dump_chunk_errors(dev, proj, traj, mean64, kv):
    """Kernel vs plain through ``sed_from_dump_streaming``'s frame-block
    loop: blocks of DUMP_CHUNK frames (the last one ragged) of the loaded
    dump written as ``out=`` row slices of one (n_t, 3, K) signal each; the
    two signals compared whole.  Returns the path_chunks_rel_err entry."""
    from psa_tpu_torch.ops.spectral import split_f64
    hi, lo = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in split_f64(mean64))
    k_dev = torch.from_numpy(np.ascontiguousarray(kv, dtype=np.float32)).to(dev)
    sigs = [[torch.empty((DUMP_FRAMES, 3, len(kv)), device=dev) for _ in range(2)]
            for _ in range(2)]
    shapes = set()
    for i in range(0, DUMP_FRAMES, DUMP_CHUNK):
        j = min(i + DUMP_CHUNK, DUMP_FRAMES)
        block = torch.from_numpy(np.ascontiguousarray(traj.velocities[i:j], np.float32)).to(dev)
        shapes.add((j - i, DUMP_ATOMS, len(kv)))
        for fn, sig in zip((proj.sed_projection, proj.sed_projection_plain), sigs):
            fn(block, hi, lo, k_dev, out=(sig[0][i:j], sig[1][i:j]))
    torch.cuda.synchronize()
    err_abs, scale = pair_err(*sigs)
    check(err_abs / scale <= TOL_KERNEL,
          f"kernel vs plain through the dump's frame blocks {err_abs / scale:.3e} > {TOL_KERNEL}")
    return {"path": "from_dump", "shapes": sorted(shapes),
            "blocks": -(-DUMP_FRAMES // DUMP_CHUNK), "rel_err": err_abs / scale}


def from_disk(dev, proj, k_vecs):
    """Phase 9: a LAMMPS dump written here, loaded with the native parser
    and computed by ``calculate``, then streamed from the file by
    ``sed_from_dump_streaming``; the two must agree to 1e-6 of max.  Then
    the kernel is held against its plain version through the same frame
    blocks.  Returns the launches of the streamed run and that check."""
    from psa_tpu_torch import SEDCalculator, TrajectoryLoader, sed_from_dump_streaming
    from psa_tpu_torch.io import native
    kv = k_vecs[:K_CHUNK]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / 'si.dump'
        t0 = time.perf_counter()
        side = write_dump(path, SEED)
        t_write = time.perf_counter() - t0
        mb = path.stat().st_size / 1e6
        native.build()                          # from the checkout's source, whatever _build/ holds
        parsed = native.bulk_parses
        t0 = time.perf_counter()
        traj = TrajectoryLoader(str(path), dt=0.01, unwrap=False).load()
        t_load = time.perf_counter() - t0
        check(native.bulk_parses - parsed == DUMP_FRAMES,
              f"the loader parsed {native.bulk_parses - parsed} frames natively, not {DUMP_FRAMES}")
        check(traj.positions.shape == (DUMP_FRAMES, DUMP_ATOMS, 3), "loaded shape")
        calc = SEDCalculator(traj, nx=side, ny=side, nz=side, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = calc.calculate(np.array([], np.float32), kv)
        t_calc = time.perf_counter() - t0
        proj.counters['launch.parity'] = 0
        t0 = time.perf_counter()
        streamed = sed_from_dump_streaming(path, 0.01, kv, frame_chunk=DUMP_CHUNK, device=dev)
        t_stream = time.perf_counter() - t0
        launches = proj.counters['launch.parity']
        loop = dump_chunk_errors(dev, proj, traj, calc.mean_positions64, kv)
    err = float(np.abs(streamed.sed - whole.sed).max() / np.abs(whole.sed).max())
    check(launches == -(-DUMP_FRAMES // DUMP_CHUNK), f"from_dump launches {launches}")
    check(np.isfinite(streamed.sed).all() and err <= TOL_PARITY,
          f"streamed from the dump vs calculate on the loaded file {err:.3e}")
    log('disk', f"LAMMPS dump {DUMP_ATOMS} atoms x {DUMP_FRAMES} frames with velocities: "
                f"{mb:.1f} MB written in {t_write:.2f} s; TrajectoryLoader (native parser, "
                f"{DUMP_FRAMES} frames parsed in parallel) {t_load:.3f} s, {mb / t_load:.1f} MB/s "
                f"(with the .npy sidecars); calculate {len(kv)} k {t_calc:.3f} s; "
                f"sed_from_dump_streaming (two passes over the file, blocks of {DUMP_CHUNK} "
                f"frames) {t_stream:.3f} s, launches {launches}; streamed vs loaded {err:.3e} of "
                f"max (tol {TOL_PARITY}), bitwise equal: {bool(np.array_equal(streamed.sed, whole.sed))}")
    log('disk', f"kernel vs plain through the dump's frame blocks {loop['shapes']}, the signal "
                f"whole: rel err {loop['rel_err']:.3e} (tol {TOL_KERNEL})")
    return launches, loop


def f64_oracle(velocities, mean64, k64, atoms=5000):
    """Φ (n_t, K, 3) complex128 of the SED formula, float64 on the card:
    FFT_t[Σ_a v_a exp(i k·mean_a)] / n_t, over atom blocks of ``atoms``."""
    s_re = torch.zeros((velocities.shape[0], k64.shape[0], 3), dtype=torch.float64,
                       device=velocities.device)
    s_im = torch.zeros_like(s_re)
    for a0 in range(0, velocities.shape[1], atoms):
        ph = mean64[a0:a0 + atoms] @ k64.T
        d = velocities[:, a0:a0 + atoms].double()
        s_re += torch.einsum('tac,ak->tkc', d, torch.cos(ph))
        s_im += torch.einsum('tac,ak->tkc', d, torch.sin(ph))
        del d
    return torch.fft.fft(torch.complex(s_re, s_im), dim=0) / velocities.shape[0]


def float_ulp(x):
    """The float32 spacing at |x|."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float('inf'))) - a


def split_at_most(parts, bound):
    """Where the split ``parts`` (one TF32 value, or a bf16 (hi, lo) pair)
    is at most ``bound``: the split is monotone in its value, (hi, lo)
    ordered by hi, then lo."""
    if len(parts) == 1:
        return parts[0] <= bound[0]
    (hi, lo), (b_hi, b_lo) = parts, bound
    return (hi < b_hi) | ((hi == b_hi) & (lo <= b_lo))


def table_checks(proj, hi, lo, kv):
    """The table kernel against its plain version on (hi, lo, kv): each
    tier's split table equal to the split of a value within TABLE_ULPS
    float32 ulps of ``phase_table``'s cos/sin, plus one float32 step of the
    angle where the float64 angle rounds the other way (the split is
    monotone, so it lies between the splits of those bounds).  Returns per
    tier the max abs difference of the split's value (hi + lo) from the
    plain split's, the values whose split differs and the share equal bit
    for bit."""
    n_a, n_k = hi.shape[0], kv.shape[0]
    plain = proj.phase_table(hi, lo, kv)
    slack = TABLE_ULPS * float_ulp(plain) + float_ulp(proj.accurate_angles(hi, lo, kv)).repeat(1, 2)
    out = {}
    for tier in TABLE_TIERS:
        got = proj.untile_table(proj.tier_table(hi, lo, kv, tier), n_a, n_k, tier)
        below, above = proj.tier_split(plain - slack, tier), proj.tier_split(plain + slack, tier)
        inside = split_at_most(below, got) & split_at_most(got, above)
        want = proj.tier_split(plain, tier)
        same = torch.stack([g == w for g, w in zip(got, want)]).all(dim=0)
        check(bool(inside.all()), f"{tier} table: {int((~inside).sum())} values are no split of a "
                                  f"value within {TABLE_ULPS} ulps of phase_table")
        out[tier] = {"max_abs_err": float((sum(got) - sum(want)).abs().max()),   # hi + lo
                     "differ": int((~same).sum()), "bitwise_equal_share": float(same.float().mean())}
        del got, below, above, inside, want, same
    torch.cuda.synchronize()
    return out


def tier_edges(proj, gen, rng, dev32, tier):
    """The tier's kernels against its plain version at ragged shapes: A %
    4 == 0 and != 0 (a view off a 16-byte boundary, copied), one stage, one
    k-point, n_t under 4 (fewer than four time-step maps); then ``out=``
    and ``accumulate=``.  Returns {shape: rel err} and the
    out/accumulate errors; checks each launch counted one table and one
    product."""
    from psa_tpu_torch.ops.spectral import split_f64
    errs = {}
    for n_t, n_a, n_k in ((9, 1000, 77), (9, 1001, 77), (197, 5003, 201), (64, 32, 64),
                          (130, 4096, 1), (3, 1002, 70)):
        hi, lo = split_f64(rng.uniform(0, 50.0, size=(n_a, 3)))
        args = (torch.randn((n_t, n_a, 3), generator=gen, device=gen.device), dev32(hi), dev32(lo),
                dev32(rng.uniform(-3, 3, size=(n_k, 3))))
        views = {(n_t, n_a, n_k): args[0]}
        if n_a % 4:
            views[(n_t - 1, n_a, n_k, 'view')] = args[0][1:]   # starts off a 16-byte boundary
        for key, data in views.items():
            before = (proj.counters['launch.table'], proj.counters['launch.product'])
            err_abs, scale = pair_err(proj.sed_projection(data, *args[1:], precision=tier),
                                      proj.sed_projection_plain(data, *args[1:], precision=tier))
            check((proj.counters['launch.table'], proj.counters['launch.product']) == (before[0] + 1, before[1] + 1),
                  f"{tier} at {key}: launches {before} -> {proj.counters['launch.table'], proj.counters['launch.product']}")
            check(err_abs / scale <= TOL_KERNEL, f"{tier} at {key}: {err_abs / scale:.3e}")
            errs[str(key)] = err_abs / scale
        check(args[0][1:].data_ptr() % 16 or n_a % 4 == 0, "the view must start off 16 bytes")
    return errs, out_accumulate_checks(proj, gen, rng, dev32, precision=tier)


def product_library_ms(proj, velocities, table, n_k, tier):
    """ms of the library (cuBLAS through torch.matmul) doing the product
    stage alone on the tier's table, which the port never calls: 'fast' one
    float32 matmul with TF32 on (switched on for the timing, restored
    after), the same function in one call; 'balanced' the three bf16
    matmuls of its split (no one call computes it: these give bf16 outputs
    and leave the float32 sum to do).  The data are laid out (3 n_t, A) and
    split before the timing."""
    n_t, n_a, _ = velocities.shape
    parts = proj.untile_table(table, n_a, n_k, tier)
    if tier == 'fast':
        d = velocities.transpose(1, 2).reshape(n_t * 3, n_a)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ms = [cuda_ms(lambda: torch.matmul(d, parts[0]), 2) for _ in range(2)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    else:
        d_hi = torch.empty((n_t * 3, n_a), dtype=torch.bfloat16, device=velocities.device)
        d_lo = torch.empty_like(d_hi)
        for t0 in range(0, n_t, 1000):   # the float32 copy of the layout in time-step chunks
            d = velocities[t0:t0 + 1000].transpose(1, 2).reshape(-1, n_a)
            rows = slice(3 * t0, 3 * t0 + d.shape[0])
            d_hi[rows] = d.to(torch.bfloat16)
            d_lo[rows] = (d - d_hi[rows].float()).to(torch.bfloat16)
        del d
        c_hi, c_lo = (c.to(torch.bfloat16) for c in parts)
        ms = [cuda_ms(lambda: (torch.matmul(d_lo, c_hi), torch.matmul(d_hi, c_lo),
                               torch.matmul(d_hi, c_hi)), 2) for _ in range(2)]
    check(not torch.backends.cuda.matmul.allow_tf32, "allow_tf32 must be back to False")
    return float(np.mean(ms))


def tiers(proj, velocities, hi_dev, lo_dev, k_vecs, grid_shape, oracle, cols, gen, rng, dev32,
          ptxas):
    """Phase 5d: the precision tiers at the working chunk.  'parity' (the
    fused kernel) against its plain version; for 'balanced' and 'fast' the
    table kernel against the plain table (table_checks), the product kernel
    against its plain version on the kernel's table, the whole projection
    against ``sed_projection_plain``, a rerun bit for bit, an atom-blocked
    run past a lowered table cap, the edge cases (tier_edges), the time of
    each stage, of the whole and of the plain versions, in turns, and the
    product stage's library time (product_library_ms); then ``calculate``
    at the working size at each tier against the float64 oracle columns,
    its launches of each kernel counted; last the tiers at A = N_ATOMS - 1, whose rows of 3A
    floats leave 16-byte boundaries (the four time-step maps still take
    them).  Returns ({tier: record},
    [kernel records])."""
    k_dev = torch.from_numpy(np.ascontiguousarray(k_vecs[:K_CHUNK], dtype=np.float32)).to(
        velocities.device)
    work = (velocities, hi_dev, lo_dev, k_dev)
    flop = 4.0 * N_T * 3 * N_ATOMS * K_CHUNK
    data_bytes, out_bytes = 4.0 * 3 * N_T * N_ATOMS, 4.0 * 2 * 3 * N_T * K_CHUNK
    bytes_moved = data_bytes + 4.0 * (6 * N_ATOMS + 3 * K_CHUNK) + out_bytes
    table_out_bytes = 4.0 * N_ATOMS * 2 * K_CHUNK
    t0 = time.perf_counter()
    table_errs = table_checks(proj, hi_dev, lo_dev, k_dev)
    log('tiers', f"table kernel at (A,K)=({N_ATOMS},{K_CHUNK}): each value the split of one "
                 f"within {TABLE_ULPS} ulps of phase_table; vs the plain split "
                 + "; ".join(f"{tier} max abs {e['max_abs_err']:.3e}, {e['differ']} values differ, "
                             f"{e['bitwise_equal_share']:.9f} bit for bit"
                             for tier, e in table_errs.items())
                 + f"; {time.perf_counter() - t0:.2f} s")
    out, kernels = {}, []
    for tier in TOL_TIERS:
        plain = proj.sed_projection_plain(*work, precision=tier)
        kern = proj.sed_projection(*work, precision=tier)
        again = proj.sed_projection(*work, precision=tier)
        torch.cuda.synchronize()
        rerun_equal = all(torch.equal(a, b) for a, b in zip(kern, again))
        err_abs, scale = pair_err(kern, plain)
        del kern, again
        check(rerun_equal, f"{tier}: two runs at the working chunk differ")
        check(err_abs / scale <= TOL_KERNEL,
              f"{tier} kernel vs plain at the working chunk {err_abs / scale:.3e} > {TOL_KERNEL}")
        rec = {"max_abs_err": err_abs, "rel_err": err_abs / scale, "rerun_bitwise": rerun_equal}
        plain_ms = [cuda_ms(lambda: proj.sed_projection_plain(*work, precision=tier), 1)]
        if tier == 'parity':
            rec["ms_runs"] = [cuda_ms(lambda: proj.sed_projection(*work, precision=tier), 2)
                              for _ in range(2)]
        else:
            table = proj.tier_table(*work[1:], tier)
            pair_out = tuple(torch.empty_like(x) for x in plain)
            proj.tier_product(velocities, table, K_CHUNK, tier, pair_out)
            p_abs, p_scale = pair_err(pair_out, proj.tier_product_plain(velocities, table, K_CHUNK,
                                                                        tier))
            check(p_abs / p_scale <= TOL_KERNEL, f"{tier} product vs plain {p_abs / p_scale:.3e}")
            saved, before = proj.TABLE_CAP_BYTES, (proj.counters['launch.table'], proj.counters['launch.product'])
            stages = -(-N_ATOMS // proj.TABLE_ATOMS)
            proj.TABLE_CAP_BYTES = proj.table_bytes(-(-stages // 3) * proj.TABLE_ATOMS, K_CHUNK)
            try:
                blocked = proj.sed_projection(*work, precision=tier)
            finally:
                proj.TABLE_CAP_BYTES = saved
            b_abs, b_scale = pair_err(blocked, plain)
            blocked_launches = (proj.counters['launch.table'] - before[0], proj.counters['launch.product'] - before[1])
            del blocked
            check(blocked_launches == (3, 3) and b_abs / b_scale <= TOL_KERNEL,
                  f"{tier} in 3 atom blocks: launches {blocked_launches}, {b_abs / b_scale:.3e}")
            t_plain = [cuda_ms(lambda: proj.tier_table_plain(*work[1:], tier), 2)]
            p_plain = [cuda_ms(lambda: proj.tier_product_plain(velocities, table, K_CHUNK, tier), 1)]
            rec["table_ms_runs"] = [cuda_ms(lambda: proj.tier_table(*work[1:], tier, out=table), 5)
                                    for _ in range(2)]
            rec["product_ms_runs"] = [cuda_ms(lambda: proj.tier_product(velocities, table, K_CHUNK,
                                                                        tier, pair_out), 2)
                                      for _ in range(2)]
            rec["ms_runs"] = [cuda_ms(lambda: proj.sed_projection(*work, precision=tier,
                                                                  out=pair_out), 2)
                              for _ in range(2)]
            t_plain.append(cuda_ms(lambda: proj.tier_table_plain(*work[1:], tier), 2))
            p_plain.append(cuda_ms(lambda: proj.tier_product_plain(velocities, table, K_CHUNK,
                                                                   tier), 1))
            del pair_out
            torch.cuda.empty_cache()
            library_ms = product_library_ms(proj, velocities, table, K_CHUNK, tier)
            del table
            torch.cuda.empty_cache()
            edge_errs, oa_errs = tier_edges(proj, gen, rng, dev32, tier)
            rec.update(table_ms=float(np.mean(rec["table_ms_runs"])),
                       product_ms=float(np.mean(rec["product_ms_runs"])),
                       table_plain_ms=float(np.mean(t_plain)), product_plain_ms=float(np.mean(p_plain)),
                       product_max_abs_err=p_abs, product_rel_err=p_abs / p_scale,
                       blocked_rel_err=b_abs / b_scale, blocked_launches=list(blocked_launches),
                       product_library_ms=library_ms, edges_rel_err=edge_errs,
                       out_accumulate_rel_err=oa_errs)
        plain_ms.append(cuda_ms(lambda: proj.sed_projection_plain(*work, precision=tier), 1))
        del plain
        torch.cuda.empty_cache()

        tcalc, _, _ = working_calculator(velocities.device, precision=tier)
        tcalc.preload_device_group_data(velocities, hi_dev, lo_dev)
        proj.counters['launch.parity'] = proj.counters['launch.table'] = proj.counters['launch.product'] = 0
        t0 = time.perf_counter()
        sed = tcalc.calculate(np.array([], np.float32), k_vecs, k_grid_shape=grid_shape,
                              k_chunk_size=K_CHUNK)
        wall = time.perf_counter() - t0
        launches = (proj.counters['launch.parity'], proj.counters['launch.table'], proj.counters['launch.product'])
        n_chunks = -(-len(k_vecs) // K_CHUNK)
        got = torch.from_numpy(np.ascontiguousarray(sed.sed[:, cols, :])).to(oracle.device)
        calc_err = rel(got.to(torch.complex128), oracle)
        want = (n_chunks, 0, 0) if tier == 'parity' else (0, n_chunks, n_chunks)
        check(bool(np.isfinite(sed.sed).all()) and launches == want,
              f"{tier} calculate: launches (fused, tables, products) {launches}, want {want}")
        check(calc_err <= TOL_TIERS[tier],
              f"{tier} calculate vs f64 oracle {calc_err:.3e} > {TOL_TIERS[tier]}")
        del sed, got, tcalc
        bound = {"operations": flop / TIER_PEAK[tier] * 1e3, "bytes": bytes_moved / HBM_RATE * 1e3}
        bound_by = max(bound, key=bound.get)
        rec.update(ms=float(np.mean(rec["ms_runs"])), plain_ms=float(np.mean(plain_ms)),
                   calculate_rel_err=calc_err, calculate_wall_s=wall, launches=launches[0],
                   table_launches=launches[1], product_launches=launches[2],
                   bound_ms=bound[bound_by], bound_by=bound_by)
        out[tier] = rec
        stages = "" if tier == 'parity' else (
            f" = table {rec['table_ms']:.3f} + product {rec['product_ms']:.3f} ms (plain "
            f"{rec['table_plain_ms']:.3f} + {rec['product_plain_ms']:.3f}; the library on the "
            f"product stage alone {rec['product_library_ms']:.3f}); product vs plain "
            f"{rec['product_rel_err']:.3e}, 3 atom blocks {rec['blocked_rel_err']:.3e}, edges "
            + ", ".join(f"{k} {v:.3e}" for k, v in rec['edges_rel_err'].items())
            + ", " + ", ".join(f"{k} {v:.3e}" for k, v in rec['out_accumulate_rel_err'].items()))
        log('tiers', f"{tier}: working chunk (n_t,A,K)=({N_T},{N_ATOMS},{K_CHUNK}) kernel vs plain "
                     f"rel err {err_abs / scale:.3e} (tol {TOL_KERNEL}), rerun bitwise; kernel "
                     f"{rec['ms']:.3f} ms{stages}; plain {rec['plain_ms']:.3f} ms, bound "
                     f"{bound[bound_by]:.3f} ms by {bound_by}; calculate {len(k_vecs)} k "
                     f"{wall:.3f} s wall, launches (fused, tables, products) {launches}, 4 "
                     f"k-columns vs f64 oracle {calc_err:.3e} (tol {TOL_TIERS[tier]})")
        if tier == 'parity':
            continue
        table_bound = {"operations": TABLE_FLOP * N_ATOMS * K_CHUNK / FP64_PEAK * 1e3,
                       "bytes": (4.0 * (6 * N_ATOMS + 3 * K_CHUNK) + table_out_bytes) / HBM_RATE * 1e3}
        product_bound = {"operations": bound["operations"],
                         "bytes": (data_bytes + table_out_bytes + out_bytes) / HBM_RATE * 1e3}
        source, replaces = "psa_tpu_torch/csrc/sed_projection_tiers.cu", "psa_tpu/ops/pallas_sed.py:116"
        library_call = ("torch.matmul, TF32 on" if tier == 'fast' else
                        "3 torch.matmul of the bf16 split, bf16 outputs (no one call computes it)")
        for name, launches_n, err, ms, p_ms, bnd, lib_ms, kernel, extra in (
                ("sed_tier_table", launches[1], table_errs[tier]['max_abs_err'], rec['table_ms'],
                 rec['table_plain_ms'], table_bound, None, f"tier_table_kernel<{proj.TIERS[tier]}>",
                 {}),
                ("sed_tier_product", launches[2], rec['product_max_abs_err'], rec['product_ms'],
                 rec['product_plain_ms'], product_bound, rec['product_library_ms'],
                 f"tier_product_kernel<{proj.TIERS[tier]}>",
                 {"library_call": library_call,
                  "design_bound_ms": (3 if tier == 'balanced' else 1) * bound["operations"]})):
            by = max(bnd, key=bnd.get)
            kernels.append({"name": f"{name}[{tier}]", "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches_n, "max_abs_err": err,
                            "ms": ms, "plain_ms": p_ms, "bound_ms": bnd[by], "bound_by": by,
                            "library_ms": lib_ms, "ptxas": ptxas.get(kernel), **extra})
    odd = (velocities[:, :N_ATOMS - 1].contiguous(), hi_dev[:N_ATOMS - 1], lo_dev[:N_ATOMS - 1],
           k_dev)
    for tier in TABLE_TIERS:
        err_abs, scale = pair_err(proj.sed_projection(*odd, precision=tier),
                                  proj.sed_projection_plain(*odd, precision=tier))
        check(err_abs / scale <= TOL_KERNEL, f"{tier} at A={N_ATOMS - 1}: {err_abs / scale:.3e}")
        ms = float(np.mean([cuda_ms(lambda: proj.sed_projection(*odd, precision=tier), 2)
                            for _ in range(2)]))
        out[tier].update(row_copy_ms=ms, row_copy_rel_err=err_abs / scale)
        log('tiers', f"{tier} at (n_t,A,K)=({N_T},{N_ATOMS - 1},{K_CHUNK}), rows off 16 bytes: "
                     f"{ms:.3f} ms (at A={N_ATOMS}: {out[tier]['ms']:.3f} ms), kernel "
                     f"vs plain {err_abs / scale:.3e}")
    del odd
    return out, kernels


def fill_positions(host_pos, make_frames):
    """Write positions made on the card into the host array ``host_pos``
    (n_t, N, 3) float32, GEN_FRAMES frames at a time: ``make_frames(t0, t1)``
    returns the (t1 − t0, N, 3) float32 block on the card (and may keep
    what it needs for an oracle)."""
    for t0 in range(0, host_pos.shape[0], GEN_FRAMES):
        t1 = min(t0 + GEN_FRAMES, host_pos.shape[0])
        torch.from_numpy(host_pos[t0:t1]).copy_(make_frames(t0, t1))


def npt_chain(lam, n_cells=16, a=2.5, dt_ps=0.01, mode_m=5, nu_thz=4.0, amp=0.02):
    """A chain in a cell scaled by lam(t) (n_frames values), one commensurate
    phonon riding in fractional space at mode ``mode_m`` and ``nu_thz``."""
    from psa_tpu_torch import Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    n_frames, length = len(lam), n_cells * a
    x_frac = (np.arange(n_cells) + 0.5) / n_cells
    phase = 2 * np.pi * (mode_m * x_frac[None, :] - nu_thz * np.arange(n_frames)[:, None] * dt_ps)
    lam = np.asarray(lam, dtype=np.float64)
    pos = np.zeros((n_frames, n_cells, 3), dtype=np.float32)
    pos[:, :, 0] = (lam[:, None] * length) * (x_frac[None, :] + (amp / length) * np.sin(phase))
    vel = np.zeros_like(pos)
    vel[:, :, 0] = lam[:, None] * amp * (-2 * np.pi * nu_thz) * np.cos(phase)
    boxes = (lam[:, None, None] * np.diag([length, 10.0, 10.0])[None]).astype(np.float32)
    return Trajectory(pos, vel, np.ones(n_cells, dtype=np.int32), np.arange(n_frames, dtype=np.float32),
                      boxes[0], *make_box_arrays(boxes[0]), dt_ps=dt_ps, box_matrices=boxes)


def npt_small(dev, proj):
    """Phase 10b: a chain whose cell drifts by 10%: the fractional anchor
    keeps the ridden phonon on its frequency with clean neighbours, where
    the fixed-cell projection loses its peak; then ``ised(npt=True)``."""
    from psa_tpu_torch import SEDCalculator
    nu, mode_m, n_frames = 4.0, 7, 128
    traj = npt_chain(1.0 + 0.10 * np.linspace(0.0, 1.0, n_frames), mode_m=mode_m)
    calc = SEDCalculator(traj, nx=16, ny=1, nz=1, device=dev)
    m = np.stack([np.arange(1, 9), np.zeros(8), np.zeros(8)], axis=1)
    proj.counters['launch.parity'] = 0
    sed = calc.calculate_npt(m)
    launches = proj.counters['launch.parity']
    pos = sed.freqs >= 0
    inten, col = sed.intensity[pos], mode_m - 1
    df = sed.freqs[1] - sed.freqs[0]
    kv = (2 * np.pi / (16 * 2.5)) * m.astype(np.float32)
    fixed = calc.calculate(np.linalg.norm(kv, axis=1), kv).intensity[pos]
    peak = sed.freqs[pos][np.argmax(inten[:, col])]
    side = max(inten[:, col - 1].max(), inten[:, col + 1].max()) / inten[:, col].max()
    gain = inten[:, col].max() / fixed[:, col].max()
    check(launches > 0 and abs(peak - nu) <= df + 1e-9 and side < 0.05 and gain > 1.2,
          f"NPT chain: peak {peak} THz, neighbours {side:.3e} of it, gain over fixed cell {gain:.2f}")
    log('npt', f"drifting chain (10% over {n_frames} frames): ridden phonon at {peak:.3f} THz "
               f"(want {nu}), neighbours {side:.2e} of its peak, {gain:.2f}x the fixed-cell peak; "
               f"launches {launches}")
    lam = 1.0 + 0.03 * np.sin(np.linspace(0, 2 * np.pi, 96))
    icalc = SEDCalculator(npt_chain(lam), nx=16, ny=1, nz=1, device=dev)
    proj.counters['launch.parity'] = 0
    with tempfile.TemporaryDirectory() as tmp:
        dump = f"{tmp}/npt.dump"
        icalc.ised(k_dir_spec=[1, 0, 0], k_target=2 * np.pi * 5 / (lam.mean() * 16 * 2.5),
                   w_target=4.0, char_len_k_path=2.5, nk_on_path=8, bz_cov_ised=8.0,
                   rescale_factor='auto', n_recon_frames=32, dump_filepath=dump, npt=True)
        with open(dump) as f:
            n_frames = f.read().count("ITEM: TIMESTEP")
    check(n_frames == 32 and proj.counters['launch.parity'] > 0, f"NPT iSED dump frames {n_frames}")
    log('npt', f"ised(npt=True) dump: {n_frames} frames of 16 atoms; launches {proj.counters['launch.parity']}")
    return launches


def npt_working_data(dev, host_vel, host_pos):
    """The working size in a breathing cell, h(t) = h̄ (1 + NPT_AMP
    sin(2πt/NPT_PERIOD)), r_a(t) = h(t)(s_a + u_a(t)) with seeded
    displacements u made on the card and written into ``host_pos``, and the
    velocities ``host_vel``: (calculator holding the velocities on the card,
    the 50x50 Miller grid spanning the fixed-cell grid's k range, the
    oracle's float64 s̄ on the card, seconds to make the positions)."""
    from psa_tpu_torch import SEDCalculator, Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    sites, side, a0 = si_sites(N_ATOMS)
    length = float(np.float32(sites.max() + a0))
    lam = 1.0 + NPT_AMP * np.sin(2 * np.pi * np.arange(N_T) / NPT_PERIOD)
    h32 = (lam * length).astype(np.float32)                 # the diagonal of h(t), as stored
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    s_dev = torch.from_numpy(sites / length).to(dev)
    h_dev = torch.from_numpy(h32.astype(np.float64)).to(dev)
    sbar = torch.zeros((N_ATOMS, 3), dtype=torch.float64, device=dev)

    def frames(t0, t1):
        u = torch.randn((t1 - t0, N_ATOMS, 3), generator=gen, device=dev) * (THERMAL_U / length)
        r = (h_dev[t0:t1, None, None] * (s_dev[None] + u.double())).float()
        sbar.add_((r.double() / h_dev[t0:t1, None, None]).sum(dim=0))   # oracle s̄ = mean h⁻¹ r
        return r
    t0 = time.perf_counter()
    fill_positions(host_pos, frames)
    sbar /= N_T
    t_gen = time.perf_counter() - t0
    boxes = h32[:, None, None] * np.eye(3, dtype=np.float32)[None]
    traj = Trajectory(host_pos, host_vel, np.ones(N_ATOMS, dtype=np.int32),
                      np.arange(N_T, dtype=np.float32), boxes[0], *make_box_arrays(boxes[0]),
                      dt_ps=0.01, box_matrices=boxes)
    ncalc = SEDCalculator(traj, nx=side, ny=side, nz=side, max_device_bytes=int(13e9), device=dev)
    m_max = round(5.0 * length / (2 * np.pi))              # |k| <= 5 Å⁻¹, the fixed-cell grid
    axis = np.rint(np.linspace(-m_max, m_max, GRID))
    miller = np.stack([np.repeat(axis, GRID), np.tile(axis, GRID), np.zeros(GRID * GRID)], axis=1)
    return ncalc, miller, sbar, t_gen


def npt_working_size(dev, proj, velocities, host_vel, host_pos):
    """Phase 10: :func:`npt_working_data`'s breathing cell:
    ``calculate_npt_peaks`` on its Miller grid, then ``calculate_npt`` on
    the same k, against a float64 NPT oracle on the card; the kernel against
    its plain version at the paths' k-chunks.  Returns the launches of the
    two paths and the checks."""
    from psa_tpu_torch.core.calculator import peaks_np
    from psa_tpu_torch.ops.spectral import split_f64
    ncalc, miller, sbar, t_gen = npt_working_data(dev, host_vel, host_pos)
    boxes = ncalc.traj.box_matrices
    m_max = int(miller[:, 0].max())
    n_k = len(miller)

    walls, launches = [], []
    for _ in range(2):                                       # the first call sums s̄ and uploads
        torch.cuda.synchronize()
        proj.counters['launch.parity'] = 0
        t0 = time.perf_counter()
        pf, ph, _, k_cart = ncalc.calculate_npt_peaks(miller, n_peaks=N_PEAKS,
                                                       k_chunk_size=K_CHUNK_GRID)
        walls.append(time.perf_counter() - t0)
        launches.append(proj.counters['launch.parity'])
    check(launches == [-(-n_k // K_CHUNK_GRID)] * 2, f"npt_peaks launches {launches}")
    proj.counters['launch.parity'] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sed = ncalc.calculate_npt(miller, k_chunk_size=K_CHUNK)
    npt_wall = time.perf_counter() - t0
    npt_launches = proj.counters['launch.parity']
    peak_mem = torch.cuda.max_memory_allocated() / 1e9
    check(npt_launches == -(-n_k // K_CHUNK) and sed.sed.shape == (N_T, n_k, 3)
          and bool(np.isfinite(sed.sed).all()), f"calculate_npt launches {npt_launches}")

    sbar_port = ncalc._fractional_mean_positions64()
    sbar_err = float(np.abs(sbar_port - sbar.cpu().numpy()).max() / np.abs(sbar_port).max())
    check(sbar_err <= 1e-12, f"fractional mean vs the oracle's {sbar_err:.3e}")
    cols = np.array([0, n_k * 777 // 2500, n_k // 2, n_k - 1])     # phase 5's columns
    k_eff = (2.0 * np.pi * miller).astype(np.float32)
    oracle = f64_oracle(velocities, sbar, torch.from_numpy(k_eff[cols].astype(np.float64)).to(dev))
    got = torch.from_numpy(np.ascontiguousarray(sed.sed[:, cols, :])).to(dev).to(torch.complex128)
    err = rel(got, oracle)
    check(err <= TOL_KERNEL, f"calculate_npt vs f64 NPT oracle {err:.3e} > {TOL_KERNEL}")
    del sed, got
    freqs = np.fft.fftfreq(N_T, 0.01)
    keep = freqs >= 0
    orc = (oracle.abs() ** 2).sum(dim=-1).cpu().numpy()[keep]
    want_f, want_h, _ = peaks_np(orc, freqs[keep].astype(np.float32), n_peaks=N_PEAKS)
    tied = near_tie_columns(orc, N_PEAKS, 4, NEAR_TIE)
    for j in np.flatnonzero(~tied):
        col = cols[j]
        h_err = float(np.max(np.abs(ph[:, col] - want_h[:, j])) / orc[:, j].max())
        check(np.array_equal(pf[:, col], want_f[:, j]) and h_err <= TOL_KERNEL,
              f"NPT peaks of k-column {col}: bins {pf[:, col]} vs {want_f[:, j]}, heights {h_err:.3e}")
    check(np.allclose(k_cart[:, 0], 2 * np.pi * miller[:, 0] / boxes.astype(np.float64)[:, 0, 0].mean(),
                      rtol=1e-6), "k_cart is the mean cell's image of m")
    log('npt', f"breathing cell (±{NPT_AMP:.0%}, period {NPT_PERIOD} frames), {N_ATOMS} atoms x {N_T} "
               f"frames made on the card and copied to the host in {t_gen:.2f} s; "
               f"calculate_npt_peaks {n_k} Miller k (|m| <= {m_max}), n_peaks={N_PEAKS}: first "
               f"{walls[0]:.3f} s (s̄ and the velocity upload), warm {walls[1]:.3f} s, "
               f"{n_k / walls[1]:.1f} k-points/s, launches {launches}; {int((~tied).sum())} of 4 oracle "
               f"columns' peaks checked (bins exact, heights <= {TOL_KERNEL} of max)")
    log('npt', f"calculate_npt {n_k} k: {npt_wall:.3f} s wall, {n_k / npt_wall:.1f} k-points/s, "
               f"launches {npt_launches}, peak device memory {peak_mem:.1f} GB; 4 k-columns vs the "
               f"f64 NPT oracle {err:.3e} (tol {TOL_KERNEL}); s̄ vs the oracle's {sbar_err:.2e}")

    hi, lo = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in split_f64(sbar_port))
    k_dev = torch.from_numpy(k_eff).to(dev)
    t0 = time.perf_counter()
    chunks = chunk_errors(proj, velocities, hi, lo, k_dev, K_CHUNK_GRID)
    chunks += chunk_errors(proj, velocities, hi, lo, k_dev[:K_CHUNK], K_CHUNK)
    log('npt', "kernel vs plain over the whole output at the NPT paths' k-chunks: "
               + ", ".join(f"{s}: rel err {e:.3e}" for s, e in chunks)
               + f" (tol {TOL_KERNEL}); {time.perf_counter() - t0:.2f} s")
    del ncalc, oracle
    torch.cuda.empty_cache()
    return launches[-1], npt_launches, chunks


def dsf_oracles(pos, vel, k64, self_k64, n_lags, atoms=2000):
    """float64 oracles on the card of the instantaneous-phase family from
    the (n_t, N, 3) float32 positions and velocities: (S, C_L, S(k), F)
    on the columns ``k64`` and (S_s, F_s) on ``self_k64``, all rows, each
    normalized by N, the ISF rows for τ < n_lags."""
    from psa_tpu_torch.ops.instantaneous import _autocorr_fft_len
    n_t, n_a = pos.shape[:2]
    fft_len = _autocorr_fft_len(n_t)
    rho = torch.zeros((n_t, k64.shape[0]), dtype=torch.complex128, device=pos.device)
    cur = torch.zeros((n_t, k64.shape[0], 3), dtype=torch.complex128, device=pos.device)
    s_self = torch.zeros((n_t, self_k64.shape[0]), dtype=torch.float64, device=pos.device)
    f_self = torch.zeros((n_lags, self_k64.shape[0]), dtype=torch.float64, device=pos.device)
    lags = (n_t - torch.arange(n_lags, device=pos.device)).double()
    for a0 in range(0, n_a, atoms):
        p = pos[:, a0:a0 + atoms].double()
        ph = torch.exp(1j * (p @ k64.T))                               # (n_t, a, K)
        rho += ph.sum(dim=1)
        cur += torch.einsum('tak,tac->tkc', ph, vel[:, a0:a0 + atoms].double().to(ph.dtype))
        ph = torch.exp(1j * (p @ self_k64.T))
        s_self += (torch.fft.fft(ph, dim=0).abs() ** 2).sum(dim=1) / n_t ** 2
        spec = torch.fft.fft(ph, n=fft_len, dim=0)
        corr = torch.fft.ifft(spec.abs() ** 2 + 0j, dim=0)[:n_lags].real.sum(dim=1)
        f_self += corr / lags[:, None]
        del p, ph, spec
    rho_w = torch.fft.fft(rho, dim=0) / n_t
    cur_w = torch.fft.fft(cur, dim=0) / n_t
    k_unit = k64 / torch.clamp(k64.norm(dim=1, keepdim=True), min=1e-300)
    c_l = (cur_w * k_unit[None]).sum(dim=-1).abs() ** 2
    spec = torch.fft.fft(rho, n=fft_len, dim=0)
    isf = torch.fft.ifft(spec.abs() ** 2 + 0j, dim=0)[:n_lags].real / lags[:, None]
    return [x / n_a for x in (rho_w.abs() ** 2, c_l, (rho.abs() ** 2).mean(dim=0), isf,
                              s_self, f_self)]


def dsf_working_data(dev, host_vel, host_pos):
    """The Si sites in a fixed cell with seeded thermal displacements made on
    the card and written into ``host_pos``, and the velocities ``host_vel``:
    (trajectory, the DSF_K-point commensurate [100] path, cells per side,
    box length, seconds to make the positions)."""
    from psa_tpu_torch import Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    from psa_tpu_torch.ops.instantaneous import nearest_commensurate
    sites, side, a0 = si_sites(N_ATOMS)
    length = float(np.float32(sites.max() + a0))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sites_dev = torch.from_numpy(sites).to(dev)
    t0 = time.perf_counter()
    fill_positions(host_pos, lambda t0, t1: (sites_dev[None] + THERMAL_U * torch.randn(
        (t1 - t0, N_ATOMS, 3), generator=gen, device=dev, dtype=torch.float64)).float())
    t_gen = time.perf_counter() - t0
    box = np.diag([length] * 3).astype(np.float32)
    traj = Trajectory(host_pos, host_vel, np.ones(N_ATOMS, dtype=np.int32),
                      np.arange(N_T, dtype=np.float32), box, *make_box_arrays(box), dt_ps=0.01)
    kv = nearest_commensurate(np.outer(np.arange(DSF_K) * (2 * np.pi / length), [1.0, 0.0, 0.0]),
                              traj.box_lengths)
    check(len(np.unique(kv[:, 0])) == DSF_K, "the [100] path must hold DSF_K distinct k")
    return traj, kv, side, length, t_gen


def phasor_counts(counted):
    """(launches of the fused mode-stack kernel, its elements, the 'exact'
    contraction's elements) in a :func:`profiling.counted_since` record."""
    return tuple(counted.get(n, 0) for n in ('launch.phasor_modes', 'phasor.fused_elems',
                                             'phasor.exact_elems'))


def modes_reference64(pos, vel, kv, cols, atoms=2000):
    """Σ_a w_c e^{i k·r_a(t)} in float64 from the float32 operands on
    ``cols`` of ``kv``, w = [1, v]: (re, im) (n_t, len(cols), 4), and
    Σ_a |w_c| (n_t, 1, 4), which bounds every partial sum of either."""
    n_t = pos.shape[0]
    out = torch.zeros((n_t, len(cols), 4), dtype=torch.complex128, device=pos.device)
    mag = torch.zeros((n_t, 1, 4), dtype=torch.float64, device=pos.device)
    k64 = kv[cols].double()
    for a0 in range(0, pos.shape[1], atoms):
        v = vel[:, a0:a0 + atoms].double()
        w = torch.cat([torch.ones_like(v[..., :1]), v], dim=-1)
        ph = torch.exp(1j * (pos[:, a0:a0 + atoms].double() @ k64.T))
        out += torch.einsum('tak,tac->tkc', ph, w.to(ph.dtype))
        mag += w.abs().sum(dim=1, keepdim=True)
        del ph, w, v
    return out.real, out.imag, mag


def modes_sum_units(got, ref, cols=None):
    """max over elements of |got − ref| in units of 2⁻²⁴ Σ_a |w| (the
    element's (t, c) magnitudes): a float32 sum's error in these units does
    not grow where the sum cancels.  With ``cols``, ``got`` is read there."""
    re, im, mag = ref
    return max(float(((g if cols is None else g[:, cols]).double() - r).abs().div_(
        mag * 2.0 ** -24).max()) for g, r in zip(got, (re, im)))


def modes_where(got, ref, cols):
    """Where ``got`` lies furthest from ``ref`` by the column's largest value
    (the old measure): that error, the (frame, column, channel), the
    column's max |ref| and |ref| there."""
    worst = (0.0,)
    for g, r in zip(got, ref[:2]):
        colmax = r.abs().amax(dim=0)
        rel_err = (g[:, cols].double() - r).abs() / colmax.clamp_min(1e-300)
        i = int(rel_err.argmax())
        t, kc = divmod(i, rel_err.shape[1] * rel_err.shape[2])
        k, c = divmod(kc, rel_err.shape[2])
        if float(rel_err.max()) > worst[0]:
            worst = (float(rel_err.max()), t, int(cols[k]), c, float(colmax[k, c]),
                     float(r[t, k, c].abs()))
    return dict(zip(("rel_err", "frame", "column", "channel", "column_max", "value_there"),
                    worst))


def modes_element_units(launch, pos, vel, kv, atoms, weight=0.75):
    """For each of ``atoms``, ``launch(acc, weights)`` with ``weight`` on it
    and 0 on the others, so each output is that atom's phasor times
    w = fl32(weight · [1, v]); the largest distance from w·(cos θ, sin θ),
    θ the float64 folded angle, beyond what the float32 rounding of θ moves
    it (|θ₃₂ − θ| times the other function's magnitude, plus (θ₃₂ − θ)²/2),
    in units of 2⁻²⁴·|w|.  sincosf keeps it within 3: its 2 ulps and the
    product's rounding."""
    n_t, n_a, _ = pos.shape
    worst = 0.0
    for atom in atoms:
        weights = torch.zeros(n_a, device=pos.device)
        weights[atom] = weight
        acc = [torch.zeros((n_t, len(kv), 4), device=pos.device) for _ in range(2)]
        launch(acc, weights)
        theta = pos[:, atom].double() @ kv.double().T
        theta -= 2 * torch.pi * torch.round(theta / (2 * torch.pi))
        delta = (theta.float().double() - theta).abs()
        w = torch.cat([torch.ones_like(vel[:, atom, :1]), vel[:, atom]], dim=-1)
        w = (w * weight).double()[:, None, :]
        for got, f, other in ((acc[0], torch.cos, torch.sin), (acc[1], torch.sin, torch.cos)):
            allow = (other(theta).abs() * delta + delta ** 2 / 2)[..., None] * w.abs()
            excess = (got.double() - w * f(theta)[..., None]).abs() - allow
            worst = max(worst, float((excess / (w.abs() * 2.0 ** -24)).max()))
        del acc, theta, delta
    return worst


def modes_checks(outs, launches, pos, vel, kv):
    """Phase 11d's checks of each version in ``outs`` ({name: (re, im)} at
    the call, 'plain' the torch chain; ``launches`` {name: f(acc, weights)}
    for the versions that take weights): against a float64 sum on
    MODES_COLS in units of 2⁻²⁴ Σ|w| (each within MODES_SUM_FACTOR of the
    plain chain's, over a floor of one unit), against the plain chain on
    every column in the same units, the old measure and where it peaks, and
    the phasors one atom at a time (:func:`modes_element_units`, within
    MODES_ELEMENT_UNITS).  Returns {name: record with ``passes``}."""
    cols = torch.tensor(MODES_COLS, device=pos.device)
    ref = modes_reference64(pos, vel, kv, cols)
    base = modes_sum_units(outs['plain'], ref, cols)
    mag = ref[2]
    out = {}
    for name, got in outs.items():
        rec = {"sum_units": modes_sum_units(got, ref, cols),
               "vs_plain_units": modes_sum_units(got, (*outs['plain'], mag)),
               "vs_plain_max_abs": max(float((g - p).abs().max())
                                       for g, p in zip(got, outs['plain'])),
               "old_measure": modes_where(got, ref, cols)}
        if name in launches:
            rec["element_units"] = modes_element_units(launches[name], pos, vel, kv, MODES_HOT)
        rec["passes"] = (rec["sum_units"] <= MODES_SUM_FACTOR * max(base, 1.0)
                         and rec["vs_plain_units"] <= (1 + MODES_SUM_FACTOR) * max(base, 1.0)
                         and rec.get("element_units", 0.0) <= MODES_ELEMENT_UNITS)
        out[name] = rec
    return out


def modes_at_cell_shape(pos, vel, kv):
    """Phase 11d: the fused mode-stack kernel (``instantaneous.fused_modes``)
    against the torch chain (``accumulate_modes_plain`` in the cell's
    20-frame tiles) on the same card tensors at the DSF cell's call,
    (n_t, A, K, C) = (10⁴, 32,000, 128, 4), ``pos``/``vel`` an atom slice:
    two launches bit for bit, :func:`modes_checks`, one launch counted, the
    walls in turns (CUDA events), and the bound of the work the function
    needs (MODES_SLOTS instructions an element at the card's top clock).
    Returns the ``kernels`` line's entry."""
    from psa_tpu_torch.ops import instantaneous as inst
    from psa_tpu_torch.utils import profiling
    n_t, n_a, _ = pos.shape
    check((n_t, n_a, len(kv)) == MODES_CELL, f"phase 11d runs at {MODES_CELL}")

    def fresh():
        return [torch.zeros((n_t, len(kv), 4), device=pos.device) for _ in range(2)]
    outs = {'this': fresh(), 'again': fresh(), 'plain': fresh()}
    before = profiling.snapshot()
    inst.fused_modes(*outs['this'], pos, vel, kv)
    counted = profiling.counted_since(before)
    inst.fused_modes(*outs['again'], pos, vel, kv)
    inst.accumulate_modes_plain(*outs['plain'], pos, vel, kv, MODES_PLAIN_T)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs.pop('again'), outs['this']))
    check(same and counted == {'launch.phasor_modes': 1, 'phasor.fused_elems': n_t * n_a * len(kv)},
          f"the fused kernel: bitwise repeat {same}, counted {counted}")
    recs = modes_checks(outs, {'this': lambda acc, w: inst.fused_modes(*acc, pos, vel, kv, w)},
                        pos, vel, kv)
    check(recs['this']['passes'], f"the fused kernel vs the torch chain and float64: {recs}")
    acc = fresh()
    ms = {'this': [], 'plain': []}
    for _ in range(2):
        ms['plain'].append(cuda_ms(lambda: inst.accumulate_modes_plain(
            *acc, pos, vel, kv, MODES_PLAIN_T), 1))
        ms['this'].append(cuda_ms(lambda: inst.fused_modes(*acc, pos, vel, kv), 5))
    top_mhz = float(subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                                    '--format=csv,noheader,nounits'], capture_output=True,
                                   text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(pos.device).multi_processor_count
    bound_ms = n_t * n_a * len(kv) * MODES_SLOTS / (sms * 128 * top_mhz * 1e6) * 1e3
    rec = recs['this']
    log('modes', f"fused mode-stack kernel at (n_t, A, K, C) = {MODES_CELL + (4,)}, an atom "
                 f"slice: {np.mean(ms['this']):.3f} ms ({ms['this']}), the torch chain "
                 f"{np.mean(ms['plain']):.3f} ms; bound {bound_ms:.3f} ms ({MODES_SLOTS} "
                 f"instructions an element at {top_mhz:.0f} MHz); two launches bit for bit; "
                 f"vs float64 on {len(MODES_COLS)} columns {rec['sum_units']:.3f} units of "
                 f"2^-24 sum|w| (the torch chain {recs['plain']['sum_units']:.3f}; tol "
                 f"{MODES_SUM_FACTOR}x), vs the chain {rec['vs_plain_units']:.3f} units, max abs "
                 f"{rec['vs_plain_max_abs']:.3e}; one atom at a time {rec['element_units']:.3f} "
                 f"units of 2^-24|w| beyond the angle's rounding (tol {MODES_ELEMENT_UNITS}); "
                 f"by the column's max: this {rec['old_measure']}, the chain "
                 f"{recs['plain']['old_measure']}")
    return {"name": "instant_modes", "route": "cuda", "source": "psa_tpu_torch/csrc/instant_modes.cu",
            "replaces": "none: psa_tpu/ops/instantaneous.py leaves the chain to XLA",
            "shape": list(MODES_CELL) + [4], "launches": counted['launch.phasor_modes'],
            "max_abs_err": rec['vs_plain_max_abs'], "sum_units": rec['sum_units'],
            "plain_sum_units": recs['plain']['sum_units'], "vs_plain_units": rec['vs_plain_units'],
            "element_units": rec['element_units'], "old_measure": rec['old_measure'],
            "plain_old_measure": recs['plain']['old_measure'],
            "ms": float(np.mean(ms['this'])), "plain_ms": float(np.mean(ms['plain'])),
            "bound_ms": bound_ms, "bound_by": "issue", "bound_clock_mhz": top_mhz,
            "library_ms": None}


def modes_cell_data(dev):
    """Phase 11d alone: 32,000 Si sites with seeded thermal displacements and
    velocities made on the card, as an atom slice of a wider array, and the
    commensurate [100] path of 128 k: (pos, vel, kv)."""
    from psa_tpu_torch.ops.instantaneous import nearest_commensurate
    n_t, n_a, n_k = MODES_CELL
    sites, _, a0 = si_sites(n_a)
    length = float(np.float32(sites.max() + a0))
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    pos = torch.empty((n_t, n_a + 8, 3), device=dev)
    vel = torch.randn((n_t, n_a + 8, 3), generator=gen, device=dev)
    sites_dev = torch.from_numpy(sites).to(dev)
    for t0 in range(0, n_t, GEN_FRAMES):
        t1 = min(t0 + GEN_FRAMES, n_t)
        pos[t0:t1, :n_a] = (sites_dev[None] + THERMAL_U * torch.randn(
            (t1 - t0, n_a, 3), generator=gen, device=dev, dtype=torch.float64)).float()
    kv = nearest_commensurate(np.outer(np.arange(n_k) * (2 * np.pi / length), [1.0, 0.0, 0.0]),
                              [length] * 3)
    return pos[:, :n_a], vel[:, :n_a], torch.from_numpy(kv).to(dev)


def phase_engines(dev, dcalc, kv, length, pos_dev, vel_dev, cols, oracle32):
    """Phase 11c: ``calculate_dsf``, ``calculate_sk`` (the DSF_K-point path)
    and ``calculate_dsf_self`` (SELF_K consecutive k about the (400)
    reflection: a strided set does not factor) under each phase engine, on
    the resident positions and velocities, warm, one call per engine and
    surface.  ``dcalc.phase_mode`` is switched between
    runs, so the 24 GB stay resident.  Each engine's columns are held
    against a float64 oracle on the card at the k it evaluates: the float32
    k for 'exact' and 'incremental' (``oracle32``: S, C_L, S(k) on
    ``cols``), the float64 lattice vectors m·B for 'factored'; and its
    planes against the exact engine's.  No chunk may fall back.  Returns the
    factored DSF and the walls."""
    from psa_tpu_torch.ops import instantaneous as inst
    bragg = int(cols[1])
    self_line = kv[bragg - SELF_K // 2:bragg + SELF_K // 2]
    box64 = float(np.float32(length))
    lattice = 2.0 * np.pi * np.round(kv.astype(np.float64) * box64 / (2.0 * np.pi)) / box64
    self_k = np.stack([kv[bragg].astype(np.float64), lattice[bragg]])
    t0 = time.perf_counter()
    o_s, o_cl, o_sk, _, o_ss, _ = (x.cpu().numpy() for x in dsf_oracles(
        pos_dev, vel_dev, torch.from_numpy(lattice[cols]).to(dev),
        torch.from_numpy(self_k).to(dev), 8))
    t_oracle = time.perf_counter() - t0
    keep = np.fft.fftfreq(N_T, 0.01) >= 0
    truth = {'factored': (o_s[keep], o_cl[keep], o_sk, o_ss[keep][:, 1])}
    truth['exact'] = truth['incremental'] = oracle32 + (o_ss[keep][:, 0],)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 1e9
    walls = {m: {'dsf': [], 'sk': [], 'dsf_self': []} for m in PHASE_ENGINES}
    peaks, out, chunks = {}, {}, {}
    for mode in PHASE_ENGINES:       # one turn (two until the script grew: CUT, to keep its time)
        dcalc.phase_mode = mode
        dcalc.factored_chunks.clear()
        for name, run in (('dsf', lambda: dcalc.calculate_dsf(kv)),
                          ('sk', lambda: dcalc.calculate_sk(kv)),
                          ('dsf_self', lambda: dcalc.calculate_dsf_self(self_line))):
            out[mode, name], wall, peak = timed(run)
            walls[mode][name].append(wall)
            peaks[mode, name] = peak - base
        chunks[mode] = list(dcalc.factored_chunks)
    dcalc.phase_mode = 'auto'
    check(chunks['exact'] == chunks['incremental'] == [] and len(chunks['factored']) == 3
          and None not in chunks['factored'],
          f"chunks the factored engine took: {chunks}")
    budget = dcalc.max_device_bytes / 4e9
    check(max(peaks.values()) <= 1.25 * budget,
          f"a phase engine's transients {max(peaks.values()):.2f} GB exceed the tile budget "
          f"{budget:.2f} GB by more than a quarter")

    errs = {}
    for mode in PHASE_ENGINES:
        (_, s_pl, cl_pl, ct_pl), sk, (_, ss) = (out[mode, n] for n in ('dsf', 'sk', 'dsf_self'))
        t_s, t_cl, t_sk, t_ss = truth[mode]
        got = (('S', s_pl[:, cols], t_s), ('C_L', cl_pl[:, cols], t_cl), ('S(k)', sk[cols][None], t_sk[None]),
               ('S_s', ss[:, SELF_K // 2:SELF_K // 2 + 1], t_ss[:, None]))
        errs[mode] = {n: float(np.max(np.abs(g - w) / np.abs(w).max(axis=0))) for n, g, w in got}
        check(max(errs[mode].values()) <= TOL_KERNEL,
              f"{mode} engine vs its f64 oracle {errs[mode]} > {TOL_KERNEL}")
        if mode != 'exact':
            (_, e_s, e_cl, e_ct), e_sk, (_, e_ss) = (out['exact', n] for n in ('dsf', 'sk', 'dsf_self'))
            errs[mode]['vs exact'] = max(
                float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in ((s_pl, e_s), (cl_pl, e_cl), (cl_pl + ct_pl, e_cl + e_ct), (sk, e_sk),
                             (ss, e_ss)))
            check(errs[mode]['vs exact'] <= TOL_ENGINES,
                  f"{mode} engine vs the exact engine {errs[mode]['vs exact']:.3e} > {TOL_ENGINES}")
    for mode in PHASE_ENGINES:
        log('engines', f"phase_mode={mode!r}, warm, one turn each (CUT from two): "
                       + "; ".join(f"{n} {w[0]:.3f} s, transients "
                                   f"{peaks[mode, n]:.2f} GB" for n, w in walls[mode].items())
                       + "; vs f64 oracle columns (of each column's max): "
                       + ", ".join(f"{n} {e:.3e}" for n, e in errs[mode].items())
                       + (f"; chunks factored as (Na, Nb) = {chunks[mode]}" if chunks[mode] else ""))
    log('engines', f"{DSF_K} k for dsf and sk, {SELF_K} consecutive k for dsf_self; tile budget "
                   f"{budget:.2f} GB (a quarter of max_device_bytes), bytes per element "
                   f"{inst.PHASOR_BYTES}; tol {TOL_KERNEL} vs the oracle at the k each engine "
                   f"evaluates, {TOL_ENGINES} vs the exact engine; lattice oracle {t_oracle:.2f} s")
    return out['factored', 'dsf'], walls


def dsf_working_size(dev, proj, host_vel, host_pos):
    """Phase 11: the instantaneous-phase family at the working size: the
    Si sites in a fixed cell with seeded thermal displacements made on the
    card and the working-size velocities (24 GB, resident under
    DSF_BUDGET).  ``calculate_dsf``, ``calculate_sk`` and
    ``calculate_isf`` on a DSF_K-point commensurate [100] path,
    ``calculate_dsf_self`` and ``calculate_isf_self`` on SELF_K of them,
    2 columns of each against float64 oracles on the card; then
    ``calculate_dsf`` at the default device budget, streamed, against the
    resident planes.  Returns the walls."""
    from psa_tpu_torch import SEDCalculator
    from psa_tpu_torch.core.calculator import _DEFAULT_MAX_DEVICE_BYTES
    from psa_tpu_torch.utils import profiling
    traj, kv, side, length, t_gen = dsf_working_data(dev, host_vel, host_pos)
    dcalc = SEDCalculator(traj, nx=side, ny=side, nz=side, max_device_bytes=DSF_BUDGET, device=dev)
    self_kv = kv[::DSF_K // SELF_K]
    n_lags = N_T // 2

    walls, peaks, fused = {}, {}, {}
    proj.counters['launch.parity'] = proj.counters['launch.phasor_modes'] = 0
    runs = (('dsf', lambda: dcalc.calculate_dsf(kv)), ('dsf_warm', lambda: dcalc.calculate_dsf(kv)),
            ('sk', lambda: dcalc.calculate_sk(kv)), ('isf', lambda: dcalc.calculate_isf(kv)),
            ('dsf_self', lambda: dcalc.calculate_dsf_self(self_kv)),
            ('isf_self', lambda: dcalc.calculate_isf_self(self_kv)))
    out = {}
    for name, run in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = profiling.snapshot()
        t0 = time.perf_counter()
        out[name] = run()
        walls[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        fused[name] = phasor_counts(profiling.counted_since(before))
    check(proj.counters['launch.parity'] == 0, "the instantaneous-phase family launched the projection kernel")
    # every mode stack of the resident group in one launch over all its atoms and frames; the
    # self parts contract nothing
    elems = N_T * N_ATOMS * DSF_K
    check(fused == {n: (1, elems, elems) if n in ('dsf', 'dsf_warm', 'sk', 'isf') else (0, 0, 0)
                    for n in fused},
          f"fused mode-stack (launches, fused, exact elements) per surface {fused}")
    freqs, s_pl, cl_pl, ct_pl = out['dsf_warm']
    check(all(np.array_equal(a, b) for a, b in zip(out['dsf'], out['dsf_warm'])),
          "the warm DSF differs from the first")
    check(all(np.isfinite(x).all() for r in out.values() for x in (r if isinstance(r, tuple) else (r,))),
          "non-finite DSF-family values")

    pos_dev, vel_dev = dcalc._raw_device_arrays(np.arange(N_ATOMS), 'PV')
    # oracle columns: the path's last k, thermal-diffuse, and the sites' (400)
    # reflection (at the working size 127 and 99 box periods, the box being
    # 24.75 cells); where |ρ_k| is small, its float32 phasor sum carries
    # ~√N·1e-7 of absolute error, so the diffuse column is taken at large k
    bragg = int(round(4 * length / SI_A0))
    check(bragg < DSF_K - 1, "the [100] path must reach past the (400) reflection")
    cols, self_cols = np.array([DSF_K - 1, bragg]), np.array([1, 3 * SELF_K // 4])
    t0 = time.perf_counter()
    o_s, o_cl, o_sk, o_isf, o_ss, o_fs = (x.cpu().numpy() for x in dsf_oracles(
        pos_dev, vel_dev, torch.from_numpy(kv[cols].astype(np.float64)).to(dev),
        torch.from_numpy(self_kv[self_cols].astype(np.float64)).to(dev), n_lags))
    t_oracle = time.perf_counter() - t0
    keep = np.fft.fftfreq(N_T, 0.01) >= 0
    errs = {}
    for name, got, want in (
            ('S', s_pl[:, cols], o_s[keep]), ('C_L', cl_pl[:, cols], o_cl[keep]),
            ('S(k)', out['sk'][cols][None], o_sk[None]), ('ISF', out['isf'][1][:, cols], o_isf),
            ('S_s', out['dsf_self'][1][:, self_cols], o_ss[keep]),
            ('F_s', out['isf_self'][1][:, self_cols], o_fs)):
        errs[name] = float(np.max(np.abs(got - want) / np.abs(want).max(axis=0)))
        check(errs[name] <= TOL_KERNEL, f"{name} vs f64 oracle {errs[name]:.3e} > {TOL_KERNEL}")
    log('dsf', f"{N_ATOMS} thermal Si atoms x {N_T} frames made on the card, copied to the host in "
               f"{t_gen:.2f} s; max_device_bytes={DSF_BUDGET:.0e} (positions + velocities resident); "
               + "; ".join(f"{n} {walls[n]:.3f} s, peak {peaks[n]:.1f} GB" for n in walls)
               + f"; {DSF_K} k ({SELF_K} for the self parts, n_lags {n_lags})")
    log('dsf', "2 columns vs f64 oracles on the card (of each column's max): "
               + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
               + f" (tol {TOL_KERNEL}); oracles {t_oracle:.2f} s; fused mode-stack (launches, "
               f"fused, exact elements) {fused}")
    t0 = time.perf_counter()
    modes_entry = modes_at_cell_shape(pos_dev[:, :MODES_CELL[1]], vel_dev[:, :MODES_CELL[1]],
                                      torch.from_numpy(kv).to(dev))
    log('modes', f"phase 11d took {time.perf_counter() - t0:.2f} s")
    factored_dsf, engine_walls = phase_engines(
        dev, dcalc, kv, length, pos_dev, vel_dev, cols,
        (o_s[keep], o_cl[keep], o_sk))
    check(proj.counters['launch.parity'] == 0, "a phase engine launched the projection kernel")
    del pos_dev, vel_dev
    dcalc.clear_device_cache()
    torch.cuda.empty_cache()

    scalc = SEDCalculator(traj, nx=side, ny=side, nz=side, max_device_bytes=_DEFAULT_MAX_DEVICE_BYTES,
                          device=dev)
    check(2 * host_pos.nbytes > scalc.max_device_bytes,
          "positions + velocities must exceed the default max_device_bytes")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = profiling.snapshot()
    t0 = time.perf_counter()
    streamed = scalc.calculate_dsf(kv)
    walls['dsf_streamed'] = time.perf_counter() - t0
    fused['dsf_streamed'] = phasor_counts(profiling.counted_since(before))
    n_blocks = -(-N_ATOMS // scalc.stream_block_atoms(N_ATOMS))
    check(fused['dsf_streamed'] == (n_blocks, N_T * N_ATOMS * DSF_K, N_T * N_ATOMS * DSF_K),
          f"streamed DSF: {n_blocks} blocks, fused mode-stack counts {fused['dsf_streamed']}")
    stream_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    s_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(streamed[1:3], (s_pl, cl_pl)))
    tot_err = float(np.abs((streamed[2] + streamed[3]) - (cl_pl + ct_pl)).max()
                    / np.abs(cl_pl + ct_pl).max())
    check(scalc.streamed_bytes == (2 * host_pos.nbytes) * -(-DSF_K // 512),
          f"the streamed DSF moved {scalc.streamed_bytes} bytes")
    check(max(s_err, tot_err) <= TOL_KERNEL and np.array_equal(streamed[0], freqs),
          f"streamed DSF vs resident {s_err:.3e}, C_L + C_T {tot_err:.3e}")
    log('dsf', f"calculate_dsf at the default max_device_bytes={scalc.max_device_bytes:.0e}: the "
               f"group streams in blocks of {scalc.stream_block_atoms(N_ATOMS)} atoms, "
               f"{scalc.streamed_bytes / 1e9:.1f} GB host->device, {walls['dsf_streamed']:.3f} s wall, "
               f"peak device memory above the call's start {stream_peak:.2f} GB; S and C_L vs "
               f"resident {s_err:.3e}, C_L + C_T {tot_err:.3e} of max (tol {TOL_KERNEL}); fused "
               f"mode-stack launches {fused['dsf_streamed'][0]}")

    fcalc = SEDCalculator(traj, nx=side, ny=side, nz=side, phase_mode='factored', device=dev)
    streamed, wall, _ = timed(lambda: fcalc.calculate_dsf(kv))
    f_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(streamed[1:3], factored_dsf[1:3]))
    check(fcalc.factored_chunks and None not in fcalc.factored_chunks and f_err <= TOL_KERNEL
          and fcalc.streamed_bytes == 2 * host_pos.nbytes and proj.counters['launch.parity'] == 0,
          f"streamed factored DSF vs resident {f_err:.3e}, chunks {fcalc.factored_chunks}")
    walls['dsf_factored_streamed'] = wall
    log('engines', f"calculate_dsf, phase_mode='factored', at the default max_device_bytes: "
                   f"{wall:.3f} s wall, {fcalc.streamed_bytes / 1e9:.1f} GB host->device, chunks "
                   f"{fcalc.factored_chunks}; S and C_L vs the resident factored planes "
                   f"{f_err:.3e} of max (tol {TOL_KERNEL})")
    return dict(walls, engines=engine_walls, launches=proj.counters['launch.parity'],
                phasor_launches={n: c[0] for n, c in fused.items()}, modes=modes_entry), traj, side


def dsf_small(dev):
    """Phase 11b: the physics of tests/test_dsf.py on the card: Bragg S(k)
    on a static lattice, the chain's current-spectrum peaks on
    ν = W|sin(ka/2)|, Σ_ω S(k,ω) = S(k), Σ_ω S_s = 1 and F_s(k,0) = 1."""
    from psa_tpu_torch import SEDCalculator, Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    from psa_tpu_torch.models import make_chain_trajectory
    from psa_tpu_torch.ops import instantaneous as inst
    from psa_tpu_torch.ops.spectral import unit_k_vectors
    a0, n_cells, n_t = 2.0, 8, 16
    pos = np.zeros((n_t, n_cells, 3), np.float32)
    pos[:, :, 0] = np.arange(n_cells) * a0
    box = np.diag([n_cells * a0] * 3).astype(np.float32)
    static = Trajectory(pos, np.zeros_like(pos), np.ones(n_cells, np.int32),
                        np.arange(n_t, dtype=np.float32), box, *make_box_arrays(box), dt_ps=0.02)
    scalc = SEDCalculator(static, nx=n_cells, ny=1, nz=1, device=dev)
    kv = np.array([[np.pi, 0, 0], [2 * np.pi * 3 / (n_cells * a0), 0, 0]], np.float32)
    sk = scalc.calculate_sk(kv)
    _, s, _, _ = scalc.calculate_dsf(kv)
    check(abs(sk[0] - n_cells) <= 1e-4 * n_cells and sk[1] <= 1e-6 * n_cells
          and abs(s[0, 0] - n_cells) <= 1e-4 * n_cells and s[1:, 0].max() <= 1e-6 * n_cells,
          f"Bragg: S(G) {sk[0]}, S(k) off G {sk[1]}, S(G, 0) {s[0, 0]}")
    log('dsf', f"static chain: S(G) = {sk[0]:.6f} (N = {n_cells}), S at m=3 of 8 {sk[1]:.2e}, "
               f"all of S(G, ω) at ω = 0")

    chain = make_chain_trajectory(n_cells=16, n_frames=128, dt_ps=0.02, a=2.5, omega_max_thz=8.0,
                                  seed=5)
    ccalc = SEDCalculator(chain, nx=16, ny=1, nz=1, device=dev)
    kc = np.zeros((3, 3), np.float32)
    kc[:, 0] = 2 * np.pi * np.array([2, 5, 8]) / (16 * 2.5)
    kc = inst.nearest_commensurate(kc, chain.box_lengths)
    freqs, _, c_l, c_t = ccalc.calculate_dsf(kc)
    miss = max(abs(freqs[np.argmax(c_l[:, j])] - 8.0 * abs(np.sin(kc[j, 0] * 2.5 / 2)))
               for j in range(3))
    check(miss <= 0.5 and c_t.max() <= 1e-8 * c_l.max(), f"chain C_L peaks off by {miss} THz")
    log('dsf', f"chain C_L peaks on nu = 8|sin(ka/2)| within {miss:.4f} THz (<= 0.5); C_T "
               f"{c_t.max() / c_l.max():.1e} of C_L")

    rng = np.random.default_rng(SEED)
    p = torch.from_numpy(rng.uniform(0, 9, (16, 7, 3)).astype(np.float32)).to(dev)
    kr = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
    re, im = inst.instant_modes(p, torch.zeros_like(p), torch.from_numpy(kr).to(dev), t_chunk=5)
    s_all = inst.dsf_reduce(re, im, torch.from_numpy(unit_k_vectors(kr)).to(dev),
                            torch.arange(16, device=dev))[0].sum(dim=0)
    parseval = float((s_all / inst.sk_reduce(re, im) - 1).abs().max())
    s_s = inst.dsf_self_block(p, torch.from_numpy(kr).to(dev), torch.arange(16, device=dev)) / 7
    self_sum = float((s_s.sum(dim=0) - 1).abs().max())
    _, f_s = ccalc.calculate_isf_self(kc, n_lags=8)
    check(parseval <= 1e-5 and self_sum <= 1e-6 and np.allclose(f_s[0], 1.0, rtol=1e-6),
          f"Parseval {parseval:.2e}, Σ S_s - 1 {self_sum:.2e}, F_s(k,0) {f_s[0]}")
    log('dsf', f"Σ_ω S(k,ω) = S(k) to {parseval:.1e}; Σ_ω S_s = 1 to {self_sum:.1e}; "
               f"F_s(k,0) = {f_s[0].min():.7f}..{f_s[0].max():.7f}")


def timed(fn):
    """(result, wall seconds, peak device GB) of ``fn()``, the device drained."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def timecorr_oracles(pos, vel, n_lags):
    """float64 direct sums on the card over all time origins: (MSD, VACF),
    each (n_lags,), the mean over the atoms of (n_t, A, 3) inputs."""
    pos, vel = pos.double(), vel.double()
    n_t = pos.shape[0]
    msd = torch.zeros(n_lags, dtype=torch.float64, device=pos.device)
    vacf = torch.zeros_like(msd)
    for tau in range(n_lags):
        d = pos[tau:] - pos[:n_t - tau]
        msd[tau] = (d * d).sum(dim=-1).mean()
        vacf[tau] = (vel[:n_t - tau] * vel[tau:]).sum(dim=-1).mean()
    return msd.cpu().numpy(), vacf.cpu().numpy()


def timecorr_working_size(dev, proj, traj, side):
    """Phase 12: ``calculate_vacf`` and ``calculate_msd`` on the phase-11
    trajectory (10^5 thermal Si atoms x 10^4 frames), default n_lags
    (n_t // 2): cold (12 GB uploaded) and warm under DSF_BUDGET, 8 atoms
    against float64 direct sums on the card, VACF(0) against the seeded
    N(0, 1) velocities' 3, another atom chunk, and both streamed at the
    default budget."""
    from psa_tpu_torch import SEDCalculator
    from psa_tpu_torch.core.calculator import _DEFAULT_MAX_DEVICE_BYTES
    from psa_tpu_torch.ops import timecorr
    calc = SEDCalculator(traj, nx=side, ny=side, nz=side, max_device_bytes=DSF_BUDGET, device=dev)
    n_lags = N_T // 2
    chunk = (DSF_BUDGET // 4) // timecorr.block_bytes_per_atom(N_T)
    walls, peaks, out = {}, {}, {}
    proj.counters['launch.parity'] = 0
    for name, run in (('vacf', calc.calculate_vacf), ('vacf_warm', calc.calculate_vacf),
                      ('msd', calc.calculate_msd), ('msd_warm', calc.calculate_msd)):
        out[name], walls[name], peaks[name] = timed(run)
    for kind in ('vacf', 'msd'):
        check(np.array_equal(out[kind][1], out[kind + '_warm'][1]), f"warm {kind} differs")
        check(out[kind][1].shape == (1, n_lags) and np.isfinite(out[kind][1]).all(),
              f"{kind} shape or values")
    check(len(calc._device_cache) == 2, "raw positions and velocities must both stay resident")
    v0, v0_err = float(out['vacf'][1][0, 0]), 5 * 3 * np.sqrt(2.0 / (3.0 * N_T * N_ATOMS)) + 3e-6
    check(abs(v0 - 3.0) <= v0_err, f"VACF(0) {v0} is not <|v|^2> = 3 within {v0_err:.1e}")

    other = {kind: fn(atom_chunk_size=1000)[1] for kind, fn in
             (('msd', calc.calculate_msd), ('vacf', calc.calculate_vacf))}
    chunk_err = {k: float(np.abs(other[k] - out[k][1]).max() / np.abs(out[k][1]).max())
                 for k in other}
    check(max(chunk_err.values()) <= TOL_INVARIANT, f"atom chunks of 1000 vs {chunk}: {chunk_err}")

    # (the 8-atom groups take the resident arrays' slots in the 2-slot cache)
    atoms = np.arange(8) * (N_ATOMS // 8) + 17
    pos8, vel8 = (torch.from_numpy(np.ascontiguousarray(x[:, atoms])).to(dev)
                  for x in (traj.positions, traj.velocities))
    t0 = time.perf_counter()
    want = dict(zip(('msd', 'vacf'), timecorr_oracles(pos8, vel8, n_lags)))
    t_oracle = time.perf_counter() - t0
    errs = {}
    for kind, fn in (('msd', calc.calculate_msd), ('vacf', calc.calculate_vacf)):
        got = fn(basis_atom_indices=atoms)[1][0].astype(np.float64)
        scale = np.abs(want[kind]).max()
        excess = np.abs(got - want[kind]) - TOL_TIMECORR[0] * np.abs(want[kind])
        errs[kind] = float(excess.max() / scale)
        check(errs[kind] <= TOL_TIMECORR[1],
              f"{kind} of 8 atoms vs the f64 direct sum: {errs[kind]:.3e} of max beyond rtol")
    check(proj.counters['launch.parity'] == 0, "the time correlations launched the projection kernel")
    calc.clear_device_cache()
    torch.cuda.empty_cache()
    log('timecorr', f"{N_ATOMS} atoms x {N_T} frames, n_lags {n_lags}, atom chunks of {chunk} "
                    f"({timecorr.block_bytes_per_atom(N_T)} bytes per atom): "
                    + "; ".join(f"{n} {walls[n]:.3f} s ({N_ATOMS / walls[n]:.0f} atoms/s), peak "
                                f"{peaks[n]:.1f} GB" for n in walls))
    log('timecorr', f"8 atoms vs f64 direct sums on the card, beyond rtol {TOL_TIMECORR[0]} of max: "
                    f"MSD {errs['msd']:.3e}, VACF {errs['vacf']:.3e} (tol {TOL_TIMECORR[1]}); "
                    f"oracles {t_oracle:.2f} s; VACF(0) = {v0:.6f} (3 within {v0_err:.1e}); chunks "
                    f"of 1000 vs {chunk}: MSD {chunk_err['msd']:.3e}, VACF {chunk_err['vacf']:.3e} "
                    f"(tol {TOL_INVARIANT})")

    scalc = SEDCalculator(traj, nx=side, ny=side, nz=side,
                          max_device_bytes=_DEFAULT_MAX_DEVICE_BYTES, device=dev)
    check(scalc._oversize(np.arange(N_ATOMS)), "the group must exceed the default budget")
    s_err = {}
    for kind, fn in (('vacf', scalc.calculate_vacf), ('msd', scalc.calculate_msd)):
        res, walls[kind + '_streamed'], peaks[kind + '_streamed'] = timed(fn)
        s_err[kind] = float(np.abs(res[1] - out[kind][1]).max() / np.abs(out[kind][1]).max())
    check(scalc.streamed_bytes == 2 * traj.positions.nbytes and not scalc._device_cache,
          f"the streamed time correlations moved {scalc.streamed_bytes} bytes")
    check(max(s_err.values()) <= TOL_INVARIANT, f"streamed vs resident {s_err}")
    log('timecorr', f"at the default max_device_bytes={scalc.max_device_bytes:.0e} the group streams "
                    f"in blocks of {scalc.stream_block_atoms(N_ATOMS)} atoms: VACF "
                    f"{walls['vacf_streamed']:.3f} s, MSD {walls['msd_streamed']:.3f} s, "
                    f"{scalc.streamed_bytes / 1e9:.1f} GB host->device, peak "
                    f"{peaks['msd_streamed']:.2f} GB; vs resident VACF {s_err['vacf']:.3e}, MSD "
                    f"{s_err['msd']:.3e} of max (tol {TOL_INVARIANT})")


def small_trajectory(pos, vel, box_edge, dt_ps, types=None):
    from psa_tpu_torch import Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    box = np.diag([box_edge] * 3).astype(np.float32)
    types = np.ones(pos.shape[1], np.int32) if types is None else types
    return Trajectory(pos.astype(np.float32), vel.astype(np.float32), types,
                      np.arange(pos.shape[0], dtype=np.float32), box, *make_box_arrays(box),
                      dt_ps=dt_ps)


def timecorr_small(dev):
    """Phase 12b: the physics of tests/test_timecorr.py on the card:
    Brownian walkers' MSD -> 6 D tau, harmonic oscillators' VACF = <|v|^2> cos."""
    from psa_tpu_torch import SEDCalculator
    rng = np.random.default_rng(7)
    n_t, n_a, d_true, dt_ps = 2048, 128, 0.3, 0.1
    pos = np.cumsum(rng.normal(0, np.sqrt(2 * d_true * dt_ps), (n_t, n_a, 3)), axis=0)
    calc = SEDCalculator(small_trajectory(pos, np.zeros_like(pos), 20.0, dt_ps), 1, 1, 1, device=dev)
    lags, msd = calc.calculate_msd(n_lags=100)
    d_est = np.polyfit(lags[1:], msd[0, 1:].astype(np.float64), 1)[0] / 6.0
    check(abs(msd[0, 0]) < 1e-4 * msd[0, -1] and abs(d_est / d_true - 1) <= 0.05,
          f"Einstein slope D {d_est} vs {d_true}")
    rng = np.random.default_rng(9)
    n_t, n_a, dt_ps, nu, amp = 512, 200, 0.02, 4.0, 1.3
    t = np.arange(n_t) * dt_ps
    vel = amp * np.cos(2 * np.pi * nu * t[:, None, None] + rng.uniform(0, 2 * np.pi, (n_a, 3))[None])
    calc = SEDCalculator(small_trajectory(np.zeros_like(vel), vel, 20.0, dt_ps), 1, 1, 1, device=dev)
    lags, vacf = calc.calculate_vacf(n_lags=64)
    v = vacf[0].astype(np.float64)
    miss = float(np.abs(v - v[0] * np.cos(2 * np.pi * nu * lags.astype(np.float64))).max() / v[0])
    check(abs(v[0] / (3 * amp ** 2 / 2) - 1) <= 0.02 and miss <= 0.05,
          f"harmonic VACF(0) {v[0]}, off the cosine by {miss}")
    log('timecorr', f"Brownian walkers: MSD slope / 6 = {d_est:.4f} (D = {d_true}, within 5%); "
                    f"harmonic bath: VACF(0) = {v[0]:.4f} (3A^2/2 = {3 * amp ** 2 / 2:.4f}), "
                    f"off cos(2 pi nu tau) by {miss:.3f} of VACF(0) (<= 0.05)")


def rdf_oracle(pos, length, n_pairs_norm):
    """float64 all-pairs minimum-image histogram on the card of (t, A, 3)
    float32 positions in a cubic cell: (g (RDF_BINS,), per-bin count of
    pairs within EDGE_EPS of one of the bin's edges, each worth that much
    of g)."""
    p = pos.double()
    edges = torch.linspace(0.0, RDF_R_MAX, RDF_BINS + 1, dtype=torch.float64, device=pos.device)
    counts = torch.zeros(RDF_BINS + 2, dtype=torch.int64, device=pos.device)
    near = torch.zeros(RDF_BINS + 1, dtype=torch.int64, device=pos.device)
    eye = torch.eye(p.shape[1], dtype=torch.bool, device=pos.device)
    for frame in p:
        d = frame[:, None, :] - frame[None, :, :]
        d -= length * torch.round(d / length)
        r = d.norm(dim=-1).masked_fill_(eye, float('inf'))
        counts += torch.bincount(torch.bucketize(r, edges, right=True).reshape(-1),
                                 minlength=RDF_BINS + 2)
        edge = torch.round(r / (RDF_R_MAX / RDF_BINS)).clamp_(max=RDF_BINS).long()
        close = (r - edges[edge]).abs() < EDGE_EPS
        near += torch.bincount(edge[close], minlength=RDF_BINS + 1)
    e = edges.cpu().numpy()
    ideal = n_pairs_norm * 4.0 / 3.0 * np.pi * (e[1:] ** 3 - e[:-1] ** 3) / length ** 3
    near = near.cpu().numpy()
    return counts[1:RDF_BINS + 1].cpu().numpy() / ideal, (near[:-1] + near[1:]) / ideal


def rdf_working_size(dev, proj, traj, side):
    """Phase 13: g(r) on the phase-11 trajectory, r < RDF_R_MAX in RDF_BINS
    bins: (a) the brute sweep over 10^5 atoms x RDF_BRUTE_FRAMES frames; (b)
    the linked cells over 10^5 atoms x RDF_CELLS_FRAMES frames, the host's
    occupancy and bucketing time apart; (c) ``method='auto'``.  Cells against
    brute bin for bin on RDF_SUBSAMPLE atoms wrapped into the cell, twice
    for the bits; on the raw ones the pairs that change bin counted, and bin
    for bin again once the atoms outside the cell are left out; both
    against a float64 all-pairs count on RDF_ORACLE_ATOMS atoms."""
    from psa_tpu_torch import SEDCalculator
    calc = SEDCalculator(traj, nx=side, ny=side, nz=side, device=dev)
    kw = dict(r_max=RDF_R_MAX, n_bins=RDF_BINS)
    proj.counters['launch.parity'] = 0
    (r, g_brute), t_brute, peak_brute = timed(lambda: calc.calculate_rdf(
        method='brute', max_frames=RDF_BRUTE_FRAMES, **kw))
    pairs = float(N_ATOMS) ** 2 * RDF_BRUTE_FRAMES
    check(calc._last_rdf_method == 'brute' and np.isfinite(g_brute).all(), "brute g(r)")
    (_, g_cells), t_cells, peak_cells = timed(lambda: calc.calculate_rdf(
        method='cells', max_frames=RDF_CELLS_FRAMES, **kw))
    check(calc._last_rdf_method == 'cells' and np.isfinite(g_cells).all(), "cells g(r)")
    # the auto run, profiled on the host: its psa.rdf.host spans are the host's share
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (_, g_auto), t_auto, _ = timed(lambda: calc.calculate_rdf(max_frames=RDF_CELLS_FRAMES,
                                                                   **kw))
    t_host = sum(e.cpu_time_total for e in prof.key_averages() if e.key == 'psa.rdf.host') / 1e6
    check(calc._last_rdf_method == 'cells' and np.array_equal(g_auto, g_cells),
          f"auto took {calc._last_rdf_method} at the working size")
    # the first Si shell (2.35 Å) holds 4 neighbours in the bulk; the sites are a truncated
    # block in a box that is no whole number of cells, so this is logged, not asserted
    shell = r < 3.0
    rho = N_ATOMS / float(np.prod(traj.box_lengths))
    coord = [float(4 * np.pi * rho * np.sum((g * r.astype(np.float64) ** 2)[shell]) * (r[1] - r[0]))
             for g in (g_brute, g_cells)]
    log('rdf', f"brute: {N_ATOMS} atoms x {RDF_BRUTE_FRAMES} frames = {pairs:.1e} pairs in "
               f"{t_brute:.3f} s, {pairs / t_brute:.3e} pairs/s, peak {peak_brute:.2f} GB; cells: "
               f"{N_ATOMS} atoms x {RDF_CELLS_FRAMES} frames in {t_cells:.3f} s, "
               f"{float(N_ATOMS) ** 2 * RDF_CELLS_FRAMES / t_cells:.3e} brute-equivalent pairs/s, "
               f"peak {peak_cells:.2f} GB; auto took cells ({t_auto:.3f} s profiled, of it "
               f"{t_host:.3f} s host occupancy and bucketing in psa.rdf.host); first-shell "
               f"coordination {coord[0]:.3f} (brute), {coord[1]:.3f} (cells)")

    # Cells against brute on a common subsample.  The cells path wraps the
    # positions into the cell (float64, rounded to float32); an atom that
    # the thermal motion carried across a face then enters the same float32
    # fold from another image, and a pair within a rounding of a bin edge
    # may change bin.  So bin for bin holds on positions inside the cell:
    # asserted on the wrapped copy; on the raw ones the moved pairs are counted.
    sub = np.arange(RDF_SUBSAMPLE)
    frames = np.arange(0, N_T, -(-N_T // RDF_BRUTE_FRAMES))
    length = float(traj.box_lengths[0])
    raw = traj.positions[frames][:, sub].astype(np.float64)
    wrapped = (raw / length - np.floor(raw / length)) * length
    crossed = int((np.abs(wrapped - raw) > 1.0).any(axis=(0, 2)).sum())
    wcalc = SEDCalculator(small_trajectory(wrapped, np.zeros_like(wrapped), length, 0.01),
                          side, side, side, device=dev)
    runs = [wcalc.calculate_rdf(method=m, **kw)[1] for m in ('brute', 'cells', 'brute', 'cells')]
    check(np.array_equal(runs[0], runs[1]),
          "cells differ from brute on the subsample wrapped into the cell")
    check(np.array_equal(runs[0], runs[2]) and np.array_equal(runs[1], runs[3]),
          "a rerun of g(r) changed bits")
    shell_vol = 4.0 / 3.0 * np.pi * np.diff(np.linspace(0.0, RDF_R_MAX, RDF_BINS + 1) ** 3)
    ideal = len(frames) * RDF_SUBSAMPLE * (RDF_SUBSAMPLE - 1) * shell_vol / length ** 3
    counts = [np.rint(calc.calculate_rdf(method=m, max_frames=RDF_BRUTE_FRAMES,
                                         basis_atom_indices=sub, **kw)[1] * ideal)
              for m in ('brute', 'cells')]
    moved = float(np.abs(counts[0] - counts[1]).sum() / 2)
    check(moved <= 1e-4 * counts[0].sum() and abs(counts[0].sum() - counts[1].sum()) <= 4,
          f"cells vs brute on the raw subsample: {moved} of {counts[0].sum()} pairs changed bin")
    # the moved pairs are the crossed atoms' alone: the raw subsample less
    # every atom that leaves [0, L) in a sampled frame is bin for bin again
    inside = sub[((raw >= 0.0) & (raw < length)).all(axis=(0, 2))]
    kept = [calc.calculate_rdf(method=m, max_frames=RDF_BRUTE_FRAMES, basis_atom_indices=inside,
                               **kw)[1] for m in ('brute', 'cells')]
    check(len(inside) >= 0.9 * RDF_SUBSAMPLE and kept[0].any() and np.array_equal(*kept),
          f"cells differ from brute on the {len(inside)} raw atoms that stay inside the cell")
    few = np.arange(RDF_ORACLE_ATOMS)
    pos = torch.from_numpy(np.ascontiguousarray(traj.positions[frames][:, few])).to(dev)
    want, slack = rdf_oracle(pos, float(traj.box_lengths[0]),
                             len(frames) * RDF_ORACLE_ATOMS * (RDF_ORACLE_ATOMS - 1))
    worst = {}
    for method in ('brute', 'cells'):
        got = calc.calculate_rdf(method=method, max_frames=RDF_BRUTE_FRAMES,
                                 basis_atom_indices=few, **kw)[1]
        excess = np.abs(got - want) - 1e-4 * np.abs(want) - slack
        worst[method] = float(excess.max())
        check(worst[method] <= 1e-5, f"{method} g(r) vs the f64 all-pairs count: {worst[method]:.3e}")
    check(proj.counters['launch.parity'] == 0, "g(r) launched the projection kernel")
    log('rdf', f"cells == brute bin for bin on {RDF_SUBSAMPLE} atoms x {RDF_BRUTE_FRAMES} frames "
               f"wrapped into the cell, reruns bitwise equal; on the raw positions ({crossed} "
               f"atoms across a face) {moved:.0f} of {counts[0].sum():.0f} pairs changed bin "
               f"(<= 1e-4), none once those atoms are left out ({len(inside)} raw atoms, bin for "
               f"bin); {RDF_ORACLE_ATOMS} atoms vs a float64 all-pairs minimum-image "
               f"count on the card: beyond rtol 1e-4 (and {int(round((slack > 0).sum()))} bins' "
               f"pairs within {EDGE_EPS} Å of an edge) brute {worst['brute']:.2e}, cells "
               f"{worst['cells']:.2e} in g (tol 1e-5)")


def rdf_small(dev):
    """Phase 13b: ``auto`` takes brute on a 512-atom Si box; the simple-cubic
    shells hold 6 and 18 neighbours; an ideal gas is flat at 1 (the fixtures
    of tests/test_rdf.py)."""
    from psa_tpu_torch import SEDCalculator
    sites, side, a0 = si_sites(512)
    rng = np.random.default_rng(SEED)
    pos = sites[None] + THERMAL_U * rng.standard_normal((4, 512, 3))
    calc = SEDCalculator(small_trajectory(pos, np.zeros_like(pos), side * a0, 0.01), side, side, side,
                         device=dev)
    _, g = calc.calculate_rdf(n_bins=100)
    check(calc._last_rdf_method == 'brute' and np.isfinite(g).all(), "auto on 512 atoms")
    a0, n_c = 2.0, 5
    grid = np.stack(np.meshgrid(*([np.arange(n_c) * a0] * 3), indexing='ij'), -1).reshape(-1, 3)
    calc = SEDCalculator(small_trajectory(grid[None], np.zeros_like(grid[None]), n_c * a0, 0.05),
                         n_c, n_c, n_c, device=dev)
    shells = {}
    for method in ('brute', 'cells'):
        r, g = calc.calculate_rdf(r_max=4.5, n_bins=90, method=method)
        coord = 4 * np.pi * (len(grid) / (n_c * a0) ** 3) * np.cumsum(
            g * r.astype(np.float64) ** 2) * (r[1] - r[0])
        shells[method] = (float(coord[np.searchsorted(r, (1.0 + np.sqrt(2)) / 2 * a0)]),
                          float(coord[np.searchsorted(r, (np.sqrt(2) + np.sqrt(3)) / 2 * a0)]))
        check(abs(shells[method][0] / 6 - 1) <= 0.02 and abs(shells[method][1] / 18 - 1) <= 0.02
              and g[r < 0.9 * a0].max() == 0.0, f"simple-cubic shells ({method}) {shells[method]}")
    gas = np.random.default_rng(3).uniform(0, 15.0, (8, 500, 3))
    calc = SEDCalculator(small_trajectory(gas, np.zeros_like(gas), 15.0, 0.05), 1, 1, 1, device=dev)
    _, g = calc.calculate_rdf(n_bins=30)
    check(np.abs(g[5:] - 1.0).max() <= 0.12 and abs(g[5:].mean() - 1.0) < 0.02,
          f"ideal gas g(r) {g[5:].min()}..{g[5:].max()}")
    log('rdf', f"auto takes brute on 512 atoms; simple cubic: coordination "
               f"{shells['brute'][0]:.3f} and {shells['brute'][1]:.3f} (6 and 18 within 2%), cells "
               f"the same; ideal gas g = {g[5:].mean():.4f} on average, within "
               f"{np.abs(g[5:] - 1).max():.3f} of 1")


# ---------------------------------------------------------------------------
# Phase 16: the mesh sweeps (psa_tpu_torch.parallel) on the one card
# ---------------------------------------------------------------------------

def nccl_group():
    """A one-rank NCCL process group on this process's card, so that the
    virtual mesh's collectives go through NCCL."""
    import torch.distributed as dist
    from psa_tpu_torch.parallel.smoke import free_port
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', init_method=f'tcp://localhost:{free_port()}',
                            world_size=1, rank=0)
    return dist.group.WORLD


def mesh_counted(proj, launches, walls, name, fn):
    """``fn()`` with its projection launches and wall kept under ``name``."""
    proj.counters['launch.parity'] = 0
    out, walls[name], _ = timed(fn)
    launches[name] = proj.counters['launch.parity']
    return out


def kernel_at_mesh_shapes(proj, data, mean64, kv, shapes):
    """Kernel vs plain on host ``data`` at the (frames, atoms, k) shapes a
    mesh's positions give the kernel: [((n_t, A, K), rel err), ...]."""
    from psa_tpu_torch.ops.spectral import split_f64
    dev = torch.device(MESH_DEVICE)
    out = []
    for n_t, n_a, n_k in shapes:
        hi, lo = (torch.from_numpy(np.ascontiguousarray(x[:n_a])).to(dev)
                  for x in split_f64(mean64))
        block = torch.from_numpy(np.ascontiguousarray(data[:n_t, :n_a], np.float32)).to(dev)
        k_dev = torch.from_numpy(np.ascontiguousarray(kv[:n_k], np.float32)).to(dev)
        err_abs, scale = pair_err(proj.sed_projection(block, hi, lo, k_dev),
                                  proj.sed_projection_plain(block, hi, lo, k_dev))
        out.append(((n_t, n_a, n_k), err_abs / scale))
        del block
    torch.cuda.empty_cache()
    worst = max(e for _, e in out)
    check(worst <= TOL_KERNEL, f"kernel vs plain at the mesh's shapes {out} > {TOL_KERNEL}")
    return out


def mesh_grid(dev, proj, calc, host_vel, k_vecs, grid_shape, oracle, cols):
    """Phase 16a/b, on the working size (10^5 Si atoms x 10^4 steps, the
    50x50 grid, parity): ``calculate_kgrid_peaks_sharded`` and
    ``calculate_kgrid_browse_sharded`` on a virtual (2, 2, 2) mesh of
    ``cuda:0`` inside a one-rank NCCL group, from a BlockSource over the host
    velocities, resident (one superchunk: 12 GB of windows on the card) and
    in superchunks of MESH_SUPERCHUNK frames, against the one-device sweeps
    of the resident calculator; ``sharded_sed_spectrum`` of the 4 oracle
    k-columns against the f64 oracle; the kernel against its plain version
    at the positions' shapes; then the gridded engine's ky stripes over 4
    positions against the one-device gridded peaks.  Returns (the group, the
    launches per path, the kernel checks)."""
    from psa_tpu_torch.parallel import ArrayBlockSource, make_mesh, sharded_sed_spectrum
    group = nccl_group()
    mesh = make_mesh(shape=MESH_SHAPE, devices=[MESH_DEVICE] * 8, group=group)
    src = ArrayBlockSource(host_vel)
    n_k = len(k_vecs)
    positions = int(np.prod(MESH_SHAPE))
    launches, walls = {}, {}
    single_peaks, t_sp, _ = timed(lambda: calc.calculate_kgrid_peaks(
        k_vecs, n_peaks=N_PEAKS, k_chunk_size=K_CHUNK_GRID))
    (freqs, single_planes, _), t_sb, _ = timed(lambda: calc.calculate_kgrid_browse(
        k_vecs, k_chunk_size=K_CHUNK_GRID))
    for sc, tag in ((None, 'resident'), (MESH_SUPERCHUNK, 'superchunks')):
        n_sc = N_T // (sc or N_T)
        peaks = mesh_counted(proj, launches, walls, f'mesh_kgrid_peaks_{tag}',
                             lambda: calc.calculate_kgrid_peaks_sharded(
                                 mesh, k_vecs, n_peaks=N_PEAKS, data=src, t_superchunk=sc))
        f_m, planes, _ = mesh_counted(proj, launches, walls, f'mesh_kgrid_browse_{tag}',
                                      lambda: calc.calculate_kgrid_browse_sharded(
                                          mesh, k_vecs, data=src, t_superchunk=sc))
        for name in (f'mesh_kgrid_peaks_{tag}', f'mesh_kgrid_browse_{tag}'):
            check(launches[name] == n_sc * positions,
                  f"{name} launched the kernel {launches[name]} times, want {n_sc * positions}")
        n_differ, h_err, _ = peaks_agree(calc, k_vecs, peaks, single_peaks, f"mesh peaks {tag}")
        plane_err = float(np.abs(planes - single_planes).max() / single_planes.max())
        check(np.array_equal(f_m, freqs) and plane_err <= TOL_MESH_PLANES,
              f"mesh browse {tag} vs one device {plane_err:.3e} > {TOL_MESH_PLANES}")
        log('mesh', f"(a) {tag}: kgrid_peaks_sharded {walls[f'mesh_kgrid_peaks_{tag}']:.3f} s, "
                    f"kgrid_browse_sharded {walls[f'mesh_kgrid_browse_{tag}']:.3f} s wall "
                    f"(one device: peaks {t_sp:.3f} s, browse {t_sb:.3f} s, velocities resident); "
                    f"{n_sc} superchunk(s) x {positions} positions = {launches[f'mesh_kgrid_peaks_{tag}']} "
                    f"launches each; peak frequencies equal the one device's (atol {TOL_PEAK_FREQ}) "
                    f"but on {n_differ} near-tied k-columns, heights within {h_err:.3e} of the "
                    f"column's highest (tol {TOL_TWO_ENGINES}); planes {plane_err:.3e} of max "
                    f"(tol {TOL_MESH_PLANES})")
    re_im = mesh_counted(proj, launches, walls, 'mesh_sed_spectrum',
                         lambda: sharded_sed_spectrum(mesh, src, calc.mean_positions64,
                                                      k_vecs[cols]))
    got = torch.from_numpy(re_im[0] + 1j * re_im[1]).to(oracle.device)
    spec_err = rel(got, oracle)
    check(spec_err <= TOL_KERNEL, f"sharded_sed_spectrum vs f64 oracle {spec_err:.3e}")
    shapes = kernel_at_mesh_shapes(
        proj, host_vel, calc.mean_positions64, k_vecs,
        [(N_T // MESH_SHAPE[0], N_ATOMS // MESH_SHAPE[1], n_k // MESH_SHAPE[2]),
         (MESH_SUPERCHUNK // MESH_SHAPE[0], N_ATOMS // MESH_SHAPE[1], n_k // MESH_SHAPE[2]),
         (N_T // MESH_SHAPE[0], N_ATOMS // MESH_SHAPE[1], len(cols) // MESH_SHAPE[2])])
    log('mesh', f"(a) sharded_sed_spectrum of the 4 oracle k-columns over the (2, 2, 2) mesh: "
                f"{walls['mesh_sed_spectrum']:.3f} s, launches {launches['mesh_sed_spectrum']}, "
                f"vs f64 oracle {spec_err:.3e} of max (tol {TOL_KERNEL}); kernel vs plain at the "
                f"positions' shapes: " + ", ".join(f"{s}: {e:.3e}" for s, e in shapes))

    stripes = make_mesh(shape=(1, 1, MESH_STRIPES), devices=[MESH_DEVICE] * MESH_STRIPES)
    single_g, t_g, _ = timed(lambda: calc.calculate_kgrid_peaks(
        k_vecs, n_peaks=N_PEAKS, engine='gridded', k_grid_shape=grid_shape))
    got_g = mesh_counted(proj, launches, walls, 'mesh_kgrid_peaks_gridded',
                         lambda: calc.calculate_kgrid_peaks_sharded(
                             stripes, k_vecs, n_peaks=N_PEAKS, engine='gridded',
                             k_grid_shape=grid_shape))
    check(launches['mesh_kgrid_peaks_gridded'] == 0, "the gridded stripes launched the kernel")
    n_differ, h_err, _ = peaks_agree(calc, k_vecs, got_g, single_g, "gridded stripes")
    log('mesh', f"(b) gridded ky stripes over {MESH_STRIPES} positions of cuda:0, 50x50: "
                f"{walls['mesh_kgrid_peaks_gridded']:.3f} s (one device {t_g:.3f} s); peak "
                f"frequencies equal the one-device gridded engine's but on {n_differ} near-tied "
                f"k-columns, heights within {h_err:.3e} of the column's highest; 0 launches")
    return group, launches, shapes


def mesh_cards(proj):
    """Phase 16f, where MESH_CARDS cards are visible: the working size's
    velocities (10^5 atoms x 10^4 steps, the 50x50 grid, parity) resident in
    atom shards on a (1, 4, 1) mesh of cards 0-3 (``preload_mesh_group_data``)
    against the same data read from a host array each call: peaks bit for
    bit; the wall of one resident call against each card's kernel time
    alone (the cards overlapped, not in turn); the counters
    ``mesh.exchange_bytes`` and ``mesh.ingest_bytes`` and the launches of a
    call; one launch of the 'parity' kernel on each card at once, each
    card's bits equal card 0's.  Skips with a message on fewer cards.
    Returns the launches per path."""
    n_cards = torch.cuda.device_count()
    if n_cards < MESH_CARDS:
        log('mesh', f"(f) skipped: {n_cards} CUDA device(s) visible; the resident mesh "
                    f"needs {MESH_CARDS}")
        return {}
    from psa_tpu_torch.ops.spectral import split_f64
    from psa_tpu_torch.parallel import ArrayBlockSource, make_mesh
    from psa_tpu_torch.parallel.sharded import _shards
    from psa_tpu_torch.utils import profiling
    cards = [torch.device('cuda', i) for i in range(MESH_CARDS)]
    vel = torch.randn((N_T, N_ATOMS, 3), generator=torch.Generator(cards[0]).manual_seed(SEED + 16),
                      device=cards[0])
    host_vel = vel.cpu().numpy()
    del vel
    calc, k_vecs, _ = working_calculator(cards[0], host_vel)
    n_k = len(k_vecs)
    mesh = make_mesh(shape=(1, MESH_CARDS, 1), devices=cards)
    hi64, lo64 = split_f64(calc.mean_positions64)
    parts = ({}, {}, {})
    for a, ((a0, a1), card) in enumerate(zip(_shards(N_ATOMS, MESH_CARDS), cards)):
        for store, x in zip(parts, (host_vel[:, a0:a1], hi64[a0:a1], lo64[a0:a1])):
            store[(0, a, 0)] = torch.from_numpy(np.ascontiguousarray(x)).to(card)
    calc.preload_mesh_group_data(mesh, *parts)
    paths = {'resident': lambda: calc.calculate_kgrid_peaks_sharded(mesh, k_vecs, n_peaks=N_PEAKS),
             'host': lambda: calc.calculate_kgrid_peaks_sharded(
                 mesh, k_vecs, n_peaks=N_PEAKS, data=ArrayBlockSource(host_vel))}
    paths['resident']()                   # warm: each card's allocator and cuFFT's plan
    outs, walls, counted = {}, {}, {}
    for name, fn in paths.items():
        before = profiling.snapshot()
        t0 = time.perf_counter()
        outs[name] = fn()                 # returns once card 0 holds every card's partial
        walls[name] = time.perf_counter() - t0
        counted[name] = profiling.counted_since(before)
    check(all(np.array_equal(a, b) for a, b in zip(outs['resident'], outs['host'])),
          "resident mesh peaks differ from the host source's")
    kernel_ms = []
    for a, card in enumerate(cards):
        k_dev = torch.from_numpy(k_vecs).to(card)
        with torch.cuda.device(card):
            kernel_ms.append(cuda_ms(lambda: proj.sed_projection(
                parts[0][(0, a, 0)], parts[1][(0, a, 0)], parts[2][(0, a, 0)], k_dev), 1))
    check(1e3 * walls['resident'] < 0.5 * sum(kernel_ms),
          f"a resident call took {1e3 * walls['resident']:.1f} ms against the cards' kernels "
          f"{kernel_ms} ms: the cards ran in turn")
    # One launch of the clustered 'parity' kernel on each card at once (an odd count of time
    # tiles, unaligned rows, a ragged k-tile): each card's bits equal card 0's, which are
    # held to the plain version.
    gen0 = torch.Generator(cards[0]).manual_seed(SEED + 161)
    n_a = CLUSTER_ATOMS[-1]
    src = (torch.randn((CLUSTER_T, n_a, 3), generator=gen0, device=cards[0]),
           *(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cards[0])
             for x in (hi64[:n_a], lo64[:n_a], k_vecs[:33])))
    inputs = [tuple(x.to(card) for x in src) for card in cards]
    at_once = []
    for card, args in zip(cards, inputs):
        with torch.cuda.device(card):
            at_once.append(proj.sed_projection(*args))
    for card in cards:
        torch.cuda.synchronize(card)
    e, scale = pair_err(at_once[0], proj.sed_projection_plain(*inputs[0]))
    same = all(torch.equal(a.cpu(), b.cpu()) for out in at_once[1:] for a, b in zip(out, at_once[0]))
    check(same and e / scale <= TOL_KERNEL,
          f"one launch on each card at once at ({CLUSTER_T},{n_a},33): cards equal {same}, "
          f"card 0 vs plain {e / scale:.3e}")
    del src, inputs, at_once
    exchange = (MESH_CARDS - 1) * 2 * N_T * 3 * n_k * 4
    k_bytes = MESH_CARDS * n_k * 3 * 4
    window_bytes = N_T * N_ATOMS * 3 * 4 + 2 * N_ATOMS * 3 * 4
    for name, ingest in (('resident', k_bytes), ('host', k_bytes + window_bytes)):
        got = {c: counted[name].get(c) for c in ('mesh.exchange_bytes', 'mesh.ingest_bytes',
                                                  'launch.parity')}
        check(got == {'mesh.exchange_bytes': exchange, 'mesh.ingest_bytes': ingest,
                      'launch.parity': MESH_CARDS},
              f"{name} mesh counters {got}, want exchange {exchange}, ingest {ingest}, "
              f"{MESH_CARDS} launches")
    log('mesh', f"(f) (1, {MESH_CARDS}, 1) mesh of cards 0-{MESH_CARDS - 1}, {N_ATOMS} atoms x "
                f"{N_T} steps, {n_k} k: resident {walls['resident']:.3f} s a call, host source "
                f"{walls['host']:.3f} s, peaks equal bit for bit; each card's kernel alone "
                + ", ".join(f"{t:.1f}" for t in kernel_ms) + " ms; "
                f"{exchange} exchange bytes and {k_bytes} ingest bytes a resident call "
                f"({k_bytes + window_bytes} from the host source); {MESH_CARDS} launches each; "
                f"one launch on each card at once at ({CLUSTER_T},{CLUSTER_ATOMS[-1]},33): "
                f"the same bits on every card, {e / scale:.3e} vs plain")
    del calc, parts
    torch.cuda.empty_cache()
    return {'mesh_cards_resident': counted['resident']['launch.parity'],
            'mesh_cards_host': counted['host']['launch.parity']}


def phase16f_alone():
    """``python3 chip_smoke.py --phase 16f``: the build, then phase 16f."""
    from psa_tpu_torch import _build
    from psa_tpu_torch.ops import sed_projection as proj
    t_start = time.perf_counter()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    _build.build()
    _build.load()
    mesh_cards(proj)
    log('done', f"phase 16f took {time.perf_counter() - t_start:.1f} s")


def mesh_rest(dev, proj, group, thermal, side, k_vecs):
    """Phase 16c/d/e.  (c) On the phase-11 trajectory cut to MESH_DEPTH
    frames (CUT from 10^4), over the virtual (2, 2, 2) mesh in the NCCL
    group, 'exact': the DSF, S(k) and ISF on the DSF_K-point path, the self
    parts on SELF_K of them, MSD/VACF and the brute g(r) (r < RDF_R_MAX)
    against the one-device calls.  (d) Two processes on the one card over
    gloo (``psa_tpu_torch.parallel.smoke``), each owning half of a (2, 2, 2)
    mesh and reading its windows of a RANK_ATOMS x RANK_FRAMES ``.npy``
    memmap: equal results on both ranks and to this process's mesh, each
    rank reading half of every pass.  (e) ``python -m
    psa_tpu_torch.pod_sweep --peaks 3 --from-dump`` on the 10^4-atom dump over
    8 positions, then its resumed rerun.  Returns (launches per path,
    kernel checks)."""
    import dataclasses
    import torch.distributed as dist
    from psa_tpu_torch import SEDCalculator, TrajectoryLoader, pod_sweep
    from psa_tpu_torch.ops.instantaneous import nearest_commensurate
    from psa_tpu_torch.parallel import ArrayBlockSource, make_mesh, smoke
    from psa_tpu_torch.parallel.sharded import _shards
    mesh = make_mesh(shape=MESH_SHAPE, devices=[MESH_DEVICE] * 8, group=group)
    launches, walls = {}, {}

    # (c) the instantaneous-phase family and the k-independent observables
    cut = dataclasses.replace(thermal, positions=thermal.positions[:MESH_DEPTH],
                              velocities=thermal.velocities[:MESH_DEPTH],
                              timesteps=thermal.timesteps[:MESH_DEPTH])
    dcalc = SEDCalculator(cut, nx=side, ny=side, nz=side, max_device_bytes=DSF_BUDGET,
                          phase_mode='exact', device=dev)
    length = float(cut.box_matrix[0, 0])
    kv = nearest_commensurate(np.outer(np.arange(DSF_K) * (2 * np.pi / length), [1.0, 0.0, 0.0]),
                              cut.box_lengths)
    self_kv = kv[::DSF_K // SELF_K]
    rdf_kw = dict(r_max=RDF_R_MAX, n_bins=RDF_BINS, max_frames=RDF_BRUTE_FRAMES)
    errs, one_walls = {}, {}
    for name, single, sharded in (
            ('dsf', lambda: dcalc.calculate_dsf(kv)[1:],
             lambda: dcalc.calculate_dsf_sharded(mesh, kv)[1:]),
            ('sk', lambda: (dcalc.calculate_sk(kv),), lambda: (dcalc.calculate_sk_sharded(mesh, kv),)),
            ('isf', lambda: dcalc.calculate_isf(kv)[1:], lambda: dcalc.calculate_isf_sharded(mesh, kv)[1:]),
            ('dsf_self', lambda: dcalc.calculate_dsf_self(self_kv)[1:],
             lambda: dcalc.calculate_dsf_self_sharded(mesh, self_kv)[1:]),
            ('isf_self', lambda: dcalc.calculate_isf_self(self_kv)[1:],
             lambda: dcalc.calculate_isf_self_sharded(mesh, self_kv)[1:]),
            ('msd', lambda: dcalc.calculate_msd()[1:], lambda: dcalc.calculate_msd_sharded(mesh)[1:]),
            ('vacf', lambda: dcalc.calculate_vacf()[1:], lambda: dcalc.calculate_vacf_sharded(mesh)[1:]),
            ('rdf', lambda: dcalc.calculate_rdf(method='brute', **rdf_kw)[1:],
             lambda: dcalc.calculate_rdf(mesh=mesh, **rdf_kw)[1:])):
        want, one_walls[name], _ = timed(single)
        got = mesh_counted(proj, launches, walls, f'mesh_{name}', sharded)
        errs[name] = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
        check(all(np.isfinite(g).all() for g in got) and launches[f'mesh_{name}'] == 0,
              f"mesh {name}: non-finite values or {launches[f'mesh_{name}']} kernel launches")
        check(errs[name] <= (0.0 if name == 'rdf' else TOL_MESH_PLANES),
              f"mesh {name} vs one device {errs[name]:.3e}")
    dcalc.clear_device_cache()
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    log('mesh', f"(c) {N_ATOMS} atoms x {MESH_DEPTH} frames (CUT from {N_T}), 'exact', {DSF_K} k "
                f"({SELF_K} for the self parts), over the (2, 2, 2) mesh vs one device, of max: "
                + ", ".join(f"{n} {errs[n]:.3e} ({walls[f'mesh_{n}']:.2f} s; one device "
                            f"{one_walls[n]:.2f} s)" for n in errs)
                + f" (tol {TOL_MESH_PLANES}; g(r) counts equal); no projection launches")

    # (d) two processes on the one card over gloo
    rng = np.random.default_rng(SEED + 5)
    sites, rside, a0 = si_sites(RANK_ATOMS)
    rlen = float(np.float32(rside * a0))
    pos = (sites[None] + THERMAL_U * rng.standard_normal((RANK_FRAMES, RANK_ATOMS, 3))).astype(np.float32)
    vel = rng.standard_normal((RANK_FRAMES, RANK_ATOMS, 3)).astype(np.float32)
    freqs = np.fft.fftfreq(RANK_FRAMES, 0.01)
    keep = freqs >= 0
    inputs = dict(k_sed=k_vecs, freq_idx=np.flatnonzero(keep), freqs_kept=freqs[keep].astype(np.float32),
                  k_dsf=nearest_commensurate(np.outer(np.arange(DSF_K) * (2 * np.pi / rlen),
                                                      [1.0, 0.0, 0.0]), np.full(3, rlen)),
                  mean64=pos.astype(np.float64).mean(axis=0), n_peaks=N_PEAKS, n_lags=RANK_LAGS,
                  t_superchunk=RANK_SUPERCHUNK, mesh_shape=MESH_SHAPE, atom_chunk=RANK_ATOMS)
    with tempfile.TemporaryDirectory() as tmp:
        smoke.write_inputs(Path(tmp), pos, vel, **inputs)
        t0 = time.perf_counter()
        ranks = smoke.launch(Path(tmp), world=2, device=torch.device(MESH_DEVICE).type,
                             backend='gloo', positions=4, timeout=300)
        t_ranks = time.perf_counter() - t0
    one = mesh_counted(proj, launches, walls, 'mesh_one_process', lambda: smoke.run_sweeps(
        make_mesh(shape=MESH_SHAPE, devices=[MESH_DEVICE] * 8), ArrayBlockSource(pos),
        ArrayBlockSource(vel), inputs))
    launches['mesh_two_ranks'] = int(sum(int(r['launches']) for r in ranks))
    check(all(int(r['launches']) > 0 for r in ranks), "a rank launched no projection kernel")
    for key in smoke.RESULTS:
        check(np.array_equal(ranks[0][key], ranks[1][key]), f"the two ranks' {key} differ")
    check(bool(np.all(np.abs(ranks[0]['peak_freqs'] - one['peak_freqs']) <= TOL_PEAK_FREQ)),
          "two-rank peak frequencies differ from one process's")
    rank_errs = {k: float(np.abs(ranks[0][k] - one[k]).max() / np.abs(one[k]).max())
                 for k in smoke.RESULTS[1:]}
    check(max(rank_errs.values()) <= TOL_MESH_PLANES, f"two ranks vs one process {rank_errs}")
    elements = RANK_FRAMES * RANK_ATOMS
    reads = {k: [int(r[k]) for r in ranks] for k in ('vel_elements', 'pos_elements')}
    for k, n in (('vel_elements', 3), ('pos_elements', 5)):
        check(sum(reads[k]) == n * elements and max(reads[k]) <= n * elements // 2,
              f"{k} read per rank {reads[k]} of {n} passes over {elements}")
    log('mesh', f"(d) two processes on cuda:0 over gloo, {RANK_ATOMS} atoms x {RANK_FRAMES} frames "
                f"from .npy memmaps, a (2, 2, 2) mesh of 4 positions each: {t_ranks:.2f} s "
                f"(interpreters included); launches {[int(r['launches']) for r in ranks]}; "
                f"ranks equal bit for bit; vs one process (of max): "
                + ", ".join(f"{k} {e:.3e}" for k, e in rank_errs.items())
                + f"; trajectory elements read per rank {reads} (each <= half of every pass)")

    # (e) the pod sweep on the 10^4-atom dump, then its resumed rerun
    with tempfile.TemporaryDirectory() as tmp:
        dump, out = Path(tmp) / 'si.dump', Path(tmp) / 'pod'
        dside = write_dump(dump, SEED)
        args = ['--trajectory', str(dump), '--dt', '0.01', '--nx', str(dside), '--ny', str(dside),
                '--nz', str(dside), '--grid', str(GRID), '--k-chunk', str(K_CHUNK),
                '--peaks', str(N_PEAKS), '--from-dump', '--positions', '8', '--out', str(out),
                '--device', torch.device(MESH_DEVICE).type]
        first = mesh_counted(proj, launches, walls, 'pod_sweep', lambda: pod_sweep.main(args))
        pod = dict(np.load(out / 'kgrid_peaks.npz'))
        t0 = time.perf_counter()
        rerun = subprocess.run([sys.executable, '-m', 'psa_tpu_torch.pod_sweep'] + args,
                               capture_output=True, text=True, timeout=300,
                               cwd=str(Path(__file__).resolve().parent))
        t_rerun = time.perf_counter() - t0
        check(rerun.returncode == 0, f"pod_sweep rerun failed: {rerun.stderr[-2000:]}")
        n_k = len(k_vecs)
        check(f"0/{n_k} k-points computed" in rerun.stdout + rerun.stderr,
              "the rerun did not resume every chunk from its cache")
        again = dict(np.load(out / 'kgrid_peaks.npz'))
        check(all(np.array_equal(pod[k], again[k]) for k in pod), "the resumed rerun's files differ")
        traj = TrajectoryLoader(str(dump), dt=0.01, unwrap=False).load()
        dcalc = SEDCalculator(traj, nx=dside, ny=dside, nz=dside, device=dev)
        want = dcalc.calculate_kgrid_peaks(pod['k_vectors'], n_peaks=N_PEAKS)
        got = (pod['peak_freqs'], pod['peak_heights'], pod['peak_widths'])
        n_differ, h_err, _ = peaks_agree(dcalc, pod['k_vectors'], got, want, "pod sweep")
        shapes = kernel_at_mesh_shapes(
            proj, traj.velocities, dcalc.mean_positions64, pod['k_vectors'],
            [(DUMP_FRAMES, DUMP_ATOMS, -(-K_CHUNK // 8)),
             (RANK_SUPERCHUNK // MESH_SHAPE[0], RANK_ATOMS // MESH_SHAPE[1], n_k // MESH_SHAPE[2])])
    mesh_t, mesh_a, mesh_k = first['mesh'].values()
    want = mesh_t * mesh_a * sum(sum(hi > lo for lo, hi in _shards(min(K_CHUNK, n_k - s), mesh_k))
                                 for s in range(0, n_k, K_CHUNK))
    check(first['computed'] == n_k and launches['pod_sweep'] == want,
          f"pod sweep computed {first['computed']} k with {launches['pod_sweep']} launches, "
          f"want {want}")
    log('mesh', f"(e) python -m psa_tpu_torch.pod_sweep --peaks {N_PEAKS} --from-dump over 8 "
                f"positions of cuda:0, mesh {first['mesh']}: {walls['pod_sweep']:.2f} s in this "
                f"process, {launches['pod_sweep']} launches; peaks vs calculate_kgrid_peaks on the "
                f"loaded dump equal but on {n_differ} near-tied k-columns, heights within "
                f"{h_err:.3e}; resumed rerun as a command {t_rerun:.2f} s, 0/{n_k} k computed, "
                f"files equal; kernel vs plain at the two-rank and pod shapes: "
                + ", ".join(f"{s}: {e:.3e}" for s, e in shapes))
    return launches, shapes


class SectionClock(logging.Handler):
    """Seconds the command line spent up to each of its log lines."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.marks = []

    def emit(self, record):
        self.marks.append((time.perf_counter(), record.getMessage()))

    def sections(self, t_start):
        """Seconds per section: the time up to each line that ends a step of it."""
        ends = (('load', 'Calculating global max'), ('sed', 'SED data saved'),
                ('kgrid', 'k-grid dispersion surface written'), ('dos', 'DOS written'),
                ('dsf', 'DSF maps written'), ('timecorr', 'MSD written'),
                ('timecorr', 'VACF written'), ('rdf', 'RDF written'),
                ('ised', 'iSED motion dump written'))
        out, last = {}, t_start
        for stamp, msg in self.marks:
            for name, start in ends:
                if msg.startswith(start):
                    out[name], last = out.get(name, 0.0) + stamp - last, stamp
                    break
        check(set(out) == {name for name, _ in ends},
              f"the command line's log gave no end for {sorted({n for n, _ in ends} - set(out))}")
        return out


def cli_config(side):
    """Every section of the command line on the phase-9 dump: two SED
    directions, a 24x24 k-grid's peaks, the DOS, S(k, w), S(k) and the ISF
    with its KWW fit, MSD and VACF, g(r) and an iSED reconstruction."""
    return {
        'md_system': {'dt': 0.01, 'nx': side, 'ny': side, 'nz': side, 'lattice_parameter': SI_A0},
        'sed_calculation': {'directions': ['x', [1, 1, 0]], 'n_kpoints': 64, 'bz_coverage': 1.0},
        'plotting': {'max_freq_2d': 25.0},
        'kgrid': {'apply': True, 'plane': 'xy', 'k_range': [-2.0, 2.0], 'n_k': 24, 'n_peaks': 2,
                  'group_velocity': True},
        'dos': {'apply': True, 'max_freq': 40.0},
        'dsf': {'apply': True, 'directions': ['x'], 'n_kpoints': 16, 'bz_coverage': 1.0,
                'observables': ['total', 'longitudinal', 'sk', 'isf'], 'n_lags': 64, 'kww': True},
        'timecorr': {'apply': True, 'observables': ['msd', 'vacf'], 'n_lags': 100},
        'rdf': {'apply': True, 'r_max': RDF_R_MAX, 'n_bins': RDF_BINS, 'max_frames': 8},
        'ised': {'apply': True,
                 'k_path': {'direction': 'x', 'characteristic_length': SI_A0, 'n_points': 32,
                            'bz_coverage': 1.0},
                 'target_point': {'k_value': 0.5, 'w_value_thz': 10.0},
                 'reconstruction': {'rescaling_factor': 'auto', 'num_animation_timesteps': 8,
                                    'output_dump_filename': 'ised_motion.dump'}},
    }


CLI_FILES = (['kgrid_peaks_xy.npz', 'dos.csv', 'dsf_x.npz', 'msd.csv', 'vacf.csv', 'rdf.csv',
              'ised_motion.dump']
             + [f'sed_data_{{kind}}_{d}.{part}.npy' for d in ('x', '1.00_1.00_0.00')
                for part in ('sed', 'freqs', 'k_points', 'k_vectors')])


def check_cli_output(out, kind):
    """Every data file the sections write is there and loads."""
    for name in CLI_FILES:
        path = out / name.format(kind=kind)
        check(path.exists() and path.stat().st_size > 0, f"the command line wrote no {path.name}")
        if path.suffix == '.npy':
            check(np.isfinite(np.load(path)).all(), f"{path.name} holds non-finite values")
        elif path.suffix == '.npz':
            data = np.load(path)
            check(all(np.isfinite(data[k]).all() for k in data.files
                      if not k.startswith(('kww_', 'tau_alpha_'))),
                  f"{path.name} holds non-finite values")
        elif path.suffix == '.csv':
            check(np.isfinite(np.loadtxt(path, delimiter=',', skiprows=1)).all(), path.name)
    dsf = np.load(out / 'dsf_x.npz')
    check({'s', 'c_l', 'sk', 'isf', 'lags_ps', 'kww_tau_isf', 'tau_alpha_isf'} <= set(dsf.files),
          f"dsf_x.npz holds {sorted(dsf.files)}")
    check(np.loadtxt(out / 'rdf.csv', delimiter=',', skiprows=1).shape == (RDF_BINS, 2), "rdf.csv")
    check((out / 'ised_motion.dump').read_text().count('ITEM: TIMESTEP') == 8, "iSED frames")
    if kind == 'chiral':
        for d in ('x', '1.00_1.00_0.00'):
            check((out / f'sed_data_chiral_{d}.phase.npy').exists(), f"no chiral phase for {d}")


def cli_chunk_errors(dev, proj, calc, traj, config, launches):
    """Kernel vs plain at every (n_t, A, K) the command line's sections gave
    the kernel on the loaded dump: each SED direction's k-path (projected
    twice, once for the global maximum), the k-grid in chunks of
    ``calculate_kgrid_peaks``'s default 2,048, and the iSED path.  The
    launches these calls make must be the ``launches`` the run counted.
    Returns the path_chunks_rel_err entry."""
    from psa_tpu_torch.ops.spectral import split_f64
    sed_cfg, kg, kp = config['sed_calculation'], config['kgrid'], config['ised']['k_path']
    data = torch.from_numpy(np.ascontiguousarray(traj.velocities, np.float32)).to(dev)
    hi, lo = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in split_f64(calc.mean_positions64))
    k_sets = [(calc.get_k_path(d, sed_cfg['bz_coverage'], sed_cfg['n_kpoints'], SI_A0)[1], K_CHUNK, 2)
              for d in sed_cfg['directions']]
    k_sets.append((calc.get_k_grid(kg['plane'], tuple(kg['k_range']), tuple(kg['k_range']),
                                   kg['n_k'], kg['n_k'], k_fixed_val=0.0)[1], 2048, 1))
    k_sets.append((calc.get_k_path(kp['direction'], kp['bz_coverage'], kp['n_points'],
                                   kp['characteristic_length'])[1], K_CHUNK, 1))
    out, expect = [], 0
    for kv, chunk, times in k_sets:
        k_dev = torch.from_numpy(np.ascontiguousarray(kv, dtype=np.float32)).to(dev)
        errs = chunk_errors(proj, data, hi, lo, k_dev, chunk)
        out += errs
        expect += times * len(errs)
    check(expect == launches,
          f"the command line launched {launches} kernels, its sections' k-sets make {expect}")
    return {"path": "cli", "shapes": sorted({shape for shape, _ in out}),
            "rel_err": max(err for _, err in out)}


def command_line(dev, proj):
    """Phase 14: ``psa_tpu_torch.cli`` on the phase-9 dump (10^4 Si atoms x
    200 frames) with a JSON config holding every section: in this process
    with no ``--device`` (so it takes the card), its saved SED against the
    library's ``calculate`` on the same dump bit for bit; again without
    ``--recalculate-sed`` (the saved SED is loaded, fewer launches); then
    ``python -m psa_tpu_torch.cli --chiral`` as a process of its own.
    The kernel is then held against its plain version at the shapes the
    sections gave it.  Returns the launches of the first run and that check."""
    from psa_tpu_torch import SEDCalculator, TrajectoryLoader
    from psa_tpu_torch.cli import main as cli_main
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        side = write_dump(tmp / 'si.dump', SEED)
        config = cli_config(side)
        (tmp / 'config.json').write_text(json.dumps(config))
        args = ['--trajectory', str(tmp / 'si.dump'), '--config', str(tmp / 'config.json')]
        clock = SectionClock()
        logging.getLogger().addHandler(clock)
        logging.getLogger().setLevel(logging.INFO)
        proj.counters['launch.parity'] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_main(args + ['--output-dir', str(tmp / 'out')])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logging.getLogger().removeHandler(clock)
        launches = proj.counters['launch.parity']
        check(launches > 0, "the command line launched no projection kernel")
        check_cli_output(tmp / 'out', 'regular')
        sections = clock.sections(t0)

        traj = TrajectoryLoader(str(tmp / 'si.dump'), dt=0.01).load()
        calc = SEDCalculator(traj, nx=side, ny=side, nz=side, device=dev)
        same = []
        for direction, label in (('x', 'x'), ([1, 1, 0], '1.00_1.00_0.00')):
            k_mags, k_vecs = calc.get_k_path(direction, 1.0, 64, SI_A0)
            want = calc.calculate(k_mags, k_vecs, k_chunk_size=500).sed
            same.append(np.array_equal(np.load(tmp / 'out' / f'sed_data_regular_{label}.sed.npy'),
                                       want))
        check(all(same), f"the command line's saved SED differs from the library's: {same}")
        loop = cli_chunk_errors(dev, proj, calc, traj, config, launches)

        proj.counters['launch.parity'] = 0
        t0 = time.perf_counter()
        cli_main(args + ['--output-dir', str(tmp / 'out')])
        torch.cuda.synchronize()
        rerun_wall, rerun_launches = time.perf_counter() - t0, proj.counters['launch.parity']
        check(0 < rerun_launches < launches,
              f"the rerun launched {rerun_launches} kernels, the first run {launches}")

        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, '-m', 'psa_tpu_torch.cli', *args, '--chiral',
                               '--output-dir', str(tmp / 'out_chiral')], timeout=600,
                              cwd=Path(__file__).resolve().parent, capture_output=True, text=True)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr, flush=True)
        done.check_returncode()
        process_wall = time.perf_counter() - t0
        check_cli_output(tmp / 'out_chiral', 'chiral')
    log('cli', f"python -m psa_tpu_torch.cli on {DUMP_ATOMS} atoms x {DUMP_FRAMES} frames, JSON "
               f"config, every section, no --device: {wall:.3f} s wall, launches {launches}; "
               + ", ".join(f"{k} {v:.3f} s" for k, v in sections.items())
               + f"; {len(CLI_FILES)} data files present and finite; saved SED == library "
               f"calculate bit for bit (2 directions)")
    log('cli', f"rerun without --recalculate-sed: {rerun_wall:.3f} s, launches {rerun_launches} "
               f"(the saved SED is loaded); as a process of its own with --chiral: "
               f"{process_wall:.3f} s, phases written")
    log('cli', f"kernel vs plain at the command line's shapes {loop['shapes']}: rel err "
               f"{loop['rel_err']:.3e} (tol {TOL_KERNEL})")
    return launches, loop


def at_once(dev, *jobs):
    """Every job on a worker thread of its own, as the view runs a compute
    (``threading.Thread(target=work, daemon=True)``), all released together;
    joined, results in order, the first exception re-raised here.  A thread
    must see PyTorch's default stream: a group uploaded by one thread is
    ordered before the kernels another thread launches on it because both
    use that stream."""
    out, errors = [None] * len(jobs), []
    gate = threading.Barrier(len(jobs))

    def work(i, job):
        try:
            if dev.type == 'cuda':
                check(torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev),
                      "a worker thread's current stream is not the default stream")
            gate.wait(timeout=600)
            out[i] = job()
        except BaseException as e:      # noqa: BLE001 - re-raised in the main thread
            errors.append(e)
    threads = [threading.Thread(target=work, args=(i, job), daemon=True)
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "a worker thread did not finish in 900 s")
    if errors:
        raise errors[0]
    return out


def in_thread(dev, fn):
    """``fn()`` on one worker thread (:func:`at_once`)."""
    return at_once(dev, fn)[0]


class SessionSteps:
    """Runs the session's steps on worker threads; per step the wall (a
    ``profiling.Timer`` section closed after ``profiling.sync``), the
    projection launches and the peak device memory."""

    def __init__(self, dev, proj):
        from psa_tpu_torch.utils.profiling import Timer
        self.dev, self.proj, self.timer = dev, proj, Timer()
        self.launches, self.peak_gb = {}, {}
        self.fence = torch.zeros(1, device=dev)

    def run(self, name, fn):
        from psa_tpu_torch.utils.profiling import sync
        if self.dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        self.proj.counters['launch.parity'] = 0

        def timed_step():
            with self.timer.section(name):
                out = fn()
                sync(self.fence)
            return out
        out = in_thread(self.dev, timed_step)      # joined: the count is read after the thread
        self.launches[name] = self.proj.counters['launch.parity']
        if self.dev.type == 'cuda':
            self.peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
        return out

    def wall(self, name):
        return self.timer.sections[name]


def npy_header(f, shape):
    np.lib.format.write_array_header_1_0(f, {'descr': '<f4', 'fortran_order': False,
                                             'shape': tuple(shape)})


def session_sidecars(dev, tmp):
    """Write the ``.npy`` sidecar set the loader reads for the thermal Si
    slab at N_ATOMS atoms x SESSION_FRAMES frames: positions = sites + seeded
    thermal displacements, velocities = seeded N(0, 1) noise plus one phonon
    along x on column SESSION_MODE[0] of the session's k-path, both made on
    the card GEN_FRAMES frames at a time and appended to the two files.  Past
    SESSION_WRITE_BUDGET seconds the writing stops (at a multiple of
    GEN_FRAMES frames, so the phonon stays on a frequency bin) and the
    headers are rewritten for the frames there are.  Returns (dump path, frames, cells per side, seconds, q)."""
    sites, side, a0 = si_sites(N_ATOMS)
    length = float(np.float32(sites.max() + a0))
    col, nu, amp = SESSION_MODE
    q = float(np.linspace(0, SESSION_BZ * 2 * np.pi / SI_A0, SESSION_NK, dtype=np.float32)[col])
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    sites_dev = torch.from_numpy(sites).to(dev)
    wave = q * sites_dev[:, 0]
    stem = Path(tmp) / 'session'
    host = torch.empty((GEN_FRAMES, N_ATOMS, 3), dtype=torch.float32,
                       pin_memory=dev.type == 'cuda')
    t0 = time.perf_counter()
    files = {part: open(f'{stem}.{part}.npy', 'wb') for part in ('positions', 'velocities')}
    for f in files.values():
        npy_header(f, (SESSION_FRAMES, N_ATOMS, 3))
    head = files['positions'].tell()
    frames = 0
    while frames < SESSION_FRAMES:
        n = min(GEN_FRAMES, SESSION_FRAMES - frames)
        t = torch.arange(frames, frames + n, device=dev, dtype=torch.float64) * 0.01
        pos = (sites_dev[None] + THERMAL_U * torch.randn((n, N_ATOMS, 3), generator=gen, device=dev,
                                                         dtype=torch.float64)).float()
        vel = torch.randn((n, N_ATOMS, 3), generator=gen, device=dev)
        vel[:, :, 0] += (amp * torch.cos(wave[None, :] - 2 * np.pi * nu * t[:, None])).float()
        for part, block in (('positions', pos), ('velocities', vel)):
            host[:n].copy_(block)
            files[part].write(memoryview(host[:n].numpy()).cast('B'))
        frames += n
        if (time.perf_counter() - t0 > SESSION_WRITE_BUDGET and SESSION_MIN_FRAMES <= frames
                < SESSION_FRAMES):
            log('session', f"CUT: {frames} of {SESSION_FRAMES} frames were made and written in "
                           f"{time.perf_counter() - t0:.1f} s (budget {SESSION_WRITE_BUDGET:.0f} s): "
                           f"the session runs on {frames} frames, all {N_ATOMS} atoms")
            break
    for f in files.values():
        if frames < SESSION_FRAMES:
            f.seek(0)
            npy_header(f, (frames, N_ATOMS, 3))
            check(f.tell() == head, "the rewritten .npy header changed its length")
        f.close()
    np.save(f'{stem}.types.npy', np.ones(N_ATOMS, dtype=np.int32))
    np.save(f'{stem}.box_matrix.npy', np.diag([length] * 3).astype(np.float32))
    stem.with_suffix('.dump').touch()          # the file the sidecars belong to
    return stem.with_suffix('.dump'), frames, side, time.perf_counter() - t0, q


def write_sidecars(stem, traj):
    """The loader's sidecar set of an in-memory trajectory (per-frame cells too)."""
    for part in ('positions', 'velocities', 'types', 'box_matrix'):
        np.save(f'{stem}.{part}.npy', getattr(traj, part))
    if traj.box_matrices is not None:
        np.save(f'{stem}.box_matrices.npy', traj.box_matrices)
    Path(f'{stem}.dump').touch()
    return f'{stem}.dump'


def same_arrays(got, want):
    """Two results (arrays, None, or tuples of them) hold the same bits."""
    if got is None or want is None:
        return got is None and want is None
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(same_arrays(g, w) for g, w in zip(got, want))
    return np.array_equal(np.asarray(got), np.asarray(want))


def csv_columns(path, skiprows):
    """(header names, (rows, columns) float64 values) of a CSV the exports wrote."""
    with open(path, encoding='utf-8') as f:
        for _ in range(skiprows):
            f.readline()
        names = f.readline().rstrip('\n').split(',')
    return names, np.loadtxt(path, delimiter=',', skiprows=skiprows + 1, ndmin=2,
                             encoding='utf-8')


def session_exports(ctrl, steps, tmp, full_sed, dump):
    """Every export of the session's states, each CSV parsed back to the
    arrays of the state it came from (each in its own dtype, exactly)."""
    from psa_tpu_torch.gui import export
    out = Path(tmp) / 'exports'
    kg, pk, dsf, liquid, sed = ctrl.kgrid, ctrl.kgrid_peaks, ctrl.dsf, ctrl.liquid, ctrl.sed_result
    n_k = kg.intensity.shape[1]

    def back(column, like):
        """The parsed float64 ``column`` equals ``like`` in ``like``'s own dtype."""
        like = np.asarray(like)
        return np.array_equal(column.astype(like.dtype), like.reshape(column.shape))

    path = steps.run('export_kpath_csv', lambda: export.export_kpath_csv(sed, out / 'kpath.csv'))
    names, data = csv_columns(path, 0)
    keep = sed.freqs >= 0
    check(names[0] == 'frequency_THz' and len(names) == 1 + sed.sed.shape[1]
          and back(data[:, 0], sed.freqs[keep]) and back(data[:, 1:], sed.sed[keep]),
          "k-path CSV != its state")
    path = steps.run('export_kgrid_csv', lambda: export.export_kgrid_csv(kg, out / 'kgrid.csv'))
    names, data = csv_columns(path, 0)
    check(names == ['frequency_THz', 'k_x', 'k_y', 'intensity']
          and back(data[:, 0], np.repeat(kg.freqs, n_k))
          and back(data[:, 1], np.tile(np.repeat(kg.k1_axis, GRID), len(kg.freqs)))
          and back(data[:, 3], kg.intensity), "k-grid CSV != its state")
    grid_rows = len(data)
    path = steps.run('export_peaks_csv', lambda: export.export_peaks_csv(pk, out / 'peaks.csv'))
    names, data = csv_columns(path, 0)
    check(names[-1] == 'linewidth_THz_fwhm'
          and np.array_equal(data[:, 0], np.repeat(np.arange(N_PEAKS), n_k))
          and all(back(data[:, c], getattr(pk, field))
                  for c, field in ((3, 'freq_surfaces'), (4, 'intensity_surfaces'),
                                   (5, 'linewidth_surfaces'))), "peaks CSV != its state")
    path = steps.run('export_dsf_csv', lambda: export.export_dsf_csv(dsf, out / 'dsf.csv'))
    names, data = csv_columns(path, 1)
    with open(path, encoding='utf-8') as f:
        comment = f.readline()
    check(comment.startswith(f"# observable={dsf.observable} direction={dsf.direction_text} ")
          and len(names) == 1 + len(dsf.k_mags), f"DSF CSV head: {comment!r}, {len(names)} columns")
    check(back(data[:, 0], dsf.freqs) and back(data[:, 1:], dsf.plane), "DSF CSV != its state")
    path = steps.run('export_liquid_csv',
                     lambda: export.export_liquid_csv(liquid, out / 'liquid.csv'))
    names, data = csv_columns(path, 1)
    check(names[1:] == [lab.replace(' ', '_') for lab in liquid.curve_labels]
          and back(data[:, 0], liquid.x) and back(data[:, 1:], liquid.curves.T),
          "liquid CSV != its state")
    files = steps.run('export_npy_set', lambda: export.export_npy_set(full_sed, out / 'npy' / 'sed'))
    check(len(files) == 4 and np.array_equal(np.load(files[0]), full_sed.sed)
          and np.array_equal(np.load(files[1]), full_sed.freqs), ".npy set != the full spectrum")
    dest = steps.run('export_ised_dump', lambda: export.export_ised_dump(
        dump, out / 'motion.dump', {'selected_point': ctrl.selected_point}))
    check(dest.read_bytes() == Path(dump).read_bytes()
          and 'selected_point' in dest.with_suffix('.info.txt').read_text(), "iSED dump export")
    return grid_rows


def session_kernel_shapes(dev, proj, k_sets, launches):
    """Kernel vs plain at every (n_t, A, K) the session gave the kernel, as
    phase 14 does for the command line.  ``k_sets``: (calculator, k as the
    path hands it over (Miller rows for an NPT step), chunk, times run, NPT
    step or not); an NPT step is checked as it launches, on the fractional
    mean positions and k = 2*pi*m.  Those k-sets must account for the
    ``launches`` the steps counted.  Returns the path_chunks_rel_err entry."""
    out, expect, seen = [], 0, {}
    for calc, kv, chunk, times, npt in k_sets:
        key = (id(calc), np.asarray(kv, np.float64).tobytes(), chunk, npt)
        if key not in seen:
            everyone = np.arange(calc.traj.n_atoms)
            if npt:
                kv = calc._npt_k_setup(kv)[0]
                data, hi, lo = calc._fractional(lambda: calc._group_device_arrays(everyone))
            else:
                data, hi, lo = calc._group_device_arrays(everyone)
            k_dev = torch.from_numpy(np.ascontiguousarray(kv, dtype=np.float32)).to(dev)
            seen[key] = chunk_errors(proj, data, hi, lo, k_dev, chunk)
            out += seen[key]
        expect += times * len(seen[key])
    check(expect == launches,
          f"the session launched {launches} kernels, its steps' k-sets make {expect}")
    return {"path": "session", "shapes": sorted({shape for shape, _ in out}),
            "rel_err": max(err for _, err in out)}


def session_npt(dev, proj, steps, tmp):
    """The NPT part of the session on phase 10b's drifting chain, loaded
    from sidecars with per-frame cells: the k-path in Miller space, the
    Miller grid browsed and its peaks, each against the calculator's own
    call bit for bit; then an NPT grid and a fixed-cell peak surface started
    at once from two threads, which queue on the controller's lock.  Returns
    the k-sets of its counted steps for :func:`session_kernel_shapes`."""
    from psa_tpu_torch.gui.controller import AnalysisController
    from psa_tpu_torch.utils.helpers import miller_line
    nu, mode_m, n_frames = 4.0, 7, 128
    traj = npt_chain(1.0 + 0.10 * np.linspace(0.0, 1.0, n_frames), mode_m=mode_m)
    ctrl = AnalysisController()
    in_thread(dev, lambda: ctrl.load_trajectory(write_sidecars(Path(tmp) / 'npt_chain', traj),
                                                dt=0.01, file_format='lammps', nx=16, ny=1, nz=1))
    check(ctrl.trajectory.box_matrices is not None and ctrl.calculator.device.type == dev.type,
          "the NPT chain's per-frame cells were not loaded")
    calc = ctrl.calculator
    sed = steps.run('session_npt_sed', lambda: ctrl.compute_npt_sed('x', n_k=8, max_order=8.0))
    want = calc.calculate_npt_browse(miller_line('x', 8, 8.0), readback_dtype='float32')
    col = mode_m - 1
    peak = sed.freqs[np.argmax(sed.sed[:, col])]
    df = sed.freqs[1] - sed.freqs[0]
    check(same_arrays((sed.freqs, sed.sed), want[:2]) and abs(peak - nu) <= df + 1e-9,
          f"NPT k-path: ridden phonon at {peak} THz, want {nu}")
    grid_args = ('xy', (1.0, 8.0), (0.0, 1.0), 8, 2)
    kg = steps.run('session_npt_grid', lambda: ctrl.compute_kgrid_sed(*grid_args, npt=True))
    pk = steps.run('session_npt_peaks', lambda: ctrl.compute_kgrid_peaks(*grid_args, npt=True))
    _, m_rows, _ = calc.get_k_grid(*grid_args)
    want_b = calc.calculate_npt_browse(m_rows.astype(np.float64), k_chunk_size=SESSION_GRID_CHUNK,
                                       readback_dtype='float32')
    want_p = calc.calculate_npt_peaks(m_rows.astype(np.float64), n_peaks=1,
                                      k_chunk_size=SESSION_GRID_CHUNK, engine='direct')
    check(kg.labels == pk.labels == ('m_x', 'm_y') and same_arrays(kg.intensity, want_b[1])
          and same_arrays(pk.freq_surfaces.ravel(), want_p[0].ravel())
          and same_arrays(pk.intensity_surfaces.ravel(), want_p[1].ravel()),
          "the controller's NPT grid differs from the calculator's")
    for name in ('session_npt_sed', 'session_npt_grid', 'session_npt_peaks'):
        check(steps.launches[name] == 1, f"{name} launched {steps.launches[name]} kernels")

    fixed_args = ('xy', (-1, 1), (-1, 1), 6, 5)
    alone = steps.run('session_npt_fixed_peaks',
                      lambda: ctrl.compute_kgrid_peaks(*fixed_args, n_peaks=2))
    rounds = 3
    both = steps.run('session_npt_at_once', lambda: [at_once(
        dev, lambda: ctrl.compute_kgrid_sed(*grid_args, npt=True),
        lambda: ctrl.compute_kgrid_peaks(*fixed_args, n_peaks=2)) for _ in range(rounds)])
    for got_npt, got_fixed in both:
        check(same_arrays(got_npt.intensity, kg.intensity)
              and same_arrays((got_fixed.freq_surfaces, got_fixed.intensity_surfaces,
                               got_fixed.linewidth_surfaces),
                              (alone.freq_surfaces, alone.intensity_surfaces,
                               alone.linewidth_surfaces)),
              "two computes started at once differ from the lone runs")
    check(calc._phase_anchor == 'cartesian', "the NPT anchor was left set")
    check(steps.launches['session_npt_fixed_peaks'] == 1
          and steps.launches['session_npt_at_once'] == 2 * rounds,
          f"the chain's fixed-cell peaks and rounds launched "
          f"{ {n: c for n, c in steps.launches.items() if 'npt_' in n} }")
    log('session', f"NPT chain through the controller: ridden phonon at {peak:.3f} THz (want {nu}); "
                   f"k-path, Miller grid and its peaks == the calculator's calls bit for bit, 1 "
                   f"launch each; {rounds} rounds of an NPT grid and a fixed-cell peak surface "
                   "started at once from two threads (2 launches a round): both equal their lone "
                   "runs bit for bit")
    return [(calc, miller_line('x', 8, 8.0), K_CHUNK, 1, True),
            (calc, m_rows.astype(np.float64), SESSION_GRID_CHUNK, 2 + rounds, True),
            (calc, calc.get_k_grid(*fixed_args)[1], SESSION_GRID_CHUNK, 1 + rounds, False)]


def session(dev, proj):
    """Phase 15: an interactive session through the GUI's headless
    controller and exports, every compute on a worker thread.  Returns
    ({session_* step: launches}, the path_chunks_rel_err entry)."""
    from psa_tpu_torch.gui.controller import AnalysisController
    from psa_tpu_torch.io import native
    from psa_tpu_torch.ops.instantaneous import commensurate_kpath
    from psa_tpu_torch.utils import debug
    steps = SessionSteps(dev, proj)
    col, nu, _ = SESSION_MODE
    with tempfile.TemporaryDirectory() as tmp:
        # -- load ----------------------------------------------------------------
        path, n_t, side, t_write, q = session_sidecars(dev, tmp)
        gb = 12.0 * n_t * N_ATOMS / 1e9
        ctrl = AnalysisController()                      # no device named: the card
        check(ctrl.has_cache(str(path)), "the sidecar set is not seen as a cache")
        traj = steps.run('load', lambda: ctrl.load_trajectory(
            str(path), dt=0.01, file_format='lammps', nx=side, ny=side, nz=side))
        calc = ctrl.calculator
        check(traj.positions.shape == (n_t, N_ATOMS, 3) and calc.device.type == dev.type,
              f"loaded {traj.positions.shape} on {calc.device}")
        log('session', f"sidecars of {N_ATOMS} atoms x {n_t} frames ({gb:.1f} GB per array) made on "
                       f"the card and written in {t_write:.2f} s; load_trajectory (worker thread) "
                       f"{steps.wall('load'):.2f} s")
        small = AnalysisController()
        dump_side = write_dump(Path(tmp) / 'si.dump', SEED)
        parsed = native.bulk_parses
        steps.run('load_dump', lambda: small.load_trajectory(
            str(Path(tmp) / 'si.dump'), dt=0.01, file_format='lammps',
            nx=dump_side, ny=dump_side, nz=dump_side))
        check(native.bulk_parses - parsed == DUMP_FRAMES and small.has_cache(str(Path(tmp) / 'si.dump'))
              and small.trajectory.positions.shape == (DUMP_FRAMES, DUMP_ATOMS, 3),
              "the text dump did not go through the C parser")
        small_sed = steps.run('session_dump_kpath', lambda: small.compute_kpath_sed(
            'x', n_k=32, bz_coverage=1.0, lattice_param=SI_A0))
        check(steps.launches['session_dump_kpath'] == 1 and bool(np.isfinite(small_sed.sed).all()),
              "k-path SED of the parsed dump")
        log('session', f"text dump {DUMP_ATOMS} atoms x {DUMP_FRAMES} frames through load_trajectory "
                       f"(C parser, sidecars written): {steps.wall('load_dump'):.2f} s; its k-path "
                       f"SED {steps.wall('session_dump_kpath'):.3f} s")
        del small_sed

        # -- k-path, click, full spectrum ------------------------------------------
        kpath = dict(n_k=SESSION_NK, bz_coverage=SESSION_BZ, lattice_param=SI_A0)
        k_mags, k_vecs = calc.get_k_path('x', SESSION_BZ, SESSION_NK, SI_A0)
        check(float(k_mags[col]) == q, "the phonon is not on the k-path")
        sed = steps.run('session_kpath_first', lambda: ctrl.compute_kpath_sed('x', **kpath))
        again = steps.run('session_kpath', lambda: ctrl.compute_kpath_sed('x', **kpath))
        want = calc.calculate_kgrid_browse(k_vecs, readback_dtype='float32')
        check(same_arrays((sed.freqs, sed.sed), want[:2]) and same_arrays(sed.sed, again.sed)
              and not sed.is_complex, "the reduced k-path planes != calculate_kgrid_browse's")
        lt = steps.run('session_kpath_lt', lambda: ctrl.compute_kpath_sed(
            'x', polarization='longitudinal', **kpath))
        want_lt = calc.calculate_lt(k_vecs)
        row = int(np.argmax(sed.sed[:, col]))
        lt_share = float(lt.sed[row, col] / sed.sed[row, col])
        check(same_arrays(lt.sed, want_lt[1]) and lt_share > 0.99,
              f"the longitudinal planes != calculate_lt's, or hold {lt_share} of the x phonon")
        welch = steps.run('session_kpath_welch', lambda: ctrl.compute_kpath_sed(
            'x', welch_segments=4, **kpath))
        want_w = calc.calculate_welch(k_mags, k_vecs, segments=4, window='hann')
        check(same_arrays(welch.sed, want_w.sed) and welch.sed.shape[0] == n_t // 4,
              "the Welch planes != calculate_welch's")
        ctrl.compute_kpath_sed('x', **kpath)             # back to the reduced display
        f_peak = float(sed.freqs[np.argmax(sed.sed[:, col])])
        check(abs(f_peak - nu) < 1e-4, f"column {col} peaks at {f_peak} THz, the phonon is at {nu}")
        click = (q + 0.3 * float(k_mags[1]), nu + 0.3 * float(sed.freqs[1]))    # a near miss
        picked = ctrl.select_nearest(*click)
        check(picked == (float(sed.k_points[col]), f_peak) == ctrl.selected_point,
              f"the click at {click} snapped to {picked}")
        full = steps.run('session_full_kpath', ctrl.full_kpath_sed)
        check(full.is_complex and full.sed.shape == (n_t, SESSION_NK, 3)
              and ctrl.sed_result is not full, "full_kpath_sed")
        cols = np.array([1, col, SESSION_NK // 2, SESSION_NK - 1])
        data_dev = calc._group_device_arrays(np.arange(N_ATOMS))[0]
        oracle = f64_oracle(data_dev, torch.from_numpy(calc.mean_positions64).to(dev),
                            torch.from_numpy(k_vecs[cols].astype(np.float64)).to(dev))
        got = torch.from_numpy(np.ascontiguousarray(full.sed[:, cols, :])).to(dev)
        oracle_err = rel(got.to(torch.complex128), oracle)
        keep = full.freqs >= 0
        reduced_err = float(np.abs(sed.sed[:, cols] - (oracle.abs() ** 2).sum(dim=-1).cpu().numpy()[keep]
                                   ).max() / sed.sed[:, cols].max())
        check(oracle_err <= TOL_KERNEL and reduced_err <= TOL_KERNEL,
              f"k-path vs f64 oracle: spectrum {oracle_err:.3e}, reduced planes {reduced_err:.3e}")
        del oracle, got, data_dev
        log('session', f"k-path 'x', {SESSION_NK} k, bz {SESSION_BZ}: first (host mean, "
                       f"{gb:.1f} GB upload) {steps.wall('session_kpath_first'):.3f} s, warm "
                       f"{steps.wall('session_kpath'):.3f} s, longitudinal "
                       f"{steps.wall('session_kpath_lt'):.3f} s ({lt_share:.6f} of the phonon's "
                       f"peak), Welch x4 "
                       f"{steps.wall('session_kpath_welch'):.3f} s, full complex "
                       f"{steps.wall('session_full_kpath'):.3f} s; planes == the calculator's calls "
                       f"bit for bit; 4 k-columns vs f64 oracle {oracle_err:.3e} (spectrum), "
                       f"{reduced_err:.3e} (reduced planes) (tol {TOL_KERNEL}); click near "
                       f"({q:.4f}, {nu}) snapped to {picked}, the injected phonon")

        # -- the 50x50 grid: browse and peaks, both engines -------------------------
        grid_args = ('xy', (-5, 5), (-5, 5), GRID, GRID)
        _, grid_k, shape = calc.get_k_grid(*grid_args)
        planes = {}
        for name, engine, dtype in (('session_kgrid_direct', 'direct', 'float32'),
                                    ('session_kgrid_direct_f16', 'direct', 'float16'),
                                    ('session_kgrid_gridded', 'gridded', 'float32')):
            ctrl.readback_dtype = dtype
            planes[name] = steps.run(name, lambda: ctrl.compute_kgrid_sed(
                *grid_args, max_freq=SESSION_MAX_FREQ, engine=engine)).intensity
        ctrl.readback_dtype = 'float32'
        want = calc.calculate_kgrid_browse(grid_k, max_freq=SESSION_MAX_FREQ, engine='direct',
                                           k_chunk_size=SESSION_GRID_CHUNK, k_grid_shape=shape)
        exact = planes['session_kgrid_direct']
        floor = F16_REL_FLOOR * exact.max()
        bright = exact >= floor
        f16_rel = float(np.max(np.abs(planes['session_kgrid_direct_f16'][bright] - exact[bright])
                               / exact[bright]))
        engines_gap = float(np.abs(planes['session_kgrid_gridded'] - exact).max() / exact.max())
        check(same_arrays(exact, want[1]) and f16_rel <= F16_REL_EPS and engines_gap <= TOL_TWO_ENGINES,
              f"grid browse: float16 {f16_rel:.3e}, gridded vs direct {engines_gap:.3e}")
        peaks = {}
        for name, engine in (('session_peaks_direct', 'direct'), ('session_peaks_gridded', 'gridded')):
            peaks[name] = steps.run(name, lambda: ctrl.compute_kgrid_peaks(
                *grid_args, n_peaks=N_PEAKS, engine=engine, width_method='lorentzian'))
            want = calc.calculate_kgrid_peaks(
                grid_k, n_peaks=N_PEAKS, k_chunk_size=SESSION_GRID_CHUNK, engine=engine,
                k_grid_shape=shape if engine != 'direct' else None, width_method='lorentzian')
            pk = peaks[name]
            check(same_arrays([x.reshape(N_PEAKS, -1) for x in (
                pk.freq_surfaces, pk.intensity_surfaces, pk.linewidth_surfaces)], want),
                f"the controller's {engine} peaks != calculate_kgrid_peaks's")
        as_triplet = {n: (p.freq_surfaces.reshape(N_PEAKS, -1), p.intensity_surfaces.reshape(N_PEAKS, -1))
                      for n, p in peaks.items()}
        n_differ, h_err, (n_bright, dim_err, surface_err) = peaks_agree(
            calc, grid_k, as_triplet['session_peaks_gridded'], as_triplet['session_peaks_direct'],
            "session peaks", bright_share=SESSION_BRIGHT)
        ctrl.compute_kgrid_sed(*grid_args, max_freq=SESSION_MAX_FREQ, engine='direct')
        log('session', f"{GRID}x{GRID} grid, max_freq {SESSION_MAX_FREQ} THz: browse direct "
                       f"{steps.wall('session_kgrid_direct'):.3f} s, float16 "
                       f"{steps.wall('session_kgrid_direct_f16'):.3f} s (per-pixel rel err "
                       f"{f16_rel:.3e}), gridded {steps.wall('session_kgrid_gridded'):.3f} s (planes "
                       f"{engines_gap:.3e} from direct); peaks (n_peaks={N_PEAKS}, lorentzian) direct "
                       f"{steps.wall('session_peaks_direct'):.3f} s, gridded "
                       f"{steps.wall('session_peaks_gridded'):.3f} s ({n_differ} near-tied columns "
                       f"differ; heights within {h_err:.3e} of the column's highest on the "
                       f"{n_bright} columns that reach {SESSION_BRIGHT} of the surface's highest, "
                       f"within {surface_err:.3e} of the surface's highest on all (tol "
                       f"{TOL_TWO_ENGINES}); on the dim columns the gridded engine is off by up to "
                       f"{dim_err:.3e} of the column's own highest: the strong mode's NUFFT error); "
                       "each == the calculator's call bit for bit")

        # -- DOS, DSF, liquid curves -------------------------------------------------
        freqs, dos = steps.run('session_dos', lambda: ctrl.compute_dos(max_freq=20.0))
        check(same_arrays((freqs, dos), calc.calculate_dos(max_freq=20.0))
              and abs(float(freqs[np.argmax(dos[0])]) - nu) < 1e-4,
              "the DOS differs from calculate_dos's, or does not peak on the phonon")
        dsf_path = dict(n_k=SESSION_DSF_NK, bz_coverage=SESSION_BZ, lattice_param=SI_A0)
        snapped = commensurate_kpath(calc.get_k_path('x', SESSION_BZ, SESSION_DSF_NK, SI_A0)[1],
                                     traj.box_matrix)
        direct = None
        for observable in ('total', 'longitudinal', 'transverse', 'self'):
            k, f, plane = steps.run(f'session_dsf_{observable}', lambda: ctrl.compute_kpath_dsf(
                'x', max_freq=20.0, observable=observable, **dsf_path))
            check(plane.shape == (len(f), len(snapped)) and bool(np.isfinite(plane).all())
                  and ctrl.sed_result is not None, f"DSF {observable}")
            if observable == 'self':
                want = calc.calculate_dsf_self(snapped, max_freq=20.0)[1]
            else:
                direct = direct or calc.calculate_dsf(snapped, max_freq=20.0)
                want = direct[{'total': 1, 'longitudinal': 2, 'transverse': 3}[observable]]
            check(same_arrays(plane, want), f"the DSF view's {observable} plane != the calculator's")
        curves = {}
        v0_err = 5 * 3 * np.sqrt(2.0 / (3.0 * n_t * N_ATOMS)) + 1e-3      # of <|v|^2> = 3 + A^2/2
        for kind in ('sk', 'rdf', 'msd', 'vacf', 'isf_self'):
            x, c, _, _ = steps.run(f'session_liquid_{kind}', lambda: ctrl.compute_liquid_curve(
                kind, direction_text='x', **dsf_path))
            check(c.shape[1] == len(x) and bool(np.isfinite(c).all()), f"liquid curve {kind}")
            curves[kind] = c
            if kind == 'rdf':
                rdf_r = x
        log('session', "liquid curves: " + ", ".join(
            f"{k} {steps.wall(f'session_liquid_{k}'):.3f} s" for k in curves)
            + f" (g(r): the controller passes no r_max, so it spans half the box, "
              f"{float(rdf_r[-1]):.1f} Å, where the linked cells prune nothing)")
        check(same_arrays(curves['sk'][0], calc.calculate_sk(snapped)), "S(k) != calculate_sk's")
        check(same_arrays(curves['msd'], calc.calculate_msd()[1]), "MSD != calculate_msd's")
        g, bin_width = curves['rdf'][0], float(rdf_r[1] - rdf_r[0])
        shell = float(rdf_r[np.argmax(np.where(rdf_r < 3.0, g, 0.0))])
        check(float(g[rdf_r < 2.0 - bin_width].max()) < 0.01 * float(g.max())
              and abs(shell - SI_A0 * np.sqrt(3) / 4) <= bin_width,
              f"g(r): first peak at {shell} Å, bins of {bin_width} Å")
        check(abs(float(curves['vacf'][0, 0]) - (3.0 + SESSION_MODE[2] ** 2 / 2)) <= v0_err
              and np.allclose(curves['isf_self'][:, 0], 1.0, rtol=1e-5),
              f"VACF(0) {curves['vacf'][0, 0]}, F_s(k, 0) {curves['isf_self'][:, 0]}")
        log('session', f"DOS {steps.wall('session_dos'):.3f} s (peak on the phonon); DSF view, "
                       f"{len(snapped)} commensurate k: "
                       + ", ".join(f"{o} {steps.wall(f'session_dsf_{o}'):.3f} s"
                                   for o in ('total', 'longitudinal', 'transverse', 'self'))
                       + f"; VACF(0) = {curves['vacf'][0, 0]:.4f}; DOS, DSF planes, S(k) and MSD == "
                       "the calculator's calls bit for bit, g(r) starts with the first Si shell")

        # -- iSED at the clicked mode, exports, clean-up ----------------------------------
        dump = steps.run('session_ised', lambda: ctrl.reconstruct_ised(
            'x', char_len=SI_A0, n_k=SESSION_NK, bz_coverage=SESSION_BZ,
            n_frames=SESSION_ISED_FRAMES))
        pos, types, _ = steps.run('session_ised_motion', ctrl.load_ised_motion)
        move = pos.astype(np.float64) - pos.astype(np.float64).mean(axis=0)
        sites_x = calc.mean_positions64[:, 0]
        wave_share = float(np.abs((move[0, :, 0] * np.exp(-1j * q * sites_x)).sum())
                           / (N_ATOMS * np.sqrt((move[0, :, 0] ** 2).mean())))
        along_x = float((move[..., 0] ** 2).sum() / (move ** 2).sum())
        check(pos.shape == (SESSION_ISED_FRAMES, N_ATOMS, 3) and len(types) == N_ATOMS
              and along_x > 0.99 and wave_share > 0.6,
              f"iSED motion {pos.shape}: {along_x:.4f} along x, plane-wave share {wave_share:.3f}")
        grid_rows = session_exports(ctrl, steps, tmp, full, dump)
        held = [Path(t.name) for t in ctrl.temp_dirs]
        ctrl.cleanup()
        check(held and not any(p.exists() for p in held) and ctrl.temp_dirs == [],
              "cleanup left a temporary directory")
        log('session', f"iSED at the click: {steps.wall('session_ised'):.2f} s, dump of "
                       f"{SESSION_ISED_FRAMES} frames x {N_ATOMS} atoms re-read in "
                       f"{steps.wall('session_ised_motion'):.2f} s, {along_x:.4f} of the motion along "
                       f"x, {wave_share:.3f} of a plane wave's overlap with exp(iqx) (0.707 when "
                       "pure); exports: "
                       + ", ".join(f"{n[7:]} {steps.wall(n):.2f} s" for n in steps.timer.sections
                                   if n.startswith('export_'))
                       + f" (k-grid CSV {grid_rows} rows); every CSV parsed back to its state's "
                       "arrays exactly; cleanup removed the temporary directory")

        # -- two computes at once on the big controller -----------------------------------
        alone_k, alone_p = ctrl.compute_kpath_sed('x', **kpath).sed, peaks['session_peaks_direct']
        got_k, got_p = steps.run('session_at_once', lambda: at_once(
            dev, lambda: ctrl.compute_kpath_sed('x', **kpath),
            lambda: ctrl.compute_kgrid_peaks(*grid_args, n_peaks=N_PEAKS, engine='direct',
                                             width_method='lorentzian')))
        check(same_arrays(got_k.sed, alone_k)
              and same_arrays((got_p.freq_surfaces, got_p.intensity_surfaces,
                               got_p.linewidth_surfaces),
                              (alone_p.freq_surfaces, alone_p.intensity_surfaces,
                               alone_p.linewidth_surfaces)),
              "two computes started at once on the big controller differ from the lone runs")
        log('session', "a k-path SED and a direct peak surface started at once from two threads "
                       "on the big controller: both equal their lone runs bit for bit")

        # -- the NPT chain ----------------------------------------------------------------------
        npt_sets = session_npt(dev, proj, steps, tmp)

        # -- the kernel at the session's shapes, the launches ----------------------------------
        check(SESSION_NK <= K_CHUNK, "the k-path must fit one k-chunk of every surface")
        grid_chunks = -(-len(grid_k) // SESSION_GRID_CHUNK)
        direct_steps = {'session_kpath_first': 1, 'session_kpath': 1, 'session_kpath_lt': 1,
                        'session_kpath_welch': 1, 'session_full_kpath': 1, 'session_ised': 1,
                        'session_kgrid_direct': grid_chunks, 'session_kgrid_direct_f16': grid_chunks,
                        'session_peaks_direct': grid_chunks, 'session_at_once': 1 + grid_chunks}
        none = [n for n in steps.launches if n.startswith(('session_dsf', 'session_liquid'))] + [
            'session_kgrid_gridded', 'session_peaks_gridded', 'session_dos']
        for name, want_n in direct_steps.items():
            check(steps.launches[name] == want_n,
                  f"{name} launched {steps.launches[name]} kernels, want {want_n}")
        check(all(steps.launches[n] == 0 for n in none),
              f"a DSF, liquid, gridded or DOS step launched the projection kernel: "
              f"{ {n: steps.launches[n] for n in none} }")
        counted = sum(steps.launches.values())          # every step of the phase, exports and loads too
        dump_k = small.calculator.get_k_path('x', 1.0, 32, SI_A0)[1]
        loop = session_kernel_shapes(
            dev, proj, [(calc, k_vecs, SESSION_NK, 7, False),
                        (calc, grid_k, SESSION_GRID_CHUNK, 4, False),
                        (small.calculator, dump_k, K_CHUNK, 1, False)] + npt_sets, counted)
        log('session', f"kernel vs plain at every shape the session launched {loop['shapes']}: rel "
                       f"err {loop['rel_err']:.3e} (tol {TOL_KERNEL}); those k-sets make all "
                       f"{counted} launches of the phase's steps: "
                       + ", ".join(f"{n[8:]} {c}" for n, c in steps.launches.items() if c)
                       + f"; 0 on {len(none)} DSF, liquid, gridded and DOS steps")
        peak_gb = max(steps.peak_gb.values()) if steps.peak_gb else 0.0
        top = max(steps.peak_gb, key=steps.peak_gb.get) if steps.peak_gb else '-'
        ctrl.calculator.clear_device_cache()
        del ctrl, calc, traj, small, npt_sets

    # -- debug mode ---------------------------------------------------------------------------
    from psa_tpu_torch import SEDCalculator
    from psa_tpu_torch.models import make_chain_trajectory
    chain = make_chain_trajectory(n_cells=16, n_frames=64, dt_ps=0.05)
    dcalc = SEDCalculator(chain, nx=16, ny=1, nz=1, device=dev)
    k_mags, k_path = dcalc.get_k_path('x', bz_coverage=0.5, n_k=9)
    plain = dcalc.calculate(k_mags, k_path).sed
    with debug.debug_numerics():
        checked = dcalc.calculate(k_mags, k_path).sed
    chain.velocities[5, 3, 0] = np.nan
    dcalc.clear_device_cache()
    raised = None
    with debug.debug_numerics():
        try:
            dcalc.calculate(k_mags, k_path)
        except FloatingPointError as e:
            raised = str(e)
    check(np.array_equal(plain, checked) and not debug.active and raised is not None
          and 'sed_projection' in raised, f"debug_numerics: raised {raised!r}")
    check('tkinter' not in sys.modules and 'matplotlib' not in sys.modules,
          "the session imported tkinter or matplotlib")
    log('session', f"debug_numerics: a clean calculate passes with the same bits; a NaN velocity "
                   f"raises FloatingPointError ({raised}); neither tkinter nor matplotlib imported; "
                   f"peak device memory over the session's steps {peak_gb:.1f} GB (in {top})")
    log('session', "walls by step:\n" + steps.timer.report())
    launches = {n: c for n, c in steps.launches.items() if n.startswith('session_')}
    return launches, loop


BENCH_KBLOCK = 1280                   # bench_torch.py's default k-points per launch
BENCH_TIMEOUT = 600                   # s, each bench_torch.py command of phase 17
BENCH_EXTRAS_STEPS = 2000             # PSA_BENCH_STEPS of phase 17d
EXAMPLES =('basic_sed_analysis', 'chiral_sed_analysis', 'k_grid_heatmap_example',
            'ised_reconstruction', 'grid_browse_and_engines', 'chiral_phonons_2d',
            'dos_analysis', 'spectral_statistics', 'thermal_transport', 'npt_cell_sed',
            'dynamic_structure_factor', 'liquid_dynamics', 'pod_mesh_semantics',
            'visualization_example')
#: Examples whose paths project (the others: the DOS, the instantaneous-phase
#: family, the liquid observables and the plots).
PROJECTING = {'basic_sed_analysis', 'chiral_sed_analysis', 'k_grid_heatmap_example',
              'ised_reconstruction', 'grid_browse_and_engines', 'chiral_phonons_2d',
              'spectral_statistics', 'thermal_transport', 'npt_cell_sed', 'pod_mesh_semantics'}


def kernel_times(proj, data, hi, lo, k_dev, block, reps=3):
    """The kernel alone at each block of ``block`` k-points, ``reps``
    launches each, CUDA events as in phase 3: ([least ms], [max − min ms])
    per block."""
    least, spread = [], []
    for s in range(0, len(k_dev), block):
        ms = [cuda_ms(lambda s=s: proj.sed_projection(data, hi, lo, k_dev[s:s + block]), 1)
              for _ in range(reps)]
        least.append(min(ms))
        spread.append(max(ms) - min(ms))
    return least, spread


def check_sweep_wall(sweep_ms, block_ms, spread_ms, what):
    """A sweep's wall is at least its launches' kernel times: the least of
    each block's timed launches, less their spread (the kernel's own
    run-to-run variation in this run).  A sweep whose fence failed would
    read the enqueue time, milliseconds."""
    floor_ms = sum(block_ms) - sum(spread_ms)
    check(sweep_ms >= floor_ms, f"{what} wall {sweep_ms:.3f} ms < its kernels' {sum(block_ms):.3f} "
                                f"ms less their spread {sum(spread_ms):.3f} ms")
    return (f"its kernels alone {' + '.join(f'{m:.3f}' for m in block_ms)} ms, spread "
            f"{sum(spread_ms):.3f} ms")


def bench_sweep(proj, velocities, hi_dev, lo_dev, k_vecs, oracle, cols):
    """Phase 17a: ``bench_torch.op_sweep`` in this process on the working
    data (its default blocks of 1,280 k, the last ragged), its spectrum's
    ``cols`` against the float64 oracle; then the kernel alone at each
    block's shape, whose times bound the sweep's wall from below
    (:func:`check_sweep_wall`).  Returns (launches, kernel ms per block)."""
    import bench_torch
    n_k = len(k_vecs)
    k_dev = torch.from_numpy(np.ascontiguousarray(k_vecs, dtype=np.float32)).to(velocities.device)
    proj.counters['launch.parity'] = 0
    sweep = bench_torch.op_sweep(velocities, hi_dev, lo_dev, k_dev, BENCH_KBLOCK, keep=cols)
    launches = proj.counters['launch.parity']
    err = rel(sweep.kept.to(torch.complex128), oracle)
    check(launches == sweep.launches == 1 + -(-n_k // BENCH_KBLOCK),
          f"op sweep launched {launches} kernels, counted {sweep.launches}")
    check(err <= TOL_KERNEL, f"op sweep vs f64 oracle {err:.3e} > {TOL_KERNEL}")
    block_ms, spread_ms = kernel_times(proj, velocities, hi_dev, lo_dev, k_dev, BENCH_KBLOCK)
    alone = check_sweep_wall(sweep.sweep_s * 1e3, block_ms, spread_ms, "op sweep")
    log('bench', f"(a) bench_torch.op_sweep on the working data: {n_k} k in blocks of "
                 f"{BENCH_KBLOCK}, first block {sweep.compile_s:.3f} s, sweep {sweep.sweep_s:.4f} s "
                 f"({n_k / sweep.sweep_s:.1f} k-points/s), {alone}; launches {launches}; "
                 f"{len(cols)} k-columns vs f64 oracle rel err {err:.3e} (tol {TOL_KERNEL})")
    return launches, block_ms


def bench_launches(stderr, what):
    """The launches bench_torch.py logged for ``what`` (summed over its lines)."""
    found = re.findall(rf"kernel launches: {re.escape(what)}.* (\d+)$", stderr, re.M)
    check(found, f"bench_torch.py logged no launches for {what!r}")
    return sum(int(n) for n in found)


def bench_command(env, **knobs):
    """``python3 bench_torch.py`` with the PSA_BENCH_* ``knobs``: CompletedProcess."""
    return subprocess.run([sys.executable, 'bench_torch.py'], cwd=Path(__file__).resolve().parent,
                          env=dict(env, **knobs), capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)


def bench_headline(done, what):
    """The one JSON line of a bench_torch.py run that must have exited 0."""
    check(done.returncode == 0, f"bench_torch.py ({what}) exited {done.returncode}: "
                                f"{done.stderr[-3000:]}")
    lines = done.stdout.splitlines()
    check(len(lines) == 1, f"bench_torch.py ({what}) printed {len(lines)} lines: {done.stdout!r}")
    return json.loads(lines[0])


def bench_runs(smi, tmp):
    """Phase 17b-d: ``python3 bench_torch.py`` as a command: (b) at its
    defaults, user headline included; (c) with PSA_BENCH_KBLOCK=250, stopped
    by SIGTERM once it logged the provisional headline; (d) with the extras
    at PSA_BENCH_STEPS=2000.  Returns (headline, {path: launches}, extras)."""
    env = dict(os.environ, PSA_BENCH_OUT_DIR=tmp)
    n_k = GRID * GRID

    t0 = time.perf_counter()
    done = bench_command(env)
    wall = time.perf_counter() - t0
    line = bench_headline(done, 'defaults')
    user = line['headline_user']
    check(line['value'] > 0 and user['value'] > 0 and line['device'] == smi,
          f"headline {line}")
    launches = {"bench_op_sweep_command": bench_launches(done.stderr, 'op sweep'),
                "bench_user_headline": bench_launches(done.stderr, 'user headline')}
    check(launches["bench_op_sweep_command"] == 1 + -(-n_k // BENCH_KBLOCK)
          and launches["bench_user_headline"] > 0, f"bench launches {launches}")
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    log('bench', f"(b) python3 bench_torch.py: {wall:.2f} s of command; op headline "
                 f"{line['value']:.1f} k-points/s ({n_k / line['value'] * 1e3:.3f} ms), "
                 f"vs_baseline {line['vs_baseline']:.1f}, compile_s "
                 f"{line['compile_s']:.3f}; user headline {user['value']:.1f} k-points/s "
                 f"(first {user['first_s']:.3f} s); launches {launches}")

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, 'bench_torch.py'], cwd=Path(__file__).resolve().parent,
                            env=dict(env, PSA_BENCH_KBLOCK='250'), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    seen = []
    for text in proc.stderr:
        seen.append(text)
        if 'provisional headline' in text:
            proc.send_signal(signal.SIGTERM)
            break
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT)
    finally:
        proc.kill()
    stopped = subprocess.CompletedProcess(proc.args, proc.returncode, out, ''.join(seen) + err)
    early = bench_headline(stopped, 'SIGTERM')
    check('provisional (first block only)' in early['metric'] and early['value'] > 0
          and 'signal 15' in stopped.stderr, f"SIGTERM run printed {early}")
    log('bench', f"(c) SIGTERM after the provisional headline (blocks of 250): exit 0 in "
                 f"{time.perf_counter() - t0:.2f} s, printed {early['value']:.1f} k-points/s, "
                 f"'{early['metric'][-33:]}'")

    t0 = time.perf_counter()
    done = bench_command(env, PSA_BENCH_EXTRAS='1', PSA_BENCH_STEPS=str(BENCH_EXTRAS_STEPS))
    short = bench_headline(done, 'extras')
    with open(Path(tmp) / 'bench_torch_extras' / 'bench_extras.json') as f:
        extras = json.load(f)
    keys = {"calculate_browse_kps", "browse_d2h_reduction", "calculate_browse_f16_kps",
            "browse_f16_speedup", "browse_f16_max_quant_err", "kpath_calculate_kps",
            "peaks_kps", "gridded_browse_kps", "gridded_peaks_kps"}
    check(keys <= set(extras) and extras['failed'] == [], f"extras {extras}")
    launches["bench_extras"] = bench_launches(done.stderr, 'user path')
    check(launches["bench_extras"] > 0, "the extras launched no kernel")
    log('bench', f"(d) PSA_BENCH_EXTRAS=1 at 2,000 steps: {time.perf_counter() - t0:.2f} s of "
                 f"command, op headline {short['value']:.1f} k-points/s; "
                 + ", ".join(f"{k} {extras[k]:.4g}" for k in sorted(keys))
                 + f"; launches {launches['bench_extras']}")
    return line, launches, dict(extras, op_headline_2000_steps=short['value'])


def chunk_entry(path, chunks):
    """A path_chunks_rel_err entry of [((n_t, A, K), rel err), ...]."""
    return {"path": path, "shapes": sorted({shape for shape, _ in chunks}),
            "rel_err": max(err for _, err in chunks)}


def bench_kernel_shapes(dev, proj):
    """Kernel vs plain on bench_torch.py's own inputs, made here as it makes
    them, at every (n_t, A, K) its commands (b) and (d) launched: the op
    sweep and the user headline on the seeded card velocities, the Si sites
    and the 50x50 grid in blocks of 1,280 (the headline's calculator holds
    the sweep's tensors); the extras on the tiled host velocities at 2,000
    steps through the calculator they build, the grid in chunks of 1,280
    and the 250-point k-path.  The kernel alone is timed at (b)'s blocks.
    Returns (path_chunks_rel_err entries, kernel ms per block, spread ms)."""
    import bench_torch
    from psa_tpu_torch import SEDCalculator
    from psa_tpu_torch.ops.spectral import split_f64
    mean64 = bench_torch.si_mean_positions(N_ATOMS)
    k_grid = bench_torch.grid_k_vectors(GRID)
    k_dev = torch.from_numpy(k_grid).to(dev)
    data = torch.randn((N_T, N_ATOMS, 3), generator=torch.Generator(dev).manual_seed(0),
                       device=dev)
    hi, lo = (torch.from_numpy(x).to(dev) for x in split_f64(mean64))
    sweep = chunk_errors(proj, data, hi, lo, k_dev, BENCH_KBLOCK)
    block_ms, spread_ms = kernel_times(proj, data, hi, lo, k_dev, BENCH_KBLOCK)
    del data
    torch.cuda.empty_cache()
    traj = bench_torch.zero_strided_trajectory(
        mean64, BENCH_EXTRAS_STEPS, bench_torch.host_velocities(BENCH_EXTRAS_STEPS, N_ATOMS))
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, max_device_bytes=int(13e9), device=dev)
    data, hi, lo = calc._group_device_arrays(np.arange(N_ATOMS))
    _, k_path = calc.get_k_path('x', bz_coverage=1.0, n_k=250, lat_param=bench_torch.A0)
    k_path = torch.from_numpy(np.ascontiguousarray(k_path, dtype=np.float32)).to(dev)
    extras = (chunk_errors(proj, data, hi, lo, k_dev, 1280)
              + chunk_errors(proj, data, hi, lo, k_path, 1280))
    del data, hi, lo
    calc.clear_device_cache()
    torch.cuda.empty_cache()
    return ([chunk_entry("bench_op_sweep_command/bench_user_headline", sweep),
             chunk_entry("bench_extras", extras)], block_ms, spread_ms)


@contextlib.contextmanager
def recorded_launches(proj):
    """Within the block, the inputs of every call of the projection wrapper
    that launched a kernel, each kept as a clone: a list of (data, mp_hi,
    mp_lo, k, precision).  The wrapper is replaced in every module of the
    port that holds it by name; every kernel the block launches must come
    from a recorded call."""
    import inspect
    import psa_tpu_torch.core.calculator        # noqa: F401  the modules that hold the wrapper
    import psa_tpu_torch.core.streaming         # noqa: F401
    import psa_tpu_torch.parallel.sharded       # noqa: F401
    real = proj.sed_projection
    signature = inspect.signature(real)
    holders = [m for name, m in list(sys.modules.items())
               if name.startswith('psa_tpu_torch') and getattr(m, 'sed_projection', None) is real]
    kept = []

    counted = []

    def recording(*args, **kwargs):
        launched = proj.kernel_launches()
        out = real(*args, **kwargs)
        call = signature.bind(*args, **kwargs)
        call.apply_defaults()
        a = call.arguments
        if proj.kernel_launches() > launched:
            kept.append(tuple(a[n].clone() for n in ('data', 'mp_hi', 'mp_lo', 'k_vectors'))
                        + (a['precision'],))
            counted.append(proj.kernel_launches() - launched)
        return out

    before = proj.kernel_launches()
    for m in holders:
        m.sed_projection = recording
    try:
        yield kept
    finally:
        for m in holders:
            m.sed_projection = real
    check(proj.kernel_launches() - before == sum(counted),
          f"{proj.kernel_launches() - before} launches, {sum(counted)} in the {len(kept)} "
          f"recorded calls")


def recorded_errors(proj, kept, path):
    """Kernel vs plain on the inputs of every recorded launch, each held to
    its tier's tolerance: the path_chunks_rel_err entry of ``path``."""
    worst = {}
    for data, hi, lo, kv, precision in kept:
        err_abs, scale = pair_err(proj.sed_projection(data, hi, lo, kv, precision=precision),
                                  proj.sed_projection_plain(data, hi, lo, kv, precision=precision))
        err = err_abs / scale if scale else err_abs
        shape = (data.shape[0], data.shape[1], len(kv))
        check(err <= TOL_TIERS[precision],
              f"{path}: kernel vs plain at {shape} ({precision}) {err:.3e} > {TOL_TIERS[precision]}")
        worst[shape] = max(worst.get(shape, 0.0), err)
    return {"path": path, "shapes": sorted(worst), "launches": len(kept),
            "rel_err": max(worst.values(), default=0.0)}


def run_examples(dev, proj, tmp):
    """Phase 17e: each example's ``main(device=...)`` in this process, its
    printed checks bounded by the example itself (it raises on a miss), its
    launches counted, each launch held to the plain version on its own
    inputs; then the same ``main(device='cpu')``, whose printed checks the
    card's must equal to the place each number is printed to (the rule the
    tests hold the port's examples to the JAX scripts by).  The
    figures-only example runs where matplotlib is installed.  Returns
    ({example_<name>: launches}, path_chunks_rel_err entries)."""
    import importlib
    import importlib.util
    import io
    from psa_tpu_torch.utils import profiling
    from psa_tpu_torch.visualization import have_matplotlib
    # by path: a machine may have another top-level package named ``tests``
    spec = importlib.util.spec_from_file_location(
        'torch_examples_harness',
        Path(__file__).resolve().parent / 'tests' / 'torch_examples_harness.py')
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    launches, entries = {}, []
    for name in EXAMPLES:
        if name == 'visualization_example' and not have_matplotlib():
            log('examples', f"{name}: not run (figures only; matplotlib is not installed)")
            continue
        module = importlib.import_module(f'examples_torch.{name}')
        card, cpu = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        before = profiling.snapshot()
        with recorded_launches(proj) as kept, contextlib.redirect_stdout(card):
            module.main(device=str(dev), out_dir=f"{tmp}/{name}")
        card_s = time.perf_counter() - t0
        launches[f"example_{name}"] = len(kept)
        check((len(kept) > 0) == (name in PROJECTING), f"{name} launched {len(kept)} kernels")
        # every 'exact' mode stack on the card through the fused kernel, which launched iff any
        phasor = phasor_counts(profiling.counted_since(before))
        check(phasor[1] == phasor[2] and (phasor[0] > 0) == (phasor[2] > 0),
              f"{name}: fused mode-stack (launches, fused, exact elements) {phasor}")
        launches[f"example_{name}_phasor_modes"] = phasor[0]
        if kept:
            entries.append(recorded_errors(proj, kept, f"example_{name}"))
        del kept
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(cpu):
            module.main(device='cpu', out_dir=f"{tmp}/{name}_cpu")
        try:
            harness.assert_same_checks(re.sub(r'\bcuda(:\d+)?\b', 'cpu', card.getvalue()),
                                       cpu.getvalue())
        except AssertionError as e:
            check(False, f"{name}: the card's printed checks differ from the CPU's: {e}")
        checks = [ln.strip() for ln in card.getvalue().splitlines() if ln.strip()]
        log('examples', f"{name}: {card_s:.2f} s, launches {launches[f'example_{name}']}"
                        f" (fused mode-stack {phasor[0]})"
                        + (f" (vs plain on their inputs: rel err {entries[-1]['rel_err']:.3e})"
                           if name in PROJECTING else "")
                        + f"; the CPU's run {time.perf_counter() - t0:.2f} s printed the same "
                        "checks; " + " | ".join(checks))
    return launches, entries


def run_graft(dev, proj):
    """Phase 17f: ``graft_entry.entry()`` (the card by default) against its
    CPU path, and ``dryrun_multichip(8)`` with and without its extended tier
    on a virtual mesh of the card; every launch held to the plain version
    on its own inputs.  Returns ({path: launches}, path_chunks_rel_err
    entries)."""
    from psa_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    check(all(a.is_cuda for a in args), "entry() put its tensors off the card")
    with recorded_launches(proj) as kept:
        got = fn(*args)
        torch.cuda.synchronize()
    launches = {"graft_entry": len(kept)}
    entries = [recorded_errors(proj, kept, "graft_entry")]
    fn_cpu, args_cpu = graft_entry.entry('cpu')
    err = rel(got.cpu(), fn_cpu(*args_cpu))
    check(got.dtype == torch.complex64 and err <= TOL_KERNEL,
          f"entry() on the card vs the CPU {err:.3e} > {TOL_KERNEL}")
    walls = {}
    for full in (False, True):
        key = "graft_dryrun_full" if full else "graft_dryrun"
        t0 = time.perf_counter()
        with recorded_launches(proj) as kept:
            graft_entry.dryrun_multichip(8, full=full)
        walls[key] = time.perf_counter() - t0
        launches[key] = len(kept)
        entries.append(recorded_errors(proj, kept, key))
    del kept
    check(all(n > 0 for n in launches.values()), f"graft launches {launches}")
    log('graft', f"entry() {tuple(got.shape)} complex64 on {dev} vs the CPU path rel err "
                 f"{err:.3e} (tol {TOL_KERNEL}); dryrun_multichip(8) {walls['graft_dryrun']:.2f} s, "
                 f"full tier {walls['graft_dryrun_full']:.2f} s on a virtual mesh of {dev}; "
                 f"launches {launches}; every launch vs plain on its inputs: "
                 + ", ".join(f"{e['path']} {e['rel_err']:.3e}" for e in entries))
    return launches, entries


def bench_phase(dev, proj, smi):
    """Phase 17b-f: bench_torch.py as three commands, the kernel against
    its plain version on their inputs, the examples and the graft entry.
    Returns (the headline, {path: launches}, the extras, path_chunks_rel_err
    entries)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        line, launches, extras = bench_runs(smi, tmp)
        entries, block_ms, spread_ms = bench_kernel_shapes(dev, proj)
        sweep_ms = GRID * GRID / line['value'] * 1e3
        alone = check_sweep_wall(sweep_ms, block_ms, spread_ms, "the bench's op sweep")
        log('bench', f"(b) the bench's op sweep {sweep_ms:.3f} ms, {alone}, on its inputs; "
                     "kernel vs plain on the commands' inputs: "
                     + ", ".join(f"{e['path']} {e['shapes']} {e['rel_err']:.3e}" for e in entries)
                     + f" (tol {TOL_KERNEL})")
        example_launches, example_entries = run_examples(dev, proj, tmp)
    graft_launches, graft_entries = run_graft(dev, proj)
    log('bench', f"bench phase (b-f) took {time.perf_counter() - t0:.2f} s")
    return (line, {**launches, **example_launches, **graft_launches}, extras,
            entries + example_entries + graft_entries)


def host_allocations(dev, n_bytes):
    """Median ms over HOST_TRIALS, at ``n_bytes``, of a fresh pinned block
    (``cudaHostAlloc``: blocks are kept until the cache has none free and
    makes new ones), a block the cache hands back, a fresh ``np.zeros`` filled from a
    warm array (its pages fault on first touch), the same fill into a reused
    array, and the DtoH copy into a warm pinned block."""
    src = np.ones(n_bytes, np.uint8)
    kept, fresh, cached, faulted, reused = [], [], [], [], []
    while len(fresh) < HOST_TRIALS:     # past the blocks the cache has free
        n_alloc = torch.cuda.host_memory_stats()['num_host_alloc']
        t0 = time.perf_counter()
        kept.append(torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True))
        if torch.cuda.host_memory_stats()['num_host_alloc'] > n_alloc:
            fresh.append(time.perf_counter() - t0)
    del kept[:]
    for _ in range(HOST_TRIALS):
        t0 = time.perf_counter()
        block = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
        cached.append(time.perf_counter() - t0)
        del block
    for _ in range(HOST_TRIALS):
        t0 = time.perf_counter()
        arr = np.zeros(n_bytes, np.uint8)
        arr[...] = src
        faulted.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        arr[...] = src
        reused.append(time.perf_counter() - t0)
        del arr
    on_dev = torch.ones(n_bytes, dtype=torch.uint8, device=dev)
    block = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    dtoh = cuda_ms(lambda: block.copy_(on_dev, non_blocking=True), HOST_TRIALS)
    ms = lambda xs: float(np.median(xs)) * 1e3   # noqa: E731
    return {"bytes": n_bytes, "pinned_fresh_ms": ms(fresh), "pinned_cached_ms": ms(cached),
            "zeros_fill_ms": ms(faulted), "reused_fill_ms": ms(reused), "dtoh_pinned_ms": dtoh}


def pinned_result(dev, calc):
    """Phase 18: ``calculate``'s pinned host result at the click's shape."""
    from psa_tpu_torch.core import calculator
    from psa_tpu_torch.utils import profiling
    mags, k = calc.get_k_path('x', KPATH_COVERAGE, KPATH_K, SI_A0)

    def click(pinned, **kw):
        cap = calculator.PINNED_RESULT_BYTES
        calculator.PINNED_RESULT_BYTES = cap if pinned else 0
        try:
            before, t0 = profiling.snapshot(), time.perf_counter()
            phi = calc.calculate(mags, k, **kw).sed
            return phi, time.perf_counter() - t0, profiling.counted_since(before)
        finally:
            calculator.PINNED_RESULT_BYTES = cap

    for chunk in (None, KPATH_CHUNK):
        kw = {} if chunk is None else {'k_chunk_size': chunk}
        (new, _, moved), (old, _, moved_old) = click(True, **kw), click(False, **kw)
        direct = moved.get('readback.direct_bytes', 0)
        check(torch.from_numpy(new).is_pinned() and not torch.from_numpy(old).is_pinned(),
              "the pinned path's result is not pinned, or the staging path's is")
        check(np.array_equal(new, old), f"pinned and staging Φ differ ({kw})")
        check(direct == (new.nbytes if chunk is None else 0)
              and moved_old.get('readback.direct_bytes', 0) == 0,
              f"readback.direct_bytes {direct} of {new.nbytes} bytes ({kw})")
        log('pinned', f"{N_ATOMS} atoms x {N_T} steps x {KPATH_K} k, "
                      f"{'one chunk' if chunk is None else f'chunks of {chunk}'}: Φ {new.shape} "
                      f"pinned, bit for bit the staging path's; readback.direct_bytes {direct}, "
                      f"dtoh_bytes {moved.get('dtoh_bytes', 0)}")
        del new, old

    walls = {True: [], False: []}
    for _ in range(KPATH_ROUNDS):
        for pinned in (True, False, False, True):
            walls[pinned].append(click(pinned)[1])
    log('pinned', f"one-chunk click walls over {KPATH_ROUNDS} rounds in turns: pinned median "
                  f"{np.median(walls[True]) * 1e3:.3f} ms (min {min(walls[True]) * 1e3:.3f}, max "
                  f"{max(walls[True]) * 1e3:.3f}), staging median {np.median(walls[False]) * 1e3:.3f} "
                  f"ms (min {min(walls[False]) * 1e3:.3f}, max {max(walls[False]) * 1e3:.3f})")

    # a chunk of the three-chunk path into its (strided) slice of a warm pinned Φ:
    # a staging block, then the host's copy, against torch's strided DtoH copy.
    # Each is timed whole on an idle card, and by when it hands the host back
    # after ~0.1 s of queued work (the pipeline enqueues the next chunk then).
    out = torch.empty((N_T, KPATH_CHUNK, 3), dtype=torch.complex64, device=dev)
    full = torch.empty((N_T, KPATH_K, 3), dtype=torch.complex64, pin_memory=True)
    full_np, busy = full.numpy(), torch.randn((8192, 8192), device=dev)

    def staged():
        block = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        block.copy_(out, non_blocking=True)
        return lambda: (torch.cuda.synchronize(),
                        full_np.__setitem__(np.s_[:, :KPATH_CHUNK], block.numpy()))

    def strided():
        full[:, :KPATH_CHUNK].copy_(out, non_blocking=True)
        return torch.cuda.synchronize

    whole, handed = {staged: [], strided: []}, {staged: [], strided: []}
    right = {staged: True, strided: True}
    for r in range(KPATH_ROUNDS):
        for fn in (staged, strided, strided, staged):
            for _ in range(4):
                busy @ busy
            out.fill_(r + 1)
            t0 = time.perf_counter()
            finish = fn()
            handed[fn].append(time.perf_counter() - t0)
            finish()
            right[fn] &= bool((full_np[:, :KPATH_CHUNK] == r + 1).all())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()()
            whole[fn].append(time.perf_counter() - t0)
    check(right[staged], "a chunk's slice of Φ differs after the staging copy")
    ms = lambda xs: f"{np.median(xs) * 1e3:.3f} ms"   # noqa: E731
    log('pinned', f"a ({N_T}, {KPATH_CHUNK}, 3) complex64 chunk into its slice of a warm pinned "
                  f"Φ, medians: staging block + host copy {ms(whole[staged])} whole, host handed "
                  f"back after {ms(handed[staged])} behind queued work, values right "
                  f"{right[staged]}; torch's strided copy_ {ms(whole[strided])} whole, "
                  f"{ms(handed[strided])} behind queued work, values right {right[strided]}")
    del out, full, full_np, busy

    stats = torch.cuda.host_memory_stats()
    log('pinned', "pinned cache after the clicks " + json.dumps(
        {key: stats.get(key) for key in ('allocations.current', 'allocated_bytes.current',
                                          'num_host_alloc', 'host_alloc_time.total')}))
    for n_bytes in HOST_SIZES:
        log('pinned', "host allocation " + json.dumps(host_allocations(dev, n_bytes)))
    getattr(torch._C, '_host_emptyCache', lambda: None)()   # the timings' blocks, where torch can


def cluster_edges(proj, gen, rng, dev32):
    """Phase 3c: the 'parity' kernel's clusters at their edges, on the card.
    A block multiplies its own time tile by its k-tile's angle tile, which
    the blocks of its cluster make in shares, so any prefix of the time
    steps (n_t of CLUSTER_NT: one step, a whole tile, a tile and a step, an
    odd count of tiles whose cluster holds a padded tile) and of the
    k-points (CLUSTER_NK) gives the bits of the same rows and columns of the
    whole call; each case is also held to the plain version.  At aligned
    and unaligned rows (CLUSTER_ATOMS).  Then ``accumulate`` on a non-zero
    ``out`` (its bits are the plain add of the kernel's own sum) and an
    ``out=`` row slice (the whole call's bits, the rows around it kept).
    Returns the largest error against the plain version per case."""
    from psa_tpu_torch.ops.spectral import split_f64
    dev = gen.device
    errs = {}
    for n_a in CLUSTER_ATOMS:
        hi, lo = split_f64(rng.uniform(0, 50.0, size=(n_a, 3)))
        data = torch.randn((CLUSTER_T, n_a, 3), generator=gen, device=dev)
        hi, lo = dev32(hi), dev32(lo)
        kv = dev32(rng.uniform(-3, 3, size=(max(CLUSTER_NK), 3)))
        whole = proj.sed_projection(data, hi, lo, kv)
        for n_t in CLUSTER_NT:
            for n_k in CLUSTER_NK:
                args = (data[:n_t], hi, lo, kv[:n_k])
                got = proj.sed_projection(*args)
                e, scale = pair_err(got, proj.sed_projection_plain(*args))
                same = all(torch.equal(g, w[:n_t, :, :n_k]) for g, w in zip(got, whole))
                errs[f"A{n_a}_t{n_t}_k{n_k}"] = e / scale
                check(same and e / scale <= TOL_KERNEL,
                      f"(n_t,A,K)=({n_t},{n_a},{n_k}): the whole call's bits {same}, "
                      f"vs plain {e / scale:.3e}")
        args = (data[:65], hi, lo, kv[:33])
        got = proj.sed_projection(*args)
        base = [torch.randn((65, 3, 33), generator=gen, device=dev) for _ in range(2)]
        acc = proj.sed_projection(*args, out=[b.clone() for b in base], accumulate=True)
        e, scale = pair_err(acc, proj.sed_projection_plain(*args, out=[b.clone() for b in base],
                                                           accumulate=True))
        same = all(torch.equal(a, b + g) for a, b, g in zip(acc, base, got))
        errs[f"A{n_a}_accumulate"] = e / scale
        check(same and e / scale <= TOL_KERNEL,
              f"accumulate at (65,{n_a},33): the kernel's sum added {same}, vs plain {e / scale:.3e}")
        sig = [torch.full((129 + 40, 3, 33), 7.0, device=dev) for _ in range(2)]
        rows = [x[20:20 + 129] for x in sig]
        proj.sed_projection(data[:129], hi, lo, kv[:33], out=rows)
        same = all(torch.equal(r, w[:129, :, :33]) for r, w in zip(rows, whole))
        kept = all(bool((x[:20] == 7.0).all() and (x[20 + 129:] == 7.0).all()) for x in sig)
        check(same and kept, f"out= row slice at (129,{n_a},33): whole call's bits {same}, "
                             f"rows around it kept {kept}")
        del data, whole
    return errs


def phase3c_alone():
    """``python3 chip_smoke.py --phase 3c``: the build (ptxas's counts and the
    clusters the card holds at once), then phase 3c."""
    from psa_tpu_torch import _build
    from psa_tpu_torch.ops import sed_projection as proj
    t_start = time.perf_counter()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    _build.build()
    lib = _build.load()
    log('build', f"sed_projection_kernel: {ptxas_by_kernel(_build.build_log)['sed_projection_kernel']}"
                 f", {lib.psa_sed_projection_smem_bytes()} bytes of dynamic shared memory, "
                 f"{lib.psa_sed_projection_active_clusters()} clusters of "
                 f"{proj.PARITY_CLUSTER} at once")
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def dev32(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    errs = cluster_edges(proj, gen, rng, dev32)
    log('cluster', f"{len(errs)} cases, each the whole call's bits; largest vs plain "
                   f"{max(errs.values()):.3e} (tol {TOL_KERNEL})")
    log('done', f"phase 3c took {time.perf_counter() - t_start:.1f} s")


def phase11d_alone():
    """``python3 chip_smoke.py --phase 11d``: the build (ptxas's counts of the
    fused mode-stack kernels), then phase 11d on 32,000 thermal Si atoms made
    on the card; prints its ``kernels`` entry."""
    from psa_tpu_torch import _build
    t_start = time.perf_counter()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    _build.build()
    ptxas = ptxas_by_kernel(_build.build_log)
    entry = modes_at_cell_shape(*modes_cell_data(torch.device('cuda')))
    entry["ptxas"] = {n: ptxas.get(n) for n in MODES_KERNELS}
    print(json.dumps({"kernels": [entry]}), flush=True)
    log('done', f"phase 11d took {time.perf_counter() - t_start:.1f} s")


def phase18_alone():
    """``python3 chip_smoke.py --phase 18``: the build, the working velocities
    preloaded into the working calculator, then phase 18."""
    from psa_tpu_torch import _build
    from psa_tpu_torch.ops.spectral import split_f64
    t_start = time.perf_counter()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    _build.build()
    _build.load()
    dev = torch.device('cuda')
    velocities = torch.randn((N_T, N_ATOMS, 3), generator=torch.Generator(dev).manual_seed(SEED),
                             device=dev)
    calc, _, _ = working_calculator(dev)
    hi, lo = (torch.from_numpy(x).to(dev) for x in split_f64(calc.mean_positions64))
    calc.preload_device_group_data(velocities, hi, lo)
    pinned_result(dev, calc)
    log('done', f"phase 18 took {time.perf_counter() - t_start:.1f} s")


def phase17_alone():
    """``python3 chip_smoke.py --phase 17``: phase 17 by itself, as the
    whole script runs it (the build, the working velocities and the oracle
    columns of phase 5, then 17a-f), for a change to bench_torch.py, the
    examples or the graft entry.  Prints the launches and the
    path_chunks_rel_err entries as one JSON line."""
    from psa_tpu_torch import _build
    from psa_tpu_torch.ops import sed_projection as proj
    from psa_tpu_torch.ops.spectral import split_f64
    t_start = time.perf_counter()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.build()
    _build.load()
    dev = torch.device('cuda')
    velocities = torch.randn((N_T, N_ATOMS, 3), generator=torch.Generator(dev).manual_seed(SEED),
                             device=dev)
    calc, k_vecs, _ = working_calculator(dev)
    mean64 = calc.mean_positions64
    hi, lo = (torch.from_numpy(x).to(dev) for x in split_f64(mean64))
    cols = np.array([0, 777, 1250, len(k_vecs) - 1])
    oracle = f64_oracle(velocities, torch.from_numpy(mean64).to(dev),
                        torch.from_numpy(k_vecs[cols].astype(np.float64)).to(dev))
    sweep_launches, block_ms = bench_sweep(proj, velocities, hi, lo, k_vecs, oracle, cols)
    del velocities, oracle, calc, hi, lo
    torch.cuda.empty_cache()
    line, launches, extras, entries = bench_phase(dev, proj, smi)
    log('done', f"phase 17 took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"launches_per_path": {"bench_op_sweep": sweep_launches, **launches},
                      "kernel_ms_per_block": block_ms, "path_chunks_rel_err": entries}),
          flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA GPU")
    from psa_tpu_torch import SEDCalculator, _build
    from psa_tpu_torch.models import (make_chain_trajectory, make_chiral_chain_trajectory,
                                      make_random_crystal_trajectory)
    from psa_tpu_torch.ops import sed_projection as proj
    from psa_tpu_torch.ops.spectral import split_f64

    dev = torch.device('cuda')
    t_start = time.perf_counter()

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, "allow_tf32 must be False")
    check(torch.get_float32_matmul_precision() == 'highest',
          "float32 matmul precision must be 'highest'")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log('device', f"{kind} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  "fp32 matmul 'highest', tf32 off")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()   # from the checkout's sources, whatever _build/ holds
    lib = _build.load()
    ptxas = ptxas_by_kernel(_build.build_log)
    ptxas_info = ptxas.get('sed_projection_kernel', {"registers": None})
    ptxas_info["smem_dynamic_bytes"] = lib.psa_sed_projection_smem_bytes()
    for name, counts in ptxas.items():
        if name.startswith('tier_product_kernel'):
            counts["smem_dynamic_bytes"] = lib.psa_sed_tier_product_smem_bytes()
    log('build', f"{_build.LIB_PATH.name} ready in {time.perf_counter() - t0:.2f} s "
                 f"(nvcc {_build.build_seconds} s, one process per source); ptxas: "
                 + " | ".join(f"{name}: {c['registers']} registers, spills {c['spill_stores_bytes']}"
                              f"/{c['spill_loads_bytes']} bytes" for name, c in ptxas.items()))
    want_kernels = ({'sed_projection_kernel', *MODES_KERNELS}
                    | {f'tier_{stage}_kernel<{proj.TIERS[tier]}>' for stage in ('table', 'product')
                       for tier in TABLE_TIERS})
    check(ptxas_info["registers"] is not None and set(ptxas) == want_kernels,
          f"ptxas counts of {sorted(want_kernels)} expected, got {sorted(ptxas)}")

    # -- 3. kernel against its plain version ------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def dev32(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    for n_t, n_a, n_k in ((9, 1000, 77), (197, 5003, 201)):   # remainders on every axis
        hi, lo = split_f64(rng.uniform(0, 50.0, size=(n_a, 3)))
        small = (torch.randn((n_t, n_a, 3), generator=gen, device=dev), dev32(hi), dev32(lo),
                 dev32(rng.uniform(-3, 3, size=(n_k, 3))))
        err_abs, err_rel, ms_k, ms_p = compare_kernel(proj, *small, reps=20)
        check(err_rel <= TOL_KERNEL, f"ragged kernel vs plain {err_rel:.3e} > {TOL_KERNEL}")
        log('kernel', f"ragged (n_t,A,K)=({n_t},{n_a},{n_k}): rel err {err_rel:.3e} "
                      f"(tol {TOL_KERNEL}); kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    view = small[0][1:]   # time steps of 3*5003 floats: this view starts off a 16-byte boundary
    err_abs, err_rel, _, _ = compare_kernel(proj, view, *small[1:], reps=1)
    check(view.data_ptr() % 16 and err_rel <= TOL_KERNEL, f"unaligned view vs plain {err_rel:.3e}")
    log('kernel', f"unaligned view (n_t,A,K)=({view.shape[0]},{n_a},{n_k}): rel err {err_rel:.3e}")
    cluster_errs = cluster_edges(proj, gen, rng, dev32)
    log('cluster', f"{len(cluster_errs)} cases, each the whole call's bits; largest vs plain "
                   f"{max(cluster_errs.values()):.3e} (tol {TOL_KERNEL}); "
                   f"{lib.psa_sed_projection_active_clusters()} clusters of "
                   f"{proj.PARITY_CLUSTER} at once")

    t0 = time.perf_counter()
    velocities = torch.randn((N_T, N_ATOMS, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    log('kernel', f"generated {N_T}x{N_ATOMS}x3 float32 velocities on the card "
                  f"({velocities.numel() * 4 / 1e9:.1f} GB) in {time.perf_counter() - t0:.2f} s")
    calc, k_vecs, grid_shape = working_calculator(dev)
    t0 = time.perf_counter()
    mean64 = calc.mean_positions64
    hi, lo = split_f64(mean64)
    hi_dev, lo_dev = dev32(hi), dev32(lo)
    log('kernel', f"mean positions of the {N_T}x{N_ATOMS} frames in "
                  f"{time.perf_counter() - t0:.2f} s")
    work = (velocities, hi_dev, lo_dev, dev32(k_vecs[:K_CHUNK]))
    kern = proj.sed_projection(*work)
    again = proj.sed_projection(*work)
    plain = proj.sed_projection_plain(*work)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(kern, again))
    del again
    check(same_bits, "two kernel runs at the working chunk differ")
    work_abs, work_scale = pair_err(kern, plain)
    work_rel = work_abs / work_scale
    check(work_rel <= TOL_KERNEL, f"working-shape kernel vs plain {work_rel:.3e} > {TOL_KERNEL}")
    kern_f64, plain_f64 = same_operand_errors(proj, *work, kern, plain)
    del kern, plain
    check(kern_f64 <= TOL_SAME_OPERANDS,
          f"kernel vs f64 sum of its operands {kern_f64:.3e} > {TOL_SAME_OPERANDS}")
    log('kernel', f"working chunk, first 8 k-columns vs a float64 sum of the same float32 "
                  f"operands: kernel {kern_f64:.3e} (tol {TOL_SAME_OPERANDS}), plain {plain_f64:.3e}; "
                  f"two kernel runs bitwise identical")
    out_errs = out_accumulate_checks(proj, gen, rng, dev32, *work)
    log('kernel', "out= and accumulate= vs the plain version's same call: "
                  + ", ".join(f"{k} rel err {v:.3e}" for k, v in out_errs.items())
                  + f" (tol {TOL_KERNEL}; the halves at (n_t,A,K)=({N_T},{N_ATOMS // 2},{K_CHUNK}))")
    work_ms, work_plain_ms = time_kernel(proj, *work, reps=2)
    del work
    flop = 4.0 * N_T * 3 * N_ATOMS * K_CHUNK
    log('kernel', f"working chunk (n_t,A,K)=({N_T},{N_ATOMS},{K_CHUNK}): rel err {work_rel:.3e}, "
                  f"max abs err {work_abs:.3e} (tol {TOL_KERNEL}); kernel {work_ms:.3f} ms "
                  f"({flop / work_ms / 1e9:.2f} TFLOP/s), plain {work_plain_ms:.3f} ms "
                  f"({flop / work_plain_ms / 1e9:.2f} TFLOP/s)")

    # -- 4. physics: chain dispersion -------------------------------------
    nu_max, a, n_cells = 10.0, 2.5, 32
    chain = make_chain_trajectory(n_cells=n_cells, n_frames=256, dt_ps=0.02, a=a,
                                  omega_max_thz=nu_max, seed=0)
    ccalc = SEDCalculator(chain, nx=n_cells, ny=1, nz=1, device=dev)
    k_mags, k_path = ccalc.get_k_path('x', bz_coverage=0.5, n_k=n_cells // 2 + 1)
    proj.counters['launch.parity'] = 0
    sed = ccalc.calculate(k_mags, k_path)
    pos = sed.freqs >= 0
    peaks = sed.freqs[pos][np.argmax(sed.intensity[pos], axis=0)]
    miss = float(np.max(np.abs(peaks[1:] - nu_max * np.abs(np.sin(k_mags[1:] * a / 2)))))
    df = 1.0 / (chain.n_frames * chain.dt_ps)
    check(proj.counters['launch.parity'] > 0, "chain calculate launched no kernel")
    check(miss <= df + 1e-6, f"chain peaks off the analytic curve by {miss} THz > {df}")
    log('physics', f"chain peaks on nu = {nu_max}|sin(ka/2)|: max miss {miss:.4f} THz "
                   f"<= resolution {df:.4f} THz; launches {proj.counters['launch.parity']}")

    # -- 5. main path at the working size ---------------------------------
    calc.preload_device_group_data(velocities, hi_dev, lo_dev)
    torch.cuda.reset_peak_memory_stats()
    proj.counters['launch.parity'] = 0
    t0 = time.perf_counter()
    sed = calc.calculate(np.array([], np.float32), k_vecs, summation_mode='coherent',
                         k_grid_shape=grid_shape)
    wall = time.perf_counter() - t0
    main_launches = proj.counters['launch.parity']
    n_k = len(k_vecs)
    check(main_launches > 0, "the working-size calculate launched no projection kernel")
    check(sed.sed.shape == (N_T, n_k, 3), f"SED shape {sed.sed.shape}")
    check(bool(np.isfinite(sed.sed).all()), "non-finite SED values")
    cols = np.array([0, 777, 1250, n_k - 1])
    oracle = f64_oracle(velocities, torch.from_numpy(mean64).to(dev),
                        torch.from_numpy(k_vecs[cols].astype(np.float64)).to(dev))
    got = torch.from_numpy(np.ascontiguousarray(sed.sed[:, cols, :])).to(dev).to(torch.complex128)
    main_err = rel(got, oracle)
    check(main_err <= TOL_KERNEL, f"working-size SED vs f64 oracle {main_err:.3e} > {TOL_KERNEL}")
    log('main', f"calculate: {N_ATOMS} atoms x {N_T} steps x {n_k} k, coherent, parity: "
                f"{wall:.3f} s wall, {n_k / wall:.1f} k-points/s; kernel launches {main_launches}; "
                f"shape {sed.sed.shape} finite; 4 k-columns vs f64 oracle rel err {main_err:.3e} "
                f"(tol {TOL_KERNEL}); peak device memory in calculate "
                f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    resident_sed = sed.sed
    del sed, got

    # -- 18. calculate's pinned host result at the click's shape -------------
    t0 = time.perf_counter()
    pinned_result(dev, calc)
    log('pinned', f"pinned-result phase took {time.perf_counter() - t0:.2f} s")

    # -- 5b/5c. on-device grid reductions ----------------------------------
    t0 = time.perf_counter()
    peaks_launches, browse_launches, big_chunks, resident_peaks = grid_working_size(
        calc, proj, (velocities, hi_dev, lo_dev), k_vecs, oracle, cols, calc.dt_ps)
    lt_launches, welch_launches, small_chunks = grid_small_sizes(dev, proj, chain, ccalc,
                                                                 nu_max, a)
    log('grid', f"grid phases took {time.perf_counter() - t0:.2f} s")

    # -- 5e. the gridded (NUFFT) engine ------------------------------------
    t0 = time.perf_counter()
    gridded_peaks, gridded_launches = gridded_working_size(calc, proj, k_vecs, grid_shape, oracle, cols,
                                            resident_sed)
    log('gridded', f"gridded phase took {time.perf_counter() - t0:.2f} s")

    # -- 17a. bench_torch's op sweep on the working data ----------------------
    t0 = time.perf_counter()
    bench_sweep_launches, bench_block_ms = bench_sweep(proj, velocities, hi_dev, lo_dev, k_vecs,
                                                       oracle, cols)
    log('bench', f"bench phase (a) took {time.perf_counter() - t0:.2f} s")

    # -- 5d. the precision tiers -------------------------------------------
    t0 = time.perf_counter()
    tier_info, tier_kernels = tiers(proj, velocities, hi_dev, lo_dev, k_vecs, grid_shape, oracle,
                                    cols, gen, rng, dev32, ptxas)
    log('tiers', f"tier phase took {time.perf_counter() - t0:.2f} s")

    # -- 7/8/9. out of core, resume, from disk ------------------------------
    t0 = time.perf_counter()
    streamed_launches, streamed_peaks_launches, streamed_loop, host_vel = out_of_core(
        velocities, calc, proj, k_vecs, grid_shape, oracle, cols, resident_sed, resident_peaks)
    del resident_sed
    log('ooc', f"out-of-core phase took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    gridded_launches["kgrid_peaks_gridded_streamed"] = gridded_streamed(
        dev, proj, host_vel, k_vecs, grid_shape, gridded_peaks)
    log('gridded', f"streamed gridded phase took {time.perf_counter() - t0:.2f} s")

    # -- 16a/b. the mesh sweeps on the working size -----------------------------
    t0 = time.perf_counter()
    mesh_group, mesh_launches, mesh_shapes = mesh_grid(dev, proj, calc, host_vel, k_vecs,
                                                       grid_shape, oracle, cols)
    log('mesh', f"mesh phase (a, b) took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rerun_launches = resume(calc, proj, k_vecs)
    log('resume', f"resume phase took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dump_launches, dump_loop = from_disk(dev, proj, k_vecs)
    log('disk', f"from-disk phase took {time.perf_counter() - t0:.2f} s")
    del oracle
    calc.clear_device_cache()
    torch.cuda.empty_cache()

    # -- 10/11. NPT and the instantaneous-phase family ----------------------
    host_pos = np.empty_like(host_vel)
    t0 = time.perf_counter()
    npt_peaks_launches, npt_launches, npt_chunks = npt_working_size(dev, proj, velocities,
                                                                    host_vel, host_pos)
    npt_chain_launches = npt_small(dev, proj)
    log('npt', f"NPT phase took {time.perf_counter() - t0:.2f} s")
    del velocities
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dsf_info, thermal, side = dsf_working_size(dev, proj, host_vel, host_pos)
    dsf_small(dev)
    log('dsf', f"instantaneous-phase phase took {time.perf_counter() - t0:.2f} s")

    # -- 12/13/14. time correlation, g(r), the command line ------------------
    t0 = time.perf_counter()
    timecorr_working_size(dev, proj, thermal, side)
    timecorr_small(dev)
    log('timecorr', f"time-correlation phase took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rdf_working_size(dev, proj, thermal, side)
    rdf_small(dev)
    log('rdf', f"g(r) phase took {time.perf_counter() - t0:.2f} s")

    # -- 16c/d/e. the mesh's other sweeps, two processes, the pod sweep ---------
    t0 = time.perf_counter()
    rest_launches, rest_shapes = mesh_rest(dev, proj, mesh_group, thermal, side, k_vecs)
    mesh_launches.update(rest_launches)
    mesh_shapes += rest_shapes
    log('mesh', f"mesh phase (c, d, e) took {time.perf_counter() - t0:.2f} s")
    del host_pos, host_vel, thermal
    mesh_launches.update(mesh_cards(proj))
    t0 = time.perf_counter()
    cli_launches, cli_loop = command_line(dev, proj)
    log('cli', f"command-line phase took {time.perf_counter() - t0:.2f} s")

    # -- 15. an interactive session through the headless controller ----------
    t0 = time.perf_counter()
    session_launches, session_loop = session(dev, proj)
    log('session', f"session phase took {time.perf_counter() - t0:.2f} s")

    # -- 17b-f. bench_torch.py as a command, the examples, the graft entry ---
    torch.cuda.empty_cache()
    bench_line, bench_path_launches, bench_extras, bench_entries = bench_phase(dev, proj, smi)

    # -- 6. the rest of the slice -----------------------------------------
    crystal = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 6), basis=2, n_frames=256,
                                             seed=SEED, n_types=2)
    xcalc = SEDCalculator(crystal, nx=6, ny=6, nz=6, device=dev)
    k_mags, k_path = xcalc.get_k_path('x', bz_coverage=1.0, n_k=33)
    proj.counters['launch.parity'] = 0
    inc = xcalc.calculate(k_mags, k_path, basis_atom_types=[1, 2], summation_mode='incoherent',
                          k_chunk_size=16)
    mean = crystal.positions.astype(np.float64).mean(axis=0)
    want = 0.0
    for typ in (1, 2):
        idx = np.where(crystal.types == typ)[0]
        ph = np.exp(1j * (k_path.astype(np.float64) @ mean[idx].T))
        spec = np.fft.fft(np.einsum('tac,ka->tkc', crystal.velocities[:, idx].astype(np.float64),
                                    ph), axis=0) / crystal.n_frames
        want = want + np.sum(np.abs(spec) ** 2, axis=-1)
    inc_err = float(np.max(np.abs(inc.sed - want)) / np.max(want))
    check(not inc.is_complex and proj.counters['launch.parity'] > 0, "incoherent run shape/launches")
    check(inc_err < TOL_PARITY, f"incoherent vs f64 oracle {inc_err:.3e}")
    log('slice', f"incoherent, 2 type groups, {crystal.n_atoms} atoms: rel err {inc_err:.3e} "
                 f"(tol {TOL_PARITY}); launches {proj.counters['launch.parity']}")

    chiral = make_chiral_chain_trajectory(n_cells=32, n_frames=250, dt_ps=0.02, a=2.5,
                                          nu_thz=5.0, mode_index=8, handedness=+1, seed=3)
    hcalc = SEDCalculator(chiral, nx=32, ny=1, nz=1, device=dev)
    kv = np.array([[2 * np.pi * 8 / (32 * 2.5), 0.0, 0.0]], dtype=np.float32)
    proj.counters['launch.parity'] = 0
    csed = hcalc.calculate(np.linalg.norm(kv, axis=1), kv)
    phase = hcalc.calculate_chiral_phase(csed.sed[:, :, 1], csed.sed[:, :, 2], angle_range_opt='C')
    pos = csed.freqs >= 0
    row = int(np.argmax(csed.intensity[pos][:, 0]))
    got_phase = float(phase[pos][row, 0])
    check(proj.counters['launch.parity'] > 0, "chiral run launched no kernel")
    check(abs(got_phase - np.pi / 2) < 0.05, f"chiral phase {got_phase} != pi/2")
    log('slice', f"chiral phase (option C) at the mode peak {csed.freqs[pos][row]:.3f} THz: "
                 f"{got_phase:.5f} rad (expect pi/2 = {np.pi / 2:.5f}); launches {proj.counters['launch.parity']}")

    ichain = make_chain_trajectory(n_cells=16, n_frames=64, dt_ps=0.05)
    icalc = SEDCalculator(ichain, nx=16, ny=1, nz=1, device=dev)
    proj.counters['launch.parity'] = 0
    with tempfile.TemporaryDirectory() as tmp:
        dump = f"{tmp}/recon.dump"
        icalc.ised(k_dir_spec='x', k_target=0.6, w_target=5.0, char_len_k_path=2.5,
                   nk_on_path=20, rescale_factor='auto', n_recon_frames=10, dump_filepath=dump)
        with open(dump) as f:
            n_frames = f.read().count("ITEM: TIMESTEP")
    check(n_frames == 10 and proj.counters['launch.parity'] > 0, f"iSED dump frames {n_frames}")
    log('slice', f"iSED dump: {n_frames} frames of {ichain.n_atoms} atoms; launches {proj.counters['launch.parity']}")

    # Least time for the working chunk: the function's products (2 (3 n_t)
    # (2K) A flop) at the dense TF32 peak, the card's fastest float32-input
    # rate, or its bytes (the data once, positions, k, both outputs) at the
    # HBM rate.  The 3xTF32 design does three such products: design_bound_ms.
    bytes_moved = 4.0 * (3 * N_T * N_ATOMS + 6 * N_ATOMS + 3 * K_CHUNK + 2 * 3 * N_T * K_CHUNK)
    bound = {"operations": flop / TF32_PEAK * 1e3, "bytes": bytes_moved / HBM_RATE * 1e3}
    bound_by = max(bound, key=bound.get)
    log('done', f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "sed_projection", "route": "cuda", "design": DESIGN,
        "source": "psa_tpu_torch/csrc/sed_projection.cu",
        "replaces": "psa_tpu/ops/pallas_sed.py:116",
        "launches": main_launches, "max_abs_err": work_abs,
        "ms": work_ms, "plain_ms": work_plain_ms,
        "bound_ms": bound[bound_by], "bound_by": bound_by, "library_ms": None,
        "design_bound_ms": 3 * flop / TF32_PEAK * 1e3,
        "ptxas": ptxas_info, "out_accumulate_rel_err": out_errs, "tiers": tier_info,
        "launches_per_path": {"calculate": main_launches, "kgrid_peaks": peaks_launches,
                              "kgrid_browse": browse_launches, "lt": lt_launches,
                              "welch": welch_launches, "calculate_streamed": streamed_launches,
                              "kgrid_peaks_streamed": streamed_peaks_launches,
                              "resume_rerun": rerun_launches, "from_dump": dump_launches,
                              "npt_peaks": npt_peaks_launches, "npt": npt_launches,
                              "npt_chain": npt_chain_launches, "cli": cli_launches,
                              **gridded_launches, **session_launches, **mesh_launches,
                              # one count over the whole phase: every engine, resident and streamed
                              "dsf_exact_factored_incremental": dsf_info['launches'],
                              # the fused mode-stack kernel's, per surface of phase 11
                              **{f"dsf_phasor_modes_{n}": c
                                 for n, c in dsf_info['phasor_launches'].items()},
                              "bench_op_sweep": bench_sweep_launches, **bench_path_launches},
        "bench": {"headline": bench_line, "kernel_ms_per_block": bench_block_ms,
                  "extras": bench_extras},
        "path_chunks_rel_err": [
            {"path": path, "shapes": [shape], "rel_err": err}
            for path, chunks in (("kgrid_peaks/kgrid_browse", big_chunks),
                                 ("square_lattice", small_chunks), ("npt", npt_chunks))
            for shape, err in chunks] + streamed_loop + [dump_loop, cli_loop, session_loop]
        + [{"path": "mesh", "shapes": [shape], "rel_err": err} for shape, err in mesh_shapes]
        + bench_entries}] + tier_kernels
        + [dict(dsf_info['modes'], ptxas={n: ptxas.get(n) for n in MODES_KERNELS})]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == '__main__':
    if sys.argv[1:] == ['--phase', '16f']:
        phase16f_alone()
    elif sys.argv[1:] == ['--phase', '17']:
        phase17_alone()
    elif sys.argv[1:] == ['--phase', '18']:
        phase18_alone()
    elif sys.argv[1:] == ['--phase', '3c']:
        phase3c_alone()
    elif sys.argv[1:] == ['--phase', '11d']:
        phase11d_alone()
    elif sys.argv[1:]:
        raise SystemExit("usage: python3 chip_smoke.py [--phase 3c | --phase 11d | --phase 16f | "
                         "--phase 17 | --phase 18]")
    else:
        main()
    sys.exit(0)

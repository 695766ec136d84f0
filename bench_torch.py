"""Benchmark of psa_tpu_torch: the repository's single-chip target on one CUDA GPU.

Coherent SED over a 50×50 k-grid (2,500 k-points) of a 10⁵-atom, 10⁴-step
trajectory, the workload of ``BASELINE.json``, through the port's projection
kernel.  The counterpart of ``bench.py``: the same workload, knobs and
one-line contract, measured on the card this script runs on.

Prints ONE JSON line on stdout:

    {"metric", "value", "unit", "vs_baseline", "compile_s", "headline_user",
     "device"}

``value`` is k-points/s of the op sweep (``psa_tpu_torch.ops.spectral.
sed_spectrum`` once per block of ``PSA_BENCH_KBLOCK`` k-points, the last block
ragged), ``vs_baseline`` its speed-up over the NumPy reference pipeline
measured on this machine's host, ``compile_s`` the wall of the first block
(the kernel's build and load included: seconds when ``psa_tpu_torch/_build``
already holds the library, about a minute when nvcc must run), and
``headline_user`` the same shape through ``SEDCalculator.calculate_kgrid_peaks``.
``device`` is the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` reports them, or ``cpu``.

Contract:
  * SIGTERM/SIGINT handlers are installed first thing in ``main``; on a
    signal the latest headline (final, or provisional after the first
    completed k-block) is printed and the process exits 0, or exits 1 when
    nothing was measured yet;
  * the headline prints right after the timed sweep and the user headline;
    the extras (``PSA_BENCH_EXTRAS=1``) run afterwards, log to stderr and
    write ``bench_torch_extras/bench_extras.json``;
  * the velocities are drawn on the device (``torch.randn``, 12.0 GB at the
    default size): nothing of that size is made or uploaded on the host;
  * each timing ends in ``torch.cuda.synchronize()``;
  * the NumPy baseline is measured on an n_t-subsample on this host and kept
    in ``bench_torch_baseline.json``, keyed by shape and host name;
  * a failure after the headline (user headline or an extra) is logged with
    its name and the process exits 1;
  * each path's launches of the projection kernel are logged to stderr as
    ``kernel launches: <path> <n>``;
  * without a CUDA card the script fails before it measures anything; only
    ``PSA_BENCH_DEVICE=cpu`` runs it on the host (the line then says ``cpu``).

Environment knobs:
    PSA_BENCH_ATOMS      (default 100000)
    PSA_BENCH_STEPS      (default 10000)
    PSA_BENCH_GRID       (default 50 -> 50x50 k-points)
    PSA_BENCH_BASELINE_K (default 8; k-subsample of the NumPy reference pass)
    PSA_BENCH_BASELINE_T (default 1000; n_t-subsample of the NumPy reference pass)
    PSA_BENCH_PRECISION  (default 'parity'; 'balanced' or 'fast')
    PSA_BENCH_EXTRAS     (default 0; 1 runs the user-path benches after the headline)
    PSA_BENCH_USER_HEADLINE (default 1; 0 skips ``headline_user``)
    PSA_BENCH_KBLOCK     (default 1280; k-points per projection launch)
    PSA_BENCH_BUDGET_S   (default 3000; no extra starts past this many seconds)
    PSA_BENCH_DEVICE     (default 'cuda'; 'cpu' runs on the host)
    PSA_BENCH_OUT_DIR    (default: this file's directory; where the baseline
                          sidecar and the extras directory are written)

Run:  python3 bench_torch.py
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import traceback
from collections import namedtuple

import numpy as np

A0 = 5.43
BASELINE_SIDECAR = 'bench_torch_baseline.json'
EXTRAS_DIR = 'bench_torch_extras'

#: compile_s: wall of the first block (kernel build and load included);
#: sweep_s: wall of the timed sweep over every block; launches: blocks of
#: the timed sweep plus the first one; kept: the spectrum's ``keep`` columns.
Sweep = namedtuple('Sweep', 'compile_s sweep_s launches kept')


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Headline:
    """The latest headline and whether it was printed; the signal handler
    prints it when the process is stopped before the normal print."""

    def __init__(self):
        self.line = None
        self.stage = 'startup'
        self.printed = False

    def print_once(self):
        if self.line is not None and not self.printed:
            self.printed = True
            print(json.dumps(self.line), flush=True)

    def on_signal(self, signum, frame):
        log(f"signal {signum} during stage '{self.stage}': printing "
            f"{'the headline' if self.line else 'nothing (no measurement yet)'}")
        self.print_once()
        os._exit(0 if self.printed else 1)


def si_mean_positions(n_atoms):
    """Si-like lattice mean positions, float64 (host; tiny)."""
    side = int(np.ceil((n_atoms / 8) ** (1 / 3)))  # 8-atom conventional cells
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing='ij'),
                     axis=-1).reshape(-1, 3)
    basis = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0.5, 0.5, 0], [0.75, 0.75, 0.25],
                      [0.5, 0, 0.5], [0.75, 0.25, 0.75], [0, 0.5, 0.5], [0.25, 0.75, 0.75]])
    sites = ((cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * A0)[:n_atoms]
    return sites.astype(np.float64)


def grid_k_vectors(grid):
    """The (grid², 3) float32 k-grid of the xy plane over ±2π/a0."""
    kx = np.linspace(-2 * np.pi / A0, 2 * np.pi / A0, grid, dtype=np.float32)
    return np.stack([np.repeat(kx, grid), np.tile(kx, grid),
                     np.zeros(grid * grid, np.float32)], axis=1)


def numpy_ref_time(velocities, mean_pos32, kv):
    """Seconds of one pass of the reference pipeline (float32 phase matrix,
    einsum, FFT / n_t) on the given data."""
    n_t = velocities.shape[0]
    t0 = time.perf_counter()
    phase = np.exp(1j * np.dot(kv, mean_pos32.T))                 # (K, N)
    sed_tk = np.zeros((n_t, kv.shape[0], 3), dtype=np.complex64)
    for pol in range(3):
        sed_tk[:, :, pol] = np.einsum('ta,ak->tk', velocities[:, :, pol],
                                      phase.T, optimize=True)
    _ = (np.fft.fft(sed_tk, axis=0) / n_t).astype(np.complex64)
    return time.perf_counter() - t0


def baseline_s_per_kpoint(sidecar_path, n_atoms, n_steps, mean_pos64, k_vectors, k_sub,
                          t_sub):
    """NumPy-reference seconds per k-point at (n_atoms, n_steps) on this host.

    Measured on a ``t_sub``-step subsample and extrapolated linearly in n_t
    (the einsum dominates and is linear in n_t); kept in ``sidecar_path``
    under the shape and the host name, so a rerun on the same host reuses
    it and another host measures its own."""
    host = socket.gethostname()
    key = f"{n_atoms}x{n_steps}@{host}"
    try:
        with open(sidecar_path) as f:
            sidecar = json.load(f)
    except (OSError, ValueError):
        sidecar = {}
    if key in sidecar:
        v = sidecar[key]['s_per_kpoint']
        log(f"numpy baseline from {sidecar_path}: {v} s/k-point ({sidecar[key]['note']})")
        return v

    t_sub = min(t_sub, n_steps)
    log(f"numpy baseline not kept for {key}; measuring on a {t_sub}-step subsample "
        f"x {k_sub} k-points...")
    rng = np.random.default_rng(0)
    vel_sub = rng.standard_normal((t_sub, n_atoms, 3), dtype=np.float32)
    dt = numpy_ref_time(vel_sub, mean_pos64.astype(np.float32), k_vectors[:k_sub])
    s_per_k = dt / k_sub * (n_steps / t_sub)
    log(f"  {k_sub} k-points x {t_sub} steps in {dt:.3f} s -> {s_per_k} s/k-point "
        f"extrapolated to n_t={n_steps}")
    sidecar[key] = {'s_per_kpoint': s_per_k,
                    'note': f"measured on this host, t_sub={t_sub} x k_sub={k_sub}, "
                            "extrapolated linearly in n_t"}
    with open(sidecar_path, 'w') as f:
        json.dump(sidecar, f, indent=1, sort_keys=True)
    return s_per_k


def device_label(dev):
    """The card's name and power limit from nvidia-smi, or 'cpu'."""
    if dev.type != 'cuda':
        return 'cpu'
    return subprocess.run(['nvidia-smi', '-i', str(dev.index), '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def op_sweep(data, mp_hi, mp_lo, k_vectors, block=1280, precision='parity',
             on_first_block=None, keep=None):
    """The op sweep: ``sed_spectrum`` once per block of ``block`` k-points.

    ``data`` (n_t, A, 3), ``mp_hi``/``mp_lo`` (A, 3) and ``k_vectors``
    (K, 3) are float32 tensors on one device; the last block is ragged.
    The first block runs once untimed (``compile_s``: the kernel's build and
    load are in it), then every block is timed, ending in a device
    synchronize.  ``on_first_block(seconds, compile_s)`` is called once the timed
    sweep's first block has completed (when there are several).  ``keep``:
    ascending k indices whose (n_t, len(keep), 3) complex64 columns are
    gathered from the blocks and returned as ``kept``.
    """
    import torch
    from psa_tpu_torch.ops import spectral

    def sync():
        if data.is_cuda:
            torch.cuda.synchronize(data.device)

    blocks = [(s, k_vectors[s:s + block]) for s in range(0, len(k_vectors), block)]
    keep = None if keep is None else np.asarray(keep)
    t0 = time.perf_counter()
    out = spectral.sed_spectrum(data, mp_hi, mp_lo, blocks[0][1], precision=precision)
    sync()
    compile_s = time.perf_counter() - t0
    del out

    kept = []
    t0 = time.perf_counter()
    for i, (start, kb) in enumerate(blocks):
        out = spectral.sed_spectrum(data, mp_hi, mp_lo, kb, precision=precision)
        if keep is not None:
            cols = keep[(keep >= start) & (keep < start + len(kb))] - start
            kept.append(out[:, torch.from_numpy(cols).to(out.device)])
        del out
        if i == 0 and on_first_block is not None and len(blocks) > 1:
            sync()
            on_first_block(time.perf_counter() - t0, compile_s)
    sync()
    sweep_s = time.perf_counter() - t0
    return Sweep(compile_s, sweep_s, len(blocks) + 1,
                 torch.cat(kept, dim=1) if keep is not None else None)


def zero_strided_trajectory(mean_pos64, n_steps, velocities=None):
    """A Trajectory whose positions are a zero-strided view of the mean
    sites and whose velocities are ``velocities`` (default: a zero-strided
    view of zeros, for a calculator whose data is preloaded on the device)."""
    from psa_tpu_torch import Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    n_atoms = mean_pos64.shape[0]
    side = float(np.max(mean_pos64)) + A0
    box = np.diag([side] * 3).astype(np.float32)
    positions = np.broadcast_to(mean_pos64.astype(np.float32)[None], (n_steps, n_atoms, 3))
    if velocities is None:
        velocities = np.broadcast_to(np.zeros(3, np.float32), (n_steps, n_atoms, 3))
    return Trajectory(positions, velocities, np.ones(n_atoms, dtype=np.int32),
                      np.arange(n_steps, dtype=np.float32), box, *make_box_arrays(box),
                      dt_ps=0.01)


def measure_user_headline(dev, mean_pos64, n_steps, k_vectors, grid, precision,
                          data_dev, hi_dev, lo_dev):
    """The same shape through the public ``calculate_kgrid_peaks``: chunking,
    the kernel, the peak reduction and the readback, on the op sweep's own
    device tensors (``preload_device_group_data``: no upload)."""
    from psa_tpu_torch import SEDCalculator
    n_atoms = mean_pos64.shape[0]
    calc = SEDCalculator(zero_strided_trajectory(mean_pos64, n_steps), nx=1, ny=1, nz=1,
                         precision=precision, max_device_bytes=int(13e9), device=dev)
    calc._mean_pos64 = mean_pos64            # skip the broadcast-mean pass
    calc.preload_device_group_data(data_dev, hi_dev, lo_dev)
    n_k = k_vectors.shape[0]
    t0 = time.perf_counter()
    calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, k_chunk_size=1280)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, k_chunk_size=1280)
    warm_s = time.perf_counter() - t0
    log(f"user headline: calculate_kgrid_peaks {warm_s:.4f} s warm "
        f"({n_k / warm_s:.1f} k-points/s; first {first_s:.4f} s)")
    return {"metric": f"k-points/sec, calculate_kgrid_peaks end-to-end, {grid}x{grid} grid, "
                      f"{n_atoms} atoms x {n_steps} steps, precision={precision}, "
                      f"device={dev.type}",
            "value": n_k / warm_s, "unit": "k-points/sec", "first_s": first_s}


def host_velocities(n_steps, n_atoms):
    """Host velocities for the extras' Trajectory at memcpy speed: a
    2²⁰-sample normal pool tiled with shifted offsets (SED rates do not
    depend on the data)."""
    t0 = time.perf_counter()
    pool = np.random.default_rng(1).standard_normal(1 << 20, dtype=np.float32)
    shifted = np.lib.stride_tricks.sliding_window_view(np.tile(pool, 2), pool.size)
    total = n_steps * n_atoms * 3
    out = np.empty(total, dtype=np.float32)
    for i, start in enumerate(range(0, total, pool.size)):
        n = min(pool.size, total - start)
        out[start:start + n] = shifted[(i * 7919) % pool.size][:n]
    log(f"host velocities (tiled pool) in {time.perf_counter() - t0:.2f} s")
    return out.reshape(n_steps, n_atoms, 3)


def timed_twice(fn):
    """(first wall, warm wall, warm result) of two calls of ``fn``."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return first, time.perf_counter() - t0, out


def user_path_benches(dev, mean_pos64, n_steps, k_vectors, grid, precision, deadline,
                      failures):
    """The SEDCalculator paths users call, on host velocities: browse (float32
    and float16 readback), ``calculate`` on a 250-point k-path, peaks, and the
    gridded browse and peaks.  A path that would start past ``deadline`` is
    skipped; a path that fails is logged and its name appended to
    ``failures``.  Returns {metric: value}."""
    from psa_tpu_torch import SEDCalculator
    from psa_tpu_torch.ops import sed_projection as proj
    n_atoms = mean_pos64.shape[0]
    traj = zero_strided_trajectory(mean_pos64, n_steps, host_velocities(n_steps, n_atoms))
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, precision=precision,
                         max_device_bytes=int(13e9), device=dev)
    n_k = k_vectors.shape[0]
    extras, state = {}, {}

    def browse():
        first, warm, (_, inten, _) = timed_twice(
            lambda: calc.calculate_kgrid_browse(k_vectors, k_chunk_size=1280))
        full_bytes = n_steps * n_k * 3 * 8
        state.update(inten=inten, warm=warm)
        extras["calculate_browse_kps"] = n_k / warm
        extras["browse_d2h_reduction"] = full_bytes / inten.nbytes
        log(f"  browse: {warm:.4f} s warm ({n_k / warm:.1f} k-points/s; first {first:.4f} s); "
            f"d2h {inten.nbytes / 1e6:.0f} MB vs {full_bytes / 1e9:.1f} GB full complex")

    def browse_f16():
        first, warm, (_, inten16, _) = timed_twice(
            lambda: calc.calculate_kgrid_browse(k_vectors, k_chunk_size=1280,
                                                readback_dtype='float16'))
        inten = state['inten']
        q_err = float(np.max(np.abs(inten16.astype(np.float64) - inten.astype(np.float64)))
                      / max(float(np.max(inten)), 1e-300))
        extras["calculate_browse_f16_kps"] = n_k / warm
        extras["browse_f16_speedup"] = state['warm'] / warm
        extras["browse_f16_max_quant_err"] = q_err
        log(f"  browse f16: {warm:.4f} s warm ({n_k / warm:.1f} k-points/s, "
            f"{state['warm'] / warm:.2f}x vs f32; first {first:.4f} s; max quantization "
            f"{q_err:.2e} of max)")

    def kpath():
        k_mags, k_path = calc.get_k_path('x', bz_coverage=1.0, n_k=250, lat_param=A0)
        first, warm, sed = timed_twice(lambda: calc.calculate(k_mags, k_path,
                                                              k_chunk_size=1280))
        extras["kpath_calculate_kps"] = 250 / warm
        log(f"  k-path calculate: {warm:.4f} s warm ({250 / warm:.1f} k-points/s; first "
            f"{first:.4f} s; {sed.sed.nbytes / 1e6:.0f} MB complex fetched)")

    def peaks():
        first, warm, pk = timed_twice(
            lambda: calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, k_chunk_size=1280))
        extras["peaks_kps"] = n_k / warm
        log(f"  peaks: {warm:.4f} s warm ({n_k / warm:.1f} k-points/s; first {first:.4f} s; "
            f"{sum(p.nbytes for p in pk) / 1e3:.0f} kB fetched)")

    def gridded_browse():
        first, warm, _ = timed_twice(lambda: calc.calculate_kgrid_browse(
            k_vectors, engine='gridded', k_grid_shape=(grid, grid)))
        extras["gridded_browse_kps"] = n_k / warm
        log(f"  gridded browse: {warm:.4f} s warm ({n_k / warm:.1f} k-points/s; "
            f"first {first:.4f} s)")

    def gridded_peaks():
        first, warm, _ = timed_twice(lambda: calc.calculate_kgrid_peaks(
            k_vectors, n_peaks=3, engine='gridded', k_grid_shape=(grid, grid)))
        extras["gridded_peaks_kps"] = n_k / warm
        log(f"  gridded peaks: {warm:.4f} s warm ({n_k / warm:.1f} k-points/s; "
            f"first {first:.4f} s)")

    paths = [("1/5 calculate_kgrid_browse", browse),
             ("1b/5 calculate_kgrid_browse readback_dtype='float16'", browse_f16),
             ("2/5 calculate on a 250-point k-path", kpath),
             ("3/5 calculate_kgrid_peaks", peaks),
             ("4/5 calculate_kgrid_browse engine='gridded'", gridded_browse),
             ("5/5 calculate_kgrid_peaks engine='gridded'", gridded_peaks)]
    for name, fn in paths:
        if time.time() > deadline:
            log(f"skipping user path {name}: past PSA_BENCH_BUDGET_S")
            continue
        if fn is browse_f16 and 'inten' not in state:
            log(f"skipping user path {name}: the float32 browse did not run")
            continue
        log(f"user path {name}...")
        launched = proj.launches
        try:
            fn()
        except Exception as e:   # logged and counted: the run then exits 1
            log(f"user path {name} failed: {type(e).__name__}: {e}\n{traceback.format_exc()}")
            failures.append(name)
        log(f"kernel launches: user path {name} {proj.launches - launched}")
    return extras


def main():
    run_start = time.time()
    head = Headline()
    signal.signal(signal.SIGTERM, head.on_signal)
    signal.signal(signal.SIGINT, head.on_signal)

    n_atoms = int(os.environ.get('PSA_BENCH_ATOMS', 100_000))
    n_steps = int(os.environ.get('PSA_BENCH_STEPS', 10_000))
    grid = int(os.environ.get('PSA_BENCH_GRID', 50))
    k_sub = int(os.environ.get('PSA_BENCH_BASELINE_K', 8))
    t_sub = int(os.environ.get('PSA_BENCH_BASELINE_T', 1000))
    precision = os.environ.get('PSA_BENCH_PRECISION', 'parity')
    block = int(os.environ.get('PSA_BENCH_KBLOCK', 1280))
    device = os.environ.get('PSA_BENCH_DEVICE', 'cuda')
    out_dir = os.environ.get('PSA_BENCH_OUT_DIR', os.path.dirname(os.path.abspath(__file__)))
    log(f"bench_torch: {n_atoms} atoms x {n_steps} steps, {grid}x{grid} grid, "
        f"precision={precision}, k-blocks of {block}, device={device}")

    head.stage = 'torch import'
    import torch
    from psa_tpu_torch.core.calculator import resolve_device
    from psa_tpu_torch.ops import sed_projection as proj
    from psa_tpu_torch.ops.spectral import check_precision, split_f64
    check_precision(precision)
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"bench_torch: {e}")
    label = device_label(dev)
    log(f"device: {label}, torch {torch.__version__}")

    head.stage = 'numpy baseline'
    mean_pos64 = si_mean_positions(n_atoms)
    k_vectors = grid_k_vectors(grid)
    n_k = k_vectors.shape[0]
    ref_s_per_k = baseline_s_per_kpoint(os.path.join(out_dir, BASELINE_SIDECAR), n_atoms,
                                        n_steps, mean_pos64, k_vectors, k_sub, t_sub)

    head.stage = 'device synth'
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    data = torch.randn((n_steps, n_atoms, 3), generator=gen, device=dev)
    hi, lo = (torch.from_numpy(x).to(dev) for x in split_f64(mean_pos64))
    k_dev = torch.from_numpy(k_vectors).to(dev)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    log(f"device-side synth of {data.numel() * 4 / 1e9:.1f} GB in "
        f"{time.perf_counter() - t0:.2f} s")

    def headline(kps, speedup, compile_s, note=''):
        return {"metric": f"k-points/sec, coherent SED, {grid}x{grid} grid, {n_atoms} atoms x "
                          f"{n_steps} steps, precision={precision}, device={dev.type}{note}",
                "value": kps, "unit": "k-points/sec", "vs_baseline": speedup,
                "compile_s": compile_s, "device": label}

    def provisional(seconds, compile_s):
        kps0 = min(block, n_k) / seconds
        head.line = headline(kps0, ref_s_per_k * kps0, compile_s,
                             note=", provisional (first block only)")
        log(f"provisional headline after the first block: {kps0:.1f} k-points/s")

    head.stage = 'timed sweep'
    launched = proj.launches
    sweep = op_sweep(data, hi, lo, k_dev, block, precision, on_first_block=provisional)
    log(f"kernel launches: op sweep {proj.launches - launched}")
    kps = n_k / sweep.sweep_s
    speedup = ref_s_per_k * n_k / sweep.sweep_s
    log(f"compile+first block: {sweep.compile_s:.3f} s")
    log(f"sweep: {n_k} k-points ({n_atoms} atoms x {n_steps} steps) in {sweep.sweep_s:.4f} s "
        f"-> {kps:.1f} k-points/s; numpy reference {ref_s_per_k * n_k:.1f} s -> "
        f"speedup {speedup:.1f}x")
    line = headline(kps, speedup, sweep.compile_s)
    head.line = line     # a stop during the user headline prints the op headline

    failures = []
    if os.environ.get('PSA_BENCH_USER_HEADLINE', '1') not in ('', '0'):
        head.stage = 'user headline'
        launched = proj.launches
        try:
            user = measure_user_headline(dev, mean_pos64, n_steps, k_vectors, grid, precision,
                                         data, hi, lo)
            log(f"kernel launches: user headline {proj.launches - launched}")
            head.line = dict(line, headline_user=user)
        except Exception as e:   # the op headline still prints; the run exits 1
            log(f"user headline failed: {type(e).__name__}: {e}\n{traceback.format_exc()}")
            failures.append('user headline')
    head.print_once()

    if os.environ.get('PSA_BENCH_EXTRAS', '0') not in ('', '0'):
        head.stage = 'extras'
        del data, hi, lo, k_dev
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
        deadline = run_start + float(os.environ.get('PSA_BENCH_BUDGET_S', 3000))
        extras = user_path_benches(dev, mean_pos64, n_steps, k_vectors, grid, precision,
                                   deadline, failures)
        path = os.path.join(out_dir, EXTRAS_DIR, 'bench_extras.json')
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w') as f:
            json.dump({"shape": f"{n_atoms}x{n_steps}x{grid}", "precision": precision,
                       "device": label, **extras, "failed": failures}, f, indent=1)
        log(f"extras written to {path}: {json.dumps(extras)}")
    if failures:
        log(f"bench_torch: failed: {', '.join(failures)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

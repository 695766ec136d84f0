"""Drive psa_tpu_torch's SED main path once on one CUDA GPU, and check it.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the projection kernel from ``psa_tpu_torch/csrc``,
checks it against its plain PyTorch version (two ragged shapes and the
working chunk, which must also come out bit for bit the same twice, and
whose error against a float64 sum of the same float32 operands is printed
for the kernel and the plain version), checks the chain-dispersion
physics, runs ``SEDCalculator.calculate`` at the working size (10^5 atoms x
10^4 steps x 2,500 k-points, coherent, parity precision), then
``calculate_kgrid_peaks`` (3 peaks, k-chunks of 1,280) and
``calculate_kgrid_browse`` (float32 and float16 readback) on the same data
against the float64 oracle, the grid reductions' physics at small sizes
(square-lattice peak surface, chiral peaks, L/T split, Welch), and the rest
of the slice (incoherent groups, chiral phase, iSED).  Each phase prints one line;
any failure raises and the script exits non-zero.  The line before the last
is a JSON record of each kernel (launches on the main path, error, times);
the last line is ``{"ok": true, "device": {...}}``.  No GPU: exits non-zero
before printing any result.
"""
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings

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
    a0 = 5.43
    side = int(np.ceil((n_atoms / 8) ** (1 / 3)))
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing='ij'), axis=-1).reshape(-1, 3)
    basis = np.array([[0, 0, 0], [.25, .25, .25], [.5, .5, 0], [.75, .75, .25],
                      [.5, 0, .5], [.75, .25, .75], [0, .5, .5], [.25, .75, .75]])
    sites = ((cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a0)[:n_atoms]
    return sites, side, a0


def working_calculator(dev):
    """(calc, k_vecs, grid_shape) of the working size: the Si slab's sites
    with host placeholders for the velocities, which live on the card (the
    caller preloads them), and the 50x50 k-grid."""
    from psa_tpu_torch import SEDCalculator, Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    sites, side, a0 = si_sites(N_ATOMS)
    box = np.diag([sites.max() + a0] * 3).astype(np.float32)
    traj = Trajectory(np.broadcast_to(sites.astype(np.float32), (N_T, N_ATOMS, 3)),
                      np.broadcast_to(np.zeros(3, np.float32), (N_T, N_ATOMS, 3)),
                      np.ones(N_ATOMS, dtype=np.int32), np.arange(N_T, dtype=np.float32),
                      box, *make_box_arrays(box), dt_ps=0.01)
    calc = SEDCalculator(traj, nx=side, ny=side, nz=side, max_device_bytes=int(13e9),
                         device=dev)
    _, k_vecs, grid_shape = calc.get_k_grid('xy', (-5, 5), (-5, 5), GRID, GRID)
    return calc, k_vecs, grid_shape


def ptxas_counts(log):
    """Registers, static shared memory and spills of the kernel from ``-Xptxas -v``."""
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
    launches of each path and the chunk checks."""
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
        proj.launches = 0
        t0 = time.perf_counter()
        (pf, ph, pw), syncs = count_syncs(lambda: calc.calculate_kgrid_peaks(
            k_vecs, n_peaks=N_PEAKS, k_chunk_size=K_CHUNK_GRID))
        walls.append(time.perf_counter() - t0)
        launches.append(proj.launches)
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
        proj.launches = 0
        t0 = time.perf_counter()
        freqs_b, inten, _ = calc.calculate_kgrid_browse(k_vecs, k_chunk_size=K_CHUNK_GRID,
                                                        readback_dtype=dtype)
        out[dtype] = (time.perf_counter() - t0, inten, proj.launches)
        check(proj.launches == want_launches and inten.shape == (len(freqs_kept), n_k),
              f"kgrid_browse {dtype}: launches {proj.launches}, shape {inten.shape}")
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
    return launches[-1], out['float32'][2], chunks


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
    proj.launches = 0
    pf, _, pw = lcalc.calculate_kgrid_peaks(kv, n_peaks=1, k_chunk_size=17)
    analytic = square_lattice_dispersion(kv[:, 0], kv[:, 1], a=2.5, nu_max_thz=10.0)
    df = 1.0 / (lattice.n_frames * lattice.dt_ps)
    ok = analytic > df
    miss = float(np.max(np.abs(pf[0][ok] - analytic[ok])))
    check(proj.launches > 0 and miss <= df + 1e-6 and (pw >= 0).all(),
          f"square-lattice peak surface off by {miss} THz > {df}")
    log('grid', f"square-lattice peak surface on nu(kx, ky): max miss {miss:.4f} THz <= "
                f"{df:.4f}; launches {proj.launches}")

    chiral = make_chiral_chain_trajectory(n_cells=32, n_frames=250, dt_ps=0.02, a=2.5,
                                          nu_thz=5.0, mode_index=8, handedness=+1, seed=3)
    hcalc = SEDCalculator(chiral, nx=32, ny=1, nz=1, device=dev)
    kv1 = np.array([[2 * np.pi * 8 / (32 * 2.5), 0.0, 0.0]], dtype=np.float32)
    proj.launches = 0
    pf, _, _, pph = hcalc.calculate_kgrid_peaks(kv1, n_peaks=1, chiral=True, chiral_axis='x')
    check(proj.launches > 0 and abs(pf[0, 0] - 5.0) <= 1.0 / (250 * 0.02) + 1e-6
          and abs(pph[0, 0] - np.pi / 2) < 0.05, f"chiral peak {pf[0, 0]} THz, phase {pph[0, 0]}")
    log('grid', f"chiral peak at {pf[0, 0]:.3f} THz, phase {pph[0, 0]:.5f} rad (expect pi/2); "
                f"launches {proj.launches}")

    proj.launches = 0
    _, i_l, i_t = lcalc.calculate_lt(kv, k_chunk_size=17)
    lt_launches = proj.launches
    _, inten, _ = lcalc.calculate_kgrid_browse(kv, k_chunk_size=17)
    lt_err = float(np.max(np.abs(i_l + i_t - inten)) / inten.max())
    check(lt_launches > 0 and lt_err <= TOL_PARITY, f"I_L + I_T vs browse {lt_err:.3e}")
    log('grid', f"calculate_lt: I_L + I_T vs browse intensity {lt_err:.3e} of max "
                f"(tol {TOL_PARITY}); launches {lt_launches}")

    k_mags, k_path = ccalc.get_k_path('x', bz_coverage=0.5, n_k=chain.n_atoms // 2 + 1)
    proj.launches = 0
    welch = ccalc.calculate_welch(k_mags, k_path, segments=2)
    welch_launches = proj.launches
    pos = welch.freqs >= 0
    peaks = welch.freqs[pos][np.argmax(welch.sed[pos], axis=0)]
    df_seg = 1.0 / (welch.sed.shape[0] * chain.dt_ps)
    miss = float(np.max(np.abs(peaks[1:] - nu_max * np.abs(np.sin(k_mags[1:] * a / 2)))))
    check(welch_launches > 0 and miss <= df_seg + 1e-6,
          f"Welch chain peaks off by {miss} THz > {df_seg}")
    log('grid', f"calculate_welch, 2 segments: chain peaks on nu = {nu_max}|sin(ka/2)| within "
                f"{miss:.4f} THz <= segment resolution {df_seg:.4f} THz; launches {welch_launches}")
    return lt_launches, welch_launches, chunks


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA GPU")
    from psa_tpu_torch import SEDCalculator, _build
    from psa_tpu_torch.models import (make_chain_trajectory, make_chiral_chain_trajectory,
                                      make_random_crystal_trajectory)
    from psa_tpu_torch.ops import sed_projection as proj
    from psa_tpu_torch.ops.spectral import split_f64

    dev = torch.device('cuda')

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
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if 'registers' in ln or 'spill' in ln]
    ptxas_info = ptxas_counts(_build.build_log)
    ptxas_info["smem_dynamic_bytes"] = lib.psa_sed_projection_smem_bytes()
    log('build', f"{_build.LIB_PATH.name} ready in {time.perf_counter() - t0:.2f} s "
                 f"(nvcc {_build.build_seconds} s); ptxas: {' | '.join(ptxas)}")
    check(ptxas_info["registers"] is not None, "no ptxas register count in the build log")

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
    proj.launches = 0
    sed = ccalc.calculate(k_mags, k_path)
    pos = sed.freqs >= 0
    peaks = sed.freqs[pos][np.argmax(sed.intensity[pos], axis=0)]
    miss = float(np.max(np.abs(peaks[1:] - nu_max * np.abs(np.sin(k_mags[1:] * a / 2)))))
    df = 1.0 / (chain.n_frames * chain.dt_ps)
    check(proj.launches > 0, "chain calculate launched no kernel")
    check(miss <= df + 1e-6, f"chain peaks off the analytic curve by {miss} THz > {df}")
    log('physics', f"chain peaks on nu = {nu_max}|sin(ka/2)|: max miss {miss:.4f} THz "
                   f"<= resolution {df:.4f} THz; launches {proj.launches}")

    # -- 5. main path at the working size ---------------------------------
    calc.preload_device_group_data(velocities, hi_dev, lo_dev)
    torch.cuda.reset_peak_memory_stats()
    proj.launches = 0
    t0 = time.perf_counter()
    sed = calc.calculate(np.array([], np.float32), k_vecs, summation_mode='coherent',
                         k_grid_shape=grid_shape)
    wall = time.perf_counter() - t0
    main_launches = proj.launches
    n_k = len(k_vecs)
    check(main_launches > 0, "the working-size calculate launched no projection kernel")
    check(sed.sed.shape == (N_T, n_k, 3), f"SED shape {sed.sed.shape}")
    check(bool(np.isfinite(sed.sed).all()), "non-finite SED values")
    cols = np.array([0, 777, 1250, n_k - 1])
    kc = torch.from_numpy(k_vecs[cols].astype(np.float64)).to(dev)
    mp = torch.from_numpy(mean64).to(dev)
    s_re = torch.zeros((N_T, len(cols), 3), dtype=torch.float64, device=dev)
    s_im = torch.zeros_like(s_re)
    for a0_ in range(0, N_ATOMS, 5000):
        ph = mp[a0_:a0_ + 5000] @ kc.T
        d = velocities[:, a0_:a0_ + 5000].double()
        s_re += torch.einsum('tac,ak->tkc', d, torch.cos(ph))
        s_im += torch.einsum('tac,ak->tkc', d, torch.sin(ph))
        del d
    oracle = torch.fft.fft(torch.complex(s_re, s_im), dim=0) / N_T
    got = torch.from_numpy(np.ascontiguousarray(sed.sed[:, cols, :])).to(dev).to(torch.complex128)
    main_err = rel(got, oracle)
    check(main_err <= TOL_KERNEL, f"working-size SED vs f64 oracle {main_err:.3e} > {TOL_KERNEL}")
    log('main', f"calculate: {N_ATOMS} atoms x {N_T} steps x {n_k} k, coherent, parity: "
                f"{wall:.3f} s wall, {n_k / wall:.1f} k-points/s; kernel launches {main_launches}; "
                f"shape {sed.sed.shape} finite; 4 k-columns vs f64 oracle rel err {main_err:.3e} "
                f"(tol {TOL_KERNEL}); peak device memory in calculate "
                f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del sed, got

    # -- 5b/5c. on-device grid reductions ----------------------------------
    t0 = time.perf_counter()
    peaks_launches, browse_launches, big_chunks = grid_working_size(
        calc, proj, (velocities, hi_dev, lo_dev), k_vecs, oracle, cols, calc.dt_ps)
    lt_launches, welch_launches, small_chunks = grid_small_sizes(dev, proj, chain, ccalc,
                                                                 nu_max, a)
    log('grid', f"grid phases took {time.perf_counter() - t0:.2f} s")
    del oracle, s_re, s_im
    calc.clear_device_cache()
    del velocities
    torch.cuda.empty_cache()

    # -- 6. the rest of the slice -----------------------------------------
    crystal = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 6), basis=2, n_frames=256,
                                             seed=SEED, n_types=2)
    xcalc = SEDCalculator(crystal, nx=6, ny=6, nz=6, device=dev)
    k_mags, k_path = xcalc.get_k_path('x', bz_coverage=1.0, n_k=33)
    proj.launches = 0
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
    check(not inc.is_complex and proj.launches > 0, "incoherent run shape/launches")
    check(inc_err < TOL_PARITY, f"incoherent vs f64 oracle {inc_err:.3e}")
    log('slice', f"incoherent, 2 type groups, {crystal.n_atoms} atoms: rel err {inc_err:.3e} "
                 f"(tol {TOL_PARITY}); launches {proj.launches}")

    chiral = make_chiral_chain_trajectory(n_cells=32, n_frames=250, dt_ps=0.02, a=2.5,
                                          nu_thz=5.0, mode_index=8, handedness=+1, seed=3)
    hcalc = SEDCalculator(chiral, nx=32, ny=1, nz=1, device=dev)
    kv = np.array([[2 * np.pi * 8 / (32 * 2.5), 0.0, 0.0]], dtype=np.float32)
    proj.launches = 0
    csed = hcalc.calculate(np.linalg.norm(kv, axis=1), kv)
    phase = hcalc.calculate_chiral_phase(csed.sed[:, :, 1], csed.sed[:, :, 2], angle_range_opt='C')
    pos = csed.freqs >= 0
    row = int(np.argmax(csed.intensity[pos][:, 0]))
    got_phase = float(phase[pos][row, 0])
    check(proj.launches > 0, "chiral run launched no kernel")
    check(abs(got_phase - np.pi / 2) < 0.05, f"chiral phase {got_phase} != pi/2")
    log('slice', f"chiral phase (option C) at the mode peak {csed.freqs[pos][row]:.3f} THz: "
                 f"{got_phase:.5f} rad (expect pi/2 = {np.pi / 2:.5f}); launches {proj.launches}")

    ichain = make_chain_trajectory(n_cells=16, n_frames=64, dt_ps=0.05)
    icalc = SEDCalculator(ichain, nx=16, ny=1, nz=1, device=dev)
    proj.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        dump = f"{tmp}/recon.dump"
        icalc.ised(k_dir_spec='x', k_target=0.6, w_target=5.0, char_len_k_path=2.5,
                   nk_on_path=20, rescale_factor='auto', n_recon_frames=10, dump_filepath=dump)
        with open(dump) as f:
            n_frames = f.read().count("ITEM: TIMESTEP")
    check(n_frames == 10 and proj.launches > 0, f"iSED dump frames {n_frames}")
    log('slice', f"iSED dump: {n_frames} frames of {ichain.n_atoms} atoms; launches {proj.launches}")

    print(json.dumps({"kernels": [{
        "name": "sed_projection", "route": "cuda", "design": DESIGN,
        "source": "psa_tpu_torch/csrc/sed_projection.cu",
        "replaces": "psa_tpu/ops/pallas_sed.py:116",
        "launches": main_launches, "max_abs_err": work_abs,
        "ms": work_ms, "plain_ms": work_plain_ms, "ptxas": ptxas_info,
        "launches_per_path": {"calculate": main_launches, "kgrid_peaks": peaks_launches,
                              "kgrid_browse": browse_launches, "lt": lt_launches,
                              "welch": welch_launches},
        "path_chunks_rel_err": [{"shape": list(shape), "rel_err": err}
                                for shape, err in big_chunks + small_chunks]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == '__main__':
    main()
    sys.exit(0)

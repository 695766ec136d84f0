"""Drive psa_tpu_torch's SED main path once on one CUDA GPU, and check it.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the projection kernel from ``psa_tpu_torch/csrc`` at first use,
checks it against its plain PyTorch version, checks the chain-dispersion
physics, runs ``SEDCalculator.calculate`` at the working size (10^5 atoms x
10^4 steps x 2,500 k-points, coherent, parity precision) and the rest of the
slice (incoherent groups, chiral phase, iSED).  Each phase prints one line;
any failure raises and the script exits non-zero.  The line before the last
is a JSON record of each kernel (launches on the main path, error, times);
the last line is ``{"ok": true, "device": {...}}``.  No GPU: exits non-zero
before printing any result.
"""
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_T, N_ATOMS, GRID = 10_000, 100_000, 50       # the working size
K_CHUNK = 500                                   # calculate()'s default k_chunk_size
SEED = 0
TOL_KERNEL = 1e-5   # kernel vs plain: same f32 products, other sum order over 1e5 atoms
TOL_PARITY = 1e-6   # small systems vs the float64 oracle (the repo's parity bar)


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


def compare_kernel(proj, data, hi, lo, kv, reps):
    """Kernel vs plain on one input: (max_abs_err, rel_err, kernel ms, plain ms)."""
    re_k, im_k = proj.sed_projection(data, hi, lo, kv)
    re_p, im_p = proj.sed_projection_plain(data, hi, lo, kv)
    torch.cuda.synchronize()
    err_abs = max(float((re_k - re_p).abs().max()), float((im_k - im_p).abs().max()))
    scale = max(float(re_p.abs().max()), float(im_p.abs().max()))
    del re_k, im_k, re_p, im_p
    # alternate plain, kernel, kernel, plain on one card
    plain = [cuda_ms(lambda: proj.sed_projection_plain(data, hi, lo, kv), reps)]
    kern = [cuda_ms(lambda: proj.sed_projection(data, hi, lo, kv), reps) for _ in range(2)]
    plain.append(cuda_ms(lambda: proj.sed_projection_plain(data, hi, lo, kv), reps))
    return err_abs, err_abs / scale, float(np.mean(kern)), float(np.mean(plain))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA GPU")
    from psa_tpu_torch import SEDCalculator, Trajectory, _build
    from psa_tpu_torch.core.trajectory import make_box_arrays
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
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if 'registers' in ln or 'spill' in ln]
    log('build', f"{_build.LIB_PATH.name} ready in {time.perf_counter() - t0:.2f} s "
                 f"(nvcc {_build.build_seconds} s); ptxas: {' | '.join(ptxas)}")

    # -- 3. kernel against its plain version ------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def dev32(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    n_t, n_a, n_k = 9, 1000, 77
    hi, lo = split_f64(rng.uniform(0, 50.0, size=(n_a, 3)))
    small = (torch.randn((n_t, n_a, 3), generator=gen, device=dev), dev32(hi), dev32(lo),
             dev32(rng.uniform(-3, 3, size=(n_k, 3))))
    err_abs, err_rel, ms_k, ms_p = compare_kernel(proj, *small, reps=20)
    check(err_rel <= TOL_KERNEL, f"ragged kernel vs plain {err_rel:.3e} > {TOL_KERNEL}")
    log('kernel', f"ragged (n_t,A,K)=({n_t},{n_a},{n_k}): rel err {err_rel:.3e} "
                  f"(tol {TOL_KERNEL}); kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")

    sites, side, a0 = si_sites(N_ATOMS)
    t0 = time.perf_counter()
    velocities = torch.randn((N_T, N_ATOMS, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    log('kernel', f"generated {N_T}x{N_ATOMS}x3 float32 velocities on the card "
                  f"({velocities.numel() * 4 / 1e9:.1f} GB) in {time.perf_counter() - t0:.2f} s")
    box = np.diag([sites.max() + a0] * 3).astype(np.float32)
    traj = Trajectory(np.broadcast_to(sites.astype(np.float32), (N_T, N_ATOMS, 3)),
                      # host placeholder: the velocities live on the card (preloaded below)
                      np.broadcast_to(np.zeros(3, np.float32), (N_T, N_ATOMS, 3)),
                      np.ones(N_ATOMS, dtype=np.int32), np.arange(N_T, dtype=np.float32),
                      box, *make_box_arrays(box), dt_ps=0.01)
    calc = SEDCalculator(traj, nx=side, ny=side, nz=side, max_device_bytes=int(13e9),
                         device=dev)
    _, k_vecs, grid_shape = calc.get_k_grid('xy', (-5, 5), (-5, 5), GRID, GRID)
    t0 = time.perf_counter()
    mean64 = calc.mean_positions64
    hi, lo = split_f64(mean64)
    hi_dev, lo_dev = dev32(hi), dev32(lo)
    log('kernel', f"mean positions of the {N_T}x{N_ATOMS} frames in "
                  f"{time.perf_counter() - t0:.2f} s")
    work_abs, work_rel, work_ms, work_plain_ms = compare_kernel(
        proj, velocities, hi_dev, lo_dev, dev32(k_vecs[:K_CHUNK]), reps=2)
    check(work_rel <= TOL_KERNEL, f"working-shape kernel vs plain {work_rel:.3e} > {TOL_KERNEL}")
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
    del sed, got, oracle, s_re, s_im
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
        "name": "sed_projection", "route": "cuda",
        "source": "psa_tpu_torch/csrc/sed_projection.cu",
        "replaces": "psa_tpu/ops/pallas_sed.py:116",
        "launches": main_launches, "max_abs_err": work_abs,
        "ms": work_ms, "plain_ms": work_plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == '__main__':
    main()
    sys.exit(0)

"""Mesh-scale k-grid SED sweep on PyTorch: the logic of ``scripts/pod_sweep.py``.

    python -m psa_tpu_torch.pod_sweep --trajectory traj.dump --dt 0.02 \\
        --grid 32 --k-chunk 512 --out sweep_out/

1. a memory-mapped trajectory (``TrajectoryLoader(mmap=True)``), or with
   ``--from-dump`` the text dump streamed straight into the mesh;
2. with ``--multihost``, the process group from torchrun's variables
   (:func:`psa_tpu_torch.parallel.initialize_cluster`);
3. a (t, a, k) mesh over ``--positions`` positions on this process's cards
   (repeated on one card: a virtual mesh), shaped to the memory budget;
4. the k-chunked sweep through :mod:`psa_tpu_torch.parallel`, each chunk
   checkpointed (``ShardedSEDCache``, the JAX script's key) so a killed
   sweep resumes;
5. a throughput report.

The flags and output files are the JAX script's; ``--device`` (default
``cuda``) and ``--positions`` are the port's.  On the CPU
(``--device cpu``) the mesh has no memory budget unless ``--hbm-gb`` sets one.
"""
import argparse
import logging
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger("pod_sweep")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--trajectory', required=True)
    p.add_argument('--dt', type=float, required=True)
    p.add_argument('--nx', type=int, default=1)
    p.add_argument('--ny', type=int, default=1)
    p.add_argument('--nz', type=int, default=1)
    p.add_argument('--plane', default='xy')
    p.add_argument('--k-min', type=float, default=-5.0)
    p.add_argument('--k-max', type=float, default=5.0)
    p.add_argument('--grid', type=int, default=200)
    p.add_argument('--k-chunk', type=int, default=2048)
    p.add_argument('--t-superchunk', type=int, default=None,
                   help='frames per streamed time superchunk (default: all frames at '
                        'once); set so one superchunk fits the card when the trajectory '
                        'does not')
    p.add_argument('--hbm-gb', type=float, default=None,
                   help="per-position memory budget (GiB) for the mesh's shape; default "
                        "half the card's memory on CUDA, none on the CPU")
    p.add_argument('--precision', choices=['parity', 'balanced', 'fast'], default='parity')
    p.add_argument('--engine', choices=['sharded', 'gridded'], default='sharded',
                   help="'sharded' = the mesh sweep; 'gridded' = the NUFFT engine (with "
                        "--peaks: its ky stripes over the mesh's devices)")
    p.add_argument('--browse', action='store_true',
                   help='store the omega>=0 float32 intensity planes reduced on the '
                        'devices instead of complex spectra (sharded engine only)')
    p.add_argument('--from-dump', action='store_true',
                   help='stream the text dump straight into the mesh through the native '
                        'parallel parser (sharded engine, or gridded with --peaks)')
    p.add_argument('--max-freq', type=float, default=None,
                   help='with --browse/--peaks: also cap retained frequencies (THz)')
    p.add_argument('--peaks', type=int, default=None, metavar='N',
                   help='store the top-N spectral peaks per k-point (freq/height/width), '
                        'found on the devices')
    p.add_argument('--lt', action='store_true',
                   help='store the (I_L, I_T) omega>=0 plane pair (sharded engine; '
                        'exclusive with --browse/--peaks/--chiral)')
    p.add_argument('--dsf', action='store_true',
                   help='store the (S, C_L, C_T) omega>=0 plane triplet of the '
                        'instantaneous phases (sharded engine, coherent; positions AND '
                        'velocities stream)')
    p.add_argument('--basis-types', default=None,
                   help='comma-separated atom types forming the basis (default: all '
                        'atoms); with --summation incoherent, one group per type')
    p.add_argument('--summation', choices=['coherent', 'incoherent'], default='coherent')
    p.add_argument('--chiral', action='store_true',
                   help='with --browse: chiral-phase planes too; with --peaks: '
                        'phase-at-peak surfaces (coherent only)')
    p.add_argument('--chiral-axis', choices=['x', 'y', 'z'], default='z')
    p.add_argument('--out', default='pod_sweep_out')
    p.add_argument('--multihost', action='store_true',
                   help='join the process group (torchrun variables) before the mesh')
    p.add_argument('--k-outer', action=argparse.BooleanOptionalAction, default=None,
                   help='k stripes over the process boundaries, atom/time sums inside '
                        'each process (default: on with several processes)')
    p.add_argument('--device', choices=['cuda', 'cpu'], default='cuda')
    p.add_argument('--positions', type=int, default=None,
                   help="mesh positions, spread over this process's cards (default: one "
                        "per card)")
    return p, p.parse_args(argv)


def save(args, out_dir: Path, full, freqs, k_vecs, shape) -> None:
    """Write the sweep's result files (the JAX script's names and keys)."""
    from .core.sed import SED
    n_k = len(k_vecs)
    if args.peaks is not None:
        arrays = dict(peak_freqs=full[0], peak_heights=full[1], peak_widths=full[2],
                      k_vectors=k_vecs, k_grid_shape=np.asarray(shape))
        if args.chiral:
            arrays['peak_phase'] = full[3]
        np.savez(out_dir / "kgrid_peaks.npz", **arrays)
        logger.info("dispersion surfaces saved: %s (%d peaks x %d k-points%s)",
                    out_dir / "kgrid_peaks.npz", args.peaks, n_k,
                    ", +chiral phase" if args.chiral else "")
    elif args.browse:
        SED(full[0], freqs, np.array([]), k_vecs, k_grid_shape=shape, is_complex=False,
            phase=(full[1] if args.chiral else None)).save(out_dir / "kgrid_sed")
    elif args.lt:
        np.savez(out_dir / "kgrid_lt.npz", i_long=full[0], i_trans=full[1], freqs=freqs,
                 k_vectors=k_vecs, k_grid_shape=np.asarray(shape))
        logger.info("L/T planes saved: %s (2 x %d freqs x %d k-points)",
                    out_dir / "kgrid_lt.npz", len(freqs), n_k)
    elif args.dsf:
        np.savez(out_dir / "kgrid_dsf.npz", s=full[0], c_long=full[1], c_trans=full[2],
                 freqs=freqs, k_vectors=k_vecs, k_grid_shape=np.asarray(shape))
        logger.info("DSF planes saved: %s (S, C_L, C_T x %d freqs x %d k-points)",
                    out_dir / "kgrid_dsf.npz", len(freqs), n_k)
    else:
        SED(full, freqs, np.array([]), k_vecs, k_grid_shape=shape,
            is_complex=True).save(out_dir / "kgrid_sed")


def main(argv=None):
    import torch
    from .core.calculator import SEDCalculator
    from .core.trajectory import Trajectory, make_box_arrays
    from .io.loader import TrajectoryLoader
    from .io.shard_cache import ShardedSEDCache, file_fingerprint, trajectory_fingerprint
    from .ops import spectral
    from .parallel import (DumpBlockSource, initialize_cluster, make_mesh, sharded_dsf,
                           sharded_sed_spectrum)
    from .utils.profiling import throughput_report

    p, args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format='%(asctime)s %(levelname)s %(message)s',
                            datefmt='%H:%M:%S')
    group = initialize_cluster(device=args.device) if args.multihost else None
    world = torch.distributed.get_world_size() if group is not None else 1
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.browse and args.engine != 'sharded':
        p.error("--browse requires the sharded engine")
    if args.from_dump and args.engine != 'sharded' and args.peaks is None:
        p.error("--from-dump needs the sharded engine, or --engine gridded with --peaks "
                "(streamed NUFFT)")

    if args.from_dump:
        source = DumpBlockSource(args.trajectory)
        pos0, _ = source.frames(0, 1)
        lengths, tilts = make_box_arrays(source.box_matrix)
        traj = Trajectory(pos0, np.zeros_like(pos0), source.types,
                          np.zeros(1, dtype=np.float32), box_matrix=source.box_matrix,
                          box_lengths=lengths, box_tilts=tilts, dt_ps=args.dt)
        n_frames, n_atoms = source.n_frames, source.n_atoms
        data = source
        mean64 = source.mean_positions64()
        traj_key = f"dump:{file_fingerprint(args.trajectory)}:{n_frames}x{n_atoms}"
        logger.info("trajectory: %d frames x %d atoms (native text streaming)",
                    n_frames, n_atoms)
    else:
        traj = TrajectoryLoader(args.trajectory, dt=args.dt, mmap=True).load()
        n_frames, n_atoms = traj.n_frames, traj.n_atoms
        data = traj.velocities
        logger.info("trajectory: %d frames x %d atoms (memory-mapped)", n_frames, n_atoms)
        if not np.any(traj.velocities):
            logger.warning("velocities are all zero (dump without vx/vy/vz?): the "
                           "velocity-SED of this sweep will be zero")
        traj_key = trajectory_fingerprint(traj)

    calc = SEDCalculator(traj, nx=args.nx, ny=args.ny, nz=args.nz, precision=args.precision,
                         device=args.device)
    if not args.from_dump:
        mean64 = calc.mean_positions64
    _, k_vecs, shape = calc.get_k_grid(args.plane, (args.k_min, args.k_max),
                                       (args.k_min, args.k_max), args.grid, args.grid)
    n_cards = torch.cuda.device_count() if args.device == 'cuda' else 1
    n_pos = args.positions or n_cards
    devices = ([f'cuda:{i % n_cards}' for i in range(n_pos)] if args.device == 'cuda'
               else ['cpu'] * n_pos) * world
    hbm = (int(args.hbm_gb * 2 ** 30) if args.hbm_gb
           else ('auto' if args.device == 'cuda' else None))
    k_outer = args.k_outer if args.k_outer is not None else world > 1
    mesh = make_mesh(devices=devices, n_t=n_frames, n_atoms=n_atoms, hbm_bytes=hbm,
                     k_outer=k_outer, group=group)
    logger.info("mesh: %s over %d positions, %d process(es)", mesh.shape, mesh.size, world)

    if args.peaks is not None and args.browse:
        p.error("--peaks is exclusive with --browse")
    if args.lt:
        if args.browse or args.peaks is not None or args.chiral:
            p.error("--lt is exclusive with --browse/--peaks/--chiral")
        if args.engine != 'sharded':
            p.error("--lt requires the sharded engine")
    if args.dsf:
        if args.browse or args.peaks is not None or args.chiral or args.lt:
            p.error("--dsf is exclusive with --browse/--peaks/--chiral/--lt")
        if args.engine != 'sharded':
            p.error("--dsf requires the sharded engine")
        if args.summation == 'incoherent':
            p.error("--dsf is coherent-only (the density mode sums amplitudes; use "
                    "--basis-types for sub-group selection)")
    if args.engine == 'gridded' and args.summation == 'incoherent':
        p.error("--engine gridded is coherent-only; use the sharded (direct) engine for "
                "incoherent sweeps")

    basis_types = ([int(t) for t in args.basis_types.replace(',', ' ').split()]
                   if args.basis_types else None)
    groups = calc._resolve_atom_groups(None, basis_types, args.summation)
    weights, single = calc._group_weights(groups, args.summation)
    incoherent = weights is not None and len(weights) > 1
    if incoherent and not (args.browse or args.peaks is not None or args.lt):
        p.error("--summation incoherent needs --browse, --peaks or --lt (the mesh sums "
                "per-group intensities)")
    if args.chiral:
        if not single:
            p.error("--chiral needs coherent summation (single spectrum)")
        if not (args.browse or args.peaks is not None):
            p.error("--chiral needs --browse or --peaks")
        if args.engine != 'sharded':
            p.error("--chiral requires the sharded engine")
    comp_pair = spectral.CHIRAL_AXIS_COMPONENTS[args.chiral_axis] if args.chiral else None

    dsf_sources = dsf_weights = None
    if args.dsf:
        # instantaneous phases are wrap-invariant on the box reciprocal lattice
        # only: snap each raster point to the nearest commensurate k
        from .ops.instantaneous import nearest_commensurate
        snapped = nearest_commensurate(k_vecs, traj.box_matrix)
        shift = (float(np.max(np.linalg.norm(snapped.astype(np.float64) - k_vecs, axis=1)))
                 if len(k_vecs) else 0.0)
        if shift > 0:
            logger.info("DSF k-grid snapped onto the box reciprocal lattice (max shift "
                        "%.3g 2π/Å); snapped k saved as k_vectors", shift)
        k_vecs = snapped
        dsf_sources = ((source.sibling('positions'), source) if args.from_dump
                       else (traj.positions, traj.velocities))
        if basis_types is not None:
            gi = np.unique(np.concatenate(groups)).astype(int)
            dsf_weights = np.zeros(n_atoms, dtype=np.float32)
            dsf_weights[gi] = 1.0

    all_freqs = spectral.fftfreq_thz(n_frames, args.dt)
    freq_idx = None
    if args.browse or args.peaks is not None or args.lt or args.dsf:
        mask = all_freqs >= 0
        if args.max_freq is not None:
            mask &= all_freqs <= args.max_freq
        freq_idx = np.flatnonzero(mask).astype(np.int32)

    mode = (f'peaks-{args.peaks}-grid' if args.peaks is not None else
            'browse-intensity-grid' if args.browse else
            'lt-grid' if args.lt else 'dsf-grid' if args.dsf else 'coherent-grid')
    cache = ShardedSEDCache(out_dir / "chunks", workload={
        'traj': traj_key, 'k_vectors': k_vecs, 'mode': mode,
        'basis_types': basis_types, 'summation': args.summation,
        'chiral': (args.chiral_axis if args.chiral else None),
        'max_freq': args.max_freq if freq_idx is not None else None,
        'precision': args.precision, 'mesh': str(dict(mesh.shape))})
    # every rank computes the same arrays; rank 0 alone writes them
    writer = mesh.rank == 0
    store = cache.store if writer else (lambda ci, array: None)

    n_k = k_vecs.shape[0]
    chunk = args.k_chunk
    n_chunks = (n_k + chunk - 1) // chunk
    if args.peaks is not None:
        freqs = all_freqs[freq_idx]
        full = np.zeros((4 if args.chiral else 3, args.peaks, n_k), dtype=np.float32)
    elif args.browse:
        freqs = all_freqs[freq_idx]
        full = np.zeros((2 if args.chiral else 1, len(freq_idx), n_k), dtype=np.float32)
    elif args.lt:
        freqs = all_freqs[freq_idx]
        full = np.zeros((2, len(freq_idx), n_k), dtype=np.float32)
    elif args.dsf:
        freqs = all_freqs[freq_idx]
        full = np.zeros((3, len(freq_idx), n_k), dtype=np.float32)
    else:
        freqs = all_freqs
        full = np.zeros((n_frames, n_k, 3), dtype=np.complex64)

    def bounds(ci):
        return ci * chunk, min((ci + 1) * chunk, n_k)

    def restore(fits, fill):
        """Chunks still to compute; the cached ones are filled in."""
        missing = []
        for ci in range(n_chunks):
            s, e = bounds(ci)
            c = cache.load(ci)
            if c is not None and fits(c, s, e):
                fill(c, s, e)
            else:
                missing.append(ci)
        return missing

    t0 = time.time()
    computed = 0
    if args.engine == 'gridded' and args.peaks is not None:
        # one-shot NUFFT dispersion surfaces, ky stripes over the mesh's devices
        missing = restore(lambda c, s, e: c.shape[-1] == e - s,
                          lambda c, s, e: full.__setitem__(np.s_[:, :, s:e], c))
        if missing:
            if args.from_dump:
                # the calculator's trajectory is a one-frame stub here: drive the
                # op with the dump's frame count and streamed mean positions
                if basis_types is not None:
                    p.error("--from-dump --engine gridded sweeps all atoms; drop "
                            "--basis-types or use the sharded engine")
                from .ops import gridded as gridded_ops
                kx_vals, ky_vals, k_fixed, axes = calc._detect_grid_axes(
                    k_vecs.astype(np.float32), shape)
                plan = gridded_ops.plan_kgrid(mean64, kx_vals, ky_vals, k_fixed=k_fixed,
                                              axes=axes)
                pf, ph, pw = gridded_ops.gridded_kgrid_peaks_sharded(
                    source, plan, freq_idx, freqs, [d for *_, d in mesh.local_positions()],
                    n_peaks=args.peaks, precision=args.precision,
                    t_superchunk=args.t_superchunk)
            else:
                pf, ph, pw = calc.calculate_kgrid_peaks_sharded(
                    mesh, k_vecs, n_peaks=args.peaks, max_freq=args.max_freq,
                    basis_atom_types=basis_types, summation_mode=args.summation,
                    engine='gridded', k_grid_shape=shape, t_superchunk=args.t_superchunk)
            full[:3] = np.stack([pf, ph, pw])
            for ci in missing:
                s, e = bounds(ci)
                store(ci, full[:, :, s:e])
                computed += e - s
    elif args.engine == 'gridded':
        # the whole grid in one shot: resume is all-or-nothing
        missing = restore(lambda c, s, e: c.shape[1] == e - s,
                          lambda c, s, e: full.__setitem__(np.s_[:, s:e, :], c))
        if missing:
            full[:, :, :] = calc.calculate_gridded(k_vecs, shape,
                                                   basis_atom_types=basis_types).sed
            for ci in missing:
                s, e = bounds(ci)
                store(ci, full[:, s:e, :])
                computed += e - s
    else:
        reduced = args.peaks is not None or args.browse or args.lt or args.dsf
        sweep = dict(precision=args.precision, t_superchunk=args.t_superchunk)
        for ci in range(n_chunks):
            s, e = bounds(ci)
            cached = cache.load(ci)
            if cached is not None and cached.shape[-1 if reduced else 1] == e - s:
                if reduced:
                    full[..., s:e] = cached
                else:
                    full[:, s:e, :] = cached
                continue
            if args.peaks is not None:
                block = np.stack(sharded_sed_spectrum(
                    mesh, data, mean64, k_vecs[s:e], freq_indices=freq_idx,
                    n_peaks=args.peaks, peak_freqs_thz=freqs, atom_weights=weights,
                    comp_pair=comp_pair, **sweep))                  # (3|4, n_peaks, chunk)
                full[..., s:e] = block
            elif args.browse:
                out = sharded_sed_spectrum(mesh, data, mean64, k_vecs[s:e],
                                           want_intensity=True, freq_indices=freq_idx,
                                           atom_weights=weights, comp_pair=comp_pair, **sweep)
                block = np.stack(out) if args.chiral else out[None]  # (1|2, n_f, chunk)
                full[..., s:e] = block
            elif args.lt:
                block = np.stack(sharded_sed_spectrum(
                    mesh, data, mean64, k_vecs[s:e], freq_indices=freq_idx,
                    atom_weights=weights, lt=True, **sweep))           # (2, n_f, chunk)
                full[..., s:e] = block
            elif args.dsf:
                block = np.stack(sharded_dsf(
                    mesh, dsf_sources[0], dsf_sources[1], k_vecs[s:e], freq_indices=freq_idx,
                    atom_weights=dsf_weights, **sweep))                # (3, n_f, chunk)
                full[..., s:e] = block
            else:
                re, im = sharded_sed_spectrum(mesh, data, mean64, k_vecs[s:e],
                                              atom_weights=weights, **sweep)
                block = (re + 1j * im).astype(np.complex64)
                full[:, s:e, :] = block
            store(ci, block)
            computed += e - s
            logger.info("chunk %d/%d done (%d k-points)", ci + 1, n_chunks, e - s)
    dt = time.time() - t0

    if writer:
        save(args, out_dir, full, freqs, k_vecs, shape)
    rep = throughput_report(n_k=max(computed, 1), seconds=max(dt, 1e-9), n_atoms=n_atoms,
                            n_t=n_frames)
    logger.info("sweep complete: %d/%d k-points computed in %.1f s (%.1f k-points/s, %.2f "
                "effective TFLOP/s)", computed, n_k, dt, rep['k_points_per_sec'],
                rep['effective_tflops'])
    return {'computed': computed, 'n_k': n_k, 'seconds': dt, 'mesh': mesh.shape}


if __name__ == "__main__":
    main()

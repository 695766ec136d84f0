"""Entry points of the port: the single-device forward step and a mesh dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.

``entry(device)`` returns the flagship forward step, the SED projection and
time FFT of one atom group (:func:`psa_tpu_torch.ops.spectral.sed_spectrum`,
the projection kernel on a card) with its arguments on ``device``: a
Si-like synthetic crystal of 512 atoms, 128 frames and 64 k-points, made
from the same NumPy seed as the JAX entry.  The step returns complex64.

``dryrun_multichip(n, full=False, device)`` runs the fully sharded SED step
on a virtual mesh of ``n`` positions of one device (``make_mesh(devices=
[device] * n)``) with the JAX dry run's composite (t, a, k) shape and each
of its checks.  The fast core always runs: SED re/im and intensity, streamed
superchunks with filtered readback, sharded peaks, incoherent groups, chiral
browse and peaks.  ``full`` adds the extended tier: the L/T split, the DSF
and liquid families, the mesh NUFFT, BlockSource streaming and k-outer
placement.  A torch mesh needs no virtual platform, so no subprocess is
started for it.
"""
import numpy as np

from .core.calculator import SEDCalculator
from .models import make_random_crystal_trajectory
from .ops import spectral
from .ops.instantaneous import nearest_commensurate
from .parallel import ArrayBlockSource, make_mesh, sharded_sed_spectrum

ENTRY_SHAPE = (128, 512, 64)   # (n_t, n_atoms, n_k)
DRYRUN_FRAMES, DRYRUN_K = 16, 24


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: check failed: {what}")


def entry(device='cuda'):
    """Return ``(fn, args)``: the SED forward step and its tensors on ``device``."""
    import torch
    from .core.calculator import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n_t, n_atoms, n_k = ENTRY_SHAPE
    data = rng.normal(size=(n_t, n_atoms, 3)).astype(np.float32)
    mean64 = rng.uniform(0, 30.0, size=(n_atoms, 3))
    mp_hi, mp_lo = spectral.split_f64(mean64)
    k_vectors = np.outer(np.linspace(0, 2.0, n_k), [1, 0, 0]).astype(np.float32)

    def sed_forward(data, mp_hi, mp_lo, k_vectors):
        """Φ_α(ω, k) of one atom group, (n_t, n_k, 3) complex64: the
        projection kernel, then the time FFT over n_t."""
        return spectral.sed_spectrum(data, mp_hi, mp_lo, k_vectors)

    args = tuple(torch.from_numpy(a).to(dev) for a in (data, mp_hi, mp_lo, k_vectors))
    return sed_forward, args


def mesh_shape(n_devices, n_t=DRYRUN_FRAMES):
    """The dry run's composite (t, a, k) shape: 2 along time when both
    ``n_devices`` and ``n_t`` are even, the rest split as squarely as it
    divides between atoms and k."""
    t_ax = 2 if (n_devices % 2 == 0 and n_t % 2 == 0) else 1
    rest = n_devices // t_ax
    a_ax = max(d for d in range(1, int(rest ** 0.5) + 1) if rest % d == 0)
    return (t_ax, a_ax, rest // a_ax)


def dryrun_multichip(n_devices: int, full: bool = False, device='cuda') -> None:
    """Run one fully sharded SED step over a virtual mesh of ``n_devices``
    positions of ``device``, checking every output; ``full`` adds the
    extended observable tier.  Raises ``RuntimeError`` on a failed check."""
    n_t = DRYRUN_FRAMES
    traj = make_random_crystal_trajectory(n_cells_xyz=(4, 2, 2), basis=2, n_frames=n_t,
                                          dt_ps=0.02, seed=0)
    shape = mesh_shape(n_devices, n_t)
    t_ax = shape[0]
    mesh = make_mesh(shape=shape, devices=[device] * n_devices)
    k_vectors = np.outer(np.linspace(0.0, 1.2, DRYRUN_K), [1, 1, 0]).astype(np.float32)
    mean64 = np.mean(traj.positions, axis=0, dtype=np.float64)

    # --- fast core: the sharded SED step across every mesh axis ---
    re, im = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors)
    _check(re.shape == (n_t, DRYRUN_K, 3) and im.shape == (n_t, DRYRUN_K, 3),
           f"spectrum shapes {re.shape}, {im.shape}")
    _check(np.all(np.isfinite(re)) and np.all(np.isfinite(im)), "finite spectrum")

    inten = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors,
                                 want_intensity=True)
    _check(inten.shape == (n_t, DRYRUN_K) and np.all(inten >= 0), "intensity plane")

    # streamed superchunks with the frequency rows filtered on the device
    freq_idx = np.arange(n_t // 2, dtype=np.int32)
    inten_s = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors,
                                   want_intensity=True, t_superchunk=max(t_ax, n_t // 2),
                                   freq_indices=freq_idx)
    _check(inten_s.shape == (n_t // 2, DRYRUN_K), f"streamed plane {inten_s.shape}")
    _check(np.allclose(inten_s, inten[freq_idx], rtol=1e-5, atol=1e-8),
           "streamed superchunks equal the resident sweep")

    # peak extraction inside the k stripes
    freqs = spectral.fftfreq_thz(n_t, traj.dt_ps)[freq_idx].astype(np.float32)
    pf, ph, pw = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors,
                                      freq_indices=freq_idx, n_peaks=2, peak_freqs_thz=freqs)
    _check(pf.shape == ph.shape == pw.shape == (2, DRYRUN_K), "peak triplet shapes")
    _check(np.all(ph[0] >= ph[1]), "peaks rank-ordered by height")

    # group semantics on the mesh: incoherent groups, chiral browse and peaks
    calc = SEDCalculator(traj, nx=4, ny=2, nz=2, device=device)
    fr, inc_inten, _ = calc.calculate_kgrid_browse_sharded(
        mesh, k_vectors, basis_atom_types=[1, 2], summation_mode='incoherent',
        t_superchunk=max(t_ax, n_t // 2))
    _check(inc_inten.shape == (fr.size, DRYRUN_K) and np.all(inc_inten >= 0),
           "incoherent browse planes")
    _, ch_inten, ch_phase = calc.calculate_kgrid_browse_sharded(
        mesh, k_vectors, chiral=True, chiral_axis='z')
    _check(ch_phase is not None and ch_phase.shape == ch_inten.shape, "chiral phase plane")
    _check(np.all(np.abs(ch_phase) <= np.pi / 2 + 1e-6), "chiral phase within ±π/2")
    cpf, cph, cpw, cpp = calc.calculate_kgrid_peaks_sharded(mesh, k_vectors, n_peaks=1,
                                                            chiral=True)
    _check(cpp.shape == (1, DRYRUN_K), "phase at the peaks")

    tiers = ("fast core (atom sums + time rows + k stripes; streamed superchunks + "
             "filtered readback + sharded peaks + incoherent groups + chiral "
             "browse/peak-phase)")
    if full:
        _dryrun_extended(mesh, calc, traj, k_vectors, mean64, n_t, shape, device)
        tiers += (" + extended (L/T split + streamed mesh DSF + liquid family "
                  "S(k)/ISF/MSD/VACF/g(r) + streamed mesh NUFFT + k-outer placement)")
    print(f"dryrun_multichip: mesh {dict(mesh.shape)} over {n_devices} positions of "
          f"{device} OK — {tiers} verified")


def _dryrun_extended(mesh, calc, traj, k_vectors, mean64, n_t, shape, device) -> None:
    """The extended observable tier: L/T, the DSF and liquid families, the
    NUFFT stripes from a BlockSource, k-outer placement."""
    ltf, il, it = calc.calculate_lt_sharded(mesh, k_vectors)
    _check(il.shape == it.shape == (ltf.size, DRYRUN_K) and np.all(it >= 0), "L/T planes")

    # instantaneous-phase observables over the mesh, k snapped onto the
    # box's reciprocal lattice
    kv_dsf = nearest_commensurate(k_vectors[:8], traj.box_matrix)
    dsff, ds, dcl, dct = calc.calculate_dsf_sharded(mesh, kv_dsf, t_superchunk=n_t // 2)
    _check(ds.shape == dcl.shape == dct.shape == (dsff.size, 8), "DSF planes")
    _check(np.all(np.isfinite(ds)) and np.all(dct >= 0), "finite DSF, C_T ≥ 0")
    dsfs, ss_plane = calc.calculate_dsf_self_sharded(mesh, kv_dsf[:4])
    _check(ss_plane.shape == (dsfs.size, 4) and np.all(ss_plane >= 0), "self DSF plane")

    sk_m = calc.calculate_sk_sharded(mesh, kv_dsf, t_superchunk=n_t // 2)
    _check(sk_m.shape == (8,) and np.all(sk_m >= 0), "S(k)")
    _, isf_m = calc.calculate_isf_sharded(mesh, kv_dsf, n_lags=4)
    _check(isf_m.shape == (4, 8), "ISF shape")
    _check(np.allclose(isf_m[0], sk_m, rtol=1e-4, atol=1e-5), "F(k, 0) = S(k)")
    _, isfs_m = calc.calculate_isf_self_sharded(mesh, kv_dsf[:4], n_lags=4)
    _check(isfs_m.shape == (4, 4), "self ISF shape")
    _check(np.allclose(isfs_m[0], 1.0, rtol=1e-4), "F_s(k, 0) = 1")
    _, msd_m = calc.calculate_msd_sharded(mesh, n_lags=4)
    _, vacf_m = calc.calculate_vacf_sharded(mesh, n_lags=4)
    _check(msd_m.shape == vacf_m.shape == (1, 4) and vacf_m[0, 0] > 0, "MSD/VACF")
    _, g_m = calc.calculate_rdf(n_bins=8, mesh=mesh, atom_block=4, max_frames=2)
    _check(g_m.shape == (8,) and np.all(g_m >= 0), "g(r)")

    # the NUFFT engine over ky stripes, resident and from a BlockSource
    _, kg_vecs, kg_shape = calc.get_k_grid('xy', (-1.0, 1.0), (-1.0, 1.0), 6, 8)
    gpf, gph, gpw = calc.calculate_kgrid_peaks_sharded(
        mesh, kg_vecs, n_peaks=1, engine='gridded', k_grid_shape=kg_shape)
    _check(gpf.shape == (1, 48) and np.all(np.isfinite(gpf)), "gridded peaks")
    spf, sph, spw = calc.calculate_kgrid_peaks_sharded(
        mesh, kg_vecs, n_peaks=1, engine='gridded', k_grid_shape=kg_shape,
        data=ArrayBlockSource(traj.velocities), t_superchunk=n_t // 2)
    _check(np.allclose(spf, gpf, atol=1e-6), "streamed gridded peaks equal the resident ones")

    # k-outer placement: the same spectrum
    re, im = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors)
    mesh_ko = make_mesh(shape=shape, devices=[device] * mesh.size, k_outer=True)
    re_ko, im_ko = sharded_sed_spectrum(mesh_ko, traj.velocities, mean64, k_vectors)
    _check(np.allclose(re_ko, re, rtol=1e-5, atol=1e-6), "k-outer equals k-inner")

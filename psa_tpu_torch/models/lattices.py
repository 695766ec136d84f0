"""Synthetic MD trajectory generators with known phonon physics.

The reference ships no test fixtures that exercise the engine; its examples
require external LAMMPS data.  These generators fill that gap: closed-form
lattice-dynamics trajectories whose SED has an analytically known dispersion,
used by the golden parity tests, the benchmark harness, and the examples.

Physics: a 1D monatomic chain with nearest-neighbor springs has
    ω(k) = ω_max · |sin(k a / 2)|,   ω_max = 2 √(κ/m)
so synthesizing atomic motion from a set of chain normal modes produces a
trajectory whose SED must peak exactly on that curve — a checkable oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..core.trajectory import Trajectory, make_box_arrays


def monatomic_chain_modes(n_cells: int, a: float = 2.5, omega_max_thz: float = 10.0,
                          n_modes: Optional[int] = None, seed: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normal modes of a 1D chain: (k values, ω(k) in THz·2π rad/ps, amplitudes)."""
    rng = np.random.default_rng(seed)
    n_modes = n_modes or max(1, n_cells // 2)
    mode_idx = rng.choice(np.arange(1, n_cells // 2 + 1), size=min(n_modes, n_cells // 2),
                          replace=False)
    k_vals = 2 * np.pi * mode_idx / (n_cells * a)                 # 2π/Å
    omega = omega_max_thz * np.abs(np.sin(k_vals * a / 2.0))      # THz
    amps = rng.uniform(0.01, 0.05, size=k_vals.shape)
    return k_vals, omega, amps


def make_chain_trajectory(n_cells: int = 64, n_frames: int = 256, dt_ps: float = 0.05,
                          a: float = 2.5, omega_max_thz: float = 10.0,
                          n_modes: Optional[int] = None, seed: int = 0,
                          noise: float = 0.0) -> Trajectory:
    """1D monatomic chain trajectory built from superposed normal modes.

    Atoms sit on x_i = i·a along x; displacement and velocity follow
    u_i(t) = Σ_m A_m cos(k_m x_i − 2π ν_m t + φ_m).  The SED of this
    trajectory peaks on ω(k) = ω_max |sin(ka/2)|.
    """
    rng = np.random.default_rng(seed + 1)
    k_vals, nu_thz, amps = monatomic_chain_modes(n_cells, a, omega_max_thz, n_modes, seed)
    phases = rng.uniform(0, 2 * np.pi, size=k_vals.shape)

    x0 = np.arange(n_cells, dtype=np.float64) * a                 # (N,)
    t = np.arange(n_frames, dtype=np.float64) * dt_ps             # (T,)
    # phase[t, atom, mode]
    arg = (k_vals[None, None, :] * x0[None, :, None]
           - 2 * np.pi * nu_thz[None, None, :] * t[:, None, None]
           + phases[None, None, :])
    disp = np.sum(amps[None, None, :] * np.cos(arg), axis=-1)     # (T, N)
    vel = np.sum(amps[None, None, :] * 2 * np.pi * nu_thz[None, None, :]
                 * np.sin(arg), axis=-1)                          # du/dt

    positions = np.zeros((n_frames, n_cells, 3), dtype=np.float32)
    velocities = np.zeros((n_frames, n_cells, 3), dtype=np.float32)
    positions[:, :, 0] = (x0[None, :] + disp).astype(np.float32)
    velocities[:, :, 0] = vel.astype(np.float32)
    if noise > 0:
        positions += rng.normal(0, noise, positions.shape).astype(np.float32)
        velocities += rng.normal(0, noise, velocities.shape).astype(np.float32)

    box = np.diag([n_cells * a, 10.0, 10.0]).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    return Trajectory(
        positions=positions, velocities=velocities,
        types=np.ones(n_cells, dtype=np.int32),
        timesteps=(t * 0 + np.arange(n_frames)).astype(np.float32),
        box_matrix=box, box_lengths=lengths, box_tilts=tilts, dt_ps=dt_ps)


def make_random_crystal_trajectory(n_cells_xyz: Tuple[int, int, int] = (4, 4, 4),
                                   basis: int = 2, n_frames: int = 64,
                                   dt_ps: float = 0.02, a: float = 5.43,
                                   seed: int = 0, n_types: int = 2) -> Trajectory:
    """Randomized 3D crystal trajectory (thermal-like motion, no exact physics).

    Used for parity and stress tests at realistic shapes: atoms on a cubic
    supercell lattice with ``basis`` atoms per cell, random velocities, and
    small random walks around the lattice sites.
    """
    rng = np.random.default_rng(seed)
    nx, ny, nz = n_cells_xyz
    grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                indexing='ij'), axis=-1).reshape(-1, 3)
    offsets = rng.uniform(0, 0.5, size=(basis, 3))
    sites = (grid[:, None, :] + offsets[None, :, :]).reshape(-1, 3) * a
    n_atoms = sites.shape[0]

    positions = (sites[None, :, :]
                 + rng.normal(0, 0.05, size=(n_frames, n_atoms, 3))).astype(np.float32)
    velocities = rng.normal(0, 1.0, size=(n_frames, n_atoms, 3)).astype(np.float32)
    types = (np.tile(np.arange(basis), n_atoms // basis) % n_types + 1).astype(np.int32)

    box = np.diag([nx * a, ny * a, nz * a]).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    return Trajectory(
        positions=positions, velocities=velocities, types=types,
        timesteps=np.arange(n_frames, dtype=np.float32),
        box_matrix=box, box_lengths=lengths, box_tilts=tilts, dt_ps=dt_ps)


def diatomic_chain_branches(k: np.ndarray, kappa: float, m1: float, m2: float):
    """Analytic diatomic-chain dispersion ω±(k) (rad/ps) and eigenvector ratios.

    For the 1D chain with alternating masses m1, m2, spring κ, spacing a/2:
        ω±² = κ(1/m1 + 1/m2) ± κ√((1/m1+1/m2)² − 4 sin²(ka/2)/(m1·m2))
    Returns (omega_acoustic, omega_optical, ratio_ac, ratio_op) where ratio is
    the m2-sublattice amplitude per unit m1-sublattice amplitude:
        u2/u1 = 2κ cos(ka/2) / (2κ − m2 ω²)
    """
    s = 1.0 / m1 + 1.0 / m2
    ka2 = k / 2.0  # k·(a=1)/2; caller scales k by the cell length
    disc = np.sqrt(np.maximum(s * s - 4.0 * np.sin(ka2) ** 2 / (m1 * m2), 0.0))
    w_ac = np.sqrt(np.maximum(kappa * (s - disc), 0.0))
    w_op = np.sqrt(kappa * (s + disc))

    def ratio(w):
        denom = 2.0 * kappa - m2 * w ** 2
        denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        return 2.0 * kappa * np.cos(ka2) / denom

    return w_ac, w_op, ratio(w_ac), ratio(w_op)


def make_diatomic_chain_trajectory(n_cells: int = 32, n_frames: int = 512,
                                   dt_ps: float = 0.02, a: float = 5.0,
                                   kappa: float = 800.0, m1: float = 1.0,
                                   m2: float = 3.0, amp: float = 0.02,
                                   seed: int = 0) -> Trajectory:
    """Diatomic 1D chain: two atoms per cell (types 1 and 2), acoustic and
    optical branches synthesized with their exact eigenvectors.

    ω in rad/ps; SED frequencies peak at ω/(2π) THz.  The optical branch
    carries opposite-phase motion of the two sublattices — type-resolved
    (incoherent) SED separates the branch weights.
    """
    rng = np.random.default_rng(seed)
    n_atoms = 2 * n_cells
    x1 = np.arange(n_cells, dtype=np.float64) * a          # type-1 sites
    x2 = x1 + a / 2.0                                      # type-2 sites

    mode_idx = np.arange(1, n_cells // 2 + 1)
    k_vals = 2 * np.pi * mode_idx / (n_cells * a)
    w_ac, w_op, r_ac, r_op = diatomic_chain_branches(k_vals * a, kappa, m1, m2)

    t = np.arange(n_frames, dtype=np.float64) * dt_ps
    disp1 = np.zeros((n_frames, n_cells))
    disp2 = np.zeros((n_frames, n_cells))
    vel1 = np.zeros((n_frames, n_cells))
    vel2 = np.zeros((n_frames, n_cells))
    for branch, (w, r) in enumerate(((w_ac, r_ac), (w_op, r_op))):
        phases = rng.uniform(0, 2 * np.pi, size=k_vals.shape)
        for km, wm, rm, ph in zip(k_vals, w, r, phases):
            if wm <= 0:
                continue
            norm = max(1.0, abs(rm))
            a1, a2 = amp / norm, amp * rm / norm
            arg1 = km * x1[None, :] - wm * t[:, None] + ph
            arg2 = km * x2[None, :] - wm * t[:, None] + ph
            disp1 += a1 * np.cos(arg1)
            disp2 += a2 * np.cos(arg2)
            vel1 += a1 * wm * np.sin(arg1)
            vel2 += a2 * wm * np.sin(arg2)

    positions = np.zeros((n_frames, n_atoms, 3), dtype=np.float32)
    velocities = np.zeros((n_frames, n_atoms, 3), dtype=np.float32)
    positions[:, 0::2, 0] = (x1[None, :] + disp1).astype(np.float32)
    positions[:, 1::2, 0] = (x2[None, :] + disp2).astype(np.float32)
    velocities[:, 0::2, 0] = vel1.astype(np.float32)
    velocities[:, 1::2, 0] = vel2.astype(np.float32)

    types = np.empty(n_atoms, dtype=np.int32)
    types[0::2] = 1
    types[1::2] = 2
    masses = np.where(types == 1, m1, m2).astype(np.float64)

    box = np.diag([n_cells * a, 10.0, 10.0]).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    return Trajectory(positions=positions, velocities=velocities, types=types,
                      timesteps=np.arange(n_frames, dtype=np.float32),
                      box_matrix=box, box_lengths=lengths, box_tilts=tilts,
                      dt_ps=dt_ps, masses=masses)


def make_chiral_chain_trajectory(n_cells: int = 64, n_frames: int = 512,
                                 dt_ps: float = 0.02, a: float = 2.5,
                                 nu_thz: float = 5.0, mode_index: int = 8,
                                 handedness: int = +1, amp: float = 0.02,
                                 seed: int = 0) -> Trajectory:
    """1D chain carrying ONE circularly polarized transverse phonon mode.

    Atoms on x_i = i·a move on circles in the y–z plane:

        u_y(t) = A cos(k x − 2π ν t + φ)
        u_z(t) = −h · A sin(k x − 2π ν t + φ),    h = handedness ∈ {+1, −1}

    so u_z lags (h=+1) or leads (h=−1) u_y by exactly π/2.  The chiral phase
    Δφ = ∠Φ_y − ∠Φ_z of the SED at the synthesized (k, ν) is therefore
    **h · π/2 exactly** — an analytic oracle for the sign convention and
    quadrant folding of ``calculate_chiral_phase`` (reference
    sed_calculator.py:344-350) and for the browse path's
    ``chiral_axis='x' → (y, z)`` component mapping (psa_gui.py:976-982).

    Args:
        mode_index: chain mode m; k = 2π·m / (n_cells·a).
        handedness: +1 (u_z lags) or −1 (u_z leads).
    """
    if handedness not in (+1, -1):
        raise ValueError(f"handedness must be +1 or -1, got {handedness}")
    rng = np.random.default_rng(seed)
    k = 2.0 * np.pi * mode_index / (n_cells * a)
    phi = rng.uniform(0, 2 * np.pi)
    x0 = np.arange(n_cells, dtype=np.float64) * a
    t = np.arange(n_frames, dtype=np.float64) * dt_ps
    arg = k * x0[None, :] - 2.0 * np.pi * nu_thz * t[:, None] + phi  # (T, N)

    w = 2.0 * np.pi * nu_thz
    positions = np.zeros((n_frames, n_cells, 3), dtype=np.float32)
    velocities = np.zeros((n_frames, n_cells, 3), dtype=np.float32)
    positions[:, :, 0] = x0[None, :].astype(np.float32)
    positions[:, :, 1] = (amp * np.cos(arg)).astype(np.float32)
    positions[:, :, 2] = (-handedness * amp * np.sin(arg)).astype(np.float32)
    velocities[:, :, 1] = (amp * w * np.sin(arg)).astype(np.float32)
    velocities[:, :, 2] = (handedness * amp * w * np.cos(arg)).astype(np.float32)

    box = np.diag([n_cells * a, 10.0, 10.0]).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    return Trajectory(
        positions=positions, velocities=velocities,
        types=np.ones(n_cells, dtype=np.int32),
        timesteps=np.arange(n_frames, dtype=np.float32),
        box_matrix=box, box_lengths=lengths, box_tilts=tilts, dt_ps=dt_ps)


def honeycomb_structure_factor(kx: np.ndarray, ky: np.ndarray,
                               a: float = 2.46) -> np.ndarray:
    """Nearest-neighbor structure factor f(k) = Σ_j exp(i k·δ_j) of the
    honeycomb lattice (complex), with the three A→B bond vectors
    δ = (a/2, a√3/6), (−a/2, a√3/6), (0, −a/√3) for lattice constant ``a``
    (the A–A distance; bond length a/√3).  |f| = 3 at Γ and 0 at the K
    points (Dirac points)."""
    d1x, d1y = a / 2.0, a * np.sqrt(3.0) / 6.0
    d3y = -a / np.sqrt(3.0)
    return (np.exp(1j * (kx * d1x + ky * d1y))
            + np.exp(1j * (-kx * d1x + ky * d1y))
            + np.exp(1j * ky * d3y))


def honeycomb_dispersion(kx: np.ndarray, ky: np.ndarray, a: float = 2.46,
                         nu_K_thz: float = 8.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic out-of-plane (flexural) bands of the nearest-neighbor
    honeycomb lattice:

        ν∓(k) = ν_K · √((3 ∓ |f(k)|) / 3)         (THz)

    where f is :func:`honeycomb_structure_factor` and ν_K the frequency at
    the K point, where the two bands touch (|f| = 0).  Returns
    (ν_acoustic, ν_optical); ν_acoustic(Γ) = 0, ν_optical(Γ) = ν_K·√2.
    """
    absf = np.abs(honeycomb_structure_factor(kx, ky, a))
    nu_ac = nu_K_thz * np.sqrt(np.maximum(3.0 - absf, 0.0) / 3.0)
    nu_op = nu_K_thz * np.sqrt((3.0 + absf) / 3.0)
    return nu_ac, nu_op


def honeycomb_K_point(a: float = 2.46) -> np.ndarray:
    """Cartesian K (Dirac) point of the honeycomb lattice: (4π/3a, 0, 0)."""
    return np.array([4.0 * np.pi / (3.0 * a), 0.0, 0.0])


def make_honeycomb_trajectory(n_cells: int = 8, n_frames: int = 512,
                              dt_ps: float = 0.01, a: float = 2.46,
                              nu_K_thz: float = 8.0,
                              bands: Tuple[str, ...] = ('acoustic', 'optical'),
                              chiral: Optional[int] = None,
                              chiral_nu_thz: Optional[float] = None,
                              amp: float = 0.01, seed: int = 0) -> Trajectory:
    """Honeycomb (graphene-like) lattice: 2-atom basis on a NON-ORTHOGONAL
    cell, out-of-plane bands synthesized with their exact Bloch eigenvectors,
    and optionally ONE circularly polarized in-plane mode at the K point —
    the chiral-phonon geometry of the 2D-materials literature.

    Cell vectors a1 = a(1,0,0), a2 = a(1/2, √3/2, 0); sublattice B offset
    d = (a1+a2)/3.  The triclinic supercell box is stored column-major
    ([[lx,xy,0],[0,ly,0],[0,0,lz]]) per the Trajectory convention.  For each
    allowed k = (m·b1 + n·b2)/n_cells and band s ∈ {−,+}, the z motion is

        u_A = A cos(k·R_A − ωt + φ),  u_B = ±A cos(k·R_B − ωt + φ − θ)

    with f(k) = |f| e^{iθ} — the eigenvector (1, ±e^{−iθ})/√2 of the NN
    dynamical matrix — so the k-grid SED peaks exactly on
    :func:`honeycomb_dispersion`.  Note the coherent visibility rule: a mode
    probed at its own k carries weight |1 ± e^{iθ}|², so the optical branch
    is invisible at Γ (the (1,−1) sublattice sum cancels) and fades wherever
    θ → 0; type-resolved (incoherent) SED sees both branches everywhere.

    With ``chiral=±1``, sublattice A additionally circles in the x–y plane
    at :func:`honeycomb_K_point` with frequency ``chiral_nu_thz`` (default
    0.6·ν_K, spectrally clear of nothing — the z bands live in Φ_z only):
    u_x = A cos(K·R − 2πνt), u_y = −h·A sin(K·R − 2πνt), so the chiral
    phase Δφ = ∠Φ_x − ∠Φ_y at (K, ν) is **h·π/2 exactly** (the
    ``chiral_axis='z' → (x, y)`` component pair, psa_gui.py:976-982).

    Types: 1 = sublattice A, 2 = sublattice B.
    """
    if chiral not in (None, +1, -1):
        raise ValueError(f"chiral must be None, +1 or -1, got {chiral}")
    rng = np.random.default_rng(seed + 2)
    a1 = np.array([a, 0.0])
    a2 = np.array([a / 2.0, a * np.sqrt(3.0) / 2.0])
    d = (a1 + a2) / 3.0
    mm, nn = np.meshgrid(np.arange(n_cells), np.arange(n_cells), indexing='ij')
    r_a = (mm.ravel()[:, None] * a1[None, :]
           + nn.ravel()[:, None] * a2[None, :])              # (C, 2)
    r_b = r_a + d[None, :]
    n_atoms = 2 * r_a.shape[0]

    # reciprocal vectors of the 2D cell: b_i·a_j = 2π δ_ij
    b1 = (2.0 * np.pi / a) * np.array([1.0, -1.0 / np.sqrt(3.0)])
    b2 = (2.0 * np.pi / a) * np.array([0.0, 2.0 / np.sqrt(3.0)])
    kxy = (mm.ravel()[:, None] * b1[None, :]
           + nn.ravel()[:, None] * b2[None, :]) / n_cells    # (C, 2) allowed k
    f = honeycomb_structure_factor(kxy[:, 0], kxy[:, 1], a)
    theta = np.angle(f)
    nu_ac, nu_op = honeycomb_dispersion(kxy[:, 0], kxy[:, 1], a, nu_K_thz)

    t = np.arange(n_frames, dtype=np.float64) * dt_ps
    disp = np.zeros((n_frames, n_atoms))
    vel = np.zeros((n_frames, n_atoms))
    for band in bands:
        if band == 'acoustic':
            nu, sgn, sel = nu_ac, +1.0, nu_ac > 1e-9         # skip Γ (ω=0)
        elif band == 'optical':
            nu, sgn, sel = nu_op, -1.0, np.ones(len(nu_op), bool)
        else:
            raise ValueError(f"unknown band {band!r}")
        amps = amp * rng.uniform(0.5, 1.0, size=int(sel.sum()))
        phases = rng.uniform(0, 2 * np.pi, size=int(sel.sum()))
        w = 2.0 * np.pi * nu[sel]
        # mode-chunked accumulation bounds the (T, N, M) transient
        idx = np.flatnonzero(sel)
        for c0 in range(0, len(idx), 64):
            sl = idx[c0:c0 + 64]
            asl = amps[c0:c0 + 64][None, None, :]
            wsl = w[c0:c0 + 64]
            arg_a = (r_a @ kxy[sl].T)[None, :, :] \
                - wsl[None, None, :] * t[:, None, None] \
                + phases[c0:c0 + 64][None, None, :]
            arg_b = (r_b @ kxy[sl].T)[None, :, :] \
                - wsl[None, None, :] * t[:, None, None] \
                + (phases[c0:c0 + 64] - theta[sl])[None, None, :]
            disp[:, 0::2] += np.sum(asl * np.cos(arg_a), axis=-1)
            disp[:, 1::2] += sgn * np.sum(asl * np.cos(arg_b), axis=-1)
            vel[:, 0::2] += np.sum(asl * wsl[None, None, :] * np.sin(arg_a),
                                   axis=-1)
            vel[:, 1::2] += sgn * np.sum(asl * wsl[None, None, :]
                                         * np.sin(arg_b), axis=-1)

    positions = np.zeros((n_frames, n_atoms, 3), dtype=np.float32)
    velocities = np.zeros((n_frames, n_atoms, 3), dtype=np.float32)
    positions[:, 0::2, 0] = r_a[None, :, 0]
    positions[:, 0::2, 1] = r_a[None, :, 1]
    positions[:, 1::2, 0] = r_b[None, :, 0]
    positions[:, 1::2, 1] = r_b[None, :, 1]
    positions[:, :, 2] = disp.astype(np.float32)
    velocities[:, :, 2] = vel.astype(np.float32)

    if chiral is not None:
        nu_c = chiral_nu_thz if chiral_nu_thz is not None else 0.6 * nu_K_thz
        w_c = 2.0 * np.pi * nu_c
        kpt = honeycomb_K_point(a)
        arg = (r_a @ kpt[:2])[None, :] - w_c * t[:, None]    # (T, C)
        ua_x, ua_y = amp * np.cos(arg), -chiral * amp * np.sin(arg)
        positions[:, 0::2, 0] += ua_x.astype(np.float32)
        positions[:, 0::2, 1] += ua_y.astype(np.float32)
        velocities[:, 0::2, 0] = (amp * w_c * np.sin(arg)).astype(np.float32)
        velocities[:, 0::2, 1] = (chiral * amp * w_c
                                  * np.cos(arg)).astype(np.float32)

    lx = n_cells * a
    box = np.array([[lx, lx / 2.0, 0.0],
                    [0.0, lx * np.sqrt(3.0) / 2.0, 0.0],
                    [0.0, 0.0, 10.0]], dtype=np.float32)
    types = np.empty(n_atoms, dtype=np.int32)
    types[0::2] = 1
    types[1::2] = 2
    lengths, tilts = make_box_arrays(box)
    return Trajectory(
        positions=positions, velocities=velocities, types=types,
        timesteps=np.arange(n_frames, dtype=np.float32),
        box_matrix=box, box_lengths=lengths, box_tilts=tilts, dt_ps=dt_ps)


def fcc_dynamical_branches(k_vecs: np.ndarray, a: float = 4.0,
                           nu_L_X_thz: float = 10.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact phonon branches of the nearest-neighbor central-force FCC
    lattice: eigen-decomposition of

        D(k) = (2κ/m) Σ_δ (1 − cos k·δ) ê_δ ê_δᵀ

    over the 12 nearest neighbors δ = (a/2)(±1, ±1, 0) + permutations.
    Normalized so the LONGITUDINAL frequency at X = (2π/a)(1,0,0) equals
    ``nu_L_X_thz`` (there ω_L² = 8κ/m).

    Returns (nu (n_k, 3) THz ascending, eigvecs (n_k, 3, 3) with
    ``eigvecs[i, :, b]`` the branch-b polarization unit vector).
    """
    k_vecs = np.atleast_2d(np.asarray(k_vecs, dtype=np.float64))[:, :3]
    deltas = []
    for i, j in ((0, 1), (0, 2), (1, 2)):
        for si in (1, -1):
            for sj in (1, -1):
                d = np.zeros(3)
                d[i], d[j] = si * a / 2.0, sj * a / 2.0
                deltas.append(d)
    deltas = np.array(deltas)                              # (12, 3)
    e_hat = deltas / np.linalg.norm(deltas, axis=1, keepdims=True)
    outer = np.einsum('di,dj->dij', e_hat, e_hat)          # (12, 3, 3)
    phase = 1.0 - np.cos(k_vecs @ deltas.T)                # (n_k, 12)
    d_mat = np.einsum('kd,dij->kij', phase, outer)         # ∝ D(k)·m/(2κ)
    evals, evecs = np.linalg.eigh(d_mat)
    # ω² = (2κ/m)·eval; at X the L eval is 4 → scale so ν_L(X) = nu_L_X
    nu = nu_L_X_thz * np.sqrt(np.maximum(evals, 0.0) / 4.0)
    return nu, evecs


def make_fcc_trajectory(n_cells: int = 6, n_frames: int = 512,
                        dt_ps: float = 0.01, a: float = 4.0,
                        nu_L_X_thz: float = 10.0,
                        branches: Tuple[int, ...] = (0, 1, 2),
                        amp: float = 0.01, seed: int = 0) -> Trajectory:
    """FCC monatomic lattice with FULL VECTOR polarizations — every mode is
    synthesized with the exact eigenvector of the NN dynamical matrix, so
    longitudinal and transverse branches live in the SED's three Cartesian
    components exactly as lattice dynamics dictates (the other oracles are
    scalar-polarized; this one pins the 3-component physics).

    ``branches`` selects which of the three branches (0, 1 ascending =
    transverse, 2 = longitudinal along high-symmetry lines) to excite.
    """
    rng = np.random.default_rng(seed + 3)
    # FCC sites: cubic cells + 3 face centers
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    mm = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3,
                              indexing='ij'), axis=-1).reshape(-1, 3)
    r = ((mm[:, None, :] + base[None, :, :]).reshape(-1, 3) * a)   # (N, 3)
    n_atoms = r.shape[0]

    # allowed k of the cubic supercell (the FCC conventional cell repeats
    # with period a in each direction): k = 2π (m, n, p) / (n_cells·a)
    ms = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3,
                              indexing='ij'), axis=-1).reshape(-1, 3)
    kall = (2.0 * np.pi / (n_cells * a)) * ms
    kall = kall[np.any(ms != 0, axis=1)]                   # drop Γ
    nu_all, evec_all = fcc_dynamical_branches(kall, a, nu_L_X_thz)

    t = np.arange(n_frames, dtype=np.float64) * dt_ps
    disp = np.zeros((n_frames, n_atoms, 3))
    vel = np.zeros((n_frames, n_atoms, 3))
    for b in branches:
        nu_b = nu_all[:, b]
        sel = np.flatnonzero(nu_b > 1e-9)
        amps = amp * rng.uniform(0.5, 1.0, size=sel.size)
        phases = rng.uniform(0, 2 * np.pi, size=sel.size)
        for c0 in range(0, sel.size, 64):
            sl = sel[c0:c0 + 64]
            w = 2.0 * np.pi * nu_b[sl]
            arg = ((r @ kall[sl].T)[None, :, :]
                   - w[None, None, :] * t[:, None, None]
                   + phases[c0:c0 + 64][None, None, :])    # (T, N, M)
            pol = evec_all[sl, :, b]                       # (M, 3)
            asl = amps[c0:c0 + 64]
            disp += np.einsum('tnm,m,mc->tnc', np.cos(arg), asl, pol)
            vel += np.einsum('tnm,m,mc->tnc', np.sin(arg), asl * w, pol)

    positions = (r[None, :, :] + disp).astype(np.float32)
    velocities = vel.astype(np.float32)
    box = np.diag([n_cells * a] * 3).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    return Trajectory(
        positions=positions, velocities=velocities,
        types=np.ones(n_atoms, dtype=np.int32),
        timesteps=np.arange(n_frames, dtype=np.float32),
        box_matrix=box, box_lengths=lengths, box_tilts=tilts, dt_ps=dt_ps)


def square_lattice_dispersion(kx: np.ndarray, ky: np.ndarray, a: float = 2.5,
                              nu_max_thz: float = 10.0) -> np.ndarray:
    """Analytic dispersion surface of the nearest-neighbor square lattice:

        ν(k) = ν_max · √( sin²(kx a/2) + sin²(ky a/2) ) / √2      (THz)

    ν_max is the zone-corner (M-point) frequency.
    """
    return nu_max_thz * np.sqrt(
        (np.sin(kx * a / 2.0) ** 2 + np.sin(ky * a / 2.0) ** 2) / 2.0)


def make_square_lattice_trajectory(n_cells: int = 16, n_frames: int = 256,
                                   dt_ps: float = 0.01, a: float = 2.5,
                                   nu_max_thz: float = 10.0, seed: int = 0,
                                   amp_decay_per_ps: float = 0.0
                                   ) -> Trajectory:
    """2D square monatomic lattice (z-polarized modes) with the analytic
    dispersion of :func:`square_lattice_dispersion` — the grid-engine
    analog of :func:`make_chain_trajectory`: the k-GRID SED of this
    trajectory must peak on ν(kx, ky) at every reciprocal-lattice-allowed
    grid point.

    Atoms sit on (i·a, j·a, 0); each allowed mode k = 2π(m, n)/(N a)
    contributes z displacement u(t) = A cos(k·r − 2π ν t + φ).

    ``amp_decay_per_ps`` γ > 0 damps every mode's amplitude as e^{-γt}
    (velocities stay the analytic du/dt), giving each spectral peak an
    exactly-known Lorentzian intensity FWHM of γ/π THz and hence a phonon
    lifetime τ = 1/(2γ) ps — the transport-pipeline oracle.
    """
    rng = np.random.default_rng(seed + 1)
    n_atoms = n_cells * n_cells
    ii, jj = np.meshgrid(np.arange(n_cells), np.arange(n_cells), indexing='ij')
    r = np.stack([ii.ravel() * a, jj.ravel() * a], axis=1).astype(np.float64)

    # all allowed modes except Γ (no restoring force there)
    ms, ns = np.meshgrid(np.arange(n_cells), np.arange(n_cells), indexing='ij')
    sel = ~((ms == 0) & (ns == 0))
    kxy = (2.0 * np.pi / (n_cells * a)) * np.stack(
        [ms[sel].ravel(), ns[sel].ravel()], axis=1)             # (M, 2)
    nu = square_lattice_dispersion(kxy[:, 0], kxy[:, 1], a, nu_max_thz)
    amps = rng.uniform(0.5, 1.0, size=len(kxy)) * 0.01
    phases = rng.uniform(0, 2 * np.pi, size=len(kxy))

    t = np.arange(n_frames, dtype=np.float64) * dt_ps
    arg = (r @ kxy.T)[None, :, :] - 2 * np.pi * nu[None, None, :] * t[:, None, None] \
        + phases[None, None, :]
    env = np.exp(-amp_decay_per_ps * t)[:, None, None]            # e^{-γt}
    disp_z = np.sum(amps[None, None, :] * env * np.cos(arg), axis=-1)  # (T, N)
    # exact du/dt of the damped mode: e^{-γt}(2πν sin(arg) − γ cos(arg))
    vel_z = np.sum(amps[None, None, :] * env
                   * (2 * np.pi * nu[None, None, :] * np.sin(arg)
                      - amp_decay_per_ps * np.cos(arg)), axis=-1)

    positions = np.zeros((n_frames, n_atoms, 3), dtype=np.float32)
    velocities = np.zeros((n_frames, n_atoms, 3), dtype=np.float32)
    positions[:, :, 0] = r[None, :, 0]
    positions[:, :, 1] = r[None, :, 1]
    positions[:, :, 2] = disp_z.astype(np.float32)
    velocities[:, :, 2] = vel_z.astype(np.float32)

    box = np.diag([n_cells * a, n_cells * a, 10.0]).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    return Trajectory(
        positions=positions, velocities=velocities,
        types=np.ones(n_atoms, dtype=np.int32),
        timesteps=np.arange(n_frames, dtype=np.float32),
        box_matrix=box, box_lengths=lengths, box_tilts=tilts, dt_ps=dt_ps)

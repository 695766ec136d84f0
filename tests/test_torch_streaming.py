"""psa_tpu_torch's out-of-core paths against the JAX package and the f64 oracle.

Groups over ``max_device_bytes`` (a tiny budget on both packages) stream
from the host in atom blocks through every surface that takes them:
``calculate`` (coherent, incoherent, displacements, mass-weighted), Welch,
browse, L/T, peaks and ``calculate_dos``; ``sed_from_dump_streaming``
streams frame blocks of a dump (native and line-iterator sources).  The
kernel's ``out=``/``accumulate=`` semantics are held in their plain version.

Tolerances: ≤ 1e-6 of max against the JAX package and the float64 oracle,
and streamed against resident in the port (the two sum the atoms in other
blocks); peaks bin for bin.  The streamed DOS sums the same atom chunks as
the resident one and must equal it exactly.
"""
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.core import streaming as jstream
from psa_tpu.models import make_chain_trajectory, make_random_crystal_trajectory
from psa_tpu.ops import spectral as jspec
from psa_tpu_torch import TrajectoryLoader, sed_from_dump_streaming
from psa_tpu_torch.core import calculator as tcalc
from psa_tpu_torch.core import streaming as tstream
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import sed_projection as tproj
from psa_tpu_torch.ops import spectral as tspec
from psa_tpu_torch.utils.transfer import DeviceToHost, HostToDevice, copy_rows

from conftest import reference_sed_oracle

torch.set_num_threads(1)

TOL = 1e-6          # of max
TINY = 1000         # bytes: every group streams
N_T, DT = 16, 0.02


def of_max(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope='module')
def crystal():
    traj = make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2, n_frames=N_T,
                                          dt_ps=DT, seed=11)
    traj.masses = np.random.default_rng(2).uniform(1.0, 30.0, traj.n_atoms)
    return traj


@pytest.fixture(scope='module')
def kv(crystal):
    return JaxCalculator(crystal, nx=3, ny=2, nz=2).get_k_grid('xy', (-1, 1), (-1, 1), 5, 4)[1]


def trio(traj, **kw):
    """(JAX streamed, port streamed, port resident) calculators."""
    ref = JaxCalculator(traj, nx=3, ny=2, nz=2, max_device_bytes=TINY, **kw)
    port = from_reference_calculator(ref, device='cpu')
    resident = from_reference_calculator(ref, device='cpu')
    resident.max_device_bytes = int(1e9)
    return ref, port, resident


# ---------------------------------------------------------------------------
# the kernel interface: out= and accumulate=, plain version
# ---------------------------------------------------------------------------

def problem(n_t=6, n_a=30, n_k=9, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_t, n_a, 3)).astype(np.float32)
    hi, lo = jspec.split_f64(rng.uniform(0, 30.0, size=(n_a, 3)))
    return data, hi, lo, rng.uniform(-2, 2, size=(n_k, 3)).astype(np.float32)


def test_out_writes_given_tensors():
    data, hi, lo, kv = problem()
    want = tproj.sed_projection(t(data), t(hi), t(lo), t(kv))
    out = (torch.full((6, 3, 9), 7.0), torch.full((6, 3, 9), 7.0))
    got = tproj.sed_projection(t(data), t(hi), t(lo), t(kv), out=out)
    assert got[0] is out[0] and got[1] is out[1]
    for g, w in zip(out, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_accumulate_over_atom_halves_equals_whole():
    data, hi, lo, kv = problem(n_a=41)
    whole = tproj.sed_projection(t(data), t(hi), t(lo), t(kv))
    out = tproj.sed_projection(t(data[:, :20]), t(hi[:20]), t(lo[:20]), t(kv))
    out = tproj.sed_projection(t(data[:, 20:]), t(hi[20:]), t(lo[20:]), t(kv), out=out,
                               accumulate=True)
    scale = max(float(w.abs().max()) for w in whole)
    assert max(float((g - w).abs().max()) for g, w in zip(out, whole)) / scale < TOL


def test_out_row_slices_of_one_signal():
    """Time blocks written into row slices equal one projection of all frames."""
    data, hi, lo, kv = problem(n_t=11)
    whole = tproj.sed_projection(t(data), t(hi), t(lo), t(kv))
    sig = (torch.empty(11, 3, 9), torch.empty(11, 3, 9))
    for i in range(0, 11, 4):
        tproj.sed_projection(t(data[i:i + 4]), t(hi), t(lo), t(kv),
                             out=(sig[0][i:i + 4], sig[1][i:i + 4]))
    for g, w in zip(sig, whole):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize('bad', ['shape', 'dtype', 'strided', 'one', 'accumulate_alone'])
def test_out_validation(bad):
    data, hi, lo, kv = problem()
    out = [torch.zeros(6, 3, 9), torch.zeros(6, 3, 9)]
    kw = dict(out=tuple(out))
    if bad == 'shape':
        kw['out'] = (torch.zeros(6, 3, 8), out[1])
    elif bad == 'dtype':
        kw['out'] = (out[0].double(), out[1])
    elif bad == 'strided':
        kw['out'] = (torch.zeros(6, 3, 18)[..., ::2], out[1])
    elif bad == 'one':
        kw['out'] = (out[0],)
    else:
        kw = dict(accumulate=True)
    with pytest.raises(ValueError):
        tproj.sed_projection(t(data), t(hi), t(lo), t(kv), **kw)


def test_streamed_projections_match_jax_streamed_spectrum(crystal, kv):
    """The calculator's atom-block accumulation, the port's one streaming
    loop, against the JAX package's sed_spectrum_streamed on the same blocks
    (ragged: 24 atoms in blocks of 5)."""
    _, port, _ = trio(crystal)
    port.max_device_bytes = 4000
    block = port.stream_block_atoms(crystal.n_atoms)
    assert block == 5 and port._oversize(np.arange(crystal.n_atoms))
    outs = port._streamed_projections(np.arange(crystal.n_atoms), [t(kv[:7]), t(kv[7:])])
    got = np.concatenate([tspec.finalize_spectrum(*o).numpy() for o in outs], axis=1)
    # the JAX form takes equal blocks: zero-pad the last (zero data adds nothing)
    hi, lo = jspec.split_f64(port.mean_positions64)
    pad = lambda x: np.concatenate([x, np.zeros((block - x.shape[0],) + x.shape[1:], x.dtype)])
    starts = range(0, crystal.n_atoms, block)
    data = [pad(crystal.velocities[:, a:a + block].swapaxes(0, 1)).swapaxes(0, 1) for a in starts]
    re, im = jspec.sed_spectrum_streamed(data, [(pad(hi[a:a + block]), pad(lo[a:a + block]))
                                                for a in starts], kv, N_T)
    assert of_max(got, np.asarray(re) + 1j * np.asarray(im)) < TOL


# ---------------------------------------------------------------------------
# SEDCalculator surfaces on a group over max_device_bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['coherent', 'incoherent', 'displacements', 'mass_weighted',
                                  'index_groups'])
def test_calculate_streamed(crystal, kv, case):
    calc_kw = {'displacements': dict(use_displacements=True),
               'mass_weighted': dict(mass_weighted=True)}.get(case, {})
    kw = {'incoherent': dict(summation_mode='incoherent', basis_atom_types=[1, 2]),
          'index_groups': dict(basis_atom_indices=[[0, 3, 5, 9, 2], [11, 12, 13]])}.get(case, {})
    ref, port, resident = trio(crystal, **calc_kw)
    before = tproj.kernel_launches()
    got = port.calculate(np.zeros(len(kv)), kv, k_chunk_size=7, **kw)
    assert tproj.kernel_launches() == before           # the CPU runs the plain version
    assert port.streamed_bytes > 0 and resident.calculate(
        np.zeros(len(kv)), kv, k_chunk_size=7, **kw) is not None and resident.streamed_bytes == 0
    want = ref.calculate(np.zeros(len(kv)), kv, k_chunk_size=7, **kw)
    res = resident.calculate(np.zeros(len(kv)), kv, k_chunk_size=7, **kw)
    assert got.is_complex == want.is_complex == (case != 'incoherent')
    assert of_max(got.sed, want.sed) < TOL
    assert of_max(got.sed, res.sed) < TOL
    if case in ('coherent', 'displacements'):
        orc = reference_sed_oracle(crystal, kv, use_displacements=case == 'displacements')
        assert of_max(got.sed, orc) < TOL


def test_stream_passes_and_bytes(crystal, kv):
    """One pass feeds every chunk's accumulator from each block: the group
    crosses once; a budget of one chunk per pass crosses it once per chunk.
    (The two budgets also cut other atom blocks, hence the tolerance.)"""
    _, port, _ = trio(crystal)
    group_bytes = 4 * crystal.n_frames * crystal.n_atoms * 3
    few = port.calculate(np.zeros(4), kv[:4], k_chunk_size=2)
    assert port.streamed_bytes == 2 * group_bytes          # 4 k in chunks of 2: 2 passes
    port.streamed_bytes = 0
    port.max_device_bytes = group_bytes - 4                # half of it holds both chunks
    one = port.calculate(np.zeros(4), kv[:4], k_chunk_size=2)
    assert port.streamed_bytes == group_bytes
    assert of_max(one.sed, few.sed) < TOL


def test_stream_block_size(crystal):
    _, port, _ = trio(crystal)
    assert port.stream_block_atoms(crystal.n_atoms) == 1
    port.max_device_bytes = int(8e9)
    assert port.stream_block_atoms(10 ** 8) == tcalc.STREAM_BLOCK_BYTES // (12 * N_T)


def test_streamed_memmap_trajectory(tmp_path, crystal, kv):
    """A trajectory memory-mapped from the .npy cache streams from disk."""
    from psa_tpu_torch.io.writer import out_to_qdump
    dump = tmp_path / "c.dump"
    out_to_qdump(str(dump), crystal.positions, crystal.types, crystal.box_matrix)
    TrajectoryLoader(str(dump), dt=DT, unwrap=False).load()
    traj = TrajectoryLoader(str(dump), dt=DT, unwrap=False, mmap=True).load()
    assert isinstance(traj.positions, np.memmap)
    calc = tcalc.SEDCalculator(traj, 3, 2, 2, use_displacements=True, max_device_bytes=TINY,
                               device='cpu')
    whole = tcalc.SEDCalculator(traj, 3, 2, 2, use_displacements=True, device='cpu')
    assert of_max(calc.calculate(np.zeros(len(kv)), kv).sed,
                  whole.calculate(np.zeros(len(kv)), kv).sed) < TOL


@pytest.mark.parametrize('kw', [dict(), dict(summation_mode='incoherent', basis_atom_types=[1, 2]),
                                dict(chiral=True), dict(welch_segments=2),
                                dict(readback_dtype='float16'), dict(max_freq=10.0)])
def test_browse_streamed(crystal, kv, kw):
    ref, port, resident = trio(crystal)
    got = port.calculate_kgrid_browse(kv, k_chunk_size=7, **kw)
    want = ref.calculate_kgrid_browse(kv, k_chunk_size=7, **kw)
    res = resident.calculate_kgrid_browse(kv, k_chunk_size=7, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(want[0], np.float32))
    tol = 2.0 ** -9 if kw.get('readback_dtype') == 'float16' else TOL
    assert of_max(got[1], want[1]) < tol and of_max(got[1], res[1]) < tol
    if kw.get('chiral'):
        bright = got[1] >= 1e-6 * got[1].max()
        assert np.max(np.abs(got[2] - want[2])[bright]) < 1e-5


def test_lt_and_welch_streamed(crystal, kv):
    ref, port, resident = trio(crystal)
    for name, call in (('lt', lambda c: c.calculate_lt(kv, k_chunk_size=7)[1:]),
                       ('welch', lambda c: (c.calculate_welch(np.zeros(len(kv)), kv, 2,
                                                              k_chunk_size=7).sed,))):
        got, want, res = call(port), call(ref), call(resident)
        for g, w, r in zip(got, want, res):
            assert of_max(g, w) < TOL and of_max(g, r) < TOL, name


@pytest.mark.parametrize('kw', [dict(), dict(width_method='lorentzian'),
                                dict(summation_mode='incoherent', basis_atom_types=[1, 2])])
def test_peaks_streamed(crystal, kv, kw):
    ref, port, resident = trio(crystal)
    got = port.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=7, **kw)
    want = ref.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=7, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert of_max(got[1], want[1]) < TOL
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)
    res = resident.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=7, **kw)
    np.testing.assert_array_equal(got[0], res[0])


@pytest.mark.parametrize('call', ['browse_chiral_welch', 'peaks_chiral'])
def test_streamed_chiral_matches_resident(crystal, kv, call):
    """Chiral Welch planes and chiral peaks of a streamed group (the JAX
    package raises for both) equal the resident ones of either package."""
    ref, port, resident = trio(crystal)
    run = {'browse_chiral_welch': lambda c: c.calculate_kgrid_browse(
               kv, k_chunk_size=7, chiral=True, welch_segments=2)[1:],
           'peaks_chiral': lambda c: c.calculate_kgrid_peaks(
               kv, n_peaks=2, k_chunk_size=7, chiral=True)}[call]
    with pytest.raises(ValueError, match="device-resident"):
        run(ref)
    got = run(port)
    assert port.streamed_bytes > 0
    for want in (run(resident), run(JaxCalculator(crystal, nx=3, ny=2, nz=2))):
        if call == 'peaks_chiral':
            np.testing.assert_array_equal(got[0], want[0])
            assert of_max(got[1], want[1]) < TOL
            np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)
        else:
            assert of_max(got[0], want[0]) < TOL
            bright = got[0] >= 1e-6 * got[0].max()
            assert np.max(np.abs(got[1] - np.asarray(want[1]))[bright]) < 1e-5


@pytest.mark.parametrize('case', ['all_atoms', 'types', 'displacements', 'mass_weighted',
                                  'max_freq'])
def test_dos_matches_jax_and_resident(crystal, case):
    calc_kw = {'displacements': dict(use_displacements=True),
               'mass_weighted': dict(mass_weighted=True)}.get(case, {})
    kw = {'types': dict(basis_atom_types=[1, 2]), 'max_freq': dict(max_freq=12.0)}.get(case, {})
    ref, port, resident = trio(crystal, **calc_kw)
    got = port.calculate_dos(atom_chunk_size=5, **kw)
    want = ref.calculate_dos(atom_chunk_size=5, **kw)
    res = resident.calculate_dos(atom_chunk_size=5, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].shape == want[1].shape and of_max(got[1], want[1]) < TOL
    np.testing.assert_array_equal(got[1], res[1])
    if case == 'all_atoms':
        v = crystal.velocities.astype(np.float64)
        orc = (np.abs(np.fft.fft(v, axis=0) / N_T) ** 2).sum(axis=(1, 2))[:N_T // 2]
        assert of_max(got[1][0], orc) < TOL


def test_dos_validation(crystal):
    _, port, _ = trio(crystal)
    with pytest.raises(ValueError, match="max_freq"):
        port.calculate_dos(max_freq=-1.0)


# ---------------------------------------------------------------------------
# sed_from_dump_streaming
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "s.dump"
    traj = make_chain_trajectory(n_cells=12, n_frames=50, dt_ps=0.02)
    with open(path, "w") as f:
        for step in range(traj.n_frames):
            f.write(f"ITEM: TIMESTEP\n{step}\nITEM: NUMBER OF ATOMS\n{traj.n_atoms}\n"
                    "ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                f.write(f"0.0 {traj.box_matrix[d, d]:.6f}\n")
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            for a in range(traj.n_atoms):
                p, v = traj.positions[step, a], traj.velocities[step, a]
                f.write(f"{a + 1} 1 {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
    return path


@pytest.fixture(scope='module')
def kpath():
    return np.outer(np.linspace(0, 1.2, 7), [1, 0, 0]).astype(np.float32)


@pytest.mark.parametrize('source', ['native', 'iterator'])
@pytest.mark.parametrize('disp', [False, True])
def test_dump_streaming_matches_jax(dump, kpath, monkeypatch, source, disp):
    if source == 'iterator':
        monkeypatch.setattr(tstream, '_open_mmap_source', lambda p: None)
        monkeypatch.setattr(jstream, '_open_mmap_source', lambda p: None)
    kw = dict(dt_ps=0.02, k_vectors=kpath, frame_chunk=16, use_displacements=disp,
              k_points_mags=np.linalg.norm(kpath, axis=1))
    got = sed_from_dump_streaming(dump, device='cpu', **kw)
    want = jstream.sed_from_dump_streaming(dump, **kw)
    assert got.sed.shape == (50, 7, 3) and got.sed.dtype == np.complex64
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert of_max(got.sed, want.sed) < TOL


def test_dump_streaming_matches_loaded_calculate(dump, kpath):
    """The dump streamed equals calculate on the same dump loaded whole."""
    traj = TrajectoryLoader(str(dump), dt=0.02, unwrap=False).load()
    calc = tcalc.SEDCalculator(traj, nx=12, ny=1, nz=1, device='cpu')
    whole = calc.calculate(np.zeros(len(kpath)), kpath)
    streamed = sed_from_dump_streaming(dump, 0.02, kpath, frame_chunk=16, device='cpu')
    assert of_max(streamed.sed, whole.sed) < TOL
    pre = sed_from_dump_streaming(dump, 0.02, kpath, frame_chunk=13, device='cpu',
                                  mean_pos64=calc.mean_positions64)
    assert of_max(pre.sed, whole.sed) < TOL


def test_dump_streaming_hands_the_kernel_contiguous_tensors(dump, kpath, monkeypatch):
    """Column-major ``mean_pos64`` (what np.mean gives for a column-major
    trajectory) and k-vectors reach the projection C-contiguous: the CUDA
    kernel refuses anything else."""
    traj = TrajectoryLoader(str(dump), dt=0.02, unwrap=False).load()
    mean64 = np.asfortranarray(traj.positions.astype(np.float64).mean(axis=0))
    real = tstream.sed_projection

    def strict(*args, **kw):
        assert all(a.is_contiguous() for a in args)
        return real(*args, **kw)
    monkeypatch.setattr(tstream, 'sed_projection', strict)
    got = sed_from_dump_streaming(dump, 0.02, np.asfortranarray(kpath), frame_chunk=16,
                                  device='cpu', mean_pos64=mean64)
    want = sed_from_dump_streaming(dump, 0.02, kpath, frame_chunk=16, device='cpu')
    assert of_max(got.sed, want.sed) < TOL


def test_dump_streaming_no_velocities_raises(tmp_path):
    path = tmp_path / "nv.dump"
    with open(path, "w") as f:
        for step in range(3):
            f.write(f"ITEM: TIMESTEP\n{step}\nITEM: NUMBER OF ATOMS\n2\n"
                    "ITEM: BOX BOUNDS pp pp pp\n0 5\n0 5\n0 5\n"
                    "ITEM: ATOMS id type x y z\n1 1 0 0 0\n2 1 1 0 0\n")
    with pytest.raises(ValueError, match="velocity"):
        sed_from_dump_streaming(path, 0.01, np.ones((2, 3), np.float32), device='cpu')


def test_dump_streaming_device_defaults_to_cuda(dump, kpath, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sed_from_dump_streaming(dump, 0.02, kpath)


# ---------------------------------------------------------------------------
# transfers on the CPU: hand-over as is
# ---------------------------------------------------------------------------

def test_transfers_on_cpu_hand_over():
    src = np.arange(24, dtype=np.float64).reshape(2, 4, 3)
    stager = HostToDevice(torch.device('cpu'), 24)
    block = stager.put(lambda dst: copy_rows(dst, src[:, 1:3]), (2, 2, 3))
    assert block.dtype == torch.float32 and stager.bytes_moved == 48
    np.testing.assert_array_equal(block.numpy(), src[:, 1:3])
    with pytest.raises(ValueError, match="staging"):
        stager.put(lambda dst: None, (5, 5, 3))
    seen = []
    readback = DeviceToHost(torch.device('cpu'))
    readback.push([block], lambda arrays: seen.append(arrays[0].copy()))
    readback.finish()
    np.testing.assert_array_equal(seen[0], src[:, 1:3])


def test_copy_rows_threads_match_numpy():
    """A 23 MB float32 block copies on the thread pool, from a source
    strided as an atom block of a trajectory is."""
    src = np.random.default_rng(0).normal(size=(64, 40000, 3))[:, 5:30005]
    got = np.empty(src.shape, np.float32)
    copy_rows(got, src)
    np.testing.assert_array_equal(got, src.astype(np.float32))

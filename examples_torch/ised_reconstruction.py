"""iSED: reconstruct the real-space atomic motion of one (k, ω) mode.

The mode of a synthetic chain nearest k = 0.8 (2π/Å), ν = 8 THz is
reconstructed and written as a LAMMPS dump animation (open it in OVITO),
with a spectrum figure marking the target where matplotlib is installed.

Run:  python examples_torch/ised_reconstruction.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.models import make_chain_trajectory

N_CELLS, A0, OMEGA_MAX, N_RECON = 48, 2.5, 10.0, 100


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)
    traj = make_chain_trajectory(n_cells=N_CELLS, n_frames=512, dt_ps=0.02,
                                 a=A0, omega_max_thz=OMEGA_MAX)
    calc = SEDCalculator(traj, nx=N_CELLS, ny=1, nz=1, device=dev)

    dump = out / "ised_motion.dump"
    calc.ised(k_dir_spec='x', k_target=0.8, w_target=8.0, char_len_k_path=A0,
              nk_on_path=N_CELLS // 2 + 1, bz_cov_ised=0.5,
              rescale_factor='auto', n_recon_frames=N_RECON,
              dump_filepath=str(dump),
              plot_dir_ised=out if figures() else None, plot_max_freq=12.0)
    n_frames = dump.read_text().count("ITEM: TIMESTEP")
    check(n_frames == N_RECON, f"{n_frames} frames in {dump}, expected {N_RECON}")
    print(f"outputs in {out}/ (ised_motion.dump + iSED_*.png)")
    return {'dump': dump}


if __name__ == "__main__":
    main(**parse_args(__doc__))

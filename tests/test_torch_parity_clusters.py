"""The 'parity' kernel's tiles as its wrapper counts them.

``csrc/sed_projection.cu`` runs one block per output tile of BT time steps
by BK k-points, in clusters of CL blocks that own CL consecutive time tiles
of one k-tile and make that k-tile's angle tile once among them.  At each
launch the wrapper adds the tiles whose products run to
``parity.time_tiles`` and the angle tiles made, one per cluster, to
``parity.angle_tiles`` (``ops/sed_projection.parity_tiles``); the kernel
pads the time tiles up to whole clusters.  The CPU runs the plain version
and counts nothing.
"""
import re
from pathlib import Path

import pytest
import torch

from psa_tpu_torch.ops import sed_projection as tproj
from psa_tpu_torch.utils.profiling import counted_since, snapshot

KERNEL = Path(__file__).resolve().parents[1] / 'psa_tpu_torch' / 'csrc' / 'sed_projection.cu'
SHAPES = [(1, 1), (64, 32), (65, 33), (129, 1), (10_000, 500), (10_016, 2_048),
          (20_000, 2_500), (100, 4_097)]


def kernel_constant(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', KERNEL.read_text()).group(1))


def enumerated(n_t, n_k):
    """(tiles, clusters) counted one by one: every (time tile, k-tile) the
    kernel multiplies, and the distinct (cluster of time tiles, k-tile)
    pairs among them."""
    tiles = [(t // tproj.PARITY_T, k // tproj.PARITY_K)
             for t in range(0, n_t, tproj.PARITY_T) for k in range(0, n_k, tproj.PARITY_K)]
    return len(tiles), len({(tt // tproj.PARITY_CLUSTER, kk) for tt, kk in tiles})


def test_the_tiles_are_the_kernels():
    assert (tproj.PARITY_T, tproj.PARITY_K, tproj.PARITY_CLUSTER) == tuple(
        kernel_constant(name) for name in ('BT', 'BK', 'CL'))


@pytest.mark.parametrize('n_t, n_k', SHAPES)
def test_parity_tiles_count_each_tile_and_each_cluster(n_t, n_k):
    assert tproj.parity_tiles(n_t, n_k) == enumerated(n_t, n_k)


@pytest.mark.parametrize('n_t, n_k', SHAPES)
def test_time_tiles_are_padded_to_whole_clusters(n_t, n_k):
    time_tiles, angle_tiles = tproj.parity_tiles(n_t, n_k)
    grid_k = -(-n_k // tproj.PARITY_K)
    padded = angle_tiles * tproj.PARITY_CLUSTER - time_tiles     # blocks that multiply nothing
    assert 0 <= padded < tproj.PARITY_CLUSTER * grid_k and padded % grid_k == 0


@pytest.mark.parametrize('n_t', [1, 17, 64])
def test_one_time_tile_makes_one_angle_tile_per_k_tile(n_t):
    assert tproj.parity_tiles(n_t, 65) == (3, 3)


def test_the_working_chunk_shares_each_angle_tile():
    # 157 time tiles by 16 k-tiles; clusters of CL time tiles, the last one padded
    time_tiles, angle_tiles = tproj.parity_tiles(10_000, 500)
    assert time_tiles == 157 * 16
    assert angle_tiles == -(-157 // tproj.PARITY_CLUSTER) * 16


def test_a_cpu_call_counts_no_tiles():
    before = snapshot()
    for precision in ('parity', 'balanced'):
        tproj.sed_projection(torch.ones((70, 5, 3)), torch.zeros((5, 3)), torch.zeros((5, 3)),
                             torch.ones((33, 3)), precision=precision)
    assert counted_since(before) == {}

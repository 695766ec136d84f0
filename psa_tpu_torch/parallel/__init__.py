"""Multi-device sweeps over a (t, a, k) mesh: the mesh, the block sources,
the sharded SED, the instantaneous-phase family and time correlation, and
the process group (counterpart of :mod:`psa_tpu.parallel`)."""
from .distributed import global_mesh_info, initialize_cluster
from .sharded import (ArrayBlockSource, BlockSource, DumpBlockSource, Mesh,
                      TiledBlockSource, make_mesh, mesh_shape_for, rdf_sweep_step,
                      sharded_dsf, sharded_dsf_self, sharded_isf, sharded_isf_self,
                      sharded_sed_spectrum, sharded_sk, sharded_timecorr)

__all__ = ["ArrayBlockSource", "BlockSource", "DumpBlockSource", "Mesh",
           "TiledBlockSource", "global_mesh_info", "initialize_cluster", "make_mesh",
           "mesh_shape_for", "rdf_sweep_step", "sharded_dsf", "sharded_dsf_self",
           "sharded_isf", "sharded_isf_self", "sharded_sed_spectrum", "sharded_sk",
           "sharded_timecorr"]

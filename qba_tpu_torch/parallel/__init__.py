"""Device-mesh parallelism — counterpart of :mod:`qba_tpu.parallel`:
trials over ``dp`` (:func:`run_trials_sharded`), lieutenants over ``tp``
(:func:`run_trials_spmd`, the party-sharded round engine), list
positions over ``sp``."""

from qba_tpu_torch.parallel.mesh import Mesh, default_mesh_shape, make_mesh
from qba_tpu_torch.parallel.montecarlo import run_trials_sharded
from qba_tpu_torch.parallel.spmd import run_trials_spmd

__all__ = [
    "Mesh",
    "default_mesh_shape",
    "make_mesh",
    "run_trials_sharded",
    "run_trials_spmd",
]

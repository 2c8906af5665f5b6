"""Fleet-scale atlas campaigns: the 4-D QBA validity phase diagram — the
counterpart of :mod:`qba_tpu.atlas` on the port.

The campaign driver (:mod:`~qba_tpu_torch.atlas.campaign`) enumerates
the (parties × dishonest × strategy × noise) cube
(:mod:`~qba_tpu_torch.atlas.cube`), prices every cell through the fleet
admission controller, steers trial budget toward the validity threshold
frontier (:mod:`~qba_tpu_torch.atlas.steer`), and fills a
content-addressed store of certified per-cell records
(:mod:`~qba_tpu_torch.atlas.store`) that
:func:`~qba_tpu_torch.atlas.render.render_atlas` turns into the phase
diagram.  Records, ledgers and digests are the JAX package's, so stores
written by either package read the same.
"""

from qba_tpu_torch.atlas.campaign import (
    CampaignDriver,
    FleetExecutor,
    LocalExecutor,
)
from qba_tpu_torch.atlas.cube import AtlasCell, CampaignSpec, enumerate_cells
from qba_tpu_torch.atlas.render import plot_slices, render_atlas
from qba_tpu_torch.atlas.steer import frontier_plan, is_frontier
from qba_tpu_torch.atlas.store import (
    AtlasStore,
    cell_key,
    cell_slug,
    record_satisfies,
)

__all__ = [
    "AtlasCell",
    "AtlasStore",
    "CampaignDriver",
    "CampaignSpec",
    "FleetExecutor",
    "LocalExecutor",
    "cell_key",
    "cell_slug",
    "enumerate_cells",
    "frontier_plan",
    "is_frontier",
    "plot_slices",
    "record_satisfies",
    "render_atlas",
]

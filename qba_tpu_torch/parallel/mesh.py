"""Device meshes — counterpart of :mod:`qba_tpu.parallel.mesh`.

A :class:`Mesh` names the axes of an array of ``torch.device``s: ``dp``
splits the trials, ``tp`` the lieutenants (the party-sharded round
engine, :mod:`qba_tpu_torch.parallel.spmd`), ``sp`` the list positions.
One process drives every device of the mesh, as ``shard_map`` does.  A
device may appear more than once: ``[torch.device("cuda", 0)] * 4``
lays four shards on one card (the counterpart of the virtual CPU devices
the JAX tests use), and ``[torch.device("cpu")] * n`` is the plain path.
The multi-slice (DCN) meshes wait for ROADMAP A12b.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object ndarray of ``torch.device`` shaped by the
    axis sizes; ``axis_names``: one name per axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return axis_sizes(self)


def make_mesh(
    axes: Mapping[str, int] | None = None,
    *,
    devices: Sequence | None = None,
) -> Mesh:
    """Build a named device mesh.

    Args:
      axes: ordered ``{axis_name: size}``.  Sizes must multiply to the
        device count used.  ``None`` means a 1-D ``{"dp": n_devices}``
        mesh.
      devices: devices to lay out (default: every visible CUDA device;
        raises when there is none).  Entries may repeat one device.
    """
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device (devices=None means every "
                "visible CUDA device); pass devices, e.g. "
                "[torch.device('cpu')] * n"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if axes is None:
        axes = {"dp": len(devices)}
    sizes = list(axes.values())
    total = math.prod(sizes)
    if total != len(devices):
        raise ValueError(
            f"mesh axes {dict(axes)} need {total} devices; got {len(devices)}"
        )
    dev_array = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        dev_array[i] = d
    return Mesh(dev_array.reshape(sizes), tuple(axes.keys()))


def axis_sizes(mesh: Mesh) -> dict[str, int]:
    """``{axis_name: size}`` for a mesh (shared by every runner)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def require_divisible(total: int, divisor: int, what: str, axis: str) -> None:
    """Raise the runners' standard sharding-divisibility error."""
    if total % divisor != 0:
        raise ValueError(f"{what}={total} not divisible by {axis}={divisor}")


def dp_devices(mesh: Mesh) -> list[torch.device]:
    """The device that runs each ``dp`` index's trials: the first device
    of that index's row of every other axis (which only replicates)."""
    names = mesh.axis_names
    devs = mesh.devices
    if "dp" in names:
        devs = np.moveaxis(devs, names.index("dp"), 0)
    else:
        devs = devs[None]
    return list(devs.reshape(devs.shape[0], -1)[:, 0])


def default_mesh_shape(n_devices: int, *, want_tp: bool = False) -> dict[str, int]:
    """A reasonable 2-D factorization of ``n_devices``.

    ``want_tp=False`` → ``{"dp": d, "sp": s}`` (Monte-Carlo + position
    sharding); ``want_tp=True`` → ``{"dp": d, "tp": s}`` (party-sharded
    round engine).  The second axis gets the largest power-of-two factor
    ≤ ``sqrt(n_devices)`` so both axes stay useful.
    """
    second = 1
    while second * 2 <= math.isqrt(n_devices) and n_devices % (second * 2) == 0:
        second *= 2
    name = "tp" if want_tp else "sp"
    return {"dp": n_devices // second, name: second}

"""Device meshes of the fused multi-device path (``parallel/mesh.py:41-97``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets
XLA place shards and insert collectives from sharding annotations. The port
keeps the mesh, one controller process over a numpy array of
``torch.device``, and makes the rest explicit:

- **placement**: a sharded operand is the list of its shards, each ``.to()``
  its device (``parallel/sharded.py``);
- **reductions**: a cross-shard reduction copies the shards to the lane's
  first device and combines them there in a fixed order.

So the JAX ``sharding()`` and ``constrain()`` have no counterpart here.

Axis convention, as in the JAX package:

- ``scene``: data parallelism over scenes, one scene lane per slot;
- ``frame``: the RGB-D frames of a scene split over devices; the
  association of a frame needs no other frame;
- ``point`` (``cfg.point_shards > 1``): the scene cloud and the (F, N)
  claim planes split by columns; the graph's co-occurrence counts are
  summed from per-shard partial counts, exact integers in any order.

A device list may repeat a device (``["cpu"] * 8`` in the tests,
``[cuda:0] * 2`` on a one-card machine): the shard-and-reduce code then runs
on one device, with real partial counts.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import resolve_device

# a 2-tuple shape is (scene, frame), a 3-tuple adds the trailing point axis
MESH_AXIS_NAMES: Tuple[str, ...] = ("scene", "frame", "point")


class Mesh:
    """A numpy array of ``torch.device`` with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({mesh_label(self.devices.shape)}, {list(self.axis_names)})"


def default_devices() -> list:
    """Every visible CUDA card; raises, as ``resolve_device`` does, without one."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Optional[Tuple[str, ...]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh over ``devices`` (default: every visible card).

    With ``shape=None`` every device lands on the last axis; a leading
    ``scene`` axis of size 1 keeps the layout uniform. ``axis_names=None``
    resolves from the axis ladder by rank: a 2-tuple shape is ``(scene,
    frame)``, a 3-tuple ``(scene, frame, point)``.
    """
    devices = [torch.device(d) for d in (devices if devices is not None
                                          else default_devices())]
    n = len(devices)
    if axis_names is None:
        rank = len(shape) if shape is not None else 2
        if not (1 <= rank <= len(MESH_AXIS_NAMES)):
            raise ValueError(f"mesh shape {shape} has rank {rank}; the "
                             f"axis ladder is {MESH_AXIS_NAMES}")
        axis_names = MESH_AXIS_NAMES[:rank]
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), axis_names)


def mesh_label(shape: Tuple[int, ...]) -> str:
    """``SxF`` / ``SxFxP`` label of a mesh shape, the string ``digest_coord``
    stamps."""
    return "x".join(str(int(d)) for d in shape)


def point_spec(mesh: Optional[Mesh]) -> Optional[str]:
    """``"point"`` when the mesh carries a point axis, else None."""
    if mesh is not None and "point" in mesh.axis_names:
        return "point"
    return None


def point_axis_size(mesh: Optional[Mesh]) -> int:
    """Size of the mesh's point axis (1 when absent: unsharded points)."""
    if mesh is not None and "point" in mesh.axis_names:
        return int(mesh.shape["point"])
    return 1

"""The fused multi-device path: a mesh of ``torch.device`` driven by one
controller process (counterpart of ``maskclustering_tpu/parallel``). The JAX
``sharding`` and ``constrain`` have no counterpart: placement is explicit."""

from maskclustering_tpu_torch.parallel.batch import cluster_scene_batch, fused_scene_objects
from maskclustering_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_label,
    point_axis_size,
    point_spec,
)
from maskclustering_tpu_torch.parallel.sharded import (
    FusedStepResult,
    build_fused_step,
    fused_step_example_args,
)

__all__ = [
    "cluster_scene_batch",
    "fused_scene_objects",
    "make_mesh",
    "mesh_label",
    "point_axis_size",
    "point_spec",
    "FusedStepResult",
    "build_fused_step",
    "fused_step_example_args",
]

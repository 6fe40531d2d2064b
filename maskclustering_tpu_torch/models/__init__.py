from maskclustering_tpu_torch.models.clustering import ClusterResult, iterative_clustering
from maskclustering_tpu_torch.models.exact_backprojection import (
    SceneAssociation,
    associate_scene_exact,
)
from maskclustering_tpu_torch.models.graph import (
    GraphStats,
    MaskTable,
    build_mask_table,
    compute_graph_stats,
)
from maskclustering_tpu_torch.models.pipeline import SceneResult, run_scene
from maskclustering_tpu_torch.models.postprocess import (
    SceneObjects,
    export_artifacts,
    postprocess_scene,
)

__all__ = [
    "ClusterResult",
    "iterative_clustering",
    "SceneAssociation",
    "associate_scene_exact",
    "GraphStats",
    "MaskTable",
    "build_mask_table",
    "compute_graph_stats",
    "SceneResult",
    "run_scene",
    "SceneObjects",
    "export_artifacts",
    "postprocess_scene",
]

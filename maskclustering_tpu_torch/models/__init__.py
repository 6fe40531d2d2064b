from maskclustering_tpu_torch.models.backprojection import (
    FrameAssociation,
    SceneAssociation,
    associate_frame,
    associate_scene,
)
from maskclustering_tpu_torch.models.clustering import ClusterResult, iterative_clustering
from maskclustering_tpu_torch.models.exact_backprojection import associate_scene_exact
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
from maskclustering_tpu_torch.models.postprocess_device import (
    PostprocessCapacityError,
    postprocess_scene_device,
    run_postprocess,
)
from maskclustering_tpu_torch.models.streaming import (
    StaleChunkAttempt,
    StreamAccumulator,
    slice_scene_frames,
    stream_scene,
    stream_state_path,
)

__all__ = [
    "FrameAssociation",
    "SceneAssociation",
    "associate_frame",
    "associate_scene",
    "ClusterResult",
    "iterative_clustering",
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
    "PostprocessCapacityError",
    "postprocess_scene_device",
    "run_postprocess",
    "StaleChunkAttempt",
    "StreamAccumulator",
    "slice_scene_frames",
    "stream_scene",
    "stream_state_path",
]

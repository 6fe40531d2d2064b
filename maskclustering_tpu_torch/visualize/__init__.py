"""Visualisation and debug images (``maskclustering_tpu/visualize/``).

Host-side artifact writers plus one hot op, the z-buffered splat of an
object into a frame (``top_images.project_zbuffer``) and the box of its
pixels in each of its frames (``top_images.bboxes_by_projection``, one
launch an object), which launch the hand-written kernels of
``ops/cuda/splat.cu`` on the card. Every file is written through the port's own PNG and PLY writers, byte for byte what
the JAX package writes (the label glyphs of ``vis_mask_frame`` aside).
"""

from maskclustering_tpu_torch.visualize.scene import (  # noqa: F401
    instance_palette,
    vis_scene,
)
from maskclustering_tpu_torch.visualize.mask2d import (  # noqa: F401
    colorize_id_map,
    create_colormap,
    vis_mask_frame,
    frames_to_gif,
)
from maskclustering_tpu_torch.visualize.top_images import (  # noqa: F401
    project_zbuffer,
    bbox_by_projection,
    bboxes_by_projection,
    draw_bbox,
    save_debug_grids,
)
from maskclustering_tpu_torch.visualize.debug_viewers import (  # noqa: F401
    compare_mask_dirs,
    depth_preview,
    fused_cloud_preview,
)

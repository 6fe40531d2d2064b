"""Host I/O of the scan layouts: the port's PNG codec, images, PLY clouds
and the compact device feed (counterpart of ``maskclustering_tpu/io``)."""

from maskclustering_tpu_torch.io.image import (
    read_depth_png,
    read_mask_png,
    read_rgb,
    resize_nearest,
    write_depth_png,
    write_mask_png,
)
from maskclustering_tpu_torch.io.ply import read_ply_mesh, read_ply_points, write_ply_points
from maskclustering_tpu_torch.io.png import png_size, read_png, write_png

__all__ = [
    "read_depth_png",
    "read_mask_png",
    "read_rgb",
    "resize_nearest",
    "write_depth_png",
    "write_mask_png",
    "read_ply_mesh",
    "read_ply_points",
    "write_ply_points",
    "png_size",
    "read_png",
    "write_png",
]

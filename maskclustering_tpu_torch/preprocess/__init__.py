"""L0 preprocessing: raw dataset downloads -> processed scene dirs + GT txt
(counterpart of ``maskclustering_tpu/preprocess``, with its exports).

Host code, as in the JAX package: it never touches the card. Each module
writes the bytes the JAX module writes, without PIL or cv2: colour frames
through the port's libjpeg-equal JPEG encoder (``io/jpeg.py``) and
Pillow-equal bilinear resize (``io/image.resize_bilinear``), depth through
the port's cv2-equal 16-bit PNG writer (``io/image.write_depth_png``).
"""

from maskclustering_tpu_torch.preprocess.scannet import (  # noqa: F401
    SensHeader,
    iter_sens_frames,
    export_sens_scene,
    prepare_scannet_gt,
    scannet_scene_gt,
    write_sens,
)
from maskclustering_tpu_torch.preprocess.matterport import convert_matterport_gt  # noqa: F401
from maskclustering_tpu_torch.preprocess.scannetpp import write_toolkit_configs  # noqa: F401
from maskclustering_tpu_torch.preprocess.tasmap import (  # noqa: F401
    omni_intrinsics,
    pose_to_extrinsic,
    convert_tasmap_scene,
)

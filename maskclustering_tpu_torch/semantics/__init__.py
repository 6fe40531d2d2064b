"""Open-vocabulary semantics (L4): crops, encoders, features and the query.

Counterpart of ``maskclustering_tpu/semantics`` with its export list.
``HFCLIPEncoder`` is CLIP in plain PyTorch (``clip.py``) with the port's
own checkpoint readers (``checkpoint.py``), tokenizer (``tokenizer.py``)
and image processor (``image_processor.py``).
"""

from maskclustering_tpu_torch.semantics.vocab import get_vocab, vocab_name
from maskclustering_tpu_torch.semantics.crops import (
    CROP_SCALES,
    mask_to_box,
    multiscale_crops,
    pad_to_square,
)
from maskclustering_tpu_torch.semantics.encoder import (
    HashEncoder,
    HFCLIPEncoder,
    ImageEncoder,
    PrecomputedFeatures,
    TextEncoder,
    l2_normalize,
)
from maskclustering_tpu_torch.semantics.features import (
    extract_label_features,
    extract_mask_features,
    pool_scale_features,
    representative_mask_index,
    save_mask_features,
)
from maskclustering_tpu_torch.semantics.query import (
    assign_labels,
    classify_objects,
    object_features,
    run_query,
)

__all__ = [
    "get_vocab",
    "vocab_name",
    "CROP_SCALES",
    "mask_to_box",
    "multiscale_crops",
    "pad_to_square",
    "HashEncoder",
    "HFCLIPEncoder",
    "ImageEncoder",
    "PrecomputedFeatures",
    "TextEncoder",
    "l2_normalize",
    "extract_label_features",
    "extract_mask_features",
    "pool_scale_features",
    "representative_mask_index",
    "save_mask_features",
    "assign_labels",
    "classify_objects",
    "object_features",
    "run_query",
]

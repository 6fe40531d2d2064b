"""PyTorch/CUDA port of ``maskclustering_tpu``.

A package of its own beside the JAX reference: it imports ``torch``, numpy
and scipy, never ``jax`` and nothing of ``maskclustering_tpu``. Module
names mirror the JAX package so each counterpart is easy to find. The
TPU's Pallas ball query is a hand-written CUDA kernel here
(``ops/cuda/ball_query.cu``); every other stage is plain torch or host
numpy, as in the reference.

Entry point: ``maskclustering_tpu_torch.models.run_scene``. It runs on the
``cuda`` device unless the caller passes ``device="cpu"``.
"""

from maskclustering_tpu_torch.config import PipelineConfig, from_jax_config, load_config

__all__ = ["PipelineConfig", "from_jax_config", "load_config"]

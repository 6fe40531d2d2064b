"""The port's host-sync guard (``maskclustering_tpu_torch/analysis/transfer_guard.py``)
against the JAX package's transfer guard (``tests/test_analysis.py:832-867``),
and the device constants that replaced the port's blocking threshold
uploads, on the CPU.

- An explicit ``arm`` takes precedence over ``MCT_TRANSFER_GUARD``, as in JAX.
- A guarded device phase raises on an injected ``.item()``, ``.cpu()`` and
  ``nonzero`` (the modes run on the CPU too), and a sanctioned window lets
  the same read through; another thread is never guarded.
- Guarded and unguarded runs give equal digests on two scenes, for both
  ``count_dtype`` values, equal to the JAX ``run_scene``'s.
- The named-pull census of the canonical guarded scene is the pinned one.
- Each threshold constant is bit-equal to the ``torch.tensor`` value it
  replaces, for every float field of the scannet config and on float32
  rounding boundaries.
"""

import threading

import numpy as np
import pytest
import torch

from maskclustering_tpu.analysis import transfer_guard as jax_tg
from maskclustering_tpu.config import PipelineConfig as JaxConfig
from maskclustering_tpu.models.pipeline import run_scene as jax_run_scene
from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors
from maskclustering_tpu_torch.analysis import ir_checks
from maskclustering_tpu_torch.analysis import transfer_guard as tg
from maskclustering_tpu_torch.config import PipelineConfig, load_config
from maskclustering_tpu_torch.models import graph, pipeline, run_scene

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

CFG = dict(config_name="synthetic", dataset="demo", distance_threshold=0.03, step=1,
           mask_pad_multiple=64, point_chunk=2048, frame_pad_multiple=8)


@pytest.fixture
def guard():
    tg.arm(True)
    yield tg
    tg.arm(None)


def test_arm_takes_precedence_over_the_environment(monkeypatch):
    for mod in (tg, jax_tg):
        monkeypatch.delenv(mod.ENV_FLAG, raising=False)
        mod.arm(None)
        assert not mod.enabled()
        monkeypatch.setenv(mod.ENV_FLAG, "1")
        assert mod.enabled()
        mod.arm(False)  # explicit arm beats the environment
        try:
            assert not mod.enabled()
        finally:
            mod.arm(None)
    assert tg.ENV_FLAG == jax_tg.ENV_FLAG


@pytest.mark.parametrize("inject", ["item", "cpu", "nonzero"])
def test_guard_trips_on_an_injected_read(guard, monkeypatch, inject):
    """An injected host read in the guarded device phase raises at its line;
    unguarded, the same scene runs."""
    tensors = to_scene_tensors(make_scene(num_boxes=2, num_frames=4, seed=3, spacing=0.08))
    cfg = PipelineConfig(**CFG)
    real = pipeline.compute_graph_stats

    def injected(mask_of_point, *a, **kw):
        x = mask_of_point.reshape(-1)[:4]
        {"item": lambda: x[0].item(), "cpu": lambda: x.cpu(),
         "nonzero": lambda: torch.nonzero(x)}[inject]()
        return real(mask_of_point, *a, **kw)

    monkeypatch.setattr(pipeline, "compute_graph_stats", injected)
    with pytest.raises(tg.HostSyncError):
        pipeline.run_scene_device(tensors, cfg, k_max=15, device="cpu")
    # inside a named window the same read goes through, and is counted
    x = torch.arange(8)
    with tg.device_phase_guard():
        with tg.sanctioned_pull("test.window"):
            {"item": lambda: x[0].item(), "cpu": lambda: x.cpu(),
             "nonzero": lambda: torch.nonzero(x)}[inject]()
    assert tg.scene_pulls() == {"test.window": 1}
    tg.arm(False)
    pipeline.run_scene_device(tensors, cfg, k_max=15, device="cpu")


def test_windows_count_and_other_threads_are_not_guarded(guard):
    x = torch.arange(8)
    seen = {}

    def other():
        seen["value"] = int(x.sum())  # a host read on an unguarded thread

    with tg.device_phase_guard():
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with pytest.raises(tg.HostSyncError):
            bool(x.any())
        for _ in range(3):
            with tg.sanctioned_pull("sweep"):
                bool(x.any())
    assert seen["value"] == 28 and tg.scene_pulls() == {"sweep": 3}


@pytest.mark.parametrize("count_dtype", ["bf16", "int8"])
def test_guarded_and_unguarded_digests_are_equal(count_dtype):
    cfg = PipelineConfig(**CFG, count_dtype=count_dtype)
    jcfg = JaxConfig(**CFG, count_dtype=count_dtype, backend="cpu")
    for seed in (3, 4):
        t = to_scene_tensors(make_scene(num_boxes=3, num_frames=6, seed=seed, spacing=0.05))
        plain = run_scene(t, cfg, k_max=15, device="cpu").digest
        tg.arm(True)
        try:
            guarded = run_scene(t, cfg, k_max=15, device="cpu").digest
        finally:
            tg.arm(None)
        jax_digest = jax_run_scene(t, jcfg, k_max=15).digest
        assert guarded == plain
        for key in ("plane", "artifact", "nan_inf", "bucket"):
            assert plain[key] == jax_digest[key], key


def test_named_pull_census_is_pinned():
    from maskclustering_tpu.analysis.ir_checks import EXPECTED_HOST_SYNCS as JAX_SYNCS

    pulls, error = ir_checks.guarded_scene_pulls("cpu")
    assert error is None and pulls == ir_checks.EXPECTED_HOST_SYNCS
    assert ir_checks.JAX_HOST_SYNCS == JAX_SYNCS
    # the one pull JAX makes is among the port's, under the same name
    assert pulls["mask_valid"] == JAX_SYNCS
    assert ir_checks.check_host_syncs(pulls) == []


def _boundary_values():
    """Doubles on and next to float32 rounding boundaries: midpoints
    between neighbouring float32 values (ties to even) and one ulp off."""
    out = []
    for f in (np.float32(0.9), np.float32(1e-7), np.float32(0.3), np.float32(65504.0)):
        nxt = np.nextafter(f, np.float32(np.inf))
        mid = (float(f) + float(nxt)) / 2
        out += [mid, np.nextafter(mid, 0.0), np.nextafter(mid, np.inf)]
    return out


def test_threshold_constants_are_bit_equal_to_the_uploads_they_replace():
    cfg = load_config("scannet")
    values = [v for v in (getattr(cfg, f) for f in cfg.__dataclass_fields__)
              if isinstance(v, float) and not isinstance(v, bool)]
    assert len(values) >= 8
    like = torch.zeros(1)
    for v in values + _boundary_values():
        old = torch.tensor(v, dtype=torch.float32)
        for new in (torch.full((), v, dtype=torch.float32), graph._f32(v, like)):
            assert new.dtype == torch.float32 and new.shape == ()
            assert new.view(torch.int32).item() == old.view(torch.int32).item(), v

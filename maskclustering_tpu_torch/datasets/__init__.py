"""Dataset registry (``datasets/__init__.py:13-46``)."""

from __future__ import annotations

from typing import Callable, Dict

from maskclustering_tpu_torch.datasets.base import BaseDataset, SceneTensors

_REGISTRY: Dict[str, Callable[..., BaseDataset]] = {}


def get_dataset(dataset: str, seq_name: str, data_root: str = "./data") -> BaseDataset:
    if not _REGISTRY:
        _populate()
    if dataset not in _REGISTRY:
        raise KeyError(f"unknown dataset {dataset!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[dataset](seq_name, data_root=data_root)


def _populate():
    from maskclustering_tpu_torch.datasets.matterport import MatterportDataset
    from maskclustering_tpu_torch.datasets.scannet import DemoDataset, ScanNetDataset
    from maskclustering_tpu_torch.datasets.scannetpp import ScanNetPPDataset
    from maskclustering_tpu_torch.datasets.tasmap import TASMapDataset

    _REGISTRY.setdefault("scannet", ScanNetDataset)
    _REGISTRY.setdefault("demo", DemoDataset)
    _REGISTRY.setdefault("scannetpp", ScanNetPPDataset)
    _REGISTRY.setdefault("matterport3d", MatterportDataset)
    _REGISTRY.setdefault("tasmap", TASMapDataset)


__all__ = ["BaseDataset", "SceneTensors", "get_dataset"]

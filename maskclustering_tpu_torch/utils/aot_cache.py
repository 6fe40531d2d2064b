"""Persistent kernel build cache: the port's counterpart of
``maskclustering_tpu/utils/aot_cache.py``.

Nothing in the port traces: its compile surface is the ``nvcc`` builds of
``ops/cuda/*.cu``. Without a cache each process builds them at first use
into ``build/torch_kernels/`` (seconds of ``nvcc`` a source, paid again by
every fresh process: a restarted daemon, a respawned serving child, a pool
slice). This module makes warm a durable property of the deployment:

- **the cache**: a directory of built ``ops/cuda`` shared libraries with a
  readable ``index.json``. An entry is keyed by the kernel's name, the
  SHA-256 of its source and ``ops.cuda.NVCC_FLAGS``, and carries a
  **version stamp**: ``nvcc --version``, ``torch.__version__``,
  ``torch.version.cuda``, the target arch and a schema number. The
  library's file name hashes key and stamp together;
- **warm start** (:func:`warm_start`): at process start every entry whose
  key and stamp match is loaded (``ops.cuda.adopt``), and on a card the
  kernels with no such entry are built at once, in parallel, and indexed,
  so a warm process builds nothing: the counterpart of the JAX cache's
  ``compiles: 0``. Restores count on ``aot_cache.hits``, builds on
  ``aot_cache.misses``;
- **invalidation**: an entry whose stamp does not match (another toolkit,
  another torch) is never loaded; it is counted on
  ``aot_cache.invalidated`` and its kernel is rebuilt and re-indexed under
  the current stamp. :func:`prune` deletes such entries' files.

The cache is chosen by ``run.py --aot-cache [DIR]``, ``$MCT_AOT_CACHE`` or
``cfg.aot_cache_dir`` and defaults to ``aot_cache/`` beside the port's
ledger path (listed in ``.gitignore``). Without a cache, builds go to
``build/torch_kernels/`` as before. Index updates take an exclusive
``flock``, so the processes of a pool can share one directory.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import logging
import os
import subprocess
import time
from typing import Dict, List, Optional

log = logging.getLogger("maskclustering_tpu_torch")

SCHEMA_VERSION = 1
INDEX_NAME = "index.json"
ENV_DIR = "MCT_AOT_CACHE"
ARCH = "sm_90a"


def _count(name: str, delta: float = 1.0) -> None:
    try:
        from maskclustering_tpu_torch.obs import metrics

        metrics.count(name, delta)
    except Exception:  # noqa: BLE001 — accounting never faults the cache
        pass


def nvcc_version() -> str:
    """The release line of ``nvcc --version`` ("none" without a toolkit)."""
    from maskclustering_tpu_torch.ops import cuda

    try:
        out = subprocess.run([cuda.nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "none"
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[-1] if lines else out.strip().splitlines()[-1] if out.strip() else "none"


def version_stamp() -> Dict[str, str]:
    """What a built library depends on besides its source and flags."""
    import torch

    return {"schema": str(SCHEMA_VERSION), "nvcc": nvcc_version(),
            "torch": torch.__version__, "cuda": str(torch.version.cuda), "arch": ARCH}


def default_cache_dir() -> str:
    """``aot_cache/`` beside the port's perf ledger path."""
    from maskclustering_tpu_torch.obs.ledger import default_ledger_path

    return os.path.join(os.path.dirname(os.path.abspath(default_ledger_path())), "aot_cache")


def resolve_cache_dir(cfg=None, explicit: Optional[str] = None) -> Optional[str]:
    """The armed cache directory, or None: ``explicit`` (``"auto"`` = the
    default), else ``$MCT_AOT_CACHE``, else ``cfg.aot_cache_dir``."""
    spec = explicit or os.environ.get(ENV_DIR) or (getattr(cfg, "aot_cache_dir", "")
                                                   if cfg is not None else "")
    if not spec:
        return None
    return default_cache_dir() if spec in ("auto", "1") else os.path.abspath(spec)


class AotCache:
    """One cache directory: its index and the current key of each kernel."""

    def __init__(self, root: str, stamp: Optional[Dict[str, str]] = None):
        from maskclustering_tpu_torch.ops import cuda

        self.root = root
        os.makedirs(root, exist_ok=True)
        self.stamp = dict(stamp) if stamp is not None else version_stamp()
        self.flags = list(cuda.NVCC_FLAGS)
        self.sources = {name: cuda.source_sha256(name) for name in cuda.KERNELS}
        self.stats = {"restored": 0, "built": 0, "invalidated": 0, "pruned": 0}

    # -- keys ------------------------------------------------------------
    def file_name(self, name: str, stamp: Optional[Dict[str, str]] = None) -> str:
        blob = json.dumps([self.sources[name], self.flags, stamp or self.stamp],
                          sort_keys=True).encode()
        return f"libmc_{name}-{hashlib.sha256(blob).hexdigest()[:16]}.so"

    def library_path(self, name: str) -> str:
        return os.path.join(self.root, self.file_name(name))

    def _matches_key(self, entry: Dict) -> bool:
        name = entry.get("kernel")
        return (name in self.sources and entry.get("source_sha256") == self.sources[name]
                and entry.get("flags") == self.flags)

    # -- the index ---------------------------------------------------------
    @property
    def index_path(self) -> str:
        return os.path.join(self.root, INDEX_NAME)

    def read_index(self) -> Dict:
        try:
            with open(self.index_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {"schema": SCHEMA_VERSION, "entries": {}}
        doc.setdefault("entries", {})
        return doc

    def _update_index(self, fn) -> None:
        """Read-modify-write the index under an exclusive lock."""
        with open(os.path.join(self.root, ".index.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            doc = self.read_index()
            fn(doc["entries"])
            tmp = f"{self.index_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
            os.replace(tmp, self.index_path)

    def record(self, seconds: Dict[str, float]) -> None:
        """Index the libraries just built (``ops.cuda.build``'s hook)."""
        def add(entries):
            for name, secs in seconds.items():
                entries[self.file_name(name)] = {
                    "kernel": name, "source_sha256": self.sources[name],
                    "flags": self.flags, "stamp": self.stamp,
                    "build_s": round(float(secs), 3), "created": time.time()}
        self._update_index(add)
        self.stats["built"] += len(seconds)
        _count("aot_cache.misses", float(len(seconds)))

    def classify(self) -> Dict[str, List[str]]:
        """The index's files by state: ``valid`` (key and stamp match, file
        present), ``invalidated`` (this key, another stamp) and ``stale``
        (a source or flags no longer built)."""
        out: Dict[str, List[str]] = {"valid": [], "invalidated": [], "stale": []}
        for fname, entry in sorted(self.read_index()["entries"].items()):
            if not self._matches_key(entry):
                out["stale"].append(fname)
            elif entry.get("stamp") != self.stamp:
                out["invalidated"].append(fname)
            elif os.path.exists(os.path.join(self.root, fname)):
                out["valid"].append(fname)
        return out

    def prune(self) -> List[str]:
        """Delete every entry whose stamp or key does not match, file and
        index line. Returns the file names removed."""
        removed: List[str] = []

        def drop(entries):
            for fname in list(entries):
                entry = entries[fname]
                if self._matches_key(entry) and entry.get("stamp") == self.stamp:
                    continue
                try:
                    os.remove(os.path.join(self.root, fname))
                except FileNotFoundError:
                    pass
                del entries[fname]
                removed.append(fname)
        self._update_index(drop)
        self.stats["pruned"] += len(removed)
        return removed

    def snapshot(self) -> Dict:
        state = self.classify()
        return {"dir": self.root, "entries": sum(len(v) for v in state.values()),
                "valid": len(state["valid"]), "invalidated_entries": len(state["invalidated"]),
                "stale_entries": len(state["stale"]), **self.stats}


_ACTIVE: Optional[AotCache] = None


def configure(root: Optional[str], stamp: Optional[Dict[str, str]] = None
              ) -> Optional[AotCache]:
    """Arm the cache at ``root`` (None disarms). Later builds go there."""
    global _ACTIVE
    _ACTIVE = AotCache(root, stamp) if root else None
    return _ACTIVE


def active() -> Optional[AotCache]:
    return _ACTIVE


def reset() -> None:
    configure(None)


def warm_start(cfg=None, *, cache_dir: Optional[str] = None, device=None,
               build: Optional[bool] = None) -> Dict[str, int]:
    """Arm the cache the config or environment names and warm the process
    from it: load every valid entry, count the invalidated ones, and (on a
    card, or with ``build=True``) build every kernel left and index it.
    Returns {"restored", "built", "invalidated"}; all 0, and the cache
    disarmed, when none is named."""
    from maskclustering_tpu_torch.ops import cuda

    root = resolve_cache_dir(cfg, cache_dir)
    if root is None:
        configure(None)  # no cache for this run: builds go to ops.cuda.BUILD_DIR
        return {"restored": 0, "built": 0, "invalidated": 0}
    cache = configure(root)
    state = cache.classify()
    index = cache.read_index()["entries"]
    restored = set()
    for fname in state["valid"]:
        name = index[fname]["kernel"]
        if fname == cache.file_name(name) and name not in restored:
            cuda.adopt(name, os.path.join(root, fname))
            restored.add(name)
    invalidated = {index[f]["kernel"] for f in state["invalidated"]} - restored
    cache.stats["restored"] += len(restored)
    cache.stats["invalidated"] += len(invalidated)
    if restored:
        _count("aot_cache.hits", float(len(restored)))
    if invalidated:
        _count("aot_cache.invalidated", float(len(invalidated)))
        log.warning("aot cache: %d entr%s built under another stamp; rebuilding %s",
                    len(invalidated), "y" if len(invalidated) == 1 else "ies",
                    sorted(invalidated))
    if build is None:
        dev = getattr(device, "type", device)
        build = dev is not None and str(dev).startswith("cuda")
    built: Dict[str, float] = {}
    missing = [k for k in cuda.KERNELS if k not in restored]
    if build and missing:
        built = cuda.build(missing)
        for name in missing:
            cuda.adopt(name, cache.library_path(name))
    return {"restored": len(restored), "built": len(built), "invalidated": len(invalidated)}


def stats_snapshot() -> Dict:
    """The armed cache's state ({} when no cache is armed)."""
    cache = _ACTIVE
    return cache.snapshot() if cache is not None else {}

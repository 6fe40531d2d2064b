"""The port's kernel build cache (``maskclustering_tpu_torch/utils/aot_cache.py``),
on the CPU with the build stubbed: this machine has no ``nvcc``, so the
compiler, the library loader and the toolkit's version line are replaced
by stand-ins that write and read placeholder files; everything else (keys,
stamps, the index, warm start, invalidation, ``prune``) is the real code.
The real cross-process warm start runs on the card (``chip_smoke.py``
phase 21).

- The key is the kernel's source SHA-256 and ``NVCC_FLAGS``; the file name
  hashes key and stamp, so a change to either names another library.
- Across processes: a cold process builds the three libraries and indexes
  them; a second process restores all three and builds nothing (an empty
  ``BUILT``); after a stamp change a third process counts three
  invalidated entries and rebuilds exactly three, and ``prune`` removes the
  stale files.
- ``--aot-cache`` defaults to ``aot_cache/`` beside the port's ledger path.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from maskclustering_tpu_torch.ops import cuda
from maskclustering_tpu_torch.utils import aot_cache

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMP = {"schema": "1", "nvcc": "Cuda compilation tools, release 12.4 (stub)",
         "torch": torch.__version__, "cuda": "12.4", "arch": "sm_90a"}

# a child process: the stand-ins, then a warm start with builds and a prune
CHILD = '''
import json, sys
from maskclustering_tpu_torch.ops import cuda
from maskclustering_tpu_torch.utils import aot_cache

class _Proc:
    returncode = 0
    def __init__(self, cmd):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library of " + cmd[-1])
    def communicate(self):
        return "", None

class _Lib:
    def __init__(self, path):
        self.path = path
    def __getattr__(self, name):
        entry = type("Entry", (), {})()
        setattr(self, name, entry)
        return entry

cuda.nvcc_path = lambda: "nvcc"
cuda._start_nvcc = _Proc
cuda._open_library = _Lib
aot_cache.version_stamp = lambda: json.loads(sys.argv[2])

stats = aot_cache.warm_start(cache_dir=sys.argv[1], build=True)
removed = aot_cache.active().prune()
print(json.dumps({"stats": stats, "built": sorted(cuda.BUILT), "removed": removed,
                  "loaded": sorted(cuda._LIBS)}))
'''


def _child(cache_dir, stamp):
    out = subprocess.run([sys.executable, "-c", CHILD, str(cache_dir), json.dumps(stamp)],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_key_and_stamp_name_the_library(tmp_path):
    cache = aot_cache.AotCache(str(tmp_path), stamp=STAMP)
    name = "associate"
    assert cache.sources[name] == cuda.source_sha256(name)
    assert cache.flags == list(cuda.NVCC_FLAGS)
    base = cache.file_name(name)
    assert base.startswith("libmc_associate-") and base.endswith(".so")
    assert cache.file_name(name, dict(STAMP, torch="0.0")) != base
    assert len({cache.file_name(k) for k in cuda.KERNELS}) == len(cuda.KERNELS)
    cache.sources[name] = "0" * 64  # another source, another library
    assert cache.file_name(name) != base
    assert aot_cache.resolve_cache_dir(None, "auto") == aot_cache.default_cache_dir()
    assert os.path.dirname(aot_cache.default_cache_dir()) == os.path.dirname(
        os.path.abspath(os.environ["MCT_PERF_LEDGER"]))


def test_cross_process_warm_start_builds_nothing_and_invalidation_rebuilds(tmp_path):
    cache_dir = tmp_path / "aot"
    n = len(cuda.KERNELS)  # one library a kernel source
    cold = _child(cache_dir, STAMP)
    assert cold["stats"] == {"restored": 0, "built": n, "invalidated": 0}
    assert cold["built"] == sorted(cuda.KERNELS) == cold["loaded"]
    with open(cache_dir / aot_cache.INDEX_NAME) as fh:
        index = json.load(fh)["entries"]
    assert sorted(e["kernel"] for e in index.values()) == sorted(cuda.KERNELS)
    assert all(e["stamp"] == STAMP and e["flags"] == list(cuda.NVCC_FLAGS)
               for e in index.values())

    warm = _child(cache_dir, STAMP)
    assert warm["stats"] == {"restored": n, "built": 0, "invalidated": 0}
    assert warm["built"] == [] and warm["loaded"] == sorted(cuda.KERNELS)
    assert warm["removed"] == []

    newer = dict(STAMP, nvcc="Cuda compilation tools, release 12.8 (stub)")
    changed = _child(cache_dir, newer)
    assert changed["stats"] == {"restored": 0, "built": n, "invalidated": n}
    assert changed["built"] == sorted(cuda.KERNELS)
    assert sorted(changed["removed"]) == sorted(index)  # the stale files, pruned
    left = sorted(f for f in os.listdir(cache_dir) if f.endswith(".so"))
    assert len(left) == n and not set(left) & set(index)
    assert _child(cache_dir, newer)["stats"] == {"restored": n, "built": 0, "invalidated": 0}


def test_a_cpu_run_arms_the_cache_and_builds_nothing(tmp_path):
    stats = aot_cache.warm_start(cache_dir=str(tmp_path / "c"), device="cpu")
    try:
        assert stats == {"restored": 0, "built": 0, "invalidated": 0}
        assert aot_cache.active().root == str(tmp_path / "c")
        assert cuda.library_path("splat").startswith(str(tmp_path / "c"))
        snap = aot_cache.stats_snapshot()
        assert snap["dir"] == str(tmp_path / "c") and snap["entries"] == 0
    finally:
        aot_cache.reset()
    assert aot_cache.stats_snapshot() == {}
    assert cuda.library_path("splat").startswith(cuda.BUILD_DIR)


@pytest.mark.parametrize("spec", ["", "auto"])
def test_no_cache_without_a_directory(spec, monkeypatch, tmp_path):
    """No directory named: no cache, and a warm start disarms one a
    previous run armed; ``auto`` is the default directory."""
    monkeypatch.delenv(aot_cache.ENV_DIR, raising=False)
    got = aot_cache.resolve_cache_dir(None, spec or None)
    assert got == (aot_cache.default_cache_dir() if spec else None)
    aot_cache.configure(str(tmp_path / "earlier"))
    try:
        stats = aot_cache.warm_start(cache_dir=spec or None, device="cpu")
        assert stats == {"restored": 0, "built": 0, "invalidated": 0}
        assert (aot_cache.active() is None) == (not spec)
    finally:
        aot_cache.reset()

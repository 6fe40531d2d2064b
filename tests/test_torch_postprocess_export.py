"""The export's artifacts when several writers export one scene into one
prediction root at once (``models/postprocess.export_artifacts``).

Each writer writes through a temporary file of its own and renames it onto
the artifact (``utils/atomic_write.replacing``). With one fixed temporary
name per artifact, two writers at once wrote one file, and one writer's
rename moved the other's file or found none. Here two threads export the
same objects many times over: neither raises, the final ``<seq>.npz`` and
``object_dict.npy`` hold a single export's bytes (the npz member by member:
``np.savez`` stamps the time into each member's zip header), and no
temporary file is left behind.
"""

import os
import threading
import zipfile

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.models.postprocess import SceneObjects, export_artifacts
from maskclustering_tpu_torch.utils import atomic_write

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

ROUNDS = 40


def _objects(seed: int = 0) -> SceneObjects:
    rng = np.random.default_rng(seed)
    n = 5000
    pids = [np.sort(rng.choice(n, size=rng.integers(50, 400), replace=False))
            for _ in range(6)]
    masks = [[(int(f), int(m), float(c)) for f, m, c in
              zip(rng.integers(0, 30, 8), rng.integers(1, 40, 8), rng.random(8))]
             for _ in pids]
    return SceneObjects(point_ids_list=pids, mask_list=masks, num_points=n)


def _export(objects, root):
    return export_artifacts(objects, "scene0007_00", "cfg", os.path.join(root, "object"),
                            prediction_root=os.path.join(root, "prediction"), top_k_repre=5)


def _npz_members(path):
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def _file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _race(target, args, rounds: int = ROUNDS):
    """Call ``target(*args)`` from two threads at once, ``rounds`` times,
    each round started together; return the errors they raised."""
    errors = []
    for _ in range(rounds):
        start = threading.Barrier(2)

        def run():
            try:
                start.wait(10.0)
                target(*args)
            except Exception as e:  # noqa: BLE001 — surfaced by the caller
                errors.append(repr(e))

        threads = [threading.Thread(target=run) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    return errors


def test_two_threads_export_one_scene_into_one_root(tmp_path):
    objects = _objects()
    single = _export(objects, str(tmp_path / "single"))
    shared = str(tmp_path / "shared")
    assert _race(_export, (objects, shared)) == []
    got_npz = os.path.join(shared, "prediction", "cfg_class_agnostic", "scene0007_00.npz")
    got_od = os.path.join(shared, "object", "cfg", "object_dict.npy")
    assert _npz_members(got_npz) == _npz_members(single["npz"])
    assert _file_bytes(got_od) == _file_bytes(single["object_dict"])
    assert os.listdir(os.path.dirname(got_npz)) == ["scene0007_00.npz"]
    assert os.listdir(os.path.dirname(got_od)) == ["object_dict.npy"]
    loaded = np.load(got_npz)
    assert loaded["pred_masks"].shape == (objects.num_points, len(objects.point_ids_list))


def test_artifact_files_keep_the_plain_open_mode(tmp_path):
    """The temporary file is made private by ``mkstemp``; the artifact gets
    the mode a plain ``open`` would give it under this process's umask."""
    out = _export(_objects(1), str(tmp_path))
    mask = os.umask(0o022)
    os.umask(mask)
    for path in out.values():
        assert os.stat(path).st_mode & 0o777 == 0o666 & ~mask


def test_a_failed_write_leaves_no_temporary_and_the_old_file(tmp_path):
    path = str(tmp_path / "a.npz")
    np.savez(path, x=np.arange(3))
    before = _file_bytes(path)
    with pytest.raises(RuntimeError):
        with atomic_write.replacing(path, ".npz") as tmp:
            np.savez(tmp, x=np.arange(4))
            raise RuntimeError("writer failed")
    assert os.listdir(tmp_path) == ["a.npz"] and _file_bytes(path) == before
    with atomic_write.replacing(path, ".npz") as tmp:
        assert tmp.endswith(".npz") and os.path.dirname(tmp) == str(tmp_path)
        np.savez(tmp, x=np.arange(4))
    assert np.array_equal(np.load(path)["x"], np.arange(4))

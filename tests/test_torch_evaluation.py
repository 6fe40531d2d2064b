"""The port's AP evaluation against analytic cases and the JAX evaluator.

Every case of ``tests/test_evaluation.py`` with the port's functions
(``device="cpu"``), then seeded random prediction/GT scans for all three
vocabularies under both ``count_dtype`` values, with and without
``no_class``: ``assign_instances_for_scan``, ``evaluate_matches`` and
``evaluate_scans`` equal to the JAX functions' results exactly (counts,
matches, AP floats, the result file), and the CLI.
"""

import math

import numpy as np
import pytest
import torch

import maskclustering_tpu.evaluation as jax_eval
from maskclustering_tpu.semantics.vocab import get_vocab as jax_get_vocab
from maskclustering_tpu_torch.evaluation import (
    assign_instances_for_scan,
    compute_averages,
    evaluate_matches,
    evaluate_scans,
    group_instances,
)
from maskclustering_tpu_torch.semantics.vocab import get_vocab

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

LABELS = ["cabinet", "bed"]
VALID_IDS = [3, 4]
ID2LABEL = {3: "cabinet", 4: "bed"}
N = 1000


def _gt_two_instances():
    """Two cabinet instances of 300 points each; the rest unannotated."""
    gt = np.zeros(N, dtype=np.int64)
    gt[:300] = 3001
    gt[300:600] = 3002
    return gt


def _matches(gt_ids, masks, scores, classes, **kw):
    gt2pred, pred2gt = assign_instances_for_scan(
        masks, scores, classes, gt_ids, LABELS, VALID_IDS, device="cpu", **kw)
    return {"scan": {"gt": gt2pred, "pred": pred2gt}}


def test_perfect_predictions_give_ap_one():
    gt = _gt_two_instances()
    masks = np.zeros((N, 2), dtype=bool)
    masks[:300, 0] = True
    masks[300:600, 1] = True
    m = _matches(gt, masks, np.ones(2), np.full(2, 3))
    aps = evaluate_matches(m, LABELS)
    avgs = compute_averages(aps, LABELS)
    assert avgs["classes"]["cabinet"]["ap"] == pytest.approx(1.0)
    assert avgs["classes"]["bed"]["ap"] != avgs["classes"]["bed"]["ap"]  # NaN: no GT, no pred
    assert avgs["all_ap"] == pytest.approx(1.0)  # nanmean skips bed


def test_half_overlap_passes_ap25_fails_ap50():
    """IoU = 150/450 = 1/3: counts at 0.25 threshold, misses at 0.5."""
    gt = _gt_two_instances()
    masks = np.zeros((N, 2), dtype=bool)
    masks[150:450, 0] = True  # straddles both instances, IoU 1/3 with each
    masks[300:600, 1] = True  # exact match of 3002
    m = _matches(gt, masks, np.array([0.9, 1.0]), np.full(2, 3))
    avgs = compute_averages(evaluate_matches(m, LABELS), LABELS)
    assert avgs["classes"]["cabinet"]["ap25%"] == pytest.approx(1.0)
    assert avgs["classes"]["cabinet"]["ap50%"] < 1.0
    assert avgs["classes"]["cabinet"]["ap50%"] > 0.0


def test_small_predictions_are_skipped():
    gt = _gt_two_instances()
    masks = np.zeros((N, 1), dtype=bool)
    masks[:50, 0] = True  # below the 100-vertex minimum region size
    _, pred2gt = assign_instances_for_scan(
        masks, np.ones(1), np.full(1, 3), gt, LABELS, VALID_IDS, device="cpu")
    assert pred2gt["cabinet"] == []


def test_void_coverage_is_not_a_false_positive():
    gt = _gt_two_instances()
    masks = np.zeros((N, 3), dtype=bool)
    masks[:300, 0] = True
    masks[300:600, 1] = True
    masks[600:900, 2] = True  # entirely void
    m = _matches(gt, masks, np.ones(3), np.full(3, 3))
    avgs = compute_averages(evaluate_matches(m, LABELS), LABELS)
    assert avgs["classes"]["cabinet"]["ap"] == pytest.approx(1.0)


def test_duplicate_detection_becomes_false_positive():
    gt = np.zeros(N, dtype=np.int64)
    gt[:300] = 3001
    masks = np.zeros((N, 2), dtype=bool)
    masks[:300, 0] = True
    masks[:300, 1] = True
    m = _matches(gt, masks, np.array([1.0, 0.5]), np.full(2, 3))
    avgs = compute_averages(evaluate_matches(m, LABELS), LABELS)
    assert avgs["classes"]["cabinet"]["ap50%"] == pytest.approx(1.0)
    m = _matches(gt, masks, np.array([1.0, 1.0]), np.full(2, 3))
    avgs = compute_averages(evaluate_matches(m, LABELS), LABELS)
    assert avgs["classes"]["cabinet"]["ap50%"] == pytest.approx(0.75)


def test_missed_instance_halves_recall():
    gt = _gt_two_instances()
    masks = np.zeros((N, 1), dtype=bool)
    masks[:300, 0] = True  # only 3001 found
    m = _matches(gt, masks, np.ones(1), np.full(1, 3))
    avgs = compute_averages(evaluate_matches(m, LABELS), LABELS)
    assert avgs["classes"]["cabinet"]["ap50%"] == pytest.approx(0.5)


def test_no_class_mode_collapses_labels():
    gt = np.zeros(N, dtype=np.int64)
    gt[:300] = 3001
    gt[300:600] = 4002
    gt[600:] = 4003
    masks = np.zeros((N, 3), dtype=bool)
    masks[:300, 0] = True
    masks[300:600, 1] = True
    masks[600:, 2] = True
    m = _matches(gt, masks, np.ones(3), np.array([99, 77, 55]), no_class=True)
    avgs = compute_averages(evaluate_matches(m, LABELS), LABELS)
    assert avgs["classes"]["cabinet"]["ap"] == pytest.approx(1.0)


def test_no_class_phantom_instance_from_unannotated():
    gt = np.full(N, 1, dtype=np.int64)  # reference encoding for unannotated
    gt[:300] = 3002
    masks = np.zeros((N, 1), dtype=bool)
    masks[:300, 0] = True
    m = _matches(gt, masks, np.ones(1), np.full(1, 3), no_class=True)
    avgs = compute_averages(evaluate_matches(m, LABELS), LABELS)
    assert avgs["classes"]["cabinet"]["ap50%"] == pytest.approx(0.5)


def test_group_instances_skips_void_and_zero():
    gt = np.zeros(N, dtype=np.int64)
    gt[:200] = 3001
    gt[200:400] = 99001  # label 99 not in vocabulary -> void
    grouped = group_instances(gt, VALID_IDS, LABELS, ID2LABEL)
    assert len(grouped["cabinet"]) == 1
    assert grouped["cabinet"][0].vert_count == 200
    assert grouped["bed"] == []


def _write_scan(tmp_path, name, gt, masks, scores, classes):
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    gt_dir.mkdir(exist_ok=True)
    pred_dir.mkdir(exist_ok=True)
    np.savetxt(gt_dir / f"{name}.txt", gt, fmt="%d")
    np.savez(pred_dir / f"{name}.npz", pred_masks=masks, pred_score=scores,
             pred_classes=classes)
    return str(pred_dir / f"{name}.npz"), str(gt_dir / f"{name}.txt")


def test_evaluate_scans_end_to_end(tmp_path):
    gt = np.zeros(N, dtype=np.int64)
    gt[:300] = 3001
    gt[300:] = 3002
    masks = np.zeros((N, 2), dtype=bool)
    masks[:300, 0] = True
    masks[300:, 1] = True
    pred, gtf = _write_scan(tmp_path, "scene0000_00", gt, masks, np.ones(2),
                            np.zeros(2, dtype=np.int32))
    out = tmp_path / "result.txt"
    avgs = evaluate_scans([pred], [gtf], "scannet", no_class=True, output_file=str(out),
                          verbose=False, device="cpu")
    assert avgs["all_ap"] == pytest.approx(1.0)
    lines = out.read_text().splitlines()
    assert lines[0] == "class,class id,ap,ap50,ap25"
    assert len(lines) > 2


def test_evaluator_memory_streams_scans(tmp_path):
    """Peak RSS stays bounded over a 50-scan evaluation: the per-scan dense
    tensors are transient; only the small match records accumulate."""
    import resource

    n, scans, inst = 200_000, 50, 20
    gt = np.zeros(n, dtype=np.int64)
    block = n // inst
    masks = np.zeros((n, inst), dtype=bool)
    for i in range(inst):
        gt[i * block:(i + 1) * block] = 3001 + i
        masks[i * block:(i + 1) * block, i] = True
    pred, gtf = _write_scan(tmp_path, "s", gt, masks, np.ones(inst), np.zeros(inst, np.int32))
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    avgs = evaluate_scans([pred] * scans, [gtf] * scans, "scannet", no_class=True,
                          verbose=False, device="cpu")
    rss_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    assert avgs["all_ap"] == pytest.approx(1.0)
    assert rss_after - rss_before < 0.6, (rss_before, rss_after)


def test_evaluation_cli_main(tmp_path, monkeypatch):
    from maskclustering_tpu_torch.evaluation.__main__ import main

    gt = np.zeros(N, dtype=np.int64)
    gt[:300] = 3001
    gt[300:] = 3002
    masks = np.zeros((N, 2), dtype=bool)
    masks[:300, 0] = True
    masks[300:, 1] = True
    _write_scan(tmp_path, "scene0000_00", gt, masks, np.ones(2), np.zeros(2, dtype=np.int32))
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    out = tmp_path / "res.txt"
    rc = main(["--pred_path", str(pred_dir), "--gt_path", str(gt_dir), "--dataset", "scannet",
               "--no_class", "--output_file", str(out), "--device", "cpu"])
    assert rc == 0
    suffixed = tmp_path / "res_class_agnostic.txt"
    assert suffixed.exists()
    assert suffixed.read_text().startswith("class,class id,ap,ap50,ap25")
    # the same file as the JAX CLI writes
    from maskclustering_tpu.evaluation.__main__ import main as jax_main

    assert jax_main(["--pred_path", str(pred_dir), "--gt_path", str(gt_dir), "--dataset",
                     "scannet", "--no_class", "--output_file", str(tmp_path / "jax.txt")]) == 0
    assert (tmp_path / "jax_class_agnostic.txt").read_text() == suffixed.read_text()

    # a prediction without GT is a loud failure that writes nothing
    monkeypatch.chdir(tmp_path)
    np.savez(pred_dir / "scene9999_00.npz", pred_masks=masks, pred_score=np.ones(2),
             pred_classes=np.zeros(2, dtype=np.int32))
    rc = main(["--pred_path", str(pred_dir), "--gt_path", str(gt_dir), "--dataset", "scannet",
               "--no_class", "--device", "cpu"])
    assert rc == 1
    assert not (tmp_path / "data").exists()


def test_evaluate_scans_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    gt = _gt_two_instances()
    pred, gtf = _write_scan(tmp_path, "s", gt, np.zeros((N, 1), bool), np.ones(1),
                            np.zeros(1, np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_scans([pred], [gtf], "scannet", verbose=False)


# ---------------------------------------------------------------------------
# parity with the JAX evaluator on seeded random scans
# ---------------------------------------------------------------------------


def _random_scan(vocab, seed, n=3000):
    """GT ids over a vocabulary (valid, void and unannotated vertices, group
    ids below 1000) and overlapping predictions with tied scores."""
    labels, ids = get_vocab(vocab)
    rng = np.random.default_rng(seed)
    gt = np.zeros(n, np.int64)
    cuts = np.sort(rng.choice(np.arange(1, n), size=24, replace=False))
    for i, (lo, hi) in enumerate(zip(np.r_[0, cuts], np.r_[cuts, n])):
        kind = rng.integers(0, 10)
        if kind < 7:
            gt[lo:hi] = int(rng.choice(ids[:6])) * 1000 + i + 1
        elif kind == 7:
            gt[lo:hi] = 999 * 1000 + i + 1  # a label outside every vocabulary: void
        elif kind == 8:
            gt[lo:hi] = 1 + i % 5  # annotation group (instance id below 1000)
    p = 30
    masks = np.zeros((n, p), bool)
    for j in range(p):
        lo = int(rng.integers(0, n - 50))
        masks[lo:lo + int(rng.integers(40, 500)), j] = True
    scores = rng.choice([0.25, 0.5, 0.75, 1.0], size=p)
    classes = np.where(rng.random(p) < 0.8, rng.choice(ids[:6], size=p), 12345).astype(np.int32)
    return labels, ids, gt, masks, scores, classes


def _plain(gt2pred, pred2gt):
    """The match records as plain tuples."""
    gts = {label: [(r.inst.instance_id, r.inst.label_id, r.inst.vert_count,
                    [(p.uid, n) for p, n in r.matched_pred]) for r in recs]
           for label, recs in gt2pred.items()}
    preds = {label: [(p.uid, p.label_id, p.vert_count, p.confidence, p.void_intersection,
                      [(g.instance_id, n) for g, n in p.matched_gt]) for p in plist]
             for label, plist in pred2gt.items()}
    return gts, preds


def _equal_with_nan(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_with_nan(a[k], b[k]) for k in a)
    return a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("vocab", ["scannet", "matterport3d", "scannetpp"])
@pytest.mark.parametrize("count_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("no_class", [False, True], ids=["class", "no_class"])
def test_matches_and_ap_equal_jax(vocab, count_dtype, no_class, tmp_path):
    assert get_vocab(vocab) == jax_get_vocab(vocab)
    matches, jax_matches, files = {}, {}, ([], [])
    for seed in range(3):
        labels, ids, gt, masks, scores, classes = _random_scan(vocab, 100 * seed + len(vocab))
        kw = dict(no_class=no_class, scan_key=f"scan{seed}", count_dtype=count_dtype)
        got = assign_instances_for_scan(masks, scores, classes, gt, labels, ids, device="cpu",
                                        **kw)
        want = jax_eval.assign_instances_for_scan(masks, scores, classes, gt, labels, ids, **kw)
        assert _plain(*got) == _plain(*want)
        matches[seed] = {"gt": got[0], "pred": got[1]}
        jax_matches[seed] = {"gt": want[0], "pred": want[1]}
        for out, path in zip(files, _write_scan(tmp_path, f"scene{seed:04d}_00", gt, masks,
                                                scores, classes)):
            out.append(path)
    aps = evaluate_matches(matches, labels)
    np.testing.assert_array_equal(aps, jax_eval.evaluate_matches(jax_matches, labels))
    got = evaluate_scans(*files, vocab, no_class=no_class, count_dtype=count_dtype,
                         verbose=False, output_file=str(tmp_path / "port.txt"), device="cpu")
    want = jax_eval.evaluate_scans(*files, vocab, no_class=no_class, count_dtype=count_dtype,
                                   verbose=False, output_file=str(tmp_path / "jax.txt"))
    assert _equal_with_nan(got, want)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert not math.isnan(got["all_ap_25%"])

"""Detection, audio, clustering, nominal and the pairwise functionals on the card, held against the CPU run.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_leaf.py

* COCO matching: the card's match flags equal the CPU's bit for bit (integer
  box corners, tied scores), chunked and not, and every result key agrees;
* audio: per-example SNR / SI-SDR values and PIT's permutations;
* the contingency counts equal the CPU's bit for bit, and every extrinsic and
  nominal score and the float64 EMI agree;
* the products the JAX package pins to ``precision="highest"`` (pairwise
  cosine / Euclidean / linear, ``embedding_similarity``, Calinski-Harabasz
  moments, Davies-Bouldin) give the same bits with TF32 allowed and not, and
  leave the caller's flags as they were;
* ``image_gradients`` equal the CPU's.

Tolerances: flags and counts are equal. Float32 values computed in another
order on the card: rtol 1e-5 (audio dB, CH / DB, pairwise matrices with atol
1e-5 for values near 0); float64 closed forms rounded once to float32 and AP
from equal counts: rtol 1e-6; the float64 EMI: rtol 1e-7, since each summand's log
probability is nine float64 ``lgamma`` values of up to ``lgamma(N + 1)`` (~5e6 here)
that cancel to O(1), and the card's ``lgamma`` and the host's differ by an ulp.
"""
import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
from metrics_tpu_torch.functional import clustering as clust
from metrics_tpu_torch.functional.audio.si_sdr import _si_sdr_per_example
from metrics_tpu_torch.functional.audio.snr import _snr_per_example
from metrics_tpu_torch.functional.clustering_intrinsic import _cluster_moments_batch
from metrics_tpu_torch.functional.detection import map as tmap

RTOL = 1e-5
RTOL_EXACT_MATH = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def _set_flags(tf32):
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def _tf32_on_and_off(fn):
    saved = _flags()
    try:
        _set_flags(True)
        with_tf32 = fn()
        assert _flags() == (True, True, "high")  # the call left the caller's flags alone
        _set_flags(False)
        without = fn()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
    return with_tf32, without


def _padded(seed, n_img=64, n_det=40, n_gt=24, num_classes=5):
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 300, (n_img, n_gt, 2))
    gb = np.concatenate([xy, xy + rng.integers(2, 200, (n_img, n_gt, 2))], -1).astype(np.float32)
    gl = rng.integers(0, num_classes, (n_img, n_gt))
    gv = rng.random((n_img, n_gt)) < 0.6
    gc = rng.random((n_img, n_gt)) < 0.05
    src = rng.integers(0, n_gt, (n_img, n_det))
    db = (np.take_along_axis(gb, src[..., None], 1) + rng.integers(-8, 9, (n_img, n_det, 4))).astype(np.float32)
    db[..., 2:] = np.maximum(db[..., 2:], db[..., :2] + 1)
    dl = np.where(rng.random((n_img, n_det)) < 0.8, np.take_along_axis(gl, src, 1),
                  rng.integers(0, num_classes, (n_img, n_det)))
    ds = (rng.integers(0, 64, (n_img, n_det)) / 64).astype(np.float32)
    dv = rng.random((n_img, n_det)) < 0.9
    return [torch.from_numpy(np.asarray(x)) for x in (db, ds, dl, dv, gb, gl, gv, gc)]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bytes", [tmap.MATCH_CHUNK_BYTES, 200_000])
def test_coco_match_flags_and_results_on_the_card_equal_cpu(cuda, chunk_bytes, monkeypatch):
    args = _padded(1)
    db, ds, dl, dv, gb, gl, gv, gc = args
    order = torch.argsort(-torch.where(dv, ds, torch.tensor(float("-inf"))), dim=1, stable=True)
    sorted_args = (torch.take_along_dim(db, order[..., None], 1), torch.take_along_dim(dv, order, 1),
                   torch.take_along_dim(dl, order, 1), gb, gl, gv, gc)
    common = (5, 100, tmap.COCO_IOU_THRESHOLDS, tmap.COCO_AREA_RANGES, chunk_bytes)
    cpu = tmap._match_flags(*sorted_args, *common)
    card = tmap._match_flags(*(a.to(cuda) for a in sorted_args), *common)
    for got, want in zip(card, cpu):
        assert torch.equal(got.cpu(), want)
    monkeypatch.setattr(tmap, "MATCH_CHUNK_BYTES", chunk_bytes)
    want = tmap.coco_map_padded(*args[:7], num_classes=5, gt_crowd=gc)
    got = tmap.coco_map_padded(*(a.to(cuda) for a in args[:7]), num_classes=5, gt_crowd=gc.to(cuda))
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=RTOL_EXACT_MATH, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_mean_average_precision_module_on_the_card_equals_cpu(cuda):
    db, ds, dl, dv, gb, gl, gv, gc = _padded(2, n_img=24)
    card, cpu = (pt.MeanAveragePrecision(num_classes=5, max_detections=40, max_gt=24, class_metrics=True, device=d)
                 for d in (cuda, "cpu"))
    for lo in range(0, 24, 8):
        preds = [{"boxes": db[i][dv[i]], "scores": ds[i][dv[i]], "labels": dl[i][dv[i]]} for i in range(lo, lo + 8)]
        target = [{"boxes": gb[i][gv[i]], "labels": gl[i][gv[i]], "iscrowd": gc[i][gv[i]]} for i in range(lo, lo + 8)]
        cpu.update(preds, target)
        card.update([{k: v.to(cuda) for k, v in d.items()} for d in preds],
                    [{k: v.to(cuda) for k, v in t.items()} for t in target])
    want, got = cpu.compute(), card.compute()
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=RTOL_EXACT_MATH, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_audio_values_and_pit_permutations_on_the_card_equal_cpu(cuda):
    rng = np.random.default_rng(3)
    target = torch.from_numpy(rng.normal(size=(32, 3, 8000)).astype(np.float32))
    perm = torch.from_numpy(np.stack([rng.permutation(3) for _ in range(32)]))
    noise = torch.from_numpy(0.3 * rng.normal(size=(32, 3, 8000)).astype(np.float32))
    preds = torch.gather(target, 1, perm[:, :, None].expand(-1, -1, 8000)) + noise
    for fn in (lambda p, t: _snr_per_example(p, t, False), lambda p, t: _si_sdr_per_example(p, t, True)):
        torch.testing.assert_close(fn(preds.to(cuda), target.to(cuda)).cpu(), fn(preds, target), rtol=RTOL, atol=0)
    metric = lambda p, t: _si_sdr_per_example(p, t, False)  # noqa: E731
    best_cpu, perm_cpu = ptf.permutation_invariant_training(preds, target, metric)
    best, perm_card = ptf.permutation_invariant_training(preds.to(cuda), target.to(cuda), metric)
    assert torch.equal(perm_card.cpu(), perm_cpu)
    torch.testing.assert_close(best.cpu(), best_cpu, rtol=RTOL, atol=0)
    snr_card, snr_cpu = pt.SNR(device=cuda), pt.SNR(device="cpu")
    snr_card.update(preds.to(cuda), target.to(cuda))
    snr_cpu.update(preds, target)
    assert int(snr_card.n_examples) == int(snr_cpu.n_examples) == 96
    torch.testing.assert_close(snr_card.compute().cpu(), snr_cpu.compute(), rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_contingency_counts_scores_and_emi_on_the_card_equal_cpu(cuda):
    rng = np.random.default_rng(4)
    target = torch.from_numpy(rng.integers(0, 300, 400_000))
    noise = torch.from_numpy(rng.integers(0, 320, 400_000))
    preds = torch.where(torch.from_numpy(rng.random(400_000) < 0.6), target, noise)
    preds[:5] = torch.tensor([-1, 320, 400, 3, 4])  # out of range: dropped on both
    cont_cpu = clust._contingency(preds, target, 320, 300)
    cont_card = clust._contingency(preds.to(cuda), target.to(cuda), 320, 300)
    assert torch.equal(cont_card.cpu(), cont_cpu)
    n = int(cont_cpu.sum())
    torch.testing.assert_close(clust._expected_mutual_info(cont_card, n).cpu(),
                               clust._expected_mutual_info(cont_cpu, n), rtol=1e-7, atol=0)
    for name in ("rand_score", "adjusted_rand_score", "mutual_info_score", "normalized_mutual_info_score",
                 "adjusted_mutual_info_score", "homogeneity_score", "completeness_score", "v_measure_score",
                 "fowlkes_mallows_score", "cramers_v", "pearsons_contingency_coefficient", "tschuprows_t", "theils_u"):
        fn = getattr(ptf, name)
        torch.testing.assert_close(fn(preds.to(cuda), target.to(cuda), 320, 300).cpu(), fn(preds, target, 320, 300),
                                   rtol=RTOL_EXACT_MATH, atol=0, msg=name)


def _blobs(seed, n, d, k):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3.0, size=(k, d))
    labels = rng.integers(0, k, n)
    return torch.from_numpy((centres[labels] + rng.normal(size=(n, d))).astype(np.float32)), torch.from_numpy(labels)


@pytest.mark.cuda
def test_intrinsic_scores_ignore_the_tf32_flags_and_equal_cpu(cuda):
    data, labels = _blobs(5, 4096, 256, 64)
    ch_card, ch_cpu = pt.CalinskiHarabaszScore(64, 256, device=cuda), pt.CalinskiHarabaszScore(64, 256, device="cpu")
    for lo in range(0, 4096, 1024):
        ch_card.update(data[lo:lo + 1024].to(cuda), labels[lo:lo + 1024].to(cuda))
        ch_cpu.update(data[lo:lo + 1024], labels[lo:lo + 1024])
    torch.testing.assert_close(ch_card.compute().cpu(), ch_cpu.compute(), rtol=RTOL, atol=0)
    d, lab = data.to(cuda), labels.to(cuda)
    on, off = _tf32_on_and_off(lambda: _cluster_moments_batch(d, lab, 64))
    assert torch.equal(on, off)
    on, off = _tf32_on_and_off(lambda: ptf.davies_bouldin_score(d, lab, 64))
    assert torch.equal(on, off)
    torch.testing.assert_close(on.cpu(), ptf.davies_bouldin_score(data, labels, 64), rtol=RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pairwise_cosine_similarity", "pairwise_euclidean_distance",
                                  "pairwise_linear_similarity", "pairwise_manhattan_distance", "embedding_similarity"])
def test_pairwise_products_ignore_the_tf32_flags_and_equal_cpu(cuda, name):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(512, 384)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(256, 384)).astype(np.float32))
    if name == "embedding_similarity":
        fn = lambda a, b: ptf.embedding_similarity(a)  # noqa: E731
    else:
        fn = getattr(ptf, name)
    on, off = _tf32_on_and_off(lambda: fn(x.to(cuda), y.to(cuda)))
    assert torch.equal(on, off)
    atol = 1e-4 if name == "pairwise_linear_similarity" else 1e-5
    torch.testing.assert_close(on.cpu(), fn(x, y), rtol=RTOL, atol=atol)


@pytest.mark.cuda
def test_image_gradients_on_the_card_equal_cpu(cuda):
    img = torch.rand(4, 3, 64, 48)
    for got, want in zip(ptf.image_gradients(img.to(cuda)), ptf.image_gradients(img)):
        assert torch.equal(got.cpu(), want)

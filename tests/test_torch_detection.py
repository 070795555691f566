"""Detection (COCO mAP) in metrics_tpu_torch against metrics_tpu.

The same numpy-seeded padded box sets go through ``coco_map_padded`` /
``MeanAveragePrecision`` of both packages:

* the match flags: the JAX package's dense ``(A, T, C, I, D)`` flags, rebuilt
  from its own ``_match_one`` vmapped as ``coco_map_padded`` vmaps it, equal
  the port's cell-wise flags bit for bit, on boxes with integer corners (exact
  IoU ties) and scores on a 1/8 grid (exact score ties), and with the
  matching chunked down to a few cells;
* every result key (``map``, ``map_50`` / ``_75``, the sizes, ``mar_<k>``,
  per class) over crowds, area ranges, other maxDets caps and thresholds,
  capacity overflow (top scores kept, with the warning) and empty input;
* a JAX checkpoint (``persistent(True)``, ``state_dict()``) loads into the
  port and the port's back into the JAX package, with equal results.

Tolerances: flags and per-cell TP / FP counts are equal. AP and recall are
float32 divisions of equal counts, with a mean over the 101 grid points (and a
``nanmean`` over classes) in another order: rtol 1e-6.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu.functional.detection import iou as jax_iou
from metrics_tpu.functional.detection import map as jmap
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.functional.detection import map as tmap
from metrics_tpu_torch.functional.detection.iou import box_iou, generalized_box_iou

RTOL = 1e-6


def _boxes(rng, shape, grid):
    xy = rng.integers(0, 150, (*shape, 2)) if grid else rng.uniform(0, 150, (*shape, 2))
    wh = rng.integers(2, 120, (*shape, 2)) if grid else rng.uniform(2, 120, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _padded(seed, n_img=6, n_det=12, n_gt=8, num_classes=3, grid=True, crowd=0.1):
    """Padded (det_boxes, det_scores, det_labels, det_valid, gt_boxes, gt_labels, gt_valid, gt_crowd)."""
    rng = np.random.default_rng(seed)
    gb = _boxes(rng, (n_img, n_gt), grid)
    gl = rng.integers(0, num_classes, (n_img, n_gt)).astype(np.int32)
    gv = rng.random((n_img, n_gt)) < 0.7
    gc = rng.random((n_img, n_gt)) < crowd
    src = rng.integers(0, n_gt, (n_img, n_det))
    jitter = rng.integers(-6, 7, (n_img, n_det, 4)) if grid else rng.normal(0, 4, (n_img, n_det, 4))
    db = (np.take_along_axis(gb, src[..., None], 1) + jitter).astype(np.float32)
    db[..., 2:] = np.maximum(db[..., 2:], db[..., :2] + 1)
    dl = np.where(rng.random((n_img, n_det)) < 0.8, np.take_along_axis(gl, src, 1),
                  rng.integers(0, num_classes, (n_img, n_det))).astype(np.int32)
    ds = (rng.integers(0, 8, (n_img, n_det)) / 8).astype(np.float32)  # exact score ties
    dv = rng.random((n_img, n_det)) < 0.85
    return db, ds, dl, dv, gb, gl, gv, gc


def _jax_dense_flags(db, ds, dl, dv, gb, gl, gv, gc, num_classes, k_max=100):
    """The JAX package's (A, T, C, I, D) flags, by its own functions vmapped as ``coco_map_padded`` does."""
    valid = jnp.asarray(dv)
    order = jnp.argsort(-jnp.where(valid, jnp.asarray(ds), -jnp.inf), axis=1)
    take = jax.vmap(lambda a, o: a[o])
    db_, dl_, dv_ = take(jnp.asarray(db), order), take(jnp.asarray(dl), order), take(valid, order)
    crowd = jnp.asarray(gc)
    iou = jnp.where(crowd[:, None, :], jax.vmap(jmap._crowd_iou)(db_, jnp.asarray(gb)),
                    jax.vmap(jmap.box_iou)(db_, jnp.asarray(gb)))
    area = jmap._box_area(jnp.asarray(gb))
    lo = jnp.asarray([r[1] for r in jmap.COCO_AREA_RANGES], jnp.float32)
    hi = jnp.asarray([r[2] for r in jmap.COCO_AREA_RANGES], jnp.float32)
    ignored = crowd[None] | (area[None] < lo[:, None, None]) | (area[None] > hi[:, None, None])
    classes = jnp.arange(num_classes)
    raw = dv_[None] & (dl_[None] == classes[:, None, None])
    ok = raw & (jnp.cumsum(raw, -1) - 1 < k_max)

    def per_cell(img_iou, d_ok, g_lab, g_ok, g_ig, g_crowd, cls, thr):
        gt_cls = g_ok & (g_lab == cls)
        return jmap._match_one(jnp.where(gt_cls[None, :], img_iou, -1.0), d_ok, gt_cls, g_ig, g_crowd, thr)

    f = jax.vmap(per_cell, in_axes=(0, 0, 0, 0, 0, 0, None, None))
    f = jax.vmap(f, in_axes=(None, 0, None, None, None, None, 0, None))
    f = jax.vmap(f, in_axes=(None, None, None, None, None, None, None, 0))
    f = jax.vmap(f, in_axes=(None, None, None, None, 0, None, None, None))
    mu, mi = f(iou, ok, jnp.asarray(gl), jnp.asarray(gv), ignored, crowd, classes,
               jnp.asarray(jmap.COCO_IOU_THRESHOLDS, jnp.float32))
    return np.asarray(mu), np.asarray(mi)


def _port_dense_flags(db, ds, dl, dv, gb, gl, gv, gc, num_classes, chunk_bytes):
    db, ds, dl, dv, gb, gl, gv, gc = (torch.from_numpy(np.asarray(x)) for x in (db, ds, dl, dv, gb, gl, gv, gc))
    order = torch.argsort(-torch.where(dv, ds, torch.tensor(float("-inf"))), dim=1, stable=True)
    db = torch.take_along_dim(db, order[..., None], 1)
    dl, dv = torch.take_along_dim(dl, order, 1), torch.take_along_dim(dv, order, 1)
    mu, mi, _, _ = tmap._match_flags(db, dv, dl, gb, gl, gv, gc, num_classes, 100, tmap.COCO_IOU_THRESHOLDS,
                                     tmap.COCO_AREA_RANGES, chunk_bytes)
    n_area, n_thr, flat = mu.shape
    labels = dl.reshape(-1).long()
    dense_u = torch.zeros((n_area, n_thr, num_classes, flat), dtype=torch.bool)
    dense_i = torch.zeros_like(dense_u)
    slots = torch.arange(flat)
    dense_u[:, :, labels, slots] = mu
    dense_i[:, :, labels, slots] = mi
    shape = (n_area, n_thr, num_classes, *dl.shape)
    return dense_u.reshape(shape).numpy(), dense_i.reshape(shape).numpy()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("chunk_bytes", [tmap.MATCH_CHUNK_BYTES, 3_000])
def test_match_flags_equal_the_dense_jax_flags_bit_for_bit(seed, chunk_bytes):
    args = _padded(seed, grid=seed % 2 == 0)
    want_u, want_i = _jax_dense_flags(*args, num_classes=3)
    got_u, got_i = _port_dense_flags(*args, num_classes=3, chunk_bytes=chunk_bytes)
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_array_equal(got_i, want_i)
    # per (area, threshold, class) TP and ignored-match counts
    np.testing.assert_array_equal(got_u.sum((3, 4)), want_u.sum((3, 4)))
    np.testing.assert_array_equal(got_i.sum((3, 4)), want_i.sum((3, 4)))


def _both(args, num_classes, **kw):
    jax_out = jmap.coco_map_padded(*(jnp.asarray(a) for a in args[:7]), num_classes=num_classes,
                                   gt_crowd=jnp.asarray(args[7]), **kw)
    port_out = tmap.coco_map_padded(*(torch.from_numpy(np.asarray(a)) for a in args[:7]), num_classes=num_classes,
                                    gt_crowd=torch.from_numpy(args[7]), **kw)
    return {k: np.asarray(v) for k, v in jax_out.items()}, {k: v.numpy() for k, v in port_out.items()}


def _assert_results(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("case", ["ties", "floats", "crowded", "caps", "thresholds", "one_class"])
def test_coco_map_padded_every_key_equals_jax(case):
    kw, num_classes = {}, 3
    if case == "ties":
        args = _padded(11)
    elif case == "floats":
        args = _padded(12, grid=False)
    elif case == "crowded":
        args = _padded(13, crowd=0.4)
    elif case == "caps":
        args = _padded(14, n_det=16)
        kw = {"max_detection_thresholds": (1, 2, 3)}
    elif case == "thresholds":
        args = _padded(15)
        kw = {"iou_thresholds": (0.3, 0.5, 0.75)}
    else:
        args, num_classes = _padded(16, num_classes=1), 1
    want, got = _both(args, num_classes, **kw)
    _assert_results(got, want)


def test_area_ranges_split_the_results_as_jax_does():
    # boxes spanning all three COCO size ranges
    rng = np.random.default_rng(3)
    args = list(_padded(17))
    scale = rng.choice([4.0, 40.0, 140.0], size=args[4].shape[:2])[..., None].astype(np.float32)
    args[4] = np.concatenate([args[4][..., :2], args[4][..., :2] + scale], -1)
    side = rng.choice([4.0, 40.0, 140.0], size=args[0].shape[:2])[..., None].astype(np.float32)
    args[0] = np.concatenate([args[0][..., :2], args[0][..., :2] + side], -1)
    want, got = _both(args, 3)
    for name in ("small", "medium", "large"):
        assert np.isfinite(want[f"map_{name}"])
    _assert_results(got, want)


def test_box_iou_and_giou_equal_jax():
    rng = np.random.default_rng(4)
    a, b = _boxes(rng, (7,), False), _boxes(rng, (5,), True)
    a[0] = [3, 3, 3, 9]  # zero area
    for jf, tf in ((jax_iou.box_iou, box_iou), (jax_iou.generalized_box_iou, generalized_box_iou)):
        np.testing.assert_allclose(tf(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                   np.asarray(jf(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL, atol=1e-7)


def _image(rng, n_det, n_gt, num_classes):
    gb, db = _boxes(rng, (n_gt,), True), _boxes(rng, (n_det,), True)
    return ({"boxes": db, "scores": (rng.integers(0, 16, n_det) / 16).astype(np.float32),
             "labels": rng.integers(0, num_classes, n_det)},
            {"boxes": gb, "labels": rng.integers(0, num_classes, n_gt), "iscrowd": rng.random(n_gt) < 0.1})


def _feed(metric, batch, to):
    metric.update([{k: to(v) for k, v in d.items()} for d, _ in batch],
                  [{k: to(v) for k, v in g.items()} for _, g in batch])


def _batches(seed, sizes=(3, 2, 4), max_det=14):
    rng = np.random.default_rng(seed)
    return [[_image(rng, int(rng.integers(0, max_det)), int(rng.integers(0, 7)), 3) for _ in range(k)] for k in sizes]


def _metrics(**kw):
    kw = dict(num_classes=3, max_detections=10, max_gt=8, class_metrics=True, **kw)
    return JaxMAP(**kw), MeanAveragePrecision(device="cpu", **kw)


def test_mean_average_precision_overflow_truncation_equals_jax():
    jax_m, port_m = _metrics()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for batch in _batches(5):
            _feed(jax_m, batch, jnp.asarray)
            _feed(port_m, batch, torch.as_tensor)
    assert any("truncated to max_detections=10" in str(w.message) for w in caught)
    want = {k: np.asarray(v) for k, v in jax_m.compute().items()}
    _assert_results({k: v.numpy() for k, v in port_m.compute().items()}, want)


def test_mean_average_precision_capacity_mode_equals_list_mode():
    _, port_list = _metrics()
    _, port_cap = _metrics(capacity=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for batch in _batches(6):
            _feed(port_list, batch, torch.as_tensor)
            _feed(port_cap, batch, torch.as_tensor)
    a, b = port_list.compute(), port_cap.compute()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, equal_nan=True)


def test_mean_average_precision_empty_is_nan_everywhere_as_in_jax():
    jax_m, port_m = _metrics()
    want, got = jax_m.compute(), port_m.compute()
    assert sorted(got) == sorted(want)
    assert all(np.all(np.isnan(v.numpy())) for v in got.values())
    assert got["map_per_class"].shape == (3,)


def test_mean_average_precision_forward_values_equal_jax():
    jax_m, port_m = _metrics()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for batch in _batches(7, sizes=(2, 3), max_det=9):
            want = jax_m([{k: jnp.asarray(v) for k, v in d.items()} for d, _ in batch],
                         [{k: jnp.asarray(v) for k, v in g.items()} for _, g in batch])
            got = port_m([{k: torch.as_tensor(v) for k, v in d.items()} for d, _ in batch],
                         [{k: torch.as_tensor(v) for k, v in g.items()} for _, g in batch])
            _assert_results({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()})
    _assert_results({k: v.numpy() for k, v in port_m.compute().items()},
                    {k: np.asarray(v) for k, v in jax_m.compute().items()})


def test_jax_checkpoint_loads_into_the_port_and_back():
    jax_m, port_m = _metrics()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for batch in _batches(8, max_det=9):
            _feed(jax_m, batch, jnp.asarray)
    want = {k: np.asarray(v) for k, v in jax_m.compute().items()}
    jax_m.persistent(True)
    port_m.load_state_dict(jax_m.state_dict())
    _assert_results({k: v.numpy() for k, v in port_m.compute().items()}, want)
    port_m.persistent(True)
    back, _ = _metrics()
    back.load_state_dict(port_m.state_dict())
    _assert_results({k: np.asarray(v) for k, v in back.compute().items()}, want)

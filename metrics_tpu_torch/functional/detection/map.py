"""COCO-style mean average precision on padded box sets.

Counterpart of ``metrics_tpu/functional/detection/map.py``: the same inputs
(images padded to ``(I, D, ...)`` detections and ``(I, G, ...)`` ground
truths with validity masks), the same pycocotools semantics and the same
result keys, computed another way.

The JAX package runs the greedy matching as a ``lax.scan`` over the D
detection slots, vmapped over area ranges x IoU thresholds x classes x
images, and XLA fuses each step. Run eagerly, every step would materialise
``(A, T, C, I, G)`` temporaries: 4.1 GB each at COCO val2017's size. This
module computes the same match flags over only the (image, class) cells that
hold a detection, since a detection of class c can only match a class-c
ground truth and every other cell's flags are all false in the dense form:

* each cell gathers its detections in score order (at most the largest
  ``maxDets`` of them) and its ground truths in column order, padded to the
  largest counts of the cells around it;
* cells are sorted by their detection count, largest first, and walked in
  chunks sized to :data:`MATCH_CHUNK_BYTES`; within a chunk, step ``r``
  matches the ``r``-th detection of every cell that has one, for every area
  range and threshold at once, as ``_match_one``'s scan step does;
* the preference is ``_match_one``'s: the best IoU >= thr among available
  un-ignored ground truths, else among available ignored ones, the first
  maximum winning a tie (``torch.max`` returns the first maximal index, as
  ``jnp.argmax`` does, over the same column order); crowd ground truths
  overlap by intersection over detection area and are never consumed.

AP is the 101-point envelope over each class's detections ranked across
images by descending score, ties in (image, in-image rank) order: both sorts
are stable, as ``jnp.argsort`` is. The TP / FP cumulative counts are int64,
and the precision and recall are each one float32 division of them, which
equals the JAX package's float32 cumsums below 2**24 detections of a class.
The recall grid is the JAX package's ``jnp.linspace(0, 1, 101)`` in float32,
``k * float32(0.01)``, so a recall that lands exactly on a grid point selects
the same rank.
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.detection.iou import _areas, _intersection, _iou, _ratio
from metrics_tpu_torch.utils.data import device_constant

COCO_IOU_THRESHOLDS = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))
COCO_AREA_RANGES = (
    ("all", 0.0, 1e10),
    ("small", 0.0, 32.0**2),
    ("medium", 32.0**2, 96.0**2),
    ("large", 96.0**2, 1e10),
)
COCO_MAX_DETS = (1, 10, 100)
_RECALL_GRID = 101

# Budget of a matching chunk's temporaries: the per-step (A, T, cells, G)
# masks and candidates (~16 bytes an element) and the chunk's (cells, D, G)
# overlap tables (~12 bytes). With it, the peak device memory of a COCO
# val2017 evaluation stays near 2 GiB.
MATCH_CHUNK_BYTES = 1 << 30


def _recall_grid(device: torch.device) -> Tensor:
    return device_constant(
        ("coco_recall_grid",), device,
        lambda: np.arange(_RECALL_GRID, dtype=np.float32) * np.float32(0.01), torch.float32,
    )


def _crowd_iou(det_boxes: Tensor, gt_boxes: Tensor) -> Tensor:
    """``(..., D, G)`` intersection over DETECTION area: pycocotools' crowd overlap."""
    return _ratio(_intersection(det_boxes, gt_boxes), _areas(det_boxes)[..., :, None])


def _area_flags(areas: Tensor, area_ranges: Tuple[Tuple[str, float, float], ...]) -> Tensor:
    """``(A, ...)``: the box lies outside each area range."""
    lo = torch.tensor([r[1] for r in area_ranges], dtype=torch.float32, device=areas.device)
    hi = torch.tensor([r[2] for r in area_ranges], dtype=torch.float32, device=areas.device)
    shape = (-1,) + (1,) * areas.ndim
    return (areas[None] < lo.view(shape)) | (areas[None] > hi.view(shape))


def _runs(keys: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Stable sort of ``keys``: (sorted keys, source positions, rank of each sorted entry within its run)."""
    skeys, src = torch.sort(keys, stable=True)
    pos = torch.arange(keys.shape[0], device=keys.device)
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    return skeys, src, pos - start


def _chunks(nd: np.ndarray, ng: np.ndarray, n_at: int, budget: int):
    """Host plan: ``[(start, stop)]`` over cells sorted by ``nd`` descending, each
    chunk's temporaries within ``budget`` bytes (one cell at least)."""
    out, start, n = [], 0, nd.shape[0]
    while start < n:
        d = int(nd[start])
        g_max = np.maximum.accumulate(np.maximum(ng[start:], 1))
        cost = np.arange(1, n - start + 1) * g_max * (16 * n_at + 12 * d)
        stop = start + max(int(np.searchsorted(cost, budget, side="right")), 1)
        out.append((start, stop))
        start = stop
    return out


def _match_flags(
    det_boxes: Tensor, det_valid_ok: Tensor, det_labels: Tensor,
    gt_boxes: Tensor, gt_labels: Tensor, gt_valid: Tensor, gt_crowd: Tensor,
    num_classes: int, k_max: int,
    iou_thresholds: Tuple[float, ...],
    area_ranges: Tuple[Tuple[str, float, float], ...],
    chunk_bytes: int = MATCH_CHUNK_BYTES,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Greedy COCO matching over the cells that hold a detection.

    Detections come in-image score-sorted, ``(I, D, ...)``. Returns ``(mu, mi,
    ok, rank)``: ``(A, T, I * D)`` flags of each detection matched to an
    un-ignored / ignored ground truth (``_match_one``'s, for the detection's
    own class), the ``(I * D,)`` detections that take part (valid, a label in
    ``[0, num_classes)``, and among the first ``k_max`` of their (image,
    class) cell) and each detection's rank within its cell.
    """
    dev = det_boxes.device
    n_img, n_det = det_labels.shape
    n_gt_slots = gt_labels.shape[1]
    n_area, n_thr = len(area_ranges), len(iou_thresholds)
    n_flat = n_img * n_det

    # cells: (image, class) keys of the detections, stably grouped, so a cell
    # lists its detections in score order
    img_d = torch.arange(n_img, device=dev).repeat_interleave(n_det)
    lab_d = det_labels.reshape(-1).to(torch.int64)
    lab_ok = det_valid_ok.reshape(-1) & (lab_d >= 0) & (lab_d < num_classes)
    sentinel = n_img * num_classes
    dkey = torch.where(lab_ok, img_d * num_classes + lab_d, torch.full_like(lab_d, sentinel))
    skey, dsrc, drank = _runs(dkey)
    rank = torch.empty_like(drank)
    rank[dsrc] = drank
    ok = lab_ok & (rank < k_max)

    img_g = torch.arange(n_img, device=dev).repeat_interleave(n_gt_slots)
    lab_g = gt_labels.reshape(-1).to(torch.int64)
    gt_ok = gt_valid.reshape(-1) & (lab_g >= 0) & (lab_g < num_classes)
    gkey = torch.where(gt_ok, img_g * num_classes + lab_g, torch.full_like(lab_g, sentinel))
    gskey, gsrc, _ = _runs(gkey)

    mu = torch.zeros((n_area, n_thr, n_flat), dtype=torch.bool, device=dev)
    mi = torch.zeros_like(mu)
    cell_first = (drank == 0) & (skey < sentinel)
    cell_start = torch.nonzero(cell_first).squeeze(1)
    if cell_start.numel() == 0:
        return mu, mi, ok, rank
    cell_key = skey[cell_start]
    run_end = torch.cat([cell_start[1:], (skey < sentinel).sum().reshape(1)])
    cell_nd = torch.clamp(run_end - cell_start, max=k_max)
    g_lo = torch.searchsorted(gskey, cell_key, right=False)
    cell_ng = torch.searchsorted(gskey, cell_key, right=True) - g_lo
    order = torch.argsort(-cell_nd, stable=True)
    cell_start, cell_nd, g_lo, cell_ng = cell_start[order], cell_nd[order], g_lo[order], cell_ng[order]
    nd_host, ng_host = cell_nd.cpu().numpy(), cell_ng.cpu().numpy()  # the one host read of the plan

    flat_boxes = det_boxes.reshape(-1, 4)
    flat_gt = gt_boxes.reshape(-1, 4)
    flat_crowd = gt_crowd.reshape(-1)
    thr = torch.tensor(iou_thresholds, dtype=torch.float32, device=dev).view(1, n_thr, 1)
    for start, stop in _chunks(nd_host, ng_host, n_area * n_thr, chunk_bytes):
        n, d_max, g_max = stop - start, int(nd_host[start]), max(int(ng_host[start:stop].max()), 1)
        d_slot = torch.arange(d_max, device=dev)
        d_ok = d_slot[None, :] < cell_nd[start:stop, None]
        det_pos = dsrc[torch.where(d_ok, cell_start[start:stop, None] + d_slot[None, :], 0)]  # (n, Dc)
        g_slot = torch.arange(g_max, device=dev)
        g_ok = g_slot[None, :] < cell_ng[start:stop, None]
        gt_pos = gsrc[torch.where(g_ok, g_lo[start:stop, None] + g_slot[None, :], 0)]  # (n, Gc)

        dbox, gbox = flat_boxes[det_pos], flat_gt[gt_pos]
        crowd = flat_crowd[gt_pos] & g_ok
        overlap = torch.where(crowd[:, None, :], _crowd_iou(dbox, gbox), _iou(dbox, gbox))
        overlap = torch.where(g_ok[:, None, :], overlap, torch.full_like(overlap, -1.0))  # (n, Dc, Gc)
        ignored = crowd[None] | _area_flags(_areas(gbox), area_ranges)  # (A, n, Gc)
        ignored = ignored[:, None]  # (A, 1, n, Gc)
        unused = torch.ones((n_area, n_thr, n, g_max), dtype=torch.bool, device=dev)
        mu_c = torch.zeros((n_area, n_thr, n, d_max), dtype=torch.bool, device=dev)
        mi_c = torch.zeros_like(mu_c)
        active = np.searchsorted(-nd_host[start:stop], -np.arange(d_max), side="left")  # cells with nd > r
        minus_one = torch.tensor(-1.0, device=dev)
        for r in range(d_max):
            m = int(active[r])  # cells with an r-th detection: a prefix, cells sorted by count
            row = overlap[:m, r, :]  # (m, Gc)
            free = unused[:, :, :m]
            avail = g_ok[:m] & (free | crowd[:m])
            ig = ignored[..., :m, :]
            best_u_val, best_u = torch.max(torch.where(avail & ~ig, row, minus_one), dim=-1)
            best_i_val, best_i = torch.max(torch.where(avail & ig, row, minus_one), dim=-1)
            hit_u = best_u_val >= thr
            hit_i = ~hit_u & (best_i_val >= thr)
            chosen = torch.where(hit_u, best_u, best_i)[..., None]  # (A, T, m, 1)
            chosen_crowd = torch.gather(crowd[:m].expand(n_area, n_thr, m, g_max), -1, chosen)
            consume = (hit_u | hit_i)[..., None] & ~chosen_crowd
            free.scatter_(-1, chosen, torch.gather(free, -1, chosen) & ~consume)
            mu_c[:, :, :m, r] = hit_u
            mi_c[:, :, :m, r] = hit_i
        dest = det_pos[d_ok]
        mu[:, :, dest] = mu_c[:, :, d_ok]
        mi[:, :, dest] = mi_c[:, :, d_ok]
    return mu, mi, ok, rank


def _interp_ap(tp: Tensor, fp: Tensor, cls: Tensor, n_gt: Tensor, num_classes: int) -> Tensor:
    """``(A, T, C)`` 101-point interpolated AP from ``(A, T, M)`` TP / FP flags of
    the detections ranked per class (``cls`` ascending, ``(M,)``) and ``(A, C)``
    un-ignored ground-truth counts. NaN where a class has no ground truth."""
    dev = tp.device
    n_area, n_thr, m = tp.shape
    grid = _recall_grid(dev)
    seg_count = torch.bincount(cls, minlength=num_classes)
    seg_end = torch.cumsum(seg_count, 0)
    seg_start = seg_end - seg_count
    if m == 0:
        ap = torch.zeros((n_area, n_thr, num_classes), dtype=torch.float32, device=dev)
    else:
        tps = torch.cumsum(tp.to(torch.int64), -1)
        fps = torch.cumsum(fp.to(torch.int64), -1)
        before = seg_start[cls] - 1  # the entry before each class's first, -1 for the first class
        tps = tps - torch.where(before >= 0, tps[..., before.clamp(min=0)], torch.zeros_like(tps))
        fps = fps - torch.where(before >= 0, fps[..., before.clamp(min=0)], torch.zeros_like(fps))
        gt = n_gt.to(torch.float32)[:, None, cls]  # (A, 1, M)
        tps_f = tps.to(torch.float32)
        recall = tps_f / torch.clamp(gt, min=1.0)
        precision = tps_f / torch.clamp((tps + fps).to(torch.float32), min=1e-30)
        # best precision at or after each rank within the class: a reverse
        # cumulative max of (class from the back, precision bits), exact in int64
        # because a non-negative float32's bits order as its values do
        hi = (num_classes - 1 - cls).to(torch.int64) << 32
        packed = hi + precision.view(torch.int32).to(torch.int64)
        envelope = torch.cummax(packed.flip(-1), -1).values.flip(-1)
        envelope = (envelope & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
        # first rank of each class whose recall reaches each grid point
        key = (cls.to(torch.int64) << 32) + recall.view(torch.int32).to(torch.int64)
        classes = torch.arange(num_classes, device=dev, dtype=torch.int64)
        query = (classes[:, None] << 32) + grid.view(torch.int32).to(torch.int64)[None, :]
        flat_key = key.reshape(n_area * n_thr, m)
        idx = torch.searchsorted(flat_key, query.reshape(1, -1).expand(n_area * n_thr, -1).contiguous())
        idx = idx.view(n_area, n_thr, num_classes, _RECALL_GRID)
        valid = idx < seg_end[None, None, :, None]
        env = torch.gather(envelope, -1, idx.clamp(max=m - 1).view(n_area, n_thr, -1)).view(idx.shape)
        ap = torch.where(valid, env, torch.zeros_like(env)).mean(-1)
    nan = torch.full_like(ap, float("nan"))
    return torch.where(n_gt[:, None, :] > 0, ap, nan)


def coco_map_padded(
    det_boxes: Tensor, det_scores: Tensor, det_labels: Tensor, det_valid: Tensor,
    gt_boxes: Tensor, gt_labels: Tensor, gt_valid: Tensor,
    num_classes: int,
    iou_thresholds: Tuple[float, ...] = COCO_IOU_THRESHOLDS,
    gt_crowd: Optional[Tensor] = None,
    max_detection_thresholds: Tuple[int, ...] = COCO_MAX_DETS,
    area_ranges: Tuple[Tuple[str, float, float], ...] = COCO_AREA_RANGES,
) -> Dict[str, Tensor]:
    """COCO mAP/mAR over padded per-image box sets.

    Args:
        det_boxes: ``(I, D, 4)`` xyxy detections per image (padded).
        det_scores / det_labels / det_valid: ``(I, D)`` confidence, integer
            class, and validity of each detection slot.
        gt_boxes: ``(I, G, 4)``; gt_labels / gt_valid: ``(I, G)``.
        num_classes: class count (labels in ``[0, num_classes)``).
        iou_thresholds: tuple of IoU thresholds (default COCO 0.50:0.05:0.95).
        gt_crowd: ``(I, G)`` bool ``iscrowd`` flags (None -> no crowds).
        max_detection_thresholds: recall caps (default COCO {1, 10, 100});
            the largest also caps the AP ranking, per (image, class).
        area_ranges: named (lo, hi) box-area ranges; ``area_ranges[0]``
            ("all") feeds the headline map/mar keys.

    Returns:
        dict with ``map``, ``map_50``, ``map_75``, per-size ``map_<name>``,
        ``mar_<k>`` per cap, per-size ``mar_<name>`` (at the largest cap), and
        per-class ``map_per_class`` / ``mar_<kmax>_per_class``
        ``(num_classes,)`` vectors (nan for classes without ground truth).

    Example:
        >>> import torch
        >>> box = torch.tensor([[[0.0, 0.0, 10.0, 10.0]]])
        >>> out = coco_map_padded(box, torch.tensor([[0.9]]), torch.tensor([[0]]), torch.tensor([[True]]),
        ...                       box, torch.tensor([[0]]), torch.tensor([[True]]), num_classes=1)
        >>> float(out["map"])
        1.0
    """
    dev = det_boxes.device
    n_img, n_det = det_scores.shape
    iou_thresholds = tuple(float(t) for t in iou_thresholds)
    k_max = max(max_detection_thresholds)
    if gt_crowd is None:
        gt_crowd = torch.zeros(gt_valid.shape, dtype=torch.bool, device=dev)
    det_valid = det_valid.to(torch.bool)

    # rank detections inside each image once (descending score; ghosts last)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    order = torch.argsort(-torch.where(det_valid, det_scores.to(torch.float32), neg_inf), dim=1, stable=True)
    det_boxes = torch.take_along_dim(det_boxes.to(torch.float32), order[..., None], dim=1)
    det_scores = torch.take_along_dim(det_scores.to(torch.float32), order, dim=1)
    det_labels = torch.take_along_dim(det_labels, order, dim=1)
    det_valid = torch.take_along_dim(det_valid, order, dim=1)
    gt_boxes = gt_boxes.to(torch.float32)
    gt_valid = gt_valid.to(torch.bool)
    gt_crowd = gt_crowd.to(torch.bool)

    mu, mi, ok, rank = _match_flags(
        det_boxes, det_valid, det_labels, gt_boxes, gt_labels, gt_valid, gt_crowd,
        num_classes, k_max, iou_thresholds, area_ranges, MATCH_CHUNK_BYTES,
    )

    # (A, C) un-ignored ground truths per range
    lab_g = gt_labels.reshape(-1).to(torch.int64)
    gt_in = gt_valid.reshape(-1) & (lab_g >= 0) & (lab_g < num_classes)
    gt_ig = gt_crowd.reshape(-1)[None] | _area_flags(_areas(gt_boxes.reshape(-1, 4)), area_ranges)  # (A, I*G)
    counted = (gt_in[None] & ~gt_ig).to(torch.int64)
    n_area = len(area_ranges)
    n_gt = torch.zeros((n_area, num_classes), dtype=torch.int64, device=dev)
    n_gt.index_add_(1, torch.where(gt_in, lab_g, 0), counted)

    # each class's detections across images by descending score, ties in
    # (image, in-image rank) order: two stable sorts
    idx = torch.nonzero(ok).squeeze(1)
    cls = det_labels.reshape(-1)[idx].to(torch.int64)
    by_score = torch.argsort(-det_scores.reshape(-1)[idx], stable=True)
    by_class = torch.argsort(cls[by_score], stable=True)
    ranked = idx[by_score[by_class]]
    cls = cls[by_score[by_class]]
    det_out = _area_flags(_areas(det_boxes.reshape(-1, 4)[ranked]), area_ranges)  # (A, M)
    tp = mu[:, :, ranked]
    # FP: taking part, unmatched, and not out of the range (matched-to-ignored and
    # unmatched out-of-range detections count neither way)
    fp = ~tp & ~mi[:, :, ranked] & ~det_out[:, None]
    ap = _interp_ap(tp, fp, cls, n_gt, num_classes)  # (A, T, C)

    def recall_at(k: int) -> Tensor:
        """(A, T, C) recall with at most k same-class detections per image."""
        hits = torch.zeros((n_area, len(iou_thresholds), num_classes), dtype=torch.int64, device=dev)
        within = (rank[ranked] < k).to(torch.int64)
        hits.index_add_(2, cls, tp.to(torch.int64) * within)
        r = hits.to(torch.float32) / torch.clamp(n_gt[:, None].to(torch.float32), min=1.0)
        return torch.where(n_gt[:, None] > 0, r, torch.full_like(r, float("nan")))

    recalls = {k: recall_at(k) for k in max_detection_thresholds}
    rec_max = recalls[k_max]

    nan = torch.tensor(float("nan"), device=dev)
    t50 = iou_thresholds.index(0.5) if 0.5 in iou_thresholds else None
    t75 = iou_thresholds.index(0.75) if 0.75 in iou_thresholds else None
    out = {
        "map": torch.nanmean(ap[0]),
        "map_50": torch.nanmean(ap[0, t50]) if t50 is not None else nan,
        "map_75": torch.nanmean(ap[0, t75]) if t75 is not None else nan,
        "map_per_class": torch.nanmean(ap[0], dim=0),
        f"mar_{k_max}_per_class": torch.nanmean(rec_max[0], dim=0),
    }
    for k, rec in recalls.items():
        out[f"mar_{k}"] = torch.nanmean(rec[0])
    for a, (name, _, _) in enumerate(area_ranges):
        if name == "all":
            continue
        out[f"map_{name}"] = torch.nanmean(ap[a])
        out[f"mar_{name}"] = torch.nanmean(rec_max[a])
    return out

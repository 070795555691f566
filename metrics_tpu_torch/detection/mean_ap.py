"""MeanAveragePrecision module. Counterpart of ``metrics_tpu/detection/mean_ap.py``.

Result-dict key parity with later torchmetrics ``detection/mean_ap.py``:
``map``, ``map_50``, ``map_75``, ``map_small/medium/large``,
``mar_1/10/100``, ``mar_small/medium/large``, plus per-class vectors under
``class_metrics``. Missing classes are ``nan``.

The eight per-image states are the JAX package's, list states with an
``item_shape`` (PaddedBuffers with ``capacity=``), gathered across ranks at
``compute()``. An update pads its images on the device and appends them as
one ``(B, ...)`` block a state, where the JAX package appends one image at a
time; the stacked rows are the same.
"""
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.detection.map import (
    COCO_AREA_RANGES,
    COCO_IOU_THRESHOLDS,
    COCO_MAX_DETS,
    coco_map_padded,
)
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _pad_images(columns: List[Tuple[List[Tensor], tuple, torch.dtype]], cap: int,
                device: torch.device) -> List[Tensor]:
    """Each column's per-image rows at the front of ``(B, cap, *item)`` slots, then the
    ``(B, cap)`` validity mask. The columns of one side share the per-image counts."""
    counts = [r.shape[0] for r in columns[0][0]]
    n_img = len(counts)
    valid = torch.zeros((n_img, cap), dtype=torch.bool, device=device)
    out = [torch.zeros((n_img, cap, *item), dtype=dtype, device=device) for _, item, dtype in columns]
    if sum(counts):
        # slot i * cap + j of image i's j-th row, one copy for every column; index_copy_ into the flat view
        # (an advanced-index assignment takes milliseconds on the CPU)
        flat = np.repeat(np.arange(n_img) * cap, counts) + np.concatenate([np.arange(c) for c in counts])
        where = torch.from_numpy(flat).to(device)
        for padded, (rows, item, dtype) in zip(out, columns):
            padded.view(n_img * cap, *item).index_copy_(0, where, torch.cat(rows).to(dtype))
        valid.view(-1)[where] = True
    return out + [valid]


class MeanAveragePrecision(Metric):
    """COCO-style mean average precision for object detection.

    ``update`` takes the torchmetrics-style per-image dict lists::

        preds  = [{"boxes": (N, 4) xyxy, "scores": (N,), "labels": (N,)}, ...]
        target = [{"boxes": (M, 4) xyxy, "labels": (M,),
                   "iscrowd": (M,) optional}, ...]

    Crowd ground truths use intersection-over-detection-area overlap, may
    match any number of detections, and are ignore-flagged (detections
    matched to them count neither as TP nor FP): pycocotools semantics.

    Every image is padded to ``max_detections`` / ``max_gt`` slots.
    ``max_detections`` is the per-image CAPACITY (all classes together), not
    the COCO maxDets cap: the COCO caps are ``max_detection_thresholds``,
    applied per (image, class). An image exceeding the capacity keeps its
    top-scoring detections and a warning names the truncation.

    Args:
        num_classes: class count (labels in ``[0, num_classes)``).
        iou_thresholds: tuple of IoU thresholds (default COCO 0.50:0.05:0.95).
        max_detections: per-image detection capacity across classes
            (default 100); overflow keeps the top scores and warns.
        max_gt: per-image ground-truth cap (exceeding it raises).
        max_detection_thresholds: the COCO ``maxDets`` recall caps, applied
            per (image, class) (default ``(1, 10, 100)``; keys ``mar_<k>``).
        class_metrics: include the per-class vectors in the result dict.

    Example:
        >>> import torch
        >>> metric = MeanAveragePrecision(num_classes=2, device="cpu")
        >>> preds = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]),
        ...           "scores": torch.tensor([0.9]), "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]),
        ...            "labels": torch.tensor([0])}]
        >>> out = metric(preds, target)
        >>> float(out["map"])
        1.0
    """

    def __init__(
        self,
        num_classes: int,
        iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS,
        max_detections: int = 100,
        max_gt: int = 100,
        max_detection_thresholds: Sequence[int] = COCO_MAX_DETS,
        class_metrics: bool = False,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
        capacity: Optional[int] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
            capacity=capacity,
        )
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError(f"`num_classes` must be a positive int, got {num_classes!r}")
        if max_detections < 1 or max_gt < 1:
            raise ValueError("`max_detections` and `max_gt` must be positive")
        if not max_detection_thresholds or any(int(k) < 1 for k in max_detection_thresholds):
            raise ValueError("`max_detection_thresholds` must be positive ints")
        self.num_classes = num_classes
        self.iou_thresholds = tuple(float(t) for t in iou_thresholds)
        self.max_detections = max_detections
        self.max_gt = max_gt
        self.max_detection_thresholds = tuple(int(k) for k in max_detection_thresholds)
        self.class_metrics = class_metrics
        d, g = max_detections, max_gt
        self.add_state("det_boxes", default=[], dist_reduce_fx=None, item_shape=(d, 4))
        self.add_state("det_scores", default=[], dist_reduce_fx=None, item_shape=(d,))
        self.add_state("det_labels", default=[], dist_reduce_fx=None, item_shape=(d,), item_dtype=torch.int32)
        self.add_state("det_valid", default=[], dist_reduce_fx=None, item_shape=(d,), item_dtype=torch.bool)
        self.add_state("gt_boxes", default=[], dist_reduce_fx=None, item_shape=(g, 4))
        self.add_state("gt_labels", default=[], dist_reduce_fx=None, item_shape=(g,), item_dtype=torch.int32)
        self.add_state("gt_valid", default=[], dist_reduce_fx=None, item_shape=(g,), item_dtype=torch.bool)
        self.add_state("gt_crowd", default=[], dist_reduce_fx=None, item_shape=(g,), item_dtype=torch.bool)

    def _det_rows(self, entry: Dict[str, Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
        boxes = torch.as_tensor(entry["boxes"], device=self.device).to(torch.float32).reshape(-1, 4)
        scores = torch.as_tensor(entry["scores"], device=self.device).to(torch.float32).reshape(-1)
        labels = torch.as_tensor(entry["labels"], device=self.device).to(torch.int32).reshape(-1)
        if not (boxes.shape[0] == scores.shape[0] == labels.shape[0]):
            raise ValueError(
                f"boxes/scores/labels disagree: {boxes.shape[0]}/{scores.shape[0]}/{labels.shape[0]}"
            )
        n, cap = boxes.shape[0], self.max_detections
        if n > cap:
            # capacity overflow: keep the top-scoring `cap` detections ACROSS
            # classes. This can drop detections pycocotools (whose maxDets caps
            # are per class) would keep, hence the loud notice.
            rank_zero_warn(
                f"MeanAveragePrecision: image with {n} detections truncated to"
                f" max_detections={cap} (top scores across classes); raise"
                " `max_detections` to evaluate every detection as pycocotools does."
            )
            keep = torch.argsort(-scores, stable=True)[:cap]
            boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        return boxes, scores, labels

    def _gt_rows(self, entry: Dict[str, Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
        boxes = torch.as_tensor(entry["boxes"], device=self.device).to(torch.float32).reshape(-1, 4)
        labels = torch.as_tensor(entry["labels"], device=self.device).to(torch.int32).reshape(-1)
        if boxes.shape[0] != labels.shape[0]:
            raise ValueError(f"gt boxes/labels disagree: {boxes.shape[0]}/{labels.shape[0]}")
        crowd = entry.get("iscrowd")
        crowd = (
            torch.zeros(labels.shape[0], dtype=torch.bool, device=self.device)
            if crowd is None
            else torch.as_tensor(crowd, device=self.device).reshape(-1).to(torch.bool)
        )
        if crowd.shape[0] != labels.shape[0]:
            raise ValueError(f"gt iscrowd/labels disagree: {crowd.shape[0]}/{labels.shape[0]}")
        if boxes.shape[0] > self.max_gt:
            raise ValueError(f"image has {boxes.shape[0]} ground-truth boxes > max_gt={self.max_gt}")
        return boxes, labels, crowd

    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:
        if len(preds) != len(target):
            raise ValueError(f"preds has {len(preds)} images, target {len(target)}")
        if not preds:
            return
        dets = [self._det_rows(e) for e in preds]
        gts = [self._gt_rows(e) for e in target]
        det_boxes, det_scores, det_labels, det_valid = _pad_images(
            [([x[0] for x in dets], (4,), torch.float32), ([x[1] for x in dets], (), torch.float32),
             ([x[2] for x in dets], (), torch.int32)], self.max_detections, self.device)
        gt_boxes, gt_labels, gt_crowd, gt_valid = _pad_images(
            [([x[0] for x in gts], (4,), torch.float32), ([x[1] for x in gts], (), torch.int32),
             ([x[2] for x in gts], (), torch.bool)], self.max_gt, self.device)
        for name, value in (("det_boxes", det_boxes), ("det_scores", det_scores), ("det_labels", det_labels),
                            ("det_valid", det_valid), ("gt_boxes", gt_boxes), ("gt_labels", gt_labels),
                            ("gt_valid", gt_valid), ("gt_crowd", gt_crowd)):
            self._append(name, value)

    def compute(self) -> Dict[str, Tensor]:
        k_largest = max(self.max_detection_thresholds)
        per_class_keys = ("map_per_class", f"mar_{k_largest}_per_class")
        raw = self.det_boxes
        empty = isinstance(raw, (list, tuple)) and len(raw) == 0
        det_boxes = None if empty else as_values(raw)
        if empty or det_boxes.shape[0] == 0:
            nan = torch.tensor(float("nan"), device=self.device)
            out = {"map": nan, "map_50": nan, "map_75": nan}
            for k in self.max_detection_thresholds:
                out[f"mar_{k}"] = nan
            for name, _, _ in COCO_AREA_RANGES[1:]:
                out[f"map_{name}"] = nan
                out[f"mar_{name}"] = nan
            if self.class_metrics:
                for key in per_class_keys:
                    out[key] = torch.full((self.num_classes,), float("nan"), device=self.device)
            return out
        out = coco_map_padded(
            det_boxes,
            as_values(self.det_scores),
            as_values(self.det_labels),
            as_values(self.det_valid),
            as_values(self.gt_boxes),
            as_values(self.gt_labels),
            as_values(self.gt_valid),
            num_classes=self.num_classes,
            iou_thresholds=self.iou_thresholds,
            gt_crowd=as_values(self.gt_crowd),
            max_detection_thresholds=self.max_detection_thresholds,
        )
        if not self.class_metrics:
            out = {k: v for k, v in out.items() if k not in per_class_keys}
        return out

"""Object-detection metrics. Counterpart of ``metrics_tpu/detection/``.

``MeanAveragePrecision`` accumulates per-image padded box sets and runs the
COCO evaluation at ``compute()``; see
``metrics_tpu_torch/functional/detection/map.py`` for the engine.
"""
from metrics_tpu_torch.detection.mean_ap import MeanAveragePrecision

__all__ = ["MeanAveragePrecision"]

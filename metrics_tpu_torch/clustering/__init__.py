"""Clustering metrics. Counterpart of ``metrics_tpu/clustering/``.

The extrinsic scores stream one ``(num_clusters, num_classes)`` int64
contingency state and apply a closed form at ``compute()``; the intrinsic
ones score the data's own geometry (see ``intrinsic.py``).
"""
from metrics_tpu_torch.clustering.intrinsic import CalinskiHarabaszScore, DaviesBouldinScore
from metrics_tpu_torch.clustering.scores import (
    AdjustedMutualInfoScore,
    AdjustedRandScore,
    CompletenessScore,
    FowlkesMallowsScore,
    HomogeneityScore,
    MutualInfoScore,
    NormalizedMutualInfoScore,
    RandScore,
    VMeasureScore,
)

__all__ = [
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "CalinskiHarabaszScore",
    "CompletenessScore",
    "DaviesBouldinScore",
    "FowlkesMallowsScore",
    "HomogeneityScore",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "RandScore",
    "VMeasureScore",
]

"""Scored rows of a click-through evaluation set, resident on the device.

The set is cut into ``parts`` parts (the first ones a row longer where the
rows do not divide), each made by its own ``torch.Generator`` from the seed,
so a rank of a ``world`` holds ``parts / world`` whole parts and the set is
the same whatever the number of ranks. A row's label is 1 with probability
``positive_rate`` (int64); its score is the float32 sigmoid of a float32
logit ``base_logit + N(0, 1) + class_shift * label``. Nothing is rounded to a
grid: ties are the ones float32 makes. With equal-variance classes the AUROC
is ``Phi(class_shift / sqrt(2))``.
"""
from typing import Any, Dict, List, Tuple

import torch

from portbench.seeds import part_seed


def part_rows(spec: Dict[str, Any]) -> List[int]:
    q, r = divmod(spec["rows"], spec["parts"])
    return [q + 1 if p < r else q for p in range(spec["parts"])]


def fill_part(spec: Dict[str, Any], seed: int, part: int, scores: torch.Tensor, labels: torch.Tensor) -> None:
    """Write part ``part`` into ``scores`` (float32) and ``labels`` (int64) of its length."""
    g = torch.Generator(device=scores.device)
    g.manual_seed(part_seed(seed, part))
    n = len(scores)
    torch.lt(torch.rand(n, generator=g, device=scores.device), spec["positive_rate"], out=labels)
    logits = torch.randn(n, generator=g, device=scores.device)
    logits += labels * spec["class_shift"] + spec["base_logit"]
    torch.sigmoid(logits, out=scores)


def make_parts(spec: Dict[str, Any], seed: int, parts, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, labels) of the given parts, in order, in one buffer each."""
    sizes = part_rows(spec)
    n = sum(sizes[p] for p in parts)
    scores = torch.empty(n, dtype=torch.float32, device=device)
    labels = torch.empty(n, dtype=torch.int64, device=device)
    at = 0
    for p in parts:
        fill_part(spec, seed, p, scores[at:at + sizes[p]], labels[at:at + sizes[p]])
        at += sizes[p]
    return scores, labels


def rank_parts(spec: Dict[str, Any], rank: int, world: int) -> range:
    if spec["parts"] % world:
        raise ValueError(f"{spec['parts']} parts do not split over {world} ranks")
    per = spec["parts"] // world
    return range(rank * per, (rank + 1) * per)


def make(spec: Dict[str, Any], seed: int, rank: int, world: int, device: torch.device) -> Dict[str, Any]:
    """This rank's rows, and the updates of an epoch over them. ``update_rows``
    is the eval batch over all ranks: a rank's update is its ``1 / world``
    share, a slice of its own rows, the last one shorter."""
    scores, labels = make_parts(spec, seed, rank_parts(spec, rank, world), device)
    if spec["update_rows"] % world:
        raise ValueError(f"an eval batch of {spec['update_rows']} rows does not split over {world} ranks")
    u = spec["update_rows"] // world
    updates = [{"preds": scores[i:i + u], "target": labels[i:i + u]} for i in range(0, len(scores), u)]
    return {"arrays": {"preds": scores, "target": labels}, "updates": updates}

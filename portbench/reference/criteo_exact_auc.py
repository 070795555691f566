"""Plain reference of exact AUROC and average precision over an evaluation
set, in plain PyTorch on the device, in float64.

The scores are sorted once (descending); the labels follow the order; a run
of equal scores is one threshold. The true and false positives at each
threshold are float64 cumulative sums of 0/1 labels, exact below 2**53 rows.
AUROC is the trapezoid under (fpr, tpr) from (0, 0), ties on a diagonal; AP
is sum over thresholds of (recall step) x precision, without interpolation
(``chip_smoke.py``'s ``_curve_oracle``).

The set is the benchmark's own, made again from the seed where a rank holds
only its share. The control is the same computation over the scores rounded
to bfloat16, the precision below the configuration's float32 scores.
"""
from typing import Any, Dict, List

import torch

# One number for both curves, the wider of the two absolute gaps: AUROC alone does
# not separate the port's float32 arithmetic from the bfloat16 control at this
# density of scores (a bf16 bin holds few positive-negative pairs), AP does. The
# limit lies between the widest gap of sound runs of the port over a dozen seeds
# and more (the lower reading) and the smallest gap of the bfloat16 control on
# three seeds (the upper reading); PERF.md gives both.
LIMITS = {"curve_abs_gap": 2e-5}


def exact_curves(scores: torch.Tensor, labels: torch.Tensor) -> Dict[str, float]:
    s, order = torch.sort(scores, descending=True)
    y = labels[order].to(torch.float64)
    del order
    last = torch.ones(len(s), dtype=torch.bool, device=s.device)
    last[:-1] = s[1:] != s[:-1]
    del s
    tps = torch.cumsum(y, 0)[last]
    fps = torch.nonzero(last).squeeze(1).to(torch.float64) + 1 - tps
    del y, last
    zero = torch.zeros(1, dtype=torch.float64, device=tps.device)
    tpr = torch.cat([zero, tps / tps[-1]])
    fpr = torch.cat([zero, fps / fps[-1]])
    auroc = torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2)
    ap = torch.sum((tpr[1:] - tpr[:-1]) * tps / (tps + fps))
    return {"AUROC": float(auroc), "AveragePrecision": float(ap)}


def _whole_set(cfg: Dict[str, Any], seed: int, data: Dict[str, Any], world: int):
    spec = cfg["data"]
    if world == 1:
        return data["arrays"]["preds"], data["arrays"]["target"]
    from portbench import discover

    gen = discover.module("data", spec["kind"])
    return gen.make_parts(spec, seed, range(spec["parts"]), data["arrays"]["preds"].device)


def expected(cfg: Dict[str, Any], seed: int, data: Dict[str, Any], world: int = 1, control: bool = False):
    scores, labels = _whole_set(cfg, seed, data, world)
    if control:
        scores = scores.to(torch.bfloat16).to(torch.float32)
    return {"epoch": exact_curves(scores, labels)}


def compare(outputs: List[tuple], exp: Dict[str, Any]) -> Dict[str, Any]:
    """The widest gap of AUROC and AP over every epoch's answer, and the answers over the limit."""
    worst, failed = 0.0, 0
    for _, _, got, *_ in outputs:
        gap = max(abs(got[k] - exp["epoch"][k]) if abs(got[k]) < float("inf") else float("inf")
                  for k in ("AUROC", "AveragePrecision"))
        worst = max(worst, gap)
        failed += gap > LIMITS["curve_abs_gap"]
    return {"checks": {"curve_abs_gap": (worst, LIMITS["curve_abs_gap"])}, "attempted": len(outputs), "failed": failed}

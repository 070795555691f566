"""The plain references against the port at a small size on the CPU, against
brute force, and against their bfloat16 controls, which must fail."""
import itertools

import numpy as np
import pytest
import torch

from portbench import calibrate, discover, run
from portbench.harness import Ctx, read_values

CPU = torch.device("cpu")


def _small(config):
    cfg = discover.json_part("configs", config)
    cfg["data"].update(cfg["rehearsal"])
    return cfg


def _window(config, traffic, seed):
    cfg = _small(config)
    data = discover.module("data", cfg["data"]["kind"]).make(cfg["data"], seed, 0, 1, CPU)
    loop = discover.module("loops", traffic)
    ctx = Ctx(run.build_collection(cfg["collection"], CPU), data, cfg["collection"]["call"], CPU)
    if "batches" in data:  # one pass of steps, then the epoch
        outputs = [a for i in range(len(data["batches"])) for a in loop.unit(ctx, i)]
        outputs.append(("epoch", 0, read_values(ctx.collection.compute())))
    else:  # two whole epochs
        outputs = loop.unit(ctx, 0) + loop.unit(ctx, 1)
    return cfg, data, outputs


@pytest.mark.parametrize("config,traffic", [("div2k_image_quality", "resident_steps"),
                                            ("criteo_exact_auc", "whole_epochs")])
@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_port_within_limits_and_control_beyond(config, traffic, seed):
    cfg, data, outputs = _window(config, traffic, seed)
    ref = discover.module("reference", config)
    exp = ref.expected(cfg, seed, data)
    program = ref.compare(outputs, exp)
    assert program["failed"] == 0, program
    control = ref.compare(calibrate.control_outputs(ref.expected(cfg, seed, data, control=True)), exp)
    for name, (value, limit) in control["checks"].items():
        assert value > limit, (name, value, limit)
    assert control["failed"] == control["attempted"]


def _brute(scores, labels):
    pos, neg = scores[labels == 1], scores[labels == 0]
    diff = pos[:, None] - neg[None, :]
    auroc = ((diff > 0).sum() + 0.5 * (diff == 0).sum()) / (len(pos) * len(neg))
    ap, seen_tp = 0.0, 0
    for thr in sorted(set(scores.tolist()), reverse=True):
        at = scores >= thr
        tp = int((labels[at] == 1).sum())
        ap += (tp - seen_tp) / len(pos) * tp / int(at.sum())
        seen_tp = tp
    return auroc, ap


def test_exact_curves_match_brute_force_with_ties():
    ref = discover.module("reference", "criteo_exact_auc")
    rng = np.random.default_rng(0)
    for n in (50, 300):
        scores = np.round(rng.random(n), 1).astype(np.float32)  # many ties
        labels = (rng.random(n) < 0.3).astype(np.int64)
        got = ref.exact_curves(torch.from_numpy(scores), torch.from_numpy(labels))
        auroc, ap = _brute(scores, labels)
        assert got["AUROC"] == pytest.approx(auroc, abs=1e-12) and got["AveragePrecision"] == pytest.approx(ap, abs=1e-12)


def test_image_reference_matches_a_direct_gaussian():
    """The separable blur equals the full 11 x 11 window on a reflect-padded image."""
    ref = discover.module("reference", "div2k_image_quality")
    x = torch.rand(1, 1, 24, 20, dtype=torch.float64)
    w = ref._window(torch.float64, CPU)
    full = torch.outer(w, w)
    pad = torch.nn.functional.pad(x, (5, 5, 5, 5), mode="reflect")[0, 0]
    want = torch.tensor([[float((pad[i:i + 11, j:j + 11] * full).sum()) for j in range(20)] for i in range(24)],
                        dtype=torch.float64)
    assert torch.allclose(ref._blur(x)[0, 0], want, atol=1e-14)
    assert list(itertools.islice(ref.BETAS, 5)) == [0.0448, 0.2856, 0.3001, 0.2363, 0.1333]

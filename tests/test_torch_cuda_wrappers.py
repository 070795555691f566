"""The keyed slab and the wrappers on the card, held against the CPU run of the port.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_wrappers.py

* ``slab_scatter`` with out-of-range ids (-1, K and beyond) on the card: sum,
  min and max rows equal the CPU's bit for bit, and the process lives (a CUDA
  scatter with an out-of-range index would be a device assert).
* ``Keyed`` over ``AUROC(approx="sketch")``, Quantile, Accuracy and
  MeanSquaredError: the card's slabs equal the CPU run's (integers exactly)
  and its values too, with out-of-range ids dropped and counted; of the
  forward's synchronizing calls two are the port's: the read of the slot ids
  and the copy of the kept samples' index.
* ``BootStrapper``: the card's stacked copies equal the CPU run's copy for
  copy (the same seeded draws).
* ``HeavyHitters``: the card's tiers equal the CPU run's (the same host table).
* The pure view's compute of a sketch state makes no synchronizing call.

Tolerances: counts and rows are integers and equal; float values from equal
counts by the same float64 math, or float32 sums in another order, agree to
rtol 1e-6; the bootstrap mean and std, float32 reductions over the copies in
another order (the std's deviations cancel), to rtol 1e-5.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
from metrics_tpu_torch.parallel import slab as pslab

RTOL = 1e-6
RTOL_REDUCED = 1e-5  # a float32 mean and std over 20 copies, reduced in another order (the std cancels)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _batch(seed, n, k):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(n) < 0.3).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.randn(n) + 1.5 * labels)))).astype(np.float32)
    logits = rng.randn(n, 10).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    classes = rng.randint(0, 10, n)
    latency = (0.02 * np.exp(rng.randn(n))).astype(np.float32)
    target = np.exp(rng.randn(n)).astype(np.float32)
    preds = (target * np.exp(0.1 * rng.randn(n))).astype(np.float32)
    slots = rng.randint(0, k, n)
    slots[:16], slots[16:32] = -1, k
    return {"scores": scores, "labels": labels, "probs": probs, "classes": classes, "latency": latency,
            "preds": preds, "target": target, "slots": slots}


def _state(metric):
    return {n: (v.counts if hasattr(v, "counts") else v).cpu() for n, v in metric._current_state().items()}


def _equal(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if np.issubdtype(got.dtype, np.integer):
        return np.array_equal(got, want)
    return np.allclose(got, want, rtol=RTOL, atol=0.0, equal_nan=True) and np.array_equal(np.isnan(got),
                                                                                         np.isnan(want))


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_slab_scatter_drops_out_of_range_ids_on_the_card(cuda, reduce, dtype):
    gen = torch.Generator().manual_seed(3)
    # integer values: float32 sums of them are exact in any order of the card's atomics
    deltas = torch.randint(-1_000, 1_000, (200_000, 4), generator=gen).to(dtype)
    ids = torch.randint(-3, 1_003, (200_000,), generator=gen)
    want = pslab.slab_scatter(reduce, deltas, ids, 1_000)
    got = pslab.slab_scatter(reduce, deltas.to(cuda), ids.to(cuda), 1_000)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert pslab.dropped_slot_count(ids.to(cuda), 1_000) == int(((ids < 0) | (ids >= 1_000)).sum()) > 0


_INNER = {
    "auroc_sketch": (lambda dev: pt.AUROC(approx="sketch", device=dev), ("scores", "labels")),
    "quantile": (lambda dev: pt.Quantile(q=(0.5, 0.99), device=dev), ("latency",)),
    "accuracy": (lambda dev: pt.Accuracy(device=dev), ("probs", "classes")),
    "mse": (lambda dev: pt.MeanSquaredError(device=dev), ("preds", "target")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("inner", sorted(_INNER))
def test_keyed_on_the_card_equals_cpu(cuda, inner):
    make, names = _INNER[inner]
    k = 1_000
    card, cpu = pt.Keyed(make(cuda), num_slots=k), pt.Keyed(make("cpu"), num_slots=k)
    for seed in range(2):
        b = _batch(seed, 20_000, k)
        card.update(*(torch.from_numpy(b[n]).to(cuda) for n in names), slot=torch.from_numpy(b["slots"]).to(cuda))
        cpu.update(*(torch.from_numpy(b[n]) for n in names), slot=torch.from_numpy(b["slots"]))
    for name, value in _state(card).items():
        assert _equal(value, _state(cpu)[name]), name
    assert int(card.keyed_rows.sum()) == 2 * (20_000 - 32)
    assert _equal(card.compute(), cpu.compute())
    b = _batch(9, 4_096, k)
    card_in = tuple(torch.from_numpy(b[n]).to(cuda) for n in names)
    slots = torch.from_numpy(b["slots"]).to(cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            card(*card_in, slot=slots)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message).lower()]
    # the port's own: the slot ids' read to the host and the kept samples' index copied back (the batch
    # carries 32 ids out of range); torch itself may add one of its own
    ours = [site for site in syncs if "metrics_tpu_torch" in site]
    assert len(ours) == 2 and all("wrappers/keyed.py" in site for site in ours), syncs


@pytest.mark.cuda
def test_bootstrapper_on_the_card_equals_cpu(cuda):
    card = pt.BootStrapper(pt.AUROC(approx="sketch", device=cuda), num_bootstraps=20, seed=0, raw=True)
    cpu = pt.BootStrapper(pt.AUROC(approx="sketch", device="cpu"), num_bootstraps=20, seed=0, raw=True)
    for seed in range(2):
        b = _batch(20 + seed, 30_000, 8)
        card.update(torch.from_numpy(b["scores"]).to(cuda), torch.from_numpy(b["labels"]).to(cuda))
        cpu.update(torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"]))
    assert card._mode == cpu._mode == "stacked"
    assert torch.equal(card._stacked["hist"].counts.cpu(), cpu._stacked["hist"].counts)
    card_out, cpu_out = card.compute(), cpu.compute()
    assert torch.equal(card_out["raw"].cpu(), cpu_out["raw"])  # each copy's value from equal counts
    for key in ("mean", "std"):  # float32 reductions over the copies in another order
        assert np.allclose(card_out[key].item(), cpu_out[key].item(), rtol=RTOL_REDUCED, atol=0.0), key


@pytest.mark.cuda
def test_heavy_hitters_on_the_card_equals_cpu(cuda):
    card = pt.HeavyHitters(pt.AUROC(approx="sketch", device=cuda), num_hot_slots=16, tail=(4, 256))
    cpu = pt.HeavyHitters(pt.AUROC(approx="sketch", device="cpu"), num_hot_slots=16, tail=(4, 256))
    rng = np.random.RandomState(30)
    for seed in range(3):
        b = _batch(30 + seed, 20_000, 8)
        keys = ((rng.zipf(1.1, 20_000) - 1) % 5_000).tolist()
        card.update(torch.from_numpy(b["scores"]).to(cuda), torch.from_numpy(b["labels"]).to(cuda), key=keys)
        cpu.update(torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"]), key=keys)
    for name, value in _state(card).items():
        assert torch.equal(value, _state(cpu)[name]), name
    assert int(card.hh_rows.sum()) + card.tail_mass() == 60_000
    assert _equal(card.compute(), cpu.compute())


@pytest.mark.cuda
def test_pure_view_compute_on_the_card_makes_no_synchronizing_call(cuda):
    metric = pt.AUROC(approx="sketch", device=cuda)
    pure = metric.pure()
    b = _batch(40, 50_000, 8)
    state = pure.update(pure.init(), torch.from_numpy(b["scores"]).to(cuda), torch.from_numpy(b["labels"]).to(cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        value = pure.compute(pure.merge(state, state))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = pt.AUROC(approx="sketch", device="cpu")
    cpu.update(torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"]))
    assert _equal(value, cpu.compute())

"""Pairwise matrices, embedding similarity and image gradients in metrics_tpu_torch against metrics_tpu.

The same numpy-seeded embeddings and images go through both packages and a
numpy float64 oracle: the four pairwise matrices with ``y`` given and not,
every ``reduction`` and both ``zero_diagonal`` settings;
``embedding_similarity`` with both similarities and every reduction;
``image_gradients``; and the full-float32 context restores the caller's
matmul precision.

Tolerances: the products are float32 over d = 48 terms in another order:
rtol 1e-5 with atol 1e-6 (cosine values near 0); row sums and means of them
atol 1e-4, the JAX package's own tolerance for its reductions. Euclidean
distances come from the ``|x|^2 - 2<x, y> + |y|^2`` expansion in both
packages, held to the float64 oracle at atol 1e-4 off the diagonal. On the
diagonal of a self-distance the expansion cancels to float32 noise in both
packages, up to ``sqrt(4 eps) max|x| sqrt(d)`` (about 0.02 here), which the
diagonal is held to (the oracle there is 0). Gradients are one float32 subtraction each:
equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as JF
import metrics_tpu_torch.functional as PF
from metrics_tpu_torch.utils.data import full_fp32_matmul

RTOL, ATOL = 1e-5, 1e-6
_PAIRWISE = ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_manhattan_distance",
             "pairwise_linear_similarity"]


def _embeddings(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _oracle(name, x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    if name == "pairwise_cosine_similarity":
        return (x / np.linalg.norm(x, axis=1, keepdims=True)) @ (y / np.linalg.norm(y, axis=1, keepdims=True)).T
    if name == "pairwise_euclidean_distance":
        return np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1))
    if name == "pairwise_manhattan_distance":
        return np.abs(x[:, None] - y[None]).sum(-1)
    return x @ y.T


@pytest.mark.parametrize("name", _PAIRWISE)
@pytest.mark.parametrize("reduction", [None, "none", "mean", "sum"])
@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("zero_diagonal", [None, True, False])
def test_pairwise_equals_jax_and_float64_oracle(name, reduction, with_y, zero_diagonal):
    x, y = _embeddings(1, 33, 48), _embeddings(2, 21, 48)
    jax_args = (jnp.asarray(x), jnp.asarray(y) if with_y else None)
    port_args = (torch.from_numpy(x), torch.from_numpy(y) if with_y else None)
    want = np.asarray(getattr(JF, name)(*jax_args, reduction=reduction, zero_diagonal=zero_diagonal))
    got = getattr(PF, name)(*port_args, reduction=reduction, zero_diagonal=zero_diagonal).numpy()
    oracle = _oracle(name, x, y if with_y else x)
    zeroed = zero_diagonal or (zero_diagonal is None and not with_y)
    if zeroed:
        np.fill_diagonal(oracle, 0.0)
    noisy_diagonal = name == "pairwise_euclidean_distance" and not with_y and not zeroed
    diag_bound = np.sqrt(4 * np.finfo(np.float32).eps) * np.abs(x).max() * np.sqrt(x.shape[1])
    if reduction in ("mean", "sum"):
        reduce = np.mean if reduction == "mean" else np.sum
        atol = 1e-4 + (diag_bound if noisy_diagonal else 0.0)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
        np.testing.assert_allclose(got, reduce(oracle, -1), rtol=RTOL, atol=atol)
        return
    off = ~np.eye(*got.shape, dtype=bool) if noisy_diagonal else np.ones(got.shape, bool)
    atol = 1e-4 if name == "pairwise_euclidean_distance" else ATOL
    np.testing.assert_allclose(got[off], want[off], rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got[off], oracle[off], rtol=RTOL, atol=1e-4)
    if noisy_diagonal:
        assert np.all(np.diag(got) <= diag_bound) and np.all(np.diag(want) <= diag_bound)


def test_pairwise_rejects_what_jax_rejects():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="2-D"):
        PF.pairwise_linear_similarity(torch.zeros(4))
    with pytest.raises(ValueError, match="Expected y"):
        PF.pairwise_cosine_similarity(x, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="reduction"):
        PF.pairwise_manhattan_distance(x, reduction="max")


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("zero_diagonal", [True, False])
def test_embedding_similarity_equals_jax(similarity, reduction, zero_diagonal):
    x = _embeddings(3, 40, 48)
    want = np.asarray(JF.embedding_similarity(jnp.asarray(x), similarity, reduction, zero_diagonal))
    got = PF.embedding_similarity(torch.from_numpy(x), similarity, reduction, zero_diagonal).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL if reduction == "none" else 1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 9, 7), (1, 1, 1, 5)])
def test_image_gradients_equal_jax(shape):
    img = np.random.default_rng(4).random(shape).astype(np.float32)
    for got, want in zip(PF.image_gradients(torch.from_numpy(img)), JF.image_gradients(jnp.asarray(img))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_image_gradients_reject_what_jax_rejects():
    with pytest.raises(RuntimeError, match="4D"):
        PF.image_gradients(torch.zeros(3, 4, 4))
    with pytest.raises(TypeError):
        PF.image_gradients([[1.0]])


def test_full_fp32_matmul_restores_the_callers_precision():
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with full_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)

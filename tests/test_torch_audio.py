"""Audio metrics (SNR, SI-SDR, SI-SNR, PIT) in metrics_tpu_torch against metrics_tpu.

The same numpy-seeded signals go through both packages: the per-example
values, the batch means, the stateful metrics over uneven batches, PIT's best
values and permutations for S = 2 and 3 sources with both ``eval_func``s, and
``pit_permutate``.

Tolerances: per-example dB values are ``10 log10`` of float32 sums over the
time axis, which XLA and torch add in another order: rtol 1e-5 (the JAX
package's own tests hold these values to its oracle at rtol 1e-4). PIT's
permutations are equal wherever the best and second-best scores differ by more
than that tolerance; the data below keeps them apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as JF
from metrics_tpu.audio import PIT as JaxPIT
from metrics_tpu.audio import SI_SDR as JaxSI_SDR
from metrics_tpu.audio import SI_SNR as JaxSI_SNR
from metrics_tpu.audio import SNR as JaxSNR
from metrics_tpu.functional.audio.si_sdr import _si_sdr_per_example as jax_si_sdr
from metrics_tpu.functional.audio.snr import _snr_per_example as jax_snr
import metrics_tpu_torch.functional as PF
from metrics_tpu_torch.audio import PIT, SI_SDR, SI_SNR, SNR
from metrics_tpu_torch.functional.audio.pit import _permutations
from metrics_tpu_torch.functional.audio.si_sdr import _si_sdr_per_example
from metrics_tpu_torch.functional.audio.snr import _snr_per_example

RTOL = 1e-5


def _signals(seed, shape, noise=0.3):
    rng = np.random.default_rng(seed)
    target = rng.normal(size=shape).astype(np.float32)
    preds = (target + noise * rng.normal(size=shape) + 0.1).astype(np.float32)
    return preds, target


@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("shape", [(4, 1000), (2, 3, 257), (64,)])
def test_per_example_values_equal_jax(zero_mean, shape):
    preds, target = _signals(1, shape)
    jp, jt, tp, tt = jnp.asarray(preds), jnp.asarray(target), torch.from_numpy(preds), torch.from_numpy(target)
    for jax_fn, port_fn in ((jax_snr, _snr_per_example), (jax_si_sdr, _si_sdr_per_example)):
        np.testing.assert_allclose(port_fn(tp, tt, zero_mean).numpy(), np.asarray(jax_fn(jp, jt, zero_mean)), rtol=RTOL)
    np.testing.assert_allclose(PF.signal_noise_ratio(tp, tt, zero_mean).numpy(),
                               np.asarray(JF.signal_noise_ratio(jp, jt, zero_mean)), rtol=RTOL)
    np.testing.assert_allclose(PF.scale_invariant_signal_distortion_ratio(tp, tt, zero_mean).numpy(),
                               np.asarray(JF.scale_invariant_signal_distortion_ratio(jp, jt, zero_mean)), rtol=RTOL)
    np.testing.assert_allclose(PF.scale_invariant_signal_noise_ratio(tp, tt).numpy(),
                               np.asarray(JF.scale_invariant_signal_noise_ratio(jp, jt)), rtol=RTOL)


def test_silent_and_perfect_signals_hit_the_same_eps_clamps():
    target = np.zeros((2, 50), np.float32)
    target[1] = np.linspace(-1, 1, 50)
    preds = target.copy()
    for jax_fn, port_fn in ((jax_snr, _snr_per_example), (jax_si_sdr, _si_sdr_per_example)):
        np.testing.assert_allclose(port_fn(torch.from_numpy(preds), torch.from_numpy(target), False).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(preds), jnp.asarray(target), False)), rtol=RTOL)


@pytest.mark.parametrize("cls, jax_cls, kw", [(SNR, JaxSNR, {}), (SNR, JaxSNR, {"zero_mean": True}),
                                              (SI_SDR, JaxSI_SDR, {}), (SI_SNR, JaxSI_SNR, {})])
def test_stateful_metrics_equal_jax_over_uneven_batches(cls, jax_cls, kw):
    port, ref = cls(device="cpu", **kw), jax_cls(**kw)
    for seed, n in enumerate((5, 1, 8)):
        preds, target = _signals(10 + seed, (n, 400))
        got = port(torch.from_numpy(preds), torch.from_numpy(target))
        want = ref(jnp.asarray(preds), jnp.asarray(target))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL)
    assert int(port.n_examples) == int(ref.n_examples) == 14
    assert port.n_examples.dtype == torch.int64


def _mixture(seed, batch, sources, length):
    """Targets, and estimates that are the targets in a random source order plus noise."""
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(batch, sources, length)).astype(np.float32)
    perms = np.stack([rng.permutation(sources) for _ in range(batch)])
    preds = np.take_along_axis(target, perms[:, :, None], 1) + 0.4 * rng.normal(size=target.shape)
    return preds.astype(np.float32), target


@pytest.mark.parametrize("sources", [2, 3])
@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_pit_values_and_permutations_equal_jax(sources, eval_func, zero_mean):
    preds, target = _mixture(sources, 6, sources, 300)

    def jax_metric(p, t):
        return jax_si_sdr(p, t, zero_mean)

    def port_metric(p, t):
        return _si_sdr_per_example(p, t, zero_mean)

    want_best, want_perm = JF.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), jax_metric,
                                                              eval_func)
    got_best, got_perm = PF.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target),
                                                           port_metric, eval_func)
    np.testing.assert_allclose(got_best.numpy(), np.asarray(want_best), rtol=RTOL)
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    want_perm_preds = JF.pit_permutate(jnp.asarray(preds), want_perm)
    np.testing.assert_array_equal(PF.pit_permutate(torch.from_numpy(preds), got_perm).numpy(),
                                  np.asarray(want_perm_preds))


def test_pit_metric_with_snr_kernel_equals_jax_and_keeps_the_permutation_table():
    port = PIT(lambda p, t: _snr_per_example(p, t, False), device="cpu")
    ref = JaxPIT(lambda p, t: jax_snr(p, t, False))
    for seed in range(3):
        preds, target = _mixture(20 + seed, 4, 3, 200)
        np.testing.assert_allclose(port(torch.from_numpy(preds), torch.from_numpy(target)).numpy(),
                                   np.asarray(ref(jnp.asarray(preds), jnp.asarray(target))), rtol=RTOL)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL)
    assert _permutations(3, torch.device("cpu")) is _permutations(3, torch.device("cpu"))  # built once per S


def test_pit_rejects_what_jax_rejects():
    x = torch.zeros(2, 2, 8)
    with pytest.raises(ValueError, match="eval_func"):
        PF.permutation_invariant_training(x, x, lambda p, t: p.sum(-1), "mean")
    with pytest.raises(ValueError, match="batch, sources, time"):
        PF.permutation_invariant_training(x[0], x[0], lambda p, t: p.sum(-1))
    with pytest.raises(ValueError, match="eval_func"):
        PIT(lambda p, t: p, eval_func="avg", device="cpu")

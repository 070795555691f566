"""Input formatting: the port's ``_input_format_classification`` against the JAX package.

The cases are the seeded random ones of the JAX fuzz test
(``tests/classification/test_inputs_fuzz.py:_gen_case``): well-formed layouts
of every input type with random arguments, plus injected corruptions. For each
case both packages must either raise the same error type with the same
message, or return the same ``DataType`` and equal normalized arrays.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.utils.checks import _input_format_classification as jax_format
from metrics_tpu_torch.utils.checks import _input_format_classification, shared_input_format
from metrics_tpu_torch.utils.data import select_topk, to_onehot

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "_torch_port_fuzz_cases", Path(__file__).parent / "classification" / "test_inputs_fuzz.py"
)
_fuzz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fuzz)

_CASES_PER_CHUNK = 25
_CHUNKS = 4


def _outcome(fn, p, t, kwargs):
    try:
        return "ok", fn(p, t, **kwargs)
    except (ValueError, RuntimeError) as err:
        return "raised", (type(err), str(err))


@pytest.mark.parametrize("chunk", range(_CHUNKS))
def test_format_matches_jax_on_fuzz_cases(chunk):
    mismatches = []
    for i in range(chunk * _CASES_PER_CHUNK, (chunk + 1) * _CASES_PER_CHUNK):
        rng = np.random.RandomState(100_000 + i)
        p, t, kwargs = _fuzz._gen_case(rng)
        want_kind, want = _outcome(jax_format, jnp.asarray(p), jnp.asarray(t), kwargs)
        got_kind, got = _outcome(_input_format_classification, torch.as_tensor(np.asarray(p)),
                                 torch.as_tensor(np.asarray(t)), kwargs)
        if want_kind != got_kind:
            mismatches.append((i, want_kind, want, got_kind, got))
        elif want_kind == "raised":
            if want != got:
                mismatches.append((i, want, got))
        else:
            same = (
                want[2] == got[2]
                and np.array_equal(np.asarray(want[0]), got[0].numpy())
                and np.array_equal(np.asarray(want[1]), got[1].numpy())
            )
            if not same:
                mismatches.append((i, kwargs, want[2], got[2]))
    assert not mismatches, mismatches[:5]


def test_fuzz_chunks_cover_both_outcomes():
    """The swept cases include well-formed inputs and every corruption kind raising."""
    kinds = set()
    for i in range(_CHUNKS * _CASES_PER_CHUNK):
        p, t, kwargs = _fuzz._gen_case(np.random.RandomState(100_000 + i))
        kinds.add(_outcome(_input_format_classification, torch.as_tensor(np.asarray(p)),
                           torch.as_tensor(np.asarray(t)), kwargs)[0])
    assert kinds == {"ok", "raised"}


def test_value_checks_read_the_host_once(monkeypatch):
    """All value checks of one call are stacked and read back in one transfer."""
    calls = []
    real = torch.Tensor.tolist

    def counting_tolist(self):
        calls.append(self.shape)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting_tolist)
    preds = torch.softmax(torch.randn(16, 5), dim=1)
    target = torch.randint(0, 5, (16,))
    _input_format_classification(preds, target, num_classes=5)
    assert len(calls) == 1 and calls[0][0] >= 5


def test_shared_input_format_memoizes_within_window():
    preds = torch.softmax(torch.randn(8, 4), dim=1)
    target = torch.randint(0, 4, (8,))
    with shared_input_format():
        a = _input_format_classification(preds, target)
        b = _input_format_classification(preds, target, num_classes=4)  # equivalent config
        c = _input_format_classification(preds, target, top_k=2)
    assert a is b and a is not c
    assert _input_format_classification(preds, target) is not a  # window closed


@pytest.mark.parametrize("shape,k", [((6, 5), 1), ((6, 5), 2), ((4, 3, 2), 2)])
def test_select_topk_and_onehot_match_jax(shape, k):
    from metrics_tpu.utils.data import select_topk as jax_topk, to_onehot as jax_onehot

    x = np.random.RandomState(k).rand(*shape).astype(np.float32)
    x[0, :2] = 0.5  # a tie: both packages keep the lower index
    np.testing.assert_array_equal(select_topk(torch.from_numpy(x), k).numpy(), np.asarray(jax_topk(jnp.asarray(x), k)))
    labels = np.random.RandomState(k).randint(0, 4, shape[:1] + shape[2:])
    np.testing.assert_array_equal(to_onehot(torch.from_numpy(labels), 4).numpy(),
                                  np.asarray(jax_onehot(jnp.asarray(labels), 4)))

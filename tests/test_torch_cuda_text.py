"""The text family's device work on the card, held against the host DP, the CPU run and float64.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_text.py

* ``edit_distance_padded`` and ``lcs_length_padded`` on the card equal a plain
  Python DP on every pair, zero lengths included, and the same call on the CPU;
* Perplexity at bf16 logits, in one chunk and in many, against a float64
  oracle, with ignored, wrapped (negative) and out-of-range (NaN) ids; the
  update makes no synchronizing CUDA call;
* BLEU's counts on the card equal the CPU's (ties in reference closeness go to
  the first reference on both);
* the text modules built on the card equal the same modules on the CPU.

Tolerances: distances, LCS lengths, BLEU denominators, lengths and counts are
equal. Perplexity's float32 sum of float32 log-likelihoods against float64:
rtol 1e-5. BLEU's numerator, float32 sums of ``min(c, m) / c`` in another
order on the card: rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
from metrics_tpu_torch.functional import nlp
from metrics_tpu_torch.functional import text_perplexity as tppl

RTOL_PPL = 1e-5
RTOL_BLEU = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y))
        prev = cur
    return prev[-1]


def _lcs(a, b):
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _padded(seed, batch, n, m, vocab):
    rng = np.random.default_rng(seed)
    p = rng.integers(1, vocab, (batch, n))
    t = rng.integers(1, vocab, (batch, m))
    pl, tl = rng.integers(0, n + 1, batch), rng.integers(0, m + 1, batch)
    pl[:3], tl[2:5] = 0, 0
    return p, t, pl, tl


@pytest.mark.cuda
@pytest.mark.parametrize("batch, n, m, vocab", [(64, 40, 35, 6), (17, 1, 90, 3), (5, 120, 1, 2), (300, 12, 12, 50)])
def test_padded_dps_on_the_card_equal_the_python_dp(cuda, batch, n, m, vocab):
    p, t, pl, tl = _padded(batch + n, batch, n, m, vocab)
    args = [torch.from_numpy(x) for x in (p, t, pl, tl)]
    dist = ptf.edit_distance_padded(*[a.to(cuda) for a in args])
    lcs = ptf.lcs_length_padded(*[a.to(cuda) for a in args])
    want_d = [_levenshtein(p[k, :pl[k]].tolist(), t[k, :tl[k]].tolist()) for k in range(batch)]
    want_l = [_lcs(p[k, :pl[k]].tolist(), t[k, :tl[k]].tolist()) for k in range(batch)]
    assert dist.dtype == lcs.dtype == torch.int32
    assert dist.tolist() == want_d == ptf.edit_distance_padded(*args).tolist()
    assert lcs.tolist() == want_l == ptf.lcs_length_padded(*args).tolist()


@pytest.mark.cuda
def test_padded_dps_raise_on_the_card(cuda):
    p, t, pl, tl = (torch.from_numpy(x).to(cuda) for x in _padded(1, 4, 6, 5, 4))
    with pytest.raises(ValueError, match="pred_len"):
        ptf.edit_distance_padded(p, t, pl + 7, tl)
    with pytest.raises(ValueError, match="target_len"):
        ptf.lcs_length_padded(p, t, pl, tl - 6)


def _ppl_oracle(logits, ids, ignore_index):
    x = logits.double()
    vocab = x.shape[-1]
    ids = ids.reshape(-1)
    keep = ids != ignore_index if ignore_index is not None else torch.ones_like(ids, dtype=torch.bool)
    idx = torch.where(keep, ids, 0)
    idx = torch.where(idx < 0, idx + vocab, idx)
    inside = (idx >= 0) & (idx < vocab)
    flat = x.reshape(-1, vocab)
    nll = torch.logsumexp(flat, -1) - flat.gather(1, idx.clamp(0, vocab - 1)[:, None])[:, 0]
    nll = torch.where(inside, nll, float("nan"))
    return (nll * keep).sum().item(), int(keep.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bytes", [tppl.CHUNK_BYTES, 4 * 32_000 * 13])
@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_on_the_card_equals_float64(cuda, monkeypatch, chunk_bytes, ignore_index):
    monkeypatch.setattr(tppl, "CHUNK_BYTES", chunk_bytes)
    gen = torch.Generator(device=cuda).manual_seed(3)
    logits = (torch.randn(2, 96, 32_000, generator=gen, device=cuda) * 2).to(torch.bfloat16)
    ids = torch.randint(0, 32_000, (2, 96), generator=gen, device=cuda)
    ids[0, :5] = -100
    ids[1, :3] = torch.tensor([-1, -32_000, 31_999], device=cuda)  # wraps to V - 1, to 0, and in range
    total, count = tppl._perplexity_update(logits, ids, ignore_index)
    want_total, want_count = _ppl_oracle(logits, ids, ignore_index)
    np.testing.assert_allclose(total.item(), want_total, rtol=RTOL_PPL)
    assert int(count) == want_count and count.dtype == torch.int64
    cpu_total, cpu_count = tppl._perplexity_update(logits.cpu(), ids.cpu(), ignore_index)
    np.testing.assert_allclose(total.item(), cpu_total.item(), rtol=RTOL_PPL)
    assert int(cpu_count) == want_count


@pytest.mark.cuda
def test_perplexity_out_of_range_ids_give_nan_on_the_card_without_a_device_assert(cuda):
    logits = torch.log(torch.tensor([[[0.25, 0.75], [0.5, 0.5]]], device=cuda))
    for ids, want in (([[1, 2]], float("nan")), ([[1, -3]], float("nan")), ([[1, -1]], 1.6330),
                      ([[1, 1_000_000]], float("nan"))):
        got = ptf.perplexity(logits, torch.tensor(ids, device=cuda)).item()
        np.testing.assert_allclose(got, want, rtol=1e-4)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_perplexity_update_makes_no_synchronizing_call(cuda):
    metric = pt.Perplexity(ignore_index=-100, device=cuda)
    logits = torch.randn(2, 64, 5_000, device=cuda, dtype=torch.bfloat16)
    ids = torch.randint(0, 5_000, (2, 64), device=cuda)
    metric(logits, ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metric(logits, ids)
        metric.update(logits, ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _corpus(seed, n, max_refs=3):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(30)]
    refs = [[list(rng.choice(words, int(rng.integers(1, 40)))) for _ in range(int(rng.integers(1, max_refs + 1)))]
            for _ in range(n)]
    hyps = [[w for w in r[0] if rng.random() > 0.2] + list(rng.choice(words, int(rng.integers(0, 4)))) for r in refs]
    return hyps, refs


@pytest.mark.cuda
@pytest.mark.parametrize("n_gram", [1, 4])
def test_bleu_counts_on_the_card_equal_the_cpu(cuda, n_gram):
    hyps, refs = _corpus(5, 200)
    hyps.append(["w1"] * 5)
    refs.append([["w1"] * 4, ["w1"] * 6])  # a tie in closeness: the first reference wins
    ids = nlp._intern_corpus(hyps, refs)
    card = nlp.bleu_counts(*nlp._pad_corpus(*ids, cuda), n_gram=n_gram)
    host = nlp.bleu_counts(*nlp._pad_corpus(*ids, torch.device("cpu")), n_gram=n_gram)
    np.testing.assert_allclose(card[0].cpu().numpy(), host[0].numpy(), rtol=RTOL_BLEU)
    for a, b in zip(card[1:], host[1:]):
        assert a.cpu().tolist() == b.tolist()
    tie = nlp.bleu_counts(*nlp._pad_corpus(*nlp._intern_corpus(hyps[-1:], refs[-1:]), cuda))
    assert int(tie[3]) == 4


@pytest.mark.cuda
def test_text_modules_on_the_card_equal_the_cpu(cuda):
    rng = np.random.default_rng(9)
    words = ["the", "cat", "sat", "on", "a", "mat", ",", ".", "3.5", "&quot;"]
    target = [" ".join(rng.choice(words, int(rng.integers(0, 80)))) for _ in range(100)]
    preds = [" ".join(w for w in t.split() if rng.random() > 0.1) for t in target]
    refs = [[t] for t in target]
    for name, args in (("WER", (preds, target)), ("CharErrorRate", (preds, target)),
                       ("MatchErrorRate", (preds, target)), ("EditDistance", (preds, target)),
                       ("BLEUScore", (preds, refs)), ("SacreBLEUScore", (preds, refs)),
                       ("CHRFScore", (preds, target)), ("ROUGEScore", (preds, target)),
                       ("SQuAD", (preds, refs)), ("TranslationEditRate", (preds[:20], refs[:20]))):
        card, host = getattr(pt, name)(device=cuda), getattr(pt, name)(device="cpu")
        got, want = card(*args), host(*args)
        got, want = (got, want) if isinstance(got, dict) else ({"v": got}, {"v": want})
        for k in want:
            assert got[k].device.type == "cuda"
            np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=RTOL_BLEU, err_msg=f"{name} {k}")
        for state in host._defaults:
            np.testing.assert_allclose(getattr(card, state).cpu().numpy(), getattr(host, state).numpy(),
                                       rtol=RTOL_BLEU, err_msg=f"{name}.{state}")

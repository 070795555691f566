"""The text family in metrics_tpu_torch against metrics_tpu, on the CPU.

The same numpy-seeded sentences, token ids and logits go through both
packages: WER / CER / MER / WIL / WIP, edit distance, BLEU / SacreBLEU, chrF,
TER, ROUGE, SQuAD and Perplexity, as functionals and as modules over uneven
batches (forward values, epoch values, states, ``_count_bound``, checkpoints
loaded across the packages both ways), the batched Levenshtein / LCS DPs, and
the port's vectorized host DPs against the JAX package's per-cell ones on
thousands of random pairs.

Tolerances: every integer (distances, hits, LCS lengths, BLEU denominators and
lengths, chrF statistics, counts, ``_count_bound``) is equal. Host floats (the
functionals' Python floats, TER / ROUGE / SQuAD sums added to float32 states
once an update) are equal. BLEU's float32 numerator sums ``min(c, m) / c`` over
windows in another grouping (a batch at once, not one example after another):
rtol 1e-6, and the scores made from it rtol 1e-6. Perplexity sums float32
token log-likelihoods from another ``log_softmax`` (XLA's against torch's):
rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as JF
import metrics_tpu.functional.nlp as jnlp
import metrics_tpu.functional.text as jtext
import metrics_tpu.functional.text_chrf as jchrf
import metrics_tpu.functional.text_rouge as jrouge
import metrics_tpu.functional.text_sacrebleu as jsacre
import metrics_tpu.functional.text_perplexity as jppl
import metrics_tpu.functional.text_squad as jsquad
import metrics_tpu.functional.text_ter as jter
import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as PF
import metrics_tpu_torch.functional.nlp as pnlp
import metrics_tpu_torch.functional.text as ptext
import metrics_tpu_torch.functional.text_chrf as pchrf
import metrics_tpu_torch.functional.text_perplexity as pppl
import metrics_tpu_torch.functional.text_rouge as prouge
import metrics_tpu_torch.functional.text_sacrebleu as psacre
import metrics_tpu_torch.functional.text_squad as psquad
import metrics_tpu_torch.functional.text_ter as pter

RTOL_BLEU = 1e-6
RTOL_PPL = 1e-5
CPU = torch.device("cpu")

_WORDS = ("the", "a", "an", "cat", "Cat", "sat", "on", "mat", "dog", "ran", "in", "park", "3.5", "1,000",
          "-", "&quot;", "it's", "U.S.", "(", ")", ",", ".", "!", "?", "x-ray", "New", "York")


def _sentence(rng, lo, hi):
    return " ".join(rng.choice(_WORDS, int(rng.integers(lo, hi))))


def _noisy(rng, sentence, p=0.3):
    """A hypothesis: the sentence with words substituted, dropped, inserted and swapped."""
    out = []
    for w in sentence.split():
        r = rng.random()
        if r < p / 3:
            out.append(str(rng.choice(_WORDS)))
        elif r < 2 * p / 3:
            continue
        else:
            out.append(w)
        if rng.random() < p / 3:
            out.append(str(rng.choice(_WORDS)))
    if len(out) > 3 and rng.random() < 0.5:
        i = int(rng.integers(0, len(out) - 3))
        out[i:i + 3] = out[i + 1:i + 3] + out[i:i + 1]
    return " ".join(out)


def _pairs(seed, n, lo=0, hi=14):
    rng = np.random.default_rng(seed)
    target = [_sentence(rng, lo, hi) for _ in range(n)]
    return [_noisy(rng, t) for t in target], target


def _refs(seed, n, max_refs=3):
    rng = np.random.default_rng(seed)
    refs = [[_sentence(rng, 1, 16) for _ in range(int(rng.integers(1, max_refs + 1)))] for _ in range(n)]
    return [_noisy(rng, r[0]) for r in refs], refs


def _close(got, want, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol)


def _host(value):
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


# ------------------------------------------------------------------ host DPs
@pytest.mark.parametrize("alphabet, pairs", [(2, 1000), (4, 3000), (26, 600)])
def test_vectorized_host_dps_equal_the_per_cell_dps(alphabet, pairs):
    rng = np.random.default_rng(alphabet)
    for _ in range(pairs):
        a = [str(x) for x in rng.integers(0, alphabet, int(rng.integers(0, 15)))]
        b = [str(x) for x in rng.integers(0, alphabet, int(rng.integers(0, 15)))]
        assert ptext._np_edit_distance(a, b) == jtext._np_edit_distance(a, b), (a, b)
        assert ptext._np_edit_distance_hits(a, b) == tuple(jtext._np_edit_distance_hits(a, b)), (a, b)


def test_host_dps_on_long_character_sequences():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a = list("".join(rng.choice(list("abcde "), int(rng.integers(80, 140)))))
        b = list("".join(rng.choice(list("abcde "), int(rng.integers(80, 140)))))
        assert ptext._np_edit_distance(a, b) == jtext._np_edit_distance(a, b)
        assert ptext._np_edit_distance_hits(a, b) == tuple(jtext._np_edit_distance_hits(a, b))


# ------------------------------------------------------------- error rates
_RATES = ("wer", "cer", "match_error_rate", "word_information_preserved", "word_information_lost")

_RATE_CASES = {
    "random": _pairs(1, 25),
    "pretokenized": ([p.split() for p in _pairs(2, 9)[0]], [t.split() for t in _pairs(2, 9)[1]]),
    "single_string": ("the cat sat", "the cat sat on the mat"),
    "empty_both": (["", ""], ["", ""]),
    "empty_reference": (["the cat", ""], ["", ""]),
    "empty_prediction": (["", ""], ["the cat", "sat"]),
    "empty_batch": ([], []),
}


@pytest.mark.parametrize("case", sorted(_RATE_CASES))
@pytest.mark.parametrize("name", _RATES)
def test_rate_functionals_equal_jax(name, case):
    preds, target = _RATE_CASES[case]
    got, want = getattr(PF, name)(preds, target), getattr(JF, name)(preds, target)
    assert type(got) is float and got == want


@pytest.mark.parametrize("name", _RATES + ("edit_distance", "chrf_score", "rouge_score", "squad"))
def test_unequal_batch_lengths_raise(name):
    with pytest.raises(ValueError):
        getattr(JF, name)(["a b", "c"], ["a b"])
    kwargs = {"device": "cpu"} if name == "edit_distance" else {}
    with pytest.raises(ValueError):
        getattr(PF, name)(["a b", "c"], ["a b"], **kwargs)


def test_corpus_functionals_with_unequal_batches_raise():
    with pytest.raises((AssertionError, ValueError)):
        JF.bleu_score([["a"]], [])
    with pytest.raises(ValueError):
        PF.bleu_score([["a"]], [], device="cpu")
    for fn in (JF.translation_edit_rate, PF.translation_edit_rate):
        with pytest.raises(ValueError):
            fn(["a", "b"], [["a"]])
    for cls, kw in ((mt.BLEUScore, {}), (pt.BLEUScore, {"device": "cpu"}), (mt.EditDistance, {}),
                    (pt.EditDistance, {"device": "cpu"}), (mt.WER, {}), (pt.WER, {"device": "cpu"})):
        with pytest.raises(ValueError):
            cls(**kw).update(["a", "b"], [["a"]])


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
@pytest.mark.parametrize("case", ["random", "empty_both", "empty_batch"])
def test_edit_distance_functional_equals_jax(reduction, case):
    preds, target = _RATE_CASES[case]
    got = PF.edit_distance(preds, target, reduction=reduction, device="cpu")
    want = JF.edit_distance(preds, target, reduction=reduction)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    if case == "empty_batch" and reduction == "mean":
        assert torch.isnan(got)


# ------------------------------------------------------------ padded DPs
def _padded(seed, batch, n, m, vocab=5):
    rng = np.random.default_rng(seed)
    p = rng.integers(1, vocab, (batch, n)).astype(np.int32)
    t = rng.integers(1, vocab, (batch, m)).astype(np.int32)
    pl = rng.integers(0, n + 1, batch).astype(np.int32)
    tl = rng.integers(0, m + 1, batch).astype(np.int32)
    pl[:2], tl[1:3] = 0, 0  # zero lengths on either side and both
    return p, t, pl, tl


@pytest.mark.parametrize("fn", ["edit_distance_padded", "lcs_length_padded"])
@pytest.mark.parametrize("shape", [(16, 9, 7), (5, 1, 12), (4, 12, 1), (3, 0, 4), (3, 4, 0), (0, 3, 3)])
def test_padded_dps_equal_jax(fn, shape):
    arrays = _padded(sum(shape), *shape)
    got = getattr(PF, fn)(*map(torch.from_numpy, arrays))
    want = np.asarray(getattr(JF, fn)(*map(jnp.asarray, arrays)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["edit_distance_padded", "lcs_length_padded"])
@pytest.mark.parametrize("which, value", [("pred_len", -1), ("pred_len", 10), ("target_len", -2), ("target_len", 8)])
def test_padded_dps_raise_on_out_of_range_lengths(fn, which, value):
    p, t, pl, tl = _padded(3, 4, 9, 7)
    (pl if which == "pred_len" else tl)[1] = value
    with pytest.raises(ValueError, match=which):
        getattr(JF, fn)(*map(jnp.asarray, (p, t, pl, tl)))
    with pytest.raises(ValueError, match=which):
        getattr(PF, fn)(*map(torch.from_numpy, (p, t, pl, tl)))


def test_padded_edit_distance_equals_the_host_dp():
    preds, target = _pairs(7, 40, 0, 20)
    pairs = [(p.split(), t.split()) for p, t in zip(preds, target)]
    vocab = {}
    n = max(len(p) for p, _ in pairs)
    m = max(len(t) for _, t in pairs)
    pi, ti = np.zeros((40, n), np.int64), np.zeros((40, m), np.int64)
    for k, (p, t) in enumerate(pairs):
        pi[k, :len(p)] = [vocab.setdefault(w, len(vocab) + 1) for w in p]
        ti[k, :len(t)] = [vocab.setdefault(w, len(vocab) + 1) for w in t]
    lens = [torch.tensor([len(x[i]) for x in pairs]) for i in (0, 1)]
    got = PF.edit_distance_padded(torch.from_numpy(pi), torch.from_numpy(ti), *lens)
    assert got.tolist() == [jtext._np_edit_distance(p, t) for p, t in pairs]
    wer = pt.WER(device="cpu")
    wer.update_counts(got, lens[1])
    ref = mt.WER()
    ref.update_counts(jnp.asarray(got.numpy()), jnp.asarray(lens[1].numpy()))
    assert int(wer.errors) == int(ref.errors) and int(wer.total) == int(ref.total)
    assert wer._count_bound == ref._count_bound == 40
    assert float(wer.compute()) == float(ref.compute()) == float(np.float32(JF.wer(preds, target)))


# ---------------------------------------------------------------- BLEU
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram", [1, 2, 3, 4])
def test_bleu_counts_and_score_equal_jax(n_gram, smooth):
    preds, refs = _refs(10 + n_gram, 30)
    hyps = [p.split() for p in preds]
    tok_refs = [[r.split() for r in rs] for rs in refs]
    hyp_ids, ref_ids = pnlp._intern_corpus(hyps, tok_refs)
    assert (hyp_ids, ref_ids) == jnlp._intern_corpus(hyps, tok_refs)
    num, den, c, r = pnlp.bleu_counts(*pnlp._pad_corpus(hyp_ids, ref_ids, CPU), n_gram=n_gram)
    jnum, jden, jc, jr = jnlp.bleu_counts(*jnlp._pad_corpus(hyp_ids, ref_ids), n_gram=n_gram)
    assert num.dtype == torch.float32 and den.dtype == torch.int64
    _close(num.numpy(), jnum, rtol=RTOL_BLEU)
    np.testing.assert_array_equal(den.numpy(), np.asarray(jden).astype(np.int64))
    assert (int(c), int(r)) == (int(jc), int(jr))
    _close(PF.bleu_score(hyps, tok_refs, n_gram, smooth, device="cpu").numpy(),
           JF.bleu_score(hyps, tok_refs, n_gram, smooth), rtol=RTOL_BLEU)


def test_bleu_counts_in_small_chunks_equal_one_chunk(monkeypatch):
    preds, refs = _refs(21, 17)
    padded = pnlp._pad_corpus(*pnlp._intern_corpus([p.split() for p in preds],
                                                   [[r.split() for r in rs] for rs in refs]), CPU)
    whole = pnlp.bleu_counts(*padded)
    monkeypatch.setattr(pnlp, "CHUNK_ELEMENTS", 1)
    for a, b in zip(pnlp.bleu_counts(*padded), whole):
        _close(a.numpy(), b.numpy(), rtol=RTOL_BLEU)


@pytest.mark.parametrize("ref_lens, want", [((4, 6), 4), ((6, 4), 6), ((7, 3, 5, 5), 5), ((2, 8), 2)])
def test_bleu_closest_reference_ties_go_to_the_first(ref_lens, want):
    hyp = [["w"] * 5]
    refs = [[["w"] * k for k in ref_lens]]
    ids = pnlp._intern_corpus(hyp, refs)
    _, _, _, r = pnlp.bleu_counts(*pnlp._pad_corpus(*ids, CPU))
    _, _, _, jr = jnlp.bleu_counts(*jnlp._pad_corpus(*ids))
    assert int(r) == int(jr) == want


def test_bleu_empty_corpus_and_examples():
    for corpus in (([], []), ([[]], [[[]]]), ([["a"]], [[]])):
        _close(PF.bleu_score(*corpus, device="cpu").numpy(), JF.bleu_score(*corpus))


@pytest.mark.parametrize("tokenize", ["13a", "none", "char"])
@pytest.mark.parametrize("lowercase", [False, True])
def test_sacrebleu_tokenizers_and_score_equal_jax(tokenize, lowercase):
    preds, refs = _refs(30, 25)
    lines = preds + [r for rs in refs for r in rs] + [
        'He said &quot;3.5 -4,000&quot; &amp; left.<skipped>', "x-\ny 10-20, 1.5. (A) {b} [c] ~d", "Z\tQ"]
    for line in lines:
        assert psacre.tokenize_sacrebleu(line, tokenize, lowercase) == jsacre.tokenize_sacrebleu(line, tokenize, lowercase)
    got = PF.sacre_bleu_score(preds, refs, n_gram=2, tokenize=tokenize, lowercase=lowercase, device="cpu")
    _close(got.numpy(), JF.sacre_bleu_score(preds, refs, n_gram=2, tokenize=tokenize, lowercase=lowercase),
           rtol=RTOL_BLEU)
    with pytest.raises(ValueError):
        psacre.tokenize_sacrebleu("a", "intl")


# ------------------------------------------------------------ chrF, TER
@pytest.mark.parametrize("kw", [{}, {"n_char_order": 3}, {"lowercase": True}, {"whitespace": True},
                                {"beta": 1.0, "eps_smoothing": True}, {"n_char_order": 1, "beta": 3.0}])
def test_chrf_equals_jax(kw):
    preds, target = _pairs(40, 20, 0, 10)
    stat_kw = {k: v for k, v in kw.items() if k in ("n_char_order", "lowercase", "whitespace")}
    np.testing.assert_array_equal(pchrf.chrf_stats(preds, target, **stat_kw), jchrf.chrf_stats(preds, target, **stat_kw))
    assert PF.chrf_score(preds, target, **kw) == JF.chrf_score(preds, target, **kw)


@pytest.mark.parametrize("case_sensitive", [False, True])
@pytest.mark.parametrize("seed", [50, 51])
def test_ter_equals_jax(case_sensitive, seed):
    preds, refs = _refs(seed, 25)
    shifted = ["c d a b e f", "B A c d"]
    shifted_refs = [["a b c d e f"], ["a b c d", "A B C D"]]
    for p, r in ((preds, refs), (shifted, shifted_refs)):
        assert pter.ter_stats(p, r, case_sensitive) == jter.ter_stats(p, r, case_sensitive)
        assert PF.translation_edit_rate(p, r, case_sensitive) == JF.translation_edit_rate(p, r, case_sensitive)
    assert pter._ter_edits("c d a b e f".split(), "a b c d e f".split()) == 1  # one block shift


# --------------------------------------------------------- ROUGE, SQuAD
@pytest.mark.parametrize("size", ["host", "device"])
def test_rouge_equals_jax_on_both_sides_of_the_device_threshold(size):
    n, lo, hi = (10, 3, 12) if size == "host" else (40, 30, 60)
    preds, target = _pairs(60 + n, n, lo, hi)
    pairs = [(prouge._rouge_tokens(p), prouge._rouge_tokens(t)) for p, t in zip(preds, target)]
    cells = sum(len(a) * len(b) for a, b in pairs)
    assert (cells >= prouge._DEVICE_LCS_MIN_CELLS) == (size == "device")
    assert prouge._lcs_lens(pairs, CPU) == jrouge._lcs_lens(pairs) == [jrouge._lcs_len(a, b) for a, b in pairs]
    keys = ("rouge1", "rouge2", "rouge3", "rougeL")
    assert PF.rouge_score(preds, target, keys, device="cpu") == JF.rouge_score(preds, target, keys)
    with pytest.raises(ValueError):
        PF.rouge_score(preds, target, ("rougeX",))


def test_squad_normalizer_and_scores_equal_jax():
    texts = ["The Cat!", "a dog", "an  apple, the pie.", "", "THE", "Mr. O'Neil's (2019) car",
             "antelope the-end", "théâtre à la carte"]
    for t in texts:
        assert psquad._normalize_answer(t) == jsquad._normalize_answer(t)
    preds = ["the cat", "Dog", "", "apple pie", "2019 car", "the"]
    target = [["The cat!", "a dog"], "dog.", ["the"], ["an  apple, the pie."], ["Mr. O'Neil's (2019) car"], "a"]
    assert PF.squad(preds, target) == JF.squad(preds, target)
    assert PF.squad("the cat", ["a cat", "the cat!"]) == JF.squad("the cat", ["a cat", "the cat!"])
    assert PF.squad([], []) == JF.squad([], [])


# ----------------------------------------------------------- Perplexity
def _logits(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, np.dtype(dtype).name))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("ignore_index", [None, -100, 3])
def test_perplexity_equals_jax(dtype, ignore_index, monkeypatch):
    jl, tl = _logits(70, (3, 17, 50), dtype)
    ids = np.random.default_rng(71).integers(0, 50, (3, 17))
    ids[0, :4] = -100
    if ignore_index != -100:
        ids[0, :4] = 7
    monkeypatch.setattr(pppl, "CHUNK_BYTES", 4 * 50 * 7)  # 7 rows a chunk: 8 chunks
    got = pppl._perplexity_update(tl, torch.from_numpy(ids), ignore_index)
    want = jppl._perplexity_update(jl, jnp.asarray(ids), ignore_index)
    _close(got[0].numpy(), want[0], rtol=RTOL_PPL)
    assert int(got[1]) == int(want[1]) and got[1].dtype == torch.int64
    _close(PF.perplexity(tl, torch.from_numpy(ids), ignore_index).numpy(),
           JF.perplexity(jl, jnp.asarray(ids), ignore_index), rtol=RTOL_PPL)


@pytest.mark.parametrize("ids, ignore_index, want", [
    ([[1, -1]], None, 1.6330),  # -1 wraps to V - 1
    ([[1, 2]], None, float("nan")),  # an id equal to V: the gather's fill
    ([[1, -3]], None, float("nan")),  # still negative after one wrap
    ([[1, -100]], -100, 4 / 3),  # ignored ids drop out
    ([[1, 0]], None, 1.6330),
])
def test_perplexity_wrapped_and_out_of_range_ids_equal_jax(ids, ignore_index, want):
    logits = np.log(np.array([[[0.25, 0.75], [0.5, 0.5]]], np.float32))
    got = float(PF.perplexity(torch.from_numpy(logits), torch.tensor(ids), ignore_index))
    ref = float(JF.perplexity(jnp.asarray(logits), jnp.asarray(ids), ignore_index))
    np.testing.assert_allclose([got, ref], [want, want], rtol=1e-4)


def test_perplexity_minus_100_without_ignore_index_wraps_to_v_minus_100():
    jl, tl = _logits(72, (1, 4, 128), jnp.float32)
    ids = np.array([[5, -100, 3, 127]])
    got = float(PF.perplexity(tl, torch.from_numpy(ids)))
    want = float(JF.perplexity(jl, jnp.asarray(ids)))
    same = float(PF.perplexity(tl, torch.tensor([[5, 28, 3, 127]])))
    np.testing.assert_allclose([got, same], [want, want], rtol=RTOL_PPL)


def test_perplexity_rejects_bad_shapes():
    for fn, arr in ((PF.perplexity, torch.zeros), (JF.perplexity, jnp.zeros)):
        with pytest.raises(ValueError):
            fn(arr((4,)), arr((4,), dtype=jnp.int32 if arr is jnp.zeros else torch.int32))
        with pytest.raises(ValueError):
            fn(arr((2, 3, 5)), arr((2, 4), dtype=jnp.int32 if arr is jnp.zeros else torch.int32))


# -------------------------------------------------------------- modules
def _batches_rates(seed):
    return [_pairs(seed + i, n, 0, 12) for i, n in enumerate((6, 1, 9))] + [(["", "a b"], ["", ""])]


def _batches_refs(seed):
    return [_refs(seed + i, n) for i, n in enumerate((5, 1, 8))]


def _batches_squad(seed):
    out = []
    for i, n in enumerate((4, 7)):
        preds, refs = _refs(seed + i, n)
        out.append((preds, refs))
    return out


_MODULES = {
    "WER": (lambda pkg, **kw: pkg.WER(**kw), _batches_rates),
    "CharErrorRate": (lambda pkg, **kw: pkg.CharErrorRate(**kw), _batches_rates),
    "MatchErrorRate": (lambda pkg, **kw: pkg.MatchErrorRate(**kw), _batches_rates),
    "WordInfoLost": (lambda pkg, **kw: pkg.WordInfoLost(**kw), _batches_rates),
    "WordInfoPreserved": (lambda pkg, **kw: pkg.WordInfoPreserved(**kw), _batches_rates),
    "EditDistance": (lambda pkg, **kw: pkg.EditDistance(**kw), _batches_rates),
    "EditDistance_sum": (lambda pkg, **kw: pkg.EditDistance(reduction="sum", **kw), _batches_rates),
    "BLEUScore": (lambda pkg, **kw: pkg.BLEUScore(**kw), _batches_refs),
    "BLEUScore_smooth2": (lambda pkg, **kw: pkg.BLEUScore(n_gram=2, smooth=True, **kw), _batches_refs),
    "SacreBLEUScore": (lambda pkg, **kw: pkg.SacreBLEUScore(**kw), _batches_refs),
    "SacreBLEUScore_char": (lambda pkg, **kw: pkg.SacreBLEUScore(tokenize="char", lowercase=True, **kw),
                            _batches_refs),
    "CHRFScore": (lambda pkg, **kw: pkg.CHRFScore(**kw), _batches_rates),
    "CHRFScore_opts": (lambda pkg, **kw: pkg.CHRFScore(n_char_order=4, lowercase=True, whitespace=True, **kw),
                       _batches_rates),
    "TranslationEditRate": (lambda pkg, **kw: pkg.TranslationEditRate(**kw), _batches_refs),
    "ROUGEScore": (lambda pkg, **kw: pkg.ROUGEScore(**kw), _batches_rates),
    "SQuAD": (lambda pkg, **kw: pkg.SQuAD(**kw), _batches_squad),
}


def _ppl_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for t in (5, 1, 8):
        logits = (rng.normal(size=(2, t, 40)) * 2).astype(np.float32)
        ids = rng.integers(0, 40, (2, t))
        ids[0, 0] = -100
        out.append((logits, ids))
    return out


def _run_modules(name, seed=80):
    build, make = _MODULES[name]
    port, ref = build(pt, device="cpu"), build(mt)
    port_steps, ref_steps = [], []
    for batch in make(seed):
        port_steps.append(_host(port(*batch)))
        ref_steps.append(_host(ref(*batch)))
    return port, ref, port_steps, ref_steps


def _assert_values(got, want, rtol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], rtol)
    else:
        _close(got, want, rtol)


@pytest.mark.parametrize("name", sorted(_MODULES))
def test_modules_equal_jax_over_uneven_batches(name):
    port, ref, port_steps, ref_steps = _run_modules(name)
    rtol = RTOL_BLEU if "BLEU" in name else 0.0
    for got, want in zip(port_steps, ref_steps):
        _assert_values(got, want, rtol)
    _assert_values(_host(port.compute()), _host(ref.compute()), rtol)
    for state in port._defaults:
        value, jvalue = getattr(port, state), np.asarray(getattr(ref, state))
        if jvalue.dtype.kind == "i":
            assert value.dtype == torch.int64, state
            np.testing.assert_array_equal(value.numpy(), jvalue, err_msg=state)
        else:
            assert value.dtype == torch.float32, state
            _close(value.numpy(), jvalue, rtol)
    assert port._count_bound == ref._count_bound
    port.reset()
    assert port._count_bound == 0 and all(not getattr(port, s).any() for s in port._defaults)


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_module_equals_jax(ignore_index):
    port, ref = pt.Perplexity(ignore_index=ignore_index, device="cpu"), mt.Perplexity(ignore_index=ignore_index)
    for logits, ids in _ppl_batches(90):
        if ignore_index is None:
            ids = np.abs(ids) % 40
        got = port(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(ids))
        want = ref(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(ids))
        _close(got.numpy(), want, rtol=RTOL_PPL)
    _close(port.compute().numpy(), ref.compute(), rtol=RTOL_PPL)
    assert int(port.count) == int(ref.count) and port.count.dtype == torch.int64
    assert port._count_bound == ref._count_bound
    with pytest.raises(ValueError):
        pt.Perplexity(ignore_index=1.5, device="cpu")


def test_module_constructor_errors_equal_jax():
    for args in (({"n_gram": 0}, "BLEUScore"), ({"tokenize": "intl"}, "SacreBLEUScore"),
                 ({"n_char_order": 0}, "CHRFScore"), ({"beta": 0}, "CHRFScore"),
                 ({"reduction": None}, "EditDistance"), ({"rouge_keys": ("rouge0",)}, "ROUGEScore")):
        kw, name = args
        with pytest.raises(ValueError):
            getattr(mt, name)(**kw)
        with pytest.raises(ValueError):
            getattr(pt, name)(device="cpu", **kw)


def test_empty_metrics_compute_as_jax():
    for name in ("WER", "CharErrorRate", "MatchErrorRate", "WordInfoPreserved", "WordInfoLost", "EditDistance",
                 "BLEUScore", "CHRFScore", "TranslationEditRate", "ROUGEScore", "SQuAD", "Perplexity"):
        got, want = _host(getattr(pt, name)(device="cpu").compute()), _host(getattr(mt, name)().compute())
        _assert_values(got, want, 0.0)


# ---------------------------------------------------------- checkpoints
@pytest.mark.parametrize("name", ["WER", "MatchErrorRate", "EditDistance", "BLEUScore", "CHRFScore",
                                  "TranslationEditRate", "ROUGEScore", "SQuAD"])
def test_checkpoints_load_across_the_packages(name):
    port, ref, _, _ = _run_modules(name, seed=95)
    ref.persistent(True)
    port.persistent(True)
    saved_ref, saved_port = ref.state_dict(), port.state_dict()
    assert sorted(saved_ref) == sorted(saved_port)
    build, _ = _MODULES[name]
    into_port, into_ref = build(pt, device="cpu"), build(mt)
    into_port.load_state_dict(saved_ref)
    into_ref.load_state_dict(saved_port)
    assert into_port._count_bound == into_ref._count_bound == ref._count_bound
    assert ref._count_bound > 0 or name == "TranslationEditRate"  # TER notes no count in either package
    rtol = RTOL_BLEU if "BLEU" in name else 0.0
    _assert_values(_host(into_port.compute()), _host(ref.compute()), rtol)
    _assert_values(_host(into_ref.compute()), _host(port.compute()), rtol)
    for state in port._defaults:
        assert getattr(into_port, state).dtype == getattr(port, state).dtype


def test_note_count_advances_the_bound_as_jax():
    port, ref = pt.WER(device="cpu"), mt.WER()
    for m in (port, ref):
        m.note_count(7)
        m.note_count(np.int64(5))
        m.update(["a b c"], ["a b d e"])
    assert port._count_bound == ref._count_bound == 16
    assert port.state_dict()["_count_bound"] == ref.state_dict()["_count_bound"] == 16


def test_text_collection_equals_its_members():
    col = pt.MetricCollection([pt.WER(device="cpu"), pt.CharErrorRate(device="cpu"), pt.EditDistance(device="cpu")])
    jcol = mt.MetricCollection([mt.WER(), mt.CharErrorRate(), mt.EditDistance()])
    for preds, target in _batches_rates(100):
        _assert_values(_host(col(preds, target)), _host(jcol(preds, target)), 0.0)
    _assert_values(_host(col.compute()), _host(jcol.compute()), 0.0)


# --------------------------------------------------------------- exports
_TEXT_CLASSES = ("BLEUScore", "CHRFScore", "CharErrorRate", "EditDistance", "MatchErrorRate", "Perplexity",
                 "ROUGEScore", "SQuAD", "SacreBLEUScore", "TranslationEditRate", "WER", "WordInfoLost",
                 "WordInfoPreserved")
_TEXT_FUNCTIONS = ("bleu_score", "cer", "chrf_score", "edit_distance", "edit_distance_padded", "lcs_length_padded",
                   "match_error_rate", "perplexity", "rouge_score", "sacre_bleu_score", "squad",
                   "translation_edit_rate", "wer", "word_information_lost", "word_information_preserved")


def test_text_names_are_exported_as_in_jax():
    import metrics_tpu.text as jtext_pkg
    import metrics_tpu_torch.text as ptext_pkg

    for name in _TEXT_CLASSES:
        assert hasattr(mt, name) and hasattr(jtext_pkg, name)
        assert getattr(pt, name) is getattr(ptext_pkg, name) and name in pt.__all__
    for name in _TEXT_FUNCTIONS:
        assert hasattr(JF, name) and callable(getattr(PF, name)), name


@pytest.mark.parametrize("module, names", [
    ("core", ("Metric", "CompositionalMetric", "MetricCollection")),
    ("utils", ("get_group_indexes", "class_reduce", "reduce")),
    ("parallel", ("PaddedBuffer", "buffer_append", "buffer_init", "buffer_mask", "buffer_merge", "buffer_values",
                  "buffer_compact_gathered", "handle_overflow", "set_overflow_policy", "host_gather",
                  "merge_values")),
    ("ops", ("binned_stat_counts",)),
])
def test_subpackages_export_what_jax_exports_and_the_port_has(module, names):
    import importlib

    ref, port = importlib.import_module(f"metrics_tpu.{module}"), importlib.import_module(f"metrics_tpu_torch.{module}")
    for name in names:
        assert hasattr(ref, name), name
        assert hasattr(port, name), name
    assert pt.functional is PF

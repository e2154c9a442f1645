"""The port's eval metrics (`mico_tpu_torch/evaluation/metrics.py`) against
the JAX package's (`mico_tpu/evaluation/metrics.py`) on random hypotheses,
references, similarity matrices and answers drawn with numpy from a seed
(to 1e-9), and against the frozen goldens of
`tests/fixtures/caption_metric_goldens.json`."""

import json
import os

import numpy as np
import pytest

from mico_tpu.evaluation import metrics as jm
from mico_tpu_torch.evaluation import metrics as tm

WORDS = ("a man dog cat runs sits on the mat park in snowy day hot red blue "
         "two three playing with ball, near tree. !").split()
TOL = 1e-9


def sentence(rng, lo=1, hi=12) -> str:
    n = int(rng.integers(lo, hi))
    return " ".join(rng.choice(WORDS, n))


def corpus(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    hyps = [sentence(rng) for _ in range(n)]
    refs = [[sentence(rng) for _ in range(int(rng.integers(1, 5)))]
            for _ in range(n)]
    # a few hypotheses that copy a reference, so high-order n-grams match
    for i in range(0, n, 5):
        hyps[i] = refs[i][0]
    return hyps, refs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_caption_metrics_match_jax(seed):
    hyps, refs = corpus(seed)
    assert tm.bleu4(hyps, refs) == pytest.approx(jm.bleu4(hyps, refs),
                                                 abs=TOL)
    assert tm.cider_d(hyps, refs) == pytest.approx(jm.cider_d(hyps, refs),
                                                   abs=TOL)
    np.testing.assert_allclose(tm.cider_d_scores(hyps, refs),
                               jm.cider_d_scores(hyps, refs), rtol=0,
                               atol=TOL)
    for s in hyps[:5]:
        assert tm._norm_text(s) == jm._norm_text(s)


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_recall_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_vis = 9
    txt2vis = np.repeat(np.arange(n_vis), rng.integers(1, 4, n_vis))
    rng.shuffle(txt2vis)
    sim = rng.standard_normal((len(txt2vis), n_vis))
    got = tm.retrieval_recall(sim, txt2vis)
    want = jm.retrieval_recall(sim, txt2vis)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=TOL), k


def test_vqa_accuracy_matches_jax():
    rng = np.random.default_rng(3)
    preds = [sentence(rng, 1, 3) for _ in range(30)]
    answers = []
    for i, p in enumerate(preds):
        if i % 3 == 0:
            answers.append(p.upper() + "!")
        elif i % 3 == 1:
            answers.append([p, p, sentence(rng, 1, 3), p])
        else:
            answers.append([sentence(rng, 1, 3) for _ in range(4)])
    assert tm.vqa_accuracy(preds, answers) == pytest.approx(
        jm.vqa_accuracy(preds, answers), abs=TOL)
    assert tm.vqa_accuracy([], []) == 0.0


def test_caption_metric_goldens():
    """The frozen goldens (BLEU-4 vs sacrebleu, CIDEr-D vs pycocoevalcap's
    cider_scorer math; scripts/gen_metric_goldens.py), per image too."""
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "caption_metric_goldens.json")
    with open(path) as f:
        gold = json.load(f)
    hyps = [p["hyp"] for p in gold["pairs"]]
    refs = [p["refs"] for p in gold["pairs"]]
    assert tm.bleu4(hyps, refs) == pytest.approx(gold["bleu4_sacrebleu"],
                                                 abs=1e-4)
    assert tm.cider_d(hyps, refs) == pytest.approx(gold["cider_d_mean"],
                                                   abs=1e-4)
    np.testing.assert_allclose(tm.cider_d_scores(hyps, refs),
                               gold["cider_d_per_image"], atol=1e-4)

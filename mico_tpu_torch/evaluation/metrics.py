"""Eval metrics: retrieval recall, caption quality (BLEU-4, CIDEr-D), VQA
accuracy (counterpart of `mico_tpu/evaluation/metrics.py`, kept as this
package's own copy).

The reference train loop imports `from evaluation import evaluation_registry`
(data/utils/pipeline.py:9) and tracks best CIDEr / accuracy / video_r1
(data/utils/pipeline.py:168-179), but the evaluation package itself is absent
from the reference repo: these are clean-room implementations of the
standard formulas those metric names denote, in plain Python and numpy.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

_PUNCT = re.compile(r"[^\w\s]")


def _norm_text(s: str) -> List[str]:
    return _PUNCT.sub("", s.lower()).split()


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------


def retrieval_recall(
    sim: np.ndarray,
    txt2vis: Sequence[int],
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """sim: (n_text, n_vis) similarity; txt2vis[i] = index of the matching
    visual item for text i (many-to-one for multi-caption sets). Returns
    text→vision (t2v) and vision→text (v2t) recall@k."""
    txt2vis = np.asarray(txt2vis)
    n_text, n_vis = sim.shape
    out: Dict[str, float] = {}

    rank_t2v = np.empty(n_text, np.int64)
    order = np.argsort(-sim, axis=1)
    for i in range(n_text):
        rank_t2v[i] = int(np.nonzero(order[i] == txt2vis[i])[0][0])
    for k in ks:
        out[f"t2v_r{k}"] = float((rank_t2v < k).mean())

    order_v = np.argsort(-sim, axis=0)  # (n_text, n_vis) column-wise
    rank_v2t = np.empty(n_vis, np.int64)
    for j in range(n_vis):
        matches = set(np.nonzero(txt2vis == j)[0].tolist())
        col = order_v[:, j]
        rank_v2t[j] = next(
            (r for r, t in enumerate(col.tolist()) if t in matches), n_text
        )
    for k in ks:
        out[f"v2t_r{k}"] = float((rank_v2t < k).mean())
    out["video_r1"] = out["t2v_r1"]
    return out


# ---------------------------------------------------------------------------
# Captioning
# ---------------------------------------------------------------------------


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu4(hyps: Sequence[str], refs: Sequence[Sequence[str]]) -> float:
    """Corpus BLEU-4 with uniform weights and brevity penalty."""
    log_precisions = []
    hyp_toks = [_norm_text(h) for h in hyps]
    ref_toks = [[_norm_text(r) for r in rs] for rs in refs]
    for n in range(1, 5):
        match, total = 0, 0
        for h, rs in zip(hyp_toks, ref_toks):
            hc = _ngrams(h, n)
            max_rc: Counter = Counter()
            for r in rs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    max_rc[g] = max(max_rc[g], c)
            match += sum(min(c, max_rc[g]) for g, c in hc.items())
            total += max(0, len(h) - n + 1)
        if match == 0:
            return 0.0
        log_precisions.append(math.log(match / total))
    hyp_len = sum(len(h) for h in hyp_toks)
    ref_len = sum(
        min((len(r) for r in rs), key=lambda L: (abs(L - len(h)), L))
        for h, rs in zip(hyp_toks, ref_toks)
    )
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(1, hyp_len))
    return bp * math.exp(sum(log_precisions) / 4)


def cider_d(
    hyps: Sequence[str], refs: Sequence[Sequence[str]], sigma: float = 6.0
) -> float:
    """Corpus CIDEr-D: mean of the per-sample scores."""
    scores = cider_d_scores(hyps, refs, sigma)
    return float(np.mean(scores)) if len(scores) else 0.0


def cider_d_scores(
    hyps: Sequence[str], refs: Sequence[Sequence[str]], sigma: float = 6.0
) -> np.ndarray:
    """Per-sample CIDEr-D: tf-idf weighted n-gram (1..4) cosine similarity
    with a Gaussian length penalty, averaged over n and scaled by 10.
    The per-sample vector is the SCST reward signal (the reference's
    --scst_finetuning surface, data/utils/args.py:255)."""
    hyp_toks = [_norm_text(h) for h in hyps]
    ref_toks = [[_norm_text(r) for r in rs] for rs in refs]
    n_imgs = len(hyp_toks)

    # document frequency over reference sets
    dfs = [Counter() for _ in range(4)]
    for rs in ref_toks:
        for n in range(4):
            seen = set()
            for r in rs:
                seen |= set(_ngrams(r, n + 1).keys())
            for g in seen:
                dfs[n][g] += 1

    def tfidf(counts: Counter, n: int) -> Dict:
        # RAW term counts x idf — pycocoevalcap's cider_scorer convention;
        # normalizing tf by caption length is NOT equivalent because the
        # clipped min() in the -D numerator is not scale-invariant
        vec = {}
        for g, c in counts.items():
            idf = math.log(max(1.0, n_imgs / max(1.0, dfs[n][g])))
            vec[g] = c * idf
        return vec

    def sim(v1: Dict, v2: Dict, l1: int, l2: int) -> float:
        # clipped dot product (the "-D" modification), length penalty
        num = sum(min(v1.get(g, 0.0), v2.get(g, 0.0)) * v2.get(g, 0.0)
                  for g in v1)
        n1 = math.sqrt(sum(x * x for x in v1.values()))
        n2 = math.sqrt(sum(x * x for x in v2.values()))
        if n1 == 0 or n2 == 0:
            return 0.0
        delta = l1 - l2
        return (num / (n1 * n2)) * math.exp(-(delta**2) / (2 * sigma**2))

    scores = []
    for h, rs in zip(hyp_toks, ref_toks):
        score_n = 0.0
        for n in range(4):
            hv = tfidf(_ngrams(h, n + 1), n)
            s = 0.0
            for r in rs:
                rv = tfidf(_ngrams(r, n + 1), n)
                s += sim(hv, rv, len(h), len(r))
            score_n += s / max(1, len(rs))
        scores.append(10.0 * score_n / 4)
    return np.asarray(scores, np.float64)


# ---------------------------------------------------------------------------
# QA
# ---------------------------------------------------------------------------


def vqa_accuracy(preds: Sequence[str], answers: Sequence) -> float:
    """Exact-match accuracy; for list-valued answers uses the VQAv2 rule
    min(#matches/3, 1)."""
    accs = []
    for p, a in zip(preds, answers):
        p = " ".join(_norm_text(p))
        if isinstance(a, list):
            matches = sum(1 for x in a if " ".join(_norm_text(x)) == p)
            accs.append(min(matches / 3.0, 1.0))
        else:
            accs.append(float(" ".join(_norm_text(a)) == p))
    return float(np.mean(accs)) if accs else 0.0

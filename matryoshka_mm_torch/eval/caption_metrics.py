"""Corpus-level caption metrics: CIDEr-D, ROUGE-L, BLEU-1..4.

Compact numpy re-implementations of the pycocoevalcap scorers the
reference's caption tasks call (reference:
lmms-eval/lmms_eval/tasks/coco_cap/utils.py coco_cap_aggregation_result —
Bleu/Rouge/Cider over the pycocoevalcap pipeline; same for nocaps,
flickr30k, textcaps).  CIDEr-D follows Vedantam et al. exactly
(tf-idf n-gram vectors, clipped cosine, length gaussian, sigma=6, x10);
ROUGE-L is the LCS F-score with beta=1.2, max over references; BLEU is
corpus-level with clipped counts and the closest-reference brevity
penalty.  Tokenization is lowercase + punctuation-stripped whitespace
split (a deterministic stand-in for the Java PTBTokenizer — scores track
the official pipeline closely but are not bit-identical).  METEOR and
SPICE need WordNet/Java and are deliberately out of scope.

CIDEr is corpus-level by construction: the idf statistics come from the
evaluation set's own references, so it must run at aggregation time over
all (prediction, references) pairs — see lmms_eval/tasks/task_utils.py
caption_aggregate.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple


def _tokenize(s: str) -> List[str]:
    return re.sub(r"[^\w\s]", "", str(s).lower()).split()


def _ngrams(toks: List[str], n_max: int = 4) -> List[Counter]:
    out = []
    for n in range(1, n_max + 1):
        out.append(Counter(tuple(toks[i:i + n])
                           for i in range(len(toks) - n + 1)))
    return out


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def cider_d(preds: Sequence[str], refs_list: Sequence[Sequence[str]],
            n_max: int = 4, sigma: float = 6.0) -> Tuple[float, List[float]]:
    """Corpus CIDEr-D.  ``refs_list[i]`` are image i's reference captions.
    Returns (corpus score, per-image scores), both already x10."""
    assert len(preds) == len(refs_list)
    ctest = [_ngrams(_tokenize(p), n_max) for p in preds]
    crefs = [[_ngrams(_tokenize(r), n_max) for r in refs] for refs in refs_list]

    # document frequency: images whose reference set contains the n-gram
    df: Counter = Counter()
    for refs in crefs:
        seen = set()
        for ref in refs:
            for grams in ref:
                seen.update(grams)
        for g in seen:
            df[g] += 1
    log_n = math.log(max(len(crefs), 1))

    def vec_norm_len(grams: List[Counter]):
        vec, norm = [], []
        length = sum(grams[0].values())          # unigram count = length
        for n in range(n_max):
            v: Dict[tuple, float] = {}
            sq = 0.0
            for g, tf in grams[n].items():
                idf = log_n - math.log(max(1.0, df[g]))
                v[g] = tf * idf
                sq += v[g] * v[g]
            vec.append(v)
            norm.append(math.sqrt(sq))
        return vec, norm, length

    scores = []
    for test, refs in zip(ctest, crefs):
        tv, tn, tl = vec_norm_len(test)
        acc = [0.0] * n_max
        for ref in refs:
            rv, rn, rl = vec_norm_len(ref)
            delta = float(tl - rl)
            for n in range(n_max):
                num = sum(min(tv[n].get(g, 0.0), rv[n][g]) * rv[n][g]
                          for g in rv[n])
                if tn[n] and rn[n]:
                    val = num / (tn[n] * rn[n])
                else:
                    val = 0.0
                acc[n] += val * math.exp(-delta * delta
                                         / (2.0 * sigma * sigma))
        m = len(refs) or 1
        scores.append(10.0 * sum(a / m for a in acc) / n_max)
    corpus = sum(scores) / max(len(scores), 1)
    return corpus, scores


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y
                       else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def rouge_l(pred: str, refs: Sequence[str], beta: float = 1.2) -> float:
    """LCS F-score.  pycocoevalcap's Rouge.calc_score takes the MAX
    precision and MAX recall independently across references (possibly
    from different references) and forms ONE F from those — not the max
    per-reference F."""
    p = _tokenize(pred)
    if not p:
        return 0.0
    prec_max = rec_max = 0.0
    for ref in refs:
        r = _tokenize(ref)
        if not r:
            continue
        lcs = _lcs_len(p, r)
        prec_max = max(prec_max, lcs / len(p))
        rec_max = max(rec_max, lcs / len(r))
    if prec_max == 0.0 or rec_max == 0.0:
        return 0.0
    return ((1 + beta ** 2) * prec_max * rec_max
            / (rec_max + beta ** 2 * prec_max))


# ---------------------------------------------------------------------------
# corpus BLEU-1..4
# ---------------------------------------------------------------------------

def corpus_bleu(preds: Sequence[str],
                refs_list: Sequence[Sequence[str]],
                n_max: int = 4) -> List[float]:
    """Corpus BLEU with per-n clipped counts and the closest-reference
    brevity penalty; returns [Bleu_1, ..., Bleu_n] where Bleu_k is the
    geometric mean over orders 1..k (pycocoevalcap Bleu convention)."""
    clipped = [0] * n_max
    totals = [0] * n_max
    pred_len = 0
    ref_len = 0
    for pred, refs in zip(preds, refs_list):
        p = _tokenize(pred)
        rtoks = [_tokenize(r) for r in refs]
        pred_len += len(p)
        ref_len += min((abs(len(r) - len(p)), len(r))
                       for r in rtoks)[1] if rtoks else 0
        pg = _ngrams(p, n_max)
        rgs = [_ngrams(r, n_max) for r in rtoks]
        for n in range(n_max):
            max_ref: Counter = Counter()
            for rg in rgs:
                for g, c in rg[n].items():
                    if c > max_ref[g]:
                        max_ref[g] = c
            clipped[n] += sum(min(c, max_ref[g])
                              for g, c in pg[n].items())
            totals[n] += sum(pg[n].values())
    bp = 1.0 if pred_len > ref_len else \
        math.exp(1 - ref_len / max(pred_len, 1))
    out = []
    log_sum = 0.0
    for n in range(n_max):
        prec = clipped[n] / totals[n] if totals[n] else 0.0
        log_sum += math.log(prec) if prec > 0 else -1e9
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out

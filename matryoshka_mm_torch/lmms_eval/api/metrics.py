"""Metrics + aggregations + bootstrap stderr
(reference: lmms-eval/lmms_eval/api/metrics.py).

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/api/metrics.py``.
"""

from __future__ import annotations

import random
import re
from typing import Callable, Dict, List

import numpy as np


def exact_match(gold: str, pred: str, ignore_case: bool = True,
                ignore_punctuation: bool = False) -> float:
    """String equality with the reference's metric options
    (e.g. tasks/realworldqa: ignore_case + ignore_punctuation)."""
    g, p = str(gold).strip(), str(pred).strip()
    if ignore_case:
        g, p = g.lower(), p.lower()
    if ignore_punctuation:
        g = re.sub(r"[^\w\s]", "", g).strip()
        p = re.sub(r"[^\w\s]", "", p).strip()
    return float(g == p)


def anls(gold_list: List[str], pred: str) -> float:
    from ...eval.m4c_evaluator import STVQAANLSEvaluator

    ev = STVQAANLSEvaluator()
    return max(ev.get_anls(pred, g) for g in gold_list)


def vqa_accuracy(gold_list: List[str], pred: str) -> float:
    """VQAv2-style min(#matches/3, 1) consensus accuracy."""
    from ...eval.m4c_evaluator import EvalAIAnswerProcessor

    proc = EvalAIAnswerProcessor()
    pred = proc(pred)
    golds = [proc(g) for g in gold_list]
    return min(sum(1 for g in golds if g == pred) / 3.0, 1.0)


def exact_match_any(gold_list, pred: str) -> float:
    """Case-insensitive exact match against ANY gold answer (the
    MP-DocVQA Evaluator's 'accuracy', reported next to ANLS — reference:
    lmms-eval/lmms_eval/tasks/multidocvqa/utils.py:40-51)."""
    golds = gold_list if isinstance(gold_list, list) else [gold_list]
    p = str(pred).strip().lower()
    return float(any(str(g).strip().lower() == p for g in golds))


def pope_yes_no(gold: str, pred: str) -> float:
    from ...eval.eval_pope import normalize_answer

    return float(normalize_answer(pred) == gold.strip().lower())


def multiple_choice_letter(gold: str, pred: str) -> float:
    """First option letter in the prediction vs gold letter.

    A letter only counts as an option pick when it stands alone —
    followed by a delimiter or the end of the answer.  An optional-suffix
    pattern would match the first letter of any ordinary word ("Blue" ->
    B, "Because..." -> B), silently scoring free-form answers as
    whichever option their first letter spells.  Free text without a
    standalone letter anywhere ("the answer is B") scores 0."""
    letter = _standalone_letter(pred, "A-E")
    return float(letter == gold.strip().upper())


def _standalone_letter(pred: str, letters: str) -> str:
    """Extract the option letter a prediction picks, or ''.

    Prefers a leading "B" / "(B)" / "B." form (either case — an answer
    that *begins* with a lone letter is an option pick); otherwise takes
    the LAST standalone UPPERCASE letter mention in the text (conclusions
    come last: "...so the answer is B."; lowercase in-text letters are
    skipped or the article in "a cat" would read as option A)."""
    pred = str(pred).strip()
    m = re.match(rf"^\(?([{letters}])(?:[).:,]|\s|$)", pred, re.IGNORECASE)
    if m:
        return m.group(1).upper()
    ms = re.findall(rf"(?<![A-Za-z])\(?([{letters}])(?:[).:,]|\s|$)", pred)
    return ms[-1].upper() if ms else ""


def relaxed_accuracy(gold, pred: str, tolerance: float = 0.05) -> float:
    """ChartQA scoring: numeric answers match within 5% relative error,
    everything else falls back to exact string match."""
    golds = gold if isinstance(gold, list) else [gold]
    pred_s = str(pred).strip().rstrip("%").replace(",", "")
    for g in golds:
        g_s = str(g).strip().rstrip("%").replace(",", "")
        try:
            gv, pv = float(g_s), float(pred_s)
            denom = abs(gv) if gv != 0 else 1.0
            if abs(gv - pv) / denom <= tolerance:
                return 1.0
        except ValueError:
            # compare both sides in the SAME normalization — a raw pred
            # against a comma-stripped gold scores the verbatim-correct
            # answer "1,000 people" as wrong
            if g_s.lower() == pred_s.lower():
                return 1.0
    return 0.0


def contains_match(gold, pred: str) -> float:
    """OCRBench scoring: any gold string appears (case/space-insensitive)
    inside the prediction."""
    golds = gold if isinstance(gold, list) else [gold]
    norm = re.sub(r"\s+", " ", str(pred).strip().lower())
    for g in golds:
        if re.sub(r"\s+", " ", str(g).strip().lower()) in norm:
            return 1.0
    return 0.0


def multiple_choice_index(gold, pred: str) -> float:
    """Like :func:`multiple_choice_letter` but the gold is a 0-based option
    index (AI2D-style datasets); standalone-letter rules apply (a bare
    word like "eight" must not read as option E)."""
    pred = str(pred).strip()
    letter = _standalone_letter(pred, "A-H")
    if not letter:
        return float(str(gold).strip() == pred)
    return float(ord(letter) - ord("A") == int(str(gold).strip()))


def squad_f1(gold, pred: str) -> float:
    """SQuAD-style token F1 (WebSRC; reference: tasks/websrc/utils.py)."""
    golds = gold if isinstance(gold, list) else [gold]

    def norm(s):
        return re.sub(r"[^a-z0-9 ]", "", str(s).lower()).split()

    p = norm(pred)
    best = 0.0
    for g in golds:
        gt = norm(g)
        common = 0
        used = list(gt)
        for t in p:
            if t in used:
                used.remove(t)
                common += 1
        if common == 0:
            continue
        prec, rec = common / len(p), common / len(gt)
        best = max(best, 2 * prec * rec / (prec + rec))
    return best


def bleu4(gold, pred: str) -> float:
    """Caption BLEU-4 against one or many references (TextCaps/COCO-style;
    reference: lmms-eval caption tasks via pycocoevalcap, compact
    implementation shared with eval/m4c_evaluator.py)."""
    from ...eval.m4c_evaluator import TextCapsBleu4Evaluator

    golds = gold if isinstance(gold, list) else [gold]
    ev = TextCapsBleu4Evaluator()
    return ev.eval_pred_list(
        [{"pred_answer": str(pred), "gt_answers": [str(g) for g in golds]}])


def gpt4_judge(gold, pred: str) -> float:
    """API-gated GPT judge (reference: mmvet/llava-in-the-wild tasks score
    via GPT-4).  Requires an OpenAI-compatible endpoint; raises a clear
    error offline instead of silently mis-scoring."""
    from ...eval.gpt_review import openai_chat_fn

    chat = openai_chat_fn()  # raises RuntimeError without OPENAI_API_KEY
    golds = gold if isinstance(gold, list) else [gold]
    out = chat(
        "You are grading a model answer against a reference. Reply with a "
        "single number between 0.0 and 1.0 on the first line.",
        f"Reference: {golds[0]}\nModel answer: {pred}\nScore:")
    m = re.search(r"([01](?:\.\d+)?)", out)
    return float(m.group(1)) if m else 0.0


def _parse_bbox(pred: str):
    """First four floats in the prediction -> (x1, y1, x2, y2); the
    reference parses '[x1, y1, x2, y2]' sequences the same way
    (refcoco/utils_rec.py parse_float_sequence_within)."""
    nums = re.findall(r"-?\d+(?:\.\d+)?", str(pred))
    if len(nums) < 4:
        return None
    return [float(v) for v in nums[:4]]


def _iou(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def rec_iou(gold, pred: str) -> float:
    """Referring-expression-comprehension IoU of the predicted vs gold
    normalized bbox (reference: refcoco/utils_rec.py compute_iou)."""
    box = _parse_bbox(pred)
    return _iou(gold, box) if box and gold else 0.0


def rec_acc05(gold, pred: str) -> float:
    """IoU >= 0.5 accuracy (the headline REC metric, refcoco_ACC@0.5)."""
    return 1.0 if rec_iou(gold, pred) >= 0.5 else 0.0


def rec_center_acc(gold, pred: str) -> float:
    """Predicted box center falls inside the gold box
    (refcoco_Center_ACC; also ScreenSpot's click-accuracy analog)."""
    box = _parse_bbox(pred)
    if not box or not gold:
        return 0.0
    cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
    return 1.0 if gold[0] <= cx <= gold[2] and gold[1] <= cy <= gold[3] \
        else 0.0


METRICS: Dict[str, Callable] = {
    "rec_iou": rec_iou,
    "rec_acc05": rec_acc05,
    "rec_center_acc": rec_center_acc,
    "relaxed_accuracy": relaxed_accuracy,
    "contains_match": contains_match,
    "multiple_choice_index": multiple_choice_index,
    "exact_match": exact_match,
    "exact_match_any": exact_match_any,
    "anls": anls,
    "vqa_accuracy": vqa_accuracy,
    "pope_yes_no": pope_yes_no,
    "multiple_choice_letter": multiple_choice_letter,
    "bleu4": bleu4,
    "gpt4_judge": gpt4_judge,
    "squad_f1": squad_f1,
}

AGGREGATIONS = {
    "mean": lambda xs: float(np.mean(xs)) if xs else 0.0,
}


def bootstrap_stderr(values: List[float], iters: int = 1000,
                     seed: int = 1234) -> float:
    """Percentile-bootstrap standard error of the mean
    (reference: metrics.py bootstrap machinery)."""
    if len(values) <= 1:
        return 0.0
    rng = random.Random(seed)
    n = len(values)
    means = []
    for _ in range(iters):
        sample = [values[rng.randrange(n)] for _ in range(n)]
        means.append(sum(sample) / n)
    return float(np.std(means))

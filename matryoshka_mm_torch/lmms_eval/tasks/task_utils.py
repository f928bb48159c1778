"""Per-task doc preprocessing hooks, referenced from task YAMLs as
``process_docs: task_utils.<fn>`` (the compact analog of the reference's
``!function utils.<fn>`` mechanism, e.g.
lmms-eval/lmms_eval/tasks/refcoco/utils_rec.py
``refcoco_bbox_rec_preprocess_dataset``).

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/tasks/task_utils.py``.
"""

from __future__ import annotations

from typing import List


def _normalize_bbox(doc: dict):
    """Pixel ``bbox`` (x, y, w, h) -> normalized corner form (x1, y1,
    x2, y2) in [0, 1], using the doc's image dimensions; returns the
    bbox unchanged when dims are unavailable.  Shared by every REC
    family so the normalization can't drift between them."""
    w = doc.get("image_width") or getattr(doc.get("image"), "width", None)
    h = doc.get("image_height") or getattr(doc.get("image"), "height", None)
    bbox = doc.get("bbox")
    if bbox is not None and w and h and len(bbox) == 4:
        x, y, bw, bh = bbox
        bbox = [x / w, y / h, (x + bw) / w, (y + bh) / h]
    return bbox


def refcoco_rec_preprocess(docs: List[dict]) -> List[dict]:
    """RefCOCO/+/g REC: normalize the bbox and explode the per-image
    referring expressions (``answer`` list) into one doc each
    (reference: utils_rec.py:11-44)."""
    out = []
    for doc in docs:
        bbox = _normalize_bbox(doc)
        answers = doc.get("answer")
        if not isinstance(answers, list):
            answers = [answers]
        for ans in answers:
            out.append({**doc, "answer": ans, "bbox": bbox})
    return out


def screenspot_rec_preprocess(docs: List[dict]) -> List[dict]:
    """ScreenSpot REC: normalize the pixel bbox (x, y, w, h) by the
    screenshot dimensions (reference: screenspot/utils_rec.py)."""
    return [{**doc, "bbox": _normalize_bbox(doc)} for doc in docs]


# ---------------------------------------------------------------------------
# MME — per-category acc + acc_plus (reference:
# lmms-eval/lmms_eval/tasks/mme/utils.py:53-120).  The same protocol as the
# repo's standalone scorer (eval/eval_mme.py score_mme); here it is wired
# into the harness so `mme` prints real MME numbers: each category scores
# 100*(acc + acc_plus) where acc_plus needs BOTH questions about an image
# answered correctly, and perception/cognition totals sum their categories.
# ---------------------------------------------------------------------------

def _mme_parse_pred(pred: str) -> str:
    """yes / no / other (always-wrong) — reference mme/utils.py:53-67."""
    p = str(pred).lower().strip().replace(".", "")
    if p in ("yes", "no"):
        return p
    head = p[:4]
    if "yes" in head:
        return "yes"
    if "no" in head:
        return "no"
    return "other"


def mme_process_results(doc: dict, result: str) -> dict:
    from ...eval.eval_mme import PERCEPTION

    gt = str(doc["answer"]).lower().strip().replace(".", "")
    score = float(_mme_parse_pred(result) == gt)
    cat = doc["category"]
    key = ("mme_perception_score" if cat in PERCEPTION
           else "mme_cognition_score")
    return {key: {"question_id": doc["question_id"], "category": cat,
                  "score": score}}


def mme_aggregate(results: List[dict]) -> dict:
    """Per-category 100*(acc + acc_plus) averaged over the category's
    images, plus the summed total (Perception and Cognition run through
    separate metric keys, so each call's total is that group's headline
    number)."""
    from collections import defaultdict

    by_cat: dict = defaultdict(lambda: defaultdict(list))
    for r in results:
        by_cat[r["category"]][r["question_id"]].append(r["score"])
    out = {}
    for cat, questions in sorted(by_cat.items()):
        total = 0.0
        for scores in questions.values():
            acc = 100.0 * sum(scores) / len(scores)
            acc_plus = 100.0 * float(len(scores) == 2 and sum(scores) == 2)
            total += acc + acc_plus
        out[cat] = round(total / len(questions), 2)
    out["total"] = round(sum(out.values()), 2)
    return out


# ---------------------------------------------------------------------------
# MMBench — option-letter inference + circular consistency + category hit
# rates (reference: lmms-eval/lmms_eval/tasks/mmbench/mmbench_evals.py).
# Circular protocol: rows with index i, i+1e6, i+2e6, ... are the same
# question with rotated options; the question counts as a hit only when
# EVERY rotation's inferred letter matches its gold letter.  Letter
# inference is the evaluator's prefetch chain (standalone letter token,
# punctuation-wrapped letter, unique option-text containment); the GPT
# fallback for unmatchable free-form answers is optional and gated on
# MMBENCH_GPT_MATCH=1 + OPENAI_API_KEY, and an unmatchable prediction
# counts as a miss otherwise (deterministic, unlike the reference's
# random fallback draw at mmbench_evals.py:196-201).
# ---------------------------------------------------------------------------

_OPTION_LETTERS = "ABCDE"


def infer_option_letter(pred: str, options: dict) -> str | None:
    """Infer which option a free-form prediction chose.

    ``options`` maps letters to option text.  Mirrors
    MMBench_Evaluator.can_infer_option/can_infer_text: (1) a unique
    standalone choice letter among the answer's tokens (bare or wrapped in
    the evaluator's punctuation patterns), with the reference's guard
    against 'A' used as an article in long answers; (2) failing that, a
    unique option text contained in the answer."""
    letters = [c for c in _OPTION_LETTERS if c in options]
    pred = str(pred)
    tokens = [t.strip() for t in pred.split()]

    def hits(prefix: str, suffix: str) -> list:
        return [c for c in letters if f"{prefix}{c}{suffix}" in tokens]

    found = hits("", "")
    if len(found) == 1:
        if found[0] == "A" and len(tokens) > 3:
            pass        # 'A' is likely an article in a long sentence
        else:
            return found[0]
    for pre, suf in (("", "."), ("", ","), ("", ":"), ("", ")"), ("", ")."),
                     ("(", ")"), ("(", ")."), (":", ""), (":", ","),
                     (":", "."), (":", ")"), (":", ").")):
        found = hits(pre, suf)
        if len(found) == 1:
            return found[0]
    low = pred.lower()
    text_hits = [c for c in letters
                 if options[c] and str(options[c]).lower() in low]
    if len(text_hits) == 1:
        return text_hits[0]
    return None


def _mmbench_options(doc: dict) -> dict:
    return {c: doc[c] for c in _OPTION_LETTERS
            if doc.get(c) not in (None, "", "nan")}


def mmbench_preprocess(docs: List[dict]) -> List[dict]:
    """Build the options block the prompt template interpolates
    (reference: mmbench_evals.py create_options_prompt with sys_prompt
    'There are several options:') and blank out missing hints."""
    out = []
    for doc in docs:
        opts = _mmbench_options(doc)
        block = "There are several options:\n" + "\n".join(
            f"{c}. {opts[c]}" for c in sorted(opts))
        hint = doc.get("hint")
        if hint is None or str(hint) == "nan":
            hint = ""
        out.append({**doc, "options": block, "hint": hint})
    return out


def mmbench_process_results(doc: dict, result: str) -> dict:
    opts = _mmbench_options(doc)
    pred = infer_option_letter(result, opts)
    if pred is None:
        pred = _mmbench_gpt_match(doc, result, opts)
    return {"mmbench_accuracy": {
        "index": int(doc.get("index", 0)),
        "pred": pred,
        "answer": str(doc.get("answer", "")).strip().upper(),
        "category": doc.get("category", "uncategorized"),
        "l2_category": doc.get("l2-category") or doc.get("L2-category")
        or doc.get("l2_category"),
    }}


def _mmbench_gpt_match(doc: dict, result: str, options: dict):
    """Optional GPT-assisted answer matching (reference:
    mmbench_evals.py build_prompt/extract_answer_from_item); returns the
    matched letter or None.  Off unless MMBENCH_GPT_MATCH=1 and an API key
    is configured."""
    import os

    if os.environ.get("MMBENCH_GPT_MATCH") != "1":
        return None
    try:
        from ...eval.gpt_review import openai_chat_fn

        chat = openai_chat_fn()
    except Exception:
        return None
    opt_str = "\n".join(f"{c}. {options[c]}" for c in sorted(options))
    out = chat(
        "You are an AI assistant who will help me to match an answer with "
        "several options of a single-choice question. You are provided "
        "with a question, several options, and an answer, and you need to "
        "find which option is most similar to the answer. If the meaning "
        "of all options are significantly different from the answer, "
        "output E. Your should output a single uppercase character in A, "
        "B, C, D (if they are valid options), and E.",
        f"Question: {doc.get('question', '')}?\nOptions: {opt_str}\n"
        f"Answer: {result}\nYour output: ")
    letter = infer_option_letter(out, {**options, "E": "none of the above"})
    return letter if letter in options else None


def mmbench_aggregate(results: List[dict]) -> dict:
    """Overall + per-category + per-L2-category hit rates under circular
    consistency (reference: mmbench_evals.py eval_sub_data +
    calculate_hit_rates)."""
    from collections import defaultdict

    groups = defaultdict(list)
    for r in results:
        groups[r["index"] % 1_000_000].append(r)
    hits, cats, l2s = [], defaultdict(list), defaultdict(list)
    for base, rows in sorted(groups.items()):
        hit = float(all(r["pred"] is not None and r["pred"] == r["answer"]
                        for r in rows))
        main = next((r for r in rows if r["index"] == base), rows[0])
        hits.append(hit)
        cats[main["category"]].append(hit)
        if main["l2_category"]:
            l2s[main["l2_category"]].append(hit)
    out = {"overall": round(sum(hits) / len(hits), 4) if hits else 0.0}
    for cat, vs in sorted(cats.items()):
        out[f"category/{cat}"] = round(sum(vs) / len(vs), 4)
    for cat, vs in sorted(l2s.items()):
        out[f"l2/{cat}"] = round(sum(vs) / len(vs), 4)
    return out


# ---------------------------------------------------------------------------
# SEED-Bench — accuracy per question type ("data_type") plus overall
# (reference: lmms-eval/lmms_eval/tasks/seedbench/utils.py:17-46, which
# fans each doc into seed_<data_type> and seed_all metric keys).
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# HallusionBench — aAcc / qAcc / fAcc (reference:
# lmms-eval/lmms_eval/tasks/hallusion_bench/evaluate_hb.py
# hb_aggregation_result_intern, the offline parse variant: answer = yes iff
# "yes" appears in the prediction; qAcc groups by (category, subcategory,
# set_id, question_id) and fAcc by (..., figure_id), a group counting only
# when EVERY member is correct.  The reference's default path swaps the
# yes-parse for a GPT correctness judge — API-gated, not wired here.)
# ---------------------------------------------------------------------------

def hallusion_process_results(doc: dict, result: str) -> dict:
    ans = "1" if "yes" in str(result).lower() else "0"
    gt = str(doc.get("gt_answer", "")).strip()
    base = (str(doc.get("category", "")), str(doc.get("subcategory", "")),
            str(doc.get("set_id", "")))
    return {"hallusion_acc": {
        "correct": float(ans == gt),
        "q_key": "_".join(base + (str(doc.get("question_id", "")),)),
        "f_key": "_".join(base + (str(doc.get("figure_id", "")),)),
    }}


def hallusion_aggregate(results: List[dict]) -> dict:
    from collections import defaultdict

    q_groups, f_groups = defaultdict(list), defaultdict(list)
    for r in results:
        q_groups[r["q_key"]].append(r["correct"])
        f_groups[r["f_key"]].append(r["correct"])

    def _all_correct_rate(groups):
        return (sum(min(vs) for vs in groups.values()) / len(groups)
                if groups else 0.0)

    return {
        "aAcc": round(sum(r["correct"] for r in results)
                      / max(len(results), 1), 4),
        "qAcc": round(_all_correct_rate(q_groups), 4),
        "fAcc": round(_all_correct_rate(f_groups), 4),
    }


# ---------------------------------------------------------------------------
# MMMU — accuracy per subject plus per-discipline and overall rollups
# (reference: lmms-eval/lmms_eval/tasks/mmmu/utils.py mmmu_process_results /
# mmmu_aggregate_results; the subject comes out of the doc id
# "validation_<Subject>_<n>", and DOMAIN_CAT2SUB_CAT groups subjects into
# the six disciplines — that table is MMMU's published taxonomy).
# ---------------------------------------------------------------------------

_MMMU_DOMAINS = {
    "Art and Design": ("Art", "Art_Theory", "Design", "Music"),
    "Business": ("Accounting", "Economics", "Finance", "Manage",
                 "Marketing"),
    "Science": ("Biology", "Chemistry", "Geography", "Math", "Physics"),
    "Health and Medicine": ("Basic_Medical_Science", "Clinical_Medicine",
                            "Diagnostics_and_Laboratory_Medicine",
                            "Pharmacy", "Public_Health"),
    "Humanities and Social Science": ("History", "Literature", "Sociology",
                                      "Psychology"),
    "Tech and Engineering": ("Agriculture", "Architecture_and_Engineering",
                             "Computer_Science", "Electronics",
                             "Energy_and_Power", "Materials",
                             "Mechanical_Engineering"),
}
_MMMU_SUBJECT2DOMAIN = {s: d for d, subs in _MMMU_DOMAINS.items()
                        for s in subs}


def _mmmu_subject(doc_id: str) -> str:
    """'validation_Art_Theory_12' -> 'Art_Theory' (reference:
    mmmu/utils.py extract_subset_name)."""
    parts = str(doc_id).split("_")
    if len(parts) >= 3:
        return "_".join(parts[1:-1])
    return "unknown"


def mmmu_process_results(doc: dict, result: str) -> dict:
    from ..api.metrics import multiple_choice_letter

    score = multiple_choice_letter(str(doc.get("answer", "")), str(result))
    return {"mmmu_acc": {"subject": _mmmu_subject(doc.get("id", "")),
                         "score": score}}


def mmmu_aggregate(results: List[dict]) -> dict:
    return _grouped_mean(results, "subject", "score",
                         domain_map=_MMMU_SUBJECT2DOMAIN)


# ---------------------------------------------------------------------------
# Caption tasks (COCO / NoCaps / Flickr30k / TextCaps) — corpus-level
# Bleu_1..4 / ROUGE_L / CIDEr (reference: the pycocoevalcap pipeline the
# reference caption tasks call, e.g. coco_cap/utils.py
# coco_cap_aggregation_result).  CIDEr's idf statistics come from the
# evaluation set's own references, so scoring happens at aggregation time
# over the collected (prediction, references) pairs.
# ---------------------------------------------------------------------------

def caption_process_results(doc: dict, result: str) -> dict:
    fields = ("answer", "annotations_captions", "reference_strs", "caption")
    refs = None
    for field in fields:
        refs = doc.get(field)
        if refs is not None:
            break
    if refs is None:
        # fail loudly: scoring against str(None) would silently report
        # near-zero CIDEr/BLEU that reads as a bad model rather than a
        # reference-field mismatch
        raise KeyError(
            f"caption doc has none of the known reference fields {fields}; "
            f"got keys {sorted(doc.keys())} — add the dataset's reference "
            "column to caption_process_results")
    if not isinstance(refs, list):
        refs = [refs]
    return {"caption_scores": {"pred": str(result),
                               "refs": [str(r) for r in refs]}}


def caption_aggregate(results: List[dict]) -> dict:
    from ...eval.caption_metrics import cider_d, corpus_bleu, rouge_l

    preds = [r["pred"] for r in results]
    refs = [r["refs"] for r in results]
    bleu = corpus_bleu(preds, refs)
    cider, _ = cider_d(preds, refs)
    rl = (sum(rouge_l(p, rs) for p, rs in zip(preds, refs))
          / max(len(preds), 1))
    return {
        **{f"Bleu_{i + 1}": round(b, 4) for i, b in enumerate(bleu)},
        "ROUGE_L": round(rl, 4),
        "CIDEr": round(cider, 4),
    }


# ---------------------------------------------------------------------------
# POPE — accuracy / precision / recall / F1 / yes-ratio (reference:
# lmms-eval/lmms_eval/tasks/pope/utils.py:29-87; F1 is POPE's headline).
# Same math as the repo's standalone scorer (eval/eval_pope.py).
# ---------------------------------------------------------------------------

def pope_process_results(doc: dict, result: str) -> dict:
    from ...eval.eval_pope import normalize_answer

    pred = normalize_answer(str(result))
    gt = str(doc.get("answer", "")).lower().strip()
    return {"pope_metrics": {"pred": pred, "gt": gt,
                             "score": float(pred == gt)}}


def pope_aggregate(results: List[dict]) -> dict:
    tp = sum(1 for r in results if r["gt"] == "yes" and r["pred"] == "yes")
    fp = sum(1 for r in results if r["gt"] == "no" and r["pred"] == "yes")
    fn = sum(1 for r in results if r["gt"] == "yes" and r["pred"] == "no")
    yes = sum(1 for r in results if r["pred"] == "yes")
    n = max(len(results), 1)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {
        "accuracy": round(sum(r["score"] for r in results) / n, 4),
        "precision": round(precision, 4),
        "recall": round(recall, 4),
        "f1": round(f1, 4),
        "yes_ratio": round(yes / n, 4),
    }


# ---------------------------------------------------------------------------
# OCRBench — per-question-type correct counts, the Text Recognition total
# (six recognition types), and the published Final Score out of ~1000
# (reference: lmms-eval/lmms_eval/tasks/ocrbench/utils.py:68-95; per-doc
# scoring is gold-containment, spaces stripped entirely for HME100k).
# ---------------------------------------------------------------------------

_OCR_RECOGNITION_TYPES = (
    "Regular Text Recognition", "Irregular Text Recognition",
    "Artistic Text Recognition", "Handwriting Recognition",
    "Digit String Recognition", "Non-Semantic Text Recognition")
_OCR_OTHER_TYPES = (
    "Scene Text-centric VQA", "Doc-oriented VQA",
    "Key Information Extraction",
    "Handwritten Mathematical Expression Recognition")


def ocrbench_process_results(doc: dict, result: str) -> dict:
    golds = doc.get("answer")
    if not isinstance(golds, list):
        golds = [golds]
    pred = str(result).lower().strip().replace("\n", " ")
    if doc.get("dataset") == "HME100k":
        # LaTeX expressions are case-SENSITIVE (x vs X, \sum vs \Sum):
        # the reference HME branch lowercases neither side, and a
        # lowercased pred against a raw gold could never match a gold
        # with any capital in it
        pred_raw = str(result).strip().replace("\n", " ").replace(" ", "")
        score = float(any(str(g).strip().replace("\n", " ")
                          .replace(" ", "") in pred_raw for g in golds))
    else:
        score = float(any(str(g).lower().strip().replace("\n", " ") in pred
                          for g in golds))
    return {"ocrbench_accuracy": {
        "score": score,
        "question_type": doc.get("question_type", "unknown"),
    }}


def ocrbench_aggregate(results: List[dict]) -> dict:
    from collections import defaultdict

    by_type = defaultdict(float)
    for r in results:
        by_type[r["question_type"]] += r["score"]
    recognition = sum(by_type[t] for t in _OCR_RECOGNITION_TYPES)
    final = recognition + sum(by_type[t] for t in _OCR_OTHER_TYPES)
    out = {t: int(v) for t, v in sorted(by_type.items())}
    out["text_recognition_total"] = int(recognition)
    out["final_score"] = int(final)
    out["accuracy"] = round(sum(r["score"] for r in results)
                            / max(len(results), 1), 4)
    return out


# ---------------------------------------------------------------------------
# ScreenSpot REC — the reference's full threshold ladder
# (utils_rec.py REC_METRICS: IoU, ACC@0.1..0.9, Center_ACC).
# ---------------------------------------------------------------------------

def screenspot_rec_process_results(doc: dict, result: str) -> dict:
    from ..api.metrics import rec_center_acc, rec_iou

    iou = rec_iou(doc.get("bbox"), str(result))
    return {"screenspot_rec": {
        "iou": iou,
        "center": rec_center_acc(doc.get("bbox"), str(result)),
    }}


def screenspot_rec_aggregate(results: List[dict]) -> dict:
    n = max(len(results), 1)
    out = {"IoU": round(sum(r["iou"] for r in results) / n, 4)}
    for thr in (0.1, 0.3, 0.5, 0.7, 0.9):
        out[f"ACC@{thr}"] = round(
            sum(1.0 for r in results if r["iou"] >= thr) / n, 4)
    out["Center_ACC"] = round(sum(r["center"] for r in results) / n, 4)
    return out


def refcoco_rec_process_results(doc: dict, result: str) -> dict:
    """RefCOCO/+/g REC: the same IoU / ACC@{0.1..0.9} / Center_ACC ladder
    as ScreenSpot (reference: refcoco/utils_rec.py:164-231 registers all
    seven aggregations)."""
    rec = screenspot_rec_process_results(doc, result)["screenspot_rec"]
    return {"refcoco_rec": rec}


def refcoco_rec_aggregate(results: List[dict]) -> dict:
    return screenspot_rec_aggregate(results)


# ---------------------------------------------------------------------------
# WebSRC — squad-F1 per website domain plus the pooled overall
# (reference: lmms-eval/lmms_eval/tasks/websrc/utils.py
# websrc_aggregate_results; the overall is instance-pooled across domains).
# ---------------------------------------------------------------------------

def websrc_process_results(doc: dict, result: str) -> dict:
    from ..api.metrics import squad_f1

    return {"websrc_squad_f1": {
        "f1": squad_f1(doc.get("answer", ""), str(result)),
        "domain": doc.get("domain", "unknown"),
    }}


def _grouped_mean(results: List[dict], group_key: str, value_key: str,
                  domain_map: dict | None = None,
                  overall_key: str = "Overall") -> dict:
    """Per-group means plus instance-pooled rollups: the shared shape of
    the MMMU/CMMMU per-discipline and WebSRC per-domain aggregations
    (reference calculate_ins_level_acc — rollups pool instances, they do
    not average the group means)."""
    from collections import defaultdict

    by_group = defaultdict(list)
    for r in results:
        by_group[r[group_key]].append(r[value_key])
    out = {}
    rollup = defaultdict(list)
    for g, vs in sorted(by_group.items()):
        out[g] = round(sum(vs) / len(vs), 4)
        if domain_map is not None:
            rollup[domain_map.get(g, "unknown")].extend(vs)
    for d, vs in sorted(rollup.items()):
        out[f"Overall-{d}"] = round(sum(vs) / len(vs), 4)
    n = sum(len(vs) for vs in by_group.values())
    out[overall_key] = round(sum(sum(vs) for vs in by_group.values())
                             / max(n, 1), 4)
    return out


def websrc_aggregate(results: List[dict]) -> dict:
    return _grouped_mean(results, "domain", "f1", overall_key="overall")


# ---------------------------------------------------------------------------
# CMMMU — per-subcategory accuracy with per-discipline + overall rollups,
# and per-question-type parsing (reference:
# lmms-eval/lmms_eval/tasks/cmmmu/utils.py cmmmu_process_results /
# cmmmu_aggregate_results).  The three question types: 选择 (multiple
# choice, option letter), 判断 (true/false, 对/错), 填空 (fill-in,
# normalized containment).  The parse chains are compact versions of the
# reference's candidate extraction; the discipline table is CMMMU's
# published taxonomy.
# ---------------------------------------------------------------------------

_CMMMU_DOMAINS = {
    "艺术与设计": ("艺术", "艺术理论", "设计", "音乐"),
    "商业": ("会计", "经济", "金融", "管理", "营销"),
    "科学": ("生物", "化学", "地理", "数学", "物理"),
    "健康与医学": ("基础医学", "临床医学", "诊断学与实验室医学", "制药",
                   "公共卫生"),
    "人文社会科学": ("历史", "文献学", "社会学", "心理学"),
    "技术与工程": ("农业", "建筑学", "计算机科学", "电子学", "能源和电力",
                   "材料", "机械工程"),
}
_CMMMU_SUB2DOMAIN = {s: d for d, subs in _CMMMU_DOMAINS.items()
                     for s in subs}


def _cmmmu_score(doc: dict, result: str) -> float:
    import re

    qtype = str(doc.get("type", "选择"))
    pred = str(result)
    answer = str(doc.get("answer", "")).strip()
    if qtype == "选择":
        # parenthesized letter, else bare letter occurrences, else the
        # answer option's text (reference get_multi_choice_prediction)
        m = re.findall(r"\(([A-D])\)", pred) or re.findall(r"[A-D]", pred)
        if m:
            return float(m[-1].upper() == answer.upper())
        opt = str(doc.get(f"option{ord(answer.upper()) - 64}", "")) \
            if answer.upper() in "ABCD" else ""
        return float(bool(opt) and opt in pred)
    if qtype == "判断":
        # 对/错 verdict words (reference get_TF_prediction indicators).
        # Strip the affirmative 没错 ("that's right") before probing for
        # 错 — its substring would otherwise always read as a falsy
        # verdict, scoring a correct 没错 answer as 错.
        depred = pred.replace("没错", "")
        truthy = any(w in pred for w in ("对", "正确", "是的", "没错"))
        falsy = any(w in depred for w in ("错", "不正确", "否")) \
            or "不对" in pred
        got = "对" if truthy and not falsy else ("错" if falsy else "")
        return float(got == answer)
    # 填空: normalized equality or containment of the gold answer
    norm = re.sub(r"[\s。.,，]", "", pred).lower()
    gold = re.sub(r"[\s。.,，]", "", answer).lower()
    return float(bool(gold) and gold in norm)


def cmmmu_process_results(doc: dict, result: str) -> dict:
    return {"cmmmu_acc": {"subject": str(doc.get("subcategory", "unknown")),
                          "score": _cmmmu_score(doc, result)}}


def cmmmu_aggregate(results: List[dict]) -> dict:
    return _grouped_mean(results, "subject", "score",
                         domain_map=_CMMMU_SUB2DOMAIN)


def seedbench_process_results(doc: dict, result: str) -> dict:
    pred = str(result).strip()
    if len(pred) > 1:
        pred = pred[:1]
    return {"seed_accuracy": {
        "pred": pred.upper(),
        "answer": str(doc.get("answer", "")).strip().upper(),
        "data_type": doc.get("data_type", "unknown"),
    }}


def seedbench_aggregate(results: List[dict]) -> dict:
    from collections import defaultdict

    by_type = defaultdict(list)
    for r in results:
        by_type[r["data_type"]].append(float(r["pred"] == r["answer"]))
    out = {}
    all_scores = []
    for t, vs in sorted(by_type.items()):
        out[t] = round(sum(vs) / len(vs), 4)
        all_scores.extend(vs)
    out["all"] = round(sum(all_scores) / len(all_scores), 4) \
        if all_scores else 0.0
    return out


# ---------------------------------------------------------------------------
# MathVista — faithful extract -> normalize -> compare -> per-key breakdown
# (reference: lmms-eval/lmms_eval/tasks/mathvista/mathvista_evals.py:114-245
# and mathvista/utils.py:45-118).  The reference's extraction chain is
# rule-first (verbatim choice / int / float / `The answer is "..."` regex)
# with a GPT call as the final fallback; here the GPT step is gated behind
# MATHVISTA_GPT_EXTRACT=1 (same pluggable judge as MMBench matching) and an
# offline heuristic (option-letter / last-number scan) takes its place so
# runs without an API key still score every response.
# ---------------------------------------------------------------------------

_MATHVISTA_KEYS = ("question_type", "answer_type", "language", "source",
                   "category", "task", "context", "grade", "skills")


def _mathvista_extract(response: str, question_type: str, answer_type: str,
                       choices: List[str], query: str = "") -> str:
    import os
    import re

    if not response:
        return ""
    r = str(response).strip()
    if question_type == "multi_choice" and r in (choices or []):
        return r
    if answer_type == "integer":
        try:
            return str(int(r))
        except ValueError:
            pass
    if answer_type == "float":
        try:
            return str(float(r))
        except ValueError:
            pass
    m = re.search(r'The answer is "(.*)"\.', r)
    if m:
        return m.group(1)
    if os.environ.get("MATHVISTA_GPT_EXTRACT") == "1":
        try:
            from ...eval.gpt_review import openai_chat_fn

            chat = openai_chat_fn()
            out = chat(
                "Please extract the answer from the model response and "
                "type it at the end of the prompt (only the extracted "
                "answer, nothing else).",
                f"{query}\n\nModel response: {r}\n\nExtracted answer: ")
            if out:
                return str(out).strip()
        except Exception:
            pass
    # offline heuristics (replace the reference's GPT fallback)
    if question_type == "multi_choice" and choices:
        opts = {chr(ord("A") + i): c for i, c in enumerate(choices)}
        letter = infer_option_letter(r, opts)
        if letter:
            return letter
    if answer_type in ("integer", "float"):
        nums = re.findall(r"[-+]?\d*\.?\d+", r.replace(",", ""))
        if nums:
            return nums[-1]
    if answer_type == "list":
        lists = re.findall(r"\[[^\[\]]*\]", r)
        if lists:
            return lists[-1]
    return r


def _mathvista_normalize(extraction: str, choices: List[str],
                         question_type: str, answer_type: str,
                         precision) -> str | None:
    """mathvista_evals.py:171-219 normalize_extracted_answer."""
    import re

    if question_type == "multi_choice":
        extraction = str(extraction or "").strip()
        letter = re.findall(r"\(([a-zA-Z])\)", extraction)
        if letter:
            extraction = letter[0].upper()
        options = [chr(ord("A") + i) for i in range(len(choices or []))]
        if extraction in options:
            return choices[options.index(extraction)]
        if not choices:
            return extraction
        from ...eval.m4c_evaluator import _levenshtein

        dists = [_levenshtein(extraction, str(c)) for c in choices]
        return choices[dists.index(min(dists))]
    if answer_type == "integer":
        try:
            return str(int(float(extraction)))
        except (TypeError, ValueError):
            return None
    if answer_type == "float":
        try:
            return str(round(float(extraction), int(precision or 0)))
        except (TypeError, ValueError):
            return None
    if answer_type == "list":
        try:
            return str(extraction)
        except Exception:
            return None
    return str(extraction) if extraction is not None else None


def mathvista_process_results(doc: dict, result: str) -> dict:
    choices = list(doc.get("choices") or [])
    qt = str(doc.get("question_type", ""))
    at = str(doc.get("answer_type", ""))
    extraction = _mathvista_extract(result, qt, at, choices,
                                    query=str(doc.get("query", "")))
    pred = _mathvista_normalize(extraction, choices, qt,
                                at, doc.get("precision", 0))
    answer = doc.get("answer")
    score = (float(str(pred).strip() == str(answer).strip())
             if answer is not None and pred is not None else 0.0)
    meta = doc.get("metadata") or {}
    rec = {"score": score, "question_type": qt, "answer_type": at}
    for k in _MATHVISTA_KEYS[2:]:
        rec[k] = meta.get(k, doc.get(k))
    return {"mathvista_acc": rec}


def mathvista_aggregate(results: List[dict]) -> dict:
    """Overall accuracy plus per-value breakdowns over every metadata key
    (mathvista/utils.py:81-104 — skills is a list and explodes)."""
    from collections import defaultdict

    out = {"average": round(sum(r["score"] for r in results)
                            / max(len(results), 1), 4)}
    for key in _MATHVISTA_KEYS:
        groups = defaultdict(list)
        for r in results:
            vals = r.get(key)
            if vals is None:
                continue
            for v in (vals if isinstance(vals, (list, tuple)) else [vals]):
                groups[str(v)].append(r["score"])
        for v, vs in sorted(groups.items(),
                            key=lambda kv: -sum(kv[1]) / len(kv[1])):
            out[f"{key}/{v}"] = round(sum(vs) / len(vs), 4)
    return out


# ---------------------------------------------------------------------------
# MathVerse — extract -> score -> per-problem_version / per-subfield
# accuracy (reference: lmms-eval/lmms_eval/tasks/mathverse/
# mathverse_evals.py:155-187 extract_answer/score_answer and :262-306
# eval_results).  The reference runs BOTH stages through GPT; offline the
# extraction reuses MathVista's rule chain and scoring falls back to the
# reference's quick_match (normalized string equality).  MATHVERSE_GPT=1
# restores the GPT judge for the match stage.
# ---------------------------------------------------------------------------

def _mathverse_quick_match(extraction: str, answer: str) -> bool:
    """quick_match (mathverse_evals.py:172-173) with the same whitespace /
    case / trailing-period tolerance the GPT judge exhibits on literal
    matches."""
    a = str(extraction or "").strip().strip(".").lower()
    b = str(answer or "").strip().strip(".").lower()
    return bool(b) and a == b


def _mathverse_extract(response: str, question_type: str) -> str:
    """Offline stand-in for the reference's GPT extractor
    (mathverse_evals.py:155-169 + DEMO_PROMPT_EXTRACT): multi-choice
    answers are bare option letters, free-form answers are the final
    value in the response."""
    import re

    r = str(response or "").strip()
    if not r:
        return ""
    if question_type == "multi-choice":
        letters = re.findall(r"\(([a-zA-Z])\)", r)
        if letters:
            return letters[-1].upper()
        tokens = re.findall(r"(?<![A-Za-z])([A-H])(?![A-Za-z])", r)
        if tokens:
            return tokens[-1]
        return r
    m = re.search(r'[Tt]he answer is "?([^".\n]+)"?\.?\s*$', r)
    if m:
        return m.group(1).strip()
    nums = re.findall(r"[-+]?\d*\.?\d+", r.replace(",", ""))
    if nums:
        return nums[-1]
    return r.splitlines()[-1].strip()


def mathverse_process_results(doc: dict, result: str) -> dict:
    import os

    pred = str(result).strip()
    qt = str(doc.get("question_type", ""))
    answer = doc.get("answer")
    extraction = _mathverse_extract(pred, qt)
    matched = False
    if answer is not None:
        matched = _mathverse_quick_match(extraction, answer)
        if not matched and os.environ.get("MATHVERSE_GPT") == "1":
            try:
                from ...eval.gpt_review import openai_chat_fn

                chat = openai_chat_fn()
                out = chat(
                    "Below is a math question, the correct answer, and a "
                    "model's extracted answer.  Judge whether the "
                    "extracted answer is correct.  Reply with 1 for "
                    "correct or 0 for incorrect, nothing else.",
                    f"Question: {doc.get('question_for_eval', '')}\n"
                    f"Correct answer: {answer}\n"
                    f"Extracted answer: {extraction}\nJudgement: ")
                matched = str(out).replace("Judgement:", "").strip() == "1"
            except Exception:
                pass
    meta = doc.get("metadata") or {}
    return {"mathverse_acc": {
        "score": float(matched),
        "problem_version": str(doc.get("problem_version", "unknown")),
        "subfield": str(meta.get("subfield", doc.get("subfield",
                                                     "unknown"))),
    }}


def mathverse_aggregate(results: List[dict]) -> dict:
    out = {"average": round(sum(r["score"] for r in results)
                            / max(len(results), 1), 4)}
    for key in ("problem_version", "subfield"):
        acc = _grouped_mean(results, key, "score")
        for v, s in acc.items():
            if v != "Overall":
                out[f"{key}/{v}"] = s
    return out


# ---------------------------------------------------------------------------
# OlympiadBench — symbolic-equivalence judging (reference:
# lmms-eval/lmms_eval/tasks/olympiadbench/en_utils.py:51-66 + the
# OlympiadBenchEvaluator protocol, re-implemented in eval/math_judge.py).
# Proof questions (source contains "TP") have no autogradable answer and
# contribute a submission record instead of a score.
# ---------------------------------------------------------------------------

def olympiadbench_doc_to_text(doc: dict) -> str:
    """Faithful prompt construction (en_utils.py:22-48): competition
    header, answer-type hint (multi-answer aware), and the boxed-answer
    instruction."""
    subject = doc.get("subfield", "Mathematics")
    mul = bool(doc.get("is_multiple_answer") or False)
    ans_type = doc.get("answer_type") or "a numeric value"
    if ans_type == "Need_human_evaluate":
        ans_type = "proof based"
    pre = f"The following is a question from an International {subject} " \
          "competition.\n"
    post = (f"The question has multiple answers, each of them should be "
            f"{ans_type}.\n" if mul
            else f"The answer of the question should be {ans_type}.\n")
    post += ("Please calculate the answer according to the given "
             "requirements and the information provided. Please use LaTeX "
             "format to represent the variables and formulas used in the "
             "solution process and results. Please end your solution with ")
    post += ('"So the final answer is \\boxed{multiple answers connected '
             'with commas}.\n' if mul
             else '"So the final answer is \\boxed{answer}."\n')
    return pre + str(doc.get("question", "")) + "\n" + post


def olympiadbench_process_results(doc: dict, result: str) -> dict:
    from ...eval.math_judge import judge

    pred = str(result).strip()
    if "TP" in str(doc.get("source", "")):
        return {"olympiadbench_acc": {"score": None, "submission": pred}}
    pred = pred.split("final answer is")[-1]
    pred = (pred.replace('"', "").replace("\n", "").replace(" ", "")
            .strip(".").strip("\u3002"))
    answers = doc.get("final_answer") or [""]
    # multi-answer docs ship one final_answer entry per part and the
    # prompt asks for "multiple answers connected with commas" — judging
    # only answers[0] would arity-mismatch every correct multi-part
    # prediction to 0; join the parts so judge() compares component-wise.
    # doc["error"] is the dataset's tolerance field — a string like
    # "1e-2" or comma-joined per-component "1e-2,1e-3"; judge() parses it
    # (None falls back to its 1e-8 default, matching the reference)
    ref = ",".join(str(a) for a in answers)
    score = float(judge(ref, pred, doc.get("error")))
    return {"olympiadbench_acc": {"score": score}}


def olympiadbench_aggregate(results: List[dict]) -> dict:
    scored = [r["score"] for r in results if r.get("score") is not None]
    return {
        "accuracy": round(sum(scored) / len(scored), 4) if scored else 0.0,
        "scored": len(scored),
        "proof_submissions": sum(1 for r in results
                                 if r.get("score") is None),
    }


# ---------------------------------------------------------------------------
# ChartQA — relaxed accuracy overall + human/augmented split means
# (reference: lmms-eval/lmms_eval/tasks/chartqa/utils.py:12-22; the split
# comes from doc["type"] == "human_test").
# ---------------------------------------------------------------------------

def chartqa_process_results(doc: dict, result: str) -> dict:
    from ..api.metrics import relaxed_accuracy

    score = relaxed_accuracy(doc.get("answer"), str(result))
    split = ("human" if str(doc.get("type", "")) == "human_test"
             else "augmented")
    return {"relaxed_accuracy": {"score": score, "split": split}}


def chartqa_aggregate(results: List[dict]) -> dict:
    out = {"relaxed_overall": round(
        sum(r["score"] for r in results) / max(len(results), 1), 4)}
    for split in ("human", "augmented"):
        vs = [r["score"] for r in results if r["split"] == split]
        if vs:
            out[f"relaxed_{split}_split"] = round(sum(vs) / len(vs), 4)
    return out


# ---------------------------------------------------------------------------
# MM-Vet — GPT-graded scores rolled up overall + per-capability +
# per-capability-combination (reference:
# lmms-eval/lmms_eval/tasks/mmvet/utils.py:159-203; the judge itself is
# the API-gated gpt4_judge metric, as in the reference which requires a
# GPT-4 key).
# ---------------------------------------------------------------------------

def mmvet_process_results(doc: dict, result: str) -> dict:
    from ..api.metrics import gpt4_judge

    caps = doc.get("capability", "")
    if isinstance(caps, (list, tuple)):
        caps = ",".join(str(c) for c in caps)
    return {"gpt4_judge": {
        "score": gpt4_judge(doc.get("answer", ""), str(result)),
        "capabilities": str(caps),
    }}


def mmvet_aggregate(results: List[dict]) -> dict:
    from collections import defaultdict

    n = max(len(results), 1)
    out = {"overall": round(
        100.0 * sum(r["score"] for r in results) / n, 2)}
    caps, combos = defaultdict(list), defaultdict(list)
    for r in results:
        parts = [c.strip() for c in r["capabilities"].split(",") if c]
        for c in parts:
            caps[c].append(r["score"])
        combos["_".join(sorted(parts))].append(r["score"])
    for c, vs in sorted(caps.items()):
        out[f"cap/{c}"] = round(100.0 * sum(vs) / len(vs), 2)
    for c, vs in sorted(combos.items()):
        if "_" in c:        # single-capability combos duplicate cap/
            out[f"detail/{c}"] = round(100.0 * sum(vs) / len(vs), 2)
    return out


# ---------------------------------------------------------------------------
# LLaVA-Bench (in-the-wild / COCO) — pairwise GPT review against the
# dataset's GPT-4 reference answers, reported as the relative score
# 100 * mean(model) / mean(gpt4) overall and per category (reference:
# lmms-eval/lmms_eval/tasks/llava-in-the-wild/utils.py:89-192; the
# rubric text is the reference rule.json llava_bench_* prompt, a scoring
# spec shared by all three categories).  API-gated like the standalone
# eval/gpt_review.py pipeline.
# ---------------------------------------------------------------------------

_LLAVA_BENCH_RUBRIC = (
    "We would like to request your feedback on the performance of two AI "
    "assistants in response to the user question displayed above. The "
    "user asks the question on observing an image. For your reference, "
    "the visual content in the image is represented with a few sentences "
    "describing the image. \nPlease rate the helpfulness, relevance, "
    "accuracy, level of details of their responses. Each assistant "
    "receives an overall score on a scale of 1 to 10, where a higher "
    "score indicates better overall performance.\nPlease first output a "
    "single line containing only two values indicating the scores for "
    "Assistant 1 and 2, respectively. The two scores are separated by a "
    "space.\nIn the subsequent line, please provide a comprehensive "
    "explanation of your evaluation, avoiding any potential bias and "
    "ensuring that the order in which the responses were presented does "
    "not affect your judgment.")


def llava_wild_process_results(doc: dict, result: str) -> dict:
    from ...eval.gpt_review import openai_chat_fn, parse_score

    chat = openai_chat_fn()  # raises a clear error without an API key
    context = doc.get("caption", doc.get("context", ""))
    if isinstance(context, (list, tuple)):
        context = "\n".join(str(c) for c in context)
    content = (f"[Context]\n{context}\n\n"
               f"[Question]\n{doc.get('question', '')}\n\n"
               f"[Assistant 1]\n{doc.get('gpt_answer', '')}\n"
               "[End of Assistant 1]\n\n"
               f"[Assistant 2]\n{result}\n[End of Assistant 2]\n\n"
               f"[System]\n{_LLAVA_BENCH_RUBRIC}\n\n")
    review = chat("You are a helpful and precise assistant for checking "
                  "the quality of the answer.", content)
    scores = parse_score(review)
    return {"gpt4_judge": {"gpt4": scores[0], "model": scores[1],
                           "category": str(doc.get("category", "all"))}}


def llava_wild_aggregate(results: List[dict]) -> dict:
    from collections import defaultdict

    valid = [r for r in results if r["gpt4"] > 0 and r["model"] > 0]
    groups = defaultdict(list)
    for r in valid:
        groups["all"].append(r)
        groups[r["category"]].append(r)
    out = {}
    for cat, rs in sorted(groups.items()):
        g = sum(r["gpt4"] for r in rs) / len(rs)
        m = sum(r["model"] for r in rs) / len(rs)
        out[cat] = round(100.0 * m / g, 1) if g else 0.0
    return out

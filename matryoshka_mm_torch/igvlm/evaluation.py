"""IG-VLM answer scoring: exact multiple-choice + GPT judge.

Reference surfaces re-provided:
* ``eval_multiple_choice``  — IG-VLM/evaluation/direct_answer_eval.py:11-65
* ``eval_gpt3``             — IG-VLM/evaluation/gpt3_evaluation_utils.py:18-99
  (per-question resume files, result.csv merge, yes/no + 0-5 score)
* ``eval_gpt3_consistency`` — IG-VLM/evaluation/gpt3_consistency_utils.py
  (paired-question consistency scoring)

The judge is pluggable: any ``chat(messages) -> str`` callable.  The
default posts to an OpenAI-compatible endpoint (``$OPENAI_API_KEY`` /
``$OPENAI_BASE_URL``); tests inject a fake.  The judge rubric strings are
scoring-spec data (Video-ChatGPT evaluation protocol, used verbatim by the
reference) — changing their wording changes absolute scores, so they are
kept semantically intact as a data table.

The PyTorch port's copy of ``matryoshka_mm_tpu/igvlm/evaluation.py``.
"""

from __future__ import annotations

import ast
import enum
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

JudgeFn = Callable[[List[dict]], str]


def extract_answer(pred: str) -> str:
    """Pull the option letter out of a multiple-choice prediction."""
    pred = pred.strip()
    m = re.search(r"\(?([A-E])\)?[.:\s]|^\(?([A-E])\)?$", pred)
    if m:
        return (m.group(1) or m.group(2)).upper()
    return pred[:1].upper()


def eval_multiple_choice(df) -> Dict[str, float]:
    """Exact option-letter accuracy (direct_answer_eval.py:11-65).

    Expects columns ``pred`` and ``answer`` (gold letter or index)."""
    correct = 0
    total = 0
    for _, row in df.iterrows():
        gold = str(row["answer"]).strip()
        if gold.isdigit():
            gold = "ABCDE"[int(gold)]
        pred = extract_answer(str(row["pred"]))
        correct += int(pred == gold.upper())
        total += 1
    acc = correct / max(total, 1)
    print(f"Accuracy: {acc * 100:.2f}% ({correct}/{total})")
    return {"accuracy": acc, "correct": correct, "total": total}


# ---------------------------------------------------------------------------
# GPT judge (reference: gpt3_evaluation_utils.py, gpt3_consistency_utils.py)
# ---------------------------------------------------------------------------

class EvaluationType(enum.Enum):
    """Video-ChatGPT text-generation benchmark dimensions
    (reference: pipeline_processor/record.py:11)."""

    DEFAULT = "default"                      # yes/no match + 0-5 score
    CORRECTNESS = "correctness"              # CI
    DETAILED_ORIENTATION = "detailed"        # DO
    CONTEXT = "context"                      # CU
    TEMPORAL = "temporal"                    # TU


_DICT_CONTRACT = (
    "Please generate the response in the form of a Python dictionary string "
    "with keys {keys}. DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. "
    "Only provide the Python dictionary string. For example, your response "
    "should look like this: {example}.")

# (system rubric, user-score-request, dict keys, example) per dimension —
# scoring-spec data, reference: gpt3_evaluation_utils.py:99-220
_RUBRICS = {
    EvaluationType.DEFAULT: (
        "You are an intelligent chatbot designed for evaluating the "
        "correctness of generative outputs for question-answer pairs. Your "
        "task is to compare the predicted answer with the correct answer and "
        "determine if they match meaningfully. "
        "------##INSTRUCTIONS: - Focus on the meaningful match between the "
        "predicted answer and the correct answer.\n- Consider synonyms or "
        "paraphrases as valid matches.\n- Evaluate the correctness of the "
        "prediction compared to the answer.",
        "Provide your evaluation only as a yes/no and score where the score "
        "is an integer value between 0 and 5, with 5 indicating the highest "
        "meaningful match. ",
        "'pred' and 'score', where value of 'pred' is a string of 'yes' or "
        "'no' and value of 'score' is in INTEGER, not STRING",
        "{'pred': 'yes', 'score': 4}"),
    EvaluationType.CORRECTNESS: (
        "You are an intelligent chatbot designed for evaluating the factual "
        "accuracy of generative outputs for video-based question-answer "
        "pairs. Your task is to compare the predicted answer with the "
        "correct answer and determine if they are factually consistent. "
        "------##INSTRUCTIONS: - Focus on the factual consistency between "
        "the predicted answer and the correct answer. The predicted answer "
        "should not contain any misinterpretations or misinformation.\n- The "
        "predicted answer must be factually accurate and align with the "
        "video content.\n- Consider synonyms or paraphrases as valid "
        "matches.\n- Evaluate the factual accuracy of the prediction "
        "compared to the answer.",
        "Provide your evaluation only as a factual accuracy score where the "
        "factual accuracy score is an integer value between 0 and 5, with 5 "
        "indicating the highest level of factual consistency. ",
        "'score', where its value is the factual accuracy score in INTEGER, "
        "not STRING",
        "{'score': 4}"),
    EvaluationType.DETAILED_ORIENTATION: (
        "You are an intelligent chatbot designed for evaluating the detail "
        "orientation of generative outputs for video-based question-answer "
        "pairs. Your task is to compare the predicted answer with the "
        "correct answer and determine its level of detail, considering both "
        "completeness and specificity. "
        "------##INSTRUCTIONS: - Check if the predicted answer covers all "
        "major points from the video. The response should not leave out any "
        "key aspects.\n- Evaluate whether the predicted answer includes "
        "specific details rather than just generic points. It should provide "
        "comprehensive information that is tied to specific elements of the "
        "video.\n- Consider synonyms or paraphrases as valid matches.\n- "
        "Provide a single evaluation score that reflects the level of detail "
        "orientation of the prediction, considering both completeness and "
        "specificity.",
        "Provide your evaluation only as a detail orientation score where "
        "the detail orientation score is an integer value between 0 and 5, "
        "with 5 indicating the highest level of detail orientation. ",
        "'score', where its value is the detail orientation score in "
        "INTEGER, not STRING",
        "{'score': 4}"),
    EvaluationType.CONTEXT: (
        "You are an intelligent chatbot designed for evaluating the "
        "contextual understanding of generative outputs for video-based "
        "question-answer pairs. Your task is to compare the predicted answer "
        "with the correct answer and determine if the generated response "
        "aligns with the overall context of the video content. "
        "------##INSTRUCTIONS: - Evaluate whether the predicted answer "
        "aligns with the overall context of the video content. It should not "
        "provide information that is out of context or misaligned.\n- The "
        "predicted answer must capture the main themes and sentiments of the "
        "video.\n- Consider synonyms or paraphrases as valid matches.\n- "
        "Provide your evaluation of the contextual understanding of the "
        "prediction compared to the answer.",
        "Provide your evaluation only as a contextual understanding score "
        "where the contextual understanding score is an integer value "
        "between 0 and 5, with 5 indicating the highest level of contextual "
        "understanding. ",
        "'score', where its value is the contextual understanding score in "
        "INTEGER, not STRING",
        "{'score': 4}"),
    EvaluationType.TEMPORAL: (
        "You are an intelligent chatbot designed for evaluating the temporal "
        "understanding of generative outputs for video-based question-answer "
        "pairs. Your task is to compare the predicted answer with the "
        "correct answer and determine if they correctly reflect the temporal "
        "sequence of events in the video content. "
        "------##INSTRUCTIONS: - Focus on the temporal consistency between "
        "the predicted answer and the correct answer. The predicted answer "
        "should correctly reflect the sequence of events or details as they "
        "are presented in the video.\n- Consider synonyms or paraphrases as "
        "valid matches, but only if the temporal order is maintained.\n- "
        "Evaluate the temporal accuracy of the prediction compared to the "
        "answer.",
        "Provide your evaluation only as a temporal accuracy score where the "
        "temporal accuracy score is an integer value between 0 and 5, with 5 "
        "indicating the highest level of temporal consistency. ",
        "'score', where its value is the temporal accuracy score in INTEGER, "
        "not STRING",
        "{'score': 4}"),
}

_CONSISTENCY_RUBRIC = (
    "You are an intelligent chatbot designed for evaluating the consistency "
    "of generative outputs for similar video-based question-answer pairs. "
    "You will be given two very similar questions, a common answer common to "
    "both the questions and predicted answers for the two questions. Your "
    "task is to compare the predicted answers for two very similar question, "
    "with a common correct answer and determine if they are consistent. "
    "------##INSTRUCTIONS: - Focus on the consistency between the two "
    "predicted answers and the correct answer. Both predicted answers should "
    "correspond to the correct answer and to each other, and should not "
    "contain any contradictions or significant differences in the conveyed "
    "information.\n- Both predicted answers must be consistent with each "
    "other and the correct answer, in terms of the information they provide "
    "about the video content.\n- Consider synonyms or paraphrases as valid "
    "matches, but only if they maintain the consistency in the conveyed "
    "information.\n- Evaluate the consistency of the two predicted answers "
    "compared to the correct answer.")


def make_messages(question: str, answer: str, pred: str,
                  eval_type: EvaluationType = EvaluationType.DEFAULT
                  ) -> List[dict]:
    system, request, keys, example = _RUBRICS[eval_type]
    user = ("Please evaluate the following video-based question-answer "
            f"pair:\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
            f"Predicted Answer: {pred}\n\n" + request
            + _DICT_CONTRACT.format(keys=keys, example=example))
    return [{"role": "system", "content": system},
            {"role": "user", "content": user}]


def make_consistency_messages(q1: str, q2: str, answer: str, p1: str,
                              p2: str) -> List[dict]:
    user = ("Please evaluate the following video-based question-answer "
            f"pair:\n\nQuestion 1: {q1}\nQuestion 2: {q2}\n"
            f"Correct Answer: {answer}\n"
            f"Predicted Answer to Question 1: {p1}\n"
            f"Predicted Answer to Question 2: {p2}\n\n"
            "Provide your evaluation only as a consistency score where the "
            "consistency score is an integer value between 0 and 5, with 5 "
            "indicating the highest level of consistency. "
            + _DICT_CONTRACT.format(
                keys="'score', where its value is the consistency score in "
                     "INTEGER, not STRING",
                example="{'score': 4}"))
    return [{"role": "system", "content": _CONSISTENCY_RUBRIC},
            {"role": "user", "content": user}]


def openai_judge(api_key: Optional[str] = None,
                 model: str = "gpt-3.5-turbo") -> JudgeFn:
    """Default judge: OpenAI-compatible chat endpoint.  Fails loudly when
    no key/endpoint is configured."""
    api_key = api_key or os.environ.get("OPENAI_API_KEY")
    base = os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1")
    if not api_key:
        raise RuntimeError(
            "GPT-judge evaluation needs an OpenAI-compatible endpoint: pass "
            "--api_key or set OPENAI_API_KEY (and optionally "
            "OPENAI_BASE_URL).")
    import requests

    def chat(messages: List[dict]) -> str:
        r = requests.post(
            f"{base}/chat/completions",
            headers={"Authorization": f"Bearer {api_key}"},
            json={"model": model, "messages": messages}, timeout=120)
        r.raise_for_status()
        return r.json()["choices"][0]["message"]["content"]

    return chat


def parse_judge_response(text: str) -> Dict[str, object]:
    """'{'pred': 'yes', 'score': 4}.' -> dict; tolerant of trailing periods
    and doubled quotes (reference: merge_qa_and_answer uses eval())."""
    text = text.strip()
    if text.endswith("."):
        text = text[:-1]
    text = text.replace("''", "'")
    try:
        out = ast.literal_eval(text)
        if isinstance(out, dict):
            return out
    except (ValueError, SyntaxError):
        pass
    # salvage: regex the fields out of malformed output
    out: Dict[str, object] = {}
    m = re.search(r"['\"]?pred['\"]?\s*[:=]\s*['\"]?(yes|no)", text, re.I)
    if m:
        out["pred"] = m.group(1).lower()
    m = re.search(r"['\"]?score['\"]?\s*[:=]\s*([0-9.]+)", text)
    if m:
        out["score"] = float(m.group(1))
    return out


def _judged_rows(rows, path_result: str, judge: JudgeFn, build_messages):
    """Per-question resume: <question_id>.txt caches the raw judge output,
    so an interrupted run re-queries only the missing rows
    (reference: process_gpt3_evaluation_v2 resume-by-file)."""
    os.makedirs(path_result, exist_ok=True)
    for row in rows:
        path = os.path.join(path_result, f"{row['question_id']}.txt")
        if os.path.exists(path):
            continue
        text = judge(build_messages(row))
        with open(path, "w") as f:
            f.write(text)


def _merge(df, path_result: str, columns=("gpt3_pred", "gpt3_score")):
    import pandas as pd

    df = df.copy()
    for c in columns:
        df[c] = None
    for idx, row in df.iterrows():
        path = os.path.join(path_result, f"{row['question_id']}.txt")
        if not os.path.exists(path):
            print(f"{path} not exist")
            continue
        with open(path) as f:
            parsed = parse_judge_response(f.read())
        if "gpt3_pred" in columns:
            df.loc[idx, "gpt3_pred"] = str(parsed.get("pred", ""))
        df.loc[idx, "gpt3_score"] = parsed.get("score")
    path_merged = os.path.join(path_result, "result.csv")
    df.to_csv(path_merged)
    return df, path_merged


def eval_gpt3(df_merged, path_result: str, judge: Optional[JudgeFn] = None,
              gpt_eval_type: EvaluationType = EvaluationType.DEFAULT,
              api_key: Optional[str] = None) -> Tuple[object, str]:
    """Judge every prediction with resume; returns (df, result.csv path).
    An existing result.csv short-circuits the whole run (idempotent reruns,
    reference: eval_gpt3:27-35)."""
    import pandas as pd

    result_path = os.path.join(path_result, "result.csv")
    if os.path.exists(result_path):
        return pd.read_csv(result_path, index_col=0), result_path

    judge = judge or openai_judge(api_key)
    _judged_rows(
        df_merged.to_dict("records"), path_result, judge,
        lambda row: make_messages(row["question"], row["answer"],
                                  row["pred"], gpt_eval_type))
    cols = (("gpt3_pred", "gpt3_score")
            if gpt_eval_type == EvaluationType.DEFAULT else ("gpt3_score",))
    return _merge(df_merged, path_result, cols)


def eval_gpt3_consistency(df1, df2, path_result: str,
                          judge: Optional[JudgeFn] = None,
                          api_key: Optional[str] = None) -> Tuple[object, str]:
    """Consistency (CO) scoring over paired question sets: both frames of
    each question_id are judged together (reference:
    gpt3_consistency_utils.py:17-99)."""
    import pandas as pd

    result_path = os.path.join(path_result, "result.csv")
    if os.path.exists(result_path):
        return pd.read_csv(result_path, index_col=0), result_path

    judge = judge or openai_judge(api_key)
    rows2 = {r["question_id"]: r for r in df2.to_dict("records")}
    paired = []
    for r1 in df1.to_dict("records"):
        r2 = rows2[r1["question_id"]]
        paired.append({**r1, "_q2": r2["question"], "_p2": r2["pred"]})
    _judged_rows(
        paired, path_result, judge,
        lambda row: make_consistency_messages(
            row["question"], row["_q2"], row["answer"], row["pred"],
            row["_p2"]))
    return _merge(df1, path_result, ("gpt3_score",))


def summarize_judge(df) -> Dict[str, float]:
    """Acc (yes-rate, when pred column present) + mean score
    (reference entry-point tails)."""
    out: Dict[str, float] = {}
    if "gpt3_pred" in df and df["gpt3_pred"].notna().any():
        out["accuracy"] = float((df["gpt3_pred"] == "yes").mean())
    scores = df["gpt3_score"].dropna().astype(float)
    out["score"] = float(scores.mean()) if len(scores) else 0.0
    return out

"""PyTorch port: the eval scorers, converters and GPT-graded scorers give
what the JAX package's originals give on the same inputs.

Each case runs once with the JAX package's module and once with the
port's, each writing into a directory of its own, and the results (or the
bytes of the files written) must be equal; the caption metrics (CIDEr-D,
ROUGE-L, BLEU) to 1e-12.  The GPT-graded scorers get the same fake
``chat_fn``: no network call is made."""

import importlib
import json
import math
import os

import numpy as np
import pytest

ANSWERS = ["Yes, there is a dog.", "No.", "no, I do not see one",
           "There is not a cat", "Yes", "The  Cat!", "two dogs",
           "a dog's toy", "dont know", "It is 3.5 meters", "No, not really.",
           "yes"]
LABELS = ["yes", "no", "no", "yes", "yes", "no", "yes", "yes", "no", "yes",
          "no", "no"]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.eval.{name}")


def _jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _answers(d, texts=ANSWERS, start=0, prompt="Is there a dog?"):
    return _jsonl(d / "answers.jsonl", [
        {"question_id": start + i, "prompt": prompt, "text": t,
         "answer_id": f"a{i}", "model_id": "m", "metadata": {}}
        for i, t in enumerate(texts)])


def _fake_chat(system, user):
    """A judge whose reply depends on the prompt alone."""
    h = sum(map(ord, user)) % 11
    return f"{h % 10} {(h * 7) % 10}\nAssistant {h % 2 + 1} is better. " \
           f"The answer is {'ABCDE'[h % 5]}. Score {h / 10:.1f}"


# ---------------------------------------------------------------------------
# the cases: each takes the package's module getter and a fresh directory
# ---------------------------------------------------------------------------

def case_pope(m, d):
    labels = _jsonl(d / "labels.jsonl", [{"question_id": i, "label": l}
                                         for i, l in enumerate(LABELS)])
    answers = [{"text": t} for t in ANSWERS]
    return (m("eval_pope").eval_pope(answers, labels),
            [m("eval_pope").normalize_answer(t) for t in ANSWERS])


def case_mme(m, d):
    cats = ["existence", "count", "OCR", "commonsense_reasoning",
            "code_reasoning", "artwork"]
    ann = [{"question_id": i, "category": cats[i % len(cats)],
            "image": f"img{i // 2}.png", "gt": LABELS[i].capitalize()}
           for i in range(len(LABELS))]
    ans = [{"question_id": i, "text": t} for i, t in enumerate(ANSWERS)]
    return m("eval_mme").score_mme(ann, ans)


def case_evalai_processor(m, d):
    p = m("m4c_evaluator").EvalAIAnswerProcessor()
    return [p(t) for t in ANSWERS + ["Ten apples.", "the 2 cats", "an owl",
                                     "isnt it?", "1,000,000", "Mr. Smith's"]]


def _pred_list():
    gts = [["dog"] * 6 + ["a dog"] * 4, ["cat"] * 5 + ["dog"] * 5,
           ["2"] * 3 + ["two"] * 7, ["no"] * 10, ["3.5 m"] * 10]
    preds = ["dog", "Cat", "two", "yes", "3.5 meters"]
    return [{"pred_answer": p, "gt_answers": g} for p, g in zip(preds, gts)]


def case_textvqa_stvqa_anls(m, d):
    ev = m("m4c_evaluator")
    preds = _pred_list()
    return (ev.TextVQAAccuracyEvaluator().eval_pred_list(preds),
            ev.STVQAAccuracyEvaluator().eval_pred_list(preds),
            ev.STVQAANLSEvaluator().eval_pred_list(preds),
            ev.TextCapsBleu4Evaluator().eval_pred_list(
                [{"pred_answer": "a dog on the grass",
                  "gt_answers": ["a dog lies on the grass", "dog on grass"]},
                 {"pred_answer": "a red car", "gt_answers": ["a red car"]}]))


PROMPTS = [
    "What is written on the sign?\nAnswer the question using a single word "
    "or phrase.",
    "Reference OCR token: STOP, sign\nWhat is written on the sign?\nAnswer "
    "the question using a single word or phrase.",
    "OCR tokens: a b c Question: What brand is it? Short answer:",
]


def case_question_from_prompt(m, d):
    return [m("eval_textvqa").question_from_prompt(p) for p in PROMPTS]


def case_textvqa_score(m, d):
    qs = ["what is written on the sign?", "what is written on the sign?",
          "what brand is it?"]
    ann = [{"image_id": i, "question": q, "answers": g}
           for i, (q, g) in enumerate(zip(qs, [["stop"] * 10,
                                               ["stop"] * 4 + ["go"] * 6,
                                               ["nike"] * 10]))]
    rows = [{"question_id": i, "prompt": p, "text": t}
            for i, (p, t) in enumerate(zip(PROMPTS, ["STOP", "go", "adidas"]))]
    with open(d / "ann.json", "w") as f:
        json.dump({"data": ann}, f)
    return (m("eval_textvqa").score_textvqa(ann, rows),
            m("eval_textvqa").eval_single(str(d / "ann.json"),
                                          _jsonl(d / "rows.jsonl", rows)))


SQA_TEXTS = ["B", "C. Because of gravity", "The answer is D.",
             "I think maybe", "A", "E"]


def case_sqa_parse(m, d):
    sqa = m("eval_science_qa")
    opts = ["A", "B", "C", "D", "E"]
    parsed = [sqa.parse_answer(t, opts) for t in SQA_TEXTS]
    return parsed, [sqa.get_pred_idx(p, ["x", "y", "z"], opts)
                    for p in parsed]


def case_sqa_evaluate(m, d):
    problems = {str(i): {"choices": ["a", "b", "c", "d"][:2 + i % 3],
                         "answer": i % 2} for i in range(6)}
    with open(d / "problems.json", "w") as f:
        json.dump(problems, f)
    with open(d / "pid_splits.json", "w") as f:
        json.dump({"test": [str(i) for i in range(6)]}, f)
    res = _jsonl(d / "res.jsonl", [
        {"question_id": str(i), "prompt": ("<image>\n" if i % 2 else "")
         + "Q?", "text": t} for i, t in enumerate(SQA_TEXTS[:5])])
    return m("eval_science_qa").evaluate(str(d), res)


def case_convert_gqa(m, d):
    m("converters").convert_gqa_for_eval(_answers(d), str(d / "out.json"))
    return (d / "out.json").read_bytes()


def case_convert_vqav2(m, d):
    split = _jsonl(d / "split.jsonl", [{"question_id": i}
                                       for i in range(len(ANSWERS) + 2)])
    m("converters").convert_vqav2_for_submission(
        _answers(d), str(d / "sub" / "out.json"), split)
    return (d / "sub" / "out.json").read_bytes()


def case_convert_vizwiz(m, d):
    ann = _jsonl(d / "ann.jsonl", [{"question_id": i, "image": f"v{i}.jpg"}
                                   for i in range(len(ANSWERS))])
    m("converters").convert_vizwiz_for_submission(ann, _answers(d),
                                                  str(d / "out.json"))
    return (d / "out.json").read_bytes()


def case_convert_seed(m, d):
    with open(d / "ann.json", "w") as f:
        json.dump({"questions": [
            {"question_id": str(i), "question_type_id": 1 + i % 3,
             "answer": "ABCD"[i % 4]} for i in range(8)]}, f)
    m("converters").convert_seed_for_submission(
        str(d / "ann.json"), _answers(d, ["A", "B", "D", "D", "A"]),
        str(d / "out.json"))
    return (d / "out.json").read_bytes()


def case_convert_mmbench(m, d):
    import pandas as pd

    pd.DataFrame({"index": [3, 5, 9], "question": ["q1", "q2", "q3"],
                  "hint": ["h", None, "h3"], "A": ["a", "b", "c"],
                  "B": ["x", "y", "z"], "answer": ["A", "B", "A"],
                  "category": ["c"] * 3, "image": ["img"] * 3}).to_csv(
        d / "ann.tsv", sep="\t", index=False)
    (d / "res").mkdir()
    _jsonl(d / "res" / "exp.jsonl", [{"question_id": 5, "text": "B"},
                                     {"question_id": 3, "text": "A"}])
    m("converters").convert_mmbench_for_submission(
        str(d / "ann.tsv"), str(d / "res"), str(d / "up"), "exp")
    out = sorted(os.listdir(d / "up"))
    if out == ["exp.tsv"]:
        return out, (d / "up" / "exp.tsv").read_bytes()
    return out, pd.read_excel(d / "up" / out[0]).to_csv().encode()


def case_convert_mmvet(m, d):
    m("converters").convert_mmvet_for_eval(_answers(d), str(d / "out.json"))
    return (d / "out.json").read_bytes()


def case_copy_predictions(m, d):
    ckpt = d / "ckpt"
    for rel in ("eval/mmbench/answers_upload/exp.xlsx",
                "eval/mmbench_cn/answers_upload/exp.tsv",
                "eval/vqav2/answers_upload/test.json",
                "eval/vizwiz/answers_upload/val.json", "eval/gqa/x.json"):
        os.makedirs(ckpt / os.path.dirname(rel), exist_ok=True)
        (ckpt / rel).write_text(rel)
    copied = m("copy_predictions").collect(str(ckpt), str(d / "up"))
    return [(os.path.relpath(s, d), os.path.relpath(t, d),
             open(t).read()) for s, t in copied]


def case_sqa_gpt4(m, d):
    case_sqa_evaluate(m, d)
    with open(d / "gpt4.json", "w") as f:
        json.dump({"outputs": {str(i): f"The answer is {'ABCAB'[i % 5]}."
                               if i != 2 else "no idea"
                               for i in range(6)}}, f)
    ours = _jsonl(d / "ours.jsonl", [
        {"question_id": str(i), "text": f"The answer is {'BACBD'[i % 5]}."
         if i != 1 else "unsure"} for i in range(6)])
    requery = _jsonl(d / "requery.jsonl", [
        {"question_id": "1", "text": "The answer is B."}])
    return m("eval_science_qa_gpt4").evaluate(str(d), str(d / "gpt4.json"),
                                              ours, requery_result=requery)


def case_gpt_review(m, d):
    qs = _jsonl(d / "q.jsonl", [
        {"question_id": i, "text": f"Question {i}?", "image": f"i{i}.jpg",
         "category": ["conv", "detail", "complex"][i % 3]}
        for i in range(5)])
    a1 = _jsonl(d / "a1.jsonl", [{"question_id": i, "answer_id": f"x{i}",
                                  "text": f"Answer one {i}."}
                                 for i in range(5)])
    a2 = _jsonl(d / "a2.jsonl", [{"question_id": i, "answer_id": f"y{i}",
                                  "text": f"Answer two {i * i}."}
                                 for i in range(5)])
    with open(d / "rule.json", "w") as f:
        json.dump({k: {"role": "Assistant", "prompt": f"Rate {k}."}
                   for k in ("conv", "detail", "complex", "default")}, f)
    ctx = _jsonl(d / "ctx.jsonl", [{"image": f"i{i}.jpg",
                                    "captions": [f"cap {i}"]}
                                   for i in range(5)])
    gr = m("gpt_review")
    out = str(d / "review.jsonl")
    first = gr.review_answers(qs, [a1, a2], str(d / "rule.json"), out,
                              context_file=ctx, chat_fn=_fake_chat, limit=3)
    resumed = gr.review_answers(qs, [a1, a2], str(d / "rule.json"), out,
                                context_file=ctx, chat_fn=_fake_chat)
    summary = {os.path.basename(k): v for k, v in
               gr.summarize_gpt_review([out]).items()}
    return first, resumed, summary, [gr.parse_score(s) for s in
                                     ("7 8\nok", "7,8", "bad", "")]


def case_mmvet(m, d):
    with open(d / "results.json", "w") as f:
        json.dump({f"v1_{i}": f"pred {i}" for i in range(4)}, f)
    with open(d / "meta.json", "w") as f:
        json.dump({f"v1_{i}": {"question": f"q{i}", "answer": f"a{i}",
                               "capability": [["ocr"], ["rec", "ocr"],
                                              ["math"], ["rec"]][i]}
                   for i in range(4)}, f)
    ev = m("eval_mmvet")
    summary = ev.grade_mmvet(str(d / "results.json"), str(d / "meta.json"),
                             str(d / "grades.json"), chat_fn=_fake_chat)
    return (summary, (d / "grades.json").read_bytes(),
            [ev.parse_grade(t) for t in ("0.7", "score 1.0", "2", "x")])


def case_qa_baseline(m, d):
    qs = _jsonl(d / "q.jsonl", [{"question_id": i, "text": f"Why {i}?"}
                                for i in range(3)])
    out = d / "out.jsonl"
    m("qa_baseline_gpt35").run(qs, str(out), chat_fn=_fake_chat, limit=2)
    m("qa_baseline_gpt35").run(qs, str(out), chat_fn=_fake_chat)
    rows = [json.loads(line) for line in open(out)]
    assert all(len(r.pop("answer_id")) == 8 for r in rows)
    return rows


def case_webpage_report(m, d):
    wr = m("webpage_report")
    qs = {i: {"question_id": i, "text": f"Q{i} <b>?", "category": "conv"}
          for i in range(3)}
    answers = {"m1": {i: {"text": f"A{i} & more"} for i in range(3)},
               "m2": {i: {"text": f"B{i}"} for i in range(2)}}
    reviews = {"gpt": {i: {"content": f"{i} {i + 1}\nreview {i}"}
                       for i in range(3)},
               "old": {0: {"text": "no score line", "tuple": [1, 2]}}}
    recs = wr.build_records(qs, answers, reviews)
    return recs, wr.render_html(recs, "t"), wr.split_review("8 9\nfine")


MATH_PAIRS = [
    ("\\boxed{\\frac{1}{2}}", "$0.5$"),
    ("\\boxed{2\\sqrt{2}}", "\\boxed{\\sqrt{8}}"),
    ("\\boxed{x^2+2x+1}", "\\boxed{(x+1)^2}"),
    ("\\boxed{[1, 3)}", "\\boxed{[1,3)}"),
    ("\\boxed{3, 5}", "\\boxed{5,3}"),
    ("\\boxed{\\pm 2}", "\\boxed{2, -2}"),
    ("\\boxed{y = 2x + 1}", "\\boxed{2y = 4x + 2}"),
    ("\\boxed{50\\%}", "\\boxed{0.5}"),
    ("\\boxed{7}", "\\boxed{8}"),
    ("\\boxed{\\pi}", "\\boxed{3.14159265358979}"),
]


def case_math_judge(m, d):
    mj = m("math_judge")
    return ([mj.judge(r, p) for r, p in MATH_PAIRS],
            [mj.extract_boxed(r) for r, _ in MATH_PAIRS])


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_scorer_gives_the_jax_result(name, tmp_path):
    out = {}
    for pkg in ("matryoshka_mm_tpu", "matryoshka_mm_torch"):
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = CASES[name](lambda n, _p=pkg: _mod(_p, n), d)
    assert out["matryoshka_mm_torch"] == out["matryoshka_mm_tpu"]


CAPTIONS = [
    ("a dog runs on the grass", ["a dog running across grass",
                                 "the brown dog runs on green grass",
                                 "a dog on a lawn"]),
    ("two people ride bikes", ["two cyclists ride down a road",
                               "people riding bicycles"]),
    ("a red car parked", ["a red car parked on the street",
                          "red car by the curb", "a parked car"]),
    ("", ["an empty caption"]),
]


@pytest.mark.parametrize("metric", ["cider_d", "rouge_l", "corpus_bleu"])
def test_caption_metric_gives_the_jax_result(metric):
    preds = [p for p, _ in CAPTIONS]
    refs = [r for _, r in CAPTIONS]
    got, want = [], []
    for pkg, out in (("matryoshka_mm_tpu", want),
                     ("matryoshka_mm_torch", got)):
        cm = _mod(pkg, "caption_metrics")
        if metric == "cider_d":
            corpus, per = cm.cider_d(preds, refs)
            out.extend([corpus, *per])
        elif metric == "rouge_l":
            out.extend(cm.rouge_l(p, r) for p, r in CAPTIONS)
        else:
            out.extend(cm.corpus_bleu(preds, refs))
    assert len(got) == len(want) and all(map(math.isfinite, got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

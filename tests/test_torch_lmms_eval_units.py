"""PyTorch port: the harness's framework-free pieces against the JAX
package's, case by case on the inputs of ``tests/test_lmms_eval.py`` and
``tests/test_lmms_eval_aggregations.py``: every ``task_utils`` hook, every
metric, every filter and both few-shot samplers give equal results; the
registry lists the same tasks, ``check_integrity`` finds the same
problems, ``ConfigurableTask`` builds the same instances and scores,
``make_table`` prints the same text and ``EvalLogger`` writes the same
files offline.  Everything here is exact."""

import copy
import json
import random
from pathlib import Path

import pytest

from matryoshka_mm_tpu.lmms_eval import evaluator as jev
from matryoshka_mm_tpu.lmms_eval import filters as jf
from matryoshka_mm_tpu.lmms_eval import logging_utils as jlog
from matryoshka_mm_tpu.lmms_eval.api import metrics as jm
from matryoshka_mm_tpu.lmms_eval.api import registry as jreg
from matryoshka_mm_tpu.lmms_eval.api import samplers as jsamp
from matryoshka_mm_tpu.lmms_eval.api import task as jtask
from matryoshka_mm_tpu.lmms_eval.tasks import task_utils as jtu
from matryoshka_mm_torch.lmms_eval import evaluator as tev
from matryoshka_mm_torch.lmms_eval import filters as tf
from matryoshka_mm_torch.lmms_eval import logging_utils as tlog
from matryoshka_mm_torch.lmms_eval.api import metrics as tm
from matryoshka_mm_torch.lmms_eval.api import registry as treg
from matryoshka_mm_torch.lmms_eval.api import samplers as tsamp
from matryoshka_mm_torch.lmms_eval.api import task as ttask
from matryoshka_mm_torch.lmms_eval.tasks import task_utils as ttu


def _shipped_names(reg):
    """The tasks of ``reg``'s package's own task files."""
    import yaml

    tasks = Path(reg.__file__).parent.parent / "tasks"
    return {yaml.safe_load(p.read_text())["task"]
            for p in tasks.glob("*.yaml")}


SHIPPED = {reg: _shipped_names(reg) for reg in (jreg, treg)}


@pytest.fixture(autouse=True)
def shipped_tasks_only():
    """Each test sees only the shipped task corpus in both registries,
    whatever another test file of this process left registered there."""
    saved = []
    for reg in (jreg, treg):
        reg.list_tasks()                        # loads the corpus
        saved.append(dict(reg.TASK_REGISTRY))
        for name in set(reg.TASK_REGISTRY) - SHIPPED[reg]:
            del reg.TASK_REGISTRY[name]
    yield
    for reg, before in zip((jreg, treg), saved):
        reg.TASK_REGISTRY.clear()
        reg.TASK_REGISTRY.update(before)


def _both(jmod, tmod, name, *args, **kw):
    """(JAX result, port result) of ``name`` on deep copies of the same
    arguments."""
    return (getattr(jmod, name)(*copy.deepcopy(args), **copy.deepcopy(kw)),
            getattr(tmod, name)(*copy.deepcopy(args), **copy.deepcopy(kw)))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

METRIC_CASES = [
    ("vqa_accuracy", (["cat"] * 10, "cat")),
    ("vqa_accuracy", (["cat", "dog", "cat"] + ["fish"] * 7, "cat")),
    ("pope_yes_no", ("no", "No, there is not.")),
    ("pope_yes_no", ("yes", "no")),
    ("multiple_choice_letter", ("B", "B. because")),
    ("multiple_choice_letter", ("B", "(A) something")),
    ("multiple_choice_letter", ("C", "the answer is C.")),
    ("multiple_choice_letter", ("B", "Because of gravity")),
    ("bootstrap_stderr", ([0.0, 1.0] * 50,)),
    ("bootstrap_stderr", ([0.25],)),
    ("relaxed_accuracy", ("100", "104")),
    ("relaxed_accuracy", ("100", "106")),
    ("relaxed_accuracy", ("12.5%", "12.3")),
    ("relaxed_accuracy", (["blue"], "Blue")),
    ("relaxed_accuracy", ("0", "0.01")),
    ("relaxed_accuracy", ("1,000 people", "1,000 people")),
    ("contains_match", ("hello world", "it says  Hello   World!")),
    ("contains_match", (["foo", "bar"], "has bar in it")),
    ("contains_match", ("baz", "nothing here")),
    ("multiple_choice_index", ("2", "C")),
    ("multiple_choice_index", (1, "(B) since")),
    ("multiple_choice_index", ("0", "D.")),
    ("multiple_choice_index", ("4", "eight")),
    ("exact_match", ("Red", " red ")),
    ("exact_match", ("red", "Red.", )),
    ("exact_match_any", (["Red Car", "automobile"], " red car ")),
    ("exact_match_any", (["red"], "red car")),
    ("anls", (["hello world"], "hello wrld")),
    ("squad_f1", ("the red cat", "red cat")),
    ("squad_f1", (["a b", "c"], "c")),
    ("bleu4", ("a cat sits on the mat quietly today",
               "a cat sits on the mat quietly today")),
    ("bleu4", ("a cat sits on the mat", "dog")),
    ("rec_iou", ([0.0, 0.0, 0.5, 0.5], "[0.0, 0.0, 0.5, 0.5]")),
    ("rec_iou", ([0.0, 0.0, 0.5, 0.5], "no numbers here")),
    ("rec_acc05", ([0.0, 0.0, 1.0, 1.0], "[0.0, 0.0, 0.6, 1.0]")),
    ("rec_center_acc", ([0.4, 0.4, 0.6, 0.6], "[0.45, 0.45, 0.55, 0.6]")),
]


@pytest.mark.parametrize("name,args", METRIC_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(METRIC_CASES)])
def test_metric_equal(name, args):
    want, got = _both(jm, tm, name, *args)
    assert got == want


def test_metric_tables_equal():
    assert sorted(tm.METRICS) == sorted(jm.METRICS)
    assert sorted(tm.AGGREGATIONS) == sorted(jm.AGGREGATIONS)
    for name in tm.METRICS:
        assert tm.METRICS[name].__name__ == jm.METRICS[name].__name__
    assert tm.AGGREGATIONS["mean"]([1.0, 2.0]) == \
        jm.AGGREGATIONS["mean"]([1.0, 2.0])


# ---------------------------------------------------------------------------
# task_utils: each hook on the aggregation tests' documents
# ---------------------------------------------------------------------------

def _mme(qid, cat, ans):
    return {"question_id": qid, "category": cat, "answer": ans,
            "question": "?"}


OPTS = {"A": "teddy bear", "B": "green pear", "C": "cat", "D": "dog"}


def _mmb(index, answer, cat="object", l2="perception"):
    return {"index": index, "answer": answer, "category": cat,
            "l2-category": l2, "question": "what?", "hint": None, **OPTS}


def _hb(q, f, gt):
    return {"category": "VD", "subcategory": "illusion", "set_id": "1",
            "question_id": str(q), "figure_id": str(f), "gt_answer": gt,
            "question": "?"}


_MV = [{"pid": "1", "question_type": "multi_choice", "answer_type": "text",
        "choices": ["3", "4"], "answer": "4", "query": "q",
        "metadata": {"task": "geometry", "skills": ["algebra", "logic"],
                     "grade": "elem"}},
       {"pid": "2", "question_type": "free_form", "answer_type": "integer",
        "choices": [], "answer": "7", "query": "q", "precision": 0,
        "metadata": {"task": "geometry", "skills": ["logic"],
                     "grade": "high"}},
       {"pid": "3", "question_type": "free_form", "answer_type": "float",
        "choices": [], "answer": "1.2", "query": "q", "precision": 1,
        "metadata": {"task": "statistics", "skills": ["algebra"],
                     "grade": "high"}}]
_MVERSE = [{"question_type": "multi-choice", "answer": "B",
            "problem_version": "Text Dominant",
            "metadata": {"subfield": "Plane Geometry"},
            "question_for_eval": "q1"},
           {"question_type": "free-form", "answer": "12",
            "problem_version": "Vision Only",
            "metadata": {"subfield": "Algebra"}, "question_for_eval": "q2"},
           {"question_type": "free-form", "answer": "3.5",
            "problem_version": "Text Dominant",
            "metadata": {"subfield": "Algebra"}, "question_for_eval": "q3"}]
_OLY = {"source": "OE_MM_maths_en_COMP", "final_answer": [r"\frac{3}{4}"],
        "error": None, "subfield": "Math", "question": "q?",
        "is_multiple_answer": False, "answer_type": "a fraction"}

# (process_results hook, its aggregation, [(doc, model output), ...])
HOOK_CASES = {
    "mme": ("mme_process_results", "mme_aggregate", [
        (_mme("existence/I1", "existence", "Yes"), "Yes."),
        (_mme("existence/I1", "existence", "No"), "Nope"),
        (_mme("existence/I2", "existence", "Yes"), "maybe"),
        (_mme("existence/I2", "existence", "No"), "no"),
        (_mme("count/A", "count", "Yes"), "yes"),
        (_mme("code_reasoning/C1", "code_reasoning", "No"), "no")]),
    "mmbench": ("mmbench_process_results", "mmbench_aggregate", [
        (_mmb(1, "B"), "B."), (_mmb(1_000_001, "C"), "C"),
        (_mmb(2, "A", cat="attribute"), "A"),
        (_mmb(1_000_002, "D", cat="attribute"), "B"),
        (_mmb(3, "B"), "no idea at all")]),
    "seedbench": ("seedbench_process_results", "seedbench_aggregate", [
        ({"answer": "A", "data_type": "image"}, "A"),
        ({"answer": "B", "data_type": "image"}, "C"),
        ({"answer": "C", "data_type": "video"}, "C. something"),
        ({"answer": "D", "data_type": "video"}, "D")]),
    "hallusion": ("hallusion_process_results", "hallusion_aggregate", [
        (_hb(0, 0, "1"), "yes"), (_hb(0, 1, "0"), "no"),
        (_hb(1, 0, "1"), "no"), (_hb(1, 1, "0"), "no"),
        (_hb(9, 9, "1"), "Yes, it is.")]),
    "mmmu": ("mmmu_process_results", "mmmu_aggregate", [
        ({"id": "validation_Art_1", "answer": "A"}, "A"),
        ({"id": "validation_Art_2", "answer": "B"}, "C"),
        ({"id": "validation_Art_Theory_1", "answer": "C"}, "(C)"),
        ({"id": "validation_Math_3", "answer": "D"}, "D.")]),
    "websrc": ("websrc_process_results", "websrc_aggregate", [
        ({"answer": "red car", "domain": "auto"}, "red car"),
        ({"answer": "blue", "domain": "auto"}, "green"),
        ({"answer": "yes", "domain": "movie"}, "yes")]),
    "cmmmu": ("cmmmu_process_results", "cmmmu_aggregate", [
        ({"type": "选择", "answer": "B", "subcategory": "艺术"}, "答案是 (B)。"),
        ({"type": "选择", "answer": "C", "subcategory": "艺术"}, "C"),
        ({"type": "判断", "answer": "对", "subcategory": "数学"}, "这是正确的"),
        ({"type": "判断", "answer": "错", "subcategory": "数学"}, "不对"),
        ({"type": "填空", "answer": "42", "subcategory": "数学"}, "结果等于 42。"),
        ({"type": "填空", "answer": "北京", "subcategory": "历史"}, "上海")]),
    "pope": ("pope_process_results", "pope_aggregate", [
        ({"answer": "yes"}, "Yes"), ({"answer": "yes"}, "no"),
        ({"answer": "no"}, "yes, there is"), ({"answer": "no"}, "No.")]),
    "ocrbench": ("ocrbench_process_results", "ocrbench_aggregate", [
        ({"answer": ["HELLO"], "question_type": "Regular Text Recognition",
          "dataset": "x"}, "hello world"),
        ({"answer": "42", "question_type": "Digit String Recognition",
          "dataset": "x"}, "41"),
        ({"answer": ["a+b"], "question_type":
          "Handwritten Mathematical Expression Recognition",
          "dataset": "HME100k"}, "a + b"),
        ({"answer": ["X=2"], "question_type":
          "Handwritten Mathematical Expression Recognition",
          "dataset": "HME100k"}, "x=2"),
        ({"answer": "paris", "question_type": "Scene Text-centric VQA",
          "dataset": "x"}, "It is Paris.")]),
    "screenspot": ("screenspot_rec_process_results",
                   "screenspot_rec_aggregate", [
                       ({"bbox": [0.0, 0.0, 0.4, 0.4]},
                        "[0.0, 0.0, 0.4, 0.4]"),
                       ({"bbox": [0.0, 0.0, 0.4, 0.4]},
                        "[0.3, 0.0, 0.7, 0.4]")]),
    "refcoco": ("refcoco_rec_process_results", "refcoco_rec_aggregate", [
        ({"bbox": [0.1, 0.1, 0.5, 0.5]}, "(0.1, 0.1, 0.5, 0.5)"),
        ({"bbox": [0.1, 0.1, 0.5, 0.5]}, "(0.3, 0.3, 0.7, 0.7)")]),
    "caption": ("caption_process_results", "caption_aggregate", [
        ({"answer": ["a cat on a mat"]}, "a cat on a mat"),
        ({"reference_strs": ["a big dog runs"]}, "a big dog runs"),
        ({"answer": ["two birds fly", "birds in the sky"]}, "a bird")]),
    "mathvista": ("mathvista_process_results", "mathvista_aggregate",
                  list(zip(_MV, ["The correct answer is (B) 4.",
                                 "The count is 7.", "I think it is 3.4"]))),
    "mathverse": ("mathverse_process_results", "mathverse_aggregate",
                  list(zip(_MVERSE, ["The answer is (B).",
                                     "So the result is 12.",
                                     "I believe it is 4"]))),
    "olympiadbench": ("olympiadbench_process_results",
                      "olympiadbench_aggregate", [
                          (_OLY, r"So the final answer is "
                                 r"\boxed{\frac{3}{4}}."),
                          (_OLY, r"So the final answer is "
                                 r"\boxed{\frac{1}{4}}."),
                          ({**_OLY, "source": "OE_TP_maths_en"},
                           "Proof: ..."),
                          ({**_OLY, "final_answer": ["$1$", "$2$"],
                            "is_multiple_answer": True},
                           r"So the final answer is \boxed{1,2}.")]),
    "chartqa": ("chartqa_process_results", "chartqa_aggregate", [
        ({"answer": "42", "type": "human_test"}, "42"),
        ({"answer": "10", "type": "human_test"}, "10.4"),
        ({"answer": "blue", "type": "aug_test"}, "red")]),
}


@pytest.mark.parametrize("bench", sorted(HOOK_CASES))
def test_task_utils_hooks_equal(bench):
    proc, agg, cases = HOOK_CASES[bench]
    per_doc = []
    for doc, out in cases:
        want, got = _both(jtu, ttu, proc, doc, out)
        assert got == want, (doc, out)
        per_doc.append(got)
    key, = per_doc[0]
    values = [p[key] for p in per_doc if key in p]
    want, got = _both(jtu, ttu, agg, values)
    assert got == want


AGG_ONLY = {
    "mmvet_aggregate": [{"score": 1.0, "capabilities": "ocr,math"},
                        {"score": 0.0, "capabilities": "ocr"},
                        {"score": 0.5, "capabilities": "rec"}],
    "llava_wild_aggregate": [
        {"gpt4": 8.0, "model": 6.0, "category": "conv"},
        {"gpt4": 10.0, "model": 9.0, "category": "detail"},
        {"gpt4": 5.0, "model": -1.0, "category": "conv"}],
}

FUNCTION_CASES = [
    ("infer_option_letter", ("B", OPTS)),
    ("infer_option_letter", ("The answer is B.", OPTS)),
    ("infer_option_letter", ("(C) because cats", OPTS)),
    ("infer_option_letter", ("A creature that barks loudly", OPTS)),
    ("infer_option_letter", ("I think it's a green pear!", OPTS)),
    ("infer_option_letter", ("B or C", OPTS)),
    ("mmbench_preprocess", ([_mmb(1, "A"), _mmb(2, "B")],)),
    ("refcoco_rec_preprocess", ([{"image": "x.jpg", "image_width": 100,
                                  "image_height": 200,
                                  "bbox": [10, 20, 30, 40],
                                  "answer": ["a cat", "the cat"]}],)),
    ("screenspot_rec_preprocess", ([{"image_width": 50, "image_height": 20,
                                     "bbox": [5, 5, 10, 10]}],)),
    ("_mme_parse_pred", ("Nope",)),
    ("_mathvista_extract", ("8/11", "multi_choice", "text",
                            ["3/11", "8/11"])),
    ("_mathvista_extract", ("0.60", "free_form", "float", [])),
    ("_mathvista_extract", ('The answer is "blue".', "free_form", "text",
                            [])),
    ("_mathvista_extract", ("The correct answer is (B) 8/11.",
                            "multi_choice", "text", ["3/11", "8/11"])),
    ("_mathvista_extract", ("Luca needs $1.45 in total.", "free_form",
                            "float", [])),
    ("_mathvista_normalize", ("(b) green", ["red", "green", "blue"],
                              "multi_choice", "text", 0)),
    ("_mathvista_normalize", ("blu", ["red", "green", "blue"],
                              "multi_choice", "text", 0)),
    ("_mathvista_normalize", ("1.456", [], "free_form", "float", 1)),
    ("_mathvista_normalize", ("oops", [], "free_form", "integer", 0)),
    ("_cmmmu_score", ({"type": "判断", "answer": "对"}, "没错")),
    ("_cmmmu_score", ({"type": "判断", "answer": "错"}, "错误")),
    ("olympiadbench_doc_to_text", (_OLY,)),
] + [(name, (values,)) for name, values in AGG_ONLY.items()]


@pytest.mark.parametrize("name,args", FUNCTION_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FUNCTION_CASES)])
def test_task_utils_function_equal(name, args):
    want, got = _both(jtu, ttu, name, *args)
    assert got == want


def test_task_utils_defines_the_same_functions():
    names = sorted(n for n in dir(jtu) if callable(getattr(jtu, n))
                   and getattr(getattr(jtu, n), "__module__", "") ==
                   jtu.__name__)
    assert names and names == sorted(
        n for n in dir(ttu) if callable(getattr(ttu, n))
        and getattr(getattr(ttu, n), "__module__", "") == ttu.__name__)


# ---------------------------------------------------------------------------
# filters and samplers
# ---------------------------------------------------------------------------

_CHOICES = {"choices": ["red apple", "green pear", "yellow banana"]}
FILTER_CASES = [
    ("take_first", {}, [["a", "b"], ["c"]], [{}, {}]),
    ("take_first_k", {"k": 2}, [["a", "b", "c"]], [{}]),
    ("majority_vote", {}, [["x", "y", "x"]], [{}]),
    ("remove_whitespace", {}, [[" hi", "hi"]], [{}]),
    ("lowercase", {}, [["Hi THERE"]], [{}]),
    ("uppercase", {}, [["Hi there"]], [{}]),
    ("map", {"mapping_dict": {"yes": 1}, "default_value": 0},
     [["yes", "nah"]], [{}]),
    ("regex", {}, [["blah #### 42"], ["no answer"]], [{}, {}]),
    ("multi_choice_regex", {"regex_pattern": r"(\([A-Z]\))",
                            "ignore_case": True,
                            "ignore_punctuation": True},
     [["The answer is (B)."], ["I think it's a green pear!"],
      ["Answer: C"], ["dunno"], ["pick (A) ok"]],
     [_CHOICES] * 4 + [{}]),
]


@pytest.mark.parametrize("name,kw,resps,docs", FILTER_CASES,
                         ids=[c[0] for c in FILTER_CASES])
def test_filter_equal(name, kw, resps, docs):
    assert sorted(tf.FILTER_REGISTRY) == sorted(jf.FILTER_REGISTRY)
    want = jf.get_filter(name)(**kw).apply(copy.deepcopy(resps), docs)
    got = tf.get_filter(name)(**kw).apply(copy.deepcopy(resps), docs)
    assert got == want


def _mc_task(mods, path):
    return mods.ConfigurableTask({
        "task": "toy_mc", "dataset_path": str(path),
        "doc_to_text": "{question}", "doc_to_target": "answer",
        "doc_to_choice": "choices",
        "filter_list": [
            {"name": "flexible-extract",
             "filter": [{"function": "multi_choice_regex",
                         "regex_pattern": r"(\([A-Z]\))",
                         "ignore_case": True}]},
            {"name": "strict", "filter": [{"function": "take_first"}]}],
        "metric_list": [{"metric": "multiple_choice_letter"}]})


def test_filter_ensembles_and_scores_equal(tmp_path):
    docs = [{"question": "Which?", "answer": "B",
             "choices": ["cat", "dog", "bird"]},
            {"question": "Which one?", "answer": "C",
             "choices": ["cat", "dog", "bird"]}]
    (tmp_path / "d.json").write_text(json.dumps(docs))
    outs = []
    for mods in (jtask, ttask):
        task = _mc_task(mods, tmp_path / "d.json")
        insts = task.build_instances()
        insts[0].resps = ["I believe the answer is a dog here."]
        insts[1].resps = ["(A)"]
        names = task.apply_filters(insts)
        per = {n: [task.process_results(i.doc, i.filtered_resps[n][0])
                   for i in insts] for n in names}
        outs.append((names, [i.filtered_resps for i in insts], per,
                     {n: task.aggregate(p) for n, p in per.items()},
                     [i.arguments for i in insts]))
    assert outs[1] == outs[0]


def test_samplers_equal(tmp_path):
    docs = [{"q": f"q{i}", "a": f"a{i}"} for i in range(6)]
    ctx = []
    for samp, mods in ((jsamp, jtask), (tsamp, ttask)):
        task = mods.ConfigurableTask({
            "task": "fs", "dataset_path": "unused", "doc_to_text": "{q}",
            "doc_to_target": "a", "test_split": "test",
            "fewshot_split": "train",
            "metric_list": [{"metric": "exact_match"}]})
        first = samp.FirstNSampler(docs, task, random.Random(0))
        got = [first.get_context(docs[5], 2)]
        task.config["fewshot_split"] = "test"
        rnd = samp.ContextSampler(docs, task, random.Random(0))
        got += [rnd.get_context(docs[i], 3) for i in range(3)]
        task.config["fewshot_split"] = None
        got.append(samp.ContextSampler(docs, task, random.Random(1))
                   .get_context(docs[2], 2))
        got.append(sorted(samp.SAMPLER_REGISTRY))
        ctx.append(got)
    assert ctx[1] == ctx[0]
    with pytest.raises(ValueError):
        tsamp.FirstNSampler(docs, task,
                            random.Random(0)).sample(7)

    data = {"test": [{"q": "Q", "a": "A"}],
            "train": [{"q": f"t{i}", "a": f"x{i}"} for i in range(3)]}
    (tmp_path / "d.json").write_text(json.dumps(data))
    args = []
    for mods in (jtask, ttask):
        task = mods.ConfigurableTask({
            "task": "fs2", "dataset_path": str(tmp_path / "d.json"),
            "test_split": "test", "fewshot_split": "train",
            "num_fewshot": 2, "fewshot_config": {"sampler": "first_n"},
            "doc_to_text": "{q}", "doc_to_target": "a",
            "metric_list": [{"metric": "exact_match"}]})
        args.append([i.arguments for i in task.build_instances()])
    assert args[1] == args[0] == [("t0 x0\n\nt1 x1\n\nQ",
                                   {"max_new_tokens": 16,
                                    "temperature": 0.0}, None)]


# ---------------------------------------------------------------------------
# registry, integrity, tables, logger
# ---------------------------------------------------------------------------

def test_registry_lists_the_same_tasks():
    assert treg.list_tasks() == jreg.list_tasks()
    assert len(treg.list_tasks()) == 46
    assert SHIPPED[treg] == SHIPPED[jreg]
    for name in treg.list_tasks():
        assert treg.get_task(name) == jreg.get_task(name), name
    with pytest.raises(KeyError):
        treg.get_model("no_such_model")


@pytest.mark.parametrize("broken", [
    {"metric_list": [{"metric": "nope"}]},
    {"process_results": "task_utils.does_not_exist",
     "metric_list": [{"metric": "whatever",
                      "aggregation": "task_utils.also_missing"}]},
    {"metric_list": [{"metric": "exact_match", "aggregation": "median"}],
     "generation_kwargs": {"max_new_tokens": "8"}},
], ids=["metric", "hooks", "aggregation"])
def test_check_integrity_equal(broken):
    cfg = {"task": "broken_task_19", "dataset_path": "x",
           "doc_to_text": "{q}", "doc_to_target": "a", **broken}
    found = []
    for reg, ev in ((jreg, jev), (treg, tev)):
        reg.register_task(cfg["task"], cfg)
        try:
            found.append(ev.check_integrity([cfg["task"], "no_such_task"]))
        finally:
            reg.TASK_REGISTRY.pop(cfg["task"])
    # a hook's message names its package
    assert [m.replace("matryoshka_mm_torch", "matryoshka_mm_tpu")
            for m in found[1]] == found[0] and found[1]
    assert tev.check_integrity() == jev.check_integrity() == []


_RESULTS = {"results": {
    "toy": {"exact_match": 0.5, "exact_match_stderr": 0.1,
            "acc,flex": 0.75, "acc_stderr,flex": 0.05, "samples": 4,
            "time_s": 1.0},
    "mme": {"mme_perception_score/existence": 125.0,
            "mme_perception_score/total": 125.0, "samples": 4,
            "time_s": 2.0}}}


def test_make_table_equal():
    assert tev.make_table(_RESULTS) == jev.make_table(_RESULTS)
    assert "toy" in tev.make_table(_RESULTS)


def test_eval_logger_writes_the_same_files(tmp_path, monkeypatch):
    samples = {"toy": [{"doc_id": 0, "resps": ["a"], "scores": {"x": 1}}]}
    trees = []
    for log, name in ((jlog, "jax"), (tlog, "torch")):
        monkeypatch.setattr(log.wandb_shim.time, "time", lambda: 5.0)
        out = tmp_path / name
        logger = log.EvalLogger(project="t", name="r", output_dir=str(out),
                                config={"tasks": "toy"})
        logger.post_init(_RESULTS)
        rows = logger.log_eval_result()
        logger.log_eval_samples(samples)
        logger.finish()
        trees.append((rows, {p.name: p.read_text()
                             for p in sorted(out.iterdir())}))
    assert trees[1] == trees[0]
    assert set(trees[1][1]) == {"results.jsonl", "results.tsv",
                                "samples_toy.jsonl", "t_r.jsonl"}


@pytest.mark.parametrize("flag", ["--list_tasks", "--check_integrity"])
def test_cli_lists_and_checks_as_jax(flag, monkeypatch, capsys):
    from matryoshka_mm_torch.lmms_eval import __main__ as tmain
    from matryoshka_mm_tpu.lmms_eval import __main__ as jmain

    outs = []
    for mod in (jmain, tmain):
        monkeypatch.setattr("sys.argv", ["lmms_eval", flag])
        if flag == "--check_integrity":
            with pytest.raises(SystemExit) as e:
                mod.main()
            assert e.value.code == 0
        else:
            mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and outs[1].strip()


def test_cli_runs_a_local_task_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--device cpu`` reaches the adapter through ``model_args``; the
    results file, the table and the offline logger's files are written."""
    from PIL import Image

    from matryoshka_mm_torch.lmms_eval import __main__ as tmain

    Image.new("RGB", (64, 48), (200, 0, 0)).save(tmp_path / "r.png")
    (tmp_path / "docs.json").write_text(json.dumps(
        [{"question": "What color?", "answer": "red", "image": "r.png"}]))
    monkeypatch.setitem(treg.TASK_REGISTRY, "toy_cli_19", {
        "task": "toy_cli_19", "dataset_path": str(tmp_path / "docs.json"),
        "doc_to_visual": "image", "doc_to_text": "{question}",
        "doc_to_target": "answer",
        "dataset_kwargs": {"image_folder": str(tmp_path)},
        "generation_kwargs": {"max_new_tokens": 3, "temperature": 0.0},
        "metric_list": [{"metric": "exact_match"}]})
    out = tmp_path / "out" / "results.json"
    monkeypatch.setattr("sys.argv", [
        "lmms_eval", "--model_args", "pretrained=debug://tiny",
        "--device", "cpu", "--tasks", "toy_cli_19", "--log_samples",
        "--matryoshka_vis_token_scale", "ver=v0_numtoks=4",
        "--output_path", str(out), "--wandb_args",
        f"project=p,name=n,dir={tmp_path / 'logs'}"])
    tmain.main()
    printed = capsys.readouterr().out
    res = json.loads(out.read_text())
    assert res["results"]["toy_cli_19"]["samples"] == 1
    assert "toy_cli_19" in printed and f"wrote {out}" in printed
    assert {p.name for p in (tmp_path / "logs").iterdir()} == {
        "results.jsonl", "results.tsv", "samples_toy_cli_19.jsonl",
        "p_n.jsonl"}

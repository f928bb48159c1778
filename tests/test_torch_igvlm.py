"""PyTorch port: the IG-VLM video pipeline against the JAX package's.

* ``video_to_grid_image`` on a cv2-written mp4 gives the same pixels;
* the scorers (``extract_answer``, ``eval_multiple_choice``,
  ``parse_judge_response``, the judge messages of every dimension,
  ``eval_gpt3`` with its resume, ``eval_gpt3_consistency``,
  ``summarize_judge``) give equal results with one fake judge;
* ``eval_llava_openended`` and ``eval_llava_multiplechoice`` end to end
  over the tiny LLaVA directory of ``tests/test_torch_eval_generators.py``
  (float32 on both sides, CRC-32 word ids, answers capped at ``CAP``
  tokens where the entries ask for 128) give the same ``pred`` column and
  summary, a missing video included;
* the two gpt4v entries give the same results with one fake ``post_fn``.

Everything here is exact.
"""

import os

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
cv2 = pytest.importorskip("cv2")

from matryoshka_mm_tpu.igvlm import evaluation as jeval  # noqa: E402
from matryoshka_mm_tpu.igvlm import grid as jgrid  # noqa: E402
from matryoshka_mm_tpu.igvlm import pipeline as jpipe  # noqa: E402
from matryoshka_mm_tpu.models import builder as jax_builder  # noqa: E402
from matryoshka_mm_torch.igvlm import evaluation as teval  # noqa: E402
from matryoshka_mm_torch.igvlm import grid as tgrid  # noqa: E402
from matryoshka_mm_torch.igvlm import pipeline as tpipe  # noqa: E402
from matryoshka_mm_torch.models import builder  # noqa: E402
from tests.test_torch_eval_generators import (_f32_jax, _f32_torch,  # noqa: E402,F401
                                             model_dir)
from tests.test_torch_families_loader import _crc_words  # noqa: E402

CAP = 8
SCALE = "ver=v0_numtoks=16"


def _video(path, n, size, seed):
    rng = np.random.default_rng(seed)
    w, h = size
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                          (w, h))
    for _ in range(n):
        small = rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8)
        out.write(cv2.resize(small, (w, h)))
    out.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    _video(root / "v0.mp4", 12, (64, 48), 0)
    _video(root / "v1.mp4", 9, (80, 60), 1)
    return root


@pytest.mark.parametrize("name,frames", [("v0.mp4", 6), ("v1.mp4", 4),
                                         ("v1.mp4", 9)])
def test_video_to_grid_image_equal(videos, name, frames):
    want = jgrid.video_to_grid_image(str(videos / name), frames)
    got = tgrid.video_to_grid_image(str(videos / name), frames)
    assert got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _judge(calls, reply="{'pred': 'yes', 'score': 4}"):
    def judge(messages):
        calls.append(messages)
        n = len(calls)
        return reply if n % 3 else "Sure! pred: no, score: 2."
    return judge


@pytest.mark.parametrize("name,args", [
    ("extract_answer", ("(C) the dog",)), ("extract_answer", ("B. running",)),
    ("extract_answer", ("A",)), ("extract_answer", ("maybe",)),
    ("parse_judge_response", ("{'pred': 'yes', 'score': 4}",)),
    ("parse_judge_response", ("{''score': 3}.",)),
    ("parse_judge_response", ("Sure! pred: yes, score: 5",)),
    ("parse_judge_response", ("nothing useful",)),
    ("make_consistency_messages", ("q1", "q2", "a", "p1", "p2")),
] + [("make_messages", ("q", "a", "p", et)) for et in jeval.EvaluationType])
def test_scorer_functions_equal(name, args):
    targs = tuple(getattr(teval.EvaluationType, a.name)
                  if isinstance(a, jeval.EvaluationType) else a for a in args)
    assert getattr(teval, name)(*targs) == getattr(jeval, name)(*args)


def test_judged_scoring_equal(tmp_path, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    df = pd.DataFrame([{"question_id": i, "question": f"q{i}",
                        "answer": "a cat", "pred": f"a small cat {i}"}
                       for i in range(4)])
    df2 = df.assign(question=[f"again q{i}" for i in range(4)])
    mc = pd.DataFrame([{"pred": "(A) cat", "answer": "A"},
                       {"pred": "B. dog", "answer": "0"},
                       {"pred": "C", "answer": "C"}])
    outs = []
    for mod, tag in ((jeval, "jax"), (teval, "torch")):
        calls = []
        judge = _judge(calls)
        got = [mod.eval_multiple_choice(mc)]
        d = str(tmp_path / tag / "judge")
        df1, path1 = mod.eval_gpt3(df, d, judge=judge)
        got += [df1.to_dict("records"), mod.summarize_judge(df1), len(calls)]
        # an existing result.csv short-circuits; a lost response re-queries
        got.append(mod.eval_gpt3(df, d, judge=judge)[0].to_dict("records"))
        os.remove(path1)
        os.remove(os.path.join(d, "2.txt"))
        df3, _ = mod.eval_gpt3(df, d, judge=judge)
        got += [df3.to_dict("records"), len(calls)]
        et = mod.EvaluationType.TEMPORAL
        dft, _ = mod.eval_gpt3(df, str(tmp_path / tag / "tu"), judge=judge,
                               gpt_eval_type=et)
        dfc, _ = mod.eval_gpt3_consistency(df, df2, str(tmp_path / tag / "co"),
                                           judge=_judge(calls,
                                                        "{'score': 5}"))
        got += [dft.to_dict("records"), mod.summarize_judge(dft),
                dfc.to_dict("records"), calls]
        with pytest.raises(RuntimeError, match="OPENAI_API_KEY"):
            mod.openai_judge()
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[1][3] == 4 and outs[1][6] == 5


@pytest.fixture
def both(monkeypatch):
    """Both pipelines load float32 weights, number words by CRC-32 and cap
    an answer at ``CAP`` tokens."""
    for cls in (builder.DebugTokenizer, jax_builder.DebugTokenizer):
        monkeypatch.setattr(cls, "__call__", _crc_words)
    for cls in (builder.LlavaModel, jax_builder.LlavaModel):
        real = cls.generate

        def capped(self, *a, _real=real, **kw):
            kw["max_new_tokens"] = min(kw.get("max_new_tokens", 128), CAP)
            return _real(self, *a, **kw)

        monkeypatch.setattr(cls, "generate", capped)
    for mod, f32 in ((jpipe, _f32_jax), (tpipe, _f32_torch)):
        real = mod.load_pretrained_model

        def load(*a, _real=real, _f32=f32, **kw):
            tok, model, proc, ctx = _real(*a, **kw)
            return tok, _f32(model), proc, ctx

        monkeypatch.setattr(mod, "load_pretrained_model", load)


def _qa(path, mc):
    rows = [{"question_id": 0, "video_name": "v0.mp4",
             "question": "what happens", "answer": "A" if mc else "flicker"},
            {"question_id": 1, "video_name": "v1.mp4",
             "question": "what moves", "answer": "B" if mc else "a box"},
            {"question_id": 2, "video_name": "missing.mp4",
             "question": "what is lost", "answer": "A" if mc else "x"}]
    if mc:
        for r in rows:
            r["options"] = "A. flicker\nB. nothing"
    pd.DataFrame(rows).to_csv(path, index=False)
    return str(path)


def test_llava_entries_equal(both, model_dir, videos, tmp_path,  # noqa: F811
                             monkeypatch, capsys):
    from matryoshka_mm_torch.igvlm import eval_llava_multiplechoice as tmc
    from matryoshka_mm_torch.igvlm import eval_llava_openended as toe
    from matryoshka_mm_tpu.igvlm import eval_llava_multiplechoice as jmc
    from matryoshka_mm_tpu.igvlm import eval_llava_openended as joe

    common = ["--path_video", str(videos), "--model-path", model_dir,
              "--matryoshka_vis_token_scale", SCALE]
    mc_csv, oe_csv = _qa(tmp_path / "mc.csv", True), _qa(tmp_path / "oe.csv",
                                                         False)
    # the JAX multiple-choice entry has only main(): drive it by argv
    monkeypatch.setattr("sys.argv", ["x", "--path_qa_pair_csv", mc_csv,
                                     "--path_result",
                                     str(tmp_path / "jmc.csv")] + common)
    jmc.main()
    want_mc = pd.read_csv(tmp_path / "jmc.csv")
    df, acc = tmc.run(tmc.build_parser().parse_args(
        ["--path_qa_pair_csv", mc_csv, "--path_result",
         str(tmp_path / "tmc.csv"), "--device", "cpu"] + common))
    got_mc = pd.read_csv(tmp_path / "tmc.csv")
    pd.testing.assert_frame_equal(got_mc, want_mc)
    assert got_mc["pred"].iloc[2].startswith("ERROR: cannot open video")
    assert acc == jeval.eval_multiple_choice(want_mc)
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("Accuracy")]
    assert len(lines) == 3 and lines[1] == lines[0]

    outs = []
    for mod, tag, extra in ((joe, "joe", []), (toe, "toe",
                                               ["--device", "cpu"])):
        calls = []
        args = mod.build_parser().parse_args(
            ["--path_qa_pair_csv", oe_csv, "--path_result",
             str(tmp_path / tag)] + common + extra)
        df, summary = mod.run(args, judge=_judge(calls))
        outs.append((df.to_dict("records"), summary, calls,
                     pd.read_csv(tmp_path / tag / "preds.csv")
                     .to_dict("records")))
    assert outs[1] == outs[0]
    assert all(isinstance(p, str) and p for p in
               pd.DataFrame(outs[1][3])["pred"])


def test_gpt4v_entries_equal(videos, tmp_path, monkeypatch):
    from matryoshka_mm_torch.igvlm import eval_gpt4v_multiplechoice as tmc
    from matryoshka_mm_torch.igvlm import eval_gpt4v_openended as toe
    from matryoshka_mm_torch.igvlm import \
        eval_gpt4v_textgeneration_openended as ttg
    from matryoshka_mm_tpu.igvlm import eval_gpt4v_multiplechoice as jmc
    from matryoshka_mm_tpu.igvlm import eval_gpt4v_openended as joe
    from matryoshka_mm_tpu.igvlm import \
        eval_gpt4v_textgeneration_openended as jtg

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    mc_csv, oe_csv = _qa(tmp_path / "mc.csv", True), _qa(tmp_path / "oe.csv",
                                                         False)
    outs = []
    for mc, oe, tg, tag in ((jmc, joe, jtg, "j"), (tmc, toe, ttg, "t")):
        posts, judged = [], []

        def post(payload, posts=posts):
            posts.append(payload)
            return {"choices": [{"message": {"content": " A. flicker "}}]}

        common = ["--path_video", str(videos), "--model_version", "test-v"]
        acc = mc.run(mc.build_parser().parse_args(
            ["--path_qa_pair_csv", mc_csv, "--path_result",
             str(tmp_path / f"{tag}mc.csv")] + common), post_fn=post)
        df, summary = oe.run(oe.build_parser().parse_args(
            ["--path_qa_pair_csv", oe_csv, "--path_result",
             str(tmp_path / f"{tag}oe")] + common),
            judge=_judge(judged), post_fn=post)
        parser = tg.build_parser()
        parser.add_argument("--eval_type", default="correctness")
        parser.add_argument("--path_qa_pair_csv2", default=oe_csv)
        dtg, stg = tg.run(parser.parse_args(
            ["--path_qa_pair_csv", oe_csv, "--path_result",
             str(tmp_path / f"{tag}tg"), "--eval_type", "consistency"]
            + common), judge=_judge(judged, "{'score': 3}"), post_fn=post)
        # no post_fn and no key: every row records the ConfigError
        nokey, _ = (jpipe if tag == "j" else tpipe).Gpt4vPipeline(
            mc_csv, str(videos), str(tmp_path / f"{tag}nokey.csv")) \
            .do_pipeline()
        outs.append((acc, df.to_dict("records"), summary,
                     dtg.to_dict("records"), stg, posts, judged,
                     list(nokey["pred"])))
    assert outs[1] == outs[0]
    assert outs[1][0]["correct"] == 1 and outs[1][0]["total"] == 3
    assert outs[1][7][0].startswith("ERROR: OPENAI_API_KEY not set")
    assert outs[1][7][2].startswith("ERROR: cannot open video")

"""Self-contained HTML report for GPT-review comparisons.

Covers the reference's eval webpage surface (reference:
llava/eval/generate_webpage_data_from_table.py:1-111 plus the static
llava/eval/webpage/ assets) with one generator: instead of emitting a
``data.json`` consumed by a separate checked-in index.html/script.js, it
renders a single standalone HTML file (inline styles, no JS dependencies)
from the same three jsonl inputs — questions, per-model answers, and
pairwise GPT reviews (gpt_review.py output).  The review's leading
"score1 score2" line is stripped from the displayed text and surfaced as
a score badge, mirroring the reference's cleanup regex
(generate_webpage_data_from_table.py:82-86).

Usage:
    python -m matryoshka_mm_torch.eval.webpage_report \
        --questions table/question.jsonl \
        --answers baseline=table/answer/answer_vicuna.jsonl \
        --answers ours=results/ours.jsonl \
        --reviews baseline_vs_ours=table/review/review.jsonl \
        --output webpage/report.html [--data-json webpage/data.json]
"""

from __future__ import annotations

import argparse
import html
import json
import os
import re
from typing import Dict, List, Optional

_SCORE_LINE = re.compile(r"^\s*(\d+(?:\.\d+)?)[,\s]+(\d+(?:\.\d+)?)\s*$")

_PAGE_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 60rem;
       color: #1a1a1a; }
h1 { font-size: 1.4rem; } h2 { font-size: 1.05rem; margin-bottom: .2rem; }
.q { border: 1px solid #ddd; border-radius: 8px; padding: 1rem;
     margin-bottom: 1.2rem; }
.cat { color: #666; font-size: .8rem; text-transform: uppercase; }
.ans { background: #f7f7f8; border-radius: 6px; padding: .6rem .8rem;
       margin: .4rem 0; white-space: pre-wrap; }
.model { font-weight: 600; font-size: .85rem; color: #444; }
.review { border-left: 3px solid #8884; padding: .4rem .8rem; margin-top: .6rem;
          white-space: pre-wrap; color: #333; }
.score { display: inline-block; background: #eef; border-radius: 4px;
         padding: .05rem .5rem; font-size: .85rem; margin-left: .5rem; }
"""


def read_jsonl(path: str, key: Optional[str] = None):
    """Load a jsonl file; with ``key``, return an id->record dict."""
    rows = []
    with open(os.path.expanduser(path)) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if key is None:
        return rows
    return {r[key]: r for r in rows}


def split_review(text: str):
    """-> (scores or None, cleaned review text).  GPT reviews open with a
    'score1 score2' line (gpt_review.py output contract)."""
    lines = text.strip().split("\n")
    m = _SCORE_LINE.match(lines[0]) if lines else None
    if m:
        return [float(m.group(1)), float(m.group(2))], "\n".join(lines[1:]).strip()
    return None, text.strip()


def build_records(questions: Dict, answers: Dict[str, Dict],
                  reviews: Dict[str, Dict]) -> List[dict]:
    """Join questions/answers/reviews on question_id into report records."""
    records = []
    for qid, q in sorted(questions.items(), key=lambda kv: str(kv[0])):
        rec = {
            "id": qid,
            "category": q.get("category", ""),
            "question": q.get("text", ""),
            "answers": {m: a[qid]["text"] for m, a in answers.items()
                        if qid in a},
            "reviews": {},
            "scores": {},
        }
        for name, rv in reviews.items():
            if qid not in rv:
                continue
            raw = rv[qid].get("content", rv[qid].get("text", ""))
            scores, cleaned = split_review(raw)
            if scores is None:
                scores = rv[qid].get("tuple", rv[qid].get("score"))
            rec["reviews"][name] = cleaned
            rec["scores"][name] = scores
        records.append(rec)
    return records


def render_html(records: List[dict], title: str = "GPT review report") -> str:
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        f"<style>{_PAGE_STYLE}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
    ]
    for r in records:
        parts.append("<div class='q'>")
        parts.append(f"<div class='cat'>#{html.escape(str(r['id']))}"
                     f" · {html.escape(str(r['category']))}</div>")
        parts.append(f"<h2>{html.escape(r['question'])}</h2>")
        for model, ans in r["answers"].items():
            parts.append(f"<div class='ans'><span class='model'>"
                         f"{html.escape(model)}</span><br>"
                         f"{html.escape(ans)}</div>")
        for name, rv in r["reviews"].items():
            score = r["scores"].get(name)
            badge = (f"<span class='score'>{score[0]:g} / {score[1]:g}</span>"
                     if isinstance(score, (list, tuple)) and len(score) == 2
                     else "")
            parts.append(f"<div class='review'><span class='model'>"
                         f"{html.escape(name)}</span>{badge}<br>"
                         f"{html.escape(rv)}</div>")
        parts.append("</div>")
    parts.append("</body></html>")
    return "\n".join(parts)


def _parse_named(pairs: List[str]) -> Dict[str, str]:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"expected name=path, got {p!r}")
        name, path = p.split("=", 1)
        out[name] = path
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--questions", required=True)
    ap.add_argument("--answers", action="append", default=[],
                    metavar="NAME=PATH", help="per-model answer jsonl")
    ap.add_argument("--reviews", action="append", default=[],
                    metavar="NAME=PATH", help="pairwise review jsonl")
    ap.add_argument("--output", required=True, help="output .html path")
    ap.add_argument("--data-json", default=None,
                    help="also dump the joined records as JSON")
    ap.add_argument("--title", default="GPT review report")
    args = ap.parse_args()

    questions = read_jsonl(args.questions, key="question_id")
    answers = {n: read_jsonl(p, key="question_id")
               for n, p in _parse_named(args.answers).items()}
    reviews = {n: read_jsonl(p, key="question_id")
               for n, p in _parse_named(args.reviews).items()}
    records = build_records(questions, answers, reviews)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        f.write(render_html(records, args.title))
    if args.data_json:
        with open(args.data_json, "w") as f:
            json.dump({"questions": records,
                       "models": sorted(answers)}, f, indent=2)
    print(f"wrote {args.output} ({len(records)} questions)")


if __name__ == "__main__":
    main()

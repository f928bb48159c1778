"""GPT-judged pairwise review (reference: llava/eval/eval_gpt_review.py,
eval_gpt_review_bench.py, eval_gpt_review_visual.py — 374 LoC across 3
variants, unified here with a pluggable judge).

The judge is any OpenAI-compatible chat function; by default it posts to
``$OPENAI_BASE_URL`` with ``$OPENAI_API_KEY``; tests inject a fake
judge and make no network call.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional

NUM_SECONDS_TO_SLEEP = 0.5


def openai_chat_fn(model: str = "gpt-4-0314", max_tokens: int = 1024,
                   temperature: float = 0.2) -> Callable[[str, str], str]:
    """Judge backed by an OpenAI-compatible endpoint (deployment path)."""
    api_key = os.environ.get("OPENAI_API_KEY")
    base = os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1")
    if not api_key:
        raise RuntimeError("OPENAI_API_KEY not set; GPT review requires an "
                           "OpenAI-compatible endpoint")
    import requests

    def chat(system: str, user: str) -> str:
        for attempt in range(5):
            try:
                r = requests.post(
                    f"{base}/chat/completions",
                    headers={"Authorization": f"Bearer {api_key}"},
                    json={"model": model, "temperature": temperature,
                          "max_tokens": max_tokens,
                          "messages": [
                              {"role": "system", "content": system},
                              {"role": "user", "content": user}]},
                    timeout=120)
                r.raise_for_status()
                return r.json()["choices"][0]["message"]["content"]
            except Exception as e:
                print(e)
                time.sleep(NUM_SECONDS_TO_SLEEP * (attempt + 1))
        raise RuntimeError("judge failed after retries")

    return chat


def parse_score(review: str) -> List[float]:
    """First line '7 8' -> [7.0, 8.0]; -1 -1 on failure
    (reference: eval_gpt_review*.py parse_score)."""
    try:
        score_pair = review.split("\n")[0].replace(",", " ")
        sp = score_pair.split()
        if len(sp) == 2:
            return [float(sp[0]), float(sp[1])]
        print("error", review)
        return [-1, -1]
    except Exception as e:
        print(e, "error", review)
        return [-1, -1]


def build_judge_prompt(rule: Dict, question: Dict, ans1: Dict, ans2: Dict,
                       context: Optional[Dict] = None,
                       visual: bool = False) -> str:
    """Assemble the two-assistant comparison prompt
    (reference: eval_gpt_review_bench.py content assembly)."""
    prompt = rule["prompt"]
    cap_str = ""
    if visual and context is not None:
        cap_str = "[Context]\n" + "\n".join(context.get("captions", [])) + "\n\n"
    return (f"{cap_str}"
            f"[Question]\n{question['text']}\n\n"
            f"[Assistant 1]\n{ans1['text']}\n\n[End of Assistant 1]\n\n"
            f"[Assistant 2]\n{ans2['text']}\n\n[End of Assistant 2]\n\n"
            f"[System]\n{prompt}\n\n")


def review_answers(question_file: str, answer_files: List[str], rule_file: str,
                   output_file: str, context_file: Optional[str] = None,
                   chat_fn: Optional[Callable] = None,
                   limit: Optional[int] = None) -> List[Dict]:
    """Run pairwise reviews, resuming past completed ids (idempotent like
    the reference's cur_reviews check)."""
    chat_fn = chat_fn or openai_chat_fn()
    questions = [json.loads(l) for l in open(question_file)]
    answers1 = [json.loads(l) for l in open(answer_files[0])]
    answers2 = [json.loads(l) for l in open(answer_files[1])]
    rules = json.load(open(rule_file))
    contexts = None
    if context_file:
        contexts = {c["image"]: c
                    for c in (json.loads(l) for l in open(context_file))}

    done = {}
    if os.path.exists(output_file):
        for l in open(output_file):
            r = json.loads(l)
            done[r["question_id"]] = r

    reviews = []
    with open(output_file, "a") as out:
        for q, a1, a2 in list(zip(questions, answers1, answers2))[:limit]:
            qid = q["question_id"]
            if qid in done:
                reviews.append(done[qid])
                continue
            category = q.get("category", "default")
            rule = rules.get(category, rules.get("default"))
            ctx = contexts.get(q.get("image")) if contexts else None
            content = build_judge_prompt(rule, q, a1, a2, ctx,
                                         visual=ctx is not None)
            review = chat_fn(rule.get("role", "Assistant"), content)
            record = {
                "question_id": qid,
                "answer1_id": a1.get("answer_id"),
                "answer2_id": a2.get("answer_id"),
                "category": category,
                "content": review,
                "tuple": parse_score(review),
            }
            out.write(json.dumps(record) + "\n")
            out.flush()
            reviews.append(record)
    return reviews


def summarize_gpt_review(review_files: List[str]) -> Dict[str, List[float]]:
    """Aggregate relative scores per category
    (reference: llava/eval/summarize_gpt_review.py:1-60)."""
    import numpy as np
    from collections import defaultdict

    out = {}
    for review_file in review_files:
        scores = defaultdict(list)
        for line in open(review_file):
            review = json.loads(line)
            if review["tuple"][0] == -1:
                continue
            scores[review.get("category", "all")].append(review["tuple"])
            scores["all"].append(review["tuple"])
        for k, v in sorted(scores.items()):
            stats = np.asarray(v).mean(0).tolist()
            stats = [round(t, 3) for t in stats]
            rel = round(stats[1] / stats[0] * 100, 1) if stats[0] else 0.0
            print(f"{review_file} {k}: rel {rel} | {stats}")
            out[f"{review_file}:{k}"] = stats + [rel]
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-q", "--question", required=True)
    parser.add_argument("-a", "--answer-list", nargs="+", required=True)
    parser.add_argument("-r", "--rule", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-c", "--context", default=None)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args()
    review_answers(args.question, args.answer_list, args.rule, args.output,
                   context_file=args.context, limit=args.limit)


if __name__ == "__main__":
    main()

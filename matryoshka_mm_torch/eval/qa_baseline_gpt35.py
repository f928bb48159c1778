"""GPT-3.5 answer baseline (reference: llava/eval/qa_baseline_gpt35.py:1-74).

Generates baseline answers for a question file with an OpenAI-compatible
endpoint (API-gated; judge injectable for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import uuid
from typing import Callable, Optional

MODEL_ID = "gpt-3.5-turbo:20230327"


def get_answer(question: str, max_tokens: int, chat_fn: Callable) -> str:
    return chat_fn("You are a helpful assistant.", question)


def run(question_file: str, output_file: str, max_tokens: int = 1024,
        chat_fn: Optional[Callable] = None, limit: Optional[int] = None):
    if chat_fn is None:
        from .gpt_review import openai_chat_fn

        chat_fn = openai_chat_fn(model="gpt-3.5-turbo", max_tokens=max_tokens)

    questions = [json.loads(l) for l in open(question_file)][:limit]
    done = set()
    if os.path.exists(output_file):
        done = {json.loads(l)["question_id"] for l in open(output_file)}
    with open(output_file, "a") as out:
        for q in questions:
            if q["question_id"] in done:
                continue
            text = get_answer(q["text"], max_tokens, chat_fn)
            out.write(json.dumps({
                "answer_id": str(uuid.uuid4())[:8],
                "question_id": q["question_id"],
                "model_id": MODEL_ID,
                "text": text,
                "metadata": {},
            }) + "\n")
            out.flush()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-q", "--question", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--max-tokens", type=int, default=1024)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args()
    run(args.question, args.output, args.max_tokens, limit=args.limit)

"""Text-only QA answer generation on the PyTorch port (port of
``matryoshka_mm_tpu/eval/model_qa.py``; reference:
llava/eval/model_qa.py:1-64).

Answers are sampled at temperature 0.7 from ``generate``'s default
generator, seeded 0, so two runs give the same text.
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

import numpy as np

from ..conversation import default_conversation
from ..models.builder import load_pretrained_model


def eval_model(args):
    model_name = os.path.basename(args.model_path.rstrip("/"))
    tokenizer, model, _, _ = load_pretrained_model(
        args.model_path, None, model_name, device=args.device)

    with open(os.path.expanduser(args.question_file)) as f:
        questions = [json.loads(line) for line in f]
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    with open(answers_file, "w") as ans_file:
        for line in questions:
            idx = line["question_id"]
            conv = default_conversation.copy()
            conv.append_message(conv.roles[0], line["text"])
            conv.append_message(conv.roles[1], None)
            input_ids = np.asarray(tokenizer(conv.get_prompt()).input_ids,
                                   np.int32)[None, :]

            output_ids = model.generate(
                input_ids, do_sample=True, temperature=0.7,
                max_new_tokens=1024,
                eos_token_id=getattr(tokenizer, "eos_token_id", 2),
                pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0)
            outputs = tokenizer.batch_decode(
                output_ids, skip_special_tokens=True)[0].strip()

            ans_file.write(json.dumps({
                "id": idx, "question_id": idx, "text": outputs,
                "answer_id": str(uuid.uuid4())[:8], "model_id": model_name,
                "metadata": {}}) + "\n")


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default="debug://tiny")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--answers-file", type=str, default="answer.jsonl")
    return parser


if __name__ == "__main__":
    eval_model(build_parser().parse_args())

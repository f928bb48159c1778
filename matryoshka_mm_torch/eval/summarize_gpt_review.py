"""CLI for GPT-review score rollups.

Reference-surface parity: ``python -m ...eval.summarize_gpt_review -f
reviews.jsonl`` prints per-category relative scores exactly like the
reference's standalone script (llava/eval/summarize_gpt_review.py:1-60);
the aggregation itself lives in :func:`eval.gpt_review.summarize_gpt_review`.
"""

from __future__ import annotations

import argparse

from .gpt_review import summarize_gpt_review


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-f", "--files", nargs="+", required=True,
                        help="review jsonl files (gpt_review output)")
    args = parser.parse_args()
    summarize_gpt_review(args.files)   # prints per-category rel scores


if __name__ == "__main__":
    main()

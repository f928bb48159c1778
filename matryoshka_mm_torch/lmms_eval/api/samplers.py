"""Few-shot context samplers (reference: lmms-eval/lmms_eval/api/samplers.py).

A sampler owns the few-shot doc pool and renders ``num_fewshot`` labeled
examples into a context prefix:

    <doc_to_text><target_delimiter><doc_to_target><fewshot_delimiter> ...

``ContextSampler`` draws randomly (seeded rng); ``FirstNSampler`` takes the
first N in order (canonical-ordered corpora like MMLU).  When the few-shot
split is the evaluation split, one extra example is drawn and the doc under
evaluation is excluded (reference: samplers.py:21-29).

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/api/samplers.py``.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence


class ContextSampler:
    def __init__(self, docs: Sequence[dict], task, rnd: random.Random,
                 fewshot_indices: Optional[List[int]] = None):
        if rnd is None:
            raise ValueError("must pass a seeded random.Random")
        self.rnd = rnd
        self.task = task
        cfg = task.config
        self.target_delimiter = cfg.get("target_delimiter", " ")
        self.fewshot_delimiter = cfg.get("fewshot_delimiter", "\n\n")
        # pool-selection predicate MUST mirror ConfigurableTask.
        # _fewshot_sampler: an unset fewshot_split means the pool IS the
        # eval split (task.py builds it from self.docs()), so the extra
        # example for self-exclusion must be drawn then too — `==` alone
        # missed the None case and under-filled the context by one shot
        # whenever the doc under evaluation was drawn
        self.same_as_eval = (cfg.get("fewshot_split")
                             in (None, cfg.get("test_split")))
        self.docs = list(docs)
        if fewshot_indices:
            self.docs = [self.docs[i] for i in fewshot_indices]

    def _render(self, doc: dict) -> str:
        text = self.task.doc_to_text(doc)
        target = self.task.doc_to_target(doc)
        choices = self.task.doc_to_choice(doc)
        if choices is not None:
            # an index-valued text/target refers into the choice list
            if isinstance(text, int):
                text = choices[text]
            if isinstance(target, int):
                target = choices[target]
        if isinstance(target, list):
            target = target[0]
        return f"{text}{self.target_delimiter}{target}"

    def get_context(self, doc: dict, num_fewshot: int) -> str:
        n = num_fewshot + 1 if self.same_as_eval else num_fewshot
        drawn = self.sample(n)
        selected = [d for d in drawn if d != doc][:num_fewshot]
        return self.fewshot_delimiter.join(
            self._render(d) for d in selected) + self.fewshot_delimiter

    def sample(self, n: int) -> List[dict]:
        return self.rnd.sample(self.docs, n)


class FirstNSampler(ContextSampler):
    """Canonical ordered few-shot (reference: samplers.py:59-66)."""

    def sample(self, n: int) -> List[dict]:
        if n > len(self.docs):
            raise ValueError(f"{n} few-shot examples requested, only "
                             f"{len(self.docs)} available")
        return self.docs[:n]


SAMPLER_REGISTRY = {
    "default": ContextSampler,
    "first_n": FirstNSampler,
}


def get_sampler(name: str):
    try:
        return SAMPLER_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; known: "
                         f"{sorted(SAMPLER_REGISTRY)}")

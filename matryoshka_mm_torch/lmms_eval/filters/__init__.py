"""Response post-processing filters.

Re-provides the reference's filter pipeline
(reference: lmms-eval/lmms_eval/filters/__init__.py — registry +
build_filter_ensemble; lmms-eval/lmms_eval/api/filter.py — Filter /
FilterEnsemble) in one compact package: without answer-extraction
filters, free-form model outputs ("The answer is (B).") never match
letter targets on MMMU/MathVista-style tasks.

A ``Filter`` maps the list of per-instance response lists to filtered
lists (same order, same outer length); a ``FilterEnsemble`` chains
filters and stores the result under ``instance.filtered_resps[name]``.
Task YAMLs declare pipelines as

    filter_list:
      - name: flexible-extract
        filter:
          - function: multi_choice_regex
            regex_pattern: "(\\\\([A-Z]\\\\))"
            ignore_case: true

Filter semantics match the reference implementations cited on each class.

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/filters/__init__.py``.
"""

from __future__ import annotations

import re
import string
import sys
import unicodedata
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence


class Filter:
    """Base: identity over the response lists."""

    def __init__(self, **kwargs):
        pass

    def apply(self, resps: Sequence[list], docs: Sequence[dict]) -> List[list]:
        return [list(r) for r in resps]


@dataclass
class FilterEnsemble:
    """Ordered filter pipeline; writes ``filtered_resps[self.name]``
    (reference: api/filter.py:31-53)."""

    name: str
    filters: List[Filter]

    def apply(self, instances: Sequence, docs: Optional[Sequence[dict]] = None):
        if docs is None:
            docs = [inst.doc for inst in instances]
        resps = [inst.resps for inst in instances]
        for f in self.filters:
            resps = list(f.apply(resps, docs))
        for inst, resp in zip(instances, resps):
            if inst.filtered_resps is None:
                inst.filtered_resps = {}
            inst.filtered_resps[self.name] = resp


# ---------------------------------------------------------------------------
# selection (reference: filters/selection.py)
# ---------------------------------------------------------------------------

class TakeFirstFilter(Filter):
    """Keep only the first response per instance; collapses the list to a
    scalar like the reference (selection.py:6-16)."""

    def apply(self, resps, docs):
        return [r[0] for r in resps]


class TakeKFilter(Filter):
    """First ``k`` responses per instance (selection.py:19-28)."""

    def __init__(self, k: int, **kwargs):
        self.k = int(k)

    def apply(self, resps, docs):
        if resps and len(resps[0]) < self.k:
            raise ValueError(
                f"need >= {self.k} responses per doc, got {len(resps[0])}; "
                f"increase repeats")
        return [list(r[: self.k]) for r in resps]


class MajorityVoteFilter(Filter):
    """Most frequent response wins (selection.py:31-47)."""

    def apply(self, resps, docs):
        return [[Counter(r).most_common(1)[0][0]] for r in resps]


# ---------------------------------------------------------------------------
# transformation (reference: filters/transformation.py)
# ---------------------------------------------------------------------------

class LowercaseFilter(Filter):
    def apply(self, resps, docs):
        return [[r.lower() for r in inst] for inst in resps]


class UppercaseFilter(Filter):
    def apply(self, resps, docs):
        return [[r.upper() for r in inst] for inst in resps]


class MapFilter(Filter):
    """Dict lookup with default (transformation.py:27-48)."""

    def __init__(self, mapping_dict: Optional[dict] = None, default_value=None,
                 **kwargs):
        self.mapping = dict(mapping_dict or {})
        self.default = default_value

    def apply(self, resps, docs):
        return [[self.mapping.get(r, self.default) for r in inst]
                for inst in resps]


# ---------------------------------------------------------------------------
# extraction (reference: filters/extraction.py)
# ---------------------------------------------------------------------------

class WhitespaceFilter(Filter):
    """Strip one leading space (extraction.py:7-26)."""

    def apply(self, resps, docs):
        return [[r[1:] if r.startswith(" ") else r for r in inst]
                for inst in resps]


def _pick_match(found, group_select):
    m = found[group_select]
    if isinstance(m, tuple):            # multiple groups: first non-empty
        m = next((g for g in m if g), "")
    return m.strip()


class RegexFilter(Filter):
    """findall + group_select, with a fallback string when nothing matches
    (extraction.py:29-69)."""

    def __init__(self, regex_pattern: str = r"#### (\-?[0-9\.\,]+)",
                 group_select: int = 0, fallback: str = "[invalid]",
                 **kwargs):
        self.regex = re.compile(regex_pattern)
        self.group_select = group_select
        self.fallback = fallback

    def _extract(self, resp: str) -> str:
        found = self.regex.findall(resp)
        if not found:
            return self.fallback
        return _pick_match(found, self.group_select)

    def apply(self, resps, docs):
        return [[self._extract(r) for r in inst] for inst in resps]


_PUNCT_TABLE = dict.fromkeys(
    i for i in range(sys.maxunicode)
    if unicodedata.category(chr(i)).startswith("P"))


class MultiChoiceRegexFilter(RegexFilter):
    """Letter-answer extraction with two fallbacks
    (extraction.py:72-171): if the base regex misses, (1) search for a
    verbatim choice string from ``doc[choices_field]`` and map it to its
    letter, then (2) match a bare trailing letter like ``: B``.  Docs
    without the choices field just use the base regex."""

    def __init__(self, regex_pattern: str = r"(\([A-Z]\))",
                 group_select: int = 0, fallback: str = "[invalid]",
                 ignore_case: bool = False, ignore_punctuation: bool = False,
                 regexes_to_ignore: Optional[List[str]] = None,
                 choices_field: str = "choices", **kwargs):
        super().__init__(regex_pattern, group_select, fallback)
        self.ignore_case = ignore_case
        self.ignore_punctuation = ignore_punctuation
        self.regexes_to_ignore = regexes_to_ignore or []
        self.choices_field = choices_field

    def _normalize(self, s: str) -> str:
        for pat in self.regexes_to_ignore:
            s = re.sub(pat, "", s)
        if self.ignore_case:
            s = s.lower()
        if self.ignore_punctuation:
            s = s.translate(_PUNCT_TABLE)
        return s

    def _find(self, regex, resp, convert=None):
        found = regex.findall(resp)
        if not found:
            return ""
        m = _pick_match(found, min(self.group_select, len(found) - 1))
        if convert and m in convert:
            return convert[m]
        return m

    def apply(self, resps, docs):
        out = []
        for inst, doc in zip(resps, docs):
            choices = doc.get(self.choices_field) if isinstance(doc, dict) \
                else None
            by_text, bare = {}, {}
            if choices:
                letters = string.ascii_uppercase
                pats = []
                for i, c in enumerate(choices):
                    norm = self._normalize(str(c).strip())
                    pats.append(re.escape(norm))
                    by_text[norm] = f"({letters[i]})"
                    bare[letters[i]] = f"({letters[i]})"
                text_regex = re.compile("|".join(pats)) if pats else None
                bare_regex = re.compile(
                    r":[\s]*(" + "|".join(bare) + r")") if bare else None
            else:
                text_regex = bare_regex = None

            filtered = []
            for resp in inst:
                m = self._find(self.regex, resp)
                if not m and text_regex is not None:
                    m = self._find(text_regex, self._normalize(resp), by_text)
                if not m and bare_regex is not None:
                    m = self._find(bare_regex, resp, bare)
                filtered.append(m or self.fallback)
            out.append(filtered)
        return out


# ---------------------------------------------------------------------------
# registry (reference: filters/__init__.py:7-45)
# ---------------------------------------------------------------------------

FILTER_REGISTRY: Dict[str, Any] = {
    "take_first": TakeFirstFilter,
    "take_first_k": TakeKFilter,
    "majority_vote": MajorityVoteFilter,
    "regex": RegexFilter,
    "multi_choice_regex": MultiChoiceRegexFilter,
    "remove_whitespace": WhitespaceFilter,
    "lowercase": LowercaseFilter,
    "uppercase": UppercaseFilter,
    "map": MapFilter,
}


def get_filter(name):
    if isinstance(name, str):
        try:
            return FILTER_REGISTRY[name]
        except KeyError:
            raise KeyError(f"unknown filter {name!r}; known: "
                           f"{sorted(FILTER_REGISTRY)}")
    return name  # already a Filter class (YAMLs may pass callables)


def build_filter_ensemble(name: str, components) -> FilterEnsemble:
    """components: list of (function_name, kwargs) pairs or config dicts
    ({"function": ..., **kwargs})."""
    filters = []
    for comp in components:
        if isinstance(comp, dict):
            kwargs = dict(comp)
            fn = kwargs.pop("function")
        else:
            fn, kwargs = comp
            kwargs = dict(kwargs or {})
        filters.append(get_filter(fn)(**kwargs))
    return FilterEnsemble(name=name, filters=filters)

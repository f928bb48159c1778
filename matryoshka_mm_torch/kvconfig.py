"""kv-string configuration DSL.

The reference depends on an unvendored external package (``rosemary``) for a
tiny key=value grammar that is the de-facto config language of every M3/MoE
feature, e.g.::

    'ver=v0_numtoks=[1,9,36,144,576]'
    'ver=v2_numtoks=[1,144]_betas=[1,0.5]_gamma=0.1'
    't=dense_ft=cls_obj=weightedlm_loadb=switch_alpha=0.01'

(reference use sites: llava/model/llava_arch.py:32-35,285,462,501,
llava/model/language_model/llava_llama.py:245,297,
llava/train/llava_trainer.py:469-470,
llava/model/language_model/generationmixin_patch.py:171-202.)

This module is a standalone, tested re-implementation of that grammar:

* a kv-string is ``key=value`` segments joined by ``_``;
* values never contain ``_``; list-valued entries are bracketed
  (``[1,9,36]``) and may contain commas;
* scalar values are auto-coerced: int first, then float, then kept as str;
* bracketed values are kept as strings -- call :func:`parse_list` (or the
  reference's ``eval``) at the use site;
* :func:`create_string_from_kv` is the exact inverse used to re-serialize a
  mutated kv-dict (e.g. mapping a multi-scale spec to per-scale specs).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, Union

Scalar = Union[int, float, str]


def _coerce(value: str) -> Scalar:
    """Coerce a raw value segment: int -> float -> str (brackets stay str)."""
    if value.startswith("["):
        return value
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def parse_kv_from_string(s: str) -> Dict[str, Scalar]:
    """Parse ``'a=1_b=x_c=[1,2]'`` into ``{'a': 1, 'b': 'x', 'c': '[1,2]'}``."""
    if s is None:
        raise ValueError("cannot parse kv-string: None")
    kvs: Dict[str, Scalar] = {}
    last_key = None
    for segment in s.split("_"):
        if "=" in segment:
            key, _, value = segment.partition("=")
            kvs[key] = _coerce(value)
            last_key = key
        elif last_key is not None:
            # Defensive: a value that legitimately contained '_' -- glue it
            # back onto the previous value verbatim.
            kvs[last_key] = f"{kvs[last_key]}_{segment}"
        else:
            raise ValueError(f"malformed kv-string segment {segment!r} in {s!r}")
    return kvs


def create_string_from_kv(kvs: Dict[str, Any]) -> str:
    """Inverse of :func:`parse_kv_from_string`."""
    return "_".join(f"{k}={v}" for k, v in kvs.items())


def parse_list(value: Union[str, int, float]) -> List[Scalar]:
    """Safely evaluate a bracketed list value like ``'[1,9,36,144,576]'``.

    The reference calls ``eval`` on these (llava_arch.py:285); we use
    ``ast.literal_eval`` for the same outcome without arbitrary code
    execution.  A scalar is promoted to a one-element list.
    """
    if isinstance(value, (int, float)):
        return [value]
    return list(ast.literal_eval(value))


def tokscales_from_spec(matryoshka_vis_token_scale: str) -> List[int]:
    """Extract the sorted token-scale list from a scale spec string.

    ``'ver=v0_numtoks=[1,9,36,144,576]'`` -> ``[1, 9, 36, 144, 576]``.
    """
    kvs = parse_kv_from_string(matryoshka_vis_token_scale)
    numtoks = kvs.get("numtoks")
    if numtoks is None:
        raise ValueError(f"spec {matryoshka_vis_token_scale!r} has no numtoks")
    return [int(x) for x in parse_list(numtoks)]


def per_scale_specs(matryoshka_vis_token_scale: str) -> List[str]:
    """Expand a multi-scale spec into one spec per scale.

    ``'ver=v0_numtoks=[1,9]'`` -> ``['ver=v0_numtoks=1', 'ver=v0_numtoks=9']``
    (reference: llava_llama.py:294-303).
    """
    kvs = parse_kv_from_string(matryoshka_vis_token_scale)
    out = []
    for n in parse_list(kvs["numtoks"]):
        kvs2 = dict(kvs)
        kvs2["numtoks"] = str(n)
        out.append(create_string_from_kv(kvs2))
    return out

"""Abstract multimodal model API (reference: lmms-eval/lmms_eval/api/model.py).

Adapters implement ``generate_until`` (free-form answers) and
``loglikelihood`` (scored continuations) over request Instances.

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/api/model.py``.
"""

from __future__ import annotations

import abc
from typing import List, Tuple

from .instance import Instance


class lmms(abc.ABC):
    def __init__(self):
        self._rank = 0
        self._world_size = 1

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @abc.abstractmethod
    def generate_until(self, requests: List[Instance]) -> List[str]:
        ...

    @abc.abstractmethod
    def loglikelihood(self, requests: List[Instance]) -> List[Tuple[float, bool]]:
        ...

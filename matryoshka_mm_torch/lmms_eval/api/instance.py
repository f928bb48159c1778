"""Request instance (reference: lmms-eval/lmms_eval/api/instance.py).

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/api/instance.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass
class Instance:
    request_type: str            # 'generate_until' | 'loglikelihood'
    doc: dict
    arguments: Tuple[Any, ...]   # (context, gen_kwargs, visual) etc.
    idx: int
    task_name: str
    doc_id: int
    resps: list = dataclasses.field(default_factory=list)
    filtered_resps: Optional[dict] = None

    @property
    def args(self):
        return self.arguments

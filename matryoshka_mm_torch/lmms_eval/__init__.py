"""lmms-eval-compatible benchmark harness.

A compact re-implementation of the vendored lmms-eval fork's architecture
(reference: lmms-eval/lmms_eval/): task registry driven by YAML configs,
an abstract multimodal model API (``loglikelihood`` / ``generate_until``),
an evaluator that collates request Instances, runs the model, and
aggregates metrics with bootstrap confidence intervals, and a CLI with the
``--matryoshka_vis_token_scale`` knob plumbed into the model kwargs
(reference: lmms-eval/lmms_eval/__main__.py:147, evaluator.py:98).

The PyTorch port of ``matryoshka_mm_tpu/lmms_eval/``, module for module,
with its own copy of the task corpus (``tasks/*.yaml``).
"""

from .api.registry import get_model, get_task, register_model, register_task  # noqa: F401
from .evaluator import simple_evaluate  # noqa: F401

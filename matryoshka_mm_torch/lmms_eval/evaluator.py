"""Evaluator (reference: lmms-eval/lmms_eval/evaluator.py:32-601).

``simple_evaluate`` seeds, instantiates the model adapter (injecting
``matryoshka_vis_token_scale`` into model kwargs like the reference's
evaluator.py:98), builds task Instances, runs requests, and aggregates
metrics with bootstrap stderr.

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/evaluator.py``.
Nothing of the port draws from torch's global generator (``generate`` and
the batcher seed their own), so ``random`` and numpy are seeded as in JAX
and nothing more.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .api.registry import get_model, get_task
from .api.task import ConfigurableTask


def simple_evaluate(
    model: str,
    model_args: Optional[str] = None,
    tasks: Optional[List[str]] = None,
    limit: Optional[int] = None,
    seed: int = 1234,
    matryoshka_vis_token_scale: Optional[str] = None,
    log_samples: bool = False,
) -> Dict[str, Any]:
    random.seed(seed)
    np.random.seed(seed)

    kwargs = {}
    if model_args:
        for part in model_args.split(","):
            if not part:
                continue
            k, _, v = part.partition("=")
            kwargs[k] = v
    if matryoshka_vis_token_scale is not None:
        # injected into model kwargs (reference: evaluator.py:98)
        kwargs["matryoshka_vis_token_scale"] = matryoshka_vis_token_scale

    lm = get_model(model)(**kwargs)
    try:
        return _evaluate(lm, tasks, limit, seed, log_samples)
    finally:
        # adapters owning external resources (e.g. llava_sglang's
        # in-process serving worker) release them here
        if hasattr(lm, "close"):
            lm.close()


def _evaluate(lm, tasks, limit, seed, log_samples) -> Dict[str, Any]:
    results: Dict[str, Any] = {"results": {}, "configs": {}, "samples": {}}
    for task_name in tasks or []:
        task = ConfigurableTask(get_task(task_name))
        instances = task.build_instances(limit, seed=seed)
        t0 = time.time()
        if task.output_type == "generate_until":
            responses = lm.generate_until(instances)
        else:
            responses = lm.loglikelihood(instances)
        for inst, resp in zip(instances, responses):
            if task.output_type == "generate_until":
                inst.resps = list(resp) if isinstance(resp, (list, tuple)) \
                    else [resp]
            else:
                # loglikelihood: the response IS one (logprob, is_greedy)
                # tuple per instance — list(resp) would split it into two
                # "responses" and take_first would hand process_results a
                # bare float instead of the pair
                inst.resps = [resp]
        # answer-extraction pipelines (reference: task.apply_filters);
        # each ensemble is scored separately, keyed "metric,name" ("none"
        # keeps the bare metric name)
        ens_names = task.apply_filters(instances)
        agg: Dict[str, Any] = {}
        samples = []
        for ens in ens_names:
            per_doc = []
            for inst in instances:
                filtered = inst.filtered_resps[ens]
                if isinstance(filtered, list):
                    filtered = filtered[0] if filtered else ""
                per_doc.append(task.process_results(inst.doc, filtered))
                if log_samples and ens == ens_names[0]:
                    samples.append({"doc_id": inst.doc_id,
                                    "resps": inst.resps,
                                    "filtered": inst.filtered_resps,
                                    "scores": per_doc[-1]})
            for k, v in task.aggregate(per_doc).items():
                agg[k if ens == "none" else f"{k},{ens}"] = v
        agg["samples"] = len(instances)
        agg["time_s"] = round(time.time() - t0, 1)
        results["results"][task_name] = agg
        results["configs"][task_name] = task.config
        if log_samples:
            results["samples"][task_name] = samples
    return results


def check_integrity(tasks: Optional[List[str]] = None) -> List[str]:
    """Task-config validation (reference: evaluator.py:20-24
    ``run_task_tests`` / ``--check_integrity``): every named task (default
    all registered) must declare the required keys, reference registered
    metrics and aggregations, and carry well-formed generation kwargs.
    Returns a list of problems (empty == clean)."""
    from .api.metrics import AGGREGATIONS, METRICS
    from .api.registry import list_tasks

    problems = []
    for name in tasks or list_tasks():
        try:
            cfg = get_task(name)
        except Exception as e:
            problems.append(f"{name}: unresolvable ({e})")
            continue
        for key in ("task", "dataset_path", "doc_to_text", "doc_to_target",
                    "metric_list"):
            if key not in cfg:
                problems.append(f"{name}: missing key {key!r}")
        for m in cfg.get("metric_list", []):
            # a custom process_results hook defines its own metric keys,
            # so they need not exist in the shared METRICS registry
            if not cfg.get("process_results") and m.get("metric") not in METRICS:
                problems.append(f"{name}: unknown metric {m.get('metric')!r}")
            agg = m.get("aggregation", "mean")
            if isinstance(agg, str) and "." in agg:
                from .api.task import _resolve_hook

                try:
                    _resolve_hook(agg)
                except Exception as e:
                    problems.append(f"{name}: unresolvable aggregation "
                                    f"hook {agg!r} ({e})")
            elif agg not in AGGREGATIONS:
                problems.append(f"{name}: unknown aggregation {agg!r}")
        for hook_key in ("process_docs", "process_results"):
            hook = cfg.get(hook_key)
            if hook:
                from .api.task import _resolve_hook

                try:
                    _resolve_hook(hook)
                except Exception as e:
                    problems.append(f"{name}: unresolvable {hook_key} "
                                    f"hook {hook!r} ({e})")
        gk = cfg.get("generation_kwargs", {})
        if gk and not isinstance(gk.get("max_new_tokens", 1), int):
            problems.append(f"{name}: max_new_tokens must be int")
    return problems


def make_table(results: Dict[str, Any]) -> str:
    """Rank-0 results table (reference: lmms-eval __main__ output).

    Metric keys are ``metric`` or ``metric,ensemble``; stderr keys carry
    the ``_stderr`` suffix on the metric part."""
    lines = [f"{'Task':<20} {'Metric':<28} {'Value':>10} {'Stderr':>10} {'N':>6}"]
    for task, agg in results["results"].items():
        for k, v in agg.items():
            if "_stderr" in k or k in ("samples", "time_s"):
                continue
            metric, _, ens = k.partition(",")
            skey = f"{metric}_stderr,{ens}" if ens else f"{metric}_stderr"
            stderr = agg.get(skey, 0.0)
            lines.append(f"{task:<20} {k:<28} {v:>10.4f} {stderr:>10.4f} "
                         f"{agg['samples']:>6}")
    return "\n".join(lines)

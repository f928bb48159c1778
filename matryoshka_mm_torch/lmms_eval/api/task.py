"""ConfigurableTask: YAML-driven benchmark definition
(reference: lmms-eval/lmms_eval/api/task.py — 1133 lines of machinery,
reduced to the surface the LLaVA benchmarks use).

A task config provides:
  task:              name
  dataset_path:      local .json/.jsonl file (or HF datasets name)
  dataset_kwargs:    {image_folder: ...}
  test_split:        split name (HF datasets only)
  doc_to_visual:     doc field holding the image (path or PIL)
  doc_to_text:       python format string over doc fields
  doc_to_target:     doc field (or format string) with the gold answer
  generation_kwargs: forwarded to model.generate
  metric_list:       [{metric: name, aggregation: mean, higher_is_better: true}]
  output_type:       'generate_until' (default) | 'loglikelihood'
  doc_to_choice:     doc field holding the multiple-choice options
  filter_list:       answer-extraction pipelines (filters package); each
                     entry {name, filter: [{function, **kwargs}]} becomes a
                     FilterEnsemble scored separately as "metric,name"
  num_fewshot:       few-shot example count (api/samplers.py)
  fewshot_split:     key/split for few-shot docs; fewshot_config.sampler
                     picks 'default' (random) or 'first_n'
  target_delimiter:  what joins context and continuation (default " ")

The PyTorch port of ``matryoshka_mm_tpu/lmms_eval/api/task.py``.  A
``loglikelihood`` instance carries ``(context, target_delimiter + target,
visual)``, as lmms-eval builds it, and its ``(logprob, greedy)`` response
is scored by the task's ``process_results`` hook.  (The JAX package passes
the generation kwargs in the continuation's place, which the adapter
cannot tokenize.)
"""

from __future__ import annotations

import json
import os
import string
from typing import Any, Dict, List, Optional

from .instance import Instance
from .metrics import AGGREGATIONS, METRICS, bootstrap_stderr


class _SafeFormatter(string.Formatter):
    def get_value(self, key, args, kwargs):
        if isinstance(key, str):
            return kwargs.get(key, "")
        return super().get_value(key, args, kwargs)


_FMT = _SafeFormatter()


def _resolve_hook(spec: str):
    """Resolve a ``"task_utils.<fn>"`` YAML hook to a callable — the
    compact analog of the reference's ``!function utils.<fn>`` mechanism
    (reference: lmms-eval/lmms_eval/api/task.py ConfigurableTask config
    hooks ``process_docs`` / ``process_results`` / per-metric
    ``aggregation``)."""
    import importlib

    mod_name, fn_name = spec.rsplit(".", 1)
    mod = importlib.import_module(f"..tasks.{mod_name}", package=__package__)
    return getattr(mod, fn_name)


class ConfigurableTask:
    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)
        self.task_name = config["task"]
        self.output_type = config.get("output_type", "generate_until")
        self._docs: Optional[List[dict]] = None

    # ---- data ----
    def docs(self, limit: Optional[int] = None) -> List[dict]:
        if self._docs is None:
            path = self.config["dataset_path"]
            if os.path.exists(path):
                if path.endswith(".jsonl"):
                    with open(path) as f:
                        self._docs = [json.loads(l) for l in f]
                else:
                    with open(path) as f:
                        data = json.load(f)
                    self._docs = data if isinstance(data, list) else \
                        data[self.config.get("test_split", "data")]
            else:
                import datasets

                ds = datasets.load_dataset(
                    path, self.config.get("dataset_name"),
                    split=self.config.get("test_split", "test"))
                self._docs = list(ds)
            hook = self.config.get("process_docs")
            if hook:
                self._docs = _resolve_hook(hook)(self._docs)
        return self._docs[:limit] if limit else self._docs

    # ---- doc adapters ----
    def doc_to_text(self, doc: dict) -> str:
        spec = self.config["doc_to_text"]
        if isinstance(spec, str) and spec.startswith("task_utils."):
            # prompt-construction hook (reference: !function utils.<fn>
            # doc_to_text entries, e.g. olympiadbench en_utils.py:22-48)
            text = _resolve_hook(spec)(doc)
        else:
            text = _FMT.vformat(spec, (), doc)
        pre = self.config.get("pre_prompt", "")
        post = self.config.get("post_prompt", "")
        return f"{pre}{text}{post}"

    def doc_to_visual(self, doc: dict):
        field = self.config.get("doc_to_visual")
        if not field or field not in doc or doc[field] is None:
            return None
        vis = doc[field]
        if isinstance(vis, str):
            from PIL import Image

            folder = self.config.get("dataset_kwargs", {}).get("image_folder", "")
            return Image.open(os.path.join(folder, vis)).convert("RGB")
        return vis

    def doc_to_target(self, doc: dict) -> Any:
        tgt = self.config["doc_to_target"]
        if isinstance(tgt, str) and "{" in tgt:
            return _FMT.vformat(tgt, (), doc)
        return doc.get(tgt, tgt)

    def doc_to_choice(self, doc: dict) -> Optional[list]:
        field = self.config.get("doc_to_choice")
        if field is None:
            return None
        if isinstance(field, list):
            return field
        return doc.get(field)

    # ---- few-shot (reference: api/samplers.py via task.py fewshot_context) ----
    def _fewshot_sampler(self, seed: int = 1234):
        import random

        from .samplers import get_sampler

        n = int(self.config.get("num_fewshot", 0) or 0)
        if n <= 0:
            return None, 0
        split = self.config.get("fewshot_split")
        pool = self.docs() if split in (None, self.config.get("test_split")) \
            else self._split_docs(split)
        name = (self.config.get("fewshot_config") or {}).get("sampler",
                                                             "default")
        return get_sampler(name)(pool, self, random.Random(seed)), n

    def _split_docs(self, split: str) -> List[dict]:
        path = self.config["dataset_path"]
        if os.path.exists(path) and not path.endswith(".jsonl"):
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, dict) and split in data:
                return data[split]
        import datasets

        ds = datasets.load_dataset(path, self.config.get("dataset_name"),
                                   split=split)
        return list(ds)

    # ---- instances ----
    def build_instances(self, limit: Optional[int] = None,
                        seed: int = 1234) -> List[Instance]:
        gen_kwargs = self.config.get("generation_kwargs",
                                     {"max_new_tokens": 16, "temperature": 0.0})
        sampler, n_shot = self._fewshot_sampler(seed)
        out = []
        for i, doc in enumerate(self.docs(limit)):
            text = self.doc_to_text(doc)
            if sampler is not None:
                text = sampler.get_context(doc, n_shot) + text
            if self.output_type == "loglikelihood":
                target = self.doc_to_target(doc)
                if isinstance(target, list):
                    target = target[0]
                second = f"{self.config.get('target_delimiter', ' ')}{target}"
            else:
                second = dict(gen_kwargs)
            out.append(Instance(
                request_type=self.output_type,
                doc=doc,
                arguments=(text, second, self.doc_to_visual(doc)),
                idx=0, task_name=self.task_name, doc_id=i))
        return out

    # ---- filters (reference: api/task.py apply_filters + filters/) ----
    def filter_ensembles(self):
        from ..filters import build_filter_ensemble

        spec = self.config.get("filter_list")
        if not spec:
            return [build_filter_ensemble("none", [("take_first", None)])]
        ensembles = []
        for entry in spec:
            ensembles.append(build_filter_ensemble(
                entry["name"], list(entry["filter"])))
        return ensembles

    def apply_filters(self, instances: List[Instance]):
        ensembles = self.filter_ensembles()
        for ens in ensembles:
            ens.apply(instances)
        return [e.name for e in ensembles]

    # ---- scoring ----
    _METRIC_META = ("metric", "aggregation", "higher_is_better")

    def process_results(self, doc: dict, result: str) -> Dict[str, Any]:
        hook = self.config.get("process_results")
        if hook:
            # Benchmark-specific scoring hook (reference: per-task utils.py
            # <task>_process_results, e.g. mme/utils.py:75-90): returns
            # {metric_key: payload}, where the payload may be a dict the
            # custom aggregation consumes (acc+ pairing, circular groups).
            return _resolve_hook(hook)(doc, result)
        if self.output_type == "loglikelihood":
            raise ValueError(
                f"task {self.task_name!r}: a loglikelihood task scores its "
                f"(logprob, greedy) responses through a process_results "
                f"hook; the shared metrics score strings")
        target = self.doc_to_target(doc)
        scores = {}
        for m in self.config.get("metric_list", [{"metric": "exact_match"}]):
            name = m["metric"]
            fn = METRICS[name]
            # extra YAML keys (ignore_case, ignore_punctuation, ...) pass
            # through as metric options (reference: metric_list kwargs)
            kwargs = {k: v for k, v in m.items() if k not in self._METRIC_META}
            scores[name] = fn(target, result, **kwargs)
        return scores

    def aggregate(self, per_doc: List[Dict[str, Any]]) -> Dict[str, Any]:
        out = {}
        for m in self.config.get("metric_list", [{"metric": "exact_match"}]):
            name = m["metric"]
            # a custom process_results may route each doc to a subset of
            # metric keys (MME: perception vs cognition docs)
            values = [d[name] for d in per_doc if name in d]
            agg_spec = m.get("aggregation", "mean")
            if isinstance(agg_spec, str) and "." in agg_spec:
                # benchmark-specific aggregation hook (reference: per-task
                # utils.py <task>_aggregate_results); may return a scalar
                # or a dict of named sub-scores (per-category breakdowns)
                result = _resolve_hook(agg_spec)(values)
                if isinstance(result, dict):
                    for sub, v in result.items():
                        out[f"{name}/{sub}"] = v
                else:
                    out[name] = result
                continue
            out[name] = AGGREGATIONS[agg_spec](values)
            out[f"{name}_stderr"] = bootstrap_stderr(values)
        return out

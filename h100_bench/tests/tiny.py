"""Tiny cells for the CPU tests: a copy of the benchmark with a tiny
Mistral and a tiny MPT configuration, a tiny mix and tiny serving cells,
added as new files and new ``BENCHMARK.json`` entries."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("tiny-mistral-serve", "tiny-mpt-serve")
TRAIN = "tiny-train"
EVAL = "tiny-eval"


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def tiny_configs(dtype: str = "float32", head_dim: int = 16,
                 vocab: int = 512) -> dict:
    b = ROOT / "h100_bench" / "configs"
    mis = json.loads((b / "llava-m3-mistral-7b.json").read_text())
    mis["decoder"].update(hidden_size=4 * head_dim, intermediate_size=96,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, vocab_size=vocab,
                          max_position_embeddings=512)
    mis["vision"].update(hidden_size=32, intermediate_size=64,
                         num_hidden_layers=3, num_attention_heads=4,
                         image_size=56, patch_size=14)
    mis["m3"]["scales"] = [1, 4, 16]
    mis["dtype"] = dtype
    mpt = json.loads((b / "llava-m3-mpt-7b.json").read_text())
    mpt["decoder"].update(d_model=4 * head_dim, n_heads=4, n_layers=2,
                          vocab_size=vocab, max_seq_len=512)
    mpt["vision"] = dict(mis["vision"])
    mpt["m3"]["scales"] = [1, 4, 16]
    mpt["dtype"] = dtype
    return {"tiny-mistral": mis, "tiny-mpt": mpt}


def tiny_workload(limit: float = 1e-3) -> dict:
    w = json.loads((ROOT / "h100_bench" / "workloads" /
                    "mistral7b-serve-mixed.json").read_text())
    w["batcher"].update(max_batch=4, prefill_len=64, max_new_tokens=12,
                        page_size=16, chunk=4)
    w.update(rate_per_s=20.0, lead_s=0.3, warmup_groups=[2],
             check={"sample": 3, "max_logit_gap": limit})
    return w


def tiny_mix() -> dict:
    t = json.loads((ROOT / "h100_bench" / "traffic" /
                    "serve-mixed.json").read_text())
    t.update(block=6, text_tokens={"dist": "loguniform", "low": 4,
                                   "high": 20},
             new_tokens={"dist": "loguniform", "low": 2, "high": 12},
             scales=[1, 4, 16], images=4, image_size=56)
    return t


def make_copy(dest: Path, dtype: str = "float32", limit: float = 1e-3,
              head_dim: int = 16) -> Path:
    """``dest`` holds ``BENCHMARK.json`` and ``h100_bench/`` as committed,
    plus the tiny cells as new files and entries."""
    shutil.copytree(ROOT / "h100_bench", dest / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    add_tiny(dest, dtype, limit, head_dim)
    return dest


def add_tiny(dest: Path, dtype: str = "float32", limit: float = 1e-3,
             head_dim: int = 16) -> None:
    hb = dest / "h100_bench"
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for name, cfg in tiny_configs(dtype, head_dim).items():
        _dump(hb / "configs" / f"{name}.json", cfg)
        bench["configs"].append({"name": name, "source": "tiny test size",
                                 "file": f"h100_bench/configs/{name}.json",
                                 "reduced": []})
    _dump(hb / "traffic" / "tiny-mixed.json", tiny_mix())
    for cell, cfg in zip(CELLS, ("tiny-mistral", "tiny-mpt")):
        _dump(hb / "workloads" / f"{cell}.json", tiny_workload(limit))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": "tiny-mixed", "chips": 1,
                                   "why": "tiny test cell"})
    # each tiny serving cell reports what its family's cell reports
    for m in bench["end_to_end"] + bench["per_layer"]:
        for cell, big in zip(CELLS, ("mistral7b-serve-mixed",
                                     "mpt7b-serve-mixed")):
            if big in m.get("workloads", ()):
                m["workloads"].append(cell)
    add_tiny_train(hb, bench)
    _dump(dest / "BENCHMARK.json", bench)


def _add_cell(bench: dict, name: str, config: str, mix: str,
              metric: str, unit: str) -> None:
    """A cell's entry, its end-to-end metric's (made when missing) and the
    per-layer metrics that move it."""
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": mix, "chips": 1,
                               "why": "tiny test cell"})
    names = {m["name"]: m for m in bench["end_to_end"]}
    if metric not in names:
        names[metric] = {"name": metric, "unit": unit, "better": "higher",
                         "bound": 0.1, "source": "host_clock",
                         "workloads": []}
        bench["end_to_end"].append(names[metric])
    names[metric]["workloads"].append(name)
    for m in bench["per_layer"]:
        if m["moves"] == metric:
            m["workloads"].append(name)


def add_tiny_train(hb: Path, bench: dict) -> None:
    """A tiny LoRA training cell and a tiny eval sweep on the tiny Mistral
    configuration."""
    w = json.loads((ROOT / "h100_bench" / "workloads" /
                    "mistral7b-train-m3lora.json").read_text())
    w["lora"] = {"r": 4, "alpha": 8}
    # float32 on both sides at this size: the readings are ~1e-7
    w["check"] = {"loss_rel_gap": 1e-4, "grad_leaf_gap": 1e-3,
                  "delta_leaf_gap": 1e-3}
    _dump(hb / "workloads" / f"{TRAIN}.json", w)
    t = json.loads((ROOT / "h100_bench" / "traffic" /
                    "lora-sft.json").read_text())
    t.update(batch=2, text_tokens=24)
    _dump(hb / "traffic" / "tiny-sft.json", t)
    _add_cell(bench, TRAIN, "tiny-mistral", "tiny-sft", "train_tok_s",
              "tokens/s")
    w = json.loads((ROOT / "h100_bench" / "workloads" /
                    "mistral7b-eval-sweep.json").read_text())
    w["check"] = {"sample_calls": 2, "max_logit_gap": 1e-3}
    _dump(hb / "workloads" / f"{EVAL}.json", w)
    t = json.loads((ROOT / "h100_bench" / "traffic" /
                    "eval-sweep.json").read_text())
    t.update(rows=4, scales=[1, 4, 16], pad_to=8, images=4, image_size=56,
             text_tokens={"dist": "loguniform", "low": 4, "high": 12})
    _dump(hb / "traffic" / "tiny-eval.json", t)
    _add_cell(bench, EVAL, "tiny-mistral", "tiny-eval", "eval_questions_s",
              "questions/s")

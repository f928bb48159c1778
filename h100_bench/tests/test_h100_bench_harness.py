"""The harness takes a new cell, configuration, mix and metric from new
files alone, runs them on the CPU at a tiny size, and its comparison comes
out false when the served tokens are altered where they are produced."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tiny import ROOT, add_tiny, make_copy

DUMMY_METRIC = '''"""A dummy per-layer metric: the window's requests."""


def read(run):
    return float(len(run["window"]["counted"]))
'''

DRIVE = r'''
import json, sys, time, torch
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
from pathlib import Path
from h100_bench import run
root = Path(".").resolve()
out = {}
for trace in (0, 1):
    r = run.run_cell(root, "tiny-mistral-serve", 2 ** 31 + 9, 1.0,
                     bool(trace), torch.device("cpu"), time.perf_counter())
    out[trace] = r
out["forbidden"] = run.forbidden_modules()
print(json.dumps(out))
'''


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "h100_bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_alone_add_a_cell_a_config_a_mix_and_a_metric(tmp_path):
    import shutil

    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _hashes(tmp_path)
    add_tiny(tmp_path)
    (tmp_path / "h100_bench" / "metrics" / "dummy_attempted.py").write_text(
        DUMMY_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "dummy_attempted", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "ttft_p95_ms",
        "workloads": ["tiny-mistral-serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _hashes(tmp_path)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    env = {"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    p = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    e2e, traced = out["0"], out["1"]
    assert e2e["correct"] and traced["correct"]
    assert set(e2e["metrics"]) == {"ttft_p95_ms", "tpot_p95_ms", "setup_s"}
    assert traced["metrics"]["dummy_attempted"]["value"] == traced["attempted"]
    assert "queue_wait_p95_ms.serve" in traced["metrics"]
    assert list(e2e)[-1] == "checks"
    assert out["forbidden"] == []


@pytest.mark.parametrize("cell", ["tiny-mistral-serve", "tiny-mpt-serve",
                                  "tiny-eval"])
def test_altered_tokens_come_out_not_correct(tmp_path, monkeypatch, cell):
    """The fault a serving or eval cell can have: a token altered where it
    is produced (the greedy pick, in the prefill and in every decode
    step)."""
    import matryoshka_mm_torch.generate as gen
    import matryoshka_mm_torch.serve.batching as batching

    from h100_bench import run

    root = make_copy(tmp_path)
    good = run.run_cell(root, cell, 21, 1.0, False, torch.device("cpu"), 0.0)
    assert good["correct"], good["checks"]
    # each family reports its own TPOT, under its own bound
    assert set(good["metrics"]) == {
        "tiny-mistral-serve": {"ttft_p95_ms", "tpot_p95_ms", "setup_s"},
        "tiny-mpt-serve": {"ttft_p95_ms", "tpot_p95_ms.mpt", "setup_s"},
        "tiny-eval": {"eval_questions_s", "setup_s"}}[cell]
    pick = gen._select_token

    def altered(logits, *a, **k):
        return (pick(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(gen, "_select_token", altered)
    monkeypatch.setattr(batching, "_select_token", altered)
    bad = run.run_cell(root, cell, 21, 1.0, False, torch.device("cpu"), 0.0)
    assert not bad["correct"]
    gap = bad["checks"]["max_logit_gap"]
    assert gap["value"] > 10 * gap["limit"]


def test_training_faults_come_out_not_correct(tmp_path, monkeypatch):
    """The faults a training cell can have: a step that returns its state
    unchanged, and half of the batch left out with the mean taken over the
    rest."""
    import matryoshka_mm_torch.train.trainer as trainer

    from h100_bench import run
    from tiny import TRAIN

    root = make_copy(tmp_path)
    cpu = torch.device("cpu")
    good = run.run_cell(root, TRAIN, 4, 0.3, False, cpu, 0.0)
    assert good["correct"], good["checks"]

    make = trainer.make_train_step

    def unchanged(cfg, tx, **kw):
        step = make(cfg, tx, **kw)

        def step_fn(state, batch):
            import copy
            saved = copy.deepcopy((state.params, state.opt_state))
            new, metrics = step(state, batch)
            for (_, a), (_, b) in zip(
                    trainer.named_leaves(state.params),
                    trainer.named_leaves(saved[0])):
                a.data.copy_(b)
            for k in ("mu", "nu"):
                for p, v in saved[1][k].items():
                    state.opt_state[k][p].copy_(v)
            return state, metrics

        return step_fn

    monkeypatch.setattr(trainer, "make_train_step", unchanged)
    bad = run.run_cell(root, TRAIN, 4, 0.3, False, cpu, 0.0)
    assert not bad["correct"]
    assert bad["checks"]["delta_leaf_gap"]["value"] == pytest.approx(1.0)
    monkeypatch.setattr(trainer, "make_train_step", make)

    loss = trainer.m3_loss

    def half(params, cfg, batch, **kw):
        n = batch.input_ids.shape[0] // 2
        return loss(params, cfg, type(batch)(*(None if t is None else t[:n]
                                                 for t in batch)), **kw)

    monkeypatch.setattr(trainer, "m3_loss", half)
    bad = run.run_cell(root, TRAIN, 4, 0.3, False, cpu, 0.0)
    assert not bad["correct"], bad["checks"]


def test_eval_and_train_cells_read_their_per_layer_metrics(tmp_path):
    from h100_bench import run
    from tiny import EVAL, TRAIN

    root = make_copy(tmp_path)
    cpu = torch.device("cpu")
    ev = run.run_cell(root, EVAL, 6, 0.5, True, cpu, 0.0)
    assert ev["correct"] and ev["device"]["window_s"] > 0
    assert {"capture_share.eval", "mfu.eval"} <= set(ev["metrics"])
    tr = run.run_cell(root, TRAIN, 6, 0.3, True, cpu, 0.0)
    assert tr["correct"] and "mfu.train" in tr["metrics"]
    e2e = run.run_cell(root, EVAL, 6, 0.5, False, cpu, 0.0)
    assert set(e2e["metrics"]) == {"eval_questions_s", "setup_s"}


@pytest.mark.parametrize("cell", ["tiny-mistral-serve", "tiny-mpt-serve",
                                  "tiny-eval"])
def test_the_control_in_the_programs_place_comes_out_not_correct(
        tmp_path, monkeypatch, cell):
    """The float8 control put in the program's place (each sampled
    request's served tokens are the control's picks): the harness's own
    comparison reports ``correct`` false, and ``control.py`` judges its
    readings by the same check."""
    from h100_bench import control, run
    from h100_bench.entries.eval import EvalCell
    from h100_bench.entries.serve import ServeCell

    root = make_copy(tmp_path)
    cpu = torch.device("cpu")
    ctx = run.load_context(root, cell, cpu)
    line = control.readings(ctx, 23, 1.0, True)
    assert line["program_correct"], line
    assert not line["control_correct"], line
    assert line["control_gap"] > float(ctx.workload["check"]["max_logit_gap"])

    cls = EvalCell if cell == "tiny-eval" else ServeCell
    pick = cls.sample
    monkeypatch.setattr(cls, "sample", lambda self, *a: control.as_control(
        self, pick(self, *a)))
    bad = run.run_cell(root, cell, 23, 1.0, False, cpu, 0.0)
    assert not bad["correct"]
    gap = bad["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_training_control_and_fault_are_judged_not_correct(tmp_path):
    """``control.py`` on a training cell: the program's readings pass the
    cell's limits, the float8 control's and half of the batch's do not."""
    from h100_bench import control, run
    from tiny import TRAIN

    root = make_copy(tmp_path)
    ctx = run.load_context(root, TRAIN, torch.device("cpu"))
    line = control.train_readings(ctx, 8, True, True)
    assert line["program_correct"], line["program"]
    assert not line["control_correct"], line["control"]
    assert not line["fault_correct"], line["fault"]

"""The PyTorch port runs with JAX and the JAX package absent, and its
sources import neither, use no fused attention operator of PyTorch and no
``torch.compile``."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "matryoshka_mm_torch"

_DRIVE = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["matryoshka_mm_tpu"] = None    # and so does the JAX package
import numpy as np
from matryoshka_mm_torch.models.builder import load_pretrained_model
_, model, _, _ = load_pretrained_model("debug://tiny", device="cpu")
ids = np.array([[1, 5, -200, 17, 42]], np.int32)
px = np.random.default_rng(0).standard_normal((1, 3, 56, 56)).astype(np.float32)
out = model.generate(ids, images=px, matryoshka_vis_token_scale="ver=v0_numtoks=4",
                     max_new_tokens=4, decode_chunk=2, eos_token_id=-1)
assert out.shape == (1, 4), out.shape
from matryoshka_mm_torch.generate import GenerationConfig
from matryoshka_mm_torch.serve.batching import ContinuousBatcher
batcher = ContinuousBatcher(
    model.params, model.cfg, max_batch=2, prefill_len=64, max_new_tokens=8,
    gen_cfg=GenerationConfig(max_new_tokens=4, decode_chunk=2,
                             eos_token_id=-1),
    chunk=2, backend="paged", page_size=16)
req = batcher.submit(ids, px, numtoks=4, max_new_tokens=4)
served = np.concatenate(list(batcher.stream(req)))
batcher.shutdown()
assert served.tolist() == out[0].tolist(), (served, out)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "matryoshka_mm_tpu")
            if sys.modules[m] is not None]
print("OK", out.tolist())
"""

_TRAIN = """
import sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import dataclasses
import numpy as np
import torch
import matryoshka_mm_torch.train.train, matryoshka_mm_torch.train.train_mem
import matryoshka_mm_torch.parallel.sharding, matryoshka_mm_torch.parallel.inference
import matryoshka_mm_torch.parallel.pipeline, matryoshka_mm_torch.parallel.ring_attention
import matryoshka_mm_torch.train.data, matryoshka_mm_torch.train.sampler
import matryoshka_mm_torch.utils.checkpoint, matryoshka_mm_torch.models.router
from matryoshka_mm_torch.models.builder import load_pretrained_model
from matryoshka_mm_torch.ops.lora import add_lora
from matryoshka_mm_torch.ops.quant import quantize_llama_params
from matryoshka_mm_torch.train.optimizer import OptimizerConfig
from matryoshka_mm_torch.train.train_step import M3Batch
from matryoshka_mm_torch.train.trainer import (create_train_state,
                                               host_metrics, make_train_step)
_, model, _, _ = load_pretrained_model("debug://tiny-moe", device="cpu")
cfg = dataclasses.replace(model.cfg, llama=dataclasses.replace(
    model.cfg.llama, remat=True, remat_policy="names:flash_out,flash_lse"))
assert "router" in model.params and cfg.is_m3_moe
quantize_llama_params(model.params, bits=8, fuse=False)
params = add_lora(model.params, torch.Generator().manual_seed(1), r=4)
state, tx = create_train_state(params, OptimizerConfig(
    learning_rate=1e-2, warmup_ratio=0.0, lora_enable=True))
step = make_train_step(cfg, tx, frozen_vision=True)
rng = np.random.default_rng(0)
ids = rng.integers(5, 500, (2, 20)); ids[:, 3] = -200
labels = ids.copy(); labels[:, :10] = -100
batch = M3Batch(torch.tensor(ids), torch.tensor(
    rng.standard_normal((2, 3, 56, 56)), dtype=torch.float32),
    torch.tensor(labels), torch.ones((2, 20), dtype=torch.bool))
losses = []
for _ in range(3):
    state, metrics = step(state, batch)
    losses.append(host_metrics(metrics)["loss"])
assert np.isfinite(losses).all() and losses[2] < losses[0], losses
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "matryoshka_mm_tpu")
            if sys.modules[m] is not None]
print("OK", losses)
"""


_FRONTEND = """
import json, sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import matryoshka_mm_torch.serve.register_worker
import matryoshka_mm_torch.serve.web_server
import matryoshka_mm_torch.serve.cli
import matryoshka_mm_torch.models.make_delta, matryoshka_mm_torch.models.consolidate
import matryoshka_mm_torch.models.utils, matryoshka_mm_torch.utils.wandb_shim
from matryoshka_mm_torch.serve import controller, model_worker, sglang_worker, test_message
from matryoshka_mm_torch.utils import profiling
from matryoshka_mm_torch import native
sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
w = model_worker.ModelWorker("", "", "t", True, "debug://tiny", None, None,
                             device="cpu", continuous_batching=True,
                             max_batch=2, kv_backend="paged")
c = controller.Controller("shortest_queue", start_expiry_thread=False)
c.register_worker("http://w", False, w.get_status())
assert c.get_worker_address("tiny") == "http://w"
params = sglang_worker._params_from_sglang(
    {"text": "USER: hi ASSISTANT:", "sampling_params": {"max_new_tokens": 4}})
rows = [json.loads(x) for x in b"".join(w.generate_stream_gate(params)).split(b"\\0") if x]
w.batcher.shutdown()
assert rows and all(r["error_code"] == 0 for r in rows), rows
with profiling.trace(sys.argv[1]):
    pass
assert native.native_available() in (True, False)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "matryoshka_mm_tpu")
            if sys.modules[m] is not None]
print("OK", rows[-1]["text"])
"""


_EVAL = """
import json, sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import numpy as np
from PIL import Image
import matryoshka_mm_torch.eval.model_vqa, matryoshka_mm_torch.eval.model_vqa_science
import matryoshka_mm_torch.eval.model_vqa_qbench, matryoshka_mm_torch.eval.model_vqa_mmbench
import matryoshka_mm_torch.eval.model_qa, matryoshka_mm_torch.eval.converters
import matryoshka_mm_torch.eval.eval_mme, matryoshka_mm_torch.eval.eval_textvqa
import matryoshka_mm_torch.eval.eval_science_qa, matryoshka_mm_torch.eval.copy_predictions
import matryoshka_mm_torch.eval.caption_metrics, matryoshka_mm_torch.eval.math_judge
import matryoshka_mm_torch.eval.eval_mmvet, matryoshka_mm_torch.eval.eval_science_qa_gpt4
import matryoshka_mm_torch.eval.qa_baseline_gpt35, matryoshka_mm_torch.eval.summarize_gpt_review
import matryoshka_mm_torch.eval.webpage_report
from matryoshka_mm_torch.eval import eval_pope, model_vqa_loader
rng = np.random.default_rng(0)
Image.fromarray(rng.integers(0, 256, (48, 64, 3), np.uint8)).save("x.png")
with open("q.jsonl", "w") as f, open("labels.jsonl", "w") as g:
    for i in range(3):
        f.write(json.dumps({"question_id": i, "image": "x.png",
                            "text": "Is there a dog in the image?"}) + "\\n")
        g.write(json.dumps({"question_id": i, "label": "yes"}) + "\\n")
model_vqa_loader.eval_model(model_vqa_loader.build_parser().parse_args([
    "--model-path", "debug://tiny", "--device", "cpu", "--image-folder", ".",
    "--question-file", "q.jsonl", "--answers-file", "a.jsonl",
    "--batch-size", "2", "--max_new_tokens", "3",
    "--matryoshka_vis_token_scale", "ver=v0_numtoks=4"]))
answers = [json.loads(l) for l in open("a.jsonl")]
assert sorted(a["question_id"] for a in answers) == [0, 1, 2], answers
scores = eval_pope.eval_pope(answers, "labels.jsonl")
assert 0.0 <= scores["accuracy"] <= 1.0, scores
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "matryoshka_mm_tpu")
            if sys.modules[m] is not None]
print("OK", scores)
"""


_HARNESS = """
import json, sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import numpy as np
from PIL import Image
import matryoshka_mm_torch.lmms_eval.__main__, matryoshka_mm_torch.lmms_eval.logging_utils
import matryoshka_mm_torch.lmms_eval.models.llava_sglang, matryoshka_mm_torch.lmms_eval.models.gpt4v
import matryoshka_mm_torch.igvlm.eval_llava_multiplechoice, matryoshka_mm_torch.igvlm.eval_llava_openended
import matryoshka_mm_torch.igvlm.eval_llava_textgeneration_openended
import matryoshka_mm_torch.igvlm.eval_gpt4v_multiplechoice, matryoshka_mm_torch.igvlm.eval_gpt4v_openended
import matryoshka_mm_torch.igvlm.eval_gpt4v_textgeneration_openended
import matryoshka_mm_torch.config.model_config
from matryoshka_mm_torch.eval.run_llava import load_images
from matryoshka_mm_torch.igvlm.grid import video_to_grid_image
from matryoshka_mm_torch.models.llama import llama_logits
from matryoshka_mm_torch.lmms_eval import register_task, simple_evaluate
from matryoshka_mm_torch.lmms_eval.api.registry import list_tasks
from matryoshka_mm_torch.lmms_eval.evaluator import check_integrity
assert len(list_tasks()) == 46 and check_integrity() == []
Image.fromarray(np.random.default_rng(0).integers(
    0, 256, (48, 64, 3), np.uint8)).save("x.png")
assert load_images(["x.png"])[0].size == (64, 48)
json.dump([{"question": "Is there a dog?", "answer": "no", "image": "x.png"},
           {"question": "Is there a cat?", "answer": "yes", "image": "x.png"}],
          open("docs.json", "w"))
register_task("toy", {"task": "toy", "dataset_path": "docs.json",
    "doc_to_visual": "image", "doc_to_text": "{question}",
    "doc_to_target": "answer", "dataset_kwargs": {"image_folder": "."},
    "generation_kwargs": {"max_new_tokens": 3, "temperature": 0.0},
    "metric_list": [{"metric": "exact_match"}]})
res = simple_evaluate(model="llava",
                      model_args="pretrained=debug://tiny,device=cpu,batch_size=2",
                      tasks=["toy"], matryoshka_vis_token_scale="ver=v0_numtoks=4",
                      log_samples=True)
assert res["results"]["toy"]["samples"] == 2, res
assert all(isinstance(s["resps"][0], str) for s in res["samples"]["toy"])
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "matryoshka_mm_tpu")
            if sys.modules[m] is not None]
print("OK", res["results"]["toy"])
"""


def test_harness_and_igvlm_run_with_jax_blocked(tmp_path):
    """Every lmms-eval and IG-VLM module imports, the task corpus loads
    clean, and ``simple_evaluate`` answers a local task on ``debug://tiny``
    on the CPU, with ``jax`` and ``matryoshka_mm_tpu`` made
    unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _HARNESS], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("OK")


def test_eval_loader_and_pope_run_with_jax_blocked(tmp_path):
    """Every eval module imports, ``model_vqa_loader.eval_model`` answers
    on ``debug://tiny`` on the CPU and ``eval_pope`` scores its answers,
    with ``jax`` and ``matryoshka_mm_tpu`` made unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _EVAL], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("OK")


def test_frontend_runs_with_jax_blocked(tmp_path):
    """The front end's modules import, and a worker answers a request
    through its paged batcher, with ``jax`` and ``matryoshka_mm_tpu`` made
    unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _FRONTEND,
                           str(tmp_path / "trace")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_tiny_generate_runs_with_jax_blocked():
    """``generate`` and one request through the paged batcher, with ``jax``
    and ``matryoshka_mm_tpu`` made unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_train_steps_run_with_jax_blocked():
    """Three QLoRA steps of an M3-MoE config through ``create_train_state``
    and ``make_train_step``, and the import of every training module, with
    ``jax`` and ``matryoshka_mm_tpu`` made unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _TRAIN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def _port_files():
    return sorted(p for p in PORT.rglob("*") if p.suffix in (
        ".py", ".cu", ".cuh", ".cpp")) + [REPO / "chip_smoke.py"]


FORBIDDEN = {
    "scaled_dot_product_attention": re.compile(r"scaled_dot_product_attention"),
    "torch.compile": re.compile(r"torch\s*\.\s*compile\b"),
    "flash_attn package": re.compile(r"\bflash_attn\b"),
}

# the one function of chip_smoke.py that may call PyTorch's own operators: it
# times them as yardsticks beside the kernels and is on no path of the port
YARDSTICKS = "library_ms"


def _without_yardsticks(path: Path) -> str:
    text = path.read_text()
    if path.name != "chip_smoke.py":
        return text
    lines = text.splitlines(keepends=True)
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name == YARDSTICKS:
            lines[node.lineno - 1:node.end_lineno] = [""] * (
                node.end_lineno - node.lineno + 1)
    return "".join(lines)


@pytest.mark.parametrize("what", sorted(FORBIDDEN))
def test_sources_do_not_use(what):
    hits = [str(p.relative_to(REPO)) for p in _port_files()
            if FORBIDDEN[what].search(_without_yardsticks(p))]
    assert not hits, f"{what} in {hits}"


def test_the_yardstick_function_is_called_only_to_fill_library_ms():
    """``library_ms`` may use PyTorch's operators; nothing but the line that
    fills the ``library_ms`` key of a kernel's record calls it."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    assert [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == YARDSTICKS]
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == YARDSTICKS]
    assert calls
    src = (REPO / "chip_smoke.py").read_text().splitlines()
    for c in calls:
        assert "library_ms" in src[c.lineno - 1].split("=")[0], src[
            c.lineno - 1]


def test_sources_import_no_jax():
    bad = []
    for p in _port_files():
        if p.suffix != ".py":
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flax") or top.startswith(
                        "matryoshka_mm_tpu"):
                    bad.append(f"{p.relative_to(REPO)}: {n}")
    assert not bad, bad


def test_sources_import_no_orbax_stack():
    """The card host has neither ``orbax``, ``tensorstore`` nor
    ``zstandard``: the port reads and writes the JAX package's orbax
    checkpoints with ``utils/orbax_io.py`` and its own zstd decoder."""
    bad = []
    for p in _port_files():
        if p.suffix != ".py":
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{p.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("orbax", "tensorstore",
                                           "zstandard")]
    assert not bad, bad


def test_sources_import_no_checkpoint_package_at_module_level():
    """The card host has neither ``safetensors`` nor ``transformers``: the
    port reads safetensors itself and imports ``transformers`` only inside
    the tokenizer fallback."""
    bad = []
    for p in _port_files():
        if p.suffix != ".py":
            continue
        tree = ast.parse(p.read_text())
        everywhere = list(ast.walk(tree))
        for node in everywhere:
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top == "safetensors" or (top == "transformers"
                                            and node in tree.body):
                    bad.append(f"{p.relative_to(REPO)}: {n}")
    assert not bad, bad


_LOAD = """
import sys
for name in ("jax", "matryoshka_mm_tpu", "safetensors", "transformers"):
    sys.modules[name] = None
import numpy as np
from matryoshka_mm_torch.models.builder import load_pretrained_model
tok, model, _, _ = load_pretrained_model(sys.argv[1], device="cpu")
assert type(tok).__name__ == "DebugTokenizer"
ids = np.array([[1, 5, -200, 17, 42]], np.int32)
px = np.zeros((1, 3, 56, 56), np.float32)
out = model.generate(ids, images=px, matryoshka_vis_token_scale="ver=v0_numtoks=4",
                     max_new_tokens=3, eos_token_id=-1)
assert out.shape == (1, 3), out.shape
print("OK", out.tolist())
"""


def test_hf_checkpoint_loads_with_jax_and_checkpoint_packages_blocked(
        tmp_path):
    """A bf16 safetensors directory in the liuhaotian layout (decoder and
    projector; the loader makes the CLIP tower) loads and generates with
    ``jax``, the JAX package, ``safetensors`` and ``transformers`` made
    unimportable (the directory is written here, with the ``safetensors``
    package)."""
    import json

    import torch
    from safetensors.torch import save_file

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.convert import init_params

    cfg = LlavaConfig.tiny_debug()
    p = init_params(cfg, device="cpu", seed=2)
    lm = p["llama"]
    sd = {"model.embed_tokens.weight": lm["embed_tokens"],
          "model.norm.weight": lm["norm"], "lm_head.weight": lm["lm_head"]}
    for i, layer in enumerate(lm["layers"]):
        for group in ("self_attn", "mlp"):
            for k, w in layer[group].items():
                sd[f"model.layers.{i}.{group}.{k}.weight"] = w
        for k in ("input_layernorm", "post_attention_layernorm"):
            sd[f"model.layers.{i}.{k}.weight"] = layer[k]
    for i, layer in enumerate(p["mm_projector"]["layers"]):
        for k in ("weight", "bias"):
            sd[f"model.mm_projector.{2 * i}.{k}"] = layer[k]
    save_file({k: v.to(torch.bfloat16).contiguous() for k, v in sd.items()},
              str(tmp_path / "model.safetensors"))
    vc = cfg.vision
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.llama.vocab_size, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 4,
        "num_attention_heads": 4, "mm_projector_type": "mlp2x_gelu",
        "vision_tower_config": {
            "hidden_size": vc.hidden_size,
            "intermediate_size": vc.intermediate_size,
            "num_hidden_layers": vc.num_hidden_layers,
            "num_attention_heads": vc.num_attention_heads,
            "image_size": vc.image_size, "patch_size": vc.patch_size},
        "config": {"matryoshka_vis_token_scale": "ver=v0_numtoks=[1,4,16]"}}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _LOAD, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_wrappers_have_no_fallback_try():
    """No try/except in a kernel module: a CUDA tensor launches the kernel
    or raises, and never drops to the plain version."""
    for name in ("flash_attention.py", "decode_attention.py",
                 "int4_matmul.py", "fused_mlp.py", "paged_attention.py",
                 "hbm_probe.py"):
        tree = ast.parse((PORT / "ops" / name).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], name

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


def test_tiny_generate_runs_with_jax_blocked():
    """``generate`` and one request through the paged batcher, with ``jax``
    and ``matryoshka_mm_tpu`` made unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def _port_files():
    return sorted(p for p in PORT.rglob("*") if p.suffix in (
        ".py", ".cu", ".cuh")) + [REPO / "chip_smoke.py"]


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


def test_wrappers_have_no_fallback_try():
    """No try/except in a kernel module: a CUDA tensor launches the kernel
    or raises, and never drops to the plain version."""
    for name in ("flash_attention.py", "decode_attention.py",
                 "int4_matmul.py", "fused_mlp.py", "paged_attention.py",
                 "hbm_probe.py"):
        tree = ast.parse((PORT / "ops" / name).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], name

"""The PyTorch port runs with JAX absent, and its sources use no JAX, no
fused attention operator of PyTorch and no ``torch.compile``."""

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
import numpy as np
from matryoshka_mm_torch.models.builder import load_pretrained_model
_, model, _, _ = load_pretrained_model("debug://tiny", device="cpu")
ids = np.array([[1, 5, -200, 17, 42]], np.int32)
px = np.random.default_rng(0).standard_normal((1, 3, 56, 56)).astype(np.float32)
out = model.generate(ids, images=px, matryoshka_vis_token_scale="ver=v0_numtoks=4",
                     max_new_tokens=4, decode_chunk=2, eos_token_id=-1)
assert out.shape == (1, 4), out.shape
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            if sys.modules[m] is not None]
print("OK", out.tolist())
"""


def test_tiny_generate_runs_with_jax_blocked():
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


@pytest.mark.parametrize("what", sorted(FORBIDDEN))
def test_sources_do_not_use(what):
    hits = [str(p.relative_to(REPO)) for p in _port_files()
            if FORBIDDEN[what].search(p.read_text())]
    assert not hits, f"{what} in {hits}"


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
                if top in ("jax", "jaxlib", "flax") or n.startswith(
                        ("matryoshka_mm_tpu.models", "matryoshka_mm_tpu.ops",
                         "matryoshka_mm_tpu.generate",
                         "matryoshka_mm_tpu.eval")):
                    bad.append(f"{p.relative_to(REPO)}: {n}")
    assert not bad, bad


def test_wrappers_have_no_fallback_try():
    """No try/except in a kernel module: a CUDA tensor launches the kernel
    or raises, and never drops to the plain version."""
    for name in ("flash_attention.py", "decode_attention.py"):
        tree = ast.parse((PORT / "ops" / name).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], name

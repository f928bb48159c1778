"""PyTorch port: the JAX package's orbax checkpoints through
``utils/orbax_io.py`` (an OCDBT / zarr reader and writer over the port's
own zstd decoder) and ``utils/checkpoint.py``, held against orbax's
``StandardCheckpointer`` and the JAX package on the CPU.

* The reader gives every leaf of what the JAX ``save_checkpoint`` (with
  ``opt_state``), ``save_projector_only`` and ``save_lora_checkpoint``
  write, bit for bit as ``StandardCheckpointer.restore`` does: a plain and
  an MoE config, a LoRA subset over a ``--bits 4`` base, 0-d leaves, an
  array in many chunks.  ``load_checkpoint`` gives ``params_from_jax`` of
  the JAX tree.
* What the port writes, orbax restores and the JAX ``load_checkpoint``
  loads as the JAX tree it was bridged from, with the same config.
* Greedy tokens agree both ways (float32, 2 layers): the port's
  ``load_pretrained_model`` on the JAX-written fixture, the JAX one on the
  port's save of it.  The committed fixture equals one rebuilt here.
* Every caller of ``load_checkpoint`` on JAX-written directories:
  ``make_delta`` / ``apply_delta`` / ``consolidate`` against the JAX
  functions, the worker's ``--lora-adapters``, and ``train()``'s
  auto-resume from the ``checkpoint-N`` JAX's ``train()`` writes.
* The JAX package's own save and load of a quantized full tree: unpadded
  leaves round-trip (and the port reads them as the JAX tree in memory); a
  padded leaf comes back padded with ``orig_shape`` None (ROADMAP.md
  Queue 3).
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.utils import checkpoint as jck
from matryoshka_mm_torch.models.convert import (params_from_jax,
                                                params_to_jax)
from matryoshka_mm_torch.train.optimizer import named_leaves
from matryoshka_mm_torch.utils import checkpoint as tck
from matryoshka_mm_torch.utils import orbax_io
from tests.torch_orbax_fixture import (FIXTURE, PROMPT, jax_config,
                                       prompt_arrays, write_checkpoint)

MOE = "t=dense_ft=cls_obj=weightedlm"


def _two_layers(cfg):
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_hidden_layers=2))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(jcfg):
    """The port's config of a JAX one (the JSON both packages write)."""
    return tck._cfg_from_json(jck._cfg_to_json(jcfg))


def _seed_lora_b(tree, key):
    """Every ``lora_b`` drawn from ``key`` (``add_lora`` starts it at 0)."""
    if not isinstance(tree, dict):
        return tree
    if "lora_b" in tree:
        b = tree["lora_b"]
        return {**tree, "lora_b": 0.02 * jax.random.normal(key, b.shape,
                                                             b.dtype)}
    return {k: _seed_lora_b(v, jax.random.fold_in(key, i))
            for i, (k, v) in enumerate(sorted(tree.items()))}


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes() \
            if x.dim() else x.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return {v: k for k, v in orbax_io.DTYPES.items()}[x.dtype]
    a = np.asarray(x)
    return "bfloat16" if a.dtype.name == "bfloat16" else a.dtype.str


def assert_same_leaves(got, want, path=""):
    """``got`` (the reader's tree) equals ``want`` (orbax's) in structure,
    shape, dtype and every byte."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_leaves(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_leaves(g, w, f"{path}/{i}")
    elif want is None or isinstance(want, (int, float)):
        assert got == want and type(got) is type(want), path
    else:
        assert tuple(got.shape) == tuple(np.shape(want)), path
        assert _dtype_name(got) == _dtype_name(want), path
        assert _bytes(got) == _bytes(want), path


def assert_same_port(got, want):
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    assert set(got) == set(want)
    for p in want:
        assert got[p].dtype == want[p].dtype and torch.equal(got[p], want[p]), p


def _restore(path):
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """The JAX package's saves: ``{name: (directory, in-memory JAX tree,
    JAX config)}``."""
    from matryoshka_mm_tpu.train import optimizer as jopt
    from matryoshka_mm_tpu.train import trainer as jtrainer

    root = tmp_path_factory.mktemp("jax")
    out = {}
    cfg = jax_config()
    p = init_llava_params(jax.random.PRNGKey(0), cfg)
    state, _ = jtrainer.create_train_state(p, jopt.OptimizerConfig())
    jck.save_checkpoint(str(root / "full"), p, cfg, step=5,
                        opt_state=state.opt_state,
                        extra={"argmaxcost_ema": 0.5})
    out["full"] = (root / "full", p, cfg)
    out["opt_state"] = (root / "full", state.opt_state, cfg)

    mcfg = _two_layers(JaxLlavaConfig.tiny_debug(moe=MOE))
    mp = init_llava_params(jax.random.PRNGKey(1), mcfg)
    jck.save_checkpoint(str(root / "moe"), mp, mcfg, step=2)
    out["moe_full"] = (root / "moe", mp, mcfg)
    jck.save_projector_only(str(root / "proj"), mp, mcfg, step=3)
    out["projector"] = (root / "proj", {"mm_projector": mp["mm_projector"]},
                        mcfg)
    q = maybe_quantize(jax.tree.map(lambda x: x, mp), load_8bit=False,
                       load_4bit=True, fuse=False)
    q = _seed_lora_b(jlora.add_lora(q, jax.random.PRNGKey(2), r=4,
                                    alpha=8.0), jax.random.PRNGKey(3))
    jck.save_lora_checkpoint(str(root / "lora"), q, mcfg, step=4)
    subset = {"lora": jlora.extract_lora(q), "mm_projector": q["mm_projector"],
              "router": q["router"]}
    out["lora_int4"] = (root / "lora", subset, mcfg)
    out["lora_base"] = (None, q, mcfg)

    chunked = {"w": np.random.default_rng(3).standard_normal(
        (37, 50)).astype(np.float32), "b": np.arange(9, dtype=np.int8),
        "s": np.float32(1.5)}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(root / "chunked"), chunked,
               save_args=jax.tree.map(
                   lambda _: ocp.SaveArgs(chunk_byte_size=512), chunked))
    ckptr.wait_until_finished()
    out["chunked"] = (root / "chunked", chunked, None)
    return out


def _sub(dirs, name):
    path, tree, cfg = dirs[name]
    return (path if name == "chunked" else
            path / ("opt_state" if name == "opt_state" else "params")), \
        tree, cfg


@pytest.mark.parametrize("name", ["full", "opt_state", "moe_full",
                                  "projector", "lora_int4", "chunked"])
def test_the_reader_gives_what_orbax_restores(jax_dirs, name):
    path, _, _ = _sub(jax_dirs, name)
    want = _restore(path)
    got = orbax_io.read_tree(path)
    assert_same_leaves(got, want)
    if name == "chunked":
        zarray = json.loads(orbax_io.OcdbtStore(path).read("w/.zarray"))
        assert zarray["chunks"] != zarray["shape"]     # several chunks
    if name == "opt_state":
        assert any(np.ndim(x) == 0 for x in jax.tree.leaves(want))
    lazy = orbax_io.read_tree(path, lazy=True)
    assert all(isinstance(x, (orbax_io.LazyArray, int, float))
               for x in jax.tree.leaves(lazy))


@pytest.mark.parametrize("name", ["full", "moe_full", "projector",
                                  "lora_int4"])
def test_load_checkpoint_bridges_the_jax_tree(jax_dirs, name):
    from matryoshka_mm_torch.config import LlavaConfig

    path, tree, jcfg = jax_dirs[name]
    got, cfg = tck.load_checkpoint(str(path), device="cpu")
    assert isinstance(cfg, LlavaConfig)
    assert cfg.llama.num_hidden_layers == jcfg.llama.num_hidden_layers
    assert cfg.preset.moe == jcfg.preset.moe
    assert_same_port(got, params_from_jax(_np(tree), cfg, device="cpu"))
    meta = tck.load_meta(str(path))
    assert meta["step"] == {"full": 5, "moe_full": 2, "projector": 3,
                            "lora_int4": 4}[name]


@pytest.mark.parametrize("name", ["full", "moe_full", "projector",
                                  "lora_int4"])
def test_orbax_and_jax_read_what_the_port_writes(jax_dirs, tmp_path, name):
    _, tree, jcfg = jax_dirs[name]
    cfg = _port_cfg(jcfg)
    port = params_from_jax(_np(tree), cfg, device="cpu")
    out = str(tmp_path / "port")
    save = {"projector": tck.save_projector_only,
            "lora_int4": tck.save_lora_checkpoint}.get(name)
    if save is None:
        tck.save_checkpoint(out, port, cfg, step=6, opt_state={
            "count": 2, "mu": {"a": torch.ones(3)}})
    elif name == "lora_int4":
        from matryoshka_mm_torch.ops.lora import load_lora, strip_lora

        base = params_from_jax(_np(jax_dirs["lora_base"][1]), cfg,
                               device="cpu")
        assert_same_port(load_lora(strip_lora(base), port["lora"])["llama"],
                         base["llama"])
        save(out, base, cfg, step=6)
    else:
        save(out, port, cfg, step=6)
    want = _np(tree)
    restored = _restore(os.path.join(out, "params"))
    assert_same_leaves(orbax_io.read_tree(os.path.join(out, "params")),
                       restored)
    assert_same_leaves(restored, want)
    assert_same_leaves(params_to_jax(port, cfg), restored)
    jparams, jcfg2 = jck.load_checkpoint(out)
    assert jcfg2 == jcfg
    assert_same_leaves(jparams, want)
    assert tck.load_meta(out)["step"] == 6
    if save is None:
        opt = _restore(os.path.join(out, "opt_state"))
        assert opt["count"] == 2 and np.array_equal(opt["mu"]["a"],
                                                    np.ones(3, np.float32))


def test_greedy_tokens_across_the_two_packages(tmp_path):
    """The fixture rebuilt here equals the committed one (leaves and JAX
    tokens); the port serves the committed JAX checkpoint with the JAX
    tokens, and the JAX package serves the port's save of it with them."""
    from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGen,
                                            generate as jax_generate)
    from matryoshka_mm_tpu.models.builder import (
        load_pretrained_model as jax_load)
    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.models.builder import load_pretrained_model

    recorded = json.loads((FIXTURE / "tokens.json").read_text())
    tokens = write_checkpoint(tmp_path / "again")
    assert tokens == recorded["tokens"]
    assert {k: v for k, v in recorded.items() if k != "tokens"} == PROMPT
    assert_same_leaves(orbax_io.read_tree(FIXTURE / "ckpt" / "params"),
                       orbax_io.read_tree(tmp_path / "again" / "params"))

    ids, px = prompt_arrays()
    scale = PROMPT["matryoshka_vis_token_scale"]
    _, model, _, _ = load_pretrained_model(str(FIXTURE / "ckpt"),
                                           device="cpu")
    assert model.cfg.llama.dtype == "float32"
    got = generate(model.params, model.cfg, ids, px,
                   matryoshka_vis_token_scale=scale,
                   gen_cfg=GenerationConfig(**PROMPT["gen"]))
    assert got.tolist() == recorded["tokens"]

    tck.save_checkpoint(str(tmp_path / "port"), model.params, model.cfg)
    _, jmodel, _, _ = jax_load(str(tmp_path / "port"), device="cpu")
    want = jax_generate(jmodel.params, jmodel.cfg, ids, px,
                        matryoshka_vis_token_scale=scale,
                        gen_cfg=JaxGen(**PROMPT["gen"]))
    assert np.asarray(want).tolist() == recorded["tokens"]


_SERVE = """
import json, sys
for name in ("jax", "matryoshka_mm_tpu", "orbax", "tensorstore",
             "zstandard", "ml_dtypes"):
    sys.modules[name] = None
import numpy as np
from matryoshka_mm_torch.generate import GenerationConfig, generate
from matryoshka_mm_torch.models.builder import load_pretrained_model
root = sys.argv[1]
rec = json.load(open(root + "/tokens.json"))
_, model, _, _ = load_pretrained_model(root + "/ckpt", device="cpu")
ids = np.asarray(rec["input_ids"], np.int32)
px = np.random.default_rng(rec["pixel_seed"]).standard_normal(
    rec["pixel_shape"]).astype(np.float32)
out = generate(model.params, model.cfg, ids, px,
               matryoshka_vis_token_scale=rec["matryoshka_vis_token_scale"],
               gen_cfg=GenerationConfig(**rec["gen"]))
assert out.tolist() == rec["tokens"], (out.tolist(), rec["tokens"])
print("OK")
"""


def test_the_fixture_serves_with_the_orbax_stack_blocked():
    """As on the card host: no JAX, orbax, tensorstore, zstandard or
    ml_dtypes, and the committed JAX checkpoint gives the JAX tokens."""
    import subprocess
    import sys

    repo = FIXTURE.parents[2]
    proc = subprocess.run([sys.executable, "-c", _SERVE, str(FIXTURE)],
                          cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_make_delta_apply_delta_and_consolidate_over_jax_checkpoints(
        jax_dirs, tmp_path):
    from matryoshka_mm_tpu.models import consolidate as jcons
    from matryoshka_mm_tpu.models import make_delta as jdelta
    from matryoshka_mm_torch.models import consolidate as tcons
    from matryoshka_mm_torch.models import make_delta as tdelta

    base_dir, base, cfg = jax_dirs["full"]
    base_dir, d = str(base_dir), lambda name: str(tmp_path / name)
    target = jax.tree.map(lambda x: x * 1.5 + 0.125, base)
    target["llama"]["embed_tokens"] = jnp.concatenate(
        [target["llama"]["embed_tokens"],
         jnp.ones((3, cfg.llama.hidden_size))])      # three more vocab rows
    jck.save_checkpoint(d("target"), target, cfg)

    def same(a, b):
        assert_same_leaves(orbax_io.read_tree(os.path.join(d(a), "params")),
                           orbax_io.read_tree(os.path.join(d(b), "params")))

    jdelta.make_delta(base_dir, d("target"), d("delta_jax"))
    tdelta.make_delta(base_dir, d("target"), d("delta_port"), device="cpu")
    same("delta_port", "delta_jax")
    jdelta.apply_delta(base_dir, d("recon_jax"), d("delta_jax"))
    tdelta.apply_delta(base_dir, d("recon_port"), d("delta_jax"),
                       device="cpu")
    same("recon_port", "recon_jax")
    recon = orbax_io.read_tree(tmp_path / "recon_port" / "params")
    np.testing.assert_allclose(recon["llama"]["embed_tokens"].numpy(),
                               np.asarray(target["llama"]["embed_tokens"]),
                               rtol=1e-6, atol=1e-6)

    jcons.consolidate_ckpt(base_dir, d("cons_jax"))
    tcons.consolidate_ckpt(base_dir, d("cons_port"), device="cpu")
    same("cons_port", "cons_jax")


def test_the_worker_serves_lora_adapters_from_a_jax_checkpoint(
        jax_dirs, tmp_path):
    import sys

    saved = sys.stdout, sys.stderr
    try:
        from matryoshka_mm_torch.serve import model_worker as MW
    finally:
        sys.stdout, sys.stderr = saved
    from matryoshka_mm_torch.serve.multi_lora import pack_adapters

    lora_dir, subset, _ = jax_dirs["lora_int4"]
    _, base, mcfg = jax_dirs["lora_base"]
    jck.save_checkpoint(str(tmp_path / "base"), jlora.strip_lora(base), mcfg)
    w = MW.ModelWorker("http://c", "http://w", "t", True,
                       str(tmp_path / "base"), None, None, device="cpu",
                       continuous_batching=True, max_batch=2,
                       kv_backend="paged", pool_prefill_len=64,
                       pool_max_new=8, lora_adapters=f"a={lora_dir}")
    try:
        cfg = w.model.cfg
        want, names = pack_adapters(
            {"a": params_from_jax(_np(subset), cfg, device="cpu")["lora"]},
            dtype=torch.float32, device="cpu")
        got = w.batcher.lora_pack
        assert w.batcher.lora_names == names and got.n == want.n == 1
        for field in ("a", "b", "s"):
            g, t = getattr(got, field), getattr(want, field)
            assert set(g) == set(t) and g
            assert all(torch.equal(g[k], t[k]) for k in t), field
    finally:
        w.batcher.shutdown()


def test_train_resumes_from_a_jax_checkpoint(jax_dirs, tmp_path,
                                             monkeypatch):
    """The ``checkpoint-N`` the JAX ``train()`` writes (its ``_save``) is
    where the port's ``train()`` starts: the params it builds its state
    from are the JAX checkpoint's, bridged, and its step is N."""
    from PIL import Image

    from matryoshka_mm_tpu.train import train as jtrain
    from matryoshka_mm_tpu.train.trainer import TrainState
    from matryoshka_mm_torch.train import train as ttrain

    cfg = JaxLlavaConfig.tiny_debug()
    p = init_llava_params(jax.random.PRNGKey(5), cfg)
    out = tmp_path / "out"
    out.mkdir()
    jtrain._save(types.SimpleNamespace(output_dir=str(out), lora_enable=False,
                                       save_total_limit=0),
                 types.SimpleNamespace(tune_mm_mlp_adapter=True),
                 TrainState(step=2, params=p, opt_state=None,
                            argmaxcost_ema=jnp.float32(-1)), cfg, 2)
    assert sorted(os.listdir(out)) == ["checkpoint-2"]

    (tmp_path / "img").mkdir()
    Image.new("RGB", (48, 48), (180, 40, 40)).save(tmp_path / "img" / "r.jpg")
    rows = [{"id": str(i), "image": "r.jpg", "conversations": [
        {"from": "human", "value": "<image>\nWrite a caption."},
        {"from": "gpt", "value": f"a red square {i}"}]} for i in range(2)]
    (tmp_path / "d.json").write_text(json.dumps(rows))
    seen = {}
    create = ttrain.create_train_state

    def spy(params, opt_cfg):
        seen["params"] = {"mm_projector": jax.tree.map(
            lambda t: t.detach().clone(), params["mm_projector"])}
        return create(params, opt_cfg)

    monkeypatch.setattr(ttrain, "create_train_state", spy)
    state = ttrain.train(argv=[
        "--model_name_or_path", "debug://tiny", "--data_path",
        str(tmp_path / "d.json"), "--image_folder", str(tmp_path / "img"),
        "--device", "cpu", "--per_device_train_batch_size", "2",
        "--model_max_length", "128", "--report_to", "none",
        "--matryoshka_vis_token_scale", "ver=v0_numtoks=[1,4]",
        "--version", "plain", "--tune_mm_mlp_adapter", "True",
        "--output_dir", str(out), "--num_train_epochs", "2"])
    assert_same_port(seen["params"], params_from_jax(
        {"mm_projector": _np(p["mm_projector"])}, _port_cfg(cfg),
        device="cpu"))
    assert state.step == 3


def test_the_jax_quantized_full_round_trip_drops_orig_shape(tmp_path):
    """The JAX package's own save + load of a quantized full tree.  Leaves
    the kernels' tiles do not pad round-trip, and the port reads them as
    ``params_from_jax`` reads the tree in memory.  A padded leaf (here the
    ``down_proj`` of a 1,100-wide MLP: 550 bytes a row, padded to 1,024)
    comes back padded, with ``orig_shape`` None: orbax stores nothing for
    the static ``LogicalShape`` node (ROADMAP.md Queue 3)."""
    cfg = _two_layers(JaxLlavaConfig.tiny_debug())
    p = init_llava_params(jax.random.PRNGKey(6), cfg)
    q = maybe_quantize(jax.tree.map(lambda x: x, p), load_8bit=False,
                       load_4bit=True, fuse=True)
    jck.save_checkpoint(str(tmp_path / "q"), q, cfg)
    back, _ = jck.load_checkpoint(str(tmp_path / "q"))
    assert_same_leaves(_np(back), _np(q))
    got, tcfg = tck.load_checkpoint(str(tmp_path / "q"), device="cpu")
    assert_same_port(got, params_from_jax(_np(q), tcfg, device="cpu"))

    wide = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, intermediate_size=1100))
    p = init_llava_params(jax.random.PRNGKey(7), wide)
    q = maybe_quantize(jax.tree.map(lambda x: x, p), load_8bit=False,
                       load_4bit=True, fuse=True)
    down = q["llama"]["layers"]["mlp"]["down_proj"]
    assert down["orig_shape"].k == 1100 and down["qint4"].shape[-1] == 1024
    jck.save_checkpoint(str(tmp_path / "wide"), q, wide)
    back, _ = jck.load_checkpoint(str(tmp_path / "wide"))
    down = back["llama"]["layers"]["mlp"]["down_proj"]
    assert down["orig_shape"] is None and down["qint4"].shape[-1] == 1024


@pytest.mark.parametrize("bits", [4, 8])
def test_load_pretrained_model_quantizes_a_native_checkpoint(tmp_path, bits):
    """``load_4bit`` / ``load_8bit`` over a checkpoint directory quantize
    what it holds, as over ``debug://``; a checkpoint saved quantized loads
    as it is."""
    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.ops.quant import quantize_llama_params

    cfg = _port_cfg(_two_layers(JaxLlavaConfig.tiny_debug()))
    assert isinstance(cfg, LlavaConfig)
    params = init_params(cfg, device="cpu", seed=4)
    tck.save_checkpoint(str(tmp_path / "a"), params, cfg)
    kw = {"load_4bit": bits == 4, "load_8bit": bits == 8}
    _, model, _, _ = load_pretrained_model(str(tmp_path / "a"), device="cpu",
                                           **kw)
    want = quantize_llama_params(params, bits=bits)
    assert_same_port(model.params, want)
    tck.save_checkpoint(str(tmp_path / "q"), want, cfg)
    _, again, _, _ = load_pretrained_model(str(tmp_path / "q"), device="cpu",
                                           **kw)
    assert_same_port(again.params, want)

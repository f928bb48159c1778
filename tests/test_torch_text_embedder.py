"""PyTorch port: the BERT text embedder of the router's ``textcls`` feature
(``models/text_embedder.py``) against the JAX package and a random-init
``transformers.BertModel``, and ``train()`` with ``--moe
t=dense_ft=textcls`` against the JAX ``train()`` on ``debug://tiny``.

Tolerances (float32 on the CPU): hidden states ``1e-5`` against JAX and
``2e-4`` against HF on the unpadded positions (the JAX test's); the
normalized embedding ``1e-5``; the train losses ``1e-4`` relative.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import transformers

from matryoshka_mm_tpu.models import builder as jax_builder
from matryoshka_mm_tpu.models import text_embedder as jte
from matryoshka_mm_torch.models import builder
from matryoshka_mm_torch.models import text_embedder as tte
from matryoshka_mm_torch.models.convert import bert_params_from_jax

CFG = tte.BertConfig.tiny_debug()


def _jax_bert(seed=0):
    jp = jte.init_bert_params(jax.random.PRNGKey(seed), jte.BertConfig.tiny_debug())
    return jp, bert_params_from_jax(jax.tree.map(np.asarray, jp), CFG,
                                    device="cpu")


def _ids():
    ids = np.array([[101, 5, 9, 14, 102, 0, 0],
                    [101, 44, 102, 0, 0, 0, 0]], np.int32)
    return ids, (ids != 0).astype(np.int32)


def test_configs_and_names():
    assert tte.BertConfig.bge_small() == tte.BertConfig()
    assert dataclass_fields(tte.BertConfig.tiny_debug()) == \
        dataclass_fields(jte.BertConfig.tiny_debug())
    assert dataclass_fields(tte.BertConfig.bge_small()) == \
        dataclass_fields(jte.BertConfig.bge_small())
    assert tte.TEXT_EMBEDDERS == jte.TEXT_EMBEDDERS
    assert tte.PROMPT_PATTERN.pattern == jte.PROMPT_PATTERN.pattern


def dataclass_fields(c):
    import dataclasses
    return dataclasses.asdict(c)


def test_init_bert_params_shapes():
    p = tte.init_bert_params(torch.Generator().manual_seed(0), CFG,
                             device="cpu")
    _, bridged = _jax_bert()
    flat = lambda t, pre="": (
        {k2: v2 for k, v in t.items() for k2, v2 in
         flat(v, f"{pre}{k}/").items()} if isinstance(t, dict) else
        {k2: v2 for i, v in enumerate(t) for k2, v2 in
         flat(v, f"{pre}{i}/").items()} if isinstance(t, list) else
        {pre: (tuple(t.shape), t.dtype)})
    assert flat(p) == flat(bridged)
    assert float(p["layers"][0]["attention"]["query"]["weight"].std()) \
        == pytest.approx(0.02, rel=0.2)


def test_bert_forward_matches_jax():
    jp, tp = _jax_bert(3)
    ids, mask = _ids()
    want = np.asarray(jte.bert_forward(jp, jte.BertConfig.tiny_debug(),
                                       jnp.asarray(ids), jnp.asarray(mask)))
    got = tte.bert_forward(tp, CFG, torch.from_numpy(ids),
                           torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bert_forward_matches_hf_bert():
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()
    params = tte.convert_bert(hf.state_dict(), CFG, device="cpu")
    ids, mask = _ids()
    with torch.no_grad():
        want = hf(torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long()
                  ).last_hidden_state.numpy()
        got = tte.bert_forward(params, CFG, torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[0, :5], want[0, :5], atol=2e-4)
    np.testing.assert_allclose(got[1, :3], want[1, :3], atol=2e-4)
    # and the JAX converter reads the same state dict into the same model
    jparams = jte.convert_bert(hf.state_dict(), jte.BertConfig.tiny_debug())
    jgot = np.asarray(jte.bert_forward(jparams, jte.BertConfig.tiny_debug(),
                                       jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got, jgot, atol=1e-5, rtol=0)


def test_extract_prompts():
    texts = ["system stuff USER: What is this? ASSISTANT: A cat.",
             "no marker here", "USER:\n  two\nlines ASSISTANT:"]
    assert tte.extract_prompts(texts) == jte.extract_prompts(texts) == \
        ["What is this?", "", "two\nlines"]


def test_text_embedder_end_to_end_as_jax():
    """Decode, extract, the word-hash tokenizer (the same ``hash`` in one
    process), BERT, CLS normalized: the port's embedder on the JAX BERT's
    bridged parameters gives JAX's embedding."""
    jp, tp = _jax_bert(1)
    texts = ["sys USER: what color is it? ASSISTANT:",
             "sys USER: <image>\ncount the red squares ASSISTANT: 3"]

    class Tok(builder.DebugTokenizer):
        def batch_decode(self, batch, skip_special_tokens=True):
            assert (np.asarray(batch) >= 0).all()    # sentinels stripped
            return texts

    class JTok(jax_builder.DebugTokenizer):
        def batch_decode(self, batch, skip_special_tokens=True):
            return texts

    ids = np.array([[1, 200, -200, 202], [1, 5, 6, 7]], np.int32)
    want = np.asarray(jte.TextEmbedder(JTok(512), params=jp,
                                       cfg=jte.BertConfig.tiny_debug())(ids))
    emb = tte.TextEmbedder(Tok(512), params=tp, cfg=CFG)
    got = emb(ids)
    assert got.shape == (2, 32) and got.dtype == torch.float32
    assert emb.hidden_size == 32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)
    # without params: a random BERT from seed 0 on the named device
    fresh = tte.TextEmbedder(Tok(512), cfg=CFG, device="cpu")
    assert fresh.device.type == "cpu"
    assert torch.isfinite(fresh(ids)).all()


def _train_data(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    Image.new("RGB", (48, 48), (180, 40, 40)).save(img_dir / "r.jpg")
    rows = [{"id": str(i), "image": "r.jpg", "conversations": [
        {"from": "human", "value": "<image>\nWrite a caption for it."},
        {"from": "gpt", "value": f"a red square number {i} " + "very " * i},
    ]} for i in range(4)]
    path = tmp_path / "train.json"
    path.write_text(json.dumps(rows))
    return ["--model_name_or_path", "debug://tiny", "--data_path", str(path),
            "--image_folder", str(img_dir),
            "--per_device_train_batch_size", "2", "--learning_rate", "1e-3",
            "--model_max_length", "128", "--report_to", "none",
            "--matryoshka_vis_token_scale", "ver=v0_numtoks=[1,4,16]",
            "--moe", "t=dense_ft=textcls_obj=weightedlm",
            "--num_train_epochs", "1", "--save_steps", "100"]


def test_train_with_the_textcls_router_matches_jax(tmp_path, monkeypatch):
    """Both ``train()`` entry points, two steps on the same parameters: the
    port's model and BERT are the JAX ones bridged.  The JAX ``train()``
    keeps ``text_embed_dim`` 384 under the tiny BERT's 32-wide embedding
    and cannot build that router, so its config is given the port's
    width here, and its debug tokenizer the port's span."""
    import dataclasses

    from matryoshka_mm_tpu.train import train as jtrain
    from matryoshka_mm_torch.models.convert import params_from_jax
    from matryoshka_mm_torch.train import train as ttrain

    seen = {}
    real_cfg, real_init = jtrain.build_llava_config, jtrain.init_llava_params
    real_emb = jte.TextEmbedder

    def jcfg(*a, **kw):
        return dataclasses.replace(real_cfg(*a, **kw), text_embed_dim=32)

    def jinit(*a, **kw):
        params = real_init(*a, **kw)
        # host copies: the train step donates the device arrays
        seen["params"] = jax.tree.map(np.array, params)
        return params

    class JEmb(real_emb):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["bert"] = jax.tree.map(np.array, self.params)

    # one device, as the port trains on one: the JAX train() multiplies the
    # batch by the device count
    real_devices = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **kw: real_devices(*a, **kw)[:1])
    monkeypatch.setattr(jtrain, "build_llava_config", jcfg)
    # the port's debug tokenizer spans the tiny model's vocabulary, the JAX
    # one 32,000 ids: the same span on both sides gives the same batches
    monkeypatch.setattr(jax_builder, "_load_tokenizer",
                        lambda *a, **kw: jax_builder.DebugTokenizer(512))
    monkeypatch.setattr(jtrain, "init_llava_params", jinit)
    monkeypatch.setattr(jte, "TextEmbedder", JEmb)
    args = _train_data(tmp_path)
    monkeypatch.setattr("sys.argv", ["train"] + args + [
        "--output_dir", str(tmp_path / "jax")])
    jtrain.train()
    monkeypatch.setattr(jax, "devices", real_devices)

    def tparams(model_args, training_args, cfg, device):
        return params_from_jax(seen["params"], cfg, device="cpu"), cfg

    real_temb = tte.TextEmbedder

    class TEmb(real_temb):
        def __init__(self, tok, cfg=None, device="cuda"):
            super().__init__(tok, cfg=cfg, device=device,
                             params=bert_params_from_jax(
                                 seen["bert"], cfg, device=device))

    monkeypatch.setattr(ttrain, "_build_params", tparams)
    monkeypatch.setattr(tte, "TextEmbedder", TEmb)
    state = ttrain.train(argv=args + ["--output_dir", str(tmp_path / "pt"),
                                      "--device", "cpu"])
    assert state.step == 2

    def losses(out):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f]

    want, got = losses(tmp_path / "jax"), losses(tmp_path / "pt")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert "router" in state.params and got[0] != got[1]

"""The float32 reference holds the program's plain path at a tiny size, for
the Mistral and the MPT family, and the float8 control departs from it by
far more than the program in bfloat16 does."""

import numpy as np
import pytest
import torch

from h100_bench import traffic
from h100_bench.reference import model as ref
from h100_bench.reference.spec import model_spec
from h100_bench.weights import make_weights
from tiny import tiny_configs


def _setup(family, dtype="float32", seed=3, vocab=512):
    from h100_bench.port_config import llava_config

    cfg = tiny_configs(dtype, vocab=vocab)[f"tiny-{family}"]
    spec = model_spec(cfg)
    w = make_weights(spec, seed, torch.device("cpu"))
    return cfg, spec, w, llava_config(spec, cfg)


@pytest.mark.parametrize("family", ["mistral", "mpt"])
def test_reference_holds_the_program_plain_path(family):
    from matryoshka_mm_torch.models.clip import clip_vision_forward
    from matryoshka_mm_torch.models.llava import forward_spliced, \
        prepare_multimodal, project

    cfg, spec, w, pcfg = _setup(family)
    px = torch.as_tensor(traffic.image_pool(7, 2, 56))
    want = clip_vision_forward(w["vision_tower"], px, pcfg.vision)["patch"]
    got = ref.clip_patch_features(w["vision_tower"], px, spec.vision)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    for i, n in enumerate((4, 16)):
        want = project(w, pcfg, px[i:i + 1], n)["image_features"][0]
        got = ref.image_tokens(w, spec, px[i:i + 1], [n])[0]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    ids = traffic.prompt_ids(7, 0, 9, spec.decoder.vocab, traffic.IMAGE_TOKEN)
    served = [5, 17, 300, 2, 44]
    full = np.concatenate([ids, np.asarray([served[:-1]], np.int32)], 1)
    spliced, _ = prepare_multimodal(w, pcfg, torch.as_tensor(full).long(),
                                    px[:1], numtoks=4,
                                    out_len=full.shape[1] - 1 + 4)
    want = forward_spliced(w, pcfg, spliced)[0]
    got = ref.served_logits(w, spec, traffic.IMAGE_TOKEN, [ids[0].tolist()],
                            px[:1], [4], [served])[0]
    t0 = ids.shape[1] - 1 + 4
    torch.testing.assert_close(got, want[t0 - 1:t0 - 1 + len(served)],
                               rtol=1e-4, atol=1e-4)


def test_fp8_control_departs_far_more_than_bfloat16():
    """At a tiny size in bfloat16 (a vocabulary of 8,192, so near-ties
    occur) the program's widest gap over 256 positions stays a small
    fraction of what the float8 control reads on the same tokens."""
    from matryoshka_mm_torch.models.llava import forward_spliced, \
        prepare_multimodal

    cfg, spec, w, pcfg = _setup("mistral", "bfloat16", vocab=8192)
    px = torch.as_tensor(traffic.image_pool(9, 4, 56))
    prog, ctrl = [], []
    for i in range(4):
        ids = traffic.prompt_ids(9, i, 12, spec.decoder.vocab,
                                 traffic.IMAGE_TOKEN)
        toks = traffic.rng(9, i).integers(3, spec.decoder.vocab, 64).tolist()
        full = np.concatenate([ids, np.asarray([toks[:-1]], np.int32)], 1)
        spliced, _ = prepare_multimodal(w, pcfg, torch.as_tensor(full).long(),
                                        px[i:i + 1], numtoks=16,
                                        out_len=full.shape[1] - 1 + 16)
        t0 = ids.shape[1] - 1 + 16
        lg = forward_spliced(w, pcfg, spliced)[0][t0 - 1:t0 - 1 + len(toks)]
        r32 = ref.served_logits(w, spec, traffic.IMAGE_TOKEN,
                                [ids[0].tolist()], px[i:i + 1], [16],
                                [toks])[0]
        r8 = ref.served_logits(w, spec, traffic.IMAGE_TOKEN,
                               [ids[0].tolist()], px[i:i + 1], [16], [toks],
                               lin=ref.fp8_linear)[0]
        prog.append(ref.gap_of(r32, lg.argmax(-1).tolist()).max())
        ctrl.append(ref.gap_of(r32, r8.argmax(-1).tolist()).max())
    assert max(ctrl) > 3 * max(prog), (prog, ctrl)

"""On the card: the serving entry at a small size that the kernels take
(head size 128, bfloat16) comes out correct, and not correct with its
tokens altered where they are produced.  Marked ``cuda``; each test
decides inside itself whether there is a card."""

import pytest
import torch

from tiny import make_copy


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-mistral-serve", "tiny-mpt-serve"])
def test_serving_entry_on_the_card(tmp_path, monkeypatch, cell):
    dev = _card()
    import matryoshka_mm_torch.generate as gen
    import matryoshka_mm_torch.serve.batching as batching

    from h100_bench import run

    root = make_copy(tmp_path, dtype="bfloat16", limit=0.05, head_dim=128)
    good = run.run_cell(root, cell, 2 ** 31 + 3, 2.0, True, dev, 0.0)
    assert good["correct"], good["checks"]
    assert good["device"]["busy_s"] > 0
    pick = gen._select_token

    def altered(logits, *a, **k):
        return (pick(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(gen, "_select_token", altered)
    monkeypatch.setattr(batching, "_select_token", altered)
    bad = run.run_cell(root, cell, 2 ** 31 + 3, 2.0, False, dev, 0.0)
    assert not bad["correct"], bad["checks"]

"""The generator gives every seed the same work in another order, and one
seed the same inputs every time."""

import json

import numpy as np

from h100_bench import traffic
from tiny import ROOT

MIX = json.loads((ROOT / "h100_bench" / "traffic" /
                  "serve-mixed.json").read_text())


def _sizes(reqs):
    return [sorted(getattr(r, k) for r in reqs)
            for k in ("text_tokens", "new_tokens", "scale")]


def test_one_seed_repeats_and_seeds_reorder_the_same_work():
    a = traffic.open_loop_schedule(MIX, 12.0, 40.0, 2 ** 31 + 7)
    b = traffic.open_loop_schedule(MIX, 12.0, 40.0, 2 ** 31 + 7)
    c = traffic.open_loop_schedule(MIX, 12.0, 40.0, 3)
    assert [(r.due_s, r.text_tokens, r.new_tokens, r.scale) for r in a] == \
        [(r.due_s, r.text_tokens, r.new_tokens, r.scale) for r in b]
    n = MIX["block"] * (min(len(a), len(c)) // MIX["block"])
    assert _sizes(a[:n]) == _sizes(c[:n])
    assert [r.new_tokens for r in a[:n]] != [r.new_tokens for r in c[:n]]
    # every block offers exactly block / rate seconds of arrivals
    blk = MIX["block"]
    assert abs(a[blk].due_s - blk / 12.0) < 1e-9


def test_lengths_scales_and_rate():
    reqs = traffic.open_loop_schedule(MIX, 10.0, 60.0, 11)
    assert abs(len(reqs) - 600) <= 1
    assert min(r.text_tokens for r in reqs) >= 16
    assert max(r.text_tokens for r in reqs) <= 384
    assert min(r.new_tokens for r in reqs) >= 8
    assert max(r.new_tokens for r in reqs) <= 256
    counts = np.bincount([MIX["scales"].index(r.scale) for r in reqs[:400]])
    assert set(counts) == {80}
    assert all(b.due_s > a.due_s for a, b in zip(reqs, reqs[1:]))


def test_prompt_ids_and_images():
    ids = traffic.prompt_ids(5, 3, 20, 512, traffic.IMAGE_TOKEN)
    assert ids.shape == (1, 22) and ids[0, 1] == traffic.IMAGE_TOKEN
    assert ((ids[0, 2:] >= 3) & (ids[0, 2:] < 512)).all()
    assert (ids == traffic.prompt_ids(5, 3, 20, 512, -200)).all()
    px = traffic.image_pool(5, 2, 14)
    assert px.shape == (2, 3, 14, 14) and px.dtype == np.float32
    assert (px == traffic.image_pool(5, 2, 14)).all()


def test_eval_batches_cycle_scales():
    mix = {"rows": 4, "scales": [1, 9, 36], "text_tokens":
           {"dist": "loguniform", "low": 24, "high": 96}}
    bs = list(traffic.eval_batches(mix, 7, 2))
    assert [b.scale for b in bs] == [1, 9, 36, 1, 9, 36, 1]
    cyc = sorted(x for b in bs[:3] for x in b.text_tokens)
    assert cyc == sorted(x for b in bs[3:6] for x in b.text_tokens)


def test_percentile_is_numpys_linear():
    assert traffic.percentile([1, 2, 3, 4], 50) == 2.5
    assert np.isnan(traffic.percentile([], 95))

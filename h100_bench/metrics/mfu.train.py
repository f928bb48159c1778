"""Train step (``train/trainer.py`` ``make_train_step``): the step's model
FLOPs (``work.train_step_flops``: the frozen tower forward, the projector
and the LoRA pairs forward and backward, the frozen decoder forward and its
activation gradients, the head on the labelled tokens; no recomputation)
over the median untraced step's host seconds (each step ends in a
synchronize) times the card's bf16 peak, in percent."""

import statistics

from h100_bench import work


def read(run):
    w = run["window"]
    times = [t for t, tr in zip(w["step_s"], w["traced"]) if not tr]
    if not times:
        return None
    spec, k = run["ctx"].spec, w["work"]
    flops = work.train_step_flops(
        spec.decoder.shape(), spec.vision_shape(), k["rows"], k["labelled"],
        k["images"], k["lora_per_layer"])
    return 100.0 * flops / (statistics.median(times) * work.PEAK_BF16_FLOPS)

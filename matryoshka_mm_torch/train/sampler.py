"""Length-grouped batch sampling.

numpy port of the reference's samplers (reference: llava/train/
llava_trainer.py:66-251): length grouping, modality-aware grouping (text
vs multimodal batches kept separate), variable-length grouping, and the
split-to-even-chunks balancing across data-parallel ranks.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def split_to_even_chunks(indices: List[int], lengths: List[int],
                         num_chunks: int) -> List[List[int]]:
    """Greedy balancing by total length (reference: llava_trainer.py:66-85)."""
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    num_indices_per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    chunks_lengths = [0 for _ in range(num_chunks)]
    for index in indices:
        shortest_chunk = chunks_lengths.index(min(chunks_lengths))
        chunks[shortest_chunk].append(index)
        chunks_lengths[shortest_chunk] += lengths[index]
        if len(chunks[shortest_chunk]) == num_indices_per_chunk:
            chunks_lengths[shortest_chunk] = float("inf")
    return chunks


def get_length_grouped_indices(lengths, batch_size, world_size,
                               generator: Optional[np.random.Generator] = None,
                               ) -> List[int]:
    """reference: llava_trainer.py:144-164."""
    generator = generator or np.random.default_rng()
    indices = generator.permutation(len(lengths)).tolist()
    megabatch_size = world_size * batch_size
    megabatches = [indices[i:i + megabatch_size]
                   for i in range(0, len(lengths), megabatch_size)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    return [i for mb in megabatches for batch in mb for i in batch]


def get_modality_length_grouped_indices(lengths, batch_size, world_size,
                                        generator=None) -> List[int]:
    """Multimodal (len>0) and text-only (len<0) samples batched separately
    (reference: llava_trainer.py:104-141)."""
    generator = generator or np.random.default_rng()
    assert all(l != 0 for l in lengths), "Should not have zero length."
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(lengths, batch_size, world_size, generator)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mm_indices, mm_lengths = zip(*mm)
    lang_indices, lang_lengths = zip(*lang)

    mm_shuffle = [mm_indices[i] for i in get_length_grouped_indices(
        mm_lengths, batch_size, world_size, generator)]
    lang_shuffle = [lang_indices[i] for i in get_length_grouped_indices(
        lang_lengths, batch_size, world_size, generator)]
    megabatch_size = world_size * batch_size
    mm_megabatches = [mm_shuffle[i:i + megabatch_size]
                      for i in range(0, len(mm_shuffle), megabatch_size)]
    lang_megabatches = [lang_shuffle[i:i + megabatch_size]
                        for i in range(0, len(lang_shuffle), megabatch_size)]
    additional_batch = mm_megabatches[-1] + lang_megabatches[-1]
    megabatches = mm_megabatches[:-1] + lang_megabatches[:-1]
    order = generator.permutation(len(megabatches)).tolist()
    megabatches = [megabatches[i] for i in order]
    if len(additional_batch) > 0:
        megabatches.append(sorted(additional_batch))
    return [i for mb in megabatches for i in mb]


def get_variable_length_grouped_indices(lengths, batch_size, world_size,
                                        megabatch_mult: int = 8,
                                        generator=None) -> List[int]:
    """reference: llava_trainer.py:88-101."""
    generator = generator or np.random.default_rng()
    indices = generator.permutation(len(lengths))
    sorted_indices = sorted(range(len(lengths)), key=lambda i: lengths[i],
                            reverse=True)
    megabatch_size = world_size * batch_size * megabatch_mult
    megabatches = [sorted_indices[i:i + megabatch_size]
                   for i in range(0, len(lengths), megabatch_size)]
    megabatches = [sorted(m, key=lambda i: indices[i], reverse=True)
                   for m in megabatches]
    shuffled = [i for m in megabatches for i in m]
    world_batch_size = world_size * batch_size
    batches = [shuffled[i:i + world_batch_size]
               for i in range(0, len(lengths), world_batch_size)]
    order = generator.permutation(len(batches)).tolist()
    return [i for bi in order for i in batches[bi]]


class LengthGroupedSampler:
    """reference: llava_trainer.py:210-251."""

    def __init__(self, batch_size: int, world_size: int, lengths=None,
                 generator=None, variable_length: bool = False,
                 group_by_modality: bool = False):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = lengths
        self.generator = generator
        self.variable_length = variable_length
        self.group_by_modality = group_by_modality

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        if self.variable_length:
            assert not self.group_by_modality
            indices = get_variable_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size,
                generator=self.generator)
        elif self.group_by_modality:
            indices = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size,
                generator=self.generator)
        else:
            indices = get_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size,
                generator=self.generator)
        return iter(indices)

"""Multi-LoRA serving, PyTorch port of
``matryoshka_mm_tpu/serve/multi_lora.py``: many adapters on one shared base
model in one batched decode pool.

Adapters (``ops/lora.py`` ``extract_lora`` trees, all of one rank and one
target set) are packed per layer into device tensors; adapter index 0 means
"base model" and stands for an all-zero adapter.  Each pool row carries an
adapter index, and every decoder projection adds the row's low-rank delta

    y = proj(x, W)  +  (x · A[idx]ᵀ · B[idx]ᵀ) * scale[idx]

with A ``(r, in)`` and B ``(out, r)`` in peft's orientations.

The JAX package's :func:`lora_delta` gathers ``A[idx]`` and ``B[idx]``,
a per-row copy of a whole adapter in every projection.  The pool's decode
takes the read-once form instead (:func:`group_deltas`), which computes the
same sums with exact zeros in place of the other adapters' terms:

* one product of ``x`` against the concatenated A of every live adapter
  (q, k and v share ``x`` and so one product, and so do gate and up);
* a per-row mask that keeps each row's own ``r`` columns
  (:func:`row_mask`; index 0 keeps none);
* one product per projection against the concatenated B, the scale folded
  in when the pack is built, which also adds the base projection's output
  (``addmm``).

So a step reads each adapter's bytes once, whatever the number of rows,
in three kernels a group and one more a projection: the A rows of a
group are stored projection-major, so each projection's masked columns
are a strided view of the one product, not a copy.
The base model's slot 0 is never stored: it would only add zeros to the
products.  :meth:`AdapterPack.gather_form` rebuilds the JAX layout, slot 0
included, for :func:`lora_delta`.

The prefill attaches the requested adapter onto the base tree with
``ops.lora.load_lora`` (the batcher caches one tree per adapter).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

PROJS = (("self_attn", "q_proj"), ("self_attn", "k_proj"),
         ("self_attn", "v_proj"), ("self_attn", "o_proj"),
         ("mlp", "gate_proj"), ("mlp", "up_proj"), ("mlp", "down_proj"))

# projections that multiply the same input: one A product each group
GROUPS = {"qkv": PROJS[0:3], "o": PROJS[3:4], "gateup": PROJS[4:6],
          "down": PROJS[6:7]}


@dataclasses.dataclass
class AdapterPack:
    """The live adapters, packed per layer for the read-once products.

    ``a[group]``: ``(n_layers, P, n, r, D_in)``, the A of the group's ``P``
    projections; ``b[(mod, proj)]``: ``(n_layers, D_out, n, r)``, B times
    the adapter's scale; ``s[(mod, proj)]``: ``(n_layers, n)`` float32
    scales.  ``n`` is the number of adapters; index ``i`` of a row is
    adapter ``i - 1`` here."""

    a: Dict[str, torch.Tensor]
    b: Dict[Tuple[str, str], torch.Tensor]
    s: Dict[Tuple[str, str], torch.Tensor]
    rank: int
    n: int

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for d in (self.a, self.b) for t in d.values())

    def gather_form(self, layer: int, key: Tuple[str, str]):
        """The JAX package's per-layer slices of one projection: ``(A
        (n + 1, r, D_in), B (n + 1, D_out, r), s (n + 1, 1, 1))`` with an
        all-zero adapter 0 and B unscaled."""
        group = next(g for g, ks in GROUPS.items() if key in ks)
        a = self.a[group][layer][GROUPS[group].index(key)]
        s = self.s[key][layer]
        b = (self.b[key][layer].float()
             / s[None, :, None].clamp_min(1e-30)).to(a.dtype).transpose(0, 1)

        def zero_first(t):
            return torch.cat([torch.zeros_like(t[:1]), t])

        return (zero_first(a), zero_first(b),
                zero_first(s.view(-1, 1, 1)).to(a.dtype))


def _layers_of(tree: dict) -> list:
    """The per-layer list of an adapter tree (the full tree with a
    ``"llama"`` key, or the decoder's subtree)."""
    layers = tree.get("llama", tree).get("layers")
    if not isinstance(layers, list):
        raise ValueError("an adapter tree needs the decoder's per-layer list "
                         "(extract_lora of the port's parameters)")
    return layers


def _leaf(layer: dict, mod: str, proj: str, name: str) -> dict:
    try:
        return layer[mod][proj]
    except (KeyError, TypeError):
        raise ValueError(
            f"adapter {name!r} has no {mod}/{proj} leaf: multi-LoRA serving "
            f"packs every LLaMA projection ({', '.join(p for _, p in PROJS)})"
        ) from None


def pack_adapters(adapters: Dict[str, dict], *,
                  dtype: Optional[torch.dtype] = None, device=None
                  ) -> Tuple[Optional[AdapterPack], Dict[Optional[str], int]]:
    """Pack named adapter trees -> ``(pack, name -> index)``; index 0 is
    the base model and the names follow in sorted order.  Adapters of
    different ranks raise ``ValueError``.  ``dtype`` / ``device`` default
    to the first A leaf's."""
    if not adapters:
        return None, {}
    names = sorted(adapters)
    name_to_idx: Dict[Optional[str], int] = {None: 0}
    name_to_idx.update({n: i + 1 for i, n in enumerate(names)})
    trees = [_layers_of(adapters[n]) for n in names]
    n_layers = len(trees[0])
    if any(len(t) != n_layers for t in trees):
        raise ValueError("adapters disagree on the number of layers: "
                         f"{sorted({len(t) for t in trees})}")
    n = len(names)
    leaves = [{key: [_leaf(layers[li], *key, name)
                     for name, layers in zip(names, trees)] for key in PROJS}
              for li in range(n_layers)]
    for key in PROJS:
        ranks = {int(leaf["lora_a"].shape[-2])
                 for layer in leaves for leaf in layer[key]}
        if len(ranks) != 1:
            raise ValueError(f"adapters disagree on rank for {key[0]}/"
                             f"{key[1]}: {sorted(ranks)}")
    first = leaves[0][PROJS[0]][0]["lora_a"]
    dtype = dtype or first.dtype
    device = torch.device(device) if device is not None else first.device

    a = {g: [] for g in GROUPS}
    b = {key: [] for key in PROJS}
    s = {key: [] for key in PROJS}
    for layer in leaves:
        for group, keys in GROUPS.items():
            a[group].append(torch.stack([
                torch.stack([layer[key][i]["lora_a"] for i in range(n)])
                for key in keys]).to(device=device, dtype=dtype))
        for key in PROJS:
            scale = torch.stack([leaf["lora_scale"].reshape(()).float()
                                 for leaf in layer[key]]).to(device)
            s[key].append(scale)
            b[key].append(torch.stack(
                [leaf["lora_b"].to(device).float() * scale[i]
                 for i, leaf in enumerate(layer[key])], dim=1).to(dtype))
    a = {g: torch.stack(v) for g, v in a.items()}
    b = {key: torch.stack(v) for key, v in b.items()}
    s = {key: torch.stack(v) for key, v in s.items()}
    rank = a["qkv"].shape[-2]
    return AdapterPack(a, b, s, rank, n), name_to_idx


def row_mask(pack: AdapterPack, lora_idx: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``(B, n)`` ones where row ``b`` uses adapter ``i + 1``: a row's index
    selects its own adapter's columns, index 0 none."""
    live = torch.arange(1, pack.n + 1, device=lora_idx.device)
    return (lora_idx.long()[:, None] == live[None]).to(dtype)


def group_deltas(pack: AdapterPack, layer: int, group: str,
                 x: torch.Tensor, mask: torch.Tensor,
                 bases: Optional[List[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
    """The read-once deltas of one group's projections at one layer:
    ``x (B, S, D_in)``, ``mask`` from :func:`row_mask` -> one ``(B, S,
    D_out)`` tensor per projection of ``GROUPS[group]``, in ``x.dtype``.
    With ``bases``, the projections' own outputs in that order, each delta
    is added to its base by the B product itself: the adapted outputs."""
    B, S, _ = x.shape
    a = pack.a[group][layer]                         # (P, n, r, D_in)
    P, n, r, d_in = a.shape
    t = F.linear(x, a.view(P * n * r, d_in).to(x.dtype))
    t = t.view(B, S, P, n, r) * mask.to(x.dtype)[:, None, None, :, None]
    out = []
    for p, key in enumerate(GROUPS[group]):
        rows = t[:, :, p].reshape(B * S, n * r)      # a strided view
        bm = pack.b[key][layer]                      # (D_out, n, r)
        bt = bm.view(bm.shape[0], n * r).to(x.dtype).t()
        y = rows @ bt if bases is None else torch.addmm(
            bases[p].reshape(B * S, bm.shape[0]), rows, bt)
        out.append(y.view(B, S, bm.shape[0]))
    return out


def lora_delta(x: torch.Tensor, layer_a: torch.Tensor, layer_b: torch.Tensor,
               layer_s: torch.Tensor, lora_idx: torch.Tensor) -> torch.Tensor:
    """The JAX package's per-row delta of one projection, by gather:
    ``x (B, S, D_in)``, ``layer_a (n + 1, r, D_in)``, ``layer_b (n + 1,
    D_out, r)``, ``layer_s (n + 1, 1, 1)`` (:meth:`AdapterPack.gather_form`),
    ``lora_idx (B,)`` -> ``(B, S, D_out)``.  Kept as the plain version of
    :func:`group_deltas`."""
    idx = lora_idx.long()
    A = layer_a[idx].to(x.dtype)                     # (B, r, D_in)
    Bm = layer_b[idx].to(x.dtype)                    # (B, D_out, r)
    t = torch.einsum("bsd,brd->bsr", x, A)
    return torch.einsum("bsr,bor->bso", t, Bm) * layer_s[idx].to(x.dtype)

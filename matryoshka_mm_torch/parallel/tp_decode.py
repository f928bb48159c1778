"""Tensor-parallel inference with the kernels kept: port of
``matryoshka_mm_tpu/parallel/tp_decode.py``.

Every rank runs the single-card decoder path of ``models/llama.py``, the
hand-written kernels included, on its Megatron-style shard:

* q/k/v row-sharded by heads, o_proj column-sharded: attention is local to
  a rank's heads, and its KV cache holds those heads only;
* gate/up row-sharded by the MLP width, down_proj column-sharded;
* the o_proj and MLP outputs summed over the ranks before their residual
  adds (``LlamaConfig.tp_axis``, set by :func:`local_llama_cfg`), and the
  vocabulary-sharded lm_head's logits gathered here;
* the embedding table and the norms replicated.

Quantized weights shard exactly: the values are sliced after quantizing
(per-output-channel scales), and an int4 K-shard (o, down) is unpacked to
its signed values, sliced and packed again in the split-half e8m layout of
its own width (``ops/quant.py`` ``int4_k_shard``): a relayout of the nibbles,
no requantization.  Each rank then fuses q/k/v and gate/up of its shard
(``_fuse_layer_projections``), so the fused decode kernels run on it.

The ranks (the JAX package drives every device from one process):

* the caller's process is rank 0; :class:`TPEngine` starts tp - 1 follower
  processes with the ``spawn`` start method;
* each follower is handed the whole decoder tree at its start (a CUDA
  tensor crosses as an IPC handle and a CPU tensor as shared memory, so
  nothing is copied), cuts its own shard onto its device and drops the
  rest; rank 0 keeps the whole model (the vision tower, the projector and
  the splice run there only) and a shard of its own;
* every call: rank 0 prepares the prompt (splice, router), tells the
  followers its shapes through a pipe and broadcasts the embeddings and
  positions; every rank runs the same prefill and decode steps; rank 0
  picks each token from the gathered logits with its generator and
  broadcasts it; rank 0 tells the followers how many steps each chunk has
  and when the request ends;
* the ranks meet through a file store in a temporary directory (no port);
  NCCL with ``cuda:r`` for rank r where the card count is at least tp,
  gloo where ``devices=`` puts several ranks on one card or on the CPU,
  which the caller says with ``backend="gloo"``;
* a follower that dies makes rank 0 raise: before each call (its process
  is checked), within a collective (gloo fails at once when the peer's
  socket closes; any backend at ``TIMEOUT_S``) and while rank 0 waits on
  its pipe (``TIMEOUT_S``).  ``close()``, or the exit of the caller's
  process, stops the followers.

The decode steps run eagerly: a gloo collective cannot be captured in a
CUDA graph.  Launch counters are per process: :meth:`TPEngine.
launch_counts` reads every rank's.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import itertools
import os
import shutil
import tempfile
import threading
import time
import traceback
import weakref
from typing import List, Optional

import numpy as np
import torch
import torch.multiprocessing as mp

from ..config import LlamaConfig, LlavaConfig, torch_dtype
from ..generate import (GATE, GenerationConfig, _gate_scale, _round_up,
                        _select_token, _trim)
from ..kvconfig import parse_kv_from_string
from ..models.llama import (embed_tokens, init_kv_cache, llama_forward,
                            lm_head)
from ..models.llava import prepare_multimodal
from ..ops.quant import (Q4KEY, QKEY, _fuse_layer_projections,
                         int4_k_shard, is_quantized)
from .collectives import TPGroup, register, unregister

_ROW_LEAVES = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
               "lm_head")
_COL_LEAVES = ("o_proj", "down_proj")
# the longest wait on a follower: its start (a spawn, ~8 s on the card
# host, and its shard of a 7B model), a collective, a reply
TIMEOUT_S = 120.0
# the longest a call waits for the calls and streams before it (the
# worker lets 5 requests in at once)
WAIT_S = 600.0


# ---------------------------------------------------------------------------
# parameter sharding (exact)
# ---------------------------------------------------------------------------

def _own(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that shares nothing."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _rows(x: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous share of the rows (output channels) of
    ``(..., N, K)``."""
    N = x.shape[-2]
    if N % tp:
        raise ValueError(f"{tuple(x.shape)}: {N} rows over tp={tp}")
    n = N // tp
    return x[..., rank * n:(rank + 1) * n, :]


def _cols(x: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous share of the columns (inputs) of
    ``(..., N, K)``."""
    K = x.shape[-1]
    if K % tp:
        raise ValueError(f"{tuple(x.shape)}: {K} columns over tp={tp}")
    k = K // tp
    return x[..., rank * k:(rank + 1) * k]


def _shard_quant_rows(leaf: dict, tp: int, rank: int, device) -> dict:
    key = Q4KEY if Q4KEY in leaf else QKEY
    return {key: _own(_rows(leaf[key], tp, rank), device),
            "scale": _own(_rows(leaf["scale"], tp, rank), device)}


def _shard_quant_cols(leaf: dict, tp: int, rank: int, device) -> dict:
    """Column (K) shard of a quantized leaf.  int8 slices the bytes; int4
    unpacks the split-half nibbles to the signed values in logical column
    order, slices, and packs the shard's own split-half layout: the values
    are untouched (exact), only the bytes move.  The scales are per output
    channel, so every rank keeps them whole."""
    scale = _own(leaf["scale"], device)
    if QKEY in leaf:
        return {QKEY: _own(_cols(leaf[QKEY], tp, rank), device),
                "scale": scale}
    return {Q4KEY: _own(int4_k_shard(leaf[Q4KEY], tp, rank), device),
            "scale": scale}


def _shard_leaf(name: str, leaf, tp: int, rank: int, device):
    if name in _ROW_LEAVES:
        return (_shard_quant_rows(leaf, tp, rank, device)
                if is_quantized(leaf) else _own(_rows(leaf, tp, rank),
                                                device))
    if name in _COL_LEAVES:
        return (_shard_quant_cols(leaf, tp, rank, device)
                if is_quantized(leaf) else _own(_cols(leaf, tp, rank),
                                                device))
    return _own(leaf, device)     # norms and other small leaves


def _check_tree(llama_params: dict, cfg: LlamaConfig) -> None:
    """The refusals of :func:`shard_llama_tp`, before any work."""
    if cfg.arch == "mpt":
        raise NotImplementedError(
            "TP inference supports llama/mistral decoders (MPT's alibi "
            "path has no kernel to preserve; run it on one card)")
    for layer in llama_params["layers"]:
        if "qkv_proj" in layer.get("self_attn", {}) \
                or "gateup_proj" in layer.get("mlp", {}):
            raise ValueError(
                "shard_llama_tp needs the unfused layout: quantize with "
                "fuse=False (each rank's shard is fused again here)")
        for part in layer.values():
            if isinstance(part, dict) and any(
                    isinstance(v, dict) and "lora_a" in v
                    for v in part.values()):
                raise ValueError("shard_llama_tp takes no LoRA leaves: "
                                 "merge the adapters first")


def shard_llama_tp(llama_params: dict, cfg: LlamaConfig, tp: int,
                   rank: int, device=None,
                   fuse: Optional[bool] = None) -> dict:
    """Rank ``rank``'s shard under ``tp``-way sharding of an UNFUSED llama
    tree (bf16 / float32, or quantized with ``fuse=False``), as new
    tensors on ``device`` (the tree's by default): ``layers`` (a list) and
    ``norm``, and ``lm_head`` row-sharded by the vocabulary (the embedding
    table's rows where the head is tied to it).  ``embed_tokens`` is left
    out: it stays whole.  When the tree is quantized and ``fuse`` is not
    False, the shard's q/k/v and gate/up are fused, the layout
    ``quantize_llama_params`` gives on one card."""
    _check_tree(llama_params, cfg)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} of tp={tp}")
    if device is None:
        device = llama_params["embed_tokens"].device

    def rec(tree: dict) -> dict:
        out = {}
        for k, v in tree.items():
            out[k] = rec(v) if isinstance(v, dict) and not is_quantized(v) \
                else _shard_leaf(k, v, tp, rank, device)
        return out

    layers = [rec(layer) for layer in llama_params["layers"]]
    head = llama_params.get("lm_head", llama_params["embed_tokens"])
    sharded = {"layers": layers,
               "norm": _own(llama_params["norm"], device),
               "lm_head": _shard_leaf("lm_head", head, tp, rank, device)}
    if fuse is not False:
        for layer in layers:
            a, m = layer["self_attn"], layer["mlp"]
            leaves = [a[n] for n in ("q_proj", "k_proj", "v_proj")] \
                + [m[n] for n in ("gate_proj", "up_proj")]
            if all(is_quantized(v) for v in leaves):
                _fuse_layer_projections(
                    layer, Q4KEY if Q4KEY in a["q_proj"] else QKEY)
    return sharded


def local_llama_cfg(cfg: LlamaConfig, tp: int, axis: str = "") -> LlamaConfig:
    """One rank's view of the decoder config under ``tp``-way sharding;
    ``axis`` names its registered TP group (``parallel/collectives.py``)."""
    H, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if H % tp or Hkv % tp or cfg.intermediate_size % tp \
            or cfg.vocab_size % tp:
        raise ValueError(
            f"tp={tp} must divide heads ({H}), kv heads ({Hkv}), ffn "
            f"({cfg.intermediate_size}) and vocab ({cfg.vocab_size})")
    return dataclasses.replace(
        cfg, num_attention_heads=H // tp, num_key_value_heads=Hkv // tp,
        intermediate_size=cfg.intermediate_size // tp,
        head_dim_override=cfg.head_dim, tp_axis=axis)


# ---------------------------------------------------------------------------
# what every rank runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RankState:
    """One rank's part: its shard (``local``, with the whole embedding
    table), the local config, its device and its group."""

    rank: int
    tp: int
    local: dict
    cfg_local: LlamaConfig
    device: torch.device
    group: Optional[TPGroup] = None

    @classmethod
    def build(cls, rank: int, tp: int, llama_params: dict, cfg: LlavaConfig,
              axis: str, device) -> "RankState":
        device = torch.device(device)
        local = shard_llama_tp(llama_params, cfg.llama, tp, rank, device)
        local["embed_tokens"] = _own(llama_params["embed_tokens"], device)
        return cls(rank, tp, local, local_llama_cfg(cfg.llama, tp, axis),
                   device)


@dataclasses.dataclass(frozen=True)
class _Shapes:
    """What a follower needs to receive rank 0's broadcasts."""

    B: int
    L: int
    dtype: str
    capacity: int


@torch.inference_mode()
def _prefill(state: RankState, shapes: _Shapes, prep=None):
    """Every rank: rank 0's embeddings, positions, mask and lengths
    (``prep``, rank 0 only) broadcast, then the prefill on this rank's
    shard -> (gathered last-position logits (B, V) f32, cache, lengths)."""
    B, L, dev = shapes.B, shapes.L, state.device
    D = state.local["embed_tokens"].shape[1]
    if state.rank == 0:
        embeds, pos, valid, lengths = prep
        embeds = embeds.contiguous()
        ints = torch.cat([pos.to(torch.int32), valid.to(torch.int32),
                          lengths.to(torch.int32)[:, None]], dim=1)
    else:
        embeds = torch.empty((B, L, D), dtype=torch_dtype(shapes.dtype),
                             device=dev)
        ints = torch.empty((B, 2 * L + 1), dtype=torch.int32, device=dev)
    state.group.broadcast(embeds)
    state.group.broadcast(ints)
    pos, valid, lengths = ints[:, :L], ints[:, L:2 * L].bool(), ints[:, 2 * L]
    cache = init_kv_cache(state.cfg_local, B, shapes.capacity, device=dev)
    hidden, cache = llama_forward(state.local, state.cfg_local, embeds,
                                  position_ids=pos, attn_valid=valid,
                                  cache=cache)
    # this rank's rows of the vocabulary: every rank's logits, in order
    logits = state.group.all_gather(
        lm_head(state.local, hidden[:, -1:, :]))[:, 0]
    return logits, cache, lengths


def _choose(state: RankState, logits: torch.Tensor,
            gen_cfg: GenerationConfig, generator) -> torch.Tensor:
    """Rank 0 picks the tokens with its generator; every rank gets them."""
    if state.rank == 0:
        tok = _select_token(logits, gen_cfg, generator).contiguous()
    else:
        tok = torch.empty(logits.shape[0], dtype=torch.int32,
                          device=state.device)
    return state.group.broadcast(tok)


def _step_logits(state: RankState, cache, token, lengths,
                 finished) -> torch.Tensor:
    """One decode step of ``token`` (B,) on this rank's shard -> the
    gathered logits (B, V) f32; the cache advances in place."""
    embeds = embed_tokens(state.local, token[:, None])
    hidden, _ = llama_forward(state.local, state.cfg_local, embeds,
                              position_ids=lengths[:, None],
                              attn_valid=~finished[:, None], cache=cache)
    return state.group.all_gather(
        lm_head(state.local, hidden[:, 0:1, :]))[:, 0]


@torch.inference_mode()
def _step(state: RankState, gen_cfg: GenerationConfig, cache, token,
          lengths, finished, generator=None):
    """One decode step on this rank's shard (``generate.py``
    ``_decode_step`` with the gathered logits and rank 0's pick)."""
    logits = _step_logits(state, cache, token, lengths, finished)
    nxt = _choose(state, logits, gen_cfg, generator)
    nxt = torch.where(finished, gen_cfg.pad_token_id, nxt)
    return nxt, lengths + 1, finished | (nxt == gen_cfg.eos_token_id)


@torch.inference_mode()
def _forced(state: RankState, shapes: _Shapes, tokens: np.ndarray,
            prep=None) -> torch.Tensor:
    """Every rank: the prefill, then a decode step on each column of
    ``tokens`` (B, n) in turn -> the gathered logits (B, n + 1, V) f32."""
    logits, cache, lengths = _prefill(state, shapes, prep)
    out = [logits]
    finished = torch.zeros(shapes.B, dtype=torch.bool, device=state.device)
    for token in torch.as_tensor(tokens, device=state.device).unbind(1):
        out.append(_step_logits(state, cache, token, lengths, finished))
        lengths = lengths + 1
    return torch.stack(out, 1)


def _follow(state: RankState, conn, shapes: _Shapes,
            gen_cfg: Optional[GenerationConfig]) -> None:
    """A follower's part of one call: the prefill, then (unless the call
    wants the prefill's logits only) the first token and the decode steps
    rank 0 asks for, chunk by chunk, until it says the request ended."""
    logits, cache, lengths = _prefill(state, shapes)
    if gen_cfg is None:
        return
    token = _choose(state, logits, gen_cfg, None)
    finished = token == gen_cfg.eos_token_id
    while True:
        msg = conn.recv()
        if msg[0] == "end":
            return
        for _ in range(msg[1]):
            token, lengths, finished = _step(state, gen_cfg, cache, token,
                                             lengths, finished)


def _launch_counts(state: RankState) -> dict:
    """This process's launch counters of the kernels on the TP path."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_launch_counts(state: RankState) -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _wrappers() -> dict:
    from ..ops.decode_attention import flash_decode_attention
    from ..ops.flash_attention import flash_attention_lse
    from ..ops.fused_mlp import quant_mlp
    from ..ops.int4_matmul import int4_matmul, int8_matmul

    return {"flash_attention": flash_attention_lse,
            "decode_attention": flash_decode_attention,
            "int4_matmul": int4_matmul, "int8_matmul": int8_matmul,
            "quant_mlp": quant_mlp}


def _follower_main(rank: int, tp: int, store: str, backend: str,
                   device: str, box: list, cfg: LlavaConfig, axis: str,
                   conn) -> None:
    """A follower process: cut the shard from the whole tree in ``box``
    (emptied, so that no reference to rank 0's tensors outlives the cut),
    join the group, then serve rank 0's calls until it says ``close`` or
    goes away."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        state = RankState.build(rank, tp, box.pop(), cfg, axis, dev)
        conn.send(("ready", None))
        state.group = TPGroup(store, rank, tp, backend, TIMEOUT_S)
        register(axis, state.group)
        while True:
            msg = conn.recv()
            if msg[0] == "close":
                return
            if msg[0] == "prefill":
                _follow(state, conn, *msg[1:])
            elif msg[0] == "forced":
                _forced(state, *msg[1:])
            elif msg[0] == "call":
                conn.send(("result", msg[1](state, *msg[2:])))
    except EOFError:
        return                      # rank 0 has gone
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

_NAMES = itertools.count()


def _plan(dev0: torch.device, tp_size: Optional[int], devices,
          backend: Optional[str]):
    """``(tp, devices, backend)``; anything left to a guess raises."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        tp = tp_size or len(devices)
        if len(devices) != tp:
            raise ValueError(f"tp_size={tp} with {len(devices)} devices")
    elif dev0.type == "cpu":
        if not tp_size:
            raise ValueError("TPEngine on the CPU: give tp_size")
        tp, devices = tp_size, [dev0] * tp_size
    else:
        n = torch.cuda.device_count()
        tp = tp_size or n
        if tp > n:
            raise ValueError(
                f"tp={tp} ranks need {tp} cards and {n} are visible: pass "
                f"devices= (with backend='gloo' for several ranks on one "
                f"card)")
        devices = [torch.device("cuda", i) for i in range(tp)]
    devices = [torch.device(d.type, d.index if d.index is not None
                            else torch.cuda.current_device())
               if d.type == "cuda" else d for d in devices]
    if devices[0] != dev0:
        raise ValueError(f"rank 0 runs on the parameters' device {dev0}, "
                         f"not {devices[0]}")
    distinct_cards = all(d.type == "cuda" for d in devices) \
        and len(set(devices)) == tp
    if backend is None:
        if any(d.type == "cuda" for d in devices) and not distinct_cards:
            raise ValueError("several ranks on one card: NCCL refuses "
                             "them; pass backend='gloo'")
        backend = "nccl" if distinct_cards else "gloo"
    if backend == "nccl" and not distinct_cards:
        raise ValueError("backend='nccl' needs one card a rank")
    return tp, devices, backend


class TPEngine:
    """Tensor-parallel generation over ``tp`` ranks with the single-card
    kernels intact.  Covers fixed ``numtoks`` and ``gateprobargmax``,
    text-only prompts and one image a row, any batch size, greedy and
    sampled decoding.  ``ver=v2``, anyres tiles, multi-image prompts and
    MPT raise ``NotImplementedError``, as in the JAX package: run those
    on one card.

    ``params`` is the LLaVA tree on rank 0's device; its decoder must be
    unfused (quantize with ``fuse=False``).  ``devices`` gives each rank's
    device (default ``cuda:0`` ... ``cuda:tp-1``, or the CPU for a CPU
    tree); ``backend`` is ``"nccl"`` (one card a rank, the default there)
    or ``"gloo"`` (several ranks on one card, which must be asked for, and
    the CPU).  ``TIMEOUT_S`` bounds every wait on a follower, ``WAIT_S``
    a call's wait for the calls before it."""

    def __init__(self, params: dict, cfg: LlavaConfig,
                 tp_size: Optional[int] = None, *, devices=None,
                 backend: Optional[str] = None):
        llama = params["llama"]
        dev0 = llama["embed_tokens"].device
        self.tp, self.devices, self.backend = _plan(dev0, tp_size, devices,
                                                    backend)
        self.params, self.cfg, self.device = params, cfg, dev0
        self.axis = f"tp{os.getpid()}.{next(_NAMES)}"
        local_llama_cfg(cfg.llama, self.tp)   # both raise before any rank
        _check_tree(llama, cfg.llama)         # starts
        self._procs: List = []
        self._conns: List = []
        self._lock = threading.Lock()
        self._broken: Optional[str] = None
        self._closed = False
        self._dir = tempfile.mkdtemp(prefix="m3_tp_")
        store = os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        try:
            for r in range(1, self.tp):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_follower_main, name=f"m3-tp-rank{r}",
                    args=(r, self.tp, store, self.backend,
                          str(self.devices[r]), [llama], cfg, self.axis,
                          child), daemon=True)
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
            self.state = RankState.build(0, self.tp, llama, cfg, self.axis,
                                         dev0)
            for r in range(1, self.tp):
                self._recv(r, "ready")
            if dev0.type == "cuda":
                # the followers have dropped their handles on the tree
                torch.cuda.ipc_collect()
            self.state.group = TPGroup(store, 0, self.tp, self.backend,
                                       TIMEOUT_S)
            register(self.axis, self.state.group)
        except BaseException:
            self.close()
            raise
        ref = weakref.ref(self)
        self._atexit = lambda: ref() is not None and ref().close()
        atexit.register(self._atexit)

    # -- the followers --------------------------------------------------
    def _check(self) -> None:
        if self._closed:
            raise RuntimeError("TPEngine is closed")
        if self._broken:
            raise RuntimeError(f"TPEngine is broken: {self._broken}")
        for r, proc in enumerate(self._procs, 1):
            if not proc.is_alive():
                self._broken = f"rank {r} exited with code {proc.exitcode}"
                raise RuntimeError(f"TPEngine: {self._broken}")

    def _send(self, msg) -> None:
        self._check()
        for r, conn in enumerate(self._conns, 1):
            try:
                conn.send(msg)
            except OSError as e:
                self._broken = f"rank {r}'s pipe: {e!r}"
                raise RuntimeError(f"TPEngine: {self._broken}") from e

    def _recv(self, r: int, kind: str):
        """The next message of rank ``r``, which must be ``kind``; a dead
        follower, its error or ``TIMEOUT_S`` of silence raises."""
        conn, proc = self._conns[r - 1], self._procs[r - 1]
        deadline = time.monotonic() + TIMEOUT_S
        while not conn.poll(0.05):
            if not proc.is_alive() and not conn.poll(0):
                self._broken = f"rank {r} exited with code {proc.exitcode}"
                raise RuntimeError(f"TPEngine: {self._broken}")
            if time.monotonic() > deadline:
                self._broken = f"rank {r} silent for {TIMEOUT_S} s"
                raise RuntimeError(f"TPEngine: {self._broken}")
        try:
            msg = conn.recv()
        except EOFError:
            msg = ("error", "its pipe closed")
        if msg[0] != kind:
            self._broken = f"rank {r} failed"
            raise RuntimeError(f"TPEngine: rank {r} failed:\n{msg[1]}")
        return msg[1]

    def _failed(self, exc: BaseException) -> RuntimeError:
        """The error to raise after a call failed on rank 0: a follower's
        own traceback where one came."""
        self._broken = self._broken or repr(exc)
        for r, conn in enumerate(self._conns, 1):
            try:
                if conn.poll(1.0):
                    msg = conn.recv()
                    if msg[0] == "error":
                        return RuntimeError(f"TPEngine: rank {r} failed:\n"
                                            f"{msg[1]}")
            except (OSError, EOFError):
                pass
        return RuntimeError(f"TPEngine: a call failed on rank 0 ({exc!r})")

    def call(self, fn, *args) -> list:
        """``fn(state, *args)`` on every rank (a module-level function:
        it is pickled to the followers), results in rank order."""
        with self._serial():
            self._send(("call", fn) + args)
            own = fn(self.state, *args)
            return [own] + [self._recv(r, "result")
                            for r in range(1, self.tp)]

    def launch_counts(self) -> list:
        """Every rank's launch counters of the TP path's kernels."""
        return self.call(_launch_counts)

    def reset_launch_counts(self) -> None:
        self.call(_reset_launch_counts)

    def close(self) -> None:
        """Stop the followers and release the group; idempotent."""
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.send(("close",))
            except OSError:
                pass
        for proc in self._procs:
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        for conn in self._conns:
            conn.close()
        unregister(self.axis)
        shutil.rmtree(self._dir, ignore_errors=True)
        if getattr(self, "_atexit", None) is not None:
            atexit.unregister(self._atexit)

    @contextlib.contextmanager
    def _serial(self):
        """One call or stream at a time: a later one waits for the ranks
        (a stream's chunks may be pulled from any thread) and raises after
        ``WAIT_S``, as a call made where an open stream can never end
        would otherwise hang."""
        if not self._lock.acquire(timeout=WAIT_S):
            raise RuntimeError(
                f"TPEngine: waited {WAIT_S} s for the call or stream "
                f"before this one: finish or close an open stream first")
        try:
            yield
        finally:
            self._lock.release()

    # -- rank 0's prompt ------------------------------------------------
    @torch.inference_mode()
    def _prep(self, input_ids, pixel_values, attention_mask, spec,
              max_new_tokens: int):
        """Rank 0's splice of one call -> (shapes, (embeds, positions,
        mask, lengths)); the modes the engine does not cover raise here,
        before any rank hears of the call."""
        params, cfg, dev = self.params, self.cfg, self.device
        ids_np = np.asarray(input_ids, np.int64)
        B, T = ids_np.shape
        numtoks = None
        if spec:
            kvs = parse_kv_from_string(spec)
            if kvs.get("ver") == "v2":
                raise NotImplementedError(
                    "ver=v2 combine-logits under TP: run it on one card")
            numtoks = GATE if kvs["numtoks"] == GATE \
                else int(kvs["numtoks"])
        px = None
        if pixel_values is not None:
            pv = np.asarray(pixel_values, np.float32)
            if pv.ndim != 4 or pv.shape[0] != B:
                raise NotImplementedError(
                    "TP generation covers text-only prompts and one image "
                    "a row; anyres tiles and multi-image prompts run on "
                    "one card")
            px = torch.as_tensor(pv, device=dev)
        if numtoks == GATE:
            if B != 1:
                raise ValueError("gateprobargmax supports batch_size=1 only")
            numtoks = _gate_scale(params, cfg, px)
        ids = torch.as_tensor(ids_np, device=dev)
        mask = None if attention_mask is None else torch.as_tensor(
            np.asarray(attention_mask, bool), device=dev)
        if px is None:
            L = _round_up(T, 64)
            pad = L - T
            m = torch.ones((B, T), dtype=torch.bool, device=dev) \
                if mask is None else mask
            m = torch.nn.functional.pad(m, (pad, 0))
            embeds = embed_tokens(params["llama"],
                                  torch.nn.functional.pad(ids, (pad, 0)))
            pos = torch.clamp(m.int().cumsum(dim=1) - 1, min=0)
            prep = (embeds, pos, m, m.int().sum(dim=1))
        else:
            n = numtoks if numtoks is not None else cfg.vision.num_patches
            L = _round_up(T - 1 + n, 64)
            spliced, _ = prepare_multimodal(
                params, cfg, ids, px, numtoks=n, attn_mask=mask, out_len=L,
                padding_side="left")
            prep = (spliced.embeds, spliced.position_ids, spliced.attn_mask,
                    torch.clamp(spliced.lengths, max=L))
        return _Shapes(B, L, cfg.llama.dtype, L + max_new_tokens), prep

    # -- calls ------------------------------------------------------------
    def prefill(self, input_ids, pixel_values=None, *, attention_mask=None,
                matryoshka_vis_token_scale=None) -> torch.Tensor:
        """One prefill on every rank -> the gathered last-position logits
        (B, V) float32 on rank 0's device."""
        with self._serial():
            shapes, prep = self._prep(input_ids, pixel_values,
                                      attention_mask,
                                      matryoshka_vis_token_scale, 1)
            self._send(("prefill", shapes, None))
            try:
                return _prefill(self.state, shapes, prep)[0]
            except Exception as e:
                raise self._failed(e) from e

    def forced_logits(self, input_ids, pixel_values, tokens, *,
                      attention_mask=None,
                      matryoshka_vis_token_scale=None) -> torch.Tensor:
        """Teacher forcing: the gathered logits (B, n + 1, V) float32 of
        the prefill's last position and of a decode step on each column
        of ``tokens`` (B, n) in turn, on rank 0's device: the decode path
        held against one card's without its own picks."""
        tokens = np.asarray(tokens, np.int32)
        with self._serial():
            shapes, prep = self._prep(input_ids, pixel_values,
                                      attention_mask,
                                      matryoshka_vis_token_scale,
                                      tokens.shape[1])
            self._send(("forced", shapes, tokens))
            try:
                return _forced(self.state, shapes, tokens, prep)
            except Exception as e:
                raise self._failed(e) from e

    def generate(self, input_ids, pixel_values=None, *, image_sizes=None,
                 attention_mask=None, matryoshka_vis_token_scale=None,
                 gen_cfg: Optional[GenerationConfig] = None,
                 stopping_criteria=None, generator=None) -> np.ndarray:
        """Blocking TP generation -> the (B, <= max_new_tokens) generated
        suffixes, as ``generate.generate``."""
        out = None
        for out in self.stream_generate(
                input_ids, pixel_values, image_sizes=image_sizes,
                attention_mask=attention_mask,
                matryoshka_vis_token_scale=matryoshka_vis_token_scale,
                gen_cfg=gen_cfg, stopping_criteria=stopping_criteria,
                generator=generator):
            pass
        return out

    def stream_generate(self, input_ids, pixel_values=None, *,
                        image_sizes=None, attention_mask=None,
                        matryoshka_vis_token_scale=None,
                        gen_cfg: Optional[GenerationConfig] = None,
                        stopping_criteria=None, generator=None):
        """A generator of the cumulative generated ids (B, n), trimmed as
        ``generate`` trims them, after the first token and after every
        decode chunk (what the worker's solo path streams).  Sampling
        draws from ``generator`` (a new one seeded with 0 on rank 0's
        device when None), as ``generate.generate``.  Closing it early
        ends the request on every rank."""
        gen_cfg = gen_cfg or GenerationConfig()
        with self._serial():
            shapes, prep = self._prep(input_ids, pixel_values,
                                      attention_mask,
                                      matryoshka_vis_token_scale,
                                      gen_cfg.max_new_tokens)
            if generator is None and gen_cfg.do_sample:
                generator = torch.Generator(
                    device=self.device).manual_seed(0)
            self._send(("prefill", shapes, gen_cfg))
            in_decode = False
            try:
                logits, cache, lengths = _prefill(self.state, shapes, prep)
                token = _choose(self.state, logits, gen_cfg, generator)
                in_decode = True
                finished = token == gen_cfg.eos_token_id
                out_tokens = [token.cpu().numpy()[:, None]]
                yield _trim(out_tokens[0], gen_cfg)
                steps_done = 1
                while steps_done < gen_cfg.max_new_tokens:
                    n = min(gen_cfg.decode_chunk,
                            gen_cfg.max_new_tokens - steps_done)
                    self._send(("steps", n))
                    toks = []
                    for _ in range(n):
                        token, lengths, finished = _step(
                            self.state, gen_cfg, cache, token, lengths,
                            finished, generator)
                        toks.append(token)
                    steps_done += n
                    out_tokens.append(torch.stack(toks, 1).cpu().numpy())
                    out = np.concatenate(out_tokens, axis=1)
                    yield _trim(out, gen_cfg)
                    if bool(finished.all()):
                        break
                    if stopping_criteria is not None and \
                            stopping_criteria(list(out[0])):
                        break
            except GeneratorExit:
                raise
            except Exception as e:
                in_decode = False
                raise self._failed(e) from e
            finally:
                if in_decode and not self._broken:
                    self._send(("end",))

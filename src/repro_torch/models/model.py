"""The decoder, dense, mixture-of-experts, SSM or RG-LRU hybrid:
parameters, cache, the fused prefill and the decode step.

Counterpart of the dense, MoE, SSM and hybrid families of the JAX
package's ``models/model.py`` (``init``, ``init_cache``, ``prefill`` with
``seq_lens``, ``decode_step`` with ``advance_mask``, ``reference_decode``
with stepwise or fused prefill, ``window_for``, ``kv_quant_effective``
and ``paging_effective``). Each layer's kind is ``cfg.layer_pattern()``'s:
"attn", "ssm" or "rglru". An MoE config (``cfg.is_moe``) has a ``"moe"``
FFN in each layer where a dense one has ``"mlp"`` (``models/moe.py``), in
bf16 or f32 weights only. An SSM config (mamba2) has ``{"norm", "ssm"}``
layers (``models/ssm.py``) and no attention. A hybrid config
(recurrentgemma) interleaves RG-LRU layers (``{"attn_norm", "rglru",
"ffn_norm", "mlp"}``, ``models/hybrid.py``) with local-attention layers
(``"attn"`` in place of ``"rglru"``), each with a GeGLU FFN; its attention
window is ``cfg.local_attn_window`` whatever the length, and its
attention layers keep a ring of ``min(max_len, window)`` positions.

The recurrent families (``cfg.is_recurrent``: SSM and hybrid) share a
serving contract: a cache of a fixed size a slot (the conv and
recurrent states, and the hybrid's rings), never paged and never
quantized (``kv_quant`` is a no-op, as in the JAX package: the hybrid's
rings stay bf16), and a prefill that starts from zero states and runs at
its exact length (a prompt longer than ``max_len`` too; the hybrid's
rings then take the ring write). ``cache_axes`` and the audio and vlm
families are not ported yet.

A windowed config (``sliding_window`` > 0, mistral-7b; or any dense
config past ``max_full_attn`` positions) keeps a ring of ``min(max_len,
window)`` positions a slot, never paged. A prefill longer than its cache
(a windowed prompt past the ring, or a resumed request past
``max_len``) writes its last ring-length positions into the ring, each
at slot ``pos % S``, as the JAX ``_write_prefill_kv`` does; its
attention reads all its own positions within the window. A decode step
attends over the whole ring, which is the window.

Parameters are a nested dict like the JAX package's, except that the
layer stack is a list of per-layer dicts instead of stacked (L, ...)
leaves (the JAX hybrid keeps a list too). The cache is ``{"lens": (B,)
int32, "layers": [per-layer leaves]}``, and ``prefill`` and
``decode_step`` update it in place. A paged cache
(``init_cache(page_size=)``) adds one ``"block_table"`` (B, max_pages)
int32 beside ``lens``, shared by every layer, whose leaves are block
pools: the JAX package stacks an identical table and ``lens`` into every
layer, the port keeps one of each.
Each residual add runs fused with the RMSNorm after it
(``layers.add_rmsnorm``), and the decode step computes the attention's
``kv_len`` once for all layers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import hybrid as hy
from repro_torch.models import layers
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import ParamSpec, init_params
from repro_torch.quant.quantize import (FLOAT_FORMATS, quantize_columns,
                                        quantizes)


def _norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), init="ones")


def _norms(params) -> List:
    """The RMSNorm weights in the order the residual stream meets them:
    each layer's ``attn_norm`` (an SSM layer's ``norm``), then
    ``final_norm``. The first runs alone (``rmsnorm``). Each later one,
    and each ``ffn_norm``, is fused with the residual add before it
    (``add_rmsnorm``), as XLA fuses them in the JAX package's layer
    body."""
    return [p_l["norm"] if "norm" in p_l else p_l["attn_norm"]
            for p_l in params["layers"]] + [params["final_norm"]]


class Model:
    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # an MoE model's (experts that had a pair, summed over MoE layer
        # passes; the passes), which its routing adds to on the device
        # (the CLI's floor); the caller zeroes it in place
        self.expert_reads = (torch.zeros((2,), dtype=torch.int64,
                                         device=self.device)
                             if cfg.is_moe else None)
        self.kinds = cfg.layer_pattern()
        # the attention layers' view of the config: a recurrent family's
        # rings are bf16 whatever ``kv_quant`` asks (a no-op there)
        self.attn_cfg = (cfg if cfg.kv_quant == self.kv_quant_effective()
                         else dataclasses.replace(cfg, kv_quant="bf16"))

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.param_dtype == "bf16" \
            else torch.float32

    def param_specs(self) -> Dict:
        cfg = self.cfg
        specs = layers.embed_specs(cfg)
        specs["final_norm"] = _norm_spec(cfg.d_model)
        if "ssm" in self.kinds:
            specs["layers"] = [{"norm": _norm_spec(cfg.d_model),
                                "ssm": ssm_mod.ssm_specs(cfg)}
                               for _ in self.kinds]
            return specs
        ffn = ("moe", moe_mod.moe_specs) if cfg.is_moe else \
            ("mlp", mlp_mod.mlp_specs)
        specs["layers"] = [{
            "attn_norm": _norm_spec(cfg.d_model),
            **({"rglru": hy.rglru_specs(cfg)} if kind == "rglru" else
               {"attn": attn.attention_specs(cfg)}),
            "ffn_norm": _norm_spec(cfg.d_model),
            ffn[0]: ffn[1](cfg),
        } for kind in self.kinds]
        return specs

    def ffn(self, p_l, z: torch.Tensor) -> torch.Tensor:
        """A layer's FFN: the MoE of an MoE config, else the dense gated
        MLP (SwiGLU, or GeGLU under ``cfg.activation`` "gelu")."""
        if self.cfg.is_moe:
            return moe_mod.moe_forward(p_l["moe"], self.cfg, z,
                                       self.expert_reads)
        return mlp_mod.mlp_forward(p_l["mlp"], z, self.cfg.activation)

    def init(self, generator: torch.Generator,
             quantize: Optional[bool] = None) -> Dict:
        """Seeded random parameters, quantized to ``cfg.quant_policy``
        unless ``quantize`` is False. An MoE config refuses a quantized
        policy (``moe.check_weight_format``).

        Each matrix that ``quantize_tree`` would quantize is quantized as
        soon as it is drawn (``quantizes``, ``quantize_columns``), so the
        whole float tree never exists: the init's peak is the quantized
        tree plus one leaf's draw (qwen1.5-110b's float tree would be
        220 GB of bf16). The draws keep their order, so the parameters
        are the bits of ``quantize_tree(init(quantize=False))``. Under
        the unfused V0 attention with a QKV bias, the three biases are
        slices of one buffer a layer (``attention.join_qkv_bias``)."""
        cfg = self.cfg
        do_quant = (cfg.quant_policy not in FLOAT_FORMATS
                    if quantize is None else quantize)
        leaf = None
        if do_quant:
            moe_mod.check_weight_format(cfg, cfg.quant_policy)

            def leaf(path, t):
                if not quantizes(path, t, cfg.quant_group):
                    return t
                return quantize_columns(t, cfg.quant_policy, cfg.quant_group)
        params = init_params(self.param_specs(), generator,
                             dtype=self.dtype, device=self.device, leaf=leaf)
        for p_l in params["layers"]:
            if "attn" in p_l:
                attn.join_qkv_bias(p_l["attn"])
        return params

    def window_for(self, total_len: int) -> int:
        """The attention window of a sequence of ``total_len`` positions
        (0: full attention): a hybrid's local window whatever the length,
        the config's sliding window, else the long-context fallback past
        ``max_full_attn``."""
        cfg = self.cfg
        if cfg.arch_type == "hybrid":
            return cfg.local_attn_window
        if cfg.sliding_window:
            return cfg.sliding_window
        if total_len > cfg.max_full_attn:
            return cfg.window_long_ctx
        return 0

    def kv_quant_effective(self) -> str:
        """Cache format actually served: ``cfg.kv_quant``, but bf16 for a
        recurrent family, whose state does not grow with the context and
        whose scan compounds rounding (a no-op there, as in the JAX
        package)."""
        return "bf16" if self.cfg.is_recurrent else self.cfg.kv_quant

    def paging_effective(self, max_len: int, page_size: int) -> int:
        """Page size actually served, or 0 when the cache stays dense.
        Paging virtualizes growing full-attention caches; a windowed
        cache is a ring already capped at the window and recurrent state
        has a fixed size, which the JAX package keeps dense."""
        if (not page_size or self.cfg.is_recurrent
                or self.window_for(max_len)):
            return 0
        return int(page_size)

    def init_cache(self, batch: int, max_len: int, page_size: int = 0,
                   cache_blocks: int = 0) -> Dict:
        """A zeroed cache in ``cfg.kv_quant``'s format, of ``max_len``
        positions a slot (a ring of ``min(max_len, window)`` for a
        windowed config); paged (block pools of ``cache_blocks`` blocks,
        default one a page a slot plus the garbage block, and a zeroed
        block table) when ``page_size`` > 0 and paging is effective. An
        SSM config's cache is each layer's zeroed conv and SSD states,
        whatever ``max_len``; a hybrid's RG-LRU layers hold their conv and
        recurrent states, its attention layers a bf16 ring of
        ``min(max_len, local_attn_window)`` positions."""
        if "ssm" in self.kinds:
            return {"lens": torch.zeros((batch,), dtype=torch.int32,
                                        device=self.device),
                    "layers": [ssm_mod.init_ssm_cache(self.cfg, batch,
                                                      self.dtype, self.device)
                               for _ in self.kinds]}
        page_size = self.paging_effective(max_len, page_size)
        window = self.window_for(max_len)
        cache = {
            "lens": torch.zeros((batch,), dtype=torch.int32,
                                device=self.device),
            "layers": [hy.init_rglru_cache(self.cfg, batch, self.dtype,
                                           self.device) if kind == "rglru"
                       else attn.init_kv_cache(
                           self.cfg, batch, max_len, window,
                           kv_quant=self.kv_quant_effective(),
                           device=self.device, page_size=page_size,
                           num_blocks=cache_blocks)
                       for kind in self.kinds],
        }
        if page_size:
            cache["block_table"] = torch.zeros(
                (batch, max_len // page_size), dtype=torch.int32,
                device=self.device)
        return cache

    @staticmethod
    def cache_len(cache: Dict) -> int:
        """Positions a slot's cache holds: S (a windowed config's ring
        length; a hybrid's, read from its first attention layer), or
        max_pages × P paged."""
        S = next(c for c in cache["layers"] if "k" in c)["k"].shape[2]
        if "block_table" in cache:
            S *= cache["block_table"].shape[1]
        return S

    def prefill(self, params, tokens: torch.Tensor, cache: Dict,
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the prompts (B, S), fill cache positions [0, S) in place
        and return the f32 logits (B, vocab) of each row's last real
        position. ``seq_lens`` (B,) marks right-padded rows' true
        lengths (the engine prefills a length bucket in one call); the
        padding writes junk K/V past ``lens``, which decode never reads
        before overwriting it. ``lens`` advances by ``seq_lens``, or by
        S without it. Prompts longer than the cache take the ring write
        (their last S_cache positions, at slots ``pos % S_cache``); that
        branch is uniform-length by contract, so ``seq_lens`` is ignored
        there and ``lens`` advances by S. The attention runs within
        ``window_for(S)``. A recurrent config runs every position of every
        row from zero states (its caller does not pad it: the engine
        buckets recurrent prompts at their exact length), and ``lens``
        advances by S, as in the JAX package. The JAX package's
        ``prefill`` takes ``{"tokens", "seq_lens"}`` and returns a new
        cache."""
        cfg = self.cfg
        B, S = tokens.shape
        ssm = "ssm" in self.kinds
        if not ssm:
            if "block_table" in cache:
                raise ValueError("prefill writes a dense cache; the serving "
                                 "engine prefills into a dense scratch "
                                 "cache and splices its pages into the "
                                 "pool")
            if S > self.cache_len(cache):
                seq_lens = None        # the ring branch: uniform-length
            window = self.window_for(S)
        x = layers.embed(params, tokens)
        norms = _norms(params)
        z = layers.rmsnorm(x, norms[0], cfg.norm_eps)
        if ssm:
            for p_l, c_l, next_norm in zip(params["layers"], cache["layers"],
                                           norms[1:]):
                z = ssm_mod.ssm_prefill(p_l["ssm"], cfg, z, c_l)
                x, z = layers.add_rmsnorm(x, z, next_norm, cfg.norm_eps)
            cache["lens"] += S
        else:
            for p_l, c_l, kind, next_norm in zip(
                    params["layers"], cache["layers"], self.kinds, norms[1:]):
                if kind == "rglru":
                    z = hy.rglru_forward(p_l["rglru"], cfg, z, c_l)
                else:
                    z = attn.attention_forward(p_l["attn"], self.attn_cfg, z,
                                               c_l, window)
                x, z = layers.add_rmsnorm(x, z, p_l["ffn_norm"],
                                          cfg.norm_eps)
                x, z = layers.add_rmsnorm(x, self.ffn(p_l, z), next_norm,
                                          cfg.norm_eps)
            cache["lens"] += S if seq_lens is None else seq_lens.to(
                cache["lens"].dtype)
        # z is the final norm of every position; unembed the last real one
        if seq_lens is None:
            last = z[:, -1:]
        else:
            rows = torch.arange(B, device=z.device)
            last = z[rows, seq_lens.long() - 1][:, None]
        logits = layers.unembed(params, last, cfg)[:, 0]
        return logits[:, :cfg.vocab_size]

    def decode_step(self, params, tokens: torch.Tensor, cache: Dict,
                    advance_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """tokens (B, 1) → logits (B, vocab) f32; the cache is updated
        in place. Rows where ``advance_mask`` (B,) is False keep their
        cache frozen: no K/V write (no conv, SSD or RG-LRU state update)
        and no ``lens`` advance (the serving engine's retired and waiting
        slots). A paged cache is read and written through its block
        table."""
        cfg = self.cfg
        x = layers.embed(params, tokens)
        lens = cache["lens"]
        norms = _norms(params)
        z = layers.rmsnorm(x, norms[0], cfg.norm_eps)
        if "ssm" in self.kinds:
            for p_l, c_l, next_norm in zip(params["layers"], cache["layers"],
                                           norms[1:]):
                z = ssm_mod.ssm_decode(p_l["ssm"], cfg, z, c_l, advance_mask)
                x, z = layers.add_rmsnorm(x, z, next_norm, cfg.norm_eps)
            return self._advance_and_unembed(params, z, lens, advance_mask)
        table = cache.get("block_table")
        # the positions each layer's attention reads, the same in every
        # layer: computed once a step
        kv_len = (torch.clamp(lens + 1, max=self.cache_len(cache))
                  if "attn" in self.kinds else None)
        # a frozen row's junk token reaches the other rows only through an
        # MoE layer that can drop pairs (more rows than its capacity): then
        # it attends as the JAX package's does (attention_decode)
        B = tokens.shape[0]
        see_current = (cfg.is_moe and table is None
                       and B > moe_mod.capacity(cfg, B))
        for p_l, c_l, kind, next_norm in zip(
                params["layers"], cache["layers"], self.kinds, norms[1:]):
            if kind == "rglru":
                z = hy.rglru_decode(p_l["rglru"], cfg, z, c_l, advance_mask)
            else:
                z = attn.attention_decode(p_l["attn"], self.attn_cfg, z, c_l,
                                          lens, kv_len, advance_mask, table,
                                          see_current)
            x, z = layers.add_rmsnorm(x, z, p_l["ffn_norm"], cfg.norm_eps)
            x, z = layers.add_rmsnorm(x, self.ffn(p_l, z), next_norm,
                                      cfg.norm_eps)
        return self._advance_and_unembed(params, z, lens, advance_mask)

    def _advance_and_unembed(self, params, z: torch.Tensor,
                             lens: torch.Tensor,
                             advance_mask: Optional[torch.Tensor]
                             ) -> torch.Tensor:
        """A decode step's end: ``lens`` advances where the row does, and
        the final norm ``z`` (B, 1, D) becomes f32 logits (B, vocab)."""
        if advance_mask is None:
            lens += 1
        else:
            lens += advance_mask.to(lens.dtype)
        logits = layers.unembed(params, z, self.cfg)[:, 0]
        return logits[:, :self.cfg.vocab_size]

    def reference_decode(self, params, prompt: Sequence[int],
                         max_new_tokens: int, eos_id: int = -1, *,
                         max_len: int = 64,
                         stepwise_prefill: bool = True) -> List[int]:
        """Greedy single-request decode: the oracle the serving engine is
        held to. ``stepwise_prefill`` feeds the prompt one token at a
        time through ``decode_step`` (the engine's chunked-admission
        path); False runs it through the fused ``prefill``, alone and
        unpadded (the stall-admission path). Returns the generated
        tokens (stops at EOS or ``max_new_tokens``). A fused prompt longer
        than ``max_len`` (or than a windowed config's ring) is written
        into the cache's ring, as in the JAX package; a recurrent state
        holds any length (a hybrid's rings take the ring write)."""
        if max_new_tokens <= 0:
            return []
        if len(prompt) == 0:
            raise ValueError("reference_decode needs at least one prompt "
                             "token")
        cache = self.init_cache(1, max_len)
        tok = torch.empty((1, 1), dtype=torch.long, device=self.device)
        if stepwise_prefill:
            for t in prompt:
                tok.fill_(int(t))
                logits = self.decode_step(params, tok, cache)
        else:
            toks = torch.as_tensor(list(prompt), dtype=torch.long,
                                   device=self.device)
            logits = self.prefill(params, toks[None], cache)
        out = [int(torch.argmax(logits[0]))]
        while len(out) < max_new_tokens and out[-1] != eos_id:
            tok.fill_(out[-1])
            logits = self.decode_step(params, tok, cache)
            out.append(int(torch.argmax(logits[0])))
        return out

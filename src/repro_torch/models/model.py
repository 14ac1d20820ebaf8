"""Dense GQA decoder: parameters, cache, the fused prefill and the decode
step.

Counterpart of the dense family of the JAX package's ``models/model.py``
(``init``, ``init_cache``, ``prefill`` with ``seq_lens``, ``decode_step``
with ``advance_mask``, ``reference_decode`` with stepwise or fused
prefill). The other families, ``cache_axes`` and the windowed configs'
``window_for`` are not ported yet: every config the port carries
attends over its whole cache (window 0).

Parameters are a nested dict like the JAX package's, except that the
layer stack is a list of per-layer dicts instead of stacked (L, ...)
leaves. The cache is ``{"lens": (B,) int32, "layers": [per-layer
leaves]}``, and ``prefill`` and ``decode_step`` update it in place.
Each residual add runs fused with the RMSNorm after it
(``layers.add_rmsnorm``), and the decode step computes the attention's
``kv_len`` once for all layers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.params import ParamSpec, init_params
from repro_torch.quant.quantize import FLOAT_FORMATS, quantize_tree


def _norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), init="ones")


def _norms(params) -> List:
    """The RMSNorm weights in the order the residual stream meets them:
    each layer's ``attn_norm``, then ``final_norm``. The first runs alone
    (``rmsnorm``). Each later one, and each ``ffn_norm``, is fused with
    the residual add before it (``add_rmsnorm``), as XLA fuses them in
    the JAX package's layer body."""
    return [p_l["attn_norm"] for p_l in params["layers"]] + \
        [params["final_norm"]]


class Model:
    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.param_dtype == "bf16" \
            else torch.float32

    def param_specs(self) -> Dict:
        cfg = self.cfg
        specs = layers.embed_specs(cfg)
        specs["final_norm"] = _norm_spec(cfg.d_model)
        specs["layers"] = [{
            "attn_norm": _norm_spec(cfg.d_model),
            "attn": attn.attention_specs(cfg),
            "ffn_norm": _norm_spec(cfg.d_model),
            "mlp": mlp_mod.mlp_specs(cfg),
        } for _ in range(cfg.num_layers)]
        return specs

    def init(self, generator: torch.Generator,
             quantize: Optional[bool] = None) -> Dict:
        """Seeded random parameters, quantized to ``cfg.quant_policy``
        unless ``quantize`` is False."""
        params = init_params(self.param_specs(), generator,
                             dtype=self.dtype, device=self.device)
        do_quant = (self.cfg.quant_policy not in FLOAT_FORMATS
                    if quantize is None else quantize)
        if do_quant:
            params = quantize_tree(params, self.cfg.quant_policy,
                                   self.cfg.quant_group)
        return params

    def init_cache(self, batch: int, max_len: int) -> Dict:
        """A zeroed cache in ``cfg.kv_quant``'s format."""
        return {
            "lens": torch.zeros((batch,), dtype=torch.int32,
                                device=self.device),
            "layers": [attn.init_kv_cache(self.cfg, batch, max_len,
                                          kv_quant=self.cfg.kv_quant,
                                          device=self.device)
                       for _ in range(self.cfg.num_layers)],
        }

    def prefill(self, params, tokens: torch.Tensor, cache: Dict,
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the prompts (B, S), fill cache positions [0, S) in place
        and return the f32 logits (B, vocab) of each row's last real
        position. ``seq_lens`` (B,) marks right-padded rows' true
        lengths (the engine prefills a length bucket in one call); the
        padding writes junk K/V past ``lens``, which decode never reads
        before overwriting it. ``lens`` advances by ``seq_lens``, or by
        S without it. The JAX package's ``prefill`` takes
        ``{"tokens", "seq_lens"}`` and returns a new cache."""
        cfg = self.cfg
        B, S = tokens.shape
        x = layers.embed(params, tokens)
        norms = _norms(params)
        z = layers.rmsnorm(x, norms[0], cfg.norm_eps)
        for p_l, c_l, next_norm in zip(params["layers"], cache["layers"],
                                       norms[1:]):
            z = attn.attention_forward(p_l["attn"], cfg, z, c_l)
            x, z = layers.add_rmsnorm(x, z, p_l["ffn_norm"], cfg.norm_eps)
            x, z = layers.add_rmsnorm(x, mlp_mod.mlp_forward(p_l["mlp"], z),
                                      next_norm, cfg.norm_eps)
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
        cache frozen: no K/V write and no ``lens`` advance (the serving
        engine's retired and waiting slots)."""
        cfg = self.cfg
        x = layers.embed(params, tokens)
        lens = cache["lens"]
        # the positions each layer's attention reads, the same in every
        # layer: computed once a step
        kv_len = torch.clamp(lens + 1, max=cache["layers"][0]["k"].shape[2])
        norms = _norms(params)
        z = layers.rmsnorm(x, norms[0], cfg.norm_eps)
        for p_l, c_l, next_norm in zip(params["layers"], cache["layers"],
                                       norms[1:]):
            z = attn.attention_decode(p_l["attn"], cfg, z, c_l, lens, kv_len,
                                      advance_mask)
            x, z = layers.add_rmsnorm(x, z, p_l["ffn_norm"], cfg.norm_eps)
            x, z = layers.add_rmsnorm(x, mlp_mod.mlp_forward(p_l["mlp"], z),
                                      next_norm, cfg.norm_eps)
        if advance_mask is None:
            lens += 1
        else:
            lens += advance_mask.to(lens.dtype)
        logits = layers.unembed(params, z, cfg)[:, 0]
        return logits[:, :cfg.vocab_size]

    def reference_decode(self, params, prompt: Sequence[int],
                         max_new_tokens: int, eos_id: int = -1, *,
                         max_len: int = 64,
                         stepwise_prefill: bool = True) -> List[int]:
        """Greedy single-request decode: the oracle the serving engine is
        held to. ``stepwise_prefill`` feeds the prompt one token at a
        time through ``decode_step`` (the engine's chunked-admission
        path); False runs it through the fused ``prefill``, alone and
        unpadded (the stall-admission path). Returns the generated
        tokens (stops at EOS or ``max_new_tokens``)."""
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

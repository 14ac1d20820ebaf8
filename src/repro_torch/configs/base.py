"""Model configuration for the decoders the port serves.

A copy of the fields of the JAX package's ``ModelConfig`` that the
dense and mixture-of-experts families read, with the JAX defaults, plus
``reduced`` for the CPU tests: the backbone, the QKV bias (``qkv_bias``,
the qwen2 models), the attention window (``sliding_window``,
mistral-7b; and ``window_long_ctx`` past ``max_full_attn`` positions,
the long-context fallback of ``Model.window_for``) and the MoE block
(``num_experts`` routed experts, ``experts_per_token`` of them a token,
``capacity_factor``, ``num_shared_experts`` always-on experts and the
Switch aux loss's ``router_aux_weight``) and the Mamba-2 SSD layer of
the SSM family (``ssm_state`` N, ``ssm_expand``, ``ssm_head_dim`` P,
``ssm_chunk``, ``ssm_conv``; ``num_heads`` 0: no attention), and the
RG-LRU hybrid (recurrentgemma-2b: ``hybrid_pattern`` of "rglru" and
"attn" layers, ``layer_pattern()``, ``rglru_width``, the local
attention's ``local_attn_window``, and ``activation`` "gelu", whose FFN
is a GeGLU). The other families of the JAX package (audio, vlm) are
refused until they are ported.

The paper's execution version (``scheduler_version``, the JAX
``configs/base.py:29-33``) and the fusion flags it drives: "v0" is the
paper's serial, unfused baseline and forces ``fuse_qkv`` and
``fuse_gate_up`` False (separate ``wq`` / ``wk`` / ``wv`` and ``w_gate``
/ ``w_up`` projections); any other version leaves the flags as given
(fused by default). On one card v1, v2 and v3 build the same fused
model, as they do in the JAX package on one device: what v2 and v3 add
is tensor-parallel sharding rules, which the port does not have yet.
Execution
knobs that the port does not have (a kernel-backend switch, scan
unrolling, remat, sharding) are left out: on a CUDA tensor the
hand-written kernels always run, on a CPU tensor their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid")
ACTIVATIONS = ("silu", "gelu")
WEIGHT_FORMATS = ("bf16", "q8_0", "q4_0")
# the paper's execution versions: v0 serial and unfused, v1 graph-level
# fusion (fused QKV and gate-up), v2 / v3 v1 with tensor parallelism
SCHEDULER_VERSIONS = ("v0", "v1", "v2", "v3")
PARAM_DTYPES = ("bf16", "f32")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    source: str = ""               # citation, e.g. "[arXiv:2407.21783]"
    arch_type: str = "dense"       # one of ARCH_TYPES

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4          # GQA; == num_heads → MHA
    head_dim: int = 0              # 0 → d_model // num_heads
    d_ff: int = 1024               # SwiGLU hidden width (per expert)
    vocab_size: int = 1024
    max_seq_len: int = 131072
    qkv_bias: bool = False         # a bias on the fused QKV projection
    tie_embeddings: bool = False   # unembed with embedding.T
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    activation: str = "silu"       # the gated FFN: silu (SwiGLU) | gelu (GeGLU)

    sliding_window: int = 0        # 0 → full attention; >0 → window size
    window_long_ctx: int = 4096    # the window past max_full_attn positions
    max_full_attn: int = 131072    # beyond this, the dense family windows

    num_experts: int = 0           # 0 → dense FFN
    experts_per_token: int = 0     # top-k
    capacity_factor: float = 1.25
    num_shared_experts: int = 0    # always-on shared experts (Kimi K2 style)
    router_aux_weight: float = 0.01

    ssm_state: int = 0             # N (state dim); 0 → no SSM
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_head_dim: int = 64         # P
    ssm_chunk: int = 256           # SSD chunk length (the plain scan's)
    ssm_conv: int = 4              # short conv width

    # the hybrid (RecurrentGemma): its block pattern, repeated, e.g.
    # ("rglru", "rglru", "attn"); the RG-LRU width (0: d_model); the
    # window of its local attention layers
    hybrid_pattern: Tuple[str, ...] = ()
    rglru_width: int = 0
    local_attn_window: int = 2048

    scheduler_version: str = "v2"  # one of SCHEDULER_VERSIONS
    fuse_qkv: bool = True          # forced False by scheduler_version v0
    fuse_gate_up: bool = True
    quant_policy: str = "bf16"     # weight format: bf16|q8_0|q4_0
    quant_group: int = 32          # group size along the reduction dim
    kv_quant: str = "bf16"         # cache format: bf16|q8_0|q4_0
    param_dtype: str = "bf16"      # bf16|f32 (f32 for exact parity tests)

    def __post_init__(self):
        if self.arch_type not in ARCH_TYPES:
            raise ValueError(f"arch_type {self.arch_type!r} is not ported; "
                             f"the port serves {ARCH_TYPES}")
        if self.scheduler_version not in SCHEDULER_VERSIONS:
            raise ValueError(f"scheduler_version must be one of "
                             f"{SCHEDULER_VERSIONS}, got "
                             f"{self.scheduler_version!r}")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.scheduler_version == "v0":
            object.__setattr__(self, "fuse_qkv", False)
            object.__setattr__(self, "fuse_gate_up", False)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"num_kv_heads {self.num_kv_heads} must "
                             f"divide num_heads {self.num_heads}")
        for field, allowed in (("activation", ACTIVATIONS),
                               ("quant_policy", WEIGHT_FORMATS),
                               ("kv_quant", WEIGHT_FORMATS),
                               ("param_dtype", PARAM_DTYPES)):
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field} must be one of {allowed}, "
                                 f"got {getattr(self, field)!r}")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the JAX package pads
        its embedding table (the logits are cut back to vocab_size)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_recurrent(self) -> bool:
        """A family whose cache holds a fixed recurrent state (the JAX
        package's ssm and hybrid): the serving contract of exact-length
        prefill buckets, no paging and no ``kv_quant``. Which layers a
        config has is ``layer_pattern()``'s to say."""
        return self.arch_type in ("ssm", "hybrid")

    def layer_pattern(self) -> Tuple[str, ...]:
        """Each layer's kind, ``num_layers`` long: "ssm", "rglru" or
        "attn" (the JAX ``ModelConfig.layer_pattern``)."""
        if self.arch_type == "ssm":
            return ("ssm",) * self.num_layers
        if self.arch_type == "hybrid":
            pat = self.hybrid_pattern or ("rglru", "rglru", "attn")
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    @property
    def lru_width(self) -> int:
        """The RG-LRU width: ``rglru_width``, or d_model where 0."""
        return self.rglru_width or self.d_model

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def reduced(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced variant of the same family for CPU tests (the same sizes
    the JAX package's ``reduced`` picks for a dense, MoE, SSM or hybrid
    config: at most 4 experts, top-2, one shared expert; an SSM config at
    d_model 128, N at most 16, P 32 and chunks of 64; a hybrid at 3
    layers, one whole rglru-rglru-attn pattern, window 64 and the RG-LRU
    width d_model)."""
    base = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 128),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=512,
    )
    if cfg.is_moe:
        base["num_experts"] = min(cfg.num_experts, 4)
        base["experts_per_token"] = min(cfg.experts_per_token, 2)
        base["num_shared_experts"] = min(cfg.num_shared_experts, 1)
    if cfg.arch_type == "ssm":
        base["d_model"] = 128
        base["ssm_state"] = min(cfg.ssm_state, 16)
        base["ssm_head_dim"] = 32
        base["ssm_chunk"] = 64
    if cfg.arch_type == "hybrid":
        base["rglru_width"] = 0
        base["local_attn_window"] = 64
        base["num_layers"] = 3
    if base["num_heads"] % max(base["num_kv_heads"], 1):
        base["num_kv_heads"] = 1
    base.update(over)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)

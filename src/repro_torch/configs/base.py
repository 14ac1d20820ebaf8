"""Model configuration for the dense decoder the port serves.

A copy of the fields of the JAX package's ``ModelConfig`` that the
dense decode path reads, plus ``reduced`` for the CPU tests. Execution
knobs that the port does not have (a kernel-backend switch, scan
unrolling, remat, sharding) are left out: on a CUDA tensor the
hand-written kernels always run, on a CPU tensor their plain versions.
"""
from __future__ import annotations

import dataclasses

WEIGHT_FORMATS = ("bf16", "q8_0", "q4_0")
PARAM_DTYPES = ("bf16", "f32")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    source: str = ""               # citation, e.g. "[arXiv:2407.21783]"

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4          # GQA; == num_heads → MHA
    head_dim: int = 0              # 0 → d_model // num_heads
    d_ff: int = 1024               # SwiGLU hidden width
    vocab_size: int = 1024
    tie_embeddings: bool = False   # unembed with embedding.T
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    quant_policy: str = "bf16"     # weight format: bf16|q8_0|q4_0
    quant_group: int = 32          # group size along the reduction dim
    kv_quant: str = "bf16"         # cache format: bf16|q8_0|q4_0
    param_dtype: str = "bf16"      # bf16|f32 (f32 for exact parity tests)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_kv_heads {self.num_kv_heads} must "
                             f"divide num_heads {self.num_heads}")
        for field, allowed in (("quant_policy", WEIGHT_FORMATS),
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
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def reduced(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced variant of the same family for CPU tests (the same sizes
    the JAX package's ``reduced`` picks for a dense config)."""
    base = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 128),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=min(cfg.d_ff, 256),
        vocab_size=min(cfg.vocab_size, 512),
    )
    if base["num_heads"] % base["num_kv_heads"]:
        base["num_kv_heads"] = 1
    base.update(over)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)

"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct].

32 layers, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=6400,
vocab=32064, MoE 16 experts top-2. A copy of the JAX package's
``configs/phi3_5_moe_42b.py``, field by field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    source="[hf:microsoft/Phi-3.5-MoE-instruct]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    capacity_factor=1.25,
    max_seq_len=131072,
)

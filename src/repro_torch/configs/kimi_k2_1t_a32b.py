"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2].

61 layers, d_model=7168, 64 heads (GQA kv=8), per-expert d_ff=2048,
vocab=163840. MoE: 384 experts, top-8, plus 1 shared expert (K2 card).
head_dim=128 as in the JAX package's ``configs/kimi_k2_1t_a32b.py``, of
which this is a copy, field by field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    source="[arXiv:2501.kimi2]",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    capacity_factor=1.25,
    max_seq_len=131072,
)

"""qwen1.5-110b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family scaling]:
a copy of the JAX package's ``configs/qwen1_5_110b.py`` (its ``source``
string as it is there).

80 layers, d_model 8192, 64 heads (GQA kv 8), d_ff 49152, vocab 152064,
rope_theta 1e6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    source="[hf:Qwen/Qwen1.5-0.5B]",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32768,
)

"""mistral-nemo-12b — dense, 128k context
[hf:mistralai/Mistral-Nemo-Base-2407]: a copy of the JAX package's
``configs/mistral_nemo_12b.py``.

40 layers, d_model 5120, 32 heads of dim 128 (GQA kv 8; q_dim 4096 !=
d_model, per the card), d_ff 14336, vocab 131072, rope_theta 1e6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    source="[hf:mistralai/Mistral-Nemo-Base-2407]",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    max_seq_len=131072,
)

"""deepseek-67b — dense llama-arch [arXiv:2401.02954]: a copy of the JAX
package's ``configs/deepseek_67b.py``.

95 layers, d_model 8192, 64 heads (GQA kv 8), d_ff 22016, vocab 102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    source="[arXiv:2401.02954]",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    max_seq_len=16384,
)

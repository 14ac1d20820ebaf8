"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

Attention-free SSM: 64 layers, d_model=2560, ssm_state=128, vocab=50280.
d_inner = 2*2560 = 5120, 80 SSD heads of dim 64. A copy of the JAX
package's ``configs/mamba2_2_7b.py``, field by field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    source="[arXiv:2405.21060]",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    max_seq_len=1 << 20,
)

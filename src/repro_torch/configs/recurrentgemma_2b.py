"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1:2
[arXiv:2402.19427].

26 layers, d_model=2560, 10 heads of dim 256 (MQA kv=1), d_ff=7680,
vocab=256000. Block pattern (rglru, rglru, attn) repeated: two recurrent
blocks per local-attention block, window 2048. A copy of the JAX
package's ``configs/recurrentgemma_2b.py``, field by field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    source="[arXiv:2402.19427]",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="gelu",
    tie_embeddings=True,
    hybrid_pattern=("rglru", "rglru", "attn"),
    rglru_width=2560,
    local_attn_window=2048,
    max_seq_len=1 << 20,
)

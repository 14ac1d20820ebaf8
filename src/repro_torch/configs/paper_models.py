"""The paper's primary profiling target (§5-6): llama3.2-1b."""
from repro_torch.configs.base import ModelConfig

LLAMA32_1B = ModelConfig(
    name="llama3.2-1b",
    source="[arXiv:2407.21783]",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
)

"""deepseek-7b — dense llama-arch [arXiv:2401.02954]; the JAX
package's serving tests use it reduced."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    source="[arXiv:2401.02954]",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    max_seq_len=16384,
)

"""The paper's six evaluated models (its Fig. 4): copies of the JAX
package's ``configs/paper_models.py``, value for value and with its
names. llama3.2-1b is the paper's primary profiling target (§5-6).

Where these differ from the published checkpoints, parity with the JAX
package wins: the qwen2 configs set no ``rope_theta`` (so 10000, where
the published Qwen2 uses 1e6), and every model keeps the default
``norm_eps`` of 1e-6. The 8B model is named by the paper's label,
"llama3.2-8b"; its architecture is llama-3.1-8B's.
"""
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
    max_seq_len=131072,
)

LLAMA32_3B = ModelConfig(
    name="llama3.2-3b",
    source="[arXiv:2407.21783]",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
    max_seq_len=131072,
)

LLAMA31_8B = ModelConfig(
    name="llama3.2-8b",  # the paper's label; the architecture is llama-3.1-8B
    source="[arXiv:2407.21783]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    max_seq_len=131072,
)

QWEN2_0_5B = ModelConfig(
    name="qwen2-0.5b",
    source="[arXiv:2407.10671]",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    max_seq_len=32768,
)

QWEN2_1_5B = ModelConfig(
    name="qwen2-1.5b",
    source="[arXiv:2407.10671]",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    max_seq_len=32768,
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b-v0.1",
    source="[arXiv:2310.06825]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    max_seq_len=32768,
)

PAPER_MODELS = {
    m.name: m
    for m in (QWEN2_0_5B, QWEN2_1_5B, LLAMA32_1B, LLAMA32_3B, MISTRAL_7B,
              LLAMA31_8B)
}

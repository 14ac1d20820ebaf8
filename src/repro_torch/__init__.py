"""PyTorch/CUDA port of the JAX serving system in ``repro``.

Serves GQA decoders, dense (llama3.2-1b at full width on an H100, and
the paper's other models) and mixture-of-experts (phi3.5-moe-42b-a6.6b,
bf16 weights), through a continuous-batching engine with chunked or
stall (fused prefill) admission; decode and prefill run on hand-written
CUDA kernels (``repro_torch.kernels``): one for each Pallas kernel of the
JAX package, the fused small ops, and the MoE routing, grouped expert
GEMMs and combine. The package imports ``torch`` and nothing of JAX or of the
``repro`` package.
"""

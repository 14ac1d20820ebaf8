"""PyTorch/CUDA port of the JAX serving system in ``repro``.

Serves a dense GQA decoder (llama3.2-1b at full width on an H100)
through a continuous-batching engine with chunked or stall (fused
prefill) admission; decode and prefill run on four hand-written CUDA
kernels (``repro_torch.kernels``), one for each Pallas kernel of the JAX
package. The package imports ``torch`` and nothing of JAX or of the
``repro`` package.
"""

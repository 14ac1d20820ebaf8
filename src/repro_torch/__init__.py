"""PyTorch/CUDA port of the JAX serving system in ``repro``.

Serves a dense GQA decoder (llama3.2-1b at full width on an H100)
through a continuous-batching engine; the decode hot path runs on three
hand-written CUDA kernels (``repro_torch.kernels``). The package imports
``torch`` and nothing of JAX or of the ``repro`` package.
"""

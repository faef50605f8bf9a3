"""PyTorch/CUDA port of the SD-Acc reproduction.

``repro_torch`` mirrors ``repro``'s layout and module names so each module's
counterpart is easy to find.  It imports ``torch`` and numpy only: no JAX,
and nothing of the ``repro`` package.  Plain tensor code is PyTorch; the
three hot-path kernels (Uni-conv, group norm with fused SiLU, flash
attention) are CUDA C++ written for Hopper under ``repro_torch.kernels``.

Entry points (``serving.config.build_engine``, ``launch.serve``) run on the
GPU unless the caller passes ``device="cpu"``; with no GPU and no explicit
CPU device they raise.
"""

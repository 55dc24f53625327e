"""PyTorch/CUDA port of the ``repro`` package (CHAOS on an NVIDIA H100).

Module names mirror ``repro``: ``repro_torch.models.cnn`` is the
counterpart of ``repro.models.cnn`` and so on.  The port imports torch and
numpy, never JAX nor anything of ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CUDA tensors the model runs
the hand-written kernels under ``kernels/csrc/``, on CPU tensors their
plain PyTorch versions.
"""

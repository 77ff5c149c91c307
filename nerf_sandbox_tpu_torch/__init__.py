"""PyTorch / CUDA port of ``nerf_sandbox_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here names
the JAX function it ports and is held against it by ``tests/test_torch_*.py``.
This package imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of ``nerf_sandbox_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device they raise (:func:`nerf_sandbox_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"

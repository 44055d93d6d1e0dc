"""ppt_torch — the PyTorch / CUDA (Hopper) port of ``ppt_tpu``.

The package mirrors ``ppt_tpu``'s layout so each module's counterpart is
found under the same path. It imports torch and numpy only: never JAX,
flax or anything of ``ppt_tpu`` (which stays the numerical reference).

Every hand-written kernel lives in ``ppt_torch/csrc`` and is reached
through a wrapper in ``ppt_torch/kernels``. A wrapper runs its plain
PyTorch version when the tensor it is given lies on the CPU, and launches
the CUDA kernel (or raises) when it lies on the card. The recognition
path's six entry points are registered operators (``torch.ops.ppt.*``,
``kernels/_ops.py``), whose CPU and CUDA keys make that rule, so
``torch.export`` and ``FlopCounterMode`` see them whole.
"""

"""Hand-written Hopper kernels (csrc/) behind wrappers with plain PyTorch versions.

Importing the package registers the recognition path's entry points as
``torch.ops.ppt.*`` operators (``_ops.py``): ``fps_batched``,
``knn_gather``, ``mini_forward``, ``mini_stats``, ``fused_vit_block`` and
``fused_vit_block_readout``.
"""

from ppt_torch.kernels import group, mini, vitblock  # noqa: F401  (they register the ops)

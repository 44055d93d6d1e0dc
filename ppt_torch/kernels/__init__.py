"""Hand-written Hopper kernels (csrc/) behind wrappers with plain PyTorch versions.

Every kernel entry point is a ``torch.ops.ppt.*`` operator (``_ops.py``),
registered when its module is imported. Importing the package registers
those of the modules that import nothing beyond it: ``attention``
(``fused_mha``, ``flash_mha``, ``flash_mha_bwd``), ``fps``
(``fps_single``), ``group`` (``fps_batched``, ``knn_gather``,
``ball_query_gather``, ``ball_query_gather_v2``,
``ball_query_gather_feats``), ``knn`` (``knn_single``), ``mini``
(``mini_forward``, ``mini_stats``), ``textblock`` (``fused_text_block``),
``texttower`` (``fused_text_tower``, ``fused_text_tower_res``,
``fused_text_tower_bwd``) and ``vitblock`` (``fused_vit_block``,
``fused_vit_block_readout``, ``fused_vit_tower``). ``chamfer``
(``chamfer_nn_dists``) and ``emd`` (``approx_match``) import
``ppt_torch.ops``, so they register when imported (``ops.losses3d`` imports
``emd``); ``tools/vitblock_probe.py`` registers ``vit_variant``.
"""

from ppt_torch.kernels import (  # noqa: F401  (they register the ops)
    attention, fps, group, knn, mini, textblock, texttower, vitblock)

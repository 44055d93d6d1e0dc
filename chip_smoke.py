"""H100 smoke run of the PyTorch port: build every kernel, hold each
against its plain PyTorch version on the card, time it, then drive the
full-width ULIP-PointBERT recognition inference path, the prompt-tuning
train path, both again with the text tower on its fused routes, the
ball-query towers (PointNeXt-S, PointNet++ SSG and MSG), PointBERT's
other trunk routes with the long-sequence trunk, and training through the
long trunk (prompt tuning at head types 3 and 2, ULIP pretraining),
PointBERT's two pretraining stages (the dVAE tokenizer, masked point
modeling), the kernel tools (the ViT-block ablation probe, the on-card
kernel check), the published recipes, converted pretrained backbones
with ULIP_PN_MLP at full width, part segmentation (ULIP_PointBERT_partseg),
the linear probe (feature extraction, the few-shot probe, prompt
interpretation), the tools (the serving export through the registered
operators, the component probe, the FLOP table, the backbone bench), and
the rest of the recognition zoo (PointNet with and without T-Nets, DGCNN,
PCT, CurveNet) with the graph towers and SimpleView, scene
segmentation (PTSeg, the Stratified Transformer, RandLA-Net and BAAF-Net
through the sceneseg driver with its whole-scene eval, the S3DIS 6-fold
tool), and the scene tier's other modules (GraphViT-3D and PointViT-Seg on
the ViT block kernel at 768 wide, ASSA, packed PointNeXt), and the
masked-point autoencoder, and the parallelism (data-, tensor- and
pipeline-parallel PPT-Base steps over ranks that share the card).

    python3 chip_smoke.py            # one CUDA card, no arguments
    python3 chip_smoke.py --only ballquery   # group.cu, phase 3's ball queries alone
    python3 chip_smoke.py --only towers      # phase 7's ball-query towers alone
    python3 chip_smoke.py --only cloud       # cloud.cu and group.cu: phase 3's fps_single and
                                             # knn_single checks and times, the grouping
                                             # wrappers' host time a call
    python3 chip_smoke.py --only losses3d    # losses3d.cu: phase 3's loss checks, nn_dists's plan
                                             # sweep, the dVAE step with recon="emd"
    python3 chip_smoke.py --only recipes     # phase 13: the published recipes, the optimizer
                                             # zoo on the card, adahessian by route
    python3 chip_smoke.py --only pretrained  # phase 14: converted ULIP/SLIP backbones loaded,
                                             # ULIP_PN_MLP at full width
    python3 chip_smoke.py --only partseg     # phase 15: part segmentation at full width
    python3 chip_smoke.py --only probe       # phase 16: the linear probe at full width
    python3 chip_smoke.py --only tools       # phase 17: the serving export, the probes, the
                                             # FLOP table, the operators' host cost
    python3 chip_smoke.py --only zoo         # phase 18: the rest of the recognition zoo, the
                                             # graph towers and SimpleView
    python3 chip_smoke.py --only scenes      # phase 19: scene segmentation (PTSeg, Stratified,
                                             # RandLA-Net, BAAF-Net, the sceneseg driver, the
                                             # 6-fold tool)
    python3 chip_smoke.py --only scenetier   # phase 3's FPS rows of the ViT tier and phase 20:
                                             # GraphViT-3D, PointViT-Seg, ASSA, packed PointNeXt
    python3 chip_smoke.py --only mae         # phase 21: the masked-point autoencoder at full
                                             # width, rows 1-5 at its shapes
    python3 chip_smoke.py --only parallel    # phase 22: dp, tp and pp PPT-Base steps over
                                             # two gloo ranks on the card, a one-rank NCCL group

Phases (any failed check raises, and the script exits non-zero):
  1. card name / power limit (nvidia-smi), torch and CUDA versions;
  2. build the kernels from ppt_torch/csrc (one nvcc per source, in
     parallel) and report the build time; count each Hopper kernel's wgmma
     (HGMMA), TMA (UTMALDG, UBLKCP) and mma.sync (HMMA) instructions with
     cuobjdump: the ViT block's and the text kernels' GEMM, the whole-row
     attention, the flash forward and backward and the bf16 MiniPointNet
     forward must issue HGMMA on UTMALDG-loaded tiles and no HMMA, the
     text kernels' bf16 attention must issue HMMA, and the text GEMMs' old
     mma.sync kernel (gemm_bf16_kernel) must be gone;
  3. each kernel entry point against its plain version, at a small shape
     and at the slice's shape, in f32 and bf16 (the grouping kernels take
     f32 coordinates in both; the five kernels of the inference path also
     at the train path's batch of 30): indices exact, f32 within 1e-4 and bf16
     within 2e-2 of the plain output's max magnitude; kernel, plain and
     library times with CUDA events. mini_forward also at the long
     trunk's 32 x 1024 groups, repeats bit-identical, timed in alternated
     rounds with its library call at the slice's and the long trunk's
     shapes, beside its weight bytes through L2 and, in the same rounds, a
     build whose producer loads the weights once (PPT_MINI_WEIGHTS_ONCE):
     the kernel's time without that traffic. The three text kernels
     (fused_text_block, fused_text_tower with and without block outputs,
     fused_text_tower_bwd) at 5 classes x 13 positions x 128 wide, at
     the slice's 40 x L x 512, 12 layers (L from the prompts), at CLIP's
     full context 40 x 77 (the bf16 attention pads it to 80) and at 37 x
     77, 2 layers (2849 rows, a multiple of neither 64 nor 128): the same
     limits, bf16 d_x0 within 5e-2, two runs bit-identical; at the slice
     timed in alternated rounds (median of 5) with the port's
     plain-PyTorch TextTransformer on the card (the library call); the
     GEMMs' device ms and TFLOP/s and the kernels launched a call, per
     entry point, under the profiler. The three
     ball-query kernels (ball_query_gather, ball_query_gather_feats with
     bf16 and f32 features, ball_query_gather_v2) against their plain
     versions at a small shape (odd nsample, N not a multiple of 32, a
     query with no hit, short rows, a point at exactly the radius, feature
     rows of 2, 10, 24 and 64 bytes), at the walk's edges (one cloud of
     20000 points, several staging chunks; S ragged against a CTA's
     queries; nsample == N, past a warp's ring of picks) and at every
     shape the towers of phase 7 give them, on those towers' own cascade
     of FPS subsets: indices and gathered features exact, coordinates
     within 1e-6, v2 (the same walk) identical to ball_query_gather bit
     for bit, the 20000-point clouds included, two runs identical; at the
     towers' shapes
     timed with the launches queued behind a sleeping kernel, in
     alternated rounds with the library call (mask + topk + gather;
     median of 5), beside the launch floor (a kernel that returns at once,
     on the same grid, block and shared memory, queued); fps_batched
     against fps_plain at each stage of the cascade, and it must raise on
     a shape it does not take. fps_batched and knn_gather also
     at the long trunk's N=8192 with 1024 centres; fps_batched on
     duplicated points, at npoint = N, at N = 77, 14528 and its cap of 16384,
     twice each (indices identical to fps_plain's and between runs), and
     the time of one step of its dependent chain (a 128-point cloud: 4
     warps of one point a thread), which times npoint is its latency floor;
     knn_gather at 100 queries and at 2 x 16384 points (indices exact,
     coordinates bit-equal to knn_gather_plain's, repeats bit-identical).
     fused_mha (q, k, v as
     views of one qkv product, as the unfused block hands them over) at
     B=2 x L=33 x 2 heads x 32, and at B=30 and 32 x 513 x 6 x 64;
     flash_mha's kernel at L=65 (one valid key in the last tile), L=1025
     and D=128, and at the long trunk's 32 x 1025 x 6 x 64; at the same
     shapes flash_mha_bwd (di, dK/dV, dQ) against flash_bwd_plain on the
     training forward's own output and lse, in f32 and bf16 with q, k, v as
     views of one qkv product: dQ, dK, dV within 1e-4 (f32) and 5e-2 (bf16)
     of the plain output's max, the lse within 1e-5 of flash_lse_plain, two
     runs bit-identical; its library time is SDPA's forward plus backward,
     beside SDPA's backward alone (library_bwd_ms: the gradient of one kept
     forward) and the port's forward plus backward (fwd_bwd_ms), its bound
     10 B H L^2 D operations at the bf16 peak beside the bytes;
     fused_vit_tower at B=2 x L=33 x C=64, depth 3 and at 30 (the train
     path's batch; checked only) and 32 x 513 x 384, depth 12, with
     DropPath scales (a zero among them): the same limits, repeats
     bit-identical, the tower
     identical to its chain of block launches; the block's own attention
     identical to fused_mha on the block's qkv product (one header, one
     implementation). The tower's library time is 12 SDPA blocks + LN.
     fused_vit_block, fused_vit_block_readout, fused_vit_tower and
     flash_mha's kernel are timed in alternated rounds with their library
     call (kernel, library, ... in each round), each time the median of
     5 rounds, since the library's time moves between calls.
     The reconstruction-loss kernels: chamfer_nn_dists (nn_dists, both
     directions, alone and in chamfer's one launch) bit-equal to
     nn_dists_plain at the dVAE's per-group clouds (4096 x 8 x 32, 4096 x 32
     x 32), at 8 x 2048 x 2048, at 4 x 16384 x 16384, at a ragged 3 x 1001 x
     777 and at M = 1, and chamfer's value and gradient equal to the plain
     recompute's; library time cdist, squared, min both ways. approx_match
     at the dVAE's 4096 x 8 x 32 and 4096 x 32 x 32 (the warp kernel), at the
     warp kernel's edges (N on the lanes, 31 x 31, 1 x 32, one point past
     its limit on either side), at 4 x 64 x 32, 4 x 1024 x 768 and 2 x 1 x
     30000 (supply vectors in device scratch): the match within 1e-4 of the
     plain auction's (bit-equality reported), the match cost within 1e-4
     relative, two runs bit-identical; no library call computes it. Both
     are timed with the launches queued (median of 5 rounds; nn_dists in
     alternated rounds with its library call) beside each shape's launch
     floor (an empty kernel launched as the kernel is). fps_single (on
     fps_batched's kernel) and knn_single (on knn_gather's selection; no
     module calls either) at 2 x 300 points with duplicates (npoint 64;
     k, S = 1, 8 / 8, 128 / 32, 256), the slice's 32 x 1024 -> 512, the
     long trunk's 32 x 8192 -> 1024 and the cap of 16384 points (k = 32):
     indices identical to the plain versions, to fps_batched's and
     knn_gather's, and between repeats; fps_single also past N (npoint >
     N, which fps_batched refuses): identical to its plain version, index 0
     once the cloud's distinct points are spent; knn_single and knn_gather also
     around their cloud chunk (N just under, at and over it with a tie
     across the border, k = 64, k past 64, N = k); each refuses by name a
     shape it does not take (S = 200; N = 16385; knn_gather k = N + 1);
     times in alternated rounds at all three large shapes: knn_single with
     cdist + topk, knn_gather (row 2) with cdist + topk + the coordinate
     gather and subtraction, fps_single with fps_batched (row 1); rows 1
     and 2 take their times in the kernels line from these rounds. Then
     the host's time a call of each grouping wrapper (fps_batched,
     fps_single, ball_query_gather, ball_query_gather_v2,
     ball_query_gather_feats): the wall time of 1000 calls queued without
     a sync, at a shape the card runs in a few microseconds, beside the
     card's own time a call (printed, not claimed). vit_variant, the ablation probe's
     block, in each mode (full, mm_only, no_softmax, no_gelu, pv_ones,
     qk_packed2, and full with two clouds per block) in f32 and bf16 at
     2 x 33 x 96 (6 heads of 16) and 32 x 513 x 384 against
     variant_block_plain: the limits above, repeats bit-identical, full and
     rows=2 bit-identical to fused_vit_block, qk_packed2 within the limits
     of full; each mode's time in bf16, the library time the SDPA block
     for full, rows2 and qk_packed2 (no one call computes the ablations);
  4. the recognition path at full width (ULIP-PointBERT, bf16, B=32,
     N=1024, 40 ModelNet40 class names, 32 prompt tokens "middle",
     weights from a seed): passes of ModelNet40's test-set size (2468
     synthetic clouds, text embedding once per pass) through
     ``validate``; the median clouds/sec of the timed passes with their
     spread, the text tower's share of a pass, each kernel's launch count
     in one pass (all must be > 0), and the logits against the same
     weights through the plain path on the card;
  5. the prompt-tuning train path at full width through ``cls.setup`` and
     the trainer (ULIP-PointBERT, bf16, head_type 0, batch 30, N=1024, the
     40 ModelNet40 names, 32 prompt tokens "middle", label smoothing 0.2,
     lr 3e-3, synthetic train split, DropPath and augmentation on): a
     warm-up, then 3 windows of 20 steps with the loss read every step as
     ``train_loop`` reads it, and between them 2 windows with the losses
     read once per window; median/min/max train clouds/sec of each kind,
     first and last loss, kernel launches per step (``mini_stats`` > 0);
     one epoch through ``cls.train_loop`` itself;
     frozen weights unchanged, prompt tokens and BatchNorm buffers moved;
     a fixed batch repeated with augmentation and DropPath off, whose loss
     must fall; one step's loss, prompt gradient and updated BatchNorm
     buffers against the same step through the plain path on the card
     (f32 and bf16); a head_type 3 step whose ``block_11`` gradients agree
     with the plain path; save -> load -> evaluate gives identical logits.
     Its numbers go on a line of their own ({"train": ...}).
  6. the fused text path at full width, through ``cls.setup`` with the
     reference's switches set as a user would set them
     (``PPT_FUSED_TEXT_TOWER=1`` / ``PPT_FUSED_TEXT=1``): a ``validate``
     pass with the tower route (the forward kernel once, no residuals),
     its logits and text embeddings against the off route on the same
     weights, the text encode's time by route; 2 windows of 20 train
     steps with the tower route interleaved with 2 of the off route
     (loss read every step), launches per step by route (the
     residual-saving forward and the backward kernel once per step);
     frozen weights unchanged; a fixed batch whose loss must fall; one
     step against the plain path for the tower and the block route (f32
     and bf16, phase 5's limits); 5 train steps with the block route (12
     block launches per encode); the three routes against each other in
     f32. Its numbers go on a line of their own ({"text": ...}).
  7. the ball-query towers through ``cls.setup`` and ``validate``:
     ULIP_PN_NEXT with ``--use_height`` at PointNeXt-S's full width, bf16,
     B=128, N=1024, 40 ModelNet40 names, 32 prompt tokens, weights from a
     seed: a warm-up pass, then 5 passes over 2468 synthetic clouds
     (median/min/max clouds/sec, launches per pass from the counters:
     ball_query_gather_feats and fps_batched > 0), logits against the plain
     path on the card in f32 and bf16 (phase 4's limits); ULIP_PN_MSG and
     ULIP_PN_SSG at B=32: one pass each, ball_query_gather launched, logits
     against the plain path; one head_type 0 train step of ULIP_PN_NEXT
     against the plain path (loss, prompt gradient, BatchNorm buffers;
     phase 5's limits), then one window of 20 steps whose frozen leaves
     stay bit-unchanged and whose BatchNorm buffers move. Its numbers go on
     a line of their own ({"ballquery": ...}).
  8. PointBERT's trunk routes through ``cls.setup`` with the reference's
     switches set as a user sets them: ``PPT_FUSED_VIT_TOWER=1`` (route
     "tower") and ``PPT_FUSED_BLOCK=0`` ("unfused"): a warm-up, then 1
     ``validate`` pass over 2468 clouds at B=32 (median/min/max
     clouds/sec, launches per pass: 78 fused_vit_tower, 936 fused_mha),
     logits against the plain path on the card (phase 4's limits), the
     tower's logits identical to the default route's; one pass with
     ``PPT_FORCE_XLA_ATTN=1`` ("plain", no trunk kernel launched); per
     route a head_type 0 bf16 step and head_type 3 steps in f32 and bf16
     against the plain path (phase 5's limits) and a window of 10 steps.
     Then the long-sequence trunk (PPT-Base's widths, 1024 groups: L=1025,
     N=8192, B=32, bf16) served through ``ulip_customized`` and
     ``validate``: clouds/sec, 12 flash_mha launches per batch, logits
     against the plain path in bf16 and f32. Its numbers go on a line of
     their own ({"routes": ...}).
  9. training through the long-sequence trunk (PPT-Base's widths, 1024
     groups, L=1025, N=8192, B=32, bf16, the text route off), built through
     ``ulip_customized``: head types 3 and 2 (block_11's leaves before its
     attention), each one step against the plain path on the card in f32
     and bf16 (phase 5's limits: loss, gradients, BatchNorm buffers; one
     flash_mha_bwd launch) and a window of 10 steps (train clouds/sec, 12
     flash_mha and 1 flash_mha_bwd a step from the counters, frozen leaves
     bit-unchanged); ULIP pretraining (``pretrain.make_pretrain_step``) on
     the same trunk: one step against the plain path at B=8 in f32 and
     bf16 (12 flash_mha_bwd launches; the group encoder's f32 gradient within
     1e-2: its max-pools route a group's gradient to one of 32 points, whose
     near-ties move with mini_stats' rounding; in bf16 the loss and the
     BatchNorm buffers within phase 5's limits, and the gradients no farther
     from the f32 step's than twice the plain bf16 step's, plus 1e-2: the
     step's conditioning makes phase 5's per-leaf limit a measure of
     rounding, not of the kernels), a fixed batch whose loss must
     fall over 10 steps, a window of 10 steps (12 flash_mha_bwd a step, the text
     tower bit-unchanged); then one epoch of ``pretrain.main`` on the
     default trunk over the synthetic ShapeNet fallback (B=32 x N=8192,
     every default-route kernel launched each step, the checkpoint read
     back). Its numbers go on a line of their own ({"pretrain": ...}).
 10. PointBERT's two pretraining stages at full width, bf16, on 320
     synthetic clouds of 1024 points (the ShapeNet-55 stand-in): the dVAE at
     ``DvaeConfig()`` (64 groups of 32, widths 256, 8192 tokens), B=64: one
     step against the plain path in f32 (loss and BatchNorm buffers within
     phase 5's 1e-4, all its gradients together within 1e-2: every leaf
     sits behind a max over EdgeConv neighbours, a max-pool or a ReLU whose
     near-ties rounding reroutes) and in bf16 (held to the f32 step as
     phase 9's pretraining is), a fixed batch whose loss must fall
     over 10 steps (Gumbel noise fixed), a window of 10 steps, one epoch of
     ``dvae_pretrain.main`` with its checkpoint read back; the dVAE with
     ``dvae_loss(recon="emd")``: one f32 step against the plain path with
     ``PPT_FORCE_XLA_EMD=1`` (two approx_match launches on the kernel side)
     and a window of 10 steps (two a step from the counters); masked point
     modeling at ``PointBertConfig()`` (384 wide, 12 blocks, 512 groups of
     32), B=32, the frozen dVAE read from that checkpoint: one step against
     the plain path at B=8 in f32 and bf16 (as the dVAE's), a fixed batch
     whose loss must fall, a window of 10 steps, one epoch of
     ``mpm_pretrain.main``. Its numbers go on a line of their own
     ({"pretrain_pb": ...}).
 11. the kernel tools as a user runs them: ``python -m
     ppt_torch.tools.vitblock_probe`` at its defaults plus qk_packed2 and
     prod (B=32, L=513, C=384, 6 heads, 12 blocks, bf16, 8 iterations;
     every mode must come back timed; vit_variant's launches from the
     counter), then ``python -m ppt_torch.tools.kernel_check`` (the
     reference tool's 25 checks on the card, 0 failures). Its numbers go
     on a line of their own ({"tools": ...}).
 12. tools/profile.py on PPT-Base recognition (B=32) and on the long
     trunk (1024 groups, N=8192): device ms by part; the block GEMMs' ms a
     batch and their TFLOP/s (the 12 blocks' products over that time), the
     flash forward's, mini_forward's, knn_gather's and fps_batched's ms a
     batch; then PPT-Base's tuning step (B=30) on the tower text route:
     wall ms a step, idle share, the text kernels' ms a step by part, and
     fused_text_tower_res and fused_text_tower_bwd launched. Its numbers go
     on a line of their own ({"profile": ...}).
 13. the published recipes through the port's own CLI: cls.main on
     configs/experiments/ppt_base_mn40.yaml and ppt_ptb_sonn_hardest.yaml
     (head type 3; ScanObjectNN falls back to synthetic clouds without
     h5py) and fewshot.main on fewshot_mn40.yaml, each with --set epochs=1
     --votes 3 --steps_per_dispatch 2: the loss finite, val_acc1 logged,
     the checkpoint read back, PointBERT's kernels launched (counts reset
     before each recipe), fused_vit_block_readout launched votes x batches
     times in the evaluation; one [recipe] line each with steps, train
     clouds/s and eval seconds with votes. Then two steps of every
     optimizer name and of the plateau stage on head type 3's leaves,
     card against host, and adahessian on every route: three steps where
     it has a second derivative, the refusal by the kernel's name where it
     has not. Its numbers go on a line of their own ({"recipes": ...});
     ``--only recipes`` builds what it needs and runs it alone.
 14. converted pretrained backbones and PointMLP: seeded full-width weights
     (SLIP's 12 x 512 text tower with its 49408-token vocabulary, PointBERT
     at PointBertConfig(), PointNet++ SSG and MSG, PointNeXt-S with the
     4-wide stem, PointMLP) written as .pt files with the reference's names
     and converted by ``python -m ppt_torch.tools.ckpt_convert``, one
     process each, into a --pretrained_dir; through ``cls.setup``: PPT-Base
     (every leaf but the prompt's loaded, by the logged counts, and
     bit-equal to its source; a ``validate`` pass over 309 of phase 4's
     clouds in bf16 and in f32 and one train step, the six kernels
     launched; logits against the plain path in bf16 and f32 at phase 4's
     limits), the SSG, MSG and NeXt files loaded bit for bit, then
     ULIP_PN_MLP at full width, B=32 x 1024 (loaded bit for bit;
     fps_batched launched 4 times a batch in a bf16 ``validate`` pass, an
     f32 pass too; logits against the plain path in bf16 and f32; 5
     timed head-type-0 train steps, then 3 under the profiler: clouds/sec,
     wall, busy and idle a batch; fps_batched at PointMLP's four shapes
     with the launches queued, against fps_plain); an existing directory
     without converted files warns and keeps the seeded init. Its numbers
     go on a line of their own ({"pretrained": ...}); ``--only pretrained``
     builds what it needs and runs it alone.
 15. part segmentation at full width through ``partseg.setup``:
     ULIP_PointBERT_partseg (PointBertConfig(), SLIP's 12 x 512 text tower,
     50 part prompts of 32 tokens, class name in the middle) on 320
     synthetic part clouds a split, B=32 x N=2048: a bf16 ``validate``
     pass after a warm-up one (clouds/sec, launches a batch: fps_batched 3, knn_gather 1,
     mini_forward 1, fused_vit_block 12, fused_vit_block_readout 0), one
     batch's logits against the plain path in bf16 and f32 at phase 4's
     limits with the refined predictions and mIoU beside them; one train
     step's launches (mini_stats 1), 5 timed head-type-0 steps and 3
     profiled (clouds/sec, wall, busy, idle; the frozen leaves
     bit-unchanged), a fixed batch whose loss falls; one step against the
     plain path at head types 0 and 3 in f32 (loss, BatchNorm buffers and
     the prompt's gradient at phase 5's limits, the other leaves by their
     gradients' distance, TOL_PARTSEG_GRAD_DIST) and bf16 (as phase 9's
     bf16 pretraining step); the tower, unfused and plain routes against the
     block route (the tower's logits identical, the others' top-1 at phase
     4's limit and max|diff|/std within twice it); the published recipe
     ``configs/experiments/partseg_shapenetpart.yaml --set epochs=1`` in
     its own process, its mIoU read from the log and its checkpoint read
     back by ``--evaluate_3d``; a seeded reference-named partseg .pt
     converted with ``--kind pointbert_partseg`` and a cls ``pointbert.pt``,
     each loaded into the partseg model bit for bit (the heads at their init
     from the cls file). Its numbers go on a line of their own
     ({"partseg": ...}); ``--only partseg`` builds what it needs and runs it
     alone.
 16. the linear probe at full width: ``feature_extract.main`` (PPT-Base,
     bf16, seeded weights, B=32 x 1024 points) over ModelNet40-sized
     synthetic splits (9843 train and 2468 test clouds, 40 classes), each
     split's clouds/sec with its model build, the batch loop's alone, and
     the launches a batch (fps_batched 1, knn_gather 1, mini_forward 1,
     fused_vit_block 11, fused_vit_block_readout 1, nothing else); one
     batch's features against the plain path (f32 max|diff| within 1e-3 of
     their std, bf16 within 0.25); ``save_recog_feats``' logits bit-equal
     to ``cls.validate``'s eval step on the same seeded state;
     ``linear_probe.run_probe`` over the two files on the card and on the
     CPU, each in a process of its own, side by side (shots 1-16, one run
     a shot, num_step 8; seconds a shot; each shot's mean within 0.5
     points), one
     fit's weights card against CPU within 1e-2 of their largest;
     ``interpret_prompt.nearest_words`` at CLIP's 49408
     x 512 table with 32 seeded context vectors, TF32 off, its indices the
     CPU's except where two squared distances lie within 1e-6 relative. The
     features stay under build/chip_smoke_probe/lp_feats, where ``python -m
     ppt_torch.tasks.linear_probe --output_dir build/chip_smoke_probe``
     reads them. Its numbers go on a line of their own ({"probe": ...});
     ``--only probe`` builds what it needs and runs it alone.
 17. the tools: ``tools/export.py``'s full-width PPT-Base program (bf16,
     seeded weights) exported baked at B=32 by the tool's ``main`` (which
     prints its ``--measure 30`` latency line), its graph calling the ``ppt``
     operators 1 / 1 / 1 / 11 / 1 times and nothing decomposed, loaded in a
     fresh ``python3 -c`` process that imports torch and
     ``ppt_torch.kernels`` alone and runs 2468 synthetic clouds through it
     (its launches a batch exactly 1 / 1 / 1 / 11 / 1, its logits bit-equal
     to the eager eval step's on the same batches, else within the bf16
     limits of phase 4); the ``--sym-batch`` program at B=8 and B=32
     against the eager step; the host's us a call of each ``ppt`` operator
     against its direct launch function, in alternated rounds ([host]
     lines); ``component_probe`` over the components no other phase
     times at the same shape (``PROBE_COMPONENTS``); ``profile --flops``
     for the recognition batch and the prompt-tuning step;
     ``backbone_bench`` for the four towers it had before phase 18 (8
     timed calls each). Its numbers go on a line of their own ({"tools17":
     ...}); ``--only tools`` builds what it needs and runs it alone.
 18. the zoo: ``ULIP_PointNet``, ``ULIP_PointNet_STN``, ``ULIP_DGCNN``,
     ``ULIP_PCT`` and ``ULIP_CurveNet`` at their default configs (full
     width), bf16, seeded weights, through ``cls.setup``: a ``validate``
     pass over phase 14's 309 clouds of 1024 points at B=32 (a warm-up
     pass, then one with the counts set to 0: clouds/sec, launches a batch,
     ``fps_batched`` 0 / 0 / 0 / 2 / 3 a batch and no other kernel); one
     batch's logits against the plain path (bf16 and f32) at phase 4's
     limits, and bf16 against f32: the point embeddings at phase 4's bf16
     max|diff| limit, the logits reported (random weights leave a cloud's
     top-2 logits within bf16's rounding); for the four that train one head-type-0
     step (loss finite, frozen leaves bit-unchanged, the prompt moved);
     ``ULIP_CurveNet``'s step refused by name. ``fps_batched`` at the new
     shapes (B=32: PCT 1024 -> 512 -> 256, CurveNet 1024 -> 256 -> 64 ->
     16, GroupPointNet 1024 -> 256) against ``fps_plain``, exact, timed with
     the launches queued beside each shape's latency floor (npoint steps of
     phase 3's dependent chain). The graph towers (BallDGCNN, DeepGCN,
     GroupPointNet) and SimpleView at their default configs, f32, B=32 x
     1024 points on a 1/64 lattice (exact coordinate distances on both
     devices): the card's forward against the CPU's. ``backbone_bench
     --model dgcnn`` at B=128. Its numbers go on a line of their own
     ({"zoo": ...}); the kernels line's ``fps_batched`` entry gains
     ``zoo_shapes`` and ``zoo_launches_per_batch``; ``--only zoo`` builds
     ``group.cu`` and runs it alone.
 19. scene segmentation: PTSeg, the Stratified Transformer, RandLA-Net
     and BAAF-Net (``farthest_knn`` off and on) at their default configs
     for S3DIS (xyz + rgb, 13 classes), f32, seeded weights and BatchNorm
     statistics, B=2 x 4096 points on a 1/64 lattice (Stratified's scaled
     to 4 m, and once more on the unit cube, where its windows overflow;
     ``window_overflow`` equal on both devices): the card's eval forward
     against the CPU's and one training-mode forward's running
     statistics, each within 1e-4 of its max magnitude (head dropout and
     DropPath the identity), ``fps_batched`` 4 / 4 / 0 / 5 a forward and
     no other kernel; bf16 against f32 on the card at
     B=8 (max|diff| and argmax agreement, reported); ``fps_batched`` at the
     scene shapes (B=8: 4096 -> 1024 -> 256 -> 64 -> 16 -> 4) against
     ``fps_plain``, exact, timed with the launches queued beside each
     shape's latency floor. Then ``sceneseg.train_loop`` for each backbone
     in bf16 on a synthetic S3DIS written from the seed (Area 1: 16 rooms,
     Areas 5 and 6: 2 rooms each, 200k raw points a room in a 6 x 5 x 3 m
     box of ceiling, floor and wall planes and clutter, rgb 0-255, 13
     labels), --voxel_size 0.04 --npoints 4096 --voxel_max 4096
     --batch_size 8 --epochs 1 --eval_scene --cm_out: the loss finite,
     the epoch's training seconds, the whole-scene eval's seconds and raw
     points/s, mIoU in [0, 100], the scene matrix counting every labelled
     raw Area 5 point once, ``fps_batched`` 4 / 4 / 0 / 5 a step, peak memory,
     checkpoint_best.pt written and (RandLA-Net's) --resume going on at
     epoch 1; bf16
     train steps of each at B=8 x 4096, one profiled after a warm-up step
     (device ms by kind: the kNN's sorts, fps_batched, GEMMs, other; the
     idle share; Stratified's ``window_overflow``) and then crops/s over 5
     steps and the peak memory; the whole-scene eval of one room under the
     profiler (its idle share); RandLA-Net with Area 6 held out, and
     ``tools/s3dis_6fold.py`` over the two areas' matrices. Its numbers go
     on a line of their own ({"sceneseg": ...}); the kernels line's
     ``fps_batched`` entry gains ``scene_shapes`` and
     ``scene_launches_per_step``; ``--only scenes`` builds ``group.cu`` and
     runs it alone.
 20. the scene tier's other modules at their default configs (seeded
     weights and BatchNorm statistics, lattice clouds): GraphViT-3D's
     ``cls_feat`` at B=32 x 1024, PointViT-Seg at B=8 x 4096, ASSA at B=8
     (4096 -> 1024 queries), packed PointNeXt-S at B=8 x 1024; each f32
     forward on the card against the CPU's within 1e-4 of its max, with
     exactly its kernels (``fused_vit_block`` 12 and ``fps_batched`` 1 /
     3 / 0 / 4 a forward), bf16 against f32 (reported), ms a forward in
     both, a bf16 forward under the profiler (the ViT blocks' device ms);
     PointViT-Seg's training-mode forward and backward at B=2 card against
     CPU (logits and statistics within 1e-4, gradients by their distance
     within phase 15's 2e-2). Phase 3 adds row 5 at GraphViT's [32, 257,
     768] x 12 heads and row 1 at the tier's shapes. A ``{"scenetier":
     ...}`` line; the kernels line's ``fps_batched`` and
     ``fused_vit_block`` entries gain ``scenetier_launches_per_forward``;
     ``--only scenetier`` builds ``group.cu`` and ``vitblock.cu`` and runs
     it alone.
 21. the masked-point autoencoder (``MaskedPointMAE``) at the full
     ``MaeConfig`` (64 groups of 32, the tokenizer 128 wide, 6 encoder
     blocks on the 25 kept tokens and 2 decoder blocks on all 64, 192 wide,
     6 heads), B=32 x 1024, seeded weights and BatchNorm statistics,
     lattice clouds: rows 1-5 at its shapes against their plain versions
     (bf16 ``mini_forward`` at CO = 128, its template width, and 256),
     timed queued in rounds alternated with the library call; the f32
     forward card against CPU (loss and ``pred`` within 1e-4), bf16
     against f32 (the loss within 5e-3, ``pred`` within 3e-2 of its max;
     a float8-weight control's ``pred`` past it); the first f32 train step's
     gradients card against CPU within 1e-3 of the largest; 5
     ``torch.optim.Adam(lr=1e-3)`` steps in each dtype with finite losses,
     launches a step ``fps_batched`` 1, ``knn_gather`` 1, ``mini_stats`` 1,
     ``mini_forward`` 1, ``fused_vit_block`` 8, and one profiled bf16 step
     (busy, wall, idle share). A ``{"mae": ...}`` line; the kernels line's
     five entries gain ``mae`` and ``mae_launches_per_step``; ``--only
     mae`` builds ``group.cu``, ``mini.cu`` and ``vitblock.cu`` and runs it
     alone.
 22. the parallelism (``ppt_torch/parallel/``) at PPT-Base's full width in
     f32: two ranks over gloo on the one card (NCCL refuses two ranks on
     one device), spawned after the build, each step held against the same
     step in this process: dp = 2 (one SGD step at global B = 32, 16 a
     rank, head type 3: the loss within 1e-5, the updates by their distance
     within 1e-3, the running statistics within 1e-4 (sync-BN), the ranks'
     launches equal to one process's), tp = 2 (the eval logits within
     1e-4, the step as dp's; 12 ``fused_mha`` over 3 heads a rank and no
     fused block), pp = 2 (``pipelined_trunk_features`` at B = 16 in 4
     microbatches and the gradient of sum(features**2): features within
     1e-5, gradients by their distance within 1e-4; ``fused_vit_block`` 6
     times a microbatch on each stage); then a one-rank NCCL group runs the
     dp step here, held as dp's. A ``{"parallel": ...}``
     line; the kernels line's entries gain ``parallel_launches_per_step``
     (rank 0's dp, tp and pp counts); ``--only parallel`` builds what
     PPT-Base runs and runs it alone.

The build prints each CUDA kernel's registers and spills (ptxas -v).
The line before the card's is a JSON object with the per-kernel numbers
(the grouping kernels' entries name their CUDA kernel, ``cuda_kernel``).
Each ``launches`` there is a counter read after a driven run, or a sum of
such readings (``fused_text_tower`` adds its two variants' counters and
lists them under ``launches_by_variant``; ``flash_mha_bwd``'s is the
pretraining window's, with the prompt-tuning windows' under
``launches_by_path``);
the last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
          file=sys.stderr)
    sys.exit(2)

import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from ppt_torch.data import datasets as pdata  # noqa: E402
from ppt_torch.data.augment import append_height, train_augment, translate_pointcloud  # noqa: E402
from ppt_torch.data.datasets import ArrayDataset, make_synthetic  # noqa: E402
from ppt_torch.data.loader import Loader  # noqa: E402
from ppt_torch.kernels import _build  # noqa: E402
from ppt_torch.kernels import attention as kattn  # noqa: E402
from ppt_torch.kernels import chamfer as kchamfer  # noqa: E402
from ppt_torch.kernels import emd as kemd  # noqa: E402
from ppt_torch.kernels import fps as kfps  # noqa: E402
from ppt_torch.kernels import group as kgroup  # noqa: E402
from ppt_torch.kernels import knn as kknn  # noqa: E402
from ppt_torch.kernels import mini as kmini  # noqa: E402
from ppt_torch.kernels import textblock as ktextblock  # noqa: E402
from ppt_torch.kernels import texttower as ktower  # noqa: E402
from ppt_torch.kernels import vitblock as kvit  # noqa: E402
from ppt_torch.models import ulip as ulip_models  # noqa: E402
from ppt_torch.models.ulip import (PromptArrays, build_model, trainable_mask,  # noqa: E402
                                   ulip_customized)
from ppt_torch.nn import dvae as ndvae  # noqa: E402
from ppt_torch.nn import mpm as nmpm  # noqa: E402
from ppt_torch.nn import pointbert as npb  # noqa: E402
from ppt_torch.nn import text as ntext  # noqa: E402
from ppt_torch.prompt.learner import build_prompt_spec  # noqa: E402
from ppt_torch.tasks import cls, dvae_pretrain, fewshot, mpm_pretrain, partseg, pretrain  # noqa: E402
from ppt_torch.tasks import feature_extract, interpret_prompt, linear_probe, sceneseg  # noqa: E402
from ppt_torch.tasks.args import TaskArgs  # noqa: E402
from ppt_torch.tools import kernel_check, vitblock_probe  # noqa: E402
from ppt_torch.tools import profile as tprofile  # noqa: E402
from ppt_torch.tools.timing import gpu_time_ms, queued_ms  # noqa: E402
from ppt_torch.models.losses import smoothed_cross_entropy, ulip_contrastive_loss  # noqa: E402
from ppt_torch.ops.losses3d import chamfer_l2  # noqa: E402
from ppt_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from ppt_torch.train.eval import make_cached_text_eval  # noqa: E402
from ppt_torch.train.optim import build_optimizer, build_schedule  # noqa: E402
from ppt_torch.train.trainer import (TrainState, create_train_state, make_eval_step,  # noqa: E402
                                     make_train_step)
from ppt_torch.utils.metrics import partseg_ious, refine_partseg_logits  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 outside tensor cores
TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (shape..., tag): a small shape, the shape the train path gives the kernel
# (batch 30; checked only) and the shape the inference path gives it (batch
# 32; checked and timed). mini_stats runs on the train path alone.
GROUP_SHAPES = ((2, 256, 32, 8, "small"), (30, 1024, 512, 32, "train"),
                (32, 1024, 512, 32, "slice"), (32, 8192, 1024, 32, "long"))  # B, N, G, K
MINI_SHAPES = ((1, 7, 20, "small"), (30, 512, 32, "train"), (32, 512, 32, "slice"),
               (32, 1024, 32, "long"))  # B, G, M (small: padded groups; long: the long trunk's)
# mini_stats: padded groups, the train path's batch of 30 (checked and timed)
# and the long trunk's training shape (the pretraining drivers')
STATS_SHAPES = ((1, 7, 20, "small"), (30, 512, 32, "slice"), (32, 1024, 32, "long"))
BLOCK_SHAPES = ((2, 33, 64, 2, "small"), (30, 513, 384, 6, "train"),
                (32, 513, 384, 6, "slice"),
                (32, 257, 768, 12, "graphvit"))  # B, L, C, heads; GraphViT-3D's encoder last
# fps_batched at the ViT segmentation tier's shapes, by batch: PointViT-Seg's
# skip levels (its encoder's 256 groups are the second) and GraphViT-3D's groups
VIT_FPS_SHAPES = {8: ((4096, 512, "PointViT-Seg"), (4096, 256, "PointViT-Seg")),
                  32: ((1024, 256, "GraphViT-3D"),)}
SOURCES = {
    "fps_batched": ("ppt_torch/csrc/group.cu", "ppt_tpu/kernels/group.py:132"),
    "knn_gather": ("ppt_torch/csrc/group.cu", "ppt_tpu/kernels/group.py:336"),
    "mini_forward": ("ppt_torch/csrc/mini.cu", "ppt_tpu/kernels/mini.py:344"),
    "mini_stats": ("ppt_torch/csrc/mini.cu", "ppt_tpu/kernels/mini.py:316"),
    "fused_vit_block": ("ppt_torch/csrc/vitblock.cu", "ppt_tpu/kernels/vitblock.py:372"),
    "fused_vit_block_readout": ("ppt_torch/csrc/vitblock.cu",
                                "ppt_tpu/kernels/vitblock.py:526"),
    "fused_text_block": ("ppt_torch/csrc/text.cu", "ppt_tpu/kernels/textblock.py:173"),
    "fused_text_tower": ("ppt_torch/csrc/text.cu", "ppt_tpu/kernels/texttower.py:351"),
    "fused_text_tower_bwd": ("ppt_torch/csrc/text.cu", "ppt_tpu/kernels/texttower.py:465"),
    "ball_query_gather": ("ppt_torch/csrc/group.cu", "ppt_tpu/kernels/group.py:769"),
    "ball_query_gather_feats": ("ppt_torch/csrc/group.cu", "ppt_tpu/kernels/group.py:832"),
    "ball_query_gather_v2": ("ppt_torch/csrc/group.cu", "ppt_tpu/kernels/group.py:421"),
    "fused_mha": ("ppt_torch/csrc/attention.cu", "ppt_tpu/kernels/attention.py:178"),
    "flash_mha": ("ppt_torch/csrc/attention.cu", "ppt_tpu/kernels/attention.py:245"),
    "fused_vit_tower": ("ppt_torch/csrc/vitblock.cu", "ppt_tpu/kernels/vitblock.py:476"),
    "flash_mha_bwd": ("ppt_torch/csrc/attention.cu",
                      "jax/experimental/pallas/ops/tpu/flash_attention.py:941,1287"),
    "chamfer_nn_dists": ("ppt_torch/csrc/losses3d.cu", "ppt_tpu/kernels/chamfer.py:99"),
    "approx_match": ("ppt_torch/csrc/losses3d.cu", "ppt_tpu/kernels/emd.py:98,157"),
    "fps_single": ("ppt_torch/csrc/group.cu", "ppt_tpu/kernels/fps.py:73"),
    "knn_single": ("ppt_torch/csrc/cloud.cu", "ppt_tpu/kernels/knn.py:64"),
    "vit_variant": ("ppt_torch/csrc/vitblock.cu", "ppt_tpu/tools/vitblock_probe.py:208"),
}
# B, L, heads, head dim
MHA_SHAPES = ((2, 33, 2, 32, "small"), (30, 513, 6, 64, "train"), (32, 513, 6, 64, "slice"))
FLASH_SHAPES = ((2, 65, 2, 32, "tail1"), (1, 1025, 6, 64, "L1025"), (2, 130, 2, 128, "d128"),
                (32, 1025, 6, 64, "slice"))
TOWER_SHAPES = ((2, 33, 64, 2, 3, "small"), (30, 513, 384, 6, 12, "train"),
                (32, 513, 384, 6, 12, "slice"))  # B, L, C, H, depth
TEXT_KERNELS = ("fused_text_block", "fused_text_tower", "fused_text_tower_bwd")
BALL_KERNELS = ("ball_query_gather", "ball_query_gather_feats", "ball_query_gather_v2")
# the kernels of PointBERT's other trunk routes (phase 8)
ROUTE_KERNELS = ("fused_mha", "flash_mha", "fused_vit_tower")
# the kernels of training through the long trunk (phase 9)
LONG_TRAIN_KERNELS = ("flash_mha_bwd",)
# the reconstruction-loss kernels of PointBERT's pretraining stages (phase 10)
LOSS3D_KERNELS = ("chamfer_nn_dists", "approx_match")
# the single-cloud FPS and kNN entry points (phase 3; fps_single on group.cu's
# fps_batched_kernel, knn_single on cloud.cu's knn_single_kernel), and the
# ablation probe's kernel (phase 11)
CLOUD_KERNELS = ("fps_single", "knn_single")
TOOL_KERNELS = ("vit_variant",)
# the PointBERT tower's kernels on its default route (phases 4 to 6)
POINT_KERNELS = tuple(k for k in SOURCES if k not in TEXT_KERNELS + BALL_KERNELS + ROUTE_KERNELS
                      + LONG_TRAIN_KERNELS + LOSS3D_KERNELS + CLOUD_KERNELS + TOOL_KERNELS)
# ball_query_gather_v2 is the reference's second formulation of
# ball_query_gather, on the same kernel here: no module calls it (nor does the
# reference call its own), so no driven path launches it;
# no entry point reaches chamfer_nn_dists either, here or in the reference: the
# dVAE's Chamfer-L1 stays plain on every device, as the reference keeps it in XLA;
# nor does any module call fps_single or knn_single (the reference reaches
# fps_pallas and knn_pallas from its tests alone)
OFF_PATH_KERNELS = ("ball_query_gather_v2", "chamfer_nn_dists") + CLOUD_KERNELS
TOL_TEXT_BWD = {"f32": 1e-4, "bf16": 5e-2}


# the warp-specialised Hopper kernels: each must issue wgmma (HGMMA) on
# tiles that TMA loads (UTMALDG), and none may run mma.sync (HMMA)
HOPPER_KERNELS = {"attention": ("attention_wgmma_kernel", "flash_fwd_wgmma_kernel",
                                "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"),
                  "vitblock": ("attention_wgmma_kernel", "gemm_wgmma_kernel"),
                  "mini": ("mini_forward_wgmma_kernel", "mini_stats_wgmma_kernel"),
                  "text": ("gemm_wgmma_kernel",)}
# the kernels on mma.sync by design (the text attention's classes of at most
# 80 padded rows): each must issue HMMA
MMA_KERNELS = {"text": ("attn_fwd_bf16_kernel", "attn_bwd_bf16_kernel")}
# kernels that must be gone: the text GEMMs' old mma.sync body, mini_stats's
# old mma.sync sweep
GONE_KERNELS = {"text": ("gemm_bf16_kernel",), "mini": ("mini_stats_bf16_kernel",)}
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "HMMA")


def hopper_sass(libs=None):
    """Instruction counts of the Hopper kernels in the built libraries
    (cuobjdump -sass; ``libs``, else every library that has one), summed
    over each kernel's template instances; checks that each of
    HOPPER_KERNELS issues HGMMA and UTMALDG and no HMMA, that each of
    MMA_KERNELS issues HMMA, and that no GONE_KERNELS is built. Returns
    {library: {kernel: {op: count, "instances": n}}}."""
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    ops = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    found = {}
    libs = list(libs or {**HOPPER_KERNELS, **MMA_KERNELS})
    # one cuobjdump per library, all at once, read in turn
    dumps = {lib: subprocess.Popen([str(tool), "-sass",
                                    str(_build.BUILD_DIR / f"libppt_{lib}.so")],
                                   stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
             for lib in libs}
    for lib in libs:
        names = HOPPER_KERNELS.get(lib, ()) + MMA_KERNELS.get(lib, ()) + GONE_KERNELS.get(lib, ())
        out, _ = dumps[lib].communicate(timeout=300)
        counts = {n: dict.fromkeys(SASS_OPS, 0) for n in names}
        instances = dict.fromkeys(names, 0)
        current = None
        for line in out.splitlines():
            if "Function : " in line:
                current = next((n for n in names if n in line), None)
                if current:
                    instances[current] += 1
            elif current:
                for op in set(ops.findall(line)):  # each op once a line, as counted before
                    counts[current][op] += 1
        for n in names:
            c = dict(counts[n], instances=instances[n])
            print(f"[sass] lib{lib}: {n}: {c}")
            if n in HOPPER_KERNELS.get(lib, ()):
                check(instances[n] > 0 and c["HGMMA"] > 0 and c["UTMALDG"] > 0
                      and c["HMMA"] == 0,
                      f"{n} in lib{lib} does not run wgmma on TMA-loaded tiles: {c}")
            elif n in MMA_KERNELS.get(lib, ()):
                check(instances[n] > 0 and c["HMMA"] > 0,
                      f"{n} in lib{lib} does not run on the tensor cores: {c}")
            else:
                check(instances[n] == 0, f"lib{lib} still builds {n}")
            found.setdefault(lib, {})[n] = c
    return found


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


_INIT_DRAWS = {}
_draw_init = ulip_models.init_weights


@torch.no_grad()
def init_weights(model, seed):
    """``models/ulip.py:init_weights`` with its draws kept: a model whose
    state has the same names, shapes and dtypes gets the same values from
    the same seed (the draws come from the seed alone, the rest is
    constructed constants), so a later build copies them instead of
    drawing them again: the run builds the full-width model dozens of
    times, each draw ~1 s of host time. ``main`` installs it over the
    port's, which ``build_model`` calls."""
    key = (seed, tuple((k, tuple(v.shape), v.dtype) for k, v in model.state_dict().items()))
    kept = _INIT_DRAWS.get(key)
    if kept is None:
        _draw_init(model, seed)
        _INIT_DRAWS[key] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    else:
        model.load_state_dict(kept)
    return model


def alternated_ms(fns, rounds=5, timer=gpu_time_ms, **kw):
    """Each callable's device time as the median over `rounds` rounds, the
    callables timed in turn within a round by `timer` (gpu_time_ms, or
    queued_ms for calls shorter than their launch; `kw` goes to it), so
    that a kernel and its library call meet the same state of the card."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(timer(fn, **kw))
    return {k: float(np.median(v)) for k, v in times.items()}


def bound_ms(nbytes, nops, peak):
    """Least time for the work: max(bytes / HBM rate, operations / peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def cloud(B, N, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(B, N, 3, generator=g).to(DEV)


# (B, N, npoint, tag): fps_batched beyond GROUP_SHAPES: duplicated points,
# npoint = N (with and without duplicates), N not a multiple of 32, the old
# kernel's cap of 14528 points and the new one
FPS_EXTRA = ((2, 300, 64, "dup"), (2, 300, 300, "dup_all"), (3, 1024, 1024, "all"),
             (2, 77, 77, "n77_all"), (2, 14528, 512, "n14528"),
             (2, kgroup.FPS_MAX_POINTS, 1024, "cap"))
# (B, N, S, k, tag): knn_gather beyond GROUP_SHAPES: a query count knn_single
# refuses (not a multiple of 16), and 16384 points, which the old kernel refused
KNN_EXTRA = ((2, 1000, 100, 32, "S100"), (2, 16384, 1024, 32, "n16384"))


def knn_gather_vs_plain(tag, xyz, q, k):
    """knn_gather against its plain version: indices exact, coordinates
    bit-equal, two runs bit-identical. Returns the coordinates' max error."""
    kidx, nb = kgroup.knn_gather(k, xyz, q)
    kidx2, nb2 = kgroup.knn_gather(k, xyz, q)
    widx, wnb = kgroup.knn_gather_plain(k, xyz, q)
    torch.cuda.synchronize()
    n_bad = int((kidx != widx).sum())
    nb_err = float((nb - wnb).abs().max())
    same = torch.equal(kidx, kidx2) and torch.equal(nb, nb2)
    print(f"[kernel] knn_gather {tag} B={xyz.shape[0]} N={xyz.shape[1]} S={q.shape[1]} k={k}: "
          f"index mismatches {n_bad}, max |d nbr| {nb_err:.3e}, repeat identical {same}")
    check(n_bad == 0, f"knn_gather indices differ at {tag}")
    check(nb_err == 0.0, f"knn_gather coordinates differ at {tag}")
    check(same, f"knn_gather repeats differ at {tag}")
    return nb_err


def fps_vs_plain(tag, xyz, npoint):
    idx = kgroup.fps_batched(xyz, npoint)
    again = kgroup.fps_batched(xyz, npoint)
    want = kgroup.fps_plain(xyz, npoint)
    torch.cuda.synchronize()
    n_bad = int((idx != want).sum())
    same = torch.equal(idx, again)
    B, N, _ = xyz.shape
    print(f"[kernel] fps_batched {tag} B={B} N={N} -> {npoint}: index mismatches {n_bad}, "
          f"repeat identical {same}")
    check(n_bad == 0 and same, f"fps_batched indices differ at {tag}")
    return want


def fps_chain_us(n=128):
    """One step of fps_batched's dependent chain, us: one n-point cloud (at
    128 points the rule gives 4 warps of one point a thread, the shortest
    chain), the time of n steps less that of one, over the difference; the
    launches queued, as each lasts a few microseconds."""
    xyz = cloud(1, n, n)
    t_all = queued_ms(lambda: kgroup.fps_batched(xyz, n))
    t_one = queued_ms(lambda: kgroup.fps_batched(xyz, 1))
    return (t_all - t_one) / (n - 1) * 1e3


def fps_shape_rows(B, shapes, tag, salt):
    """fps_batched on B clouds at ``shapes`` ((N, npoint, models), ...), the
    launches queued, against fps_plain (exact), beside each shape's bound and
    latency floor: npoint steps of the dependent chain (phase 3's
    ``fps_chain_us``). The clouds are drawn from seed ``salt * N + npoint``."""
    chain_us = fps_chain_us()
    rows = []
    for N, npoint, models in shapes:
        xyz = cloud(B, N, salt * N + npoint)
        check(torch.equal(kgroup.fps_batched(xyz, npoint), kgroup.fps_plain(xyz, npoint)),
              f"fps_batched differs from fps_plain at {N} -> {npoint}")
        times = alternated_ms({"kernel": lambda: kgroup.fps_batched(xyz, npoint)},
                              timer=queued_ms)
        bms, by = bound_ms(B * N * 12 + B * npoint * 4, B * npoint * N * 10, PEAK["f32"])
        row = dict(B=B, N=N, npoint=npoint, models=models, queued_ms=times["kernel"],
                   plain_ms=gpu_time_ms(lambda: kgroup.fps_plain(xyz, npoint), reps=3, warmup=1),
                   bound_ms=bms, bound_by=by, latency_floor_ms=npoint * chain_us * 1e-3)
        rows.append(row)
        print(f"[{tag}] fps_batched {models} {B} x {N} -> {npoint}: exact; queued "
              f"{row['queued_ms']:.4f} ms, fps_plain {row['plain_ms']:.3f} ms, bound "
              f"{bms:.5f} ms ({by}), latency floor {row['latency_floor_ms']:.4f} ms")
    return rows


def check_grouping(results):
    for B, N, G, K, tag in GROUP_SHAPES:
        xyz = cloud(B, N, N + G)
        want = fps_vs_plain(tag, xyz, G)
        center = torch.gather(xyz, 1, want.long()[:, :, None].expand(-1, -1, 3))
        nb_err = knn_gather_vs_plain(tag, xyz, center, K)
        if tag != "slice":
            continue
        fps_b = B * N * 12 + B * G * 4
        fps_ops = B * G * N * 10  # 3 sub, 3 mul, 2 add, min, compare per point per step
        bms, by = bound_ms(fps_b, fps_ops, PEAK["f32"])
        results["fps_batched"] = dict(
            cuda_kernel="fps_batched_kernel", max_abs_err=0.0,
            ms=None,  # check_cloud times it beside fps_single
            plain_ms=gpu_time_ms(lambda: kgroup.fps_plain(xyz, G), reps=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=None)
        knn_b = B * N * 12 + B * G * 12 + B * G * K * 16
        knn_ops = B * G * N * 9  # distance (8) + one comparison per candidate
        bms, by = bound_ms(knn_b, knn_ops, PEAK["f32"])
        results["knn_gather"] = dict(
            cuda_kernel="knn_gather_kernel", max_abs_err=nb_err, ms=None, library_ms=None,  # check_cloud: alternated rounds
            plain_ms=gpu_time_ms(lambda: kgroup.knn_gather_plain(K, xyz, center)),
            bound_ms=bms, bound_by=by)
    for B, N, npoint, tag in FPS_EXTRA:
        fps_vs_plain(tag, dup_cloud(B, N, N + npoint) if "dup" in tag else cloud(B, N, N),
                     npoint)
    for B, N, S, K, tag in KNN_EXTRA:
        xyz = dup_cloud(B, N, N + S)
        knn_gather_vs_plain(tag, xyz, xyz[:, :S].contiguous(), K)

    # the latency floor: npoint steps of the shortest dependent chain, at the
    # shapes check_cloud times
    chain = fps_chain_us()
    results["fps_batched"].update(
        step_chain_us=chain,
        latency_floor_ms={tag: chain * npoint * 1e-3
                          for _, _, npoint, tag in CLOUD_SHAPES if tag != "small"})
    print(f"[kernel] fps_batched step chain {chain:.4f} us; latency floor, ms: "
          f"{json.dumps(results['fps_batched']['latency_floor_ms'])}")
    results["fps_batched"]["vit_tier_shapes"] = vit_fps_rows()


def vit_fps_rows():
    """fps_batched at VIT_FPS_SHAPES, exact and queued (``fps_shape_rows``)."""
    return [row for B, shapes in VIT_FPS_SHAPES.items()
            for row in fps_shape_rows(B, shapes, "kernel", 5)]


def mini_weights(co, seed):
    g = torch.Generator().manual_seed(seed)

    def f(*s, sc):
        return (torch.randn(*s, generator=g) * sc).to(DEV)

    return [f(3, 128, sc=0.5), f(128, sc=0.1), f(128, 256, sc=128 ** -0.5), f(256, sc=0.1),
            f(256, 512, sc=0.05), f(256, 512, sc=0.05), f(512, sc=0.1),
            f(512, co, sc=512 ** -0.5), f(co, sc=0.1)]


def mini_library(M, dt, x, w):
    fw1, fb1, w2, b2, fwg, fwl, fbs, w3, b3 = [t.to(dt) for t in w]
    B, GM, _ = x.shape
    h = F.relu(F.linear(x.to(dt), fw1.t(), fb1))
    x2 = F.linear(h, w2.t(), b2).reshape(B, GM // M, M, -1)
    gh = F.linear(x2.amax(2), fwg.t())
    h = F.relu(F.linear(x2, fwl.t()) + gh[:, :, None] + fbs)
    return F.linear(h, w3.t(), b3).amax(2)


# the bf16 weights a 128-row tile of the wgmma kernel streams through L2
# (w2, fwg, fwl, w3; csrc/mini.cu: every tile reads all of them)
MINI_TILE_ROWS = 128
MINI_WEIGHT_BYTES = 2 * (128 * 256 + 2 * 256 * 512 + 512 * 256)


def mini_weights_once():
    """mini_forward's bf16 kernel built with PPT_MINI_WEIGHTS_ONCE
    (csrc/mini.cu): its producer fills the weight ring once and then hands
    the consumers stale stages, so it runs without the weights' L2 traffic
    (its output is wrong by design). Returns f(M, x, w) that launches it as
    the wrapper launches the kernel."""
    so = _build.BUILD_DIR / "libppt_mini_weights_once.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-DPPT_MINI_WEIGHTS_ONCE", "-o", str(so),
                    str(_build.CSRC / "mini.cu")], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    lib.ppt_mini_forward.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 11)

    def run(M, x, w):
        B, GM, _ = x.shape
        ws = [t.to(torch.bfloat16).contiguous() for t in w]
        out = torch.empty(B, GM // M, 256, dtype=torch.bfloat16, device=x.device)
        rc = lib.ppt_mini_forward(1, _build.ptr(x), B * GM // M, M, 128, 256, 512, 256,
                                  *[_build.ptr(t) for t in ws], _build.ptr(out),
                                  _build.stream_ptr(x))
        check(rc == 0, f"mini_forward weights-once build: error {rc}")
        return out

    return run


def check_mini(results):
    by_shape = {}
    once = mini_weights_once()
    for B, G, M, tag in MINI_SHAPES:
        x = cloud(B, G * M, G) - 0.5
        w = mini_weights(256, G)
        for dname, dt in DTYPES.items():
            got = kmini.mini_forward(M, dt, x, *w)
            again = kmini.mini_forward(M, dt, x, *w)
            want = kmini.mini_forward_plain(M, dt, x, *w)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            same = torch.equal(got, again)
            print(f"[kernel] mini_forward {tag} {dname} B={B} G={G} M={M}: max rel err "
                  f"{err:.3e} (tol {TOL[dname]}); repeat identical {same}")
            check(torch.isfinite(got.float()).all(), "mini_forward non-finite")
            check(err <= TOL[dname], f"mini_forward {tag} {dname} error {err}")
            check(same, f"mini_forward {tag} {dname}: repeats differ")
            if tag not in ("slice", "long") or dname != "bf16":
                continue
            n = B * G * M
            ops = 2 * n * (3 * 128 + 128 * 256 + 256 * 512 + 512 * 256) + 2 * B * G * 256 * 512
            wbytes = 2 * (3 * 128 + 128 + 128 * 256 + 256 + 2 * 256 * 512 + 512 + 512 * 256 + 256)
            bms, by = bound_ms(n * 12 + B * G * 256 * 2 + wbytes, ops, PEAK["bf16"])
            t = alternated_ms({"ms": lambda: kmini.mini_forward(M, dt, x, *w),
                               "library_ms": lambda: mini_library(M, dt, x, w),
                               "weights_once_ms": lambda: once(M, x.contiguous(), w)})
            l2_bytes = -(-n // MINI_TILE_ROWS) * MINI_WEIGHT_BYTES
            by_shape[tag] = dict(t, bound_ms=bms, bound_by=by, tflops=ops / (t["ms"] * 1e-3) / 1e12,
                                 weight_l2_gb=l2_bytes / 1e9,
                                 weight_l2_tb_per_s=l2_bytes / (t["ms"] * 1e-3) / 1e12)
            print(f"[kernel] mini_forward {tag}: {json.dumps(by_shape[tag])}")
            if tag == "slice":
                results["mini_forward"] = dict(
                    max_abs_err=float((got.float() - want.float()).abs().max()), ms=t["ms"],
                    plain_ms=gpu_time_ms(lambda: kmini.mini_forward_plain(M, dt, x, *w)),
                    bound_ms=bms, bound_by=by, library_ms=t["library_ms"])
    results["mini_forward"]["by_shape"] = by_shape


def stats_library(M, dt, x, w):
    """One chain of library calls for the same function: form h, sum it."""
    fw1, fb1, w2, b2, wg, wl, bs = [t.to(dt) for t in w]
    B, GM, _ = x.shape
    x1 = F.relu(F.linear(x.to(dt), fw1.t(), fb1))
    x2 = F.linear(x1, w2.t(), b2).reshape(B, GM // M, M, -1)
    gh = F.linear(x2.amax(2), wg.t())
    h = (F.linear(x2, wl.t()) + gh[:, :, None] + bs).float().reshape(-1, wl.shape[1])
    return h.sum(0), (h * h).sum(0)


def check_mini_stats(results):
    for B, G, M, tag in STATS_SHAPES:
        x = cloud(B, G * M, G + 1) - 0.5
        w = mini_weights(256, G + 1)[:7]  # fw1, fb1, w2, b2, wg, wl, bsplit
        for dname, dt in DTYPES.items():
            got = kmini.mini_stats(M, dt, x, *w)
            want = kmini.mini_stats_plain(M, dt, x, *w)
            sweep = kmini.mini_stats_sweep(M, dt, x, *w[:4])
            sweep2 = kmini.mini_stats_sweep(M, dt, x, *w[:4])
            sweep_want = kmini.mini_stats_sweep_plain(M, dt, x, *w[:4])
            again = kmini.mini_stats(M, dt, x, *w)
            torch.cuda.synchronize()
            errs = [rel_err(g, t) for g, t in zip(got, want)]
            sweep_errs = [rel_err(g, t) for g, t in zip(sweep, sweep_want)]
            same = all(torch.equal(a, b) for a, b in zip(sweep + got, sweep2 + again))
            sym = torch.equal(sweep[0], sweep[0].t())
            print(f"[kernel] mini_stats {tag} {dname} B={B} G={G} M={M}: max rel err sum_h "
                  f"{errs[0]:.3e}, sumsq_h {errs[1]:.3e} (tol {TOL[dname]}); sweep m2 "
                  f"{sweep_errs[0]:.3e}, sg {sweep_errs[1]:.3e}, gmax {sweep_errs[2]:.3e}; "
                  f"two runs bit-identical: {same}; m2 exactly symmetric: {sym}")
            check(all(torch.isfinite(t).all() for t in got), "mini_stats non-finite")
            check(max(errs + sweep_errs) <= TOL[dname], f"mini_stats {tag} {dname} error {errs}")
            check(same, f"mini_stats {tag} {dname} differs between two runs")
            check(sym, f"mini_stats {tag} {dname}: m2 is not symmetric")
            if tag != "slice":
                continue
            # the sweep, the f32 epilogue and the whole wrapper in alternated
            # rounds with the library chain (median of 5)
            tm = alternated_ms({"ms": lambda: kmini.mini_stats(M, dt, x, *w),
                               "sweep_ms": lambda: kmini.mini_stats_sweep(M, dt, x, *w[:4]),
                               "epilogue_ms": lambda: kmini._stats_epilogue(M, *sweep, *w[4:]),
                               "library_ms": lambda: stats_library(M, dt, x, w)})
            # The sweep's operations: two products per point, and m2 = x2^T x2,
            # which is symmetric, so C2 (C2 + 1) / 2 of its entries are needed.
            # The epilogue's f32 products are left out: the bound errs low.
            n, C2 = B * G * M, 256
            ops = 2 * n * (3 * 128 + 128 * C2) + n * C2 * (C2 + 1)
            tflops = ops / (tm["sweep_ms"] * 1e-3) / 1e12
            print(f"[kernel] mini_stats slice {dname}: sweep {tm['sweep_ms']:.4f} ms "
                  f"({tflops:.1f} TFLOP/s of the needed operations) + f32 epilogue "
                  f"{tm['epilogue_ms']:.4f} ms; the wrapper {tm['ms']:.4f} ms; library chain "
                  f"{tm['library_ms']:.4f} ms")
            if dname == "f32":
                f32_ms = {"f32_ms": tm["ms"], "f32_sweep_ms": tm["sweep_ms"]}
                continue
            nbytes = n * 12 + 2 * B * G * C2 * 4 + C2 * C2 * 4 + 2 * (
                3 * 128 + 128 + 128 * C2 + C2)
            bms, by = bound_ms(nbytes, ops, PEAK["bf16"])
            results["mini_stats"] = dict(
                max_abs_err=max(float((g - t).abs().max()) for g, t in zip(got, want)),
                ms=tm["ms"],
                plain_ms=gpu_time_ms(lambda: kmini.mini_stats_plain(M, dt, x, *w)),
                bound_ms=bms, bound_by=by, library_ms=tm["library_ms"],
                sweep_ms=tm["sweep_ms"], epilogue_ms=tm["epilogue_ms"], sweep_tflops=tflops,
                **f32_ms)


def block_inputs(B, L, C, dt, seed):
    g = torch.Generator().manual_seed(seed)

    def f(*s, sc=1.0):
        return (torch.randn(*s, generator=g) * sc).to(DEV)

    x, pos = f(B, L, C).to(dt), f(B, L, C).to(dt)
    dp = torch.ones(B, 2, device=DEV)
    s = C ** -0.5
    weights = [1 + 0.1 * f(C), 0.1 * f(C), f(C, 3 * C, sc=s).to(dt), f(C, C, sc=s).to(dt),
               0.1 * f(C), 1 + 0.1 * f(C), 0.1 * f(C), f(C, 4 * C, sc=s).to(dt), 0.1 * f(4 * C),
               f(4 * C, C, sc=(4 * C) ** -0.5).to(dt), 0.1 * f(C)]
    lnf = [1 + 0.1 * f(C), 0.1 * f(C)]
    return x, pos, dp, weights, lnf


def block_library(x, pos, dp, w, heads, lnf=None):
    ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2 = w
    B, L, C = x.shape
    dt = x.dtype
    x0 = x + pos
    h = F.layer_norm(x0, (C,), ln1s.to(dt), ln1b.to(dt), eps=1e-6)
    q, k, v = (t.reshape(B, L, heads, C // heads).transpose(1, 2)
               for t in F.linear(h, wqkv.t()).split(C, -1))
    a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, L, C)
    x1 = x0 + F.linear(a, wproj.t(), bproj.to(dt)) * dp[:, None, 0:1].to(dt)
    h = F.layer_norm(x1, (C,), ln2s.to(dt), ln2b.to(dt), eps=1e-6)
    h = F.gelu(F.linear(h, wfc1.t(), bfc1.to(dt)), approximate="tanh")
    out = x1 + F.linear(h, wfc2.t(), bfc2.to(dt)) * dp[:, None, 1:2].to(dt)
    if lnf is None:
        return out
    xn = F.layer_norm(out.float(), (C,), lnf[0], lnf[1], eps=1e-6)
    return torch.stack([xn[:, 0], xn[:, 1:].amax(1)], 1)


def check_block(results):
    for B, L, C, H, tag in BLOCK_SHAPES:
        for dname, dt in DTYPES.items():
            x, pos, dp, w, lnf = block_inputs(B, L, C, dt, L)
            got = kvit.fused_vit_block(x, pos, dp, *w, H)
            want = kvit.vit_block_plain(x, pos, dp, *w, H)
            ro = kvit.fused_vit_block_readout(x, pos, dp, *w, *lnf, H)
            ro_want = kvit.vit_block_readout_plain(x, pos, dp, *w, *lnf, H)
            torch.cuda.synchronize()
            err, ro_err = rel_err(got, want), rel_err(ro, ro_want)
            print(f"[kernel] fused_vit_block {tag} {dname} B={B} L={L} C={C} H={H}: max rel "
                  f"err {err:.3e}; readout {ro_err:.3e} (tol {TOL[dname]})")
            check(torch.isfinite(got.float()).all() and torch.isfinite(ro).all(),
                  "vit block non-finite")
            check(err <= TOL[dname], f"fused_vit_block {tag} {dname} error {err}")
            check(ro_err <= TOL[dname], f"fused_vit_block_readout {tag} {dname} error {ro_err}")
            check(bool((ro[:, 2:] == 0).all()), "readout rows 2..7 not zero")
            if tag not in ("slice", "graphvit") or dname != "bf16":
                continue
            rows, hid = B * L, 4 * C
            ops = 2 * rows * (C * 3 * C + C * C + 2 * C * hid) + 4 * B * L * L * C
            wbytes = 2 * (C * 3 * C + C * C + 2 * C * hid) + 4 * (7 * C + hid)
            bms, by = bound_ms(3 * rows * C * 2 + B * 2 * 4 + wbytes, ops, PEAK["bf16"])
            fns = {"block": lambda: kvit.fused_vit_block(x, pos, dp, *w, H),
                   "library": lambda: block_library(x, pos, dp, w, H)}
            if tag == "slice":
                fns.update(readout=lambda: kvit.fused_vit_block_readout(x, pos, dp, *w, *lnf, H),
                           readout_library=lambda: block_library(x, pos, dp, w, H, lnf))
            t = alternated_ms(fns)
            entry = dict(
                max_abs_err=float((got.float() - want.float()).abs().max()),
                ms=t["block"],
                plain_ms=gpu_time_ms(lambda: kvit.vit_block_plain(x, pos, dp, *w, H)),
                bound_ms=bms, bound_by=by, library_ms=t["library"])
            if tag == "graphvit":  # the entry's shape: GraphViT-3D / PointViT-Seg's encoder
                results["fused_vit_block"]["graphvit"] = dict(B=B, L=L, C=C, heads=H, **entry)
                print(f"[kernel] fused_vit_block graphvit bf16 {B} x {L} x {C}, {H} heads: "
                      f"{json.dumps(entry)}")
                continue
            results["fused_vit_block"] = entry
            bms, by = bound_ms(2 * rows * C * 2 + B * 2 * 4 + wbytes + 4 * 2 * C
                               + B * 8 * C * 4, ops + 8 * rows * C, PEAK["bf16"])
            results["fused_vit_block_readout"] = dict(
                max_abs_err=float((ro - ro_want).abs().max()),
                ms=t["readout"],
                plain_ms=gpu_time_ms(
                    lambda: kvit.vit_block_readout_plain(x, pos, dp, *w, *lnf, H)),
                bound_ms=bms, bound_by=by, library_ms=t["readout_library"])


def qkv_views(B, L, H, D, dt, seed):
    """q, k, v [B, L, H, D] as the unfused block hands them over: column
    views of one [B, L, 3HD] product, no copies."""
    g = torch.Generator().manual_seed(seed)
    qkv = (torch.randn(B, L, 3 * H * D, generator=g) * 0.5).to(DEV).to(dt)
    return tuple(t.reshape(B, L, H, D) for t in qkv.split(H * D, dim=-1))


def sdpa(q, k, v):
    """The library call for the same function, [B, L, H, D] in and out."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2)).transpose(1, 2)


def attention_bound(B, L, H, D, dt):
    """Two products of 2 B H L^2 D operations; q, k, v read, out written."""
    return bound_ms(4 * B * L * H * D * (2 if dt == torch.bfloat16 else 4),
                    4 * B * H * L * L * D, PEAK["bf16" if dt == torch.bfloat16 else "f32"])


def check_attention(results):
    """fused_mha and flash_mha's kernel against their plain versions."""
    for B, L, H, D, tag in MHA_SHAPES:
        for dname, dt in DTYPES.items():
            q, k, v = qkv_views(B, L, H, D, dt, L + D)
            got = kattn._mha_run(q, k, v)
            again = kattn._mha_run(q, k, v)
            dense = kattn._mha_run(q.contiguous(), k.contiguous(), v.contiguous())
            want = kattn.mha_plain(q, k, v)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            same = torch.equal(got, again) and torch.equal(got, dense)
            print(f"[kernel] fused_mha {tag} {dname} B={B} L={L} H={H} D={D}: max rel err "
                  f"{err:.3e} (tol {TOL[dname]}); repeats and contiguous inputs bit-identical "
                  f"{same}")
            check(torch.isfinite(got.float()).all(), "fused_mha non-finite")
            check(err <= TOL[dname], f"fused_mha {tag} {dname} error {err}")
            check(same, f"fused_mha {tag} {dname} differs between runs or layouts")
            if tag != "slice":
                continue
            if dname == "f32":
                mha_f32_ms = gpu_time_ms(lambda: kattn._mha_run(q, k, v))
                continue
            bms, by = attention_bound(B, L, H, D, dt)
            results["fused_mha"] = dict(
                max_abs_err=float((got.float() - want.float()).abs().max()),
                ms=gpu_time_ms(lambda: kattn._mha_run(q, k, v)),
                plain_ms=gpu_time_ms(lambda: kattn.mha_plain(q, k, v)),
                bound_ms=bms, bound_by=by, library_ms=gpu_time_ms(lambda: sdpa(q, k, v)),
                f32_ms=mha_f32_ms)

    for B, L, H, D, tag in FLASH_SHAPES:
        for dname, dt in DTYPES.items():
            q, k, v = qkv_views(B, L, H, D, dt, L + D)
            got = kattn._flash_run(q, k, v)
            again = kattn._flash_run(q, k, v)
            want = kattn.flash_plain(q, k, v)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            same = torch.equal(got, again)
            print(f"[kernel] flash_mha {tag} {dname} B={B} L={L} H={H} D={D}: max rel err "
                  f"{err:.3e} (tol {TOL[dname]}); repeats bit-identical {same}")
            check(torch.isfinite(got.float()).all(), "flash_mha non-finite")
            check(err <= TOL[dname], f"flash_mha {tag} {dname} error {err}")
            check(same, f"flash_mha {tag} {dname} differs between two runs")
            if tag != "slice":
                continue
            if dname == "f32":
                flash_f32_ms = gpu_time_ms(lambda: kattn._flash_run(q, k, v))
                continue
            bms, by = attention_bound(B, L, H, D, dt)
            t = alternated_ms({"kernel": lambda: kattn._flash_run(q, k, v),
                               "library": lambda: sdpa(q, k, v),
                               "with_lse": lambda: kattn._flash_fwd(q, k, v)})
            results["flash_mha"] = dict(
                max_abs_err=float((got.float() - want.float()).abs().max()),
                ms=t["kernel"],
                plain_ms=gpu_time_ms(lambda: kattn.flash_plain(q, k, v), reps=3, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=t["library"],
                f32_ms=flash_f32_ms, with_lse_ms=t["with_lse"],
                whole_row_ms=gpu_time_ms(lambda: kattn._mha_run(q, k, v)))

    # the block's attention is fused_mha's kernel on the block's own qkv product
    for B, L, C, H, tag in BLOCK_SHAPES:
        for dname, dt in DTYPES.items():
            x, pos, dp, w, _ = block_inputs(B, L, C, dt, L + 1)
            sc = {}
            kvit._launch(x, pos, dp, w, None, H, "fused_vit_block", scratch=sc)
            q, k, v = (t.reshape(B, L, H, C // H) for t in sc["qkv"].reshape(B, L, 3 * C)
                       .split(C, dim=-1))
            alone = kattn._mha_run(q, k, v)
            torch.cuda.synchronize()
            same = torch.equal(alone.reshape(B * L, C), sc["attn"])
            print(f"[kernel] fused_vit_block {tag} {dname}: its attention output equals "
                  f"fused_mha on its qkv product bit for bit: {same}")
            check(same, f"the block's attention and fused_mha differ at {tag} {dname}")


def sdpa_fwd_bwd(q, k, v, do):
    """The library's forward plus backward at the same shape (a yardstick)."""
    out = sdpa(q, k, v)
    return torch.autograd.grad(out, (q, k, v), do)


def sdpa_bwd(out, q, k, v, do):
    """The library's backward alone: the gradient of one kept forward."""
    return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)


def check_flash_bwd(results):
    """flash_mha's backward kernels against flash_bwd_plain, on the kernel
    forward's own output and lse, and that lse against flash_lse_plain."""
    for B, L, H, D, tag in FLASH_SHAPES:
        for dname, dt in DTYPES.items():
            q, k, v = qkv_views(B, L, H, D, dt, 7 * L + D)
            g = torch.Generator().manual_seed(L + 3 * D)
            do = torch.randn(B, L, H, D, generator=g).to(DEV).to(dt)
            o, lse = kattn._flash_fwd(q, k, v)
            got = kattn._flash_bwd(q, k, v, o, lse, do)
            again = kattn._flash_bwd(q, k, v, o, lse, do)
            want = kattn.flash_bwd_plain(q, k, v, o, lse, do)
            lse_want = kattn.flash_lse_plain(q, k)
            torch.cuda.synchronize()
            errs = [rel_err(a, w) for a, w in zip(got, want)]
            lse_err = float((lse - lse_want).abs().max())
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"[kernel] flash_mha_bwd {tag} {dname} B={B} L={L} H={H} D={D}: max rel err "
                  f"dq/dk/dv {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (tol "
                  f"{TOL_TEXT_BWD[dname]}); forward lse max abs err {lse_err:.3e} (tol 1e-5); "
                  f"repeats bit-identical {same}")
            check(all(torch.isfinite(a.float()).all() for a in got), "flash_mha_bwd non-finite")
            check(max(errs) <= TOL_TEXT_BWD[dname], f"flash_mha_bwd {tag} {dname} error {errs}")
            check(lse_err <= 1e-5, f"flash_mha lse {tag} {dname} error {lse_err}")
            check(same, f"flash_mha_bwd {tag} {dname} differs between two runs")
            if tag != "slice":
                continue
            if dname == "f32":
                bwd_f32_ms = gpu_time_ms(lambda: kattn._flash_bwd(q, k, v, o, lse, do))
                continue
            elt = 2
            bms, by = bound_ms(8 * B * L * H * D * elt + 4 * B * H * L,
                               10 * B * H * L * L * D, PEAK["bf16"])
            leaves = [t.detach().clone().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
            lq, lk, lv = (t.transpose(1, 2) for t in leaves)
            kept = sdpa(lq, lk, lv)  # one forward whose backward alone is timed
            results["flash_mha_bwd"] = dict(
                max_abs_err=max(float((a.float() - w.float()).abs().max())
                                for a, w in zip(got, want)),
                ms=gpu_time_ms(lambda: kattn._flash_bwd(q, k, v, o, lse, do)),
                plain_ms=gpu_time_ms(lambda: kattn.flash_bwd_plain(q, k, v, o, lse, do),
                                     reps=3, warmup=1),
                bound_ms=bms, bound_by=by,
                library_ms=gpu_time_ms(lambda: sdpa_fwd_bwd(lq, lk, lv, do)),
                library="scaled_dot_product_attention forward + backward",
                library_bwd_ms=gpu_time_ms(lambda: sdpa_bwd(kept, lq, lk, lv, do)),
                fwd_bwd_ms=gpu_time_ms(
                    lambda: kattn._flash_bwd(q, k, v, *kattn._flash_fwd(q, k, v), do)),
                f32_ms=bwd_f32_ms, lse_max_abs_err=lse_err)


def tower_inputs(B, L, C, depth, dt, seed):
    """x, pos, DropPath scales [B, depth, 2] (block 0 kept, a zero among
    the rest), the stacked weights and the final LN, from a seed."""
    g = torch.Generator().manual_seed(seed)
    per_block = [block_inputs(B, L, C, dt, seed + 1 + i) for i in range(depth)]
    x, pos, _, _, lnf = per_block[0]
    keep = 1.0 - torch.linspace(0.0, 0.1, depth)[None, :, None]
    dp = ((torch.rand(B, depth, 2, generator=g) < keep).float() / keep).to(DEV)
    dp[0, -1, 0] = 0.0
    stacked = [torch.stack(ws) for ws in zip(*(blk[3] for blk in per_block))]
    return x, pos, dp, stacked, lnf


def tower_library(x, pos, dp, stacked, lnf, heads):
    depth = stacked[0].shape[0]
    for i in range(depth - 1):
        x = block_library(x, pos, dp[:, i], [t[i] for t in stacked], heads)
    return block_library(x, pos, dp[:, -1], [t[-1] for t in stacked], heads, lnf)


def tower_chain(x, pos, dp, stacked, lnf, heads):
    """The same trunk as launches of the block kernels, one per block."""
    depth = stacked[0].shape[0]
    for i in range(depth - 1):
        x = kvit._block_run(x, pos, dp[:, i], *[t[i] for t in stacked], heads)
    return kvit._block_readout_run(x, pos, dp[:, -1], *[t[-1] for t in stacked], *lnf, heads)


def check_tower(results):
    for B, L, C, H, depth, tag in TOWER_SHAPES:
        for dname, dt in DTYPES.items():
            x, pos, dp, w, lnf = tower_inputs(B, L, C, depth, dt, L + depth)
            got = kvit._tower_run(x, pos, dp, *w, *lnf, H)
            again = kvit._tower_run(x, pos, dp, *w, *lnf, H)
            chain = tower_chain(x, pos, dp, w, lnf, H)
            want = kvit.vit_tower_plain(x, pos, dp, *w, *lnf, H)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            same, as_chain = torch.equal(got, again), torch.equal(got, chain)
            print(f"[kernel] fused_vit_tower {tag} {dname} B={B} L={L} C={C} H={H} depth "
                  f"{depth}: max rel err {err:.3e} (tol {TOL[dname]}); repeats bit-identical "
                  f"{same}; equal to the chain of {depth} block launches bit for bit {as_chain}")
            check(torch.isfinite(got).all(), "fused_vit_tower non-finite")
            check(err <= TOL[dname], f"fused_vit_tower {tag} {dname} error {err}")
            check(same and as_chain, f"fused_vit_tower {tag} {dname} differs from a repeat or "
                                     f"from the block chain")
            check(bool((got[:, 2:] == 0).all()), "tower readout rows 2..7 not zero")
            if tag != "slice":
                continue
            if dname == "f32":
                tower_f32_ms = gpu_time_ms(lambda: kvit._tower_run(x, pos, dp, *w, *lnf, H),
                                           reps=3, warmup=1)
                continue
            rows, hid = B * L, 4 * C
            ops = depth * (2 * rows * (C * 3 * C + C * C + 2 * C * hid) + 4 * B * L * L * C) \
                + 8 * rows * C
            wbytes = 2 * (C * 3 * C + C * C + 2 * C * hid) + 4 * (7 * C + hid)
            bms, by = bound_ms(2 * rows * C * 2 + B * depth * 2 * 4 + depth * wbytes
                               + 4 * 2 * C + B * 8 * C * 4, ops, PEAK["bf16"])
            t = alternated_ms({"tower": lambda: kvit._tower_run(x, pos, dp, *w, *lnf, H),
                               "library": lambda: tower_library(x, pos, dp, w, lnf, H),
                               "chain": lambda: tower_chain(x, pos, dp, w, lnf, H)},
                              reps=5, warmup=1)
            results["fused_vit_tower"] = dict(
                max_abs_err=float((got - want).abs().max()),
                ms=t["tower"],
                plain_ms=gpu_time_ms(lambda: kvit.vit_tower_plain(x, pos, dp, *w, *lnf, H),
                                     reps=3, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=t["library"], chain_ms=t["chain"],
                f32_ms=tower_f32_ms)


def mn40_prompts():
    """The 40 ModelNet40 names with 32 prompt tokens "middle", on the card."""
    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    spec = build_prompt_spec(names, n_ctx=32, class_name_position="middle")
    return PromptArrays.from_spec(spec, device=DEV)


def text_inputs(C, L, D, depth, E, dt, seed):
    """x0, one-hot EOT rows, output cotangent and the tower's 15 weights
    (matrices in ``dt``, LN parameters and biases f32), from a seed."""
    g = torch.Generator().manual_seed(seed)

    def f(*s, sc=1.0):
        return (torch.randn(*s, generator=g) * sc).to(DEV)

    hid = 4 * D
    x0 = f(C, L, D).to(dt)
    eot_pos = torch.randint(1, L, (C,), generator=g).to(DEV)
    onehot = (torch.arange(L, device=DEV)[None, :] == eot_pos[:, None]).float()
    cot = f(C, E)
    s = D ** -0.5
    weights = [1 + 0.1 * f(depth, D), 0.1 * f(depth, D), f(depth, D, 3 * D, sc=s).to(dt),
               0.1 * f(depth, 3 * D), f(depth, D, D, sc=s).to(dt), 0.1 * f(depth, D),
               1 + 0.1 * f(depth, D), 0.1 * f(depth, D), f(depth, D, hid, sc=s).to(dt),
               0.1 * f(depth, hid), f(depth, hid, D, sc=hid ** -0.5).to(dt), 0.1 * f(depth, D),
               1 + 0.1 * f(D), 0.1 * f(D), f(D, E, sc=s)]
    return x0, eot_pos, onehot, cot, weights


def text_library(C, L, D, H, depth, E, dt, x0, eot_pos):
    """The port's plain-PyTorch ``TextTransformer`` (route "off") and one
    of its blocks, on the card, for the library times: forward, and
    forward + backward to the input."""
    cfg = ntext.TextConfig(vocab_size=8, context_length=max(L, 77), width=D, layers=depth,
                           heads=H, embed_dim=E)
    text = ntext.TextTransformer(cfg, dtype=dt).to(DEV)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in text.named_parameters():
            if name.endswith("kernel") or name == "text_projection":
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[0] ** -0.5)
            p.requires_grad_(False)
    mask = text.mask[:L, :L]

    def block():
        with torch.no_grad():
            return text.block_0(x0, mask)

    def forward():
        with torch.no_grad():
            return text(x0, eot_pos)

    def forward_backward():
        x = x0.detach().requires_grad_(True)
        return torch.autograd.grad(text(x, eot_pos).float().sum(), x)

    def forward_with_graph():
        return text(x0.detach().requires_grad_(True), eot_pos)

    return block, forward, forward_backward, forward_with_graph


def text_ops(C, L, D, H, hid, depth, E):
    """Operations of the tower's forward and of its backward kernel:
    every product at 2 per multiply-add, attention counted to the
    diagonal (what the causal loops run)."""
    R, d = C * L, D // H
    tri = C * H * (L * (L + 1) // 2) * d * 2  # one causal product
    fwd_layer = 2 * R * (3 * D * D + D * D + 2 * D * hid) + 2 * tri
    epilogue = 2 * C * (L * D + D * E)
    # backward: qkv, out_proj and c_fc recomputed; one product per forward
    # product for the input cotangent; four more attention products
    bwd_layer = 2 * R * (3 * D * D + D * D + D * hid) + 2 * tri \
        + 2 * R * (2 * D * hid + D * D + 3 * D * D) + 4 * tri
    return depth * fwd_layer + epilogue, depth * bwd_layer + 2 * epilogue, fwd_layer


def text_gemm_ops(R, D, hid, depth):
    """Operations of the GEMMs alone: one block, the tower's forward and
    its backward (the recomputed qkv, out_proj and c_fc, and the four
    input-cotangent products)."""
    layer = 2 * R * (3 * D * D + D * D + 2 * D * hid)
    bwd = 2 * R * (3 * D * D + D * D + D * hid) + 2 * R * (2 * D * hid + D * D + 3 * D * D)
    return layer, depth * layer, depth * bwd


def text_shapes():
    """(C, L, D, heads, depth, E, tag): a small shape; the slice (40 prompts,
    L from the prompts); CLIP's full context, which the bf16 attention pads
    to 80; and 37 x 77 = 2849 rows, a multiple of neither 64 nor 128."""
    L_slice = int(mn40_prompts().perm_tokens.shape[1])
    return ((5, 13, 128, 4, 2, 96, "small"), (40, L_slice, 512, 8, 12, 512, "slice"),
            (40, 77, 512, 8, 12, 512, "ctx77"), (37, 77, 512, 8, 2, 512, "ragged"))


def check_text(results):
    """Phase 3 for the text path: fused_text_block, fused_text_tower (with
    and without block outputs) and fused_text_tower_bwd at every shape of
    text_shapes(), then timed at the slice in alternated rounds with the
    plain-PyTorch TextTransformer, with the GEMMs' rate and the kernels
    launched a call per entry point, under the profiler."""
    for C, L, D, H, depth, E, tag in text_shapes():
        for dname, dt in DTYPES.items():
            x0, eot_pos, onehot, cot, w = text_inputs(C, L, D, depth, E, dt, seed=L + depth)
            w0 = [t[0] for t in w[:12]]
            with torch.no_grad():
                blk = ktextblock.fused_text_block(x0, *w0, H)
                blk2 = ktextblock.fused_text_block(x0, *w0, H)
                blk_want = ktextblock.text_block_plain(x0, *w0, H)
                out = ktower.tower_forward(x0, onehot, w, H)
                out_res, xs = ktower.tower_forward(x0, onehot, w, H, want_blocks=True)
                out2, xs2 = ktower.tower_forward(x0, onehot, w, H, want_blocks=True)
                out_want, xs_want = ktower.text_tower_plain(x0, onehot, *w, H, return_blocks=True)
                dx = ktower.tower_backward(cot, x0, xs, onehot, w, H)
                dx2 = ktower.tower_backward(cot, x0, xs, onehot, w, H)
                dx_want = ktower.text_tower_bwd_plain(cot, x0, xs, onehot, *w, H)
            torch.cuda.synchronize()
            errs = {"block": rel_err(blk, blk_want), "tower": rel_err(out, out_want),
                    "tower_res": rel_err(out_res, out_want), "xs": rel_err(xs, xs_want),
                    "bwd": rel_err(dx, dx_want)}
            same = (torch.equal(blk, blk2) and torch.equal(out, out_res)
                    and torch.equal(out_res, out2) and torch.equal(xs, xs2)
                    and torch.equal(dx, dx2))
            print(f"[kernel] text {tag} {dname} C={C} L={L} D={D} H={H} depth={depth}: max rel "
                  f"err block {errs['block']:.3e}, tower {errs['tower']:.3e}, tower with block "
                  f"outputs {errs['tower_res']:.3e}, block outputs {errs['xs']:.3e} (tol "
                  f"{TOL[dname]}); backward d_x0 {errs['bwd']:.3e} (tol {TOL_TEXT_BWD[dname]}); "
                  f"two runs bit-identical: {same}")
            check(all(torch.isfinite(t.float()).all() for t in (blk, out, xs, dx)),
                  f"text kernels non-finite at {tag} {dname}")
            for k in ("block", "tower", "tower_res", "xs"):
                check(errs[k] <= TOL[dname], f"text {k} {tag} {dname} error {errs[k]}")
            check(errs["bwd"] <= TOL_TEXT_BWD[dname],
                  f"fused_text_tower_bwd {tag} {dname} error {errs['bwd']}")
            check(same, f"text kernels {tag} {dname} differ between two runs")
            if tag != "slice":
                continue
            hid, R = 4 * D, C * L
            if dname == "f32":
                f32_ms = {"block": gpu_time_ms(lambda: ktextblock._block_run(x0, *w0, H)),
                          "tower": gpu_time_ms(lambda: ktower.tower_forward(x0, onehot, w, H)),
                          "res": gpu_time_ms(lambda: ktower.tower_forward(
                              x0, onehot, w, H, want_blocks=True)),
                          "bwd": gpu_time_ms(lambda: ktower.tower_backward(
                              cot, x0, xs, onehot, w, H))}
                print(f"[kernel] text slice f32 (CUDA cores): block {f32_ms['block']:.3f} ms, "
                      f"tower {f32_ms['tower']:.3f} ms, with block outputs {f32_ms['res']:.3f} "
                      f"ms, backward {f32_ms['bwd']:.3f} ms")
                continue
            with torch.no_grad():
                plain_blk = gpu_time_ms(lambda: ktextblock.text_block_plain(x0, *w0, H), reps=5)
                plain_fwd = gpu_time_ms(lambda: ktower.text_tower_plain(x0, onehot, *w, H),
                                        reps=3, warmup=1)
                plain_bwd = gpu_time_ms(
                    lambda: ktower.text_tower_bwd_plain(cot, x0, xs, onehot, *w, H),
                    reps=3, warmup=1)
            lib_block, lib_fwd, lib_fwd_bwd, lib_graph = text_library(
                C, L, D, H, depth, E, dt, x0, eot_pos)
            fns = {"block": lambda: ktextblock._block_run(x0, *w0, H),
                   "tower": lambda: ktower.tower_forward(x0, onehot, w, H),
                   "res": lambda: ktower.tower_forward(x0, onehot, w, H, want_blocks=True),
                   "bwd": lambda: ktower.tower_backward(cot, x0, xs, onehot, w, H),
                   "lib_block": lib_block, "lib_fwd": lib_fwd, "lib_fwd_bwd": lib_fwd_bwd,
                   "lib_graph": lib_graph}
            ms = alternated_ms(fns)
            print("[kernel] text slice bf16, alternated rounds (median of 5), ms: "
                  + json.dumps({k: round(v, 4) for k, v in ms.items()}))
            gemm_ops = dict(zip(("block", "tower", "bwd"), text_gemm_ops(R, D, hid, depth)))
            profs = {k: tprofile.profile_calls(fns[k]) for k in ("block", "tower", "bwd")}
            gemm_ms = {k: p["device_ms_per_batch"]["text: GEMMs"] for k, p in profs.items()}
            per_call = {k: sum(v["launches"] for v in p["text_kernels_per_batch"].values())
                        for k, p in profs.items()}
            check(all(per_call.values()), f"the profiler saw no text kernel in a call: {per_call}")
            tflops = {k: gemm_ops[k] / (gemm_ms[k] * 1e-3) / 1e12 for k in gemm_ms}
            print("[kernel] text slice bf16 GEMMs: " + ", ".join(
                f"{k} {gemm_ms[k]:.4f} ms, {gemm_ops[k] / 1e9:.1f} GFLOP, {tflops[k]:.1f} TFLOP/s"
                for k in gemm_ms) + "; text kernels a call, profiled: "
                + ", ".join(f"{k} {per_call[k]:g}" for k in per_call))
            fwd_ops, bwd_ops, layer_ops = text_ops(C, L, D, H, hid, depth, E)
            layer_w = 2 * (3 * D * D + D * D + 2 * D * hid) + 4 * (9 * D + hid)
            act = R * D * 2
            bms, by = bound_ms(2 * act + layer_w, layer_ops, PEAK["bf16"])
            results["fused_text_block"] = dict(
                max_abs_err=float((blk.float() - blk_want.float()).abs().max()), ms=ms["block"],
                plain_ms=plain_blk, bound_ms=bms, bound_by=by, library_ms=ms["lib_block"],
                f32_ms=f32_ms["block"], gemm_ms=gemm_ms["block"], gemm_tflops=tflops["block"])
            tower_b = act + C * L * 4 + depth * layer_w + 4 * (2 * D + D * E) + C * E * 4
            bms, by = bound_ms(tower_b, fwd_ops, PEAK["bf16"])
            bms_res, _ = bound_ms(tower_b + depth * act, fwd_ops, PEAK["bf16"])
            results["fused_text_tower"] = dict(
                max_abs_err=float((out - out_want).abs().max()), ms=ms["tower"],
                plain_ms=plain_fwd, bound_ms=bms, bound_by=by, library_ms=ms["lib_fwd"],
                res_ms=ms["res"], res_bound_ms=bms_res, res_library_ms=ms["lib_graph"],
                f32_ms=f32_ms["tower"], f32_res_ms=f32_ms["res"],
                gemm_ms=gemm_ms["tower"], gemm_tflops=tflops["tower"],
                device_kernels_per_call=per_call["tower"])
            bms, by = bound_ms(tower_b + depth * act + act, bwd_ops, PEAK["bf16"])
            results["fused_text_tower_bwd"] = dict(
                max_abs_err=float((dx.float() - dx_want.float()).abs().max()), ms=ms["bwd"],
                plain_ms=plain_bwd, bound_ms=bms, bound_by=by,
                library_ms=ms["lib_fwd_bwd"] - ms["lib_graph"],
                library_fwd_bwd_ms=ms["lib_fwd_bwd"], fwd_bwd_ms=ms["res"] + ms["bwd"],
                f32_ms=f32_ms["bwd"], gemm_ms=gemm_ms["bwd"], gemm_tflops=tflops["bwd"],
                device_kernels_per_call=per_call["bwd"])
            print(f"[kernel] text slice bf16: forward + backward to x0, kernels "
                  f"{ms['res'] + ms['bwd']:.3f} ms, the plain-PyTorch TextTransformer "
                  f"{ms['lib_fwd_bwd']:.3f} ms (its forward alone {ms['lib_fwd']:.3f} ms, with "
                  f"a graph {ms['lib_graph']:.3f} ms)")


# (tag, B, [(N, S, radius, nsample, F or 0), ...]): each tower's ball queries in
# call order, at the batch phase 7 gives it; F is the width of the gathered
# features (PointNeXt's stem and stages, SSG's sa1 output), 0 where the tower
# gathers none inside the kernel.
BALL_SHAPES = (
    ("pn_next", 128, [(1024, 512, 0.15, 32, 32), (512, 256, 0.225, 32, 64),
                      (256, 128, 0.3375, 32, 128), (128, 64, 0.50625, 32, 256)]),
    ("pn_ssg", 32, [(1024, 512, 0.2, 32, 0), (512, 128, 0.4, 64, 128)]),
    ("pn_msg", 32, [(1024, 512, 0.1, 16, 0), (1024, 512, 0.2, 32, 0), (1024, 512, 0.4, 128, 0),
                    (512, 128, 0.2, 32, 0), (512, 128, 0.4, 64, 0), (512, 128, 0.8, 128, 0)]),
)


def ball_library(radius, nsample, xyz, q, feats):
    """Library calls for the same function: distance mask, top-k of the
    masked indices, gathers."""
    B, N, _ = xyz.shape
    hit = torch.cdist(q, xyz) <= radius
    masked = torch.where(hit, torch.arange(N, device=xyz.device), N)
    idx = torch.topk(masked, nsample, dim=-1, largest=False, sorted=True).values
    idx = torch.where(idx == N, idx[..., :1], idx).clamp_max(N - 1)
    flat = idx.reshape(B, -1, 1)
    rel = torch.gather(xyz, 1, flat.expand(-1, -1, 3)).reshape(*idx.shape, 3) - q[:, :, None]
    if feats is None:
        return idx, rel
    F_ = feats.shape[-1]
    return idx, rel, torch.gather(feats, 1, flat.expand(-1, -1, F_)).reshape(*idx.shape, F_)


def ball_bound(xyz, q, idx, feats):
    """Bytes: coordinates, centres and features read once, indices,
    coordinates and gathered rows written once. Operations: the 9 of a
    distance test (3 sub, 3 mul, 2 add, 1 compare) for every point a query
    has to look at on this data: up to its `nsample`-th hit, or all N."""
    B, N, _ = xyz.shape
    S, ns = idx.shape[1:]
    full = idx[..., -1] != idx[..., 0] if ns > 1 else torch.ones_like(idx[..., 0], dtype=torch.bool)
    looked = torch.where(full, idx[..., -1].long() + 1, N).sum().item()
    nbytes = B * N * 12 + B * S * 12 + B * S * ns * 16
    if feats is not None:
        row = feats.shape[-1] * feats.element_size()
        nbytes += B * N * row + B * S * ns * row
    return bound_ms(nbytes, 9 * looked, PEAK["f32"]), looked / (B * S * N)


def ball_floor_ms(B, N, S, ns):
    """A kernel that returns at once, launched on the ball query's grid,
    block and shared memory and queued as the kernels are: the least time
    a launch of that shape takes. None for a build of group.cu from
    before the floor's entry point, timed beside this one for comparison."""
    if not hasattr(_build.load("group"), "ppt_ball_launch_floor"):
        return None
    lib = kgroup._lib()
    args = (B, N, S, ns, *kgroup._ball_plan(B, S),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return queued_ms(lambda: _build.check(lib, lib.ppt_ball_launch_floor(*args), "launch floor"))


def check_one_ball(tag, radius, ns, xyz, q, feat_list, results=None):
    """The three wrappers at one shape against the plain versions; with
    ``results`` also queued times in alternated rounds with the library
    calls (median of 5), the launch floor, bounds and plain times."""
    B, N, _ = xyz.shape
    S = q.shape[1]
    widx, wrel = kgroup.ball_query_gather_plain(radius, ns, xyz, q)
    idx, rel = kgroup.ball_query_gather(radius, ns, xyz, q)
    idx_b, rel_b = kgroup.ball_query_gather(radius, ns, xyz, q)
    idx2, rel2 = kgroup.ball_query_gather_v2(radius, ns, xyz, q)
    idx2_b, rel2_b = kgroup.ball_query_gather_v2(radius, ns, xyz, q)
    torch.cuda.synchronize()
    n_bad, n_bad2 = int((idx != widx).sum()), int((idx2 != widx).sum())
    err = float((rel - wrel).abs().max())
    same = (torch.equal(idx, idx_b) and torch.equal(rel, rel_b) and torch.equal(idx2, idx2_b)
            and torch.equal(rel2, rel2_b))
    v2_same = torch.equal(idx, idx2) and torch.equal(rel, rel2)
    short = float((widx[..., -1] == widx[..., 0]).float().mean()) if ns > 1 else 0.0
    msg = (f"[kernel] ball query {tag} B={B} N={N} S={S} r={radius} ns={ns}: index mismatches "
           f"{n_bad} (v2 {n_bad2}), max |d rel| {err:.1e}, v2 == v1 bit for bit {v2_same}, "
           f"two runs identical {same}, short rows {short:.3f}")
    check(n_bad == 0 and n_bad2 == 0, f"ball query indices differ at {tag}")
    check(err <= 1e-6, f"ball query coordinates differ at {tag}")
    check(v2_same, f"ball_query_gather_v2 differs from ball_query_gather at {tag}")
    check(same, f"ball query differs between two runs at {tag}")
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    for feats in feat_list:
        fname = names[feats.dtype]
        fi, fr, fj = kgroup.ball_query_gather_feats(radius, ns, xyz, q, feats)
        _, _, fj_b = kgroup.ball_query_gather_feats(radius, ns, xyz, q, feats)
        _, _, wfj = kgroup.ball_query_gather_feats_plain(radius, ns, xyz, q, feats)
        torch.cuda.synchronize()
        ok = (torch.equal(fi, widx) and torch.equal(fr, rel) and torch.equal(fj, wfj)
              and torch.equal(fj, fj_b))
        msg += f"; feats {fname} F={feats.shape[-1]} exact {ok}"
        check(ok, f"ball_query_gather_feats differs at {tag} {fname}")
    print(msg)
    if results is None:
        return

    def add(name, row):
        acc = results.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                            library_ms=0.0, shapes=[]))
        acc["max_abs_err"] = max(acc["max_abs_err"], row.pop("max_abs_err"))
        for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
            acc[k] += row[k]
        acc["shapes"].append(row)

    fns = {"ball_query_gather": lambda: kgroup.ball_query_gather(radius, ns, xyz, q),
           "ball_query_gather_v2": lambda: kgroup.ball_query_gather_v2(radius, ns, xyz, q),
           "library": lambda: ball_library(radius, ns, xyz, q, None)}
    for feats in feat_list:
        fns[f"feats_{names[feats.dtype]}"] = (
            lambda f=feats: kgroup.ball_query_gather_feats(radius, ns, xyz, q, f))
        fns[f"library_{names[feats.dtype]}"] = lambda f=feats: ball_library(radius, ns, xyz, q, f)
    t = alternated_ms(fns, timer=queued_ms)
    floor = ball_floor_ms(B, N, S, ns)
    shape = dict(tag=tag, B=B, N=N, S=S, radius=radius, nsample=ns, floor_ms=floor)
    (bms, by), looked = ball_bound(xyz, q, widx, None)
    plain_ms = gpu_time_ms(lambda: kgroup.ball_query_gather_plain(radius, ns, xyz, q), reps=3,
                           warmup=1)
    line = (f"[kernel] ball query {tag} B={B} N={N} S={S} ns={ns}, ms queued: ball_query_gather "
            f"{t['ball_query_gather']:.4f} (launch floor "
            f"{'not built' if floor is None else f'{floor:.4f}'}, bound {bms:.4f} {by}, library "
            f"{t['library']:.4f}, plain {plain_ms:.3f}), v2 {t['ball_query_gather_v2']:.4f}")
    for name in ("ball_query_gather", "ball_query_gather_v2"):
        add(name, dict(shape, max_abs_err=err, ms=t[name], plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=t["library"], points_looked_at=looked))
    for feats in feat_list:
        fname = names[feats.dtype]
        (bms, by), _ = ball_bound(xyz, q, widx, feats)
        row = dict(shape, F=feats.shape[-1], dtype=str(feats.dtype).split(".")[1],
                   max_abs_err=err, bound_ms=bms, bound_by=by, points_looked_at=looked,
                   ms=t[f"feats_{fname}"], library_ms=t[f"library_{fname}"],
                   plain_ms=gpu_time_ms(lambda: kgroup.ball_query_gather_feats_plain(
                       radius, ns, xyz, q, feats), reps=3, warmup=1))
        line += (f"; feats {fname} F={feats.shape[-1]} {row['ms']:.4f} (bound {bms:.4f}, "
                 f"library {row['library_ms']:.4f}, plain {row['plain_ms']:.3f})")
        # the dtype the bf16 towers hand the kernel: PointNeXt casts before the
        # gather, PointNet++ gathers its BatchNorm's f32 output
        if (feats.dtype == torch.float32) == tag.startswith("pn_ssg"):
            add("ball_query_gather_feats", row)
        else:
            results.setdefault("ball_query_gather_feats_other_dtype", []).append(row)  # checked too
    print(line)


def check_ballquery(results):
    """Phase 3 for the ball-query towers. A tower's clouds are a cascade:
    each stage queries the FPS subset the stage before it kept."""
    # small: odd nsample, N not a multiple of 32, a query with no hit, short rows
    xyz = cloud(2, 77, 77)
    q = torch.gather(xyz, 1, kgroup.fps_plain(xyz, 9).long()[:, :, None].expand(-1, -1, 3)).clone()
    q[0, 1] = 40.0
    g = torch.Generator().manual_seed(7)
    small_feats = [torch.randn(2, 77, 5, generator=g).to(DEV).bfloat16(),  # 10-byte rows
                   torch.randn(2, 77, 6, generator=g).to(DEV),             # 24-byte rows
                   torch.randn(2, 77, 32, generator=g).to(DEV).bfloat16(),  # 64-byte rows
                   torch.randn(2, 77, 1, generator=g).to(DEV).bfloat16()]  # 2-byte rows
    check_one_ball("small", 0.3, 7, xyz, q, small_feats)
    empty, _ = kgroup.ball_query_gather(0.3, 7, xyz, q)
    check(bool((empty[0, 1] == 76).all()), "a query with no hit must give N - 1")

    # a point at exactly the radius is inside (d <= r*r); the next float is not
    edge = torch.full((1, 40, 3), 9.0, device=DEV)
    edge[0, :3] = torch.tensor([[0.0, 0, 0], [0.5, 0, 0], [0.5000001, 0, 0]])
    origin = torch.zeros(1, 8, 3, device=DEV)
    check_one_ball("boundary", 0.5, 4, edge, origin, [])
    at_radius, _ = kgroup.ball_query_gather(0.5, 4, edge, origin)
    check(at_radius[0, 0].tolist() == [0, 1, 0, 0], "a point at the radius must be a hit")

    # the walk's edges: one cloud of more than one staging chunk (hits across
    # chunks; a ball that fills part way, one that walks every chunk; v2 too,
    # past the 19370 points its old kernel's shared memory held), S
    # ragged against the CTA's query tile, nsample == N past the warp's ring
    # of picks (written out part way through the walk), a cloud taken whole
    for tag, B, N, S, radius, ns, F_ in (
            ("n20000", 1, 20000, 100, 0.1, 64, 32), ("n20000_walk_all", 1, 20000, 96, 0.05, 64, 0),
            ("ragged_s", 3, 1024, 37, 0.2, 32, 64), ("ns_eq_n", 2, 300, 40, 0.5, 300, 6),
            ("n128_ns_eq_n", 2, 128, 24, 0.3, 128, 1)):
        xyz = cloud(B, N, N + S)
        q = torch.gather(xyz, 1, kgroup.fps_plain(xyz, S).long()[:, :, None].expand(-1, -1, 3))
        f32 = torch.randn(B, N, F_, generator=g).to(DEV)
        check_one_ball(tag, radius, ns, xyz, q, [f32.bfloat16(), f32] if F_ else [])

    for bad in (lambda: kgroup.fps_batched(cloud(1, 64, 1), 65),
                lambda: kgroup.fps_batched(cloud(1, kgroup.FPS_MAX_POINTS + 1, 1), 8)):
        try:
            bad()
        except ValueError as e:
            print(f"[kernel] fps_batched refuses: {e}")
        else:
            check(False, "fps_batched took a shape it cannot run")

    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    for tag, B, stages in BALL_SHAPES:
        pts = make_synthetic(num_classes=40, samples_per_class=-(-B // 40), npoints=1024,
                             seed=3, classnames=names).points[:B]
        level = {1024: torch.from_numpy(pts).to(DEV)}
        g = torch.Generator().manual_seed(B)
        for N, S, radius, ns, F_ in stages:
            xyz = level[N]
            fidx = kgroup.fps_batched(xyz, S)
            want = kgroup.fps_plain(xyz, S)
            torch.cuda.synchronize()
            n_bad = int((fidx != want).sum())
            fps_ms = gpu_time_ms(lambda: kgroup.fps_batched(xyz, S))
            print(f"[kernel] fps_batched {tag} B={B} N={N} -> {S}: index mismatches {n_bad}, "
                  f"{fps_ms:.3f} ms")
            check(n_bad == 0, f"fps_batched indices differ at {tag} N={N}")
            q = torch.gather(xyz, 1, fidx.long()[:, :, None].expand(-1, -1, 3))
            level.setdefault(S, q)
            feats = []
            if F_:
                f32 = torch.randn(B, N, F_, generator=g).to(DEV)
                feats = [f32.bfloat16(), f32]
            check_one_ball(f"{tag}/N{N}", radius, ns, xyz, q, feats, results)
            results.setdefault("fps_by_shape", []).append(
                dict(tag=tag, B=B, N=N, npoint=S, ms=fps_ms))
    for name in BALL_KERNELS:
        r = results[name]
        r["cuda_kernel"] = ("ball_query_feats_kernel" if name == "ball_query_gather_feats"
                            else "ball_query_kernel")  # v2: the same walk as ball_query_gather
        # one bound for the sum over the shapes: what bounds most of it
        by = collections.Counter()
        for row in r["shapes"]:
            by[row["bound_by"]] += row["bound_ms"]
        r["bound_by"] = by.most_common(1)[0][0]


# (B, N, M, tag): the dVAE's per-group clouds (B*G = 64*64 groups; coarse 8
# and fine 32 points against each 32-point neighbourhood), kernel_check's
# reconstruction scale (tools/kernel_check.py:190-195), the 16k-point
# clouds of the Chamfer kernel's docstring, N and M that are multiples of
# neither a query group (2 or 4), the block (128 threads) nor a support
# chunk, and M = 1. The row's headline is the reconstruction scale, the
# shape the reference's own on-chip check takes.
NN_SHAPES = ((4096, 8, 32, "dvae_coarse"), (4096, 32, 32, "dvae_fine"), (8, 2048, 2048, "recon"),
             (4, 16384, 16384, "16k"), (3, 1001, 777, "ragged"), (5, 37, 1, "m1"))
# the dVAE's two EMD terms, the reference's small shape, kernel_check's
# (tools/kernel_check.py:201-204), one whose supply vectors alone pass a
# block's shared memory (the device-scratch path), and the warp kernel's
# edges: N on the lanes, 31 and 1 points a side, and one point past its
# limit on either side. The headline is the dVAE's step: its coarse and
# fine terms together.
EMD_SHAPES = ((4096, 8, 32, "dvae_coarse"), (4096, 32, 32, "dvae_fine"), (4, 64, 32, "small"),
              (4, 1024, 768, "kernel_check"), (2, 1, 30000, "scratch"), (64, 32, 8, "lanes_n"),
              (64, 31, 31, "ragged"), (64, 1, 32, "n1"), (64, 32, 33, "past_m"),
              (64, 33, 32, "past_n"))


def chamfer_library(a, b):
    """One PyTorch call per direction: cdist, squared, min."""
    return torch.cdist(a, b).square().amin(-1), torch.cdist(b, a).square().amin(-1)


def nn_both(a, b):
    """Both directions the way ``chamfer`` runs them: one launch, or two
    with a build from before ``nn_dists_both``, timed beside this one."""
    both = getattr(kchamfer, "nn_dists_both", None)
    return both(a, b) if both else (kchamfer.nn_dists(a, b), kchamfer.nn_dists(b, a))


def losses3d_floor(name, *args):
    """Queued time of an empty kernel launched as the loss kernel is (grid,
    block, cluster, shared memory): None for a build of losses3d.cu from
    before the floor's entry points, timed beside this one."""
    try:
        from ppt_torch.kernels import _losses3d
    except ImportError:
        return None
    lib = _losses3d.lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    return queued_ms(lambda: _build.check(lib, getattr(lib, name)(*args, stream), "launch floor"))


def sm_clock_hz():
    """The card's highest SM clock (nvidia-smi), for the issue floor."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def nn_plan_sweep():
    """Queued ms of nn_dists, both directions in one launch, at each of
    NN_SHAPES for every (queries a thread, split): the measurement
    kernels/chamfer.py:nn_plan is read from. None for a build from before
    the plan, timed beside this one."""
    try:
        from ppt_torch.kernels import _losses3d
    except ImportError:
        return None
    lib, P = _losses3d.lib(), _build.ptr
    g = torch.Generator().manual_seed(23)
    table = {}
    for B, N, M, tag in NN_SHAPES:
        a, b = (torch.rand(B, n, 3, generator=g).to(DEV) for n in (N, M))
        da, db = torch.empty(B, N, device=DEV), torch.empty(B, M, device=DEV)
        stream = _build.stream_ptr(a)

        def run(q, split):
            _build.check(lib, lib.ppt_nn_dists(P(a), P(b), P(da), B, N, M, P(b), P(a), P(db),
                                               B, M, N, q, split, stream), "nn_dists")

        row = {f"{q}/{split}": queued_ms(lambda: run(q, split))
               for q in kchamfer.QUERIES for split in (1, 2, 4, 8)}
        plan = "%d/%d" % kchamfer.nn_plan([(B, N, M), (B, M, N)])
        best = min(row, key=row.get)
        print(f"[sweep] nn_dists {tag} B={B} N={N} M={M}: plan {plan} {row[plan]:.4f} ms, best "
              f"{best} {row[best]:.4f}; queries/split: "
              + " ".join(f"{k} {v:.4f}" for k, v in row.items()))
        table[tag] = dict(row, plan=plan)
    return table


def check_losses3d(results):
    """Phase 3 for the reconstruction-loss kernels: nn_dists bit-equal to
    its plain version both ways, alone and in chamfer's one launch (and
    chamfer's value and gradient to the plain recompute's), approx_match's
    match within 1e-4 and its cost within 1e-4 relative of the plain
    auction's, repeats bit-identical; times with the launches queued, in
    alternated rounds with the library call (median of 5), beside each
    shape's launch floor."""
    g = torch.Generator().manual_seed(17)
    clock = sm_clock_hz()
    rows = []
    for B, N, M, tag in NN_SHAPES:
        a, b = (torch.rand(B, n, 3, generator=g).to(DEV) for n in (N, M))
        one = (kchamfer.nn_dists(a, b), kchamfer.nn_dists(b, a))
        got = nn_both(a, b)
        want = (kchamfer.nn_dists_plain(a, b), kchamfer.nn_dists_plain(b, a))
        again = nn_both(a, b)
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) and torch.equal(x, z) and torch.equal(x, r)
                    for x, y, z, r in zip(got, want, one, again))
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        check(equal, f"chamfer_nn_dists differs from its plain version at {tag} (max |diff| "
                     f"{err:.1e})")
        nbytes = (B * N + B * M) * 12 + (B * N + B * M) * 4  # each cloud read once, both minima
        pairs = 2 * B * N * M
        bms, by = bound_ms(nbytes, 9 * pairs, PEAK["f32"])  # 3 sub, 3 mul, 2 add, min
        t = alternated_ms({"kernel": lambda: nn_both(a, b),
                           "library": lambda: chamfer_library(a, b)}, timer=queued_ms)
        plan = kchamfer.nn_plan([(B, N, M), (B, M, N)]) if hasattr(kchamfer, "nn_plan") else None
        floor = losses3d_floor("ppt_nn_launch_floor", B, N, M, B, M, N, *plan) if plan else None
        row = dict(tag=tag, B=B, N=N, M=M, max_abs_err=err, bound_ms=bms, bound_by=by,
                   # 9 instructions a pair, issued one a cycle by each of an SM's 4
                   # schedulers for 32 lanes, at the highest SM clock
                   issue_floor_ms=9 * pairs / (132 * 4 * 32 * clock) * 1e3,
                   ms=t["kernel"], library_ms=t["library"], floor_ms=floor, plan=plan,
                   plain_ms=gpu_time_ms(lambda: (kchamfer.nn_dists_plain(a, b),
                                                 kchamfer.nn_dists_plain(b, a)), reps=2, warmup=1))
        rows.append(row)
        print(f"[kernel] chamfer_nn_dists {tag} B={B} N={N} M={M}, both directions: bit-equal to "
              f"the plain version, one direction at a time and in one launch, repeats "
              f"identical {equal}; ms queued {row['ms']:.4f} (launch floor "
              f"{'not built' if floor is None else f'{floor:.4f}'}, queries/split {plan}), library "
              f"{row['library_ms']:.4f}, plain {row['plain_ms']:.3f}, bound {bms:.4f} ({by}), "
              f"issue floor {row['issue_floor_ms']:.4f}")
    a = torch.rand(4, 500, 3, generator=g).to(DEV).requires_grad_()
    b = torch.rand(4, 300, 3, generator=g).to(DEV).requires_grad_()
    value = kchamfer.chamfer(a, b)
    ga, gb = torch.autograd.grad(value, [a, b])
    wa, wb = torch.autograd.grad(chamfer_l2(a, b), [a, b])
    same = (float(value.detach()) == float(kchamfer.chamfer_plain(a.detach(), b.detach()))
            and torch.equal(ga, wa) and torch.equal(gb, wb))
    print(f"[kernel] chamfer 4 x 500 vs 300: value equal to chamfer_plain and gradients equal to "
          f"the plain chamfer_l2's {same}")
    check(same, "chamfer's value or gradient differs from the plain version")
    head = next(r for r in rows if r["tag"] == "recon")
    results["chamfer_nn_dists"] = dict(
        {k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        max_abs_err=max(r["max_abs_err"] for r in rows), headline=head["tag"], shapes=rows)

    rows = []
    warp_rule = getattr(kemd, "warp_auction", None)
    for B, N, M, tag in EMD_SHAPES:
        x1, x2 = torch.rand(B, N, 3, generator=g).to(DEV), torch.rand(B, M, 3, generator=g).to(DEV)
        match, again = kemd.approx_match(x1, x2), kemd.approx_match(x1, x2)
        want = kemd.approx_match_plain(x1, x2)
        d2 = kemd.match_d2(x1, x2)
        cost, cost_p = kemd.emd_matchcost(x1, x2), (d2 * want).sum((1, 2))
        torch.cuda.synchronize()
        err = float((match - want).abs().max())
        cost_rel = float(((cost - cost_p).abs() / cost_p.abs()).max())
        same = torch.equal(match, again)
        check(err <= 1e-4, f"approx_match's match differs from the plain auction at {tag}")
        check(cost_rel <= 1e-4, f"the EMD match cost differs from the plain version at {tag}")
        check(same, f"approx_match differs between two runs at {tag}")
        nbytes = 2 * B * N * M * 4  # d2 read, match written
        # per pair and level: the bid (mul, exp), suml (mul, add), sumr
        # (mul, add), the flow (2 mul) into match (add) and its row sum (add)
        bms, by = bound_ms(nbytes, 10 * len(kemd.LEVELS) * B * N * M, PEAK["f32"])
        warp = warp_rule(N, M) if warp_rule else None
        floor = (losses3d_floor("ppt_approx_match_floor", B, N, M, int(warp))
                 if warp is not None else None)
        row = dict(tag=tag, B=B, N=N, M=M, max_abs_err=err, cost_rel=cost_rel, bound_ms=bms,
                   bound_by=by, bit_equal=torch.equal(match, want), warp_kernel=warp,
                   ms=float(np.median([queued_ms(lambda: kemd._auction_run(d2))
                                       for _ in range(5)])),
                   floor_ms=floor,
                   plain_ms=gpu_time_ms(lambda: kemd.auction_plain(d2, *kemd.supplies(N, M)),
                                        reps=1, warmup=1))
        rows.append(row)
        print(f"[kernel] approx_match {tag} B={B} N={N} M={M} ({'warp' if warp else 'block'} "
              f"kernel): match max |diff| {err:.2e} (tol 1e-4; bit-equal {row['bit_equal']}), "
              f"cost rel {cost_rel:.2e} (tol 1e-4), repeats identical {same}, rows ship "
              f"{float(match.sum(2).min()):.6f}-{float(match.sum(2).max()):.6f}; ms queued "
              f"{row['ms']:.4f} (launch floor {'not built' if floor is None else f'{floor:.4f}'})"
              f", plain {row['plain_ms']:.3f}, bound {bms:.4f} ({by})")
    step = [r for r in rows if r["tag"].startswith("dvae_")]
    results["approx_match"] = dict(
        {k: sum(r[k] for r in step) for k in ("ms", "plain_ms", "bound_ms")},
        bound_by=collections.Counter(r["bound_by"] for r in step).most_common(1)[0][0],
        library_ms=None, max_abs_err=max(r["max_abs_err"] for r in rows),
        headline="dvae_coarse + dvae_fine", shapes=rows)


# (B, N, npoint, tag): the reference test's small cloud with duplicated points,
# the slice's 32 x 1024 -> 512, the long trunk's 32 x 8192 -> 1024 and the
# cap that fps_single shares with fps_batched (16 points a thread, the
# coordinates in shared memory). k = 32 at the three large shapes; the small
# one takes (k, S) = (1, 8), (8, 128), (32, 256).
CLOUD_SHAPES = ((2, 300, 64, "small"), (32, 1024, 512, "slice"), (32, 8192, 1024, "long"),
                (2, kfps.MAX_POINTS, 1024, "cap"))
CLOUD_SMALL_KNN = ((1, 8), (8, 128), (32, 256))
# (B, N, npoint, duplicated points): fps_single past N, as fps_pallas takes it
FPS_PAST_N = ((2, 77, 100, False), (2, 300, 400, True), (1, 1, 3, False))
# (B, N, S, k) around the cloud chunk of knn_single and knn_gather, as
# tests/test_torch_fps_knn.py and tests/test_torch_grouping.py take them: N just under, at and over it (a duplicated point across the
# border), k = 64 (two queue pairs a lane), k past 64 (passes), N = k
KNN_EDGES = ((1, kknn.CHUNK - 1, 128, 64), (1, kknn.CHUNK, 128, 32), (1, kknn.CHUNK + 1, 128, 40),
             (1, 300, 128, 100), (2, 48, 8, 48), (2, 5000, 256, 200))


def dup_cloud(B, N, seed):
    """A cloud whose every fourth point repeats another: exact ties."""
    xyz = cloud(B, N, seed)
    g = torch.Generator().manual_seed(seed + 1)
    src = torch.randint(0, N, (N // 4,), generator=g).to(DEV)
    xyz[:, 3::4] = xyz[:, src[: xyz[:, 3::4].shape[1]]]
    return xyz


def host_us_a_call(calls=1000):
    """The host's microseconds a call of each grouping wrapper: the wall time
    of `calls` calls queued without a sync, at a shape the card runs in a
    few microseconds (so the card keeps up and the queue never fills),
    beside the card's own time a call, queued. Printed, not claimed."""
    xyz = cloud(1, 256, 5)
    q = xyz[:, :32].contiguous()
    feats = torch.randn(1, 256, 32, generator=torch.Generator().manual_seed(5)).to(DEV).bfloat16()
    fns = {"fps_batched": lambda: kgroup.fps_batched(xyz, 32),
           "fps_single": lambda: kfps.fps_single(xyz, 32),
           "ball_query_gather": lambda: kgroup.ball_query_gather(0.2, 32, xyz, q),
           "ball_query_gather_v2": lambda: kgroup.ball_query_gather_v2(0.2, 32, xyz, q),
           "ball_query_gather_feats": lambda: kgroup.ball_query_gather_feats(0.2, 32, xyz, q,
                                                                             feats)}
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        out[name] = dict(host_us=host, card_us=queued_ms(fn) * 1e3)
        print(f"[host] {name}: {host:.3f} us a call on the host (the wall of {calls} calls "
              f"queued without a sync), the card {out[name]['card_us']:.3f} us a call (queued); "
              f"B=1 N=256, {'npoint' if 'fps' in name else 'S=nsample'} 32")
    return out


def check_cloud(results):
    """Phase 3 for fps_single and knn_single: indices identical to their plain
    versions and to fps_batched's / knn_gather's, repeats bit-identical,
    fps_single past N, refusals by name; times beside rows 1-2 and the
    library calls, in alternated rounds (rows 1-2 take their times from
    these rounds too); the grouping wrappers' host time a call. Rows 1-2's
    entries need not exist (``--only cloud``)."""
    timing = {}
    for B, N, npoint, tag in CLOUD_SHAPES:
        xyz = dup_cloud(B, N, N) if tag == "small" else cloud(B, N, N + npoint)
        got = kfps.fps_single(xyz, npoint)
        again = kfps.fps_single(xyz, npoint)
        want = kfps.fps_single_plain(xyz, npoint)
        row1 = kgroup.fps_batched(xyz, npoint)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        same = torch.equal(got, again) and torch.equal(got, row1)
        print(f"[kernel] fps_single {tag} B={B} N={N} npoint={npoint}: index mismatches {n_bad}; "
              f"repeat and fps_batched identical {same}")
        check(n_bad == 0 and same, f"fps_single indices differ at {tag}")
        if tag == "small":
            qsets = [(k, xyz[:, :S].contiguous()) for k, S in CLOUD_SMALL_KNN]
        else:
            qsets = [(32, torch.gather(xyz, 1, want.long()[:, :, None].expand(-1, -1, 3)))]
        for k, q in qsets:
            got_k = kknn.knn_single(k, xyz, q)
            again_k = kknn.knn_single(k, xyz, q)
            want_k = kknn.knn_single_plain(k, xyz, q)
            row2 = kgroup.knn_gather(k, xyz, q)[0]
            torch.cuda.synchronize()
            n_bad = int((got_k != want_k).sum())
            same = torch.equal(got_k, again_k) and torch.equal(got_k, row2)
            print(f"[kernel] knn_single {tag} B={B} N={N} S={q.shape[1]} k={k}: index "
                  f"mismatches {n_bad}; repeat and knn_gather identical {same}")
            check(n_bad == 0 and same, f"knn_single indices differ at {tag} k={k}")
        if tag == "small":
            continue
        k, q = qsets[0]
        S = q.shape[1]

        def library():
            return torch.topk(torch.cdist(q, xyz), k, dim=-1, largest=False).indices

        def gather_library():  # row 2's function: the picks' coordinates minus the query's
            i = torch.topk(torch.cdist(q, xyz), k, dim=-1, largest=False).indices
            nb = torch.gather(xyz, 1, i.reshape(B, S * k, 1).expand(-1, -1, 3))
            return i, nb.reshape(B, S, k, 3) - q[:, :, None, :]

        # knn_single and row 2 against their library calls, in alternated rounds
        timing[tag] = alternated_ms({"knn_single_ms": lambda: kknn.knn_single(k, xyz, q),
                                     "knn_library_ms": library,
                                     "knn_gather_ms": lambda: kgroup.knn_gather(k, xyz, q),
                                     "knn_gather_library_ms": gather_library})
        timing[tag]["knn_bound_ms"] = bound_ms(B * N * 12 + B * S * 12 + B * S * k * 4,
                                               B * S * N * 9, PEAK["f32"])[0]
        timing[tag]["knn_gather_bound_ms"] = bound_ms(
            B * N * 12 + B * S * 12 + B * S * k * 16, B * S * N * 9, PEAK["f32"])[0]
        timing[tag].update(alternated_ms(
            {"fps_single_ms": lambda: kfps.fps_single(xyz, npoint),
             "fps_batched_ms": lambda: kgroup.fps_batched(xyz, npoint)}))
        if tag != "slice":
            continue
        bms, by = bound_ms(B * N * 12 + B * npoint * 4, B * npoint * N * 10, PEAK["f32"])
        results["fps_single"] = dict(
            cuda_kernel="fps_batched_kernel", max_abs_err=0.0, ms=timing[tag]["fps_single_ms"],
            plain_ms=gpu_time_ms(lambda: kfps.fps_single_plain(xyz, npoint), reps=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=None)
        bms, by = bound_ms(B * N * 12 + B * S * 12 + B * S * k * 4, B * S * N * 9, PEAK["f32"])
        results["knn_single"] = dict(
            cuda_kernel="knn_single_kernel", max_abs_err=0.0, ms=timing[tag]["knn_single_ms"],
            plain_ms=gpu_time_ms(lambda: kknn.knn_single_plain(k, xyz, q), reps=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=timing[tag]["knn_library_ms"])
        results.setdefault("fps_batched", {})["ms"] = timing[tag]["fps_batched_ms"]
        results.setdefault("knn_gather", {}).update(
            ms=timing[tag]["knn_gather_ms"], library_ms=timing[tag]["knn_gather_library_ms"])
    for name, shapes in (("fps_single", "fps"), ("knn_single", "knn"), ("fps_batched", "fps"),
                         ("knn_gather", "knn")):
        results[name]["by_shape"] = {tag: {key: v for key, v in t.items() if key.startswith(shapes)}
                                     for tag, t in timing.items()}
    print(f"[kernel] fps_single / knn_single against rows 1-2, ms: {json.dumps(timing)}")

    # fps_single past N (fps_batched refuses it): the plain version's indices,
    # index 0 once the cloud's distinct points are spent
    for B, N, npoint, dup in FPS_PAST_N:
        xyz = dup_cloud(B, N, N + npoint) if dup else cloud(B, N, N + npoint)
        got = kfps.fps_single(xyz, npoint)
        want = kfps.fps_single_plain(xyz, npoint)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        distinct = len(torch.unique(xyz[0], dim=0))
        spent = bool((want[:, distinct:] == 0).all())
        print(f"[kernel] fps_single past N B={B} N={N} npoint={npoint} ({distinct} distinct "
              f"points): index mismatches {n_bad}; index 0 once they are spent {spent}")
        check(n_bad == 0 and spent, f"fps_single differs past N at N={N} npoint={npoint}")

    # the shapes around knn_single's chunk and queue, as the CPU tests take them
    for B, N, S, k in KNN_EDGES:
        xyz = dup_cloud(B, N, N + k)
        q = xyz[:, torch.randperm(N, generator=torch.Generator().manual_seed(S))[:S].to(DEV)]
        if N > kknn.CHUNK:  # a tie across the border
            xyz[:, kknn.CHUNK] = xyz[:, kknn.CHUNK - 1]
            q[:, 1] = xyz[:, kknn.CHUNK]
        got = kknn.knn_single(k, xyz, q)
        again = kknn.knn_single(k, xyz, q)
        want = kknn.knn_single_plain(k, xyz, q)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        print(f"[kernel] knn_single edge B={B} N={N} S={S} k={k}: index mismatches {n_bad}; "
              f"repeat identical {torch.equal(got, again)}")
        check(n_bad == 0 and torch.equal(got, again), f"knn_single differs at N={N} k={k}")
        knn_gather_vs_plain("edge", xyz, q, k)  # the same selection, the same edges

    # the shapes they refuse, by name
    xyz = cloud(1, 256, 1)
    for fn, msg in ((lambda: kknn.knn_single(4, xyz, cloud(1, 200, 2)), "knn_single: S=200"),
                    (lambda: kgroup.knn_gather(257, xyz, cloud(1, 8, 2)), "knn_gather: k=257"),
                    (lambda: kfps.fps_single(cloud(1, kfps.MAX_POINTS + 1, 3), 8),
                     f"fps_single: N={kfps.MAX_POINTS + 1}")):
        try:
            fn()
        except ValueError as e:
            check(msg in str(e), f"unexpected refusal: {e}")
        else:
            check(False, f"{msg} was not refused")
    results["host_us_a_call"] = host_us_a_call()


# B, L, C (the probe's 6 heads): a small shape (head dim 16) and the slice's
VARIANT_SHAPES = ((2, 33, 96, "small"), (32, 513, 384, "slice"))
VARIANT_RUNS = tuple((m, 1) for m in vitblock_probe.MODES) + (("full", 2),)


def variant_bound(B, L, C, mode):
    """The block's products (the attention's twice in qk_packed2) at the bf16
    peak, beside x and pos read, the output written and the weights read."""
    rows, hid = B * L, 4 * C
    attn = 4 * B * L * L * C * (2 if mode == "qk_packed2" else 1)
    ops = 2 * rows * (C * 3 * C + C * C + 2 * C * hid) + attn
    wbytes = 2 * (C * 3 * C + C * C + 2 * C * hid) + 4 * (7 * C + hid)
    return bound_ms(3 * rows * C * 2 + B * 2 * 4 + wbytes, ops, PEAK["bf16"])


def check_variant(results):
    """Phase 3 for the ablation probe's kernel: every mode, f32 and bf16,
    against its plain version; full and rows=2 bit-identical to
    fused_vit_block; qk_packed2 within the limits of full; repeats
    bit-identical; times of every mode at the slice's shape in bf16."""
    modes = {}
    for B, L, C, tag in VARIANT_SHAPES:
        for dname, dt in DTYPES.items():
            x, pos, dp, w, _ = block_inputs(B, L, C, dt, L + C)
            dp[0, 0], dp[-1, 1] = 0.0, 2.0  # DropPath scales: a zero and a 2
            H = vitblock_probe.HEADS
            prod = kvit.fused_vit_block(x, pos, dp, *w, H)
            outs = {}
            for mode, rows in VARIANT_RUNS:
                key = "rows2" if rows == 2 else mode
                got = vitblock_probe.variant_block(x, pos, dp, *w, mode=mode, rows=rows)
                again = vitblock_probe.variant_block(x, pos, dp, *w, mode=mode, rows=rows)
                want = vitblock_probe.variant_block_plain(x, pos, dp, *w, mode=mode, rows=rows)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                same = torch.equal(got, again)
                line = (f"[kernel] vit_variant {tag} {dname} B={B} L={L} C={C} {key}: max rel "
                        f"err {err:.3e} (tol {TOL[dname]}); repeat bit-identical {same}")
                if mode == "full":
                    ident = torch.equal(got, prod)
                    line += f"; bit-identical to fused_vit_block {ident}"
                    check(ident, f"vit_variant {key} differs from fused_vit_block at {tag} {dname}")
                if mode == "qk_packed2":
                    full_err = rel_err(got, outs["full"])
                    ident = torch.equal(got, outs["full"])
                    line += f"; against full {full_err:.3e}, bit-identical to full {ident}"
                    check(full_err <= TOL[dname], f"qk_packed2 strays from full at {tag} {dname}")
                print(line)
                check(torch.isfinite(got.float()).all(), f"vit_variant {key} non-finite")
                check(err <= TOL[dname], f"vit_variant {tag} {dname} {key} error {err}")
                check(same, f"vit_variant {tag} {dname} {key} differs between two runs")
                outs[key] = got
                if tag != "slice" or dname != "bf16":
                    continue
                bms, by = variant_bound(B, L, C, mode)
                lib = (gpu_time_ms(lambda: block_library(x, pos, dp, w, H))
                       if mode in ("full", "qk_packed2") else None)
                modes[key] = dict(
                    max_abs_err=float((got.float() - want.float()).abs().max()),
                    ms=gpu_time_ms(lambda: vitblock_probe.variant_block(x, pos, dp, *w, mode=mode,
                                                                         rows=rows)),
                    plain_ms=gpu_time_ms(lambda: vitblock_probe.variant_block_plain(
                        x, pos, dp, *w, mode=mode, rows=rows)),
                    bound_ms=bms, bound_by=by, library_ms=lib)
                if mode == "qk_packed2":
                    modes[key]["bit_identical_to_full"] = bool(torch.equal(got, outs["full"]))
    modes["rows2"]["library_ms"] = modes["full"]["library_ms"]  # the same function
    results["vit_variant"] = dict(modes["full"], headline="full", modes=modes)


# ---------------------------------------------------------------------------
# phase 4: the recognition path at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel calls to the plain PyTorch versions."""
    saved = (kgroup.fps_batched, kgroup.knn_gather, npb.mini_forward, npb.fused_vit_block,
             npb.fused_vit_block_readout, npb.mini_stats)
    saved_text = (ktextblock._block_run, ktower.tower_forward, ktower.tower_backward)
    saved_ball = (kgroup.ball_query_gather, kgroup._ball_feats_run)
    saved_route = (kattn._mha_run, kattn._flash_run, kvit._tower_run)
    saved_flash = (kattn._flash_fwd, kattn._flash_bwd)
    saved_emd = kemd._auction_run
    kemd._auction_run = lambda d2: kemd.auction_plain(d2, *kemd.supplies(*d2.shape[1:]))
    kattn._mha_run, kattn._flash_run = kattn.mha_plain, kattn.flash_plain
    kattn._flash_fwd = lambda q, k, v: (kattn.flash_plain(q, k, v), kattn.flash_lse_plain(q, k))
    kattn._flash_bwd = kattn.flash_bwd_plain
    kvit._tower_run = kvit.vit_tower_plain
    kgroup.ball_query_gather = kgroup.ball_query_gather_plain
    kgroup._ball_feats_run = kgroup.ball_query_gather_feats_plain
    ktextblock._block_run = ktextblock.text_block_plain
    ktower.tower_forward = lambda x0, eot, w, heads, want_blocks=False: ktower.text_tower_plain(
        x0, eot, *w, heads, return_blocks=want_blocks)
    ktower.tower_backward = lambda g, x0, xs, eot, w, heads: ktower.text_tower_bwd_plain(
        g, x0, xs, eot, *w, heads)
    kgroup.fps_batched = kgroup.fps_plain
    kgroup.knn_gather = kgroup.knn_gather_plain
    npb.mini_forward = kmini.mini_forward_plain
    npb.mini_stats = kmini.mini_stats_plain
    npb.fused_vit_block = kvit.vit_block_plain
    npb.fused_vit_block_readout = kvit.vit_block_readout_plain
    try:
        yield
    finally:
        (kgroup.fps_batched, kgroup.knn_gather, npb.mini_forward, npb.fused_vit_block,
         npb.fused_vit_block_readout, npb.mini_stats) = saved
        ktextblock._block_run, ktower.tower_forward, ktower.tower_backward = saved_text
        kgroup.ball_query_gather, kgroup._ball_feats_run = saved_ball
        kattn._mha_run, kattn._flash_run, kvit._tower_run = saved_route
        kattn._flash_fwd, kattn._flash_bwd = saved_flash
        kemd._auction_run = saved_emd


MN40_TEST_CLOUDS = 2468  # ModelNet40's test split


def run_slice(passes=5, batch=32, npoints=1024, seed=0):
    args = TaskArgs(dataset_name="modelnet40", npoints=npoints, batch_size=batch,
                    num_learnable_prompt_tokens=32, class_name_position="middle",
                    compute_dtype="bfloat16", evaluate_3d=True, seed=seed, device="cuda")
    classnames = args.load_classnames()  # the 40 ModelNet40 names
    check(len(classnames) == 40, "ModelNet40 class names")
    spec = build_prompt_spec(classnames, n_ctx=32, class_name_position="middle")
    prompts = PromptArrays.from_spec(spec, device=DEV)
    model = build_model("ULIP_PointBERT", args, device=DEV).model
    n_params = sum(p.numel() for p in model.parameters())
    full = make_synthetic(num_classes=40, samples_per_class=-(-MN40_TEST_CLOUDS // 40),
                          npoints=npoints, seed=seed + 1, classnames=classnames)
    ds = ArrayDataset(full.points[:MN40_TEST_CLOUDS], full.labels[:MN40_TEST_CLOUDS],
                      full.classnames, name=full.name)
    eval_fn = make_cached_text_eval(model)
    embed_fn, step_fn = eval_fn
    n_batches = math.ceil(len(ds) / batch)
    print(f"[slice] ULIP_PointBERT bf16: {n_params / 1e6:.1f} M parameters, "
          f"{len(ds)} clouds x {npoints} points, batch {batch} ({n_batches} batches), "
          f"prompt length {prompts.perm_tokens.shape[1]}")

    cls.validate(model, eval_fn, ds, prompts, args, DEV)  # warm-up (allocator, libraries)
    torch.cuda.synchronize()
    walls, launches = [], None
    for _ in range(passes):
        _build.reset_launches()
        t0 = time.perf_counter()
        val = cls.validate(model, eval_fn, ds, prompts, args, DEV)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = dict(_build.LAUNCHES)
        check(launches is None or got == launches, f"launch counts differ between passes: {got}")
        launches = got
    rates = sorted(len(ds) / w for w in walls)
    rate = rates[len(rates) // 2]
    print(f"[slice] validate, {passes} passes of {len(ds)} clouds (text tower once + "
          f"{n_batches} batches each): median {rate:.1f} clouds/sec, min {rates[0]:.1f}, "
          f"max {rates[-1]:.1f}; pass walls ms {[round(w * 1e3, 2) for w in walls]}; "
          f"acc1 {val['acc1']:.2f} (random weights)")
    print(f"[slice] kernel launches in one pass: {json.dumps(launches, sort_keys=True)}")
    for name in POINT_KERNELS:
        if name != "mini_stats":  # the train path's kernel: phase 5 counts it
            check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")

    text_ms = []
    for _ in range(passes):
        t0 = time.perf_counter()
        embed_fn(model, prompts)
        torch.cuda.synchronize()
        text_ms.append((time.perf_counter() - t0) * 1e3)
    text_med = sorted(text_ms)[len(text_ms) // 2]
    pass_med = sorted(walls)[len(walls) // 2] * 1e3
    print(f"[slice] text tower (40 prompts, once per pass): median {text_med:.2f} ms, "
          f"{100 * text_med / pass_med:.2f}% of the median pass ({pass_med:.1f} ms)")

    # the same weights and batch through the plain path on the card
    pc = torch.from_numpy(ds.points[:batch]).to(DEV)
    text_embed = embed_fn(model, prompts)
    logits = step_fn(model, {"pc": pc}, text_embed)
    with plain_path():
        want = step_fn(model, {"pc": pc}, text_embed)
    torch.cuda.synchronize()
    check(logits.shape == (batch, 40) and torch.isfinite(logits).all(), "slice logits")
    diff = float((logits - want).abs().max() / want.std())
    top1 = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[slice] logits vs plain path on the card (bf16): max|diff|/std {diff:.3e}, "
          f"top-1 agreement {top1:.3f}")
    check(diff <= 0.25 and top1 >= 0.8, "bf16 slice logits disagree with the plain path")

    # f32 at full width: the kernels should follow the plain path closely
    args.compute_dtype = "float32"
    m32 = build_model("ULIP_PointBERT", args, device=DEV).model
    te32 = embed_fn(m32, prompts)
    l32 = step_fn(m32, {"pc": pc}, te32)
    with plain_path():
        w32 = step_fn(m32, {"pc": pc}, te32)
    torch.cuda.synchronize()
    diff32 = float((l32 - w32).abs().max() / w32.std())
    top1_32 = float((l32.argmax(-1) == w32.argmax(-1)).float().mean())
    print(f"[slice] logits vs plain path on the card (f32): max|diff|/std {diff32:.3e}, "
          f"top-1 agreement {top1_32:.3f}")
    check(diff32 <= 1e-3 and top1_32 >= 0.95, "f32 slice logits disagree with the plain path")
    return launches, {"clouds_per_sec": rate, "clouds_per_sec_min": rates[0],
                      "clouds_per_sec_max": rates[-1], "text_tower_ms": text_med,
                      "pass_ms": pass_med}


# ---------------------------------------------------------------------------
# phase 5: the prompt-tuning train path at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH = 30  # configs/experiments/ppt_base_mn40.yaml
TRAIN_DIR = _build.BUILD_DIR.parent / "chip_smoke_train"


@functools.lru_cache(maxsize=None)
def modelnet40_clouds(samples_per_class, npoints, seed):
    """``make_synthetic`` over ModelNet40's 40 class names, drawn once a run
    for each (clouds a class, points, seed): the phases set models up
    dozens of times on the same clouds (a test split of 2468 clouds took
    ~0.4 s to draw each time)."""
    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    return make_synthetic(num_classes=40, samples_per_class=samples_per_class, npoints=npoints,
                          seed=seed, classnames=names)


def synthetic_modelnet40(args, split):
    """ModelNet40's 40 class names over synthetic clouds (no dataset ships
    with the repository): 30 clouds per class to train on, 3 to test. Each
    call gets its own copy of the kept clouds."""
    ds = modelnet40_clouds(30 if split == "train" else 3, args.npoints,
                           0 if split == "train" else 1)
    return ArrayDataset(ds.points.copy(), ds.labels.copy(), ds.classnames,
                        name="modelnet40_synthetic_clouds")


def train_args(dtype="bfloat16", head_type=0, batch=TRAIN_BATCH, **kw):
    return TaskArgs(dataset_name="modelnet40", npoints=1024, batch_size=batch,
                    num_learnable_prompt_tokens=32, class_name_position="middle",
                    compute_dtype=dtype, head_type=head_type, label_smoothing=0.2, lr=3e-3,
                    epochs=250, seed=0, device="cuda", pretrained_dir="",
                    output_dir=str(TRAIN_DIR), **kw)


def snapshot(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def step_quantities(state, seed, loss_of):
    """Loss, gradients of the trainable leaves and the BatchNorm buffers
    after one training-mode forward/backward ``loss_of()`` (no optimizer
    step) with ``state.generator`` seeded by ``seed``, the buffers put back
    as they were."""
    before = snapshot(state.batch_stats())
    state.generator.manual_seed(seed)
    loss = loss_of()
    names = list(state.trainable)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.trainable[k] for k in names])))
    after = snapshot(state.batch_stats())
    with torch.no_grad():
        for k, v in state.batch_stats().items():
            v.copy_(before[k])
    torch.cuda.synchronize()
    return float(loss.detach()), grads, after


def one_step_quantities(ctx, batch, seed):
    """``step_quantities`` of the prompt-tuning loss."""
    state, model = ctx["state"], ctx["model"]
    return step_quantities(state, seed, lambda: smoothed_cross_entropy(
        model(batch["pc"], ctx["prompts"], train=True, generator=state.generator),
        batch["label"], 0.2))


TEXT_SWITCHES = {"off": {}, "block": {"PPT_FUSED_TEXT": "1"},
                 "tower": {"PPT_FUSED_TEXT_TOWER": "1"}}


POINT_SWITCHES = {"block": {}, "tower": {"PPT_FUSED_VIT_TOWER": "1"},
                  "unfused": {"PPT_FUSED_BLOCK": "0"}, "plain": {"PPT_FORCE_XLA_ATTN": "1"}}


@contextlib.contextmanager
def switches(settings):
    """The reference's switches set as a user's shell would set them, for
    the ``cls.setup`` calls inside; every other switch of the text tower or
    the trunk unset."""
    keys = ("PPT_FUSED_TEXT", "PPT_FUSED_TEXT_TOWER", "PPT_FORCE_XLA_ATTN", "PPT_FUSED_BLOCK",
            "PPT_FUSED_VIT_TOWER", "PPT_FORCE_XLA_EMD")
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(settings)
    try:
        yield
    finally:
        for k in keys:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def setup_with_route(args, route, point="block"):
    with switches({**TEXT_SWITCHES[route], **POINT_SWITCHES[point]}):
        ctx = cls.setup(args)
    check(ctx["model"].text.fused == route, f"setup did not take the text route {route}")
    if args.model == "ULIP_PointBERT":
        check(ctx["model"].point_encoder.route == point,
              f"setup did not take the point route {point}")
    return ctx


def compare_with_plain(dtype, head_type, batch_size, tol_loss, tol_grad, tol_stats, route="off",
                       point="block", **model_kw):
    """One step through the kernels against the same step through their
    plain versions on the card; returns the worst relative differences."""
    args = train_args(dtype, head_type, batch_size, **model_kw)
    ctx = setup_with_route(args, route, point)
    b = cls.device_batch(next(iter(Loader(ctx["train_ds"], batch_size, shuffle=True, seed=3))),
                         DEV)
    if args.use_height:
        b["pc"] = append_height(b["pc"])
    loss, grads, stats = one_step_quantities(ctx, b, seed=11)
    with plain_path():
        loss_p, grads_p, stats_p = one_step_quantities(ctx, b, seed=11)
    d_loss = abs(loss - loss_p) / abs(loss_p)
    d_grad = {k: rel_err(grads[k], grads_p[k]) for k in grads}
    d_stats = max(rel_err(stats[k], stats_p[k]) for k in stats)
    tag = (f"{args.model} {dtype} head_type {head_type} B={batch_size} text route {route} "
           f"point route {point}")
    print(f"[train] one step vs plain path on the card ({tag}): loss {loss:.6f} vs "
          f"{loss_p:.6f} (rel {d_loss:.3e}, tol {tol_loss}); BN buffers max rel "
          f"{d_stats:.3e} (tol {tol_stats}); gradient max rel per leaf (tol {tol_grad}): "
          + json.dumps({k: float(f"{v:.3e}") for k, v in d_grad.items()}))
    check(math.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
          f"non-finite loss or gradient ({tag})")
    check(all(float(g.abs().max()) > 0 for g in grads.values()), f"a zero gradient ({tag})")
    check(d_loss <= tol_loss, f"loss disagrees with the plain path ({tag})")
    check(max(d_grad.values()) <= tol_grad, f"gradients disagree with the plain path ({tag})")
    check(d_stats <= tol_stats, f"BN buffers disagree with the plain path ({tag})")
    if head_type:
        check(any("block_11" in k for k in d_grad), "head_type 3 trains no block_11 leaf")
    return {"loss_rel": d_loss, "grad_rel": max(d_grad.values()), "stats_rel": d_stats}


def batch_stream(loader):
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        for batch in loader:
            yield batch
        epoch += 1


def run_steps(ctx, step_fn, stream, n, read_every_step=True):
    """`n` steps as the body of ``cls.train_loop`` takes them: the loss is
    read on the host after every step, which waits for the card. With
    ``read_every_step`` off the losses are read after the last."""
    losses = []
    for _ in range(n):
        b = cls.device_batch(next(stream), DEV)
        b["pc"] = train_augment(ctx["state"].generator, b["pc"])
        ctx["state"], metrics = step_fn(ctx["state"], b, ctx["prompts"])
        losses.append(float(metrics["loss"]) if read_every_step else metrics["loss"])
    torch.cuda.synchronize()
    return [float(x) for x in losses]


def fixed_batch_losses(loader, steps, route="off"):
    """A fixed batch, augmentation and DropPath off: the loss must fall."""
    fixed_args = train_args()
    fixed_args.pointbert_config = npb.PointBertConfig(drop_path_rate=0.0)
    fctx = setup_with_route(fixed_args, route)
    fstep = make_train_step(smoothing=0.2)
    fb = cls.device_batch(next(iter(loader)), DEV)
    fstate, flosses = fctx["state"], []
    for _ in range(steps):
        fstate, m = fstep(fstate, fb, fctx["prompts"])
        flosses.append(m["loss"])
    flosses = [float(x) for x in flosses]
    print(f"[train] fixed batch, {steps} steps, augmentation and DropPath off, text route "
          f"{route}: loss {flosses[0]:.4f} -> {flosses[-1]:.4f} (lowest {min(flosses):.4f})")
    check(all(math.isfinite(x) for x in flosses) and flosses[-1] < flosses[0],
          f"the loss did not fall on a fixed batch (text route {route})")
    return flosses


def run_train_slice(windows=3, steps_per_window=20, warmup=5):
    saved_loader = pdata.DATASETS["modelnet40"]
    pdata.DATASETS["modelnet40"] = synthetic_modelnet40
    try:
        return _run_train_slice(windows, steps_per_window, warmup)
    finally:
        pdata.DATASETS["modelnet40"] = saved_loader
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _run_train_slice(windows, steps_per_window, warmup):
    args = train_args()
    ctx = cls.setup(args)
    state, model, prompts = ctx["state"], ctx["model"], ctx["prompts"]
    check(len(ctx["classnames"]) == 40 and ctx["classnames"][0] == "airplane",
          "ModelNet40 class names")
    check(sorted(state.trainable) == ["prompt_learner.learnable_tokens"], "head_type 0 partition")
    frozen0 = snapshot({k: p for k, p in model.named_parameters() if k not in state.trainable})
    check(not any(p.requires_grad for p in frozen0.values()), "a frozen leaf requires grad")
    tokens0 = snapshot(state.trainable)["prompt_learner.learnable_tokens"]
    stats0 = snapshot(state.batch_stats())
    step_fn = make_train_step(smoothing=args.label_smoothing)
    loader = Loader(ctx["train_ds"], TRAIN_BATCH, shuffle=True, drop_last=True, seed=args.seed)
    print(f"[train] ULIP_PointBERT bf16 head_type 0: {len(ctx['train_ds'])} train clouds x "
          f"{args.npoints} points, batch {TRAIN_BATCH} ({ctx['steps_per_epoch']} steps per "
          f"epoch), label smoothing {args.label_smoothing}, lr {args.lr}, DropPath "
          f"{model.point_encoder.config.drop_path_rate}, augmentation on")

    stream = batch_stream(loader)

    def run(n, read_every_step=True):
        return run_steps(ctx, step_fn, stream, n, read_every_step)

    # `windows` windows that read the loss every step, and between each two
    # of them one that reads its losses at its end, so a host that drifts
    # during the run slows both kinds alike
    losses = run(warmup)
    _build.reset_launches()
    in_order = []
    for i in range(2 * windows - 1):
        t0 = time.perf_counter()
        losses += run(steps_per_window, read_every_step=i % 2 == 0)
        in_order.append(steps_per_window * TRAIN_BATCH / (time.perf_counter() - t0))
    launches = dict(_build.LAUNCHES)
    n_steps = len(in_order) * steps_per_window
    per_step = {k: v / n_steps for k, v in sorted(launches.items())}
    rates, late = sorted(in_order[0::2]), sorted(in_order[1::2])
    rate, late_rate = rates[len(rates) // 2], late[len(late) // 2]
    print(f"[train] {warmup} warm-up steps, then {len(in_order)} windows of {steps_per_window} "
          f"steps, train clouds/sec in run order {[round(r, 1) for r in in_order]}; loss first "
          f"{losses[0]:.4f}, last {losses[-1]:.4f}")
    print(f"[train] {len(rates)} windows with the loss read every step, as train_loop reads it: "
          f"median {rate:.1f} train clouds/sec, min {rates[0]:.1f}, max {rates[-1]:.1f} "
          f"({1e3 * TRAIN_BATCH / rate:.2f} ms per step)")
    print(f"[train] {len(late)} windows between them with the losses read once per window (no "
          f"wait per step): median {late_rate:.1f} train clouds/sec, min {late[0]:.1f}, max "
          f"{late[-1]:.1f} ({1e3 * TRAIN_BATCH / late_rate:.2f} ms per step)")
    print(f"[train] kernel launches per step: {json.dumps(per_step)}")

    # one epoch through train_loop itself (epochs cut to 1; the schedule is setup's)
    steps_before = state.step
    loop_args = dataclasses.replace(args, start_epoch=0, epochs=1)
    epoch = cls.train_loop(loop_args, ctx)["history"][0]
    state = ctx["state"]
    loop_steps = state.step - steps_before
    loop_rate = loop_steps * TRAIN_BATCH / epoch["epoch_time"]
    print(f"[train] cls.train_loop, one epoch of {loop_steps} steps: {loop_rate:.1f} train "
          f"clouds/sec ({1e3 * epoch['epoch_time'] / loop_steps:.2f} ms per step), loss "
          f"{epoch['loss']:.4f}, val_acc1 {epoch['val_acc1']:.2f}")
    check(loop_steps == ctx["steps_per_epoch"] and math.isfinite(epoch["loss"]),
          "train_loop's epoch")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(steps_before == warmup + n_steps and n_steps >= 100, "step count")
    for name in POINT_KERNELS:
        check(launches.get(name, 0) >= n_steps, f"{name} was not launched on every train step")
    check(all(torch.equal(p, frozen0[k]) for k, p in model.named_parameters() if k in frozen0),
          "a frozen weight changed")
    moved = float((state.trainable["prompt_learner.learnable_tokens"].detach() - tokens0)
                  .abs().max())
    stats_moved = min(float((v - stats0[k]).abs().max()) for k, v in state.batch_stats().items())
    print(f"[train] frozen weights unchanged ({len(frozen0)} leaves); prompt tokens moved by up "
          f"to {moved:.3e}; every BatchNorm buffer moved (least max change {stats_moved:.3e})")
    check(moved > 0 and stats_moved > 0, "prompt tokens or BN buffers did not move")

    # save -> load into a fresh setup -> the evaluation step gives the same logits
    save_checkpoint(str(TRAIN_DIR / "cls"), state, meta={"epoch": 0})
    eval_args = train_args(evaluate_3d=True, test_ckpt_addr=str(TRAIN_DIR / "cls"))
    ctx2 = cls.setup(eval_args)
    ctx2["state"] = load_checkpoint(eval_args.test_ckpt_addr, ctx2["state"])
    embed_fn, step_fn2 = make_cached_text_eval(model)
    pc = torch.from_numpy(ctx["test_ds"].points[:TRAIN_BATCH]).to(DEV)
    want = step_fn2(model, {"pc": pc}, embed_fn(model, prompts))
    got = step_fn2(ctx2["model"], {"pc": pc}, embed_fn(ctx2["model"], ctx2["prompts"]))
    untrained = cls.setup(train_args())["model"]
    base = step_fn2(untrained, {"pc": pc}, embed_fn(untrained, prompts))
    val = cls.validate(ctx2["model"], (embed_fn, step_fn2), ctx2["test_ds"], ctx2["prompts"],
                       eval_args, DEV)
    torch.cuda.synchronize()
    print(f"[train] checkpoint round trip: logits identical {torch.equal(got, want)}; differ "
          f"from the untrained model's by up to {float((want - base).abs().max()):.3e}; "
          f"validate acc1 {val['acc1']:.2f} on {len(ctx2['test_ds'])} synthetic test clouds")
    check(torch.isfinite(want).all() and torch.equal(got, want),
          "logits differ after the checkpoint round trip")
    check(not torch.equal(want, base), "training left the logits unchanged")

    flosses = fixed_batch_losses(loader, 60)

    agree = {
        "f32": compare_with_plain("float32", 0, TRAIN_BATCH, 1e-4, 1e-4, 1e-4),
        "bf16": compare_with_plain("bfloat16", 0, TRAIN_BATCH, 5e-2, 0.25, 2e-2),
        "f32_head3": compare_with_plain("float32", 3, 8, 1e-4, 1e-4, 1e-4),
        "bf16_head3": compare_with_plain("bfloat16", 3, 8, 5e-2, 0.25, 2e-2),
    }
    return launches, {
        "train_clouds_per_sec": rate, "train_clouds_per_sec_min": rates[0],
        "train_clouds_per_sec_max": rates[-1], "ms_per_step": 1e3 * TRAIN_BATCH / rate,
        "loss_read": "every step", "train_clouds_per_sec_loss_read_per_window": late_rate,
        "window_clouds_per_sec_in_run_order": in_order,
        "train_loop_clouds_per_sec": loop_rate,
        "steps": n_steps, "batch": TRAIN_BATCH, "loss_first": losses[0], "loss_last": losses[-1],
        "launches_per_step": per_step, "fixed_batch_loss": [flosses[0], flosses[-1]],
        "vs_plain": agree,
    }

# ---------------------------------------------------------------------------
# phase 6: the fused text path at full width
# ---------------------------------------------------------------------------


def median(xs):
    return sorted(xs)[len(xs) // 2]


def run_text_slice(windows=2, steps_per_window=20, warmup=5):
    saved_loader = pdata.DATASETS["modelnet40"]
    pdata.DATASETS["modelnet40"] = synthetic_modelnet40
    try:
        return _run_text_slice(windows, steps_per_window, warmup)
    finally:
        pdata.DATASETS["modelnet40"] = saved_loader
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _run_text_slice(windows, steps_per_window, warmup):
    # the same seed gives the two setups the same weights
    ctxs = {route: setup_with_route(train_args(), route) for route in ("off", "tower")}
    off, tower = ctxs["off"], ctxs["tower"]
    prompts = tower["prompts"]
    C, L = prompts.perm_tokens.shape
    print(f"[text] ULIP_PointBERT bf16, {C} prompts x {L} positions, text tower "
          f"{tower['model'].text.config.layers} layers x {tower['model'].text.config.width}")

    # --- eval: one validate pass with the tower route -----------------------
    eval_fn = make_cached_text_eval(tower["model"])
    embed_fn, step_fn = eval_fn
    cls.validate(tower["model"], eval_fn, tower["test_ds"], prompts, train_args(), DEV)  # warm-up
    _build.reset_launches()
    val = cls.validate(tower["model"], eval_fn, tower["test_ds"], prompts, train_args(), DEV)
    torch.cuda.synchronize()
    eval_launches = dict(_build.LAUNCHES)
    check(eval_launches.get("fused_text_tower", 0) == 1
          and "fused_text_tower_res" not in eval_launches
          and "fused_text_tower_bwd" not in eval_launches,
          f"a validate pass takes the forward kernel once, without residuals: {eval_launches}")
    pc = torch.from_numpy(tower["test_ds"].points[:TRAIN_BATCH]).to(DEV)
    te_tower, te_off = embed_fn(tower["model"], prompts), embed_fn(off["model"], prompts)
    logits = step_fn(tower["model"], {"pc": pc}, te_tower)
    want = step_fn(off["model"], {"pc": pc}, te_off)
    torch.cuda.synchronize()
    check(logits.shape == (TRAIN_BATCH, C) and torch.isfinite(logits).all(), "text slice logits")
    diff = float((logits - want).abs().max() / want.std())
    top1 = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    te_err = rel_err(te_tower, te_off)
    encode_ms = {"off": [], "tower": []}
    for _ in range(5):
        for route, ctx in ctxs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            embed_fn(ctx["model"], prompts)
            torch.cuda.synchronize()
            encode_ms[route].append((time.perf_counter() - t0) * 1e3)
    encode_ms = {k: median(v) for k, v in encode_ms.items()}
    print(f"[text] validate with the tower route: acc1 {val['acc1']:.2f} (random weights), "
          f"launches {json.dumps(eval_launches, sort_keys=True)}; logits vs the off route "
          f"(bf16): max|diff|/std {diff:.3e}, top-1 agreement {top1:.3f}; text embeddings max "
          f"rel diff {te_err:.3e}; text encode median of 5, interleaved: tower "
          f"{encode_ms['tower']:.2f} ms, off {encode_ms['off']:.2f} ms")
    check(diff <= 0.25 and top1 >= 0.8, "tower-route logits disagree with the off route")

    # --- train: interleaved windows, tower and off ---------------------------
    step = make_train_step(smoothing=0.2)
    streams = {r: batch_stream(Loader(c["train_ds"], TRAIN_BATCH, shuffle=True, drop_last=True,
                                      seed=0)) for r, c in ctxs.items()}
    frozen0 = snapshot({k: p for k, p in tower["model"].named_parameters()
                        if k not in tower["state"].trainable})
    tokens0 = snapshot(tower["state"].trainable)["prompt_learner.learnable_tokens"]
    losses = {r: run_steps(ctxs[r], step, streams[r], warmup) for r in ctxs}
    rates, launches = {"off": [], "tower": []}, {}
    counted = collections.Counter(eval_launches)  # the counts as read, summed over the runs
    for _ in range(windows):
        for route in ("tower", "off"):
            _build.reset_launches()
            t0 = time.perf_counter()
            losses[route] += run_steps(ctxs[route], step, streams[route], steps_per_window)
            rates[route].append(steps_per_window * TRAIN_BATCH / (time.perf_counter() - t0))
            if route == "tower":
                counted.update(_build.LAUNCHES)
            got = {k: v / steps_per_window for k, v in sorted(_build.LAUNCHES.items())}
            check(launches.setdefault(route, got) == got, f"launches per step moved: {got}")
    for route in ("tower", "off"):
        r = sorted(rates[route])
        print(f"[text] train, text route {route}: {windows} windows of {steps_per_window} steps "
              f"(loss read every step), interleaved with the other route: median "
              f"{median(r):.1f} train clouds/sec, min {r[0]:.1f}, max {r[-1]:.1f} "
              f"({1e3 * TRAIN_BATCH / median(r):.2f} ms per step); loss first "
              f"{losses[route][0]:.4f}, last {losses[route][-1]:.4f}; kernel launches per step "
              f"{json.dumps(launches[route])}")
        check(all(math.isfinite(x) for x in losses[route]), f"non-finite loss, route {route}")
    per_step = launches["tower"]
    check(per_step.get("fused_text_tower_res") == 1 and per_step.get("fused_text_tower_bwd") == 1
          and "fused_text_tower" not in per_step,
          f"a tower-route train step takes the residual forward and the backward once: {per_step}")
    check(not any(k in launches["off"] for k in ("fused_text_tower", "fused_text_tower_res",
                                                 "fused_text_tower_bwd", "fused_text_block")),
          "the off route launched a text kernel")
    for name in POINT_KERNELS:
        check(per_step.get(name, 0) >= 1, f"{name} was not launched on every tower-route step")
    check(all(torch.equal(p, frozen0[k]) for k, p in tower["model"].named_parameters()
              if k in frozen0), "a frozen weight changed on the tower route")
    moved = float((tower["state"].trainable["prompt_learner.learnable_tokens"].detach()
                   - tokens0).abs().max())
    print(f"[text] tower route: frozen weights unchanged ({len(frozen0)} leaves); prompt tokens "
          f"moved by up to {moved:.3e}")
    check(moved > 0, "the prompt tokens did not move on the tower route")

    loader = Loader(tower["train_ds"], TRAIN_BATCH, shuffle=True, drop_last=True, seed=0)
    flosses = fixed_batch_losses(loader, 30, route="tower")

    # one step, kernels against their plain versions, per route
    agree = {
        "tower_f32": compare_with_plain("float32", 0, TRAIN_BATCH, 1e-4, 1e-4, 1e-4, "tower"),
        "tower_bf16": compare_with_plain("bfloat16", 0, TRAIN_BATCH, 5e-2, 0.25, 2e-2, "tower"),
    }
    agree["block_f32"] = compare_with_plain("float32", 0, TRAIN_BATCH, 1e-4, 1e-4, 1e-4, "block")
    agree["block_bf16"] = compare_with_plain("bfloat16", 0, TRAIN_BATCH, 5e-2, 0.25, 2e-2,
                                             "block")

    # --- train with the block route: a few steps driven, the count read after
    block = setup_with_route(train_args(), "block")
    block_steps = 5
    _build.reset_launches()
    block_losses = run_steps(block, step, batch_stream(loader), block_steps)
    block_counts = dict(_build.LAUNCHES)
    layers = block["model"].text.config.layers
    print(f"[text] train, text route block: {block_steps} steps, loss first {block_losses[0]:.4f}"
          f", last {block_losses[-1]:.4f}; kernel launches {json.dumps(block_counts, sort_keys=True)}")
    check(all(math.isfinite(x) for x in block_losses), "non-finite loss, route block")
    check(block_counts.get("fused_text_block") == layers * block_steps,
          f"the block route launches {layers} text blocks per encode: {block_counts}")
    check(not any(k.startswith("fused_text_tower") for k in block_counts),
          "the block route launched a tower kernel")

    # the routes against each other in f32: the same function of the same weights
    b = cls.device_batch(next(iter(loader)), DEV)
    f32 = {r: setup_with_route(train_args("float32"), r) for r in ("off", "block", "tower")}
    ref = one_step_quantities(f32["off"], b, seed=11)
    for route in ("block", "tower"):
        loss, grads, _ = one_step_quantities(f32[route], b, seed=11)
        d_loss = abs(loss - ref[0]) / abs(ref[0])
        d_grad = max(rel_err(grads[k], ref[1][k]) for k in grads)
        print(f"[text] f32 step, route {route} vs off: loss rel {d_loss:.3e}, prompt gradient "
              f"max rel {d_grad:.3e} (tol 1e-3)")
        check(d_loss <= 1e-4 and d_grad <= 1e-3, f"route {route} disagrees with off in f32")
        agree[f"{route}_vs_off_f32"] = {"loss_rel": d_loss, "grad_rel": d_grad}

    # every figure here is a counter as read after a driven run, or a sum of such
    by_variant = {k: counted[k] for k in ("fused_text_tower", "fused_text_tower_res")}
    text_launches = {
        "fused_text_block": block_counts["fused_text_block"],
        "fused_text_tower": sum(by_variant.values()),
        "fused_text_tower_bwd": counted["fused_text_tower_bwd"],
    }
    r_t, r_o = median(rates["tower"]), median(rates["off"])
    return text_launches, {
        "prompt_length": L, "eval_logits_vs_off": {"diff_over_std": diff, "top1": top1},
        "text_embed_rel_vs_off": te_err, "text_encode_ms": encode_ms,
        "eval_launches": eval_launches, "tower_launches_by_variant": by_variant,
        "block_route_launches": block_counts,
        "train_clouds_per_sec": {"tower": r_t, "off": r_o},
        "train_clouds_per_sec_windows": rates,
        "ms_per_step": {"tower": 1e3 * TRAIN_BATCH / r_t, "off": 1e3 * TRAIN_BATCH / r_o},
        "launches_per_step": launches,
        "block_route_text_blocks_per_encode": block_counts["fused_text_block"] // block_steps,
        "loss_first_last": {r: [losses[r][0], losses[r][-1]] for r in losses},
        "fixed_batch_loss": [flosses[0], flosses[-1]], "vs_plain": agree,
    }

# ---------------------------------------------------------------------------
# phase 7: the ball-query towers at full width
# ---------------------------------------------------------------------------

NEXT_BATCH = 128  # the PointNeXt-S inference shape: B=128 x N=1024


def synthetic_modelnet40_eval(args, split):
    """As ``synthetic_modelnet40``, with a test split of ModelNet40's size."""
    if split == "train":
        return synthetic_modelnet40(args, split)
    ds = modelnet40_clouds(-(-MN40_TEST_CLOUDS // 40), args.npoints, 1)
    return ArrayDataset(ds.points[:MN40_TEST_CLOUDS].copy(), ds.labels[:MN40_TEST_CLOUDS].copy(),
                        ds.classnames, name="modelnet40_synthetic_clouds")


def tower_args(model, batch, dtype="bfloat16", **kw):
    return train_args(dtype, 0, batch, model=model, use_height=model == "ULIP_PN_NEXT",
                      evaluate_3d=True, **kw)


def logits_vs_plain(model_name, dtype, batch, test_ds):
    """One batch's logits through the kernels and through their plain
    versions on the card, same weights."""
    args = tower_args(model_name, batch, dtype)
    ctx = cls.setup(args)
    embed_fn, step_fn = make_cached_text_eval(ctx["model"])
    pc = torch.from_numpy(test_ds.points[:batch]).to(DEV)
    if args.use_height:
        pc = append_height(pc)
    text_embed = embed_fn(ctx["model"], ctx["prompts"])
    logits = step_fn(ctx["model"], {"pc": pc}, text_embed)
    with plain_path():
        want = step_fn(ctx["model"], {"pc": pc}, text_embed)
    torch.cuda.synchronize()
    check(logits.shape == (batch, 40) and torch.isfinite(logits).all(), f"{model_name} logits")
    diff = float((logits - want).abs().max() / want.std())
    top1 = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[ballquery] {model_name} logits vs plain path on the card ({dtype}, B={batch}): "
          f"max|diff|/std {diff:.3e}, top-1 agreement {top1:.3f}")
    if dtype == "float32":
        ok = diff <= 1e-3 and top1 >= 0.95
    else:
        ok = diff <= 0.25 and top1 >= 0.8
    check(ok, f"{dtype} {model_name} logits disagree with the plain path")
    return {"diff_over_std": diff, "top1": top1}


def timed_passes(ctx, args, passes):
    """`passes` validate passes with the counters set to 0 just before each
    and read just after; the counts must not move between passes."""
    eval_fn = make_cached_text_eval(ctx["model"])
    walls, launches = [], None
    for _ in range(passes):
        _build.reset_launches()
        t0 = time.perf_counter()
        val = cls.validate(ctx["model"], eval_fn, ctx["test_ds"], ctx["prompts"], args, DEV)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = dict(_build.LAUNCHES)
        check(launches is None or got == launches, f"launch counts differ between passes: {got}")
        launches = got
    return walls, launches, val


def run_ballquery_slice(passes=5, steps=20):
    saved_loader = pdata.DATASETS["modelnet40"]
    pdata.DATASETS["modelnet40"] = synthetic_modelnet40_eval
    try:
        return _run_ballquery_slice(passes, steps)
    finally:
        pdata.DATASETS["modelnet40"] = saved_loader
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _run_ballquery_slice(passes, steps):
    out, counted = {}, collections.Counter()
    # --- ULIP_PN_NEXT, the serving path -------------------------------------
    args = tower_args("ULIP_PN_NEXT", NEXT_BATCH)
    ctx = cls.setup(args)
    model, test_ds = ctx["model"], ctx["test_ds"]
    n_params = sum(p.numel() for p in model.point_encoder.parameters())
    n_batches = math.ceil(len(test_ds) / NEXT_BATCH)
    check(len(test_ds) == MN40_TEST_CLOUDS and len(ctx["classnames"]) == 40, "phase 7 data")
    check(model.point_encoder.config.stage_channels() == (32, 64, 128, 256, 512, 512)
          and model.point_encoder.stem.kernel.shape == (4, 32), "PointNeXt-S at full width")
    print(f"[ballquery] ULIP_PN_NEXT bf16 --use_height: point tower {n_params / 1e6:.2f} M "
          f"parameters, {len(test_ds)} clouds x {args.npoints} points, batch {NEXT_BATCH} "
          f"({n_batches} batches), prompt length {ctx['prompts'].perm_tokens.shape[1]}")
    timed_passes(ctx, args, 1)  # warm-up (allocator, libraries)
    walls, launches, val = timed_passes(ctx, args, passes)
    rates = sorted(len(test_ds) / w for w in walls)
    print(f"[ballquery] ULIP_PN_NEXT validate, {passes} passes of {len(test_ds)} clouds: median "
          f"{median(rates):.1f} clouds/sec, min {rates[0]:.1f}, max {rates[-1]:.1f}; pass walls "
          f"ms {[round(w * 1e3, 2) for w in walls]}; acc1 {val['acc1']:.2f} (random weights); "
          f"kernel launches in one pass: {json.dumps(launches, sort_keys=True)}")
    check(launches.get("ball_query_gather_feats", 0) == 4 * n_batches
          and launches.get("fps_batched", 0) == 4 * n_batches,
          f"ULIP_PN_NEXT launches 4 ball queries and 4 FPS per batch: {launches}")
    counted.update(launches)
    out["pn_next"] = {
        "clouds_per_sec": median(rates), "clouds_per_sec_min": rates[0],
        "clouds_per_sec_max": rates[-1], "pass_ms": median(walls) * 1e3, "batch": NEXT_BATCH,
        "launches_per_pass": launches,
        "logits_vs_plain": {dt: logits_vs_plain("ULIP_PN_NEXT", dt, NEXT_BATCH, test_ds)
                            for dt in ("float32", "bfloat16")},
    }

    # --- ULIP_PN_MSG and ULIP_PN_SSG, one pass each -------------------------
    for name, key, per_batch in (("ULIP_PN_MSG", "pn_msg", {"ball_query_gather": 6}),
                                 ("ULIP_PN_SSG", "pn_ssg", {"ball_query_gather": 1,
                                                            "ball_query_gather_feats": 1})):
        targs = tower_args(name, 32)
        tctx = cls.setup(targs)
        timed_passes(tctx, targs, 1)  # warm-up
        walls, launches, val = timed_passes(tctx, targs, 1)
        nb = math.ceil(len(test_ds) / 32)
        print(f"[ballquery] {name} bf16 B=32 validate, one pass of {len(test_ds)} clouds: "
              f"{len(test_ds) / walls[0]:.1f} clouds/sec; kernel launches "
              f"{json.dumps(launches, sort_keys=True)}")
        for k, n in dict(per_batch, fps_batched=2).items():
            check(launches.get(k, 0) == n * nb, f"{name} launches {n} {k} per batch: {launches}")
        counted.update(launches)
        out[key] = {"clouds_per_sec": len(test_ds) / walls[0], "batch": 32,
                    "launches_per_pass": launches,
                    "logits_vs_plain": {dt: logits_vs_plain(name, dt, 32, test_ds)
                                        for dt in ("float32", "bfloat16")}}

    # --- ULIP_PN_NEXT, the prompt-tuning step -------------------------------
    next_kw = dict(model="ULIP_PN_NEXT", use_height=True)
    out["train_vs_plain"] = {
        "f32": compare_with_plain("float32", 0, TRAIN_BATCH, 1e-4, 1e-4, 1e-4, **next_kw),
        "bf16": compare_with_plain("bfloat16", 0, TRAIN_BATCH, 5e-2, 0.25, 2e-2, **next_kw),
    }
    targs = train_args(**next_kw)
    tctx = cls.setup(targs)
    state, tmodel = tctx["state"], tctx["model"]
    check(sorted(state.trainable) == ["prompt_learner.learnable_tokens"], "head_type 0 partition")
    frozen0 = snapshot({k: p for k, p in tmodel.named_parameters() if k not in state.trainable})
    stats0 = snapshot(state.batch_stats())
    step_fn = make_train_step(smoothing=targs.label_smoothing)
    stream = batch_stream(Loader(tctx["train_ds"], TRAIN_BATCH, shuffle=True, drop_last=True,
                                 seed=0))

    def run(n):
        losses = []
        for _ in range(n):
            b = cls.device_batch(next(stream), DEV)
            b["pc"] = train_augment(state.generator, b["pc"], use_height=True)
            _, metrics = step_fn(state, b, tctx["prompts"])
            losses.append(float(metrics["loss"]))  # read every step, as train_loop reads it
        torch.cuda.synchronize()
        return losses

    losses = run(5)
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += run(steps)
    rate = steps * TRAIN_BATCH / (time.perf_counter() - t0)
    per_step = {k: v / steps for k, v in sorted(_build.LAUNCHES.items())}
    counted.update(_build.LAUNCHES)
    stats_moved = min(float((v - stats0[k]).abs().max()) for k, v in state.batch_stats().items())
    print(f"[ballquery] ULIP_PN_NEXT train, bf16 head_type 0 B={TRAIN_BATCH}: 5 warm-up steps, "
          f"then one window of {steps} steps (loss read every step): {rate:.1f} train clouds/sec "
          f"({1e3 * TRAIN_BATCH / rate:.2f} ms per step); loss first {losses[0]:.4f}, last "
          f"{losses[-1]:.4f}; kernel launches per step {json.dumps(per_step)}; {len(frozen0)} "
          f"frozen leaves unchanged; {len(stats0)} BatchNorm buffers moved (least max change "
          f"{stats_moved:.3e})")
    check(all(math.isfinite(x) for x in losses), "non-finite ULIP_PN_NEXT training loss")
    check(per_step.get("ball_query_gather_feats") == 4 and per_step.get("fps_batched") == 4,
          f"a ULIP_PN_NEXT train step launches 4 ball queries and 4 FPS: {per_step}")
    check(all(torch.equal(p, frozen0[k]) for k, p in tmodel.named_parameters() if k in frozen0),
          "a frozen weight of ULIP_PN_NEXT changed")
    check(stats_moved > 0, "a BatchNorm buffer of ULIP_PN_NEXT did not move")
    out["train"] = {"train_clouds_per_sec": rate, "ms_per_step": 1e3 * TRAIN_BATCH / rate,
                    "steps": steps, "batch": TRAIN_BATCH,
                    "loss_first_last": [losses[0], losses[-1]],
                    "launches_per_step": per_step}
    # counters as read after the driven runs above, summed
    ball_launches = {k: counted.get(k, 0) for k in BALL_KERNELS}
    out["launches_counted"] = dict(ball_launches, fps_batched=counted["fps_batched"])
    return ball_launches, out


# ---------------------------------------------------------------------------
# phase 8: PointBERT's other trunk routes and the long-sequence trunk
# ---------------------------------------------------------------------------

LONG_NPOINTS, LONG_GROUPS = 8192, 1024  # PointTransformer_8192point.yaml's npoints; L = 1025
TRUNK_KERNELS = ("fused_vit_block", "fused_vit_block_readout") + ROUTE_KERNELS


def eval_args(dtype="bfloat16", batch=32, npoints=1024):
    args = train_args(dtype, 0, batch, evaluate_3d=True)
    args.npoints = npoints
    return args


def route_logits(ctx, batch, test_ds, plain):
    embed_fn, step_fn = make_cached_text_eval(ctx["model"])
    pc = torch.from_numpy(test_ds.points[:batch]).to(DEV)
    text_embed = embed_fn(ctx["model"], ctx["prompts"])
    with plain_path() if plain else contextlib.nullcontext():
        return step_fn(ctx["model"], {"pc": pc}, text_embed)


def logits_agree(tag, logits, want, dtype):
    check(torch.isfinite(logits).all(), f"{tag} logits non-finite")
    diff = float((logits - want).abs().max() / want.std())
    top1 = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[routes] {tag} logits vs plain path on the card ({dtype}): max|diff|/std "
          f"{diff:.3e}, top-1 agreement {top1:.3f}")
    ok = diff <= 1e-3 and top1 >= 0.95 if dtype == "float32" else diff <= 0.25 and top1 >= 0.8
    check(ok, f"{tag} {dtype} logits disagree with the plain path")
    return {"diff_over_std": diff, "top1": top1}


def route_passes(ctx, args, passes):
    timed_passes(ctx, args, 1)  # warm-up (allocator, libraries)
    walls, launches, val = timed_passes(ctx, args, passes)
    rates = sorted(len(ctx["test_ds"]) / w for w in walls)
    return {"clouds_per_sec": median(rates), "clouds_per_sec_min": rates[0],
            "clouds_per_sec_max": rates[-1], "pass_ms": median(walls) * 1e3,
            "launches_per_pass": launches, "acc1": val["acc1"]}


def run_routes_slice(passes=1, steps=10):
    saved_loader = pdata.DATASETS["modelnet40"]
    pdata.DATASETS["modelnet40"] = synthetic_modelnet40_eval
    try:
        return _run_routes_slice(passes, steps)
    finally:
        pdata.DATASETS["modelnet40"] = saved_loader
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _run_routes_slice(passes, steps):
    out, counted = {}, {}
    block = setup_with_route(eval_args(), "off", "block")
    depth = block["model"].point_encoder.config.depth
    per_batch = {"tower": ("fused_vit_tower", 1), "unfused": ("fused_mha", depth)}
    test_ds = block["test_ds"]
    n_batches = math.ceil(len(test_ds) / 32)
    block_logits = route_logits(block, 32, test_ds, plain=False)
    for route, (kernel, n) in per_batch.items():
        ctx = setup_with_route(eval_args(), "off", route)
        r = route_passes(ctx, eval_args(), passes)
        launches = r["launches_per_pass"]
        print(f"[routes] route {route} ({POINT_SWITCHES[route]}), ULIP_PointBERT bf16 B=32: "
              f"{passes} validate passes of {len(test_ds)} clouds, median "
              f"{r['clouds_per_sec']:.1f} clouds/sec, min {r['clouds_per_sec_min']:.1f}, max "
              f"{r['clouds_per_sec_max']:.1f}; kernel launches in one pass "
              f"{json.dumps(launches, sort_keys=True)}")
        check(launches.get(kernel, 0) == n * n_batches,
              f"route {route} launches {n} {kernel} per batch: {launches}")
        check(not any(launches.get(k) for k in TRUNK_KERNELS if k != kernel),
              f"route {route} launched another trunk kernel: {launches}")
        counted[kernel] = launches[kernel]
        r["logits_vs_plain"] = {}
        for dtype in ("float32", "bfloat16"):
            dctx = ctx if dtype == "bfloat16" else setup_with_route(eval_args(dtype), "off", route)
            got = route_logits(dctx, 32, test_ds, plain=False)
            want = route_logits(dctx, 32, test_ds, plain=True)
            r["logits_vs_plain"][dtype] = logits_agree(f"route {route}", got, want, dtype)
        if route == "tower":
            same = torch.equal(route_logits(ctx, 32, test_ds, plain=False), block_logits)
            print(f"[routes] route tower: logits identical to the default route's: {same}")
            check(same, "the tower route's logits differ from the block route's")
        out[route] = r

    # no trunk kernel at all with PPT_FORCE_XLA_ATTN
    ctx = setup_with_route(eval_args(), "off", "plain")
    walls, launches, _ = timed_passes(ctx, eval_args(), 1)
    print(f"[routes] route plain ({POINT_SWITCHES['plain']}): one pass "
          f"{len(test_ds) / walls[0]:.1f} clouds/sec; kernel launches "
          f"{json.dumps(launches, sort_keys=True)}")
    check(not any(launches.get(k) for k in TRUNK_KERNELS),
          f"PPT_FORCE_XLA_ATTN launched a trunk kernel: {launches}")
    out["plain"] = {"clouds_per_sec_one_pass": len(test_ds) / walls[0],
                    "launches_per_pass": launches}

    # the prompt-tuning step on each route
    step_fn = make_train_step(smoothing=0.2)
    for route, (kernel, n) in per_batch.items():
        out[route]["train_vs_plain"] = {
            "bf16": compare_with_plain("bfloat16", 0, TRAIN_BATCH, 5e-2, 0.25, 2e-2,
                                       point=route),
            "f32_head3": compare_with_plain("float32", 3, 8, 1e-4, 1e-4, 1e-4, point=route),
            "bf16_head3": compare_with_plain("bfloat16", 3, 8, 5e-2, 0.25, 2e-2, point=route),
        }
        ctx = setup_with_route(train_args(), "off", route)
        stream = batch_stream(Loader(ctx["train_ds"], TRAIN_BATCH, shuffle=True, drop_last=True,
                                     seed=0))
        losses = run_steps(ctx, step_fn, stream, 5)
        _build.reset_launches()
        t0 = time.perf_counter()
        losses += run_steps(ctx, step_fn, stream, steps)
        rate = steps * TRAIN_BATCH / (time.perf_counter() - t0)
        per_step = {k: v / steps for k, v in sorted(_build.LAUNCHES.items())}
        print(f"[routes] route {route} train, bf16 head_type 0 B={TRAIN_BATCH}: 5 warm-up steps, "
              f"then {steps} steps (loss read every step): {rate:.1f} train clouds/sec "
              f"({1e3 * TRAIN_BATCH / rate:.2f} ms per step); loss first {losses[0]:.4f}, last "
              f"{losses[-1]:.4f}; kernel launches per step {json.dumps(per_step)}")
        check(all(math.isfinite(x) for x in losses), f"non-finite loss on route {route}")
        check(per_step.get(kernel) == n, f"route {route} step launches {n} {kernel}: {per_step}")
        out[route]["train"] = {"train_clouds_per_sec": rate, "ms_per_step": 1e3 * TRAIN_BATCH / rate,
                               "steps": steps, "loss_first_last": [losses[0], losses[-1]],
                               "launches_per_step": per_step}

    # the long-sequence trunk, served through ulip_customized
    long_out = {}
    long_ds = synthetic_modelnet40_eval(eval_args(npoints=LONG_NPOINTS), "test")
    for dtype in ("bfloat16", "float32"):
        args = eval_args(dtype, npoints=LONG_NPOINTS)
        with switches({}):
            route = cls.point_route_from_env()
        dt = DTYPES["bf16" if dtype == "bfloat16" else "f32"]
        cfg = npb.PointBertConfig(num_group=LONG_GROUPS)
        spec = ulip_customized(args, npb.PointBert(cfg, dtype=dt, route=route), 2 * cfg.trans_dim)
        model = init_weights(spec.model, args.seed).to(DEV).eval()
        ctx = {"model": model, "prompts": mn40_prompts(), "test_ds": long_ds}
        if dtype == "bfloat16":
            r = route_passes(ctx, args, passes)
            launches = r["launches_per_pass"]
            print(f"[routes] long trunk (ULIP_CUSTOMIZED over PointBERT {cfg.trans_dim} x "
                  f"{cfg.depth}, {cfg.num_group} groups, L={cfg.num_group + 1}) bf16 B=32 x "
                  f"N={LONG_NPOINTS}: {passes} validate passes of "
                  f"{len(ctx['test_ds'])} clouds, median {r['clouds_per_sec']:.1f} clouds/sec, "
                  f"min {r['clouds_per_sec_min']:.1f}, max {r['clouds_per_sec_max']:.1f}; "
                  f"kernel launches in one pass {json.dumps(launches, sort_keys=True)}")
            check(launches.get("flash_mha", 0) == cfg.depth * n_batches,
                  f"the long trunk launches {cfg.depth} flash_mha per batch: {launches}")
            check(not any(launches.get(k) for k in TRUNK_KERNELS if k != "flash_mha"),
                  f"the long trunk launched another trunk kernel: {launches}")
            counted["flash_mha"] = launches["flash_mha"]
            long_out.update(r, batch=32, npoints=LONG_NPOINTS, num_group=LONG_GROUPS, tokens=1025)
            long_out["logits_vs_plain"] = {}
        got = route_logits(ctx, 32, ctx["test_ds"], plain=False)
        want = route_logits(ctx, 32, ctx["test_ds"], plain=True)
        long_out["logits_vs_plain"][dtype] = logits_agree("long trunk", got, want, dtype)
    out["long_trunk"] = long_out
    return counted, out


# ---------------------------------------------------------------------------
# phase 9: training through the long-sequence trunk
# ---------------------------------------------------------------------------

PRETRAIN_DIR = _build.BUILD_DIR.parent / "chip_smoke_pretrain"
LONG_BATCH, PLAIN_PRETRAIN_BATCH = 32, 8
TOL_STEP = {"float32": (1e-4, 1e-4, 1e-4), "bfloat16": (5e-2, 0.25, 2e-2)}  # phase 5's


def long_trunk_model(dtype, drop_path_rate=0.1, seed=0):
    """ULIP_CUSTOMIZED over PointBERT at PPT-Base's widths with 1024 groups
    (L = 1025: every block on flash_mha), the text route off, weights from
    a seed, on the card."""
    args = eval_args(dtype, npoints=LONG_NPOINTS)
    with switches({}):
        route = cls.point_route_from_env()
    cfg = npb.PointBertConfig(num_group=LONG_GROUPS, drop_path_rate=drop_path_rate)
    encoder = npb.PointBert(cfg, dtype=DTYPES["bf16" if dtype == "bfloat16" else "f32"],
                            route=route)
    spec = ulip_customized(args, encoder, 2 * cfg.trans_dim)
    return init_weights(spec.model, seed).to(DEV)


def long_train_state(model, head_type=0, task="cls", lr=None):
    """The published recipe's AdamW and cosine schedule (or a constant
    ``lr``) on the partition that ``head_type`` / ``task`` trains."""
    sched = (lambda s: lr) if lr is not None else build_schedule(
        "cosine", 3e-3, 250, 9843 // LONG_BATCH, final_lr=1e-5, warmup_epochs=1,
        warmup_start_lr=1e-6)
    return create_train_state(model, trainable_mask(model, head_type=head_type, task=task),
                              lambda tr: build_optimizer("adamw", tr.items(), sched), seed=1)


def long_clouds(n=320):
    """Synthetic clouds of 8192 points with ModelNet40's class names."""
    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    return make_synthetic(num_classes=40, samples_per_class=n // 40, npoints=LONG_NPOINTS,
                          seed=2, classnames=names)


def rel_to_floor(got, want, floor):
    """max |got - want| over max(max |want|, floor)."""
    return float((got.float() - want.float()).abs().max()) / max(float(want.abs().max()), floor)


def pretrain_quantities(model, state, pc, tokens, seed):
    """``step_quantities`` of ULIP's contrastive pretraining loss."""
    return step_quantities(state, seed, lambda: ulip_contrastive_loss(
        model.encode_pc(pc, train=True, generator=state.generator),
        model.encode_captions(tokens), None, torch.exp(model.logit_scale))["loss"])


# the group encoder's gradient in f32, pretraining only: a relative change
# of 1e-6 in its BatchNorm sums (mini_stats' f32 sums over 262k rows differ
# from the plain sums at about that level) moves the encoder's gradients by
# 7e-4 to 2.6e-3 (measured on the CPU at B=8, 1024 groups): its max-pools
# send each group's gradient to one of 32 points, whose near-ties flip
TOL_ENCODER_F32 = 1e-2


def step_vs_plain(tag, dtype, quantities, tol_encoder=None, encoder="point_encoder.encoder.",
                  kernel="flash_mha_bwd"):
    """``quantities()`` -> (loss, grads, stats) through the kernels and
    through their plain versions on the card; phase 5's limits, and
    ``tol_encoder`` for the leaves under ``encoder`` (the group encoder)
    when it trains. A leaf's gradient error is taken
    against its largest entry, floored at 1e-3 of the largest gradient of
    any leaf: a Dense bias just before a train-mode BatchNorm has a
    gradient of rounding noise. ``kernel``'s launches are counted."""
    tol_loss, tol_grad, tol_stats = TOL_STEP[dtype]
    tol_encoder = tol_encoder or tol_grad
    _build.reset_launches()
    loss, grads, stats = quantities()
    bwd = _build.LAUNCHES[kernel]
    with plain_path():
        loss_p, grads_p, stats_p = quantities()
    top = max(float(g.abs().max()) for g in grads_p.values())
    d_loss = abs(loss - loss_p) / abs(loss_p)
    d_grad = {k: rel_to_floor(grads[k], grads_p[k], 1e-3 * top) for k in grads}
    d_stats = max(rel_err(stats[k], stats_p[k]) for k in stats)
    enc = {k: v for k, v in d_grad.items() if k.startswith(encoder)}
    rest = {k: v for k, v in d_grad.items() if k not in enc}
    worst = max(rest, key=rest.get)
    worst_enc = max(enc, key=enc.get) if enc else None
    print(f"[pretrain] {tag} {dtype}: one step vs plain path on the card: loss {loss:.6f} vs "
          f"{loss_p:.6f} (rel {d_loss:.3e}, tol {tol_loss}); gradient max rel {rest[worst]:.3e} "
          f"({worst}; {len(grads)} leaves; tol {tol_grad})"
          + (f", group encoder {enc[worst_enc]:.3e} ({worst_enc}; tol {tol_encoder})"
             if enc else "")
          + f"; BN buffers max rel {d_stats:.3e} (tol {tol_stats}); {kernel} launches {bwd}")
    check(math.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
          f"non-finite loss or gradient ({tag} {dtype})")
    check(d_loss <= tol_loss, f"loss disagrees with the plain path ({tag} {dtype})")
    check(rest[worst] <= tol_grad, f"gradients disagree with the plain path ({tag} {dtype})")
    check(not enc or enc[worst_enc] <= tol_encoder,
          f"the group encoder's gradients disagree with the plain path ({tag} {dtype})")
    check(d_stats <= tol_stats, f"BN buffers disagree with the plain path ({tag} {dtype})")
    return {"loss_rel": d_loss, "grad_rel": rest[worst],
            "encoder_grad_rel": enc[worst_enc] if enc else None, "stats_rel": d_stats,
            f"{kernel}_launches": bwd}, grads


def grad_dist(grads, ref):
    """||grads - ref|| / ||ref|| over all leaves together, in f32."""
    num = sum(float(((grads[k].float() - ref[k].float()) ** 2).sum()) for k in ref)
    return math.sqrt(num / sum(float((ref[k].float() ** 2).sum()) for k in ref))


# bf16 pretraining: a step's gradients against the f32 step's on the same
# weights, the kernels' no farther than twice the plain path's, plus 1e-2.
# The per-leaf limit of phase 5 measures the step's conditioning here, not
# the kernels: a 2e-3 change of the BatchNorm sums alone (bf16's rounding)
# moves the plain bf16 step's gradients by 0.48 (max over leaves, the group
# encoder's aside) at B=8 and 0.19 at B=32 (measured on the CPU at 96 wide,
# depth 4, 1024 groups): the group encoder's and the readout's max-pools
# route gradients to near-tied points.
BF16_PRETRAIN_FACTOR, BF16_PRETRAIN_SLACK = 2.0, 1e-2


def bf16_pretrain_vs_plain(tag, quantities, f32_grads, kernel="flash_mha_bwd"):
    tol_loss, _, tol_stats = TOL_STEP["bfloat16"]
    _build.reset_launches()
    loss, grads, stats = quantities()
    bwd = _build.LAUNCHES[kernel]
    with plain_path():
        loss_p, grads_p, stats_p = quantities()
    d_loss = abs(loss - loss_p) / abs(loss_p)
    d_stats = max(rel_err(stats[k], stats_p[k]) for k in stats)
    e_k, e_p = grad_dist(grads, f32_grads), grad_dist(grads_p, f32_grads)
    top = max(float(g.abs().max()) for g in grads_p.values())
    d_grad = {k: rel_to_floor(grads[k], grads_p[k], 1e-3 * top) for k in grads}
    worst = max(d_grad, key=d_grad.get)
    print(f"[pretrain] {tag} bfloat16: one step vs plain path on the card: loss {loss:.6f} vs "
          f"{loss_p:.6f} (rel {d_loss:.3e}, tol {tol_loss}); gradients' distance from the f32 "
          f"step {e_k:.3e} (kernels) vs {e_p:.3e} (plain), tol {BF16_PRETRAIN_FACTOR} x plain + "
          f"{BF16_PRETRAIN_SLACK}; per-leaf max rel kernels vs plain {d_grad[worst]:.3e} "
          f"({worst}; not checked); BN buffers max rel {d_stats:.3e} (tol {tol_stats}); "
          f"{kernel} launches {bwd}")
    check(math.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
          f"non-finite loss or gradient ({tag} bfloat16)")
    check(d_loss <= tol_loss, f"loss disagrees with the plain path ({tag} bfloat16)")
    check(e_k <= BF16_PRETRAIN_FACTOR * e_p + BF16_PRETRAIN_SLACK,
          f"the kernels' bf16 gradients are farther from the f32 step than the plain path's "
          f"({tag})")
    check(d_stats <= tol_stats, f"BN buffers disagree with the plain path ({tag} bfloat16)")
    return {"loss_rel": d_loss, "grad_dist_from_f32": e_k, "plain_grad_dist_from_f32": e_p,
            "grad_rel_per_leaf_unchecked": d_grad[worst], "stats_rel": d_stats,
            f"{kernel}_launches": bwd}


def run_long_train_slice(steps=10):
    try:
        return _run_long_train_slice(steps)
    finally:
        shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)


def _run_long_train_slice(steps):
    out, counted = {"batch": LONG_BATCH, "npoints": LONG_NPOINTS, "num_group": LONG_GROUPS,
                    "tokens": LONG_GROUPS + 1}, {}
    ds = long_clouds()
    prompts = mn40_prompts()
    stream = batch_stream(Loader(ds, LONG_BATCH, shuffle=True, drop_last=True, seed=0))
    step_fn = make_train_step(smoothing=0.2)

    # prompt tuning with head types 3 and 2: one flash_mha_bwd a step, in block_11
    for ht in (3, 2):
        r = {"vs_plain": {}}
        b = cls.device_batch(next(iter(Loader(ds, LONG_BATCH, shuffle=True, seed=3))), DEV)
        for dtype in ("float32", "bfloat16"):
            model = long_trunk_model(dtype)
            ctx = {"model": model, "state": long_train_state(model, ht), "prompts": prompts}
            r["vs_plain"][dtype], _ = step_vs_plain(
                f"long trunk head_type {ht}", dtype, lambda: one_step_quantities(ctx, b, 11))
            check(r["vs_plain"][dtype]["flash_mha_bwd_launches"] == 1,
                  f"head_type {ht} runs one flash_mha_bwd a step")
        state = ctx["state"]
        check(any("block_11" in k for k in state.trainable), f"head_type {ht} trains block_11")
        frozen0 = snapshot({k: p for k, p in model.named_parameters() if k not in state.trainable})
        losses = run_steps(ctx, step_fn, stream, 3)
        _build.reset_launches()
        t0 = time.perf_counter()
        losses += run_steps(ctx, step_fn, stream, steps)
        rate = steps * LONG_BATCH / (time.perf_counter() - t0)
        per_step = {k: v / steps for k, v in sorted(_build.LAUNCHES.items())}
        counted[f"head_type_{ht}"] = _build.LAUNCHES["flash_mha_bwd"]
        print(f"[pretrain] long trunk prompt tuning, bf16 head_type {ht} B={LONG_BATCH} x "
              f"N={LONG_NPOINTS}: 3 warm-up steps, then {steps} steps (loss read every step): "
              f"{rate:.1f} train clouds/sec ({1e3 * LONG_BATCH / rate:.2f} ms per step); loss "
              f"first {losses[0]:.4f}, last {losses[-1]:.4f}; kernel launches per step "
              f"{json.dumps(per_step)}")
        check(all(math.isfinite(x) for x in losses), f"non-finite loss, head_type {ht}")
        check(per_step.get("flash_mha_bwd") == 1 and per_step.get("flash_mha") == 12,
              f"head_type {ht}: 12 flash_mha and 1 flash_mha_bwd a step: {per_step}")
        check(all(torch.equal(p, frozen0[k]) for k, p in model.named_parameters()
                  if k in frozen0), f"a frozen weight changed under head_type {ht}")
        r.update(train_clouds_per_sec=rate, ms_per_step=1e3 * LONG_BATCH / rate, steps=steps,
                 loss_first_last=[losses[0], losses[-1]], launches_per_step=per_step)
        out[f"head_type_{ht}"] = r
        del model, ctx, state

    # ULIP pretraining on the long trunk: every block runs flash_mha_bwd
    bank = pretrain.build_caption_bank(ds.classnames)
    cap_rng = np.random.RandomState(3)

    def tokens_for(labels):  # one template per cloud, as the driver draws them
        t_idx = cap_rng.randint(0, bank.shape[1], len(labels))
        return torch.from_numpy(bank[labels, t_idx]).to(DEV)

    r = {"vs_plain": {}}
    raw = next(iter(Loader(ds, PLAIN_PRETRAIN_BATCH, shuffle=True, seed=4)))
    pc8, tok8 = cls.device_batch(raw, DEV)["pc"], tokens_for(raw["label"])
    for dtype in ("float32", "bfloat16"):
        model = long_trunk_model(dtype)  # the same weights in both dtypes
        state = long_train_state(model, task="pretrain")
        tag = f"long trunk pretrain B={PLAIN_PRETRAIN_BATCH}"
        quantities = lambda: pretrain_quantities(model, state, pc8, tok8, 11)  # noqa: E731
        if dtype == "float32":
            r["vs_plain"][dtype], f32_grads = step_vs_plain(tag, dtype, quantities,
                                                            tol_encoder=TOL_ENCODER_F32)
        else:
            r["vs_plain"][dtype] = bf16_pretrain_vs_plain(tag, quantities, f32_grads)
        check(r["vs_plain"][dtype]["flash_mha_bwd_launches"] == 12,
              "a pretrain step runs 12 flash_mha_bwd on the long trunk")
        del model, state

    # a fixed batch, DropPath and augmentation off: the loss must fall
    model = long_trunk_model("bfloat16", drop_path_rate=0.0)
    state = long_train_state(model, task="pretrain", lr=1e-4)
    pstep = pretrain.make_pretrain_step(model, state.optimizer)
    raw = next(iter(Loader(ds, LONG_BATCH, shuffle=True, seed=5)))
    fb, ftok = cls.device_batch(raw, DEV), tokens_for(raw["label"])
    flosses = []
    for _ in range(10):
        state, m = pstep(state, {"pc": fb["pc"]}, ftok)
        flosses.append(m["loss"])
    flosses = [float(x) for x in flosses]
    print(f"[pretrain] long trunk, fixed batch B={LONG_BATCH}, 10 steps at lr 1e-4, "
          f"augmentation and DropPath off: loss {flosses[0]:.4f} -> {flosses[-1]:.4f} "
          f"(lowest {min(flosses):.4f})")
    check(all(math.isfinite(x) for x in flosses) and flosses[-1] < flosses[0],
          "the pretraining loss did not fall on a fixed batch")
    r["fixed_batch_loss"] = [flosses[0], flosses[-1]]
    del model, state, pstep

    # a window of pretraining steps as the driver takes them
    model = long_trunk_model("bfloat16")
    state = long_train_state(model, task="pretrain")
    pstep = pretrain.make_pretrain_step(model, state.optimizer)
    text0 = snapshot({k: p for k, p in model.named_parameters() if k not in state.trainable})

    def run(n):
        losses = []
        for _ in range(n):
            raw = next(stream)
            pc = train_augment(state.generator, cls.device_batch(raw, DEV)["pc"])
            _, m = pstep(state, {"pc": pc}, tokens_for(raw["label"]))
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        return losses

    losses = run(3)
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += run(steps)
    rate = steps * LONG_BATCH / (time.perf_counter() - t0)
    per_step = {k: v / steps for k, v in sorted(_build.LAUNCHES.items())}
    counted["pretrain"] = _build.LAUNCHES["flash_mha_bwd"]
    print(f"[pretrain] long trunk ULIP pretraining, bf16 B={LONG_BATCH} x N={LONG_NPOINTS}: 3 "
          f"warm-up steps, then {steps} steps (loss read every step): {rate:.1f} train "
          f"clouds/sec ({1e3 * LONG_BATCH / rate:.2f} ms per step); loss first {losses[0]:.4f}, "
          f"last {losses[-1]:.4f}; kernel launches per step {json.dumps(per_step)}")
    check(all(math.isfinite(x) for x in losses), "non-finite pretraining loss")
    check(per_step.get("flash_mha_bwd") == 12 and per_step.get("flash_mha") == 12,
          f"a pretrain step on the long trunk runs 12 flash_mha and 12 flash_mha_bwd: {per_step}")
    check(all(torch.equal(p, text0[k]) for k, p in model.named_parameters() if k in text0),
          "a frozen text-tower weight changed in pretraining")
    r.update(train_clouds_per_sec=rate, ms_per_step=1e3 * LONG_BATCH / rate, steps=steps,
             loss_first_last=[losses[0], losses[-1]], launches_per_step=per_step)
    out["pretrain_long_trunk"] = r
    del model, state, pstep

    # one epoch of pretrain.main on the default trunk over the synthetic ShapeNet fallback
    args = TaskArgs(dataset_name="shapenet", data_path=str(PRETRAIN_DIR / "no_shapenet"),
                    npoints=LONG_NPOINTS, batch_size=LONG_BATCH, epochs=1, seed=0,
                    compute_dtype="bfloat16", device="cuda", output_dir=str(PRETRAIN_DIR))
    _build.reset_launches()
    with switches({}):
        res = pretrain.main(args)
    launches = dict(_build.LAUNCHES)
    (entry,) = res["history"]
    pstate = res["state"]
    n_steps = pstate.step
    print(f"[pretrain] pretrain.main, one epoch on the default trunk (ULIP_PointBERT bf16, 513 "
          f"tokens) over the synthetic ShapeNet fallback, B={LONG_BATCH} x N={LONG_NPOINTS}: "
          f"{n_steps} steps, loss {entry['loss']:.4f}, pc_text_acc {entry['pc_text_acc']:.2f}, "
          f"{n_steps * LONG_BATCH / entry['epoch_time']:.1f} train clouds/sec; kernel launches "
          f"{json.dumps(launches, sort_keys=True)}")
    check(n_steps == 320 // LONG_BATCH and math.isfinite(entry["loss"]), "pretrain.main's epoch")
    for name in POINT_KERNELS:
        check(launches.get(name, 0) >= n_steps, f"pretrain.main did not launch {name} each step")
    fresh = create_train_state(
        build_model("ULIP_PointBERT", args, device=DEV).model,
        trainable_mask(pstate.model, task="pretrain"),
        lambda tr: build_optimizer("adamw", tr.items(), lambda s: 0.0), seed=0)
    load_checkpoint(str(PRETRAIN_DIR / "pretrain"), fresh)
    same = all(torch.equal(fresh.trainable[k], v) for k, v in pstate.trainable.items())
    print(f"[pretrain] checkpoint written and read back: {len(pstate.trainable)} trainable "
          f"leaves identical {same}, step {fresh.step}")
    check(same and fresh.step == n_steps, "the pretraining checkpoint did not read back")
    out["pretrain_main"] = {"steps": n_steps, "loss": entry["loss"],
                            "pc_text_acc": entry["pc_text_acc"],
                            "train_clouds_per_sec": n_steps * LONG_BATCH / entry["epoch_time"],
                            "launches": launches}
    return counted, out


# ---------------------------------------------------------------------------
# phase 10: PointBERT's two pretraining stages (dVAE tokenizer, masked point
# modeling)
# ---------------------------------------------------------------------------

PB_DIR = _build.BUILD_DIR.parent / "chip_smoke_pretrain_pb"
DVAE_BATCH, MPM_BATCH, PLAIN_MPM_BATCH = 64, 32, 8  # TaskArgs' default batch; PR 6's B=8
PB_NPOINTS = 1024


def pb_clouds():
    """320 synthetic clouds of 1024 points: the synthetic fallback that
    stands in for ShapeNet-55 (not in the repository)."""
    return make_synthetic(num_classes=40, samples_per_class=8, npoints=PB_NPOINTS, seed=2)


def trainable_all(model, lr):
    """AdamW at a constant ``lr`` on every parameter of ``model``."""
    return create_train_state(model, {k: True for k, _ in model.named_parameters()},
                              lambda tr: build_optimizer("adamw", tr.items(), lambda s: lr),
                              seed=1)


def dvae_model(dtype, seed=0):
    """The dVAE at ``DvaeConfig()`` (64 groups of 32, widths 256, 8192
    tokens), weights from ``seed``, on the card."""
    return ndvae.init_dvae(ndvae.DiscreteVAE(ndvae.DvaeConfig(), dtype=DTYPES[dtype]),
                           seed).to(DEV)


def dvae_quantities(model, state, pc, seed, recon):
    """``step_quantities`` of the dVAE's loss (``make_dvae_step``'s) at
    temperature 1, the Gumbel noise drawn after ``seed``."""
    def loss_of():
        ret = model(pc, temperature=1.0, train=True, generator=state.generator)
        loss_recon, klv = ndvae.dvae_loss(ret, model.config.num_tokens, recon=recon)
        return loss_recon + 0.1 * klv

    return step_quantities(state, seed, loss_of)


def mpm_quantities(student, dvae, state, pc, mask, seed):
    """``step_quantities`` of the MPM loss against the frozen dVAE's ids at
    ``mask``."""
    def loss_of():
        nb, ct = npb.group_points(pc, student.config.num_group, student.config.group_size)
        logits = student(nb, ct, mask, train=True, generator=state.generator)
        return nmpm.mpm_loss(logits, nmpm.dvae_tokenize(dvae, nb, ct), mask)[0]

    return step_quantities(state, seed, loss_of)


def timed_window(tag, batch, run_step, steps):
    """3 warm-up steps, then ``steps`` with the loss read every step:
    train clouds/sec and kernel launches per step from the counters."""
    losses = [run_step() for _ in range(3)]
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += [run_step() for _ in range(steps)]
    torch.cuda.synchronize()
    rate = steps * batch / (time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    per_step = {k: v / steps for k, v in sorted(launches.items())}
    print(f"[pretrain_pb] {tag}: 3 warm-up steps, then {steps} steps (loss read every step): "
          f"{rate:.1f} train clouds/sec ({1e3 * batch / rate:.2f} ms per step); loss first "
          f"{losses[0]:.4f}, last {losses[-1]:.4f}; kernel launches per step "
          f"{json.dumps(per_step)}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss ({tag})")
    return launches, dict(train_clouds_per_sec=rate, ms_per_step=1e3 * batch / rate, steps=steps,
                          loss_first_last=[losses[0], losses[-1]], launches_per_step=per_step)


def fixed_batch_falls(tag, step, steps=10):
    losses = [step() for _ in range(steps)]
    print(f"[pretrain_pb] {tag}, a fixed batch, {steps} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (lowest {min(losses):.4f})")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"the loss did not fall on a fixed batch ({tag})")
    return [losses[0], losses[-1]]


# The dVAE's every leaf sits behind a max over 4 EdgeConv neighbours, the
# group encoder's max-pool or a decoder ReLU, so a rounding-sized change of
# the group encoder's output reroutes some gradients: a 1e-7 relative change
# moves single leaves by up to 1.4e-2 of their largest entry and all leaves
# together by 5.2e-4 (1.3e-3 at 1e-6; measured on the CPU at full width,
# B=8, f32). An f32 dVAE step is held to the plain path by the distance of
# all its gradients together, with phase 5's limits on loss and buffers.
TOL_DVAE_GRAD_DIST = 1e-2


def f32_step_vs_plain_by_distance(tag, quantities, kernel, plain_switches=None):
    tol_loss, _, tol_stats = TOL_STEP["float32"]
    _build.reset_launches()
    loss, grads, stats = quantities()
    n = _build.LAUNCHES[kernel]
    with switches(plain_switches or {}), plain_path():
        loss_p, grads_p, stats_p = quantities()
    d_loss = abs(loss - loss_p) / abs(loss_p)
    d_stats = max(rel_err(stats[k], stats_p[k]) for k in stats)
    dist = grad_dist(grads, grads_p)
    top = max(float(g.abs().max()) for g in grads_p.values())
    d_grad = {k: rel_to_floor(grads[k], grads_p[k], 1e-3 * top) for k in grads}
    worst = max(d_grad, key=d_grad.get)
    print(f"[pretrain_pb] {tag} float32: one step vs plain path on the card: loss {loss:.6f} vs "
          f"{loss_p:.6f} (rel {d_loss:.3e}, tol {tol_loss}); gradients' distance, all "
          f"{len(grads)} leaves together, {dist:.3e} (tol {TOL_DVAE_GRAD_DIST}); per-leaf max "
          f"rel {d_grad[worst]:.3e} ({worst}; not checked); BN buffers max rel {d_stats:.3e} "
          f"(tol {tol_stats}); {kernel} launches {n}")
    check(math.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
          f"non-finite loss or gradient ({tag} float32)")
    check(d_loss <= tol_loss, f"loss disagrees with the plain path ({tag} float32)")
    check(dist <= TOL_DVAE_GRAD_DIST, f"gradients disagree with the plain path ({tag} float32)")
    check(d_stats <= tol_stats, f"BN buffers disagree with the plain path ({tag} float32)")
    return {"loss_rel": d_loss, "grad_dist": dist, "grad_rel_per_leaf_unchecked": d_grad[worst],
            "stats_rel": d_stats, f"{kernel}_launches": n}, grads


def pb_data():
    """The pretraining stages' clouds, a shuffled stream of dVAE batches
    and one fixed batch of 64 on the card."""
    ds = pb_clouds()
    stream = batch_stream(Loader(ds, DVAE_BATCH, shuffle=True, drop_last=True, seed=0))
    pc64 = cls.device_batch(next(iter(Loader(ds, DVAE_BATCH, shuffle=True, seed=3))), DEV)["pc"]
    return ds, stream, pc64


def run_dvae_emd(pc64, stream, total, steps):
    """The dVAE with ``dvae_loss(recon="emd")``, approx_match on the path:
    one f32 step against the plain path (``PPT_FORCE_XLA_EMD=1``), then a
    bf16 window of ``steps`` steps. Returns its numbers and the window's
    approx_match launches."""
    r = {"batch": DVAE_BATCH, "npoints": PB_NPOINTS}
    model = dvae_model("f32")
    state = trainable_all(model, 1e-3)
    r["vs_plain"], _ = f32_step_vs_plain_by_distance(
        f"dVAE (EMD) B={DVAE_BATCH}", lambda: dvae_quantities(model, state, pc64, 11, "emd"),
        "approx_match", plain_switches={"PPT_FORCE_XLA_EMD": "1"})
    check(r["vs_plain"]["approx_match_launches"] == 2, "a dVAE EMD step runs approx_match twice")
    model = dvae_model("bf16")
    state = trainable_all(model, 1e-3)
    step = dvae_pretrain.make_dvae_step(model, state.optimizer, recon="emd")

    def window_step():
        pc = train_augment(state.generator, cls.device_batch(next(stream), DEV)["pc"])
        temp = dvae_pretrain.temperature_at(state.step, total)
        return float(step(state, {"pc": pc}, temp)[1]["loss"])

    launches, stats = timed_window(f"dVAE (EMD) bf16 B={DVAE_BATCH} x N={PB_NPOINTS}",
                                   DVAE_BATCH, window_step, steps)
    r.update(stats)
    check(launches.get("approx_match") == 2 * steps, f"two approx_match a step: {launches}")
    return r, launches.get("approx_match", 0)


def run_pretrain_pb_slice(steps=10):
    try:
        return _run_pretrain_pb_slice(steps)
    finally:
        shutil.rmtree(PB_DIR, ignore_errors=True)


def _run_pretrain_pb_slice(steps):
    out = {"dvae": {"batch": DVAE_BATCH, "npoints": PB_NPOINTS, "config": "DvaeConfig()"},
           "mpm": {"batch": MPM_BATCH, "npoints": PB_NPOINTS, "config": "PointBertConfig()"}}
    counted = {}
    ds, stream, pc64 = pb_data()

    # 1. the dVAE with its Chamfer-L1 loss: one step against the plain path
    r = out["dvae"]
    r["vs_plain"] = {}
    for dtype in ("f32", "bf16"):
        model = dvae_model(dtype)  # the same weights in both dtypes
        state = trainable_all(model, 1e-3)
        quantities = lambda: dvae_quantities(model, state, pc64, 11, "chamfer")  # noqa: E731
        if dtype == "f32":
            r["vs_plain"][dtype], f32_grads = f32_step_vs_plain_by_distance(
                f"dVAE B={DVAE_BATCH}", quantities, "mini_stats")
        else:
            r["vs_plain"][dtype] = bf16_pretrain_vs_plain(f"dVAE B={DVAE_BATCH}", quantities,
                                                          f32_grads, kernel="mini_stats")
        del model, state

    model = dvae_model("bf16")
    state = trainable_all(model, 1e-3)
    step = dvae_pretrain.make_dvae_step(model, state.optimizer)

    def fixed():
        state.generator.manual_seed(0)  # the same Gumbel noise every step
        return float(step(state, {"pc": pc64}, 1.0)[1]["loss"])

    r["fixed_batch_loss"] = fixed_batch_falls("dVAE bf16, lr 1e-3, Gumbel noise fixed", fixed)
    model = dvae_model("bf16")
    state = trainable_all(model, 1e-3)
    step = dvae_pretrain.make_dvae_step(model, state.optimizer)
    total = 250 * (len(ds) // DVAE_BATCH)

    def window_step():
        pc = train_augment(state.generator, cls.device_batch(next(stream), DEV)["pc"])
        temp = dvae_pretrain.temperature_at(state.step, total)
        return float(step(state, {"pc": pc}, temp)[1]["loss"])

    launches, stats = timed_window(f"dVAE (Chamfer-L1) bf16 B={DVAE_BATCH} x N={PB_NPOINTS}",
                                   DVAE_BATCH, window_step, steps)
    r.update(stats)
    for name in ("fps_batched", "knn_gather", "mini_stats", "mini_forward"):
        check(launches.get(name, 0) == steps, f"the dVAE step launches {name} once: {launches}")
    check(not launches.get("approx_match"), "the Chamfer-L1 dVAE step launched approx_match")

    # dvae_pretrain.main: one epoch, its checkpoint read back (phase 10's MPM reads it too)
    args = TaskArgs(dataset_name="synthetic", npoints=PB_NPOINTS, batch_size=DVAE_BATCH,
                    epochs=1, seed=0, compute_dtype="bfloat16", device="cuda",
                    output_dir=str(PB_DIR))
    res = dvae_pretrain.main(args)
    (entry,) = res["history"]
    dstate = res["state"]
    fresh = trainable_all(ndvae.DiscreteVAE(ndvae.DvaeConfig(), torch.bfloat16).to(DEV), 0.0)
    load_checkpoint(str(PB_DIR / "dvae"), fresh)
    same = (all(torch.equal(fresh.trainable[k], v) for k, v in dstate.trainable.items())
            and all(torch.equal(fresh.batch_stats()[k], v)
                    for k, v in dstate.batch_stats().items()))
    rate = dstate.step * DVAE_BATCH / entry["epoch_time"]
    print(f"[pretrain_pb] dvae_pretrain.main, one epoch (bf16, B={DVAE_BATCH} x N={PB_NPOINTS}, "
          f"{len(ds)} synthetic clouds): {dstate.step} steps, recon {entry['recon']:.4f}, kl "
          f"{entry['kl']:.4f}, temperature {entry['temperature']:.4f}, {rate:.1f} train "
          f"clouds/sec; checkpoint read back identical {same}")
    check(dstate.step == len(ds) // DVAE_BATCH and math.isfinite(entry["recon"]) and same,
          "dvae_pretrain.main's epoch or checkpoint")
    r["main"] = dict(entry, steps=dstate.step, train_clouds_per_sec=rate)
    del model, state, step, res, dstate, fresh

    # 2. the dVAE with dvae_loss(recon="emd"): approx_match on the path
    out["dvae_emd"], counted["approx_match"] = run_dvae_emd(pc64, stream, total, steps)

    # 3. masked point modeling at PointBERT's widths, the dVAE from the checkpoint
    r = out["mpm"]
    cfg = npb.PointBertConfig()
    dcfg = ndvae.DvaeConfig(group_size=cfg.group_size, num_group=cfg.num_group)
    ckpt = PB_DIR / "dvae" / "checkpoint_best.pt"

    def frozen_dvae(dtype):
        dvae = ndvae.DiscreteVAE(dcfg, dtype=DTYPES[dtype])
        return mpm_pretrain.load_dvae(dvae, str(ckpt)).to(DEV).requires_grad_(False)

    def student(dtype, drop_path_rate=0.1):
        return nmpm.init_mpm(nmpm.PointBertMPM(
            npb.PointBertConfig(drop_path_rate=drop_path_rate), num_tokens=dcfg.num_tokens,
            dtype=DTYPES[dtype]), 0).to(DEV)

    pc8 = pc64[:PLAIN_MPM_BATCH]
    mask8 = nmpm.sample_group_mask(torch.Generator(device=DEV).manual_seed(5), PLAIN_MPM_BATCH,
                                   cfg.num_group, 0.4, device=DEV)
    r["vs_plain"] = {}
    for dtype in ("f32", "bf16"):
        s_model, dvae = student(dtype), frozen_dvae(dtype)
        state = trainable_all(s_model, 1e-4)
        quantities = lambda: mpm_quantities(s_model, dvae, state, pc8, mask8, 11)  # noqa: E731
        tag = f"MPM B={PLAIN_MPM_BATCH}"
        if dtype == "f32":
            r["vs_plain"][dtype], f32_grads = step_vs_plain(
                tag, "float32", quantities, tol_encoder=TOL_ENCODER_F32, encoder="encoder.",
                kernel="fused_vit_block")
        else:
            r["vs_plain"][dtype] = bf16_pretrain_vs_plain(tag, quantities, f32_grads,
                                                          kernel="fused_vit_block")
        check(r["vs_plain"][dtype]["fused_vit_block_launches"] == cfg.depth,
              "an MPM step runs the block kernel once a block")
        del s_model, dvae, state

    dvae = frozen_dvae("bf16")
    s_model = student("bf16", drop_path_rate=0.0)
    state = trainable_all(s_model, 1e-4)
    mstep = mpm_pretrain.make_mpm_step(s_model, dvae, state.optimizer, 0.4, cfg.num_group,
                                       cfg.group_size)
    pc32 = pc64[:MPM_BATCH]
    mask32 = nmpm.sample_group_mask(torch.Generator(device=DEV).manual_seed(6), MPM_BATCH,
                                    cfg.num_group, 0.4, device=DEV)
    r["fixed_batch_loss"] = fixed_batch_falls(
        "MPM bf16, lr 1e-4, DropPath off, mask fixed",
        lambda: float(mstep(state, {"pc": pc32}, mask=mask32)[1]["loss"]))
    s_model = student("bf16")
    state = trainable_all(s_model, 1e-4)
    mstep = mpm_pretrain.make_mpm_step(s_model, dvae, state.optimizer, 0.4, cfg.num_group,
                                       cfg.group_size)
    mstream = batch_stream(Loader(ds, MPM_BATCH, shuffle=True, drop_last=True, seed=1))
    accs = []

    def mpm_window_step():
        pc = train_augment(state.generator, cls.device_batch(next(mstream), DEV)["pc"])
        metrics = mstep(state, {"pc": pc})[1]
        accs.append(metrics["masked_acc"])
        return float(metrics["loss"])

    launches, stats = timed_window(f"MPM bf16 B={MPM_BATCH} x N={PB_NPOINTS}", MPM_BATCH,
                                   mpm_window_step, steps)
    r.update(stats, masked_acc_last=float(accs[-1]))
    check(launches.get("fused_vit_block") == cfg.depth * steps
          and launches.get("mini_forward") == 2 * steps,
          f"an MPM step runs 12 block kernels and two MiniPointNets: {launches}")
    del s_model, state, mstep, dvae

    # mpm_pretrain.main: one epoch, reading the dVAE checkpoint itself
    args = TaskArgs(dataset_name="synthetic", npoints=PB_NPOINTS, batch_size=MPM_BATCH,
                    epochs=1, seed=0, compute_dtype="bfloat16", device="cuda",
                    output_dir=str(PB_DIR))
    res = mpm_pretrain.main(args)
    (entry,) = res["history"]
    n_steps = res["state"].step
    rate = n_steps * MPM_BATCH / entry["epoch_time"]
    print(f"[pretrain_pb] mpm_pretrain.main, one epoch (bf16, B={MPM_BATCH} x N={PB_NPOINTS}, "
          f"the dVAE from {ckpt.relative_to(PB_DIR)}): {n_steps} steps, loss "
          f"{entry['loss']:.4f}, masked_acc {entry['masked_acc']:.2f}, {rate:.1f} train "
          f"clouds/sec")
    check(n_steps == len(ds) // MPM_BATCH and math.isfinite(entry["loss"]),
          "mpm_pretrain.main's epoch")
    r["main"] = dict(entry, steps=n_steps, train_clouds_per_sec=rate)
    return counted, out


# ---------------------------------------------------------------------------
# phase 11: the kernel tools
# ---------------------------------------------------------------------------

PROBE_MODES = vitblock_probe.DEFAULT_MODES + ",qk_packed2,prod"


def run_tools_slice():
    """The ablation probe as a user runs it (its defaults plus qk_packed2 and
    prod), every mode timed; then the on-card kernel check, 0 failures."""
    _build.reset_launches()
    t0 = time.perf_counter()
    probe_ms = vitblock_probe.main(["--modes", PROBE_MODES])
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    probe_launches = dict(_build.LAUNCHES)
    missing = [m for m in PROBE_MODES.split(",") if m not in probe_ms]
    check(not missing, f"vitblock_probe timed no result for {missing}")
    check(probe_launches.get("vit_variant", 0) > 0 and probe_launches.get("fused_vit_block", 0) > 0,
          f"vitblock_probe launched {probe_launches}")
    _build.reset_launches()
    t0 = time.perf_counter()
    rc = kernel_check.main()
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    check_launches = dict(_build.LAUNCHES)
    check(rc == 0, "kernel_check reported failures")
    stats = dict(vitblock_probe_ms=probe_ms, probe_seconds=probe_s,
                 probe_launches=probe_launches, kernel_check_failures=0,
                 kernel_check_seconds=check_s, kernel_check_launches=check_launches)
    return {"vit_variant": probe_launches["vit_variant"]}, stats


# ---------------------------------------------------------------------------
# phase 12: device time by part (tools/profile.py)
# ---------------------------------------------------------------------------


def run_profiles(batch=32, batches=5):
    """PPT-Base recognition and the long trunk's under tools/profile.py: the
    block GEMMs' device ms a batch and their rate (the 12 blocks' four
    products over that time), and the flash forward's, mini_forward's and
    knn_gather's and fps_batched's ms a batch; then PPT-Base's tuning step
    on the tower text route: wall, idle share and the text kernels' parts."""
    out = {}
    for tag, kw in (("ppt_base", {}), ("long_trunk", dict(num_group=1024, npoints=8192))):
        r = tprofile.profile_step(batch=batch, batches=batches, **kw)
        parts = r["device_ms_per_batch"]
        stats = dict(wall_ms_per_batch=r["wall_ms_per_batch"],
                     device_busy_ms_per_batch=r["device_busy_ms_per_batch"],
                     device_idle_share=r["device_idle_share"], device_ms_per_batch=parts)
        cfg = npb.PointBertConfig(num_group=kw.get("num_group", 512))
        rows, C = batch * (cfg.num_group + 1), cfg.trans_dim
        if "vit block: GEMMs" in parts:
            flops = cfg.depth * 2 * rows * (C * 3 * C + C * C + 2 * C * 4 * C)
            gemm_ms = parts["vit block: GEMMs"]
            stats.update(block_gemm_ms=gemm_ms, block_gemm_gflop=flops / 1e9,
                         block_gemm_tflops=flops / (gemm_ms * 1e-3) / 1e12)
        for part in ("flash_mha", "mini_forward", "knn_gather", "fps_batched"):
            if part in parts:
                stats[f"{part}_ms"] = parts[part]
        print(f"[profile] {tag}: wall {r['wall_ms_per_batch']:.3f} ms a batch, idle "
              f"{r['device_idle_share']:.3f}; block GEMMs {stats.get('block_gemm_ms')} ms "
              f"({stats.get('block_gemm_tflops')} TFLOP/s); flash_mha "
              f"{stats.get('flash_mha_ms')} ms; mini_forward {stats.get('mini_forward_ms')} ms; "
              f"knn_gather {stats.get('knn_gather_ms')} ms; fps_batched "
              f"{stats.get('fps_batched_ms')} ms")
        out[tag] = stats
    check("block_gemm_ms" in out["ppt_base"], "PPT-Base recognition ran no block GEMM")
    check("flash_mha_ms" in out["long_trunk"], "the long trunk ran no flash_mha")
    check(all("mini_forward_ms" in v for v in out.values()), "a profile ran no mini_forward")
    check(all("knn_gather_ms" in v and "fps_batched_ms" in v for v in out.values()),
          "a profile ran no grouping kernel")

    _build.reset_launches()
    r = tprofile.profile_train_step(batch=TRAIN_BATCH, batches=batches, text_route="tower")
    counts = {k: _build.LAUNCHES[k] for k in ("fused_text_tower_res", "fused_text_tower_bwd")}
    text = {k: v for k, v in r["device_ms_per_batch"].items() if k.startswith("text:")}
    out["ppt_base_train_tower"] = dict(
        wall_ms_per_step=r["wall_ms_per_batch"], device_busy_ms_per_step=r[
            "device_busy_ms_per_batch"], device_idle_share=r["device_idle_share"],
        clouds_per_sec=r["clouds_per_sec"], device_ms_per_step=r["device_ms_per_batch"],
        text_ms_per_step=text, text_kernels_per_step=r["text_kernels_per_batch"],
        section_ms_per_step=r["section_ms_per_batch"], launches=counts)
    print(f"[profile] ppt_base_train_tower: wall {r['wall_ms_per_batch']:.3f} ms a step, idle "
          f"{r['device_idle_share']:.3f}, busy {r['device_busy_ms_per_batch']:.3f} ms; text "
          f"parts, ms a step: {json.dumps({k: round(v, 4) for k, v in text.items()})}; "
          f"launches {counts}")
    check(all(v > 0 for v in counts.values()),
          f"the tower-route step ran no fused_text_tower_res or fused_text_tower_bwd: {counts}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the published recipes through the port's own CLI
# ---------------------------------------------------------------------------

RECIPE_DIR = _build.BUILD_DIR.parent / "chip_smoke_recipes"
RECIPE_ROOT = Path(__file__).resolve().parent / "configs" / "experiments"
RECIPES = ("ppt_base_mn40", "ppt_ptb_sonn_hardest", "fewshot_mn40")
RECIPE_VOTES, RECIPE_DISPATCH = 3, 2
# PointBERT's kernels on the recipes' default routes
RECIPE_KERNELS = ("fps_batched", "knn_gather", "mini_forward", "mini_stats", "fused_vit_block",
                  "fused_vit_block_readout")
# (text route, point route, head type, the kernel adahessian is refused by, or None)
ADAHESSIAN_ROUTES = (("off", "block", 0, None), ("off", "plain", 3, None),
                     ("off", "block", 3, "fused_vit_block_readout"),
                     ("off", "tower", 3, "fused_vit_tower"), ("off", "unfused", 2, "fused_mha"),
                     ("block", "block", 0, "fused_text_block"),
                     ("tower", "block", 0, "fused_text_tower_bwd"))


def run_recipe(name, smi):
    """One epoch of a published recipe through ``cls.main`` (``fewshot.main``
    for the few-shot one) with ``--set epochs=1 --votes 3
    --steps_per_dispatch 2``: the loss finite, ``val_acc1`` logged, the
    checkpoint read back into a fresh ``cls.setup``, PointBERT's kernels
    launched, and ``fused_vit_block_readout`` launched votes x batches times
    in the evaluation."""
    module = fewshot if name.startswith("fewshot") else cls
    out_dir = RECIPE_DIR / name
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--config", str(RECIPE_ROOT / f"{name}.yaml"), "--set", "epochs=1", "--votes",
            str(RECIPE_VOTES), "--steps_per_dispatch", str(RECIPE_DISPATCH), "--output_dir",
            str(out_dir)]
    seen = {}
    real_parse, real_validate = module.parse_args, cls.validate

    def parse(argv=None):
        seen["args"] = real_parse(argv)
        return seen["args"]

    def validate(*a, **kw):
        before = collections.Counter(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = real_validate(*a, **kw)
        torch.cuda.synchronize()
        seen["eval_s"] = time.perf_counter() - t0
        seen["eval_launches"] = {k: _build.LAUNCHES[k] - before[k] for k in RECIPE_KERNELS}
        seen["eval_batches"] = math.ceil(len(a[2]) / a[4].batch_size)
        seen["votes"] = kw.get("votes", 1)
        return val

    _build.reset_launches()
    module.parse_args, cls.validate = parse, validate
    t0 = time.perf_counter()
    try:
        result = module.main(argv)
    finally:
        module.parse_args, cls.validate = real_parse, real_validate
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES[k] for k in RECIPE_KERNELS}
    args = seen["args"]
    (entry,) = result["history"]
    check(math.isfinite(entry["loss"]), f"recipe {name}: non-finite loss {entry['loss']}")
    check("val_acc1" in entry, f"recipe {name}: no val_acc1 in {entry}")
    check(all(v > 0 for v in launches.values()), f"recipe {name}: a kernel never ran: {launches}")
    check(seen["votes"] == RECIPE_VOTES, f"recipe {name}: the train loop's eval took "
          f"{seen['votes']} votes")
    want = RECIPE_VOTES * seen["eval_batches"]
    check(seen["eval_launches"]["fused_vit_block_readout"] == want,
          f"recipe {name}: fused_vit_block_readout ran {seen['eval_launches']} times in the "
          f"evaluation, not votes x batches = {want}")
    fresh = cls.setup(args)
    load_checkpoint(str(out_dir / (args.exp_name or "cls")), fresh["state"])
    n_batches = len(fresh["train_ds"]) // args.batch_size
    steps = sum(1 for it in range(n_batches) if it / n_batches <= args.data_ratio)
    check(fresh["state"].step == steps, f"recipe {name}: the checkpoint holds step "
          f"{fresh['state'].step}, the epoch took {steps}")
    stats = dict(steps=steps, batch=args.batch_size, head_type=args.head_type,
                 dataset=fresh["train_ds"].name, compute_dtype=args.compute_dtype,
                 loss=entry["loss"], val_acc1=entry["val_acc1"],
                 train_clouds_per_s=steps * args.batch_size / entry["epoch_time"],
                 train_s=entry["epoch_time"], eval_s_with_votes=seen["eval_s"],
                 votes=RECIPE_VOTES, eval_batches=seen["eval_batches"], wall_s=wall,
                 launches=launches, eval_launches=seen["eval_launches"])
    print(f"[recipe] {name}: {steps} steps of {args.batch_size} ({stats['dataset']}, head_type "
          f"{args.head_type}, {args.compute_dtype}, steps_per_dispatch {RECIPE_DISPATCH}), "
          f"train {stats['train_clouds_per_s']:.1f} clouds/s; eval {seen['eval_s']:.3f} s with "
          f"{RECIPE_VOTES} votes over {seen['eval_batches']} batches; loss {entry['loss']:.4f}, "
          f"val_acc1 {entry['val_acc1']:.2f}; launches {launches}; {smi}")
    return stats


def _close_rel(got, want):
    """Worst |got - want| / |want| (inf where want is 0 and got is not)."""
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / want.abs()).max())


def run_optimizer_zoo():
    """Two card steps of every optimizer name and of the plateau stage on
    the trainable leaves of head type 3 (the 384 x 1152 qkv weight reaches
    adafactor's factored path), held to the same optimizer on the CPU with
    the same gradients copied to the host: f32, 1e-6 relative to each entry
    (the optimizers take correctly rounded square roots, divide by device
    scalars and sum in f64, so the two devices round alike)."""
    from ppt_torch.train.optim import OPTIMIZERS

    ctx = cls.setup(train_args("float32", head_type=3))
    state, names = ctx["state"], list(ctx["state"].trainable)
    qkv = "point_encoder.block_11.attn.qkv.kernel"
    check(tuple(state.trainable[qkv].shape) == (384, 1152), f"{qkv} is not 384 x 1152")
    b = cls.device_batch(next(iter(Loader(ctx["train_ds"], TRAIN_BATCH, shuffle=True, seed=3))),
                         DEV)
    logits = state.model(b["pc"], ctx["prompts"], train=True, generator=state.generator)
    loss = smoothed_cross_entropy(logits, b["label"], 0.2)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.trainable[k] for k in names])))
    hess = {k: g * g + 1e-3 for k, g in grads.items()}  # a positive diagonal for adahessian
    loss = loss.detach()
    host = ({k: g.cpu() for k, g in grads.items()}, {k: h.cpu() for k, h in hess.items()},
            loss.cpu())
    worst = {}
    for name in OPTIMIZERS + ("plateau",):
        kw = dict(weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)
        if name == "plateau":
            kw.update(plateau_patience=1, steps_per_epoch=1)
        opt = "adamw" if name == "plateau" else name
        on_card = {k: v.detach().clone() for k, v in state.trainable.items()}
        on_host = {k: v.detach().cpu().clone() for k, v in state.trainable.items()}
        card = build_optimizer(opt, on_card.items(), lambda s: 3e-3, **kw)
        cpu = build_optimizer(opt, on_host.items(), lambda s: 3e-3, **kw)
        for _ in range(2):
            card.step(grads, value=loss, hess=hess)
            cpu.step(host[0], value=host[2], hess=host[1])
        worst[name] = max(_close_rel(on_card[k], on_host[k]) for k in names)
        check(worst[name] <= 1e-6, f"optimizer {name}: card and host differ by {worst[name]:.3e}")
        if name == "adafactor":
            check(tuple(card.v_row[qkv].shape) == (384,) and tuple(card.v_col[qkv].shape)
                  == (1152,), "adafactor did not factor the 384 x 1152 qkv weight")
        if name == "plateau":
            check(abs(float(card.plateau.scale) - 0.1) < 1e-7 and float(cpu.plateau.scale)
                  == float(card.plateau.scale), "the plateau stage did not scale by 0.1")
    print(f"[recipe] optimizer zoo, 2 steps on the card vs the host at head_type 3 (worst "
          f"relative difference by name): "
          + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def run_adahessian_routes(steps=3):
    """adahessian on every route: three steps where no kernel lies between a
    trainable leaf and the loss, the refusal by the kernel's name where one
    does (the reference's hutchinson_diag refuses there too)."""
    out = {}
    for text, point, head_type, refused in ADAHESSIAN_ROUTES:
        tag = f"text {text}, point {point}, head_type {head_type}"
        ctx = setup_with_route(train_args("float32", head_type=head_type, optim="adahessian"),
                               text, point)
        step = make_train_step(0.2, second_order=True)
        loader = Loader(ctx["train_ds"], TRAIN_BATCH, shuffle=True, seed=5)
        stream = batch_stream(loader)
        if refused:
            try:
                step(ctx["state"], cls.device_batch(next(stream), DEV), ctx["prompts"])
            except NotImplementedError as e:
                check(str(e).startswith(f"{refused}: no second derivative"),
                      f"adahessian ({tag}) refused by another name: {e}")
                out[tag] = f"refused by {refused}"
                continue
            check(False, f"adahessian ({tag}) was not refused by {refused}")
        before = snapshot(ctx["state"].trainable)
        losses = run_steps(ctx, step, stream, steps)
        moved = max(float((v.detach() - before[k]).abs().max())
                    for k, v in ctx["state"].trainable.items())
        check(all(math.isfinite(x) for x in losses) and moved > 0
              and all(torch.isfinite(v).all() for v in ctx["state"].trainable.values()),
              f"adahessian ({tag}): losses {losses}, largest move {moved}")
        out[tag] = dict(losses=losses, largest_move=moved)
    print(f"[recipe] adahessian by route: {json.dumps(out)}")
    return out


def run_recipes_slice(smi):
    """Phase 13: the three published recipes, the optimizer zoo on the card,
    adahessian by route; ``smi`` is the card's name and power limit."""
    t0 = time.perf_counter()
    stats = {name: run_recipe(name, smi) for name in RECIPES}
    stats["optimizer_zoo_worst_rel"] = run_optimizer_zoo()
    stats["adahessian_routes"] = run_adahessian_routes()
    stats["seconds"] = time.perf_counter() - t0
    print(f"[recipe] phase 13 took {stats['seconds']:.1f} s")
    return stats


# ---------------------------------------------------------------------------
# phase 14: converted ULIP/SLIP backbones, and ULIP_PN_MLP at full width
# ---------------------------------------------------------------------------

PRETRAINED_DIR = _build.BUILD_DIR.parent / "chip_smoke_pretrained"
MLP_BATCH = 32
MLP_STEPS = 5  # the timed window
MLP_PROFILED = 3  # the profiled window
# PointMLP's four FPS launches a batch: 1024 -> 512 -> 256 -> 128 -> 64 points
MLP_FPS_SHAPES = ((1024, 512), (512, 256), (256, 128), (128, 64))
LOADED_MSG = "%s: loaded %d/%d leaves from pretrained"  # train/checkpoint.py's line

# The phase writes its .pt files with the reference's parameter names from a
# seeded port model: a port module path -> (the reference's module name, a
# Conv's 1-wide kernel), by checkpoint kind, the inverse of the layout rules of
# ppt_torch/tools/ckpt_convert.py. A template ending in "_" joins its leaves
# without a dot (in_proj_weight).
_TEXT_REF = (
    (r"", "", False), (r"text", "", False), (r"text\.token_embedding", "token_embedding", False),
    (r"text\.ln_final", "ln_final", False),
    (r"text\.block_(\d+)\.(ln_[12])", r"transformer.resblocks.\1.\2", False),
    (r"text\.block_(\d+)\.attn\.in_proj", r"transformer.resblocks.\1.attn.in_proj_", False),
    (r"text\.block_(\d+)\.attn\.out_proj", r"transformer.resblocks.\1.attn.out_proj", False),
    (r"text\.block_(\d+)\.(c_fc|c_proj)", r"transformer.resblocks.\1.mlp.\2", False))
_PE = r"point_encoder\."
REF_NAMES = {
    "slip": _TEXT_REF,
    "pointbert": (
        (r"", "", False), (r"point_encoder", "point_encoder", False),
        (_PE + r"encoder\.conv1a", "point_encoder.encoder.first_conv.0", True),
        (_PE + r"encoder\.bn1", "point_encoder.encoder.first_conv.1", False),
        (_PE + r"encoder\.conv1b", "point_encoder.encoder.first_conv.3", True),
        (_PE + r"encoder\.conv2a", "point_encoder.encoder.second_conv.0", True),
        (_PE + r"encoder\.bn2", "point_encoder.encoder.second_conv.1", False),
        (_PE + r"encoder\.conv2b", "point_encoder.encoder.second_conv.3", True),
        (_PE + r"(reduce_dim|norm)", r"point_encoder.\1", False),
        (_PE + r"pos_embed1", "point_encoder.pos_embed.0", False),
        (_PE + r"pos_embed2", "point_encoder.pos_embed.2", False),
        (_PE + r"block_(\d+)\.(.+)", r"point_encoder.blocks.blocks.\1.\2", False)),
    "pointnet2": (
        (r"", "", False),
        (_PE + r"(sa\d)\.conv(\d+)_(\d+)", r"point_encoder.\1.conv_blocks.\2.\3", True),
        (_PE + r"(sa\d)\.bn(\d+)_(\d+)", r"point_encoder.\1.bn_blocks.\2.\3", False),
        (_PE + r"(sa\d)\.conv(\d+)", r"point_encoder.\1.mlp_convs.\2", True),
        (_PE + r"(sa\d)\.bn(\d+)", r"point_encoder.\1.mlp_bns.\2", False),
        (_PE + r"head\.(fc\d|bn\d)", r"point_encoder.\1", False)),
    "pointmlp": (
        (r"", "", False),
        (_PE + r"embedding\.conv", "point_encoder.embedding.net.0", True),
        (_PE + r"embedding\.bn", "point_encoder.embedding.net.1", False),
        (_PE + r"grouper(\d)", r"point_encoder.local_grouper_list.\1", False),
        (_PE + r"pre(\d)\.transfer\.conv", r"point_encoder.pre_blocks_list.\1.transfer.net.0",
         True),
        (_PE + r"pre(\d)\.transfer\.bn", r"point_encoder.pre_blocks_list.\1.transfer.net.1", False),
        (_PE + r"(pre|pos)(\d)\.res(\d)\.conv(\d)",
         r"point_encoder.\1_blocks_list.\2.operation.\3.net\4.0", True),
        (_PE + r"(pre|pos)(\d)\.res(\d)\.bn(\d)",
         r"point_encoder.\1_blocks_list.\2.operation.\3.net\4.1", False),
        (_PE + r"fc1", "point_encoder.classifier.0", False),
        (_PE + r"bn1", "point_encoder.classifier.1", False),
        (_PE + r"fc2", "point_encoder.classifier.4", False),
        (_PE + r"bn2", "point_encoder.classifier.5", False)),
    "pointnext": (
        (r"", "", False),
        (_PE + r"stem", "point_encoder.encoder.encoder.0.0.convs.0.0", True),
        (_PE + r"stage(\d)_(?:sa|global)\.conv(\d)\.conv",
         r"point_encoder.encoder.encoder.\1.0.convs.\2.0", True),
        (_PE + r"stage(\d)_(?:sa|global)\.conv(\d)\.bn",
         r"point_encoder.encoder.encoder.\1.0.convs.\2.1", False),
        (_PE + r"stage(\d)_sa\.skipconv", r"point_encoder.encoder.encoder.\1.0.skipconv.0", True),
        (_PE + r"head_fc0", "point_encoder.prediction.head.0.0", False),
        (_PE + r"head_bn0", "point_encoder.prediction.head.0.1", False),
        (_PE + r"head_fc1", "point_encoder.prediction.head.2.0", False),
        (_PE + r"head_bn1", "point_encoder.prediction.head.2.1", False)),
}
# the partseg trunk's heads (``point_encoder.py:260-420``): Conv1d propagations,
# Conv2d EdgeConv layers (2 trailing 1-wide axes) with their GroupNorms
REF_NAMES["pointbert_partseg"] = REF_NAMES["pointbert"] + (
    (_PE + r"propagation_(\d)\.conv(\d)", r"point_encoder.propagation_\1.mlp_convs.\2", True),
    (_PE + r"propagation_(\d)\.bn(\d)", r"point_encoder.propagation_\1.mlp_bns.\2", False),
    (_PE + r"dgcnn_pro_(\d)\.layer(\d)", r"point_encoder.dgcnn_pro_\1.layer\2.0", 2),
    (_PE + r"dgcnn_pro_(\d)\.gn(\d)", r"point_encoder.dgcnn_pro_\1.layer\2.1", False),
    (_PE + r"(conv1|bn1)", r"point_encoder.\1", False))
# (converter kind, the file the loader reads, the model whose seeded weights
# write it): SLIP's text tower from PPT-Base's, each point tower from its own
PRETRAINED_FILES = (("slip", "slip_text", "ULIP_PointBERT"),
                    ("pointbert", "pointbert", "ULIP_PointBERT"),
                    ("pointnet2_ssg", "pointnet2_ssg", "ULIP_PN_SSG"),
                    ("pointnet2_msg", "pointnet2_msg_1kpts", "ULIP_PN_MSG"),
                    ("pointnext", "pointnext", "ULIP_PN_NEXT"),
                    ("pointmlp", "pointmlp", "ULIP_PN_MLP"))


def in_file(kind, key):
    """Whether the port's state-dict ``key`` is a leaf of ``kind``'s file."""
    if kind == "slip":
        return key.startswith("text.") or key == "logit_scale"
    return key.startswith("point_encoder.") or key == "pc_projection"


def reference_state_dict(kind, sd):
    """The port's ``sd`` leaves of ``kind`` under the reference's names and
    layouts: Dense kernels transposed (a Conv's with its 1-wide axes),
    BatchNorms with their ``num_batches_tracked``."""
    rules = REF_NAMES["pointnet2" if kind.startswith("pointnet2") else kind]
    out = {}
    for key, t in sd.items():
        if not in_file(kind, key):
            continue
        mod, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        for pattern, template, conv in rules:
            m = re.fullmatch(pattern, mod)
            if m:
                name = m.expand(template)
                break
        else:
            raise KeyError(f"no reference name for {key} ({kind})")
        ref_leaf = "weight" if leaf == "kernel" else leaf
        ref = name + ref_leaf if name.endswith("_") else ".".join(filter(None, (name, ref_leaf)))
        if leaf == "kernel":
            t = t.t().contiguous()
            t = t[(...,) + (None,) * int(conv)]
        out[ref] = t.clone()
        if leaf == "running_mean":
            out[f"{name}.num_batches_tracked"] = torch.tensor(1000)
    return out


def pretrained_args(model, dtype="bfloat16", batch=MLP_BATCH, pretrained_dir=None, **kw):
    args = train_args(dtype, 0, batch, model=model, use_height=model == "ULIP_PN_NEXT", **kw)
    args.pretrained_dir = str(pretrained_dir or PRETRAINED_DIR)
    return args


def write_pretrained_files():
    """Seeded full-width weights (seed 11, every leaf drawn anew) as the
    reference's ``.pt`` files, each converted by ``python -m
    ppt_torch.tools.ckpt_convert`` in its own process (all at once) into
    ``PRETRAINED_DIR``. Returns each model's source state dict (CPU)."""
    shutil.rmtree(PRETRAINED_DIR, ignore_errors=True)
    (PRETRAINED_DIR / "src").mkdir(parents=True)
    sources, procs = {}, []
    t0 = time.perf_counter()
    for kind, fname, model in PRETRAINED_FILES:
        if model not in sources:
            m = build_model(model, pretrained_args(model, "float32"), device="cpu", seed=11).model
            gen = torch.Generator().manual_seed(len(sources) + 12)
            with torch.no_grad():
                for key, t in m.state_dict().items():  # BatchNorm and LayerNorm too
                    noise = 0.02 * torch.randn(t.shape, generator=gen)
                    t.copy_(t * (1 + noise.abs()) if key.endswith("running_var") else t + noise)
            sources[model] = {k: v.clone() for k, v in m.state_dict().items()}
        src = PRETRAINED_DIR / "src" / f"{fname}.pt"
        torch.save({"state_dict": reference_state_dict(kind, sources[model]),
                    "args": argparse.Namespace(model=model, seed=11)}, src)
        procs.append((fname, subprocess.Popen(
            [sys.executable, "-m", "ppt_torch.tools.ckpt_convert", "--src", str(src), "--kind",
             kind, "--out", str(PRETRAINED_DIR / f"{fname}.msgpack")],
            cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for fname, p in procs:
        out, _ = p.communicate(timeout=300)
        check(p.returncode == 0, f"ckpt_convert {fname} failed: {out[-2000:]}")
    shutil.rmtree(PRETRAINED_DIR / "src")
    sizes = {f: (PRETRAINED_DIR / f"{f}.msgpack").stat().st_size for _, f, _ in PRETRAINED_FILES}
    print(f"[pretrained] wrote and converted {len(procs)} full-width .pt files in "
          f"{time.perf_counter() - t0:.1f} s: MB "
          f"{json.dumps({k: round(v / 2**20, 1) for k, v in sizes.items()})}")
    return sources


@contextlib.contextmanager
def loaded_counts():
    """The loader's logged (collection, loaded, total) lines, in order."""
    seen = []

    class Grab(logging.Handler):
        def emit(self, record):
            if record.msg == LOADED_MSG:
                seen.append(tuple(record.args))

    lg = logging.getLogger("ppt_torch.train.checkpoint")
    handler, level = Grab(), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        yield seen
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)


def setup_loaded(model, dtype, sources, files):
    """``cls.setup`` of ``model`` with ``PRETRAINED_DIR``: every leaf but the
    prompt's loaded (the logged counts) and bit-equal to its source."""
    with loaded_counts() as counts:
        ctx = cls.setup(pretrained_args(model, dtype))
    sd = ctx["model"].state_dict()
    n_params = len(list(ctx["model"].parameters()))
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in sd)
    loaded = sum(c[1] for c in counts if c[0] == "params")
    check([c[0] for c in counts] == ["params", "batch_stats"] * len(files),
          f"{model}: the loader logged {counts} for {files}")
    check(loaded == n_params - 1 and sum(c[1] for c in counts if c[0] == "batch_stats")
          == n_stats, f"{model} {dtype}: loaded {counts}, the model has {n_params} params "
          f"(the prompt's stays) and {n_stats} statistics")
    n_equal = 0
    for kind, src_model in files:
        src = sources[src_model]
        for key, want in src.items():
            if in_file(kind, key):
                check(torch.equal(sd[key].cpu(), want), f"{model}: {key} differs from its source")
                n_equal += 1
    check(n_equal == len(sd) - 1, f"{model}: {n_equal} leaves checked of {len(sd)}")
    print(f"[pretrained] {model} {dtype}: loaded {json.dumps(counts)}; {n_equal} leaves "
          f"bit-equal to their .pt sources")
    return ctx, {"counts": counts, "bit_equal_leaves": n_equal}


def loaded_logits_vs_plain(tag, ctx, dtype, pc):
    embed_fn, step_fn = make_cached_text_eval(ctx["model"])
    text_embed = embed_fn(ctx["model"], ctx["prompts"])
    logits = step_fn(ctx["model"], {"pc": pc}, text_embed)
    with plain_path():
        want = step_fn(ctx["model"], {"pc": pc}, text_embed)
    torch.cuda.synchronize()
    check(torch.isfinite(logits).all() and logits.shape == want.shape, f"{tag} logits")
    diff = float((logits - want).abs().max() / want.std())
    top1 = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    ok = diff <= 1e-3 and top1 >= 0.95 if dtype == "float32" else diff <= 0.25 and top1 >= 0.8
    print(f"[pretrained] {tag} {dtype} logits vs plain path on the card, loaded weights: "
          f"max|diff|/std {diff:.3e}, top-1 agreement {top1:.3f}")
    check(ok, f"{tag} {dtype} logits disagree with the plain path")
    return {"diff_over_std": diff, "top1": top1}


def validate_counted(ctx, args):
    """One ``validate`` pass with the counts set to 0 just before it."""
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = cls.validate(ctx["model"], make_cached_text_eval(ctx["model"]), ctx["test_ds"],
                       ctx["prompts"], args, DEV)
    torch.cuda.synchronize()
    return dict(_build.LAUNCHES), time.perf_counter() - t0, val


def f32_validate(model, ctx):
    """The f32 ``validate`` pass of a loaded model: finite, its kernels
    launched."""
    launches, wall, val = validate_counted(ctx, pretrained_args(model, "float32"))
    check(math.isfinite(val["acc1"]) and launches.get("fps_batched", 0) > 0,
          f"{model} f32 validate: acc1 {val['acc1']}, launches {launches}")
    print(f"[pretrained] {model} f32 loaded: validate in {wall * 1e3:.1f} ms, acc1 "
          f"{val['acc1']:.2f}; launches {json.dumps(launches, sort_keys=True)}")
    return {"ms": wall * 1e3, "acc1": val["acc1"], "launches": launches}


def synthetic_modelnet40_phase4(args, split):
    """Phase 4's clouds, every 8th of them (309 over the 40 classes), to test
    on; phase 5's to train on."""
    if split == "train":
        return synthetic_modelnet40(args, split)
    ds = synthetic_modelnet40_eval(args, split)
    return ArrayDataset(ds.points[::8], ds.labels[::8], ds.classnames, name=ds.name)


def run_pretrained_slice(smi):
    saved_loader = pdata.DATASETS["modelnet40"]
    pdata.DATASETS["modelnet40"] = synthetic_modelnet40_phase4
    try:
        return _run_pretrained_slice(smi)
    finally:
        pdata.DATASETS["modelnet40"] = saved_loader
        shutil.rmtree(PRETRAINED_DIR, ignore_errors=True)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _run_pretrained_slice(smi):
    t_phase = time.perf_counter()
    out = {}
    sources = write_pretrained_files()

    # --- PPT-Base with the converted PointBERT and SLIP ----------------------
    base_files = (("pointbert", "ULIP_PointBERT"), ("slip", "ULIP_PointBERT"))
    ctx, out["ppt_base_load"] = setup_loaded("ULIP_PointBERT", "bfloat16", sources, base_files)
    pc = torch.from_numpy(ctx["test_ds"].points[:MLP_BATCH]).to(DEV)
    launches, wall, val = validate_counted(ctx, pretrained_args("ULIP_PointBERT"))
    n_batches = math.ceil(len(ctx["test_ds"]) / MLP_BATCH)
    b = cls.device_batch(next(iter(Loader(ctx["train_ds"], MLP_BATCH, shuffle=True, seed=3))),
                         DEV)
    _build.reset_launches()
    make_train_step(smoothing=0.2)(ctx["state"], b, ctx["prompts"])
    torch.cuda.synchronize()
    train_launches = dict(_build.LAUNCHES)
    six = ("fps_batched", "knn_gather", "mini_forward", "mini_stats", "fused_vit_block",
           "fused_vit_block_readout")
    counted = {k: launches.get(k, 0) for k in six if k != "mini_stats"}
    counted["mini_stats"] = train_launches.get("mini_stats", 0)
    print(f"[pretrained] ULIP_PointBERT bf16 loaded: validate over {len(ctx['test_ds'])} clouds "
          f"({n_batches} batches) in {wall * 1e3:.1f} ms, acc1 {val['acc1']:.2f}; launches in the "
          f"pass {json.dumps(counted)} (mini_stats in one train step)")
    check(all(v > 0 for v in counted.values()), f"a PPT-Base kernel never ran: {counted}")
    out["ppt_base_launches"] = counted
    out["ppt_base_logits"] = {"bfloat16": loaded_logits_vs_plain("ULIP_PointBERT", ctx,
                                                                 "bfloat16", pc)}
    del ctx
    ctx32, _ = setup_loaded("ULIP_PointBERT", "float32", sources, base_files)
    out["ppt_base_f32_validate"] = f32_validate("ULIP_PointBERT", ctx32)
    out["ppt_base_logits"]["float32"] = loaded_logits_vs_plain("ULIP_PointBERT", ctx32,
                                                               "float32", pc)
    del ctx32

    # --- the other converted towers load bit for bit ---------------------------
    for kind, fname, model in PRETRAINED_FILES[2:5]:
        c, out[f"{model}_load"] = setup_loaded(model, "bfloat16", sources,
                                               ((kind, model), ("slip", "ULIP_PointBERT")))
        del c

    # --- ULIP_PN_MLP at full width with its converted weights -------------------
    mlp_files = (("pointmlp", "ULIP_PN_MLP"), ("slip", "ULIP_PointBERT"))
    args = pretrained_args("ULIP_PN_MLP")
    ctx, out["pn_mlp_load"] = setup_loaded("ULIP_PN_MLP", "bfloat16", sources, mlp_files)
    tower = ctx["model"].point_encoder
    check(tower.config.points == 1024 and tower.config.embed_dim == 64
          and tower.fc1.kernel.shape == (1024, 512), "PointMLP at full width")
    n_tower = sum(p.numel() for p in tower.parameters())
    validate_counted(ctx, args)  # warm-up
    launches, wall, val = validate_counted(ctx, args)
    n_batches = math.ceil(len(ctx["test_ds"]) / MLP_BATCH)
    print(f"[pretrained] ULIP_PN_MLP bf16 loaded: point tower {n_tower / 1e6:.2f} M parameters; "
          f"validate over {len(ctx['test_ds'])} clouds x {args.npoints} points ({n_batches} "
          f"batches of {MLP_BATCH}) in {wall * 1e3:.1f} ms, acc1 {val['acc1']:.2f}; launches "
          f"{json.dumps(launches, sort_keys=True)}")
    check(launches.get("fps_batched", 0) == 4 * n_batches,
          f"ULIP_PN_MLP launched fps_batched {launches.get('fps_batched')} times in "
          f"{n_batches} batches, not 4 a batch")
    out["pn_mlp_validate"] = {"clouds": len(ctx["test_ds"]), "batches": n_batches,
                              "ms": wall * 1e3, "launches": launches,
                              "fps_batched_per_batch": launches.get("fps_batched", 0) / n_batches}
    out["pn_mlp_logits"] = {"bfloat16": loaded_logits_vs_plain("ULIP_PN_MLP", ctx, "bfloat16",
                                                               pc)}

    # MLP_STEPS timed head-type-0 train steps, then their device time under the profiler
    state = ctx["state"]
    check(sorted(state.trainable) == ["prompt_learner.learnable_tokens"], "PN_MLP partition")
    frozen0 = snapshot({k: p for k, p in ctx["model"].named_parameters()
                        if k not in state.trainable})
    step_fn = make_train_step(smoothing=0.2)
    stream = batch_stream(Loader(ctx["train_ds"], MLP_BATCH, shuffle=True, drop_last=True,
                                 seed=0))
    run_steps(ctx, step_fn, stream, 1)  # warm-up
    t0 = time.perf_counter()
    losses = run_steps(ctx, step_fn, stream, MLP_STEPS)
    wall = time.perf_counter() - t0
    rate = MLP_STEPS * MLP_BATCH / wall

    def one_step():
        run_steps(ctx, step_fn, stream, 1)

    prof = tprofile._profile(one_step, MLP_PROFILED)
    check(all(math.isfinite(x) for x in losses), f"PN_MLP train losses {losses}")
    check(all(torch.equal(p, frozen0[k]) for k, p in ctx["model"].named_parameters()
              if k in frozen0), "a frozen PointMLP leaf moved")
    out["pn_mlp_train"] = {
        "steps": MLP_STEPS, "batch": MLP_BATCH, "clouds_per_sec": rate,
        "wall_ms_per_batch": wall / MLP_STEPS * 1e3,
        "busy_ms_per_batch": prof["device_busy_ms_per_batch"],
        # the profiler slows the host, not the card: idle against the plain wall
        "idle_share": 1.0 - prof["device_busy_ms_per_batch"] / (wall / MLP_STEPS * 1e3),
        "profiled_wall_ms_per_batch": prof["wall_ms_per_batch"],
        "profiled_idle_share": prof["device_idle_share"],
        "loss_first_last": [losses[0], losses[-1]], "card": smi}
    print(f"[pretrained] ULIP_PN_MLP bf16 head_type 0, {MLP_STEPS} steps of {MLP_BATCH}: "
          f"{rate:.1f} clouds/sec, wall {wall / MLP_STEPS * 1e3:.3f} ms a batch, busy "
          f"{prof['device_busy_ms_per_batch']:.3f} ms (profiled), idle "
          f"{out['pn_mlp_train']['idle_share']:.3f}; the profiled window: wall "
          f"{prof['wall_ms_per_batch']:.3f} ms, idle {prof['device_idle_share']:.3f}; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {smi}")
    del ctx, state, frozen0, stream
    ctx32, _ = setup_loaded("ULIP_PN_MLP", "float32", sources, mlp_files)
    out["pn_mlp_f32_validate"] = f32_validate("ULIP_PN_MLP", ctx32)
    out["pn_mlp_logits"]["float32"] = loaded_logits_vs_plain("ULIP_PN_MLP", ctx32, "float32",
                                                             pc)
    del ctx32

    out["pn_mlp_fps"] = fps_shape_rows(
        MLP_BATCH, [(N, npoint, "PointMLP") for N, npoint in MLP_FPS_SHAPES], "pretrained", 1)

    # --- the miss path: an existing directory without converted files ------------
    empty = PRETRAINED_DIR / "empty"
    empty.mkdir()
    miss_args = pretrained_args("ULIP_PN_MLP", pretrained_dir=empty)
    want = build_model("ULIP_PN_MLP", miss_args, device=DEV).model.state_dict()

    class Grab(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    seen, lg = [], logging.getLogger("ppt_torch.tasks.cls")
    handler = Grab(level=logging.WARNING)
    lg.addHandler(handler)
    try:
        got = cls.setup(miss_args)["model"].state_dict()
    finally:
        lg.removeHandler(handler)
    check(any(f"pretrained checkpoints not found under {empty}; random init" in m
              for m in seen), f"the miss path did not warn: {seen}")
    check(all(torch.equal(got[k], want[k]) for k in want), "the miss path moved the init")
    out["miss_path"] = {"warned": True, "init_kept": True}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[pretrained] phase 14 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: part segmentation at full width
# ---------------------------------------------------------------------------

PARTSEG_DIR = _build.BUILD_DIR.parent / "chip_smoke_partseg"
PARTSEG_BATCH = 32
PARTSEG_STEPS = 5  # the timed window
PARTSEG_PROFILED = 3  # the profiled window
PARTSEG_NPOINTS = 2048  # configs/datasets/shapenetpart.yaml
PARTSEG_PER_CATEGORY = 20  # 16 categories x 20 = 320 synthetic part clouds a split
# each kernel's launches a batch on the block route (validate); mini_stats a train step
PARTSEG_PER_BATCH = {"fps_batched": 3, "knn_gather": 1, "mini_forward": 1,
                     "fused_vit_block": 12, "fused_vit_block_readout": 0}
PARTSEG_RECIPE = Path(__file__).resolve().parent / "configs" / "experiments" / \
    "partseg_shapenetpart.yaml"
# The segmentation heads' gradients (and block_11's, which come back through
# them) are conditioned far worse than the prompt's: in the port alone,
# multiplying the taps by 1 + 1e-7 noise moves them by up to 0.9% of a leaf's
# scale and by 1.3e-3 all together (3.2e-3 at 1e-6), the prompt's by 1.2e-6
# (measured on the CPU at the 48-wide test trunk, B=2 x 2048 points; each
# train-mode BatchNorm and GroupNorm subtracts its batch mean from a nearly
# common gradient). An f32 step is held to the plain path by the prompt's
# gradient at phase 5's limit and the other leaves' distance all together.
TOL_PARTSEG_GRAD_DIST = 2e-2


def partseg_args(dtype="bfloat16", head_type=0, batch=PARTSEG_BATCH, **kw):
    """ShapeNetPart's task at full width (PointBertConfig(), SLIP's 12 x 512
    text tower, 50 part prompts of 32 learnable tokens, N=2048); the data
    path holds no files, so the clouds are synthetic with part labels."""
    args = TaskArgs(model="ULIP_PointBERT_partseg", dataset_name="shapenetpart",
                    data_path=str(PARTSEG_DIR / "no_files"), npoints=PARTSEG_NPOINTS,
                    batch_size=batch, num_learnable_prompt_tokens=32,
                    class_name_position="middle", compute_dtype=dtype, head_type=head_type,
                    lr=1e-3, epochs=250, seed=0, device="cuda", pretrained_dir="",
                    output_dir=str(PARTSEG_DIR), **kw)
    args.num_classes, args.samples_per_class = 16, PARTSEG_PER_CATEGORY
    return args


def partseg_setup(args, route="block"):
    with switches(POINT_SWITCHES[route]):
        ctx = partseg.setup(args)
    check(ctx["model"].point_encoder.route == route, f"partseg setup did not take route {route}")
    return ctx


def partseg_batch(ds, seed=3):
    batch = next(iter(Loader(ds, PARTSEG_BATCH, shuffle=True, seed=seed)))
    b = partseg.device_batch(batch, DEV)
    b["category"] = torch.from_numpy(batch["category"].astype(np.int64)).to(DEV)
    return b


def partseg_validate_counted(ctx, args):
    """One ``partseg.validate`` pass, the counts set to 0 just before it."""
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = partseg.validate(ctx["state"], make_eval_step(partseg=True), ctx["test_ds"],
                           ctx["prompts"], args, DEV)
    torch.cuda.synchronize()
    return dict(_build.LAUNCHES), time.perf_counter() - t0, val


def partseg_logits_vs_plain(tag, ctx, dtype, b):
    """One batch's [B, N, 50] logits through the kernels and through their
    plain versions on the card, at phase 4's limits (per point); the refined
    predictions' agreement and both batches' mIoU beside them."""
    eval_fn = make_eval_step(partseg=True)
    logits = eval_fn(ctx["state"], b, ctx["prompts"])
    with plain_path():
        want = eval_fn(ctx["state"], b, ctx["prompts"])
    torch.cuda.synchronize()
    check(torch.isfinite(logits).all() and logits.shape == (PARTSEG_BATCH, PARTSEG_NPOINTS, 50),
          f"{tag} partseg logits {tuple(logits.shape)}")
    diff = float((logits - want).abs().max() / want.std())
    top1 = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    ranges = torch.from_numpy(pdata.SHAPENETPART_PART_RANGES).to(DEV)
    pred = refine_partseg_logits(logits, b["category"], ranges)
    pred_p = refine_partseg_logits(want, b["category"], ranges)
    agree = float((pred == pred_p).float().mean())
    miou = float(partseg_ious(pred, b["label"], b["category"], ranges, 16)["instance_miou"])
    miou_p = float(partseg_ious(pred_p, b["label"], b["category"], ranges, 16)["instance_miou"])
    ok = (diff <= 1e-3 and top1 >= 0.95 and agree >= 0.95 if dtype == "float32"
          else diff <= 0.25 and top1 >= 0.8 and agree >= 0.8)
    print(f"[partseg] {tag} {dtype} logits vs plain path on the card: max|diff|/std {diff:.3e}, "
          f"top-1 agreement {top1:.4f}, refined predictions agree {agree:.4f}, instance mIoU "
          f"{miou:.3f} vs {miou_p:.3f} (random weights)")
    check(ok, f"{tag} {dtype} partseg logits disagree with the plain path")
    return {"diff_over_std": diff, "top1": top1, "refined_agree": agree,
            "instance_miou": miou, "plain_instance_miou": miou_p}


def partseg_quantities(ctx, b, seed, smoothing):
    """``step_quantities`` of the partseg loss (flattened label-smoothed CE,
    the tower in training mode, dropout and DropPath from the seeded
    generator)."""
    state, model = ctx["state"], ctx["model"]
    return step_quantities(state, seed, lambda: smoothed_cross_entropy(
        model(b["pc"], ctx["prompts"], train=True, generator=state.generator,
              cls_onehot=b["cls_onehot"]).reshape(-1, 50), b["label"].reshape(-1), smoothing))


def partseg_step_vs_plain(dtype, head_type, f32_grads=None):
    """One step's loss, gradients and BatchNorm buffers through the kernels
    and through their plain versions on the card. f32: loss, buffers and the
    prompt's gradient at phase 5's limits, the other leaves by their distance
    all together (TOL_PARTSEG_GRAD_DIST); bf16: loss and buffers at phase 5's
    limits, the gradients' distance from the f32 step's no more than twice
    the plain path's plus 1e-2, as phase 9's bf16 pretraining step."""
    tol_loss, tol_grad, tol_stats = TOL_STEP[dtype]
    args = partseg_args(dtype, head_type)
    ctx = partseg_setup(args)
    b = partseg_batch(ctx["train_ds"])
    loss, grads, stats = partseg_quantities(ctx, b, 11, args.label_smoothing)
    with plain_path():
        loss_p, grads_p, stats_p = partseg_quantities(ctx, b, 11, args.label_smoothing)
    tag = f"ULIP_PointBERT_partseg {dtype} head_type {head_type}"
    d_loss = abs(loss - loss_p) / abs(loss_p)
    d_stats = max(rel_err(stats[k], stats_p[k]) for k in stats)
    prompt = "prompt_learner.learnable_tokens"
    d_prompt = rel_err(grads[prompt], grads_p[prompt])
    rest = [k for k in grads if k != prompt]
    out = {"loss_rel": d_loss, "stats_rel": d_stats, "prompt_grad_rel": d_prompt,
           "leaves": len(grads)}
    check(math.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
          f"non-finite loss or gradient ({tag})")
    check(all(float(g.abs().max()) > 0 for g in grads.values()), f"a zero gradient ({tag})")
    check(d_loss <= tol_loss, f"loss disagrees with the plain path ({tag})")
    check(d_stats <= tol_stats, f"BN buffers disagree with the plain path ({tag})")
    if head_type:
        check(any("block_11" in k for k in grads), "head_type 3 trains no block_11 leaf")
    if dtype == "float32":
        dist = grad_dist({k: grads[k] for k in rest}, {k: grads_p[k] for k in rest})
        out["grad_dist"] = dist
        print(f"[partseg] {tag}: one step vs plain path on the card: loss {loss:.6f} vs "
              f"{loss_p:.6f} (rel {d_loss:.3e}, tol {tol_loss}); prompt gradient max rel "
              f"{d_prompt:.3e} (tol {tol_grad}); the other {len(rest)} leaves' distance "
              f"{dist:.3e} (tol {TOL_PARTSEG_GRAD_DIST}); BN buffers max rel {d_stats:.3e} "
              f"(tol {tol_stats})")
        check(d_prompt <= tol_grad, f"the prompt's gradient disagrees with the plain path ({tag})")
        check(dist <= TOL_PARTSEG_GRAD_DIST, f"gradients disagree with the plain path ({tag})")
        return out, grads
    e_k, e_p = grad_dist(grads, f32_grads), grad_dist(grads_p, f32_grads)
    out.update(grad_dist_from_f32=e_k, plain_grad_dist_from_f32=e_p)
    print(f"[partseg] {tag}: one step vs plain path on the card: loss {loss:.6f} vs "
          f"{loss_p:.6f} (rel {d_loss:.3e}, tol {tol_loss}); gradients' distance from the f32 "
          f"step {e_k:.3e} (kernels) vs {e_p:.3e} (plain), tol {BF16_PRETRAIN_FACTOR} x plain + "
          f"{BF16_PRETRAIN_SLACK}; prompt gradient max rel {d_prompt:.3e} (not checked); BN "
          f"buffers max rel {d_stats:.3e} (tol {tol_stats})")
    check(e_k <= BF16_PRETRAIN_FACTOR * e_p + BF16_PRETRAIN_SLACK,
          f"the kernels' bf16 gradients are farther from the f32 step than the plain path's "
          f"({tag})")
    return out, grads


def partseg_run_steps(ctx, step_fn, stream, n):
    """``n`` steps as ``partseg.train_loop`` takes them (translated clouds,
    the loss read on the host after each)."""
    losses = []
    for _ in range(n):
        b = partseg.device_batch(next(stream), DEV)
        b["pc"] = translate_pointcloud(ctx["state"].generator, b["pc"])
        ctx["state"], metrics = step_fn(ctx["state"], b, ctx["prompts"])
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    return losses


def run_partseg_slice(smi):
    try:
        return _run_partseg_slice(smi)
    finally:
        shutil.rmtree(PARTSEG_DIR, ignore_errors=True)


def _run_partseg_slice(smi):
    t_phase = time.perf_counter()
    out = {"card": smi}

    # --- serving: validate on the block route ------------------------------------
    args = partseg_args()
    ctx = partseg_setup(args)
    tower = ctx["model"].point_encoder
    check(tower.config == npb.PointBertConfig() and ctx["model"].text.config == ntext.TextConfig()
          and ctx["prompts"].perm_tokens.shape[0] == 50, "partseg at full width")
    n_params = sum(p.numel() for p in ctx["model"].parameters())
    n_batches = math.ceil(len(ctx["test_ds"]) / PARTSEG_BATCH)
    partseg_validate_counted(ctx, args)  # warm-up
    launches, wall, val = partseg_validate_counted(ctx, args)
    per_batch = {k: launches.get(k, 0) / n_batches for k in PARTSEG_PER_BATCH}
    print(f"[partseg] ULIP_PointBERT_partseg bf16: {n_params / 1e6:.1f} M parameters; validate "
          f"over {len(ctx['test_ds'])} clouds x {PARTSEG_NPOINTS} points ({n_batches} batches of "
          f"{PARTSEG_BATCH}): one pass after a warm-up {wall * 1e3:.1f} ms, "
          f"{len(ctx['test_ds']) / wall:.1f} clouds/sec; instance mIoU {val['instance_miou']:.3f}, "
          f"category mIoU {val['category_miou']:.3f} (random weights); launches a batch "
          f"{json.dumps(per_batch)}; {smi}")
    check(per_batch == {k: float(v) for k, v in PARTSEG_PER_BATCH.items()},
          f"partseg launches a batch {per_batch}, not {PARTSEG_PER_BATCH}")
    check(math.isfinite(val["instance_miou"]) and math.isfinite(val["category_miou"]),
          f"partseg validate metrics {val}")
    out["validate"] = {"clouds": len(ctx["test_ds"]), "batches": n_batches,
                       "ms": wall * 1e3, "clouds_per_sec": len(ctx["test_ds"]) / wall,
                       "launches_per_batch": per_batch,
                       "instance_miou": val["instance_miou"], "category_miou": val["category_miou"]}
    fixed = partseg_batch(ctx["test_ds"])
    out["logits"] = {"bfloat16": partseg_logits_vs_plain("block route", ctx, "bfloat16", fixed)}
    block_logits = make_eval_step(partseg=True)(ctx["state"], fixed, ctx["prompts"])
    vprof = tprofile._profile(lambda: make_eval_step(partseg=True)(ctx["state"], fixed,
                                                                   ctx["prompts"]), 3)
    out["validate"]["profiled_batch"] = {
        k: vprof[k] for k in ("wall_ms_per_batch", "device_busy_ms_per_batch",
                              "device_idle_share", "device_ms_per_batch",
                              "top_other_kernels_ms_per_batch")}
    print(f"[partseg] one eval batch profiled (3 calls, the text tower in each): busy "
          f"{vprof['device_busy_ms_per_batch']:.3f} ms, wall {vprof['wall_ms_per_batch']:.3f} ms, "
          f"idle {vprof['device_idle_share']:.3f}; ms by part "
          + json.dumps({k: round(v, 3) for k, v in vprof["device_ms_per_batch"].items()}))

    # --- training: a train step's launches, a timed window, a fixed batch ----------
    state = ctx["state"]
    frozen0 = snapshot({k: p for k, p in ctx["model"].named_parameters()
                        if k not in state.trainable})
    step_fn = make_train_step(smoothing=args.label_smoothing, partseg=True)
    b = partseg_batch(ctx["train_ds"])
    _build.reset_launches()
    ctx["state"], _ = step_fn(ctx["state"], b, ctx["prompts"])
    torch.cuda.synchronize()
    step_launches = {k: _build.LAUNCHES.get(k, 0) for k in
                     tuple(PARTSEG_PER_BATCH) + ("mini_stats",)}
    print(f"[partseg] one bf16 head_type 0 train step launched {json.dumps(step_launches)}")
    check(step_launches == {**PARTSEG_PER_BATCH, "mini_stats": 1},
          f"a partseg train step launched {step_launches}")
    out["train_step_launches"] = step_launches
    stream = batch_stream(Loader(ctx["train_ds"], PARTSEG_BATCH, shuffle=True, drop_last=True,
                                 seed=0))
    partseg_run_steps(ctx, step_fn, stream, 1)  # warm-up
    t0 = time.perf_counter()
    losses = partseg_run_steps(ctx, step_fn, stream, PARTSEG_STEPS)
    wall = time.perf_counter() - t0
    prof = tprofile._profile(lambda: partseg_run_steps(ctx, step_fn, stream, 1),
                             PARTSEG_PROFILED)
    check(all(math.isfinite(x) for x in losses), f"partseg train losses {losses}")
    check(all(torch.equal(p, frozen0[k]) for k, p in ctx["model"].named_parameters()
              if k in frozen0), "a frozen leaf of the partseg model moved")
    out["train"] = {
        "steps": PARTSEG_STEPS, "batch": PARTSEG_BATCH,
        "clouds_per_sec": PARTSEG_STEPS * PARTSEG_BATCH / wall,
        "wall_ms_per_batch": wall / PARTSEG_STEPS * 1e3,
        "busy_ms_per_batch": prof["device_busy_ms_per_batch"],
        "idle_share": 1.0 - prof["device_busy_ms_per_batch"] / (wall / PARTSEG_STEPS * 1e3),
        "profiled_wall_ms_per_batch": prof["wall_ms_per_batch"],
        "profiled_idle_share": prof["device_idle_share"],
        "device_ms_per_batch": prof["device_ms_per_batch"],
        "top_other_kernels_ms_per_batch": prof["top_other_kernels_ms_per_batch"],
        "trainable_leaves": len(state.trainable), "loss_first_last": [losses[0], losses[-1]]}
    print(f"[partseg] bf16 head_type 0, {PARTSEG_STEPS} steps of {PARTSEG_BATCH} x "
          f"{PARTSEG_NPOINTS}: {out['train']['clouds_per_sec']:.1f} clouds/sec, wall "
          f"{wall / PARTSEG_STEPS * 1e3:.3f} ms a "
          f"batch, busy {prof['device_busy_ms_per_batch']:.3f} ms (profiled), idle "
          f"{out['train']['idle_share']:.3f}; the profiled window: wall "
          f"{prof['wall_ms_per_batch']:.3f} ms, idle {prof['device_idle_share']:.3f}; "
          f"{len(state.trainable)} trainable leaves, the frozen ones bit-unchanged; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {smi}; ms by part "
          + json.dumps({k: round(v, 3) for k, v in prof["device_ms_per_batch"].items()}))
    del ctx, state, frozen0, stream

    fargs = partseg_args()
    fargs.pointbert_config = npb.PointBertConfig(drop_path_rate=0.0)
    fctx = partseg_setup(fargs)
    fb = partseg_batch(fctx["train_ds"])
    flosses = []
    for _ in range(12):
        fctx["state"], m = step_fn(fctx["state"], fb, fctx["prompts"])
        flosses.append(m["loss"])
    flosses = [float(x) for x in flosses]
    print(f"[partseg] fixed batch, 12 steps (warmup schedule), augmentation and DropPath off, "
          f"dropout on: loss {flosses[0]:.4f} -> {flosses[-1]:.4f} (lowest {min(flosses):.4f})")
    check(all(math.isfinite(x) for x in flosses)
          and sum(flosses[-3:]) < sum(flosses[:3]), "the partseg loss did not fall")
    out["fixed_batch_losses"] = flosses
    del fctx

    # --- one step against the plain path, head types 0 and 3 ------------------------
    out["step_vs_plain"] = {}
    for head_type in (0, 3):
        q32, g32 = partseg_step_vs_plain("float32", head_type)
        q16, _ = partseg_step_vs_plain("bfloat16", head_type, g32)
        out["step_vs_plain"][f"head_type_{head_type}"] = {"float32": q32, "bfloat16": q16}
        del g32

    # --- the other routes against the block route ----------------------------------
    routes = {}
    for route in ("tower", "unfused", "plain"):
        rctx = partseg_setup(partseg_args(), route)
        _build.reset_launches()
        logits = make_eval_step(partseg=True)(rctx["state"], fixed, rctx["prompts"])
        torch.cuda.synchronize()
        counted = {k: _build.LAUNCHES.get(k, 0) for k in ("fused_vit_block", "fused_mha",
                                                          "fused_vit_tower", "flash_mha")}
        diff = float((logits - block_logits).abs().max() / block_logits.std())
        top1 = float((logits.argmax(-1) == block_logits.argmax(-1)).float().mean())
        routes[route] = {"diff_over_std": diff, "top1": top1, "launches": counted,
                         "identical": bool(torch.equal(logits, block_logits))}
        print(f"[partseg] route {route} bf16 vs the block route: max|diff|/std {diff:.3e}, "
              f"top-1 agreement {top1:.4f}, identical {routes[route]['identical']}; trunk "
              f"launches in one batch {json.dumps(counted)}")
        want = {"tower": {"fused_vit_block": 12}, "unfused": {"fused_mha": 12},
                "plain": {}}[route]
        check({k: v for k, v in counted.items() if v} == want,
              f"route {route} launched {counted}, not {want}")
        if route == "tower":  # the reference's partseg trunk never reads the tower switch
            check(routes[route]["identical"], "the tower route's logits differ from the block's")
        else:  # two bf16 paths, each within phase 4's 0.25 of a plain path: 0.5 apart at most
            check(diff <= 0.5 and top1 >= 0.8, f"route {route} disagrees with the block route")
        del rctx
    out["routes"] = routes
    ctx32 = partseg_setup(partseg_args("float32"))
    out["logits"]["float32"] = partseg_logits_vs_plain("block route", ctx32, "float32", fixed)
    del ctx32

    out["recipe"] = run_partseg_recipe()
    out["pretrained"] = run_partseg_pretrained()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[partseg] phase 15 took {out['seconds']:.1f} s")
    return out


def run_partseg_recipe():
    """The published recipe through the port's CLI for one epoch (its
    synthetic fallback: 128 part clouds, batch 90, f32), the mIoU read from
    its log, then ``--evaluate_3d`` reading its best checkpoint back."""
    out_dir = PARTSEG_DIR / "recipe"
    argv = ["--config", str(PARTSEG_RECIPE), "--set", "epochs=1", "--output_dir", str(out_dir)]
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "ppt_torch.tasks.partseg", *argv],
                       cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    log_text = p.stdout + p.stderr
    check(p.returncode == 0, f"the partseg recipe failed: {log_text[-3000:]}")
    m = re.search(r"epoch 0: (\{.*\})", log_text)
    check(m is not None and "instance_miou" in m.group(1), f"no mIoU in the log: {log_text[-2000:]}")
    entry = m.group(1)
    meta = json.loads((out_dir / "partseg" / "checkpoint_best.json").read_text())
    ev = partseg.main(argv + ["--evaluate_3d", "--test_ckpt_addr", str(out_dir / "partseg")])
    keys = ("instance_miou", "category_miou", "accuracy")
    identical = all(ev["best"][k] == meta[k] for k in keys)
    print(f"[partseg] recipe {PARTSEG_RECIPE.name} --set epochs=1: {wall:.1f} s in its own "
          f"process; {entry}; --evaluate_3d from its checkpoint: {json.dumps(ev['best'])} "
          f"(identical to the run's: {identical})")
    check(all(abs(ev["best"][k] - meta[k]) <= 1e-3 for k in keys),
          f"the checkpoint read back gives {ev['best']}, the run logged {meta}")
    return {"seconds": wall, "best": meta, "evaluate_3d": ev["best"], "identical": identical}


def run_partseg_pretrained():
    """A seeded full-width partseg model written as a reference-named .pt and
    converted with ``--kind pointbert_partseg``, and a cls PointBERT's
    ``pointbert.pt`` with ``--kind pointbert``, in two processes; each file
    as ``pointbert.msgpack`` read by ``partseg.setup``: every leaf of the
    partseg file bit-equal, the cls file's trunk leaves bit-equal and the
    heads at their seeded init."""
    t0 = time.perf_counter()
    dirs, sources, procs = {}, {}, []
    for kind, model in (("pointbert_partseg", "ULIP_PointBERT_partseg"),
                        ("pointbert", "ULIP_PointBERT")):
        d = PARTSEG_DIR / f"pretrained_{kind}"
        d.mkdir(parents=True)
        m = build_model(model, partseg_args("float32"), device="cpu", seed=11).model
        gen = torch.Generator().manual_seed(13)
        with torch.no_grad():
            for key, t in m.state_dict().items():
                noise = 0.02 * torch.randn(t.shape, generator=gen)
                t.copy_(t * (1 + noise.abs()) if key.endswith("running_var") else t + noise)
        sources[kind] = {k: v.clone() for k, v in m.state_dict().items()}
        src = d / "src.pt"
        torch.save({"state_dict": reference_state_dict(kind, sources[kind]),
                    "args": argparse.Namespace(model=model, seed=11)}, src)
        procs.append((kind, subprocess.Popen(
            [sys.executable, "-m", "ppt_torch.tools.ckpt_convert", "--src", str(src), "--kind",
             kind, "--out", str(d / "pointbert.msgpack")],
            cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
        dirs[kind] = d
    for kind, p in procs:
        text, _ = p.communicate(timeout=300)
        check(p.returncode == 0, f"ckpt_convert {kind} failed: {text[-2000:]}")
    seeded = build_model("ULIP_PointBERT_partseg", partseg_args(), device="cpu").model.state_dict()
    out = {}
    for kind, d in dirs.items():
        args = partseg_args()
        args.pretrained_dir = str(d)
        with loaded_counts() as counts:
            sd = partseg_setup(args)["model"].state_dict()
        src = sources[kind]
        n_equal = n_init = 0
        for key, t in sd.items():
            if not in_file("pointbert", key):
                continue
            if kind == "pointbert_partseg" or (key in src and key != "pc_projection"):
                check(torch.equal(t.cpu(), src[key]), f"{kind}: {key} differs from its source")
                n_equal += 1
            else:  # a head leaf, or the 768-row projection: the seeded init stays
                check(torch.equal(t.cpu(), seeded[key]), f"{kind}: {key} left its init")
                n_init += 1
        print(f"[partseg] {kind} file into the partseg model: loaded {json.dumps(counts)}; "
              f"{n_equal} leaves bit-equal to their .pt source, {n_init} at their seeded init")
        check(n_equal > 0 and (n_init == 0) == (kind == "pointbert_partseg"),
              f"{kind}: {n_equal} leaves loaded, {n_init} kept")
        out[kind] = {"counts": counts, "bit_equal_leaves": n_equal, "init_leaves": n_init}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 16: the linear probe at full width
# ---------------------------------------------------------------------------

PROBE_DIR = _build.BUILD_DIR.parent / "chip_smoke_probe"
PROBE_BATCH = 32
MN40_TRAIN_CLOUDS = 9843  # ModelNet40's train split
# each kernel's launches a batch of frozen-feature extraction (block route)
PROBE_PER_BATCH = {"fps_batched": 1, "knn_gather": 1, "mini_forward": 1, "fused_vit_block": 11,
                   "fused_vit_block_readout": 1}
PROBE_SHOTS = (1, 2, 4, 8, 16)
PROBE_RUNS = 1  # one run a shot holds the card's fit to the CPU's
PROBE_MEAN_TOL = 0.5  # points: each shot's mean on the card against the CPU's
PROBE_W_TOL = 1e-2  # one fit's weights, card against CPU: two f32 L-BFGS paths to one minimum
VOCAB, N_CTX_PROBE = 49408, 32  # CLIP's token table, PPT-Base's context vectors
TIE_REL = 1e-6  # two squared distances this close (relative) may swap places


def synthetic_modelnet40_probe():
    """ModelNet40-sized synthetic splits over its 40 names (9843 clouds to
    train on, 2468 to test), made once; the loader then returns them."""
    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    splits = {}
    for split, n, seed in (("train", MN40_TRAIN_CLOUDS, 0), ("test", MN40_TEST_CLOUDS, 1)):
        ds = make_synthetic(num_classes=40, samples_per_class=-(-n // 40), npoints=1024,
                            seed=seed, classnames=names)
        splits[split] = ArrayDataset(ds.points[:n], ds.labels[:n], ds.classnames,
                                     name="modelnet40_synthetic_clouds")
    return lambda args, split: splits[split]


def probe_args(dtype="bfloat16", **kw):
    return TaskArgs(dataset_name="modelnet40", npoints=1024, batch_size=PROBE_BATCH,
                    num_learnable_prompt_tokens=32, class_name_position="middle",
                    compute_dtype=dtype, seed=0, device="cuda", pretrained_dir="",
                    output_dir=str(PROBE_DIR), **kw)


def probe_features_vs_plain(pc, model):
    """One batch's features through the kernels and through their plain
    versions on the card, same weights: ``model`` (bf16) and its f32 twin."""
    out = {}
    f32 = build_model("ULIP_PointBERT", probe_args("float32"), device=DEV).model
    for dtype, tol, m in (("float32", 1e-3, f32), ("bfloat16", 0.25, model)):
        with torch.no_grad():
            got = m.point_encoder(pc, train=False).float()
            with plain_path():
                want = m.point_encoder(pc, train=False).float()
        torch.cuda.synchronize()
        check(got.shape == (PROBE_BATCH, 768) and torch.isfinite(got).all(), "probe features")
        diff = float((got - want).abs().max() / want.std())
        print(f"[probe] features vs plain path on the card ({dtype}, B={PROBE_BATCH}): "
              f"max|diff|/std {diff:.3e} (limit {tol})")
        check(diff <= tol, f"{dtype} features disagree with the plain path")
        out[dtype] = diff
    return out


def probe_logits_vs_validate(recog, model, prompts, test_ds):
    """save_recog_feats' logits against ``cls.validate``'s eval step
    (``make_cached_text_eval``) on the same seeded state: bit-equal."""
    embed_fn, step_fn = make_cached_text_eval(model)
    text_embed = embed_fn(model, prompts)
    want = []
    for batch in Loader(test_ds, batch_size=PROBE_BATCH):
        pc = torch.from_numpy(batch["pc"]).to(DEV)
        want.append(step_fn(model, {"pc": pc}, text_embed).cpu().numpy()[batch["valid"]])
    want = np.concatenate(want)
    got = recog["logits"]
    equal = bool(np.array_equal(got, want))
    print(f"[probe] save_recog_feats logits {got.shape} vs validate's eval step: bit-equal "
          f"{equal}, max|diff| {float(np.abs(got - want).max()):.3e}")
    check(equal, "save_recog_feats' logits differ from validate's eval step")
    check(np.array_equal(recog["label_list"], test_ds.labels), "recog labels")
    return {"bit_equal": equal}


# run_probe a shot count at a time (a shot's subsets depend only on the shot
# and the run) in a fresh process on one device: {shot: (mean, std, seconds)}
PROBE_CHILD = """
import json, sys, time
import torch
from ppt_torch.tasks import linear_probe
torch.set_num_threads(1)  # no intra-op pool spinning beside the other process
files, shots, runs, device = json.loads(sys.argv[1])
out = {}
for shot in shots:
    t0 = time.perf_counter()
    mean, std = linear_probe.run_probe(*files, num_run=runs, num_step=8, shots=(shot,),
                                       device=device)[shot]
    out[shot] = (mean, std, time.perf_counter() - t0)
print(json.dumps(out))
"""


def probe_card_and_host(files):
    """The protocol on the card and on the CPU, each in a process of its own,
    side by side (the fits read the host every step)."""
    procs = {dev: subprocess.Popen(
        [sys.executable, "-c", PROBE_CHILD, json.dumps([files, PROBE_SHOTS, PROBE_RUNS, dev])],
        cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for dev in ("cuda", "cpu")}
    out = {}
    try:
        for dev, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            check(p.returncode == 0, f"the probe on {dev} failed: {stderr[-2000:]}")
            out[dev] = {int(k): v for k, v in json.loads(stdout.splitlines()[-1]).items()}
    finally:
        for p in procs.values():
            p.kill()
    return out["cuda"], out["cpu"]


def probe_fit_card_vs_host(files, C=1e-2, shot=16):
    """One fit (run 0's subset at ``shot``) on the card and on the CPU at a
    C where the objective is well conditioned: max|dW| / max|W|."""
    tr = np.load(files[0])
    idx = linear_probe.shot_indices(tr["label_list"], shot, 0, 40)
    X = torch.from_numpy(tr["feature_list"][idx])
    y = torch.from_numpy(tr["label_list"][idx].astype(np.int64))
    w_card, _ = linear_probe._fit_logreg(X.to(DEV), y.to(DEV), C, 40)
    w_host, _ = linear_probe._fit_logreg(X, y, C, 40)
    return float((w_card.cpu() - w_host).abs().max() / w_host.abs().max())


def probe_interpretation():
    """nearest_words at CLIP's size on the card against the CPU, TF32 off:
    indices identical except where the f64 squared distances of the two
    indices lie within TIE_REL of each other."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    gen = torch.Generator().manual_seed(21)
    table = torch.randn(VOCAB, 512, generator=gen) * 0.02  # the init's scale
    ctx = torch.randn(N_CTX_PROBE, 512, generator=gen) * 0.02
    want_idx, want_d = interpret_prompt.nearest_indices(ctx, table, 5)
    tc, tt = ctx.to(DEV), table.to(DEV)
    interpret_prompt.nearest_indices(tc, tt, 5)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_idx, got_d = interpret_prompt.nearest_indices(tc, tt, 5)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got_idx, got_d = got_idx.cpu(), got_d.cpu()
    c64, t64 = ctx.double(), table.double()
    d2 = (c64 * c64).sum(-1)[:, None] + (t64 * t64).sum(-1)[None, :] - 2.0 * c64 @ t64.t()
    swaps = 0
    for i, j in zip(*torch.nonzero(got_idx != want_idx, as_tuple=True)):
        a, b = d2[i, got_idx[i, j]], d2[i, want_idx[i, j]]
        check(abs(a - b) <= TIE_REL * max(abs(a), abs(b)),
              f"ctx {int(i)} rank {int(j)}: card {int(got_idx[i, j])}, CPU {int(want_idx[i, j])}")
        swaps += 1
    dist_diff = float((got_d - want_d).abs().max())
    words = interpret_prompt.nearest_words(tc, tt, topk=5)
    check(len(words) == N_CTX_PROBE and all(len(r) == 5 for r in words), "nearest words")
    print(f"[probe] nearest_words {N_CTX_PROBE} x {VOCAB} x 512 on the card: {ms:.2f} ms; "
          f"indices identical to the CPU's but {swaps} near-tie swaps; max|dist diff| "
          f"{dist_diff:.3e}; ctx[ 0]: {words[0]}")
    return {"ms": ms, "near_tie_swaps": swaps, "max_dist_diff": dist_diff}


def run_probe_slice(smi):
    saved_loader = pdata.DATASETS["modelnet40"]
    pdata.DATASETS["modelnet40"] = synthetic_modelnet40_probe()
    try:
        return _run_probe_slice(smi)
    finally:
        pdata.DATASETS["modelnet40"] = saved_loader


def _run_probe_slice(smi):
    """The extracted features stay under ``PROBE_DIR/lp_feats``, where
    ``python -m ppt_torch.tasks.linear_probe --output_dir build/chip_smoke_probe``
    reads them."""
    t_phase = time.perf_counter()
    shutil.rmtree(PROBE_DIR, ignore_errors=True)
    out = {"card": smi}

    # --- extraction: feature_extract.main, each split timed --------------------------
    walls = {}
    extract = feature_extract.extract_features

    def timed_extract(args, split, with_logits=False):
        t0 = time.perf_counter()
        data = extract(args, split, with_logits)
        torch.cuda.synchronize()
        walls[split] = time.perf_counter() - t0
        return data

    feature_extract.extract_features = timed_extract
    try:
        _build.reset_launches()
        feat_dir = feature_extract.main(probe_args())
        launches = dict(_build.LAUNCHES)
    finally:
        feature_extract.extract_features = extract
    files = [os.path.join(feat_dir, f"{s}.npz") for s in ("train", "test")]
    n = {s: len(np.load(f)["label_list"]) for s, f in zip(("train", "test"), files)}
    check(n == {"train": MN40_TRAIN_CLOUDS, "test": MN40_TEST_CLOUDS}, f"extracted rows {n}")
    n_batches = sum(math.ceil(v / PROBE_BATCH) for v in n.values())
    per_batch = {k: launches.get(k, 0) / n_batches for k in PROBE_PER_BATCH}
    others = {k: v for k, v in launches.items() if k not in PROBE_PER_BATCH and v}
    rates = {s: n[s] / walls[s] for s in n}
    print(f"[probe] feature_extract.main bf16 (ULIP_PointBERT, B={PROBE_BATCH} x 1024 points): "
          f"train {n['train']} clouds in {walls['train']:.2f} s ({rates['train']:.1f} clouds/sec), "
          f"test {n['test']} in {walls['test']:.2f} s ({rates['test']:.1f} clouds/sec), each "
          f"with its model build; launches a batch {json.dumps(per_batch)}; {smi}")
    check(per_batch == {k: float(v) for k, v in PROBE_PER_BATCH.items()} and not others,
          f"extraction launches a batch {per_batch} (others {others}), not {PROBE_PER_BATCH}")
    out["extract"] = {"seconds": walls, "clouds_per_sec": rates, "launches_per_batch": per_batch}

    # the batch loop alone, the model built: clouds/sec of the encoder over the test split
    args = probe_args()
    test_ds = pdata.build_dataset("modelnet40", args, "test")
    prompts, model = cls.prompts_and_model(args, test_ds.classnames, DEV)  # main's weights
    batches = [torch.from_numpy(b["pc"]).to(DEV) for b in Loader(test_ds, PROBE_BATCH)]
    loop = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for pc in batches:
                model.point_encoder(pc, train=False).float().cpu()
        torch.cuda.synchronize()
        loop.append(time.perf_counter() - t0)
    loop_rate = len(test_ds) / sorted(loop)[1]
    print(f"[probe] the extraction loop alone over the test split (model built, batches on the "
          f"card): median of 3 {sorted(loop)[1] * 1e3:.1f} ms, {loop_rate:.1f} clouds/sec")
    out["extract"]["loop_clouds_per_sec"] = loop_rate
    out["features_vs_plain"] = probe_features_vs_plain(batches[0], model)

    # --- the recognition dump against validate's eval step ---------------------------
    recog = np.load(feature_extract.save_recog_feats(probe_args()))
    check(np.array_equal(recog["feature_list"], np.load(files[1])["feature_list"]),
          "save_recog_feats' features differ from main's")
    out["logits"] = probe_logits_vs_validate(recog, model, prompts, test_ds)
    del model

    # --- the probe on the card and on the CPU, side by side --------------------------
    card, host = probe_card_and_host(files)
    for shot in PROBE_SHOTS:
        print(f"[probe] {shot}-shot, {PROBE_RUNS} runs, num_step 8: card {card[shot][0]:.2f} +- "
              f"{card[shot][1]:.2f} in {card[shot][2]:.2f} s; CPU {host[shot][0]:.2f} +- "
              f"{host[shot][1]:.2f} in {host[shot][2]:.2f} s")
        check(abs(card[shot][0] - host[shot][0]) <= PROBE_MEAN_TOL,
              f"{shot}-shot mean on the card {card[shot][0]} vs the CPU {host[shot][0]}")
    w_diff = probe_fit_card_vs_host(files)
    print(f"[probe] one fit (16-shot, run 0, C = 1e-2) on the card against the CPU: "
          f"max|dW|/max|W| {w_diff:.3e} (limit {PROBE_W_TOL})")
    check(w_diff <= PROBE_W_TOL, "the card's fit differs from the CPU's")
    out["probe"] = {"card": card, "cpu": host, "w_card_vs_cpu": w_diff}

    out["interpret"] = probe_interpretation()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[probe] phase 16 took {out['seconds']:.1f} s")
    return out


# kernels whose every instance must build without spills (the ball-query walk,
# the 3-D loss kernels)
# ---------------------------------------------------------------------------
# phase 17: the tools (the serving export, the component probe, the FLOP
# table, the backbone bench) and the registered operators' host cost
# ---------------------------------------------------------------------------

TOOLS_DIR = _build.BUILD_DIR.parent / "chip_smoke_tools"
EXPORT_BATCH = 32
# the exported PPT-Base program's kernels, a batch, and nothing else
EXPORT_PER_BATCH = {"fps_batched": 1, "knn_gather": 1, "mini_forward": 1, "fused_vit_block": 11,
                    "fused_vit_block_readout": 1}
HOST_ROUNDS = 400
# a fresh process that loads the baked program with torch and ppt_torch.kernels
# alone, runs the clouds through it and reports its launches
LOADER_CHILD = """
import json, sys, time
import torch
import ppt_torch.kernels
from ppt_torch.kernels import _build
art, clouds, out = sys.argv[1:4]
t0 = time.perf_counter()
program = torch.export.load(art).module()
load_s = time.perf_counter() - t0
pcs = torch.load(clouds).cuda()  # [batches, B, N, 3]
with torch.no_grad():
    program(pcs[0])
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits = [program(pc) for pc in pcs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
torch.save(torch.stack(logits).cpu(), out)
extra = sorted(m for m in sys.modules if m.startswith("ppt_torch.")
               and not m.startswith("ppt_torch.kernels"))
print(json.dumps({"launches": dict(_build.LAUNCHES), "batches": len(pcs), "wall_s": wall,
                  "load_s": load_s, "other_ppt_torch_modules": extra}))
"""


def host_us_by_op(rounds=HOST_ROUNDS):
    """The host's microseconds a call of each ``ppt`` operator through
    ``torch.ops.ppt`` against its direct launch function (the operator's CUDA
    implementation), in alternated rounds of one call each (the order
    swapped every round, the queue drained every 20 rounds, untimed), at
    shapes the card runs in microseconds; medians. Printed, not claimed."""
    xyz = cloud(1, 256, 5)
    q = xyz[:, :32].contiguous()
    groups = cloud(1, 8 * 32, 6) - 0.5
    mw = mini_weights(256, 7)
    x, pos, dp, bw, lnf = block_inputs(1, 33, 384, torch.bfloat16, 8)
    bf = torch.bfloat16
    pairs = {
        "fps_batched": (lambda: torch.ops.ppt.fps_batched(xyz, 32),
                        lambda: kgroup._fps_batched_cuda(xyz, 32), "B=1 N=256 npoint 32"),
        "knn_gather": (lambda: torch.ops.ppt.knn_gather(32, xyz, q),
                       lambda: kgroup._knn_gather_cuda(32, xyz, q), "B=1 N=256 S=32 k=32"),
        "mini_forward": (lambda: torch.ops.ppt.mini_forward(32, bf, groups, *mw),
                         lambda: kmini._mini_forward_cuda(32, bf, groups, *mw),
                         "B=1 G=8 M=32 bf16"),
        "mini_stats": (lambda: torch.ops.ppt.mini_stats(32, bf, groups, *mw[:7]),
                       lambda: kmini._mini_stats_cuda(32, bf, groups, *mw[:7]),
                       "B=1 G=8 M=32 bf16"),
        "fused_vit_block": (lambda: torch.ops.ppt.fused_vit_block(x, pos, dp, *bw, 6),
                            lambda: kvit._block_cuda(x, pos, dp, *bw, 6),
                            "B=1 L=33 C=384 bf16"),
        "fused_vit_block_readout": (
            lambda: torch.ops.ppt.fused_vit_block_readout(x, pos, dp, *bw, *lnf, 6),
            lambda: kvit._block_readout_cuda(x, pos, dp, *bw, *lnf, 6), "B=1 L=33 C=384 bf16"),
    }
    out = {}
    with torch.no_grad():
        for name, (op, direct, shape) in pairs.items():
            a, b = op(), direct()
            check(all(torch.equal(u, v) for u, v in zip(
                a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,))),
                f"{name}: the operator and its direct launch differ")
            torch.cuda.synchronize()
            times = {"op": [], "direct": []}
            for r in range(rounds):
                for key in (("op", "direct") if r % 2 == 0 else ("direct", "op")):
                    fn = op if key == "op" else direct
                    t0 = time.perf_counter()
                    fn()
                    times[key].append(time.perf_counter() - t0)
                if r % 20 == 19:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            op_us, direct_us = median(times["op"]) * 1e6, median(times["direct"]) * 1e6
            out[name] = dict(op_us=op_us, direct_us=direct_us, extra_us=op_us - direct_us)
            print(f"[host] {name}: {op_us:.3f} us a call through torch.ops.ppt, {direct_us:.3f} "
                  f"us by the direct launch ({op_us - direct_us:+.3f} us); medians of {rounds} "
                  f"alternated rounds of one call; {shape}")
    return out


def export_clouds(n_clouds=MN40_TEST_CLOUDS, batch=EXPORT_BATCH, seed=1):
    """ModelNet40's test-split count of synthetic clouds, the last batch
    padded with the first clouds: [batches, B, 1024, 3] f32 on the host."""
    full = make_synthetic(num_classes=40, samples_per_class=-(-n_clouds // 40), npoints=1024,
                          seed=seed)
    pts = torch.from_numpy(full.points[:n_clouds])
    pad = -len(pts) % batch
    pts = torch.cat([pts, pts[:pad]])
    return pts.reshape(-1, batch, *pts.shape[1:]).contiguous()


def run_export(smi):
    """The full-width PPT-Base program on the card: ``tools/export.py``'s
    ``main`` exports it baked at B=32 and prints its ``--measure`` line;
    a fresh process loads it, its logits against the eager eval step's on
    the same batches and seeded weights, its launches a batch; the
    symbolic batch at 8 and 32."""
    from ppt_torch.tools import export as texport

    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    meta = texport.main(["--out", str(TOOLS_DIR / "baked"), "--bake-weights", "--measure", "30"])
    main_s = time.perf_counter() - t0
    check(meta["ppt_ops"] == EXPORT_PER_BATCH,
          f"the exported graph calls {meta['ppt_ops']}, not {EXPORT_PER_BATCH}")
    art = TOOLS_DIR / "baked" / texport.ARTIFACT
    pcs = export_clouds()
    torch.save(pcs, TOOLS_DIR / "clouds.pt")
    child = subprocess.run(
        [sys.executable, "-c", LOADER_CHILD, str(art), str(TOOLS_DIR / "clouds.pt"),
         str(TOOLS_DIR / "logits.pt")], cwd=str(Path(__file__).resolve().parent),
        capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"the loading process failed: {child.stderr[-3000:]}")
    loaded = json.loads(child.stdout.splitlines()[-1])
    got = torch.load(TOOLS_DIR / "logits.pt")
    n = loaded["batches"]
    per_batch = {k: v / n for k, v in loaded["launches"].items()}
    print(f"[export] baked B={EXPORT_BATCH} artifact {meta['artifact_bytes']} bytes; export, "
          f"save and {meta['latency']['reps']} measured calls in {main_s:.2f} s; graph ppt ops "
          f"{json.dumps(meta['ppt_ops'])}; the loading process (torch and ppt_torch.kernels "
          f"alone; other ppt_torch modules {loaded['other_ppt_torch_modules']}) loaded it in "
          f"{loaded['load_s']:.2f} s and ran {n} batches in {loaded['wall_s']:.3f} s "
          f"({n * EXPORT_BATCH / loaded['wall_s']:.1f} clouds/sec, the clouds on the card); "
          f"launches a batch {json.dumps(per_batch)}")
    check(not loaded["other_ppt_torch_modules"], "the loading process imported model code")
    check(per_batch == EXPORT_PER_BATCH, f"the loaded program launched {per_batch} a batch")

    model, prompts = texport.flagship(texport.flagship_args(False, DEV), DEV)  # main's weights
    embed_fn, step_fn = make_cached_text_eval(model)
    text_embed = embed_fn(model, prompts)
    want = torch.stack([step_fn(model, {"pc": pc.to(DEV)}, text_embed) for pc in pcs]).cpu()
    bit_equal = torch.equal(got, want)
    diff = float((got - want).abs().max() / want.std())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[export] loaded program vs the eager eval step on the same {n} batches: bit-equal "
          f"{bit_equal}; max|diff|/std {diff:.3e}, top-1 agreement {top1:.3f}")
    check(got.shape == want.shape and torch.isfinite(got).all(), "exported logits")
    check(bit_equal or (diff <= 0.25 and top1 >= 0.8),
          "the loaded program's logits disagree with the eager eval step")

    ep_sym = texport.export_serving(model, prompts, batch=EXPORT_BATCH, npoints=1024,
                                    bake_weights=True, sym_batch=True)
    sym_path = TOOLS_DIR / "sym" / texport.ARTIFACT
    sym_path.parent.mkdir(parents=True, exist_ok=True)
    texport.save_exported(ep_sym, str(sym_path))
    sym = texport.load_exported(str(sym_path))
    sym_equal = {}
    with torch.no_grad():
        for b in (8, 32):
            pc = pcs[1, :b].to(DEV)
            sym_equal[b] = torch.equal(sym(pc), step_fn(model, {"pc": pc}, text_embed))
    print(f"[export] --sym-batch program at B=8 and B=32 bit-equal to the eager step: "
          f"{json.dumps(sym_equal)}")
    check(all(sym_equal.values()), f"the symbolic-batch program disagrees: {sym_equal}")
    return {"main_s": main_s, "artifact_bytes": meta["artifact_bytes"], "ppt_ops": meta["ppt_ops"],
            "loaded": loaded, "launches_per_batch": per_batch, "bit_equal": bit_equal,
            "max_diff_over_std": diff, "top1": top1, "sym_batch_bit_equal": sym_equal,
            "latency": meta["latency"], "card": smi}


def run_tools17_slice(smi):
    """Phase 17: the export, the registered operators' host cost, the
    component probe at its defaults, profile --flops for recognition and
    the prompt-tuning step, and backbone_bench for each of its towers."""
    from ppt_torch.tools import backbone_bench, component_probe

    t0 = time.perf_counter()
    out = {"export": run_export(smi), "host_us_by_op": host_us_by_op()}
    out["component_probe"] = {ln["component"]: {k: ln[k] for k in ("ms", "timer", "launches")}
                              for ln in component_probe.main(["--components",
                                                              ",".join(PROBE_COMPONENTS)])}
    out["flops"] = {}
    for train in (False, True):
        table = tprofile.profile_flops(train)
        print(f"[flops] {json.dumps(table)}")
        check(abs(sum(s["gflop"] for s in table["sections"].values())
                  - table["total"]["gflop"]) <= 1e-9 * table["total"]["gflop"],
              "profile --flops: the sections do not add up to the step")
        out["flops"]["train" if train else "eval"] = table
    out["backbones"] = {}
    for name in PHASE17_BACKBONES:  # phase 18 times dgcnn
        line = backbone_bench.main(["--model", name, "--iters", "8"])
        out["backbones"][name] = {k: line[k] for k in ("clouds_per_sec", "fwd_ms", "spread_pct")}
    out["seconds"] = time.perf_counter() - t0
    print(f"[tools] phase 17 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: the rest of the recognition zoo, the graph towers, SimpleView
# ---------------------------------------------------------------------------

PHASE17_BACKBONES = ("pointnext", "pointnet2_ssg", "pointnet2_msg", "pointmlp")
# the component probe's components that no other phase times at the same
# shape: the text routes (phase 6), the other trunk routes (phase 8), the
# flash backward and the feature ball query (phase 3) are timed there
PROBE_COMPONENTS = ("grouping", "grouping_single", "mini_forward", "mini_stats", "vit12_block",
                    "ball_query_gather", "flash_fwd")
ZOO_BATCH = 32
ZOO_MODELS = ("ULIP_PointNet", "ULIP_PointNet_STN", "ULIP_DGCNN", "ULIP_PCT", "ULIP_CurveNet")
ZOO_FPS_PER_BATCH = {"ULIP_PointNet": 0, "ULIP_PointNet_STN": 0, "ULIP_DGCNN": 0,
                     "ULIP_PCT": 2, "ULIP_CurveNet": 3}
# (N, npoint, towers): fps_batched's new shapes at B=32
ZOO_FPS_SHAPES = ((1024, 512, "PCT"), (512, 256, "PCT"),
                  (1024, 256, "CurveNet, GroupPointNet"), (256, 64, "CurveNet"),
                  (64, 16, "CurveNet"))
TOL_ZOO_CPU = 1e-3  # the card's f32 forward against the CPU's, of the output's std


def zoo_args(model, dtype="bfloat16"):
    return train_args(dtype, 0, ZOO_BATCH, model=model, evaluate_3d=True)


def zoo_logits(ctx, pc, plain=False):
    embed_fn, step_fn = make_cached_text_eval(ctx["model"])
    with plain_path() if plain else contextlib.nullcontext():
        out = step_fn(ctx["model"], {"pc": pc}, embed_fn(ctx["model"], ctx["prompts"]))
    torch.cuda.synchronize()
    return out


def logits_agree_zoo(tag, got, want, dtype):
    """Phase 4's limits: max|diff| over the reference's std and top-1."""
    check(got.shape == want.shape and torch.isfinite(got).all(), f"{tag} logits")
    diff = float((got.float() - want.float()).abs().max() / want.float().std())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    ok = diff <= 1e-3 and top1 >= 0.95 if dtype == "float32" else diff <= 0.25 and top1 >= 0.8
    print(f"[zoo] {tag}: max|diff|/std {diff:.3e}, top-1 agreement {top1:.3f}")
    check(ok, f"{tag}: logits disagree")
    return {"diff_over_std": diff, "top1": top1}


def bf16_vs_f32_zoo(tag, ctx16, ctx32, pc, logits16, logits32):
    """bf16 against f32, same weights: the point embeddings ``encode_pc``
    and the logits each within phase 4's bf16 limit (max|diff| 0.25 of the
    f32 side's std). The logits' top-1 agreement is reported, not held: at
    random weights the 40 prompts' text embeddings lie so close that a
    cloud's top-2 logits sit within bf16's rounding of each other (top-1
    agreement 0.31 for ``ULIP_PointNet``, measured)."""
    with torch.no_grad():
        e16 = ctx16["model"].encode_pc(pc).float()
        e32 = ctx32["model"].encode_pc(pc).float()
    torch.cuda.synchronize()
    diff = float((e16 - e32).abs().max() / e32.std())
    ldiff = float((logits16.float() - logits32).abs().max() / logits32.std())
    top1 = float((logits16.argmax(-1) == logits32.argmax(-1)).float().mean())
    print(f"[zoo] {tag} bf16 vs f32: point embeddings max|diff|/std {diff:.3e} (limit 0.25); "
          f"logits max|diff|/std {ldiff:.3e} (limit 0.25), top-1 agreement {top1:.3f} (reported)")
    check(torch.isfinite(e16).all() and diff <= 0.25, f"{tag}: bf16 embeddings disagree with f32")
    check(torch.isfinite(logits16).all() and ldiff <= 0.25, f"{tag}: bf16 logits disagree with f32")
    return {"embed_diff_over_std": diff, "logits_diff_over_std": ldiff, "logits_top1": top1}


def zoo_step(name, ctx):
    """One head-type-0 train step of a seeded model: loss finite, frozen
    leaves bit-unchanged, the prompt moved; ``ULIP_CurveNet``'s refused by
    name, nothing moved."""
    state, model = ctx["state"], ctx["model"]
    check(sorted(state.trainable) == ["prompt_learner.learnable_tokens"], f"{name} partition")
    before = snapshot(dict(model.named_parameters()))
    b = cls.device_batch(next(iter(Loader(ctx["train_ds"], ZOO_BATCH, shuffle=True, seed=3))),
                         DEV)
    if name == "ULIP_CurveNet":
        try:
            make_train_step(smoothing=0.2)(state, b, ctx["prompts"])
        except ValueError as e:
            check("ULIP_CurveNet" in str(e) and "'gumbel'" in str(e), f"refusal: {e}")
            check(all(torch.equal(p, before[k]) for k, p in model.named_parameters()),
                  "a leaf moved in the refused step")
            print(f"[zoo] ULIP_CurveNet train step refused by name: {str(e)[:80]}...")
            return {"refused": True}
        check(False, "ULIP_CurveNet's train step ran")
    _build.reset_launches()
    t0 = time.perf_counter()
    _, m = make_train_step(smoothing=0.2)(state, b, ctx["prompts"])
    loss = float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    moved = not torch.equal(state.trainable["prompt_learner.learnable_tokens"],
                            before["prompt_learner.learnable_tokens"])
    frozen = all(torch.equal(p, before[k]) for k, p in model.named_parameters()
                 if k not in state.trainable)
    print(f"[zoo] {name} bf16 head_type 0 step (B={ZOO_BATCH}): loss {loss:.4f}, {ms:.1f} ms "
          f"(the first step), prompt moved {moved}, frozen leaves unchanged {frozen}; launches "
          f"{json.dumps(launches, sort_keys=True)}")
    check(math.isfinite(loss) and moved and frozen, f"{name} step")
    return {"loss": loss, "first_step_ms": ms, "launches": launches}


def zoo_entry(name, smi):
    args = zoo_args(name)
    ctx = cls.setup(args)
    n_tower = sum(p.numel() for p in ctx["model"].point_encoder.parameters())
    n_batches = math.ceil(len(ctx["test_ds"]) / ZOO_BATCH)
    validate_counted(ctx, args)  # warm-up
    launches, wall, val = validate_counted(ctx, args)
    per_batch = {k: v / n_batches for k, v in launches.items()}
    rate = len(ctx["test_ds"]) / wall
    print(f"[zoo] {name} bf16: point tower {n_tower / 1e6:.2f} M parameters; validate over "
          f"{len(ctx['test_ds'])} clouds x {args.npoints} points ({n_batches} batches of "
          f"{ZOO_BATCH}) in {wall * 1e3:.1f} ms, {rate:.1f} clouds/sec, acc1 {val['acc1']:.2f}; "
          f"launches a batch {json.dumps(per_batch, sort_keys=True)}; {smi}")
    want_fps = ZOO_FPS_PER_BATCH[name]
    check(launches.get("fps_batched", 0) == want_fps * n_batches
          and set(k for k, v in launches.items() if v) <= {"fps_batched"},
          f"{name} launched {launches} in {n_batches} batches, not fps_batched {want_fps} a batch "
          "and nothing else")
    out = {"tower_params": n_tower, "clouds": len(ctx["test_ds"]), "batches": n_batches,
           "validate_ms": wall * 1e3, "clouds_per_sec": rate, "acc1": val["acc1"],
           "launches_per_batch": per_batch, "card": smi}
    pc = torch.from_numpy(ctx["test_ds"].points[:ZOO_BATCH]).to(DEV)
    bf16 = zoo_logits(ctx, pc)
    out["logits"] = {"bfloat16_vs_plain": logits_agree_zoo(f"{name} bf16 vs plain path", bf16,
                                                           zoo_logits(ctx, pc, plain=True),
                                                           "bfloat16")}
    ctx32 = cls.setup(zoo_args(name, "float32"))
    f32 = zoo_logits(ctx32, pc)
    out["logits"]["float32_vs_plain"] = logits_agree_zoo(
        f"{name} f32 vs plain path", f32, zoo_logits(ctx32, pc, plain=True), "float32")
    out["logits"]["bfloat16_vs_float32"] = bf16_vs_f32_zoo(name, ctx, ctx32, pc, bf16, f32)
    del ctx32
    out["step"] = zoo_step(name, ctx)  # its training-mode forward moves the running statistics
    return out


@contextlib.contextmanager
def knn_graphs(replay=None):
    """``ops/geometry.py:knn_point``'s results recorded call by call into the
    yielded list, or (``replay``) each call answered with the next recorded
    graph, moved to the caller's device."""
    from ppt_torch.ops import geometry as gops

    real, seen = gops.knn_point, []
    given = iter(replay or ())

    def knn(k, xyz, new_xyz):
        idx = real(k, xyz, new_xyz) if replay is None else next(given).to(xyz.device)
        seen.append(idx)
        return idx

    gops.knn_point = knn
    try:
        yield seen
    finally:
        gops.knn_point = real


def zoo_graph_towers():
    """The graph towers and SimpleView at their default configs, f32, seeded
    weights, B=32 x 1024 lattice points: the card's forward against the
    CPU's. The lattice keeps the coordinate distances exact on both
    devices, so the ball queries and the coordinate kNN pick alike.
    DeepGCN's later graphs are kNN over its features, where the devices'
    summation orders swap neighbours that lie within rounding of each other,
    and its 14 dilated blocks carry a swap on (the CPU tests measured that
    chaos): its CPU forward takes the card's graphs, call by call, and the
    graphs each device builds are counted against each other."""
    from ppt_torch.nn.gcn import BallDgcnn, DeepGcn, GroupPointNet
    from ppt_torch.nn.layers import init_dense_
    from ppt_torch.nn.resnet import init_conv_
    from ppt_torch.nn.simpleview import SimpleView

    g = torch.Generator().manual_seed(5)
    pts = (torch.randint(0, 65, (ZOO_BATCH, 1024, 3), generator=g) / 64.0).float()
    out = {}
    for name, tower, fwd in (("BallDGCNN", BallDgcnn(), "cls_feat"),
                             ("DeepGCN", DeepGcn(), "cls_feat"),
                             ("GroupPointNet", GroupPointNet(), "cls_feat"),
                             ("SimpleView", SimpleView(), "forward")):
        gen = torch.Generator().manual_seed(6)
        init_dense_(tower, gen)
        init_conv_(tower, gen)
        tower.eval()
        row = {}
        with torch.no_grad():
            with knn_graphs() as cpu_graphs:
                want = getattr(tower, fwd)(pts)
            tower.to(DEV)
            getattr(tower, fwd)(pts.to(DEV))  # warm-up
            _build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with knn_graphs() as card_graphs:
                got = getattr(tower, fwd)(pts.to(DEV))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            if name == "DeepGCN":
                row["graph_indices_differing"] = [
                    int((a.cpu() != b).sum()) for a, b in zip(card_graphs, cpu_graphs)]
                row["unshared_graphs_diff_over_std"] = float((got.cpu() - want).abs().max()
                                                            / want.std())
                tower.cpu()
                with knn_graphs(replay=card_graphs):
                    want = getattr(tower, fwd)(pts)
        diff = float((got.cpu() - want).abs().max() / want.std())
        graphs = ""
        if name == "DeepGCN":
            graphs = (f", the CPU on the card's graphs (each device on its own graphs: "
                      f"{row['unshared_graphs_diff_over_std']:.3e}, kNN indices differing by "
                      f"block {row['graph_indices_differing']})")
        print(f"[zoo] {name} f32 B={ZOO_BATCH} x 1024: card vs CPU max|diff|/std {diff:.3e} "
              f"(limit {TOL_ZOO_CPU:g}){graphs}; {ms:.1f} ms a forward on the card; launches "
              f"a forward {json.dumps(launches)}")
        check(torch.isfinite(got).all() and diff <= TOL_ZOO_CPU,
              f"{name}: the card disagrees with the CPU")
        want_fps = 1 if name == "GroupPointNet" else 0
        check(launches.get("fps_batched", 0) == want_fps, f"{name} launches {launches}")
        out[name] = dict(row, diff_over_std=diff, card_ms=ms, launches=launches,
                         out_shape=list(got.shape))
        del tower
    return out


def run_zoo_slice(smi):
    saved_loader = pdata.DATASETS["modelnet40"]
    pdata.DATASETS["modelnet40"] = synthetic_modelnet40_phase4
    try:
        return _run_zoo_slice(smi)
    finally:
        pdata.DATASETS["modelnet40"] = saved_loader
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _run_zoo_slice(smi):
    from ppt_torch.tools import backbone_bench

    t0 = time.perf_counter()
    out = {"entries": {name: zoo_entry(name, smi) for name in ZOO_MODELS}}
    out["fps_shapes"] = fps_shape_rows(ZOO_BATCH, ZOO_FPS_SHAPES, "zoo", 7)
    out["graph_towers"] = zoo_graph_towers()
    line = backbone_bench.main(["--model", "dgcnn"])
    out["backbone_dgcnn"] = {k: line[k] for k in ("batch", "clouds_per_sec", "fwd_ms",
                                                  "spread_pct")}
    out["seconds"] = time.perf_counter() - t0
    print(f"[zoo] phase 18 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: scene segmentation (PTSeg, RandLA-Net, BAAF-Net, the driver)
# ---------------------------------------------------------------------------

SCENE_DIR = _build.BUILD_DIR.parent / "chip_smoke_scenes"
SCENE_MODELS = ("ptseg", "stratified", "randlanet", "baafnet")
SCENE_RESUME = "randlanet"  # --resume reads a checkpoint alike for every backbone: one shows it
SCENE_B, SCENE_N = 8, 4096  # the driver's batch, --npoints and --voxel_max
SCENE_CHECK_B = 2  # the card-against-CPU forwards
SCENE_CLASSES = 13  # S3DIS
SCENE_FPS_SHAPES = ((4096, 1024, "BAAF-Net, PTSeg, Stratified"),
                    (1024, 256, "BAAF-Net, PTSeg, Stratified"),
                    (256, 64, "BAAF-Net, PTSeg, Stratified"),
                    (64, 16, "BAAF-Net, PTSeg, Stratified"), (16, 4, "BAAF-Net"))
SCENE_FPS_PER_FORWARD = {"ptseg": 4, "stratified": 4, "randlanet": 0, "baafnet": 5}
# the lattice's edge by model: the Stratified Transformer's first windows are
# 1.28 m (fine) and 2.56 m (coarse), so its clouds span 4 m (spacing 1/16 m,
# tens of points a fine window); on the unit cube every cloud is one window
SCENE_SCALE = {"stratified": 4.0}
ROOM_POINTS = 200_000
# rooms a synthetic area holds: Area 1 trains (16 crops: two batches of 8),
# Areas 5 and 6 are the two folds evaluated whole
AREA_ROOMS = {1: 16, 5: 2, 6: 2}
TOL_SCENE_CPU = 1e-4  # the card's f32 forward against the CPU's, of the output's max
SCENE_RATE_STEPS = 5  # train steps timed for crops/s, after the profiled ones


def scene_module(name, dtype, farthest=False, seed=7):
    """A scene backbone at its default config for S3DIS (xyz + rgb, 13
    classes) with seeded Dense kernels (``sceneseg.build_model``) and seeded
    BatchNorm affine and running statistics, drawn on the CPU."""
    from ppt_torch.nn import baafnet as nbaaf
    from ppt_torch.nn.layers import init_dense_

    if farthest:
        model = nbaaf.BaafNet(nbaaf.BaafNetConfig(num_classes=SCENE_CLASSES, farthest_knn=True,
                                                  dims=(6, 4, 16, 64, 128, 256, 512)),
                              feat_channels=3, dtype=dtype)
        init_dense_(model, torch.Generator().manual_seed(seed))
    else:
        model = sceneseg.build_model(name, SCENE_CLASSES, 6, dtype, seed)
    return seed_batchnorm(model, seed + 1)


@torch.no_grad()
def seed_batchnorm(model, seed):
    """Every BatchNorm's affine and running statistics drawn from ``seed`` on
    the CPU (not the identity they start as)."""
    from ppt_torch.nn.layers import BatchNormStats

    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, BatchNormStats):
            n = mod.weight.shape[0]
            mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
            mod.bias.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model


def scene_inputs(B, seed, scale=1.0):
    """(xyz on a 1/64 lattice of the unit cube, times ``scale`` (a power of
    two), rgb 0-255), on the CPU: every expanded-form distance is exact in
    f32, so kNN and FPS pick alike on both devices."""
    g = torch.Generator().manual_seed(seed)
    pts = (torch.randint(0, 65, (B, SCENE_N, 3), generator=g) / 64.0 * scale).float()
    rgb = torch.randint(0, 256, (B, SCENE_N, 3), generator=g).float()
    return pts, rgb


@contextlib.contextmanager
def scene_dropout_off():
    """RandLA-Net's and BAAF-Net's head dropout and the Stratified
    Transformer's DropPath the identity (no two devices draw alike), so a
    training-mode forward's statistics compare."""
    from ppt_torch.nn import baafnet as nbaaf
    from ppt_torch.nn import randlanet as nrandla
    from ppt_torch.nn import stratified as nstrat

    saved = nbaaf.dropout, nrandla.dropout, nstrat._drop_path
    nbaaf.dropout = nrandla.dropout = nstrat._drop_path = lambda x, rate, train, generator: x
    try:
        yield
    finally:
        nbaaf.dropout, nrandla.dropout, nstrat._drop_path = saved


def scene_card_vs_cpu(name, farthest=False, scale=None):
    """The default config in f32 on the card against the CPU, same weights,
    B=2 x 4096 lattice points (``scale``: the lattice's edge, SCENE_SCALE's
    by default): eval logits, then one training-mode forward's running
    statistics, each within TOL_SCENE_CPU of its max magnitude. A
    Stratified Transformer's ``window_overflow`` is read on both."""
    scale = SCENE_SCALE.get(name, 1.0) if scale is None else scale
    tag = name + (" farthest_knn" if farthest else "") + (f" x{scale:g}" if scale != 1 else "")
    cpu = scene_module(name, torch.float32, farthest)
    card = scene_module(name, torch.float32, farthest).to(DEV)
    pts, rgb = scene_inputs(SCENE_CHECK_B, 11, scale)
    with torch.no_grad():
        t0 = time.perf_counter()
        want = sceneseg._apply(name, cpu, pts, rgb, False)
        cpu_s = time.perf_counter() - t0
        sceneseg._apply(name, card, pts.to(DEV), rgb.to(DEV), False)  # warm-up
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sceneseg._apply(name, card, pts.to(DEV), rgb.to(DEV), False)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        diff = rel_err(got.cpu(), want)
        overflow = window_overflow(cpu, card)
        with scene_dropout_off():
            sceneseg._apply(name, cpu, pts, rgb, True)
            sceneseg._apply(name, card, pts.to(DEV), rgb.to(DEV), True)
    card_stats = dict(card.named_buffers())
    stats = max(rel_err(card_stats[k].cpu(), v) for k, v in cpu.named_buffers())
    print(f"[scenes] {tag} f32 B={SCENE_CHECK_B} x {SCENE_N}: card vs CPU logits max|diff|/max "
          f"{diff:.3e}, a training-mode forward's running statistics {stats:.3e} (limit "
          f"{TOL_SCENE_CPU:g}); {card_ms:.1f} ms a forward on the card, {cpu_s:.1f} s on the "
          f"CPU; launches a forward {json.dumps(launches)}"
          + ("" if overflow is None else f"; window_overflow {overflow}"))
    check(torch.isfinite(got).all() and diff <= TOL_SCENE_CPU, f"{tag}: card disagrees with CPU")
    check(stats <= TOL_SCENE_CPU, f"{tag}: training-mode statistics disagree with the CPU's")
    check(launches.get("fps_batched", 0) == SCENE_FPS_PER_FORWARD[name]
          and set(launches) <= {"fps_batched"}, f"{tag} launched {launches}")
    out = {"logits_diff_over_max": diff, "train_stats_diff_over_max": stats,
           "card_ms": card_ms, "cpu_s": cpu_s, "launches": launches,
           "params": sum(p.numel() for p in cpu.parameters())}
    if overflow is not None:
        out["window_overflow"] = overflow
    return out


def window_overflow(cpu, card):
    """A Stratified Transformer's ``window_overflow`` after a forward, on the
    CPU and on the card (which must agree: the key tables are exact), or
    None for another backbone."""
    if getattr(cpu, "window_overflow", None) is None:
        return None
    got, want = int(card.window_overflow), int(cpu.window_overflow)
    check(got == want, f"window_overflow {got} on the card, {want} on the CPU")
    return got


def scene_bf16_vs_f32(name):
    """bf16 against f32 on the card, same weights, B=8 x 4096: max|diff|
    over the f32 logits' max and the argmax agreement (reported)."""
    f32 = scene_module(name, torch.float32).to(DEV)
    bf16 = scene_module(name, torch.bfloat16).to(DEV)
    bf16.load_state_dict(f32.state_dict())
    pts, rgb = (t.to(DEV) for t in scene_inputs(SCENE_B, 12, SCENE_SCALE.get(name, 1.0)))
    with torch.no_grad():
        want = sceneseg._apply(name, f32, pts, rgb, False).float()
        got = sceneseg._apply(name, bf16, pts, rgb, False).float()
    diff = rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[scenes] {name} bf16 vs f32 B={SCENE_B} x {SCENE_N}: max|diff|/max {diff:.3e}, "
          f"argmax agreement {agree:.4f}")
    check(bool(torch.isfinite(got).all()), f"{name}: bf16 logits not finite")
    return {"diff_over_max": diff, "argmax_agreement": agree}


def s3dis_room(rng, n=ROOM_POINTS):
    """One synthetic S3DIS room [n, 7] (xyz, rgb 0-255, label): a 6 x 5 x 3 m
    box of ceiling (0), floor (1) and wall (2) planes, and clutter boxes of
    the other ten classes, each class its own colour plus noise."""
    size = np.array([6.0, 5.0, 3.0])
    kind = rng.choice(4, n, p=[0.2, 0.2, 0.35, 0.25])
    xyz = rng.rand(n, 3) * size
    label = kind.copy()
    xyz[kind == 0, 2] = size[2]
    xyz[kind == 1, 2] = 0.0
    wall = np.flatnonzero(kind == 2)
    side = rng.randint(0, 4, wall.size)
    xyz[wall, side % 2] = np.where(side < 2, 0.0, size[side % 2])
    clutter = np.flatnonzero(kind == 3)
    centres = rng.rand(12, 3) * (size - 1.0) + 0.5
    extent = 0.2 + rng.rand(12, 3) * 0.6
    box = rng.randint(0, 12, clutter.size)
    xyz[clutter] = centres[box] + (rng.rand(clutter.size, 3) - 0.5) * extent[box]
    label[clutter] = 3 + box % 10
    xyz += rng.randn(n, 3) * 0.005  # sensor noise
    colours = np.random.RandomState(99).randint(0, 256, (SCENE_CLASSES, 3))
    rgb = np.clip(colours[label] + rng.randn(n, 3) * 12.0, 0, 255)
    return np.concatenate([xyz, rgb, label[:, None]], axis=1).astype(np.float32)


def write_s3dis(root, seed=0):
    """``<root>/raw/Area_<a>_room_<i>.npy`` for AREA_ROOMS; returns the
    labelled raw points by area."""
    raw = root / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    points = {}
    for area, rooms in AREA_ROOMS.items():
        for i in range(rooms):
            room = s3dis_room(rng)
            np.save(raw / f"Area_{area}_room_{i}.npy", room)
            points[area] = points.get(area, 0) + int((room[:, 6] >= 0).sum())
    return points


def scene_args(root, name, **kw):
    base = dict(dataset_name="s3dis", data_path=str(root), model=name, npoints=SCENE_N,
                voxel_max=SCENE_N, voxel_size=0.04, batch_size=SCENE_B, epochs=1,
                eval_scene=True, test_area=5, allow_synthetic_fallback=False,
                output_dir=str(SCENE_DIR / "out"), exp_name=name,
                cm_out=str(SCENE_DIR / f"{name}_a5.npz"), device=DEV.type)
    base.update(kw)
    return TaskArgs(**base)


@contextlib.contextmanager
def counted_steps(per_step, overflows=None):
    """``sceneseg.make_seg_train_step``'s steps, each step's kernel launches
    appended to ``per_step`` (and a Stratified Transformer's
    ``window_overflow`` on the step's crops to ``overflows``)."""
    real = sceneseg.make_seg_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def counted(state, batch):
            before = dict(_build.LAUNCHES)
            out = step(state, batch)
            per_step.append({k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                             if v - before.get(k, 0)})
            if overflows is not None and getattr(state.model, "window_overflow", None) is not None:
                overflows.append(int(state.model.window_overflow))
            return out

        return counted

    sceneseg.make_seg_train_step = make
    try:
        yield
    finally:
        sceneseg.make_seg_train_step = real


def kernel_split_ms(fn, calls=3, kinds=()):
    """Device ms a call by kind (sort, fps_batched, GEMM, other; ``kinds``,
    ((kind, name substrings), ...), is tried first) over ``calls`` calls
    under the profiler, the wall ms a call and the card's idle share of that
    window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(kernels), "the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    split = collections.Counter()
    for e, us in zip(kernels, tprofile.exclusive_us(spans)):
        low = e.name.lower()
        kind = next((k for k, subs in kinds if any(sub in low for sub in subs)), None) or (
            "sort" if "sort" in low else "fps_batched" if "fps" in low
            else "gemm" if "gemm" in low or "xmma" in low or "cutlass" in low else "other")
        split[kind] += us
    busy = tprofile.busy_us(spans)
    return {"wall_ms": wall_us / calls / 1e3, "busy_ms": busy / calls / 1e3,
            "idle_share": 1.0 - busy / wall_us, "kernels_per_call": len(kernels) / calls,
            "device_ms_by_kind": {k: v / calls / 1e3 for k, v in split.most_common()}}


def scene_step_profile(name):
    """bf16 train steps of the driver's kind at B=8 x 4096 (seeded weights,
    AdamW, one batch): one profiled after a warm-up step, for where its
    device time goes (the kNN's sorts); then the crops/s of
    ``SCENE_RATE_STEPS`` steps without the profiler, the loss read after
    each step as the driver reads it."""
    model = scene_module(name, torch.bfloat16).to(DEV)
    state = TrainState(model, build_optimizer("adamw", model.named_parameters(),
                                              lambda step: 1e-3, betas=(0.9, 0.999)),
                       torch.Generator(device=DEV).manual_seed(1))
    step = sceneseg.make_seg_train_step(name, SCENE_CLASSES, 0.2)
    pts, rgb = (t.to(DEV) for t in scene_inputs(SCENE_B, 13, SCENE_SCALE.get(name, 1.0)))
    label = torch.randint(0, SCENE_CLASSES, (SCENE_B, SCENE_N), device=DEV)
    batch = {"pts": pts, "feats": rgb, "label": label}
    torch.cuda.reset_peak_memory_stats()
    out = kernel_split_ms(lambda: step(state, batch), calls=1)
    t0 = time.perf_counter()
    for _ in range(SCENE_RATE_STEPS):
        float(step(state, batch)["loss"])
    out["crops_per_s"] = SCENE_RATE_STEPS * SCENE_B / (time.perf_counter() - t0)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if getattr(model, "window_overflow", None) is not None:
        out["window_overflow"] = int(model.window_overflow)
    print(f"[scenes] {name} bf16 train step B={SCENE_B} x {SCENE_N} profiled: "
          f"{json.dumps(out)}")
    return out


def scene_driver(root, name, val_points, smi):
    """``sceneseg.train_loop`` as a user runs it: one epoch, the best
    checkpoint's whole-scene eval with --cm_out, then (``SCENE_RESUME``)
    --resume at epoch 1."""
    args = scene_args(root, name)
    per_step, overflows = [], []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_steps(per_step, overflows):
        out = sceneseg.train_loop(args)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    h = out["history"][0]
    cm = np.load(args.cm_out, allow_pickle=True)["matrix"]
    ckpt = Path(args.output_dir) / args.exp_name
    rate = out["scene_points"] / out["scene_eval_seconds"]
    fps_steps = [s.get("fps_batched", 0) for s in per_step]
    print(f"[scenes] driver {name} bf16: {len(per_step)} steps of {SCENE_B} crops x {SCENE_N}, "
          f"loss {h['loss']:.4f}, the epoch's training in {h['train_seconds']:.2f} s (its "
          f"first step's setup included; crops/s: the step profile); crop mIoU {h['miou']:.2f}; whole-scene eval over {out['scene_points']} "
          f"raw points in {out['scene_eval_seconds']:.1f} s ({rate:.0f} raw points/s), mIoU "
          f"{out['scene_miou']:.2f}, OA {out['scene_oa']:.2f}, matrix count {int(cm.sum())} of "
          f"{val_points} labelled val points; fps_batched a step {fps_steps}; peak "
          f"{peak:.2f} GiB; {wall:.1f} s in all; {smi}"
          + (f"; window_overflow a step on the rooms' crops {overflows}" if overflows else ""))
    check(math.isfinite(h["loss"]) and per_step, f"{name}: loss {h['loss']} over {per_step}")
    check(0.0 <= out["scene_miou"] <= 100.0, f"{name}: scene mIoU {out['scene_miou']}")
    check(int(cm.sum()) == val_points, f"{name}: the scene matrix counts {int(cm.sum())} of "
          f"{val_points} labelled raw val points")
    check((ckpt / "checkpoint_best.pt").exists(), f"{name}: no checkpoint_best.pt")
    check(all(n == SCENE_FPS_PER_FORWARD[name] for n in fps_steps),
          f"{name}: fps_batched {fps_steps} a step, not {SCENE_FPS_PER_FORWARD[name]}")
    resumed = {}
    if name == SCENE_RESUME:
        run = sceneseg.train_loop(scene_args(root, name, resume=str(ckpt), epochs=2,
                                             eval_scene=False, cm_out="",
                                             exp_name=name + "_resume"))
        resumed = {"resumed_at_epoch": run["history"][0]["epoch"]}
        check(resumed["resumed_at_epoch"] == 1, f"{name}: --resume began at "
              f"{resumed['resumed_at_epoch']}")
    return {"steps": len(per_step), "loss": h["loss"],
            "epoch_train_s": h["train_seconds"], "crop_miou": h["miou"],
            "scene_points": out["scene_points"], "scene_eval_s": out["scene_eval_seconds"],
            "scene_points_per_s": rate, "scene_miou": out["scene_miou"],
            "scene_oa": out["scene_oa"], "matrix_count": int(cm.sum()), "val_points": val_points,
            "fps_batched_per_step": fps_steps, "peak_gib": peak, "wall_s": wall, **resumed,
            **({"window_overflow_per_step": overflows} if overflows else {})}


def scene_eval_profile(root):
    """The whole-scene eval's idle share: one val room, two voxel passes, the
    RandLA-Net eval step, under the profiler (the host's voxelize, tiles and
    ``np.add.at`` between the forwards show as the card's idle time)."""
    from ppt_torch.data.scenes import SceneDataset, load_s3dis

    scenes = load_s3dis(str(root), "val", test_area=5, voxel_size=0.0)
    one = SceneDataset(scenes.scenes[:1], scenes.classnames, scenes.name)
    model = scene_module("randlanet", torch.bfloat16).to(DEV)
    eval_fn = sceneseg.make_seg_eval_step("randlanet", model, DEV)
    out = kernel_split_ms(lambda: sceneseg.whole_scene_eval(
        eval_fn, one, npoints=SCENE_N, num_classes=SCENE_CLASSES, batch_size=SCENE_B,
        max_passes=2), calls=1)
    print(f"[scenes] whole-scene eval of one room, two passes, randlanet bf16, profiled: "
          f"{json.dumps(out)}")
    return out


def run_scenes_slice(smi):
    try:
        return _run_scenes_slice(smi)
    finally:
        shutil.rmtree(SCENE_DIR, ignore_errors=True)


def _run_scenes_slice(smi):
    from ppt_torch.tools import s3dis_6fold

    t0 = time.perf_counter()
    out = {"card_vs_cpu": {}, "bf16_vs_f32": {}, "driver": {}, "step_profile": {},
           "seconds_by_part": {}}
    t_part = [t0]

    def part(name):
        now = time.perf_counter()
        out["seconds_by_part"][name] = now - t_part[0]
        t_part[0] = now

    # the Stratified Transformer twice: on its 4 m lattice, and on the unit
    # cube, where every cloud is one window far past its caps (the member
    # table's overflow rule on the card)
    for key, name, far, scale in (("ptseg", "ptseg", False, None),
                                  ("stratified", "stratified", False, None),
                                  ("stratified_overflow", "stratified", False, 1.0),
                                  ("randlanet", "randlanet", False, None),
                                  ("baafnet", "baafnet", False, None),
                                  ("baafnet_farthest", "baafnet", True, None)):
        out["card_vs_cpu"][key] = scene_card_vs_cpu(name, far, scale)
    check(out["card_vs_cpu"]["stratified_overflow"]["window_overflow"] > 0,
          "the unit-cube lattice did not overflow Stratified's windows")
    part("card_vs_cpu")
    for name in SCENE_MODELS:
        out["bf16_vs_f32"][name] = scene_bf16_vs_f32(name)
    out["fps_shapes"] = fps_shape_rows(SCENE_B, SCENE_FPS_SHAPES, "scenes", 3)
    part("bf16_vs_f32, fps_shapes")
    SCENE_DIR.mkdir(parents=True, exist_ok=True)
    root = SCENE_DIR / "s3dis"
    labelled = write_s3dis(root)
    part("fixture")
    for name in SCENE_MODELS:
        out["driver"][name] = scene_driver(root, name, labelled[5], smi)
        part(f"driver {name}")
        out["step_profile"][name] = scene_step_profile(name)
        part(f"profile {name}")
    out["scene_eval_profile"] = scene_eval_profile(root)
    # the second fold: Area 6 held out, then the two areas' matrices summed
    sceneseg.train_loop(scene_args(root, "randlanet", test_area=6, exp_name="randlanet_a6",
                                   cm_out=str(SCENE_DIR / "randlanet_a6.npz")))
    folds = [str(SCENE_DIR / "randlanet_a5.npz"), str(SCENE_DIR / "randlanet_a6.npz")]
    six = s3dis_6fold.aggregate(folds)
    total = sum(int(np.load(p, allow_pickle=True)["matrix"].sum()) for p in folds)
    print(f"[scenes] s3dis_6fold over Areas 5 and 6 (randlanet): {json.dumps(six)}; "
          f"{total} points, {labelled[5] + labelled[6]} labelled")
    check(six["folds"] == 2 and total == labelled[5] + labelled[6], "s3dis_6fold's union")
    out["six_fold"] = six
    part("scene eval profile, Area 6, 6-fold")
    out["card"] = smi
    out["seconds"] = time.perf_counter() - t0
    print(f"[scenes] phase 19 took {out['seconds']:.1f} s: "
          f"{json.dumps({k: round(v, 1) for k, v in out['seconds_by_part'].items()})}")
    return out


# ---------------------------------------------------------------------------
# phase 20: the scene tier's other modules
# ---------------------------------------------------------------------------

TIER_MODELS = ("graphvit", "vitseg", "assa", "pointnext_packed")
# (batch, points a cloud) by module: GraphViT-3D's classification readout at
# ModelNet's 1024, PointViT-Seg and ASSA at the scene driver's crops,
# PointNeXt-S packed at 1024
TIER_SHAPES = {"graphvit": (32, 1024), "vitseg": (SCENE_B, SCENE_N), "assa": (SCENE_B, SCENE_N),
               "pointnext_packed": (SCENE_B, 1024)}
# the kernels a forward launches, by module
TIER_LAUNCHES = {"graphvit": {"fps_batched": 1, "fused_vit_block": 12},
                 "vitseg": {"fps_batched": 3, "fused_vit_block": 12},
                 "assa": {}, "pointnext_packed": {"fps_batched": 4}}
# ASSANet's first set abstraction on an S3DIS crop: 4096 -> 1024 queries, radius
# 0.1, 32 neighbours, xyz + rgb in; two pre-convs and one post-conv
ASSA_QUERIES = 1024
ASSA_KW = dict(channels=(6, 32, 64, 64), radius=0.1, nsample=32)
VIT_KINDS = (("vit_block", ("add_ln", "gemm_wgmma", "gemm_f32", "attention_", "readout_kernel")),)


def tier_module(name, dtype, seed=7):
    """The module at its default config with seeded weights: Dense kernels
    lecun-normal, the cls token and position N(0, 0.02), BatchNorm affine
    and running statistics, all drawn on the CPU."""
    from ppt_torch.nn.assa import Assa
    from ppt_torch.nn.graphvit import GraphVit3d
    from ppt_torch.nn.layers import init_dense_
    from ppt_torch.nn.pointnext import PointNextConfig
    from ppt_torch.nn.pointnext_packed import PointNextPacked
    from ppt_torch.nn.vitseg import PointVitSeg

    model = {"graphvit": lambda: GraphVit3d(dtype=dtype),
             "vitseg": lambda: PointVitSeg(dtype=dtype),
             "assa": lambda: Assa(**ASSA_KW, dtype=dtype),
             "pointnext_packed": lambda: PointNextPacked(PointNextConfig(), dtype=dtype)}[name]()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        init_dense_(model, gen)
        if hasattr(model, "init_leaves_"):
            model.init_leaves_(gen)
    return seed_batchnorm(model, seed + 1)


def tier_inputs(name, B, seed):
    """The module's arguments on the CPU: clouds on a 1/64 lattice of the
    unit cube (FPS, kNN and ball queries pick alike on both devices), rgb in
    [0, 1]; GraphViT-3D takes the coordinates alone, ASSA its queries by
    ``fps_plain`` (no kernel), packed PointNeXt xyz + height packed with
    its offsets as ints."""
    N = TIER_SHAPES[name][1]
    g = torch.Generator().manual_seed(seed)
    pts = (torch.randint(0, 65, (B, N, 3), generator=g) / 64.0).float()
    rgb = torch.randint(0, 256, (B, N, 3), generator=g).float() / 255.0
    if name == "graphvit":
        return (pts,)
    if name == "vitseg":
        return pts, rgb
    if name == "pointnext_packed":
        height = pts[..., 2:] - pts[..., 2:].amin(1, keepdim=True)
        return torch.cat([pts, height], -1).reshape(B * N, 4), tuple(N * (i + 1) for i in range(B))
    qi = kgroup.fps_plain(pts, ASSA_QUERIES)
    query = torch.gather(pts, 1, qi.long()[..., None].expand(-1, -1, 3))
    return query, pts, torch.cat([pts, rgb], -1), qi


def tier_call(name, model, args, train=False):
    """The module's forward (GraphViT-3D's ``cls_feat``) on ``args``, each
    tensor moved to the model's device."""
    fn = model.cls_feat if name == "graphvit" else model
    dev = next(model.parameters()).device
    return fn(*[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args], train=train)


def tier_card_vs_cpu(name):
    """f32 on the card against the CPU (same weights, eval) within
    TOL_SCENE_CPU of the output's max, with the kernels the forward
    launched; bf16 against f32 on the card (reported); each forward's ms on
    the card, and a bf16 forward under the profiler (device ms by kind, the
    ViT blocks' kernels together, the idle share)."""
    B, N = TIER_SHAPES[name]
    cpu = tier_module(name, torch.float32)
    card = tier_module(name, torch.float32).to(DEV)
    bf16 = tier_module(name, torch.bfloat16).to(DEV)
    bf16.load_state_dict(card.state_dict())
    args = tier_inputs(name, B, 21)
    with torch.no_grad():
        t0 = time.perf_counter()
        want = tier_call(name, cpu, args)
        cpu_s = time.perf_counter() - t0
        tier_call(name, card, args)  # warm-up
        _build.reset_launches()
        got = tier_call(name, card, args)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        got16 = tier_call(name, bf16, args).float()
        diff, diff16 = rel_err(got.cpu(), want), rel_err(got16, got)
        ms = {dname: gpu_time_ms(lambda m=m: tier_call(name, m, args), reps=5, warmup=1)
              for dname, m in (("f32", card), ("bf16", bf16))}
        prof = kernel_split_ms(lambda: tier_call(name, bf16, args), calls=3, kinds=VIT_KINDS)
    print(f"[scenetier] {name} B={B} x {N}: f32 card vs CPU max|diff|/max {diff:.3e} (limit "
          f"{TOL_SCENE_CPU:g}), bf16 vs f32 {diff16:.3e}; launches a forward "
          f"{json.dumps(launches)}; ms a forward f32 {ms['f32']:.3f}, bf16 {ms['bf16']:.3f} "
          f"(CPU f32 {cpu_s:.1f} s); bf16 profiled {json.dumps(prof)}")
    check(bool(torch.isfinite(got).all()) and diff <= TOL_SCENE_CPU,
          f"{name}: card disagrees with CPU ({diff})")
    check(bool(torch.isfinite(got16).all()), f"{name}: bf16 output not finite")
    check(launches == TIER_LAUNCHES[name], f"{name} launched {launches}, not "
          f"{TIER_LAUNCHES[name]}")
    return {"B": B, "N": N, "diff_over_max": diff, "bf16_vs_f32": diff16, "launches": launches,
            "ms": ms, "cpu_s": cpu_s, "bf16_profile": prof,
            "params": sum(p.numel() for p in cpu.parameters())}


def vitseg_train_card_vs_cpu(B=2):
    """One training-mode forward and backward of PointViT-Seg (the head's
    dropout the identity), card against CPU at B=2 x 4096: the logits and
    the running statistics within TOL_SCENE_CPU, the gradients of
    ``sum(logits * R)`` (through each block's ``recompute_grad``) within
    TOL_PARTSEG_GRAD_DIST of the CPU's by distance, phase 15's limit for
    the same feature-propagation heads behind training-mode BatchNorms
    (their eval-mode gradients match ``jax.grad`` within 1e-4 on the CPU,
    ``tests/test_torch_graphvit.py``); 12 block launches."""
    from ppt_torch.nn import vitseg as nvitseg

    cpu = tier_module("vitseg", torch.float32)
    card = tier_module("vitseg", torch.float32).to(DEV)
    args = tier_inputs("vitseg", B, 22)
    r = torch.randn(B, SCENE_N, SCENE_CLASSES, generator=torch.Generator().manual_seed(23))
    saved = nvitseg.dropout
    nvitseg.dropout = lambda x, rate, train, generator: x
    try:
        out = {}
        for tag, model, rr in (("cpu", cpu, r), ("card", card, r.to(DEV))):
            _build.reset_launches()
            logits = tier_call("vitseg", model, args, train=True)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad((logits * rr).sum(), params)
            out[tag] = (logits.detach().cpu(), {k: g.cpu() for k, g in zip(names, grads)},
                        {k: v.cpu() for k, v in model.named_buffers()},
                        {k: v for k, v in _build.LAUNCHES.items() if v})
    finally:
        nvitseg.dropout = saved
    diff = rel_err(out["card"][0], out["cpu"][0])
    dist = grad_dist(out["card"][1], out["cpu"][1])
    stats = max(rel_err(out["card"][2][k], v) for k, v in out["cpu"][2].items())
    launches = out["card"][3]
    print(f"[scenetier] vitseg training-mode forward + backward B={B} x {SCENE_N}, card vs CPU: "
          f"logits {diff:.3e}, running statistics {stats:.3e} (limit {TOL_SCENE_CPU:g}), "
          f"gradients' distance {dist:.3e} (limit {TOL_PARTSEG_GRAD_DIST:g}); launches "
          f"{json.dumps(launches)}")
    check(diff <= TOL_SCENE_CPU and stats <= TOL_SCENE_CPU, "vitseg training-mode forward "
          "disagrees with the CPU")
    check(dist <= TOL_PARTSEG_GRAD_DIST, f"vitseg gradients' distance {dist}")
    check(launches.get("fused_vit_block") == 12, f"vitseg's training forward launched {launches}")
    return {"logits_diff_over_max": diff, "stats_diff_over_max": stats, "grad_dist": dist,
            "launches": launches}


def run_scenetier_slice(smi):
    t0 = time.perf_counter()
    out = {"modules": {name: tier_card_vs_cpu(name) for name in TIER_MODELS}}
    out["vitseg_train"] = vitseg_train_card_vs_cpu()
    out["card"] = smi
    out["seconds"] = time.perf_counter() - t0
    print(f"[scenetier] phase 20 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: the masked-point autoencoder at full width
# ---------------------------------------------------------------------------

MAE_BATCH = 32
MAE_NPOINTS = 1024
MAE_STEPS = 5  # Adam(1e-3) steps in each dtype
# the kernels a train step launches: the grouping once, the group encoder's two
# (mini_stats in training), one block kernel for each of the 6 encoder blocks
# on the 25 kept tokens and the 2 decoder blocks on all 64; the backward
# recomputes each plain version and launches nothing
MAE_LAUNCHES = {"fps_batched": 1, "knn_gather": 1, "mini_stats": 1, "mini_forward": 1,
                "fused_vit_block": 8}
TOL_MAE_CPU = 1e-4  # the f32 forward card against CPU, of the output's max (phase 20's limit)
# the f32 step's gradients card against CPU: max|diff| over the largest gradient.
# Both run the plain versions in the backward; the forwards differ in f32
# summation order, and the group encoder's two max-pools and the Chamfer's
# nearest-neighbour picks route a gradient to one of two near-tied points
TOL_MAE_GRAD = 1e-3
# the bf16 forward against f32's on the card: the Chamfer-L1, relative, and
# ``pred``'s max|diff| over its max, a bound on every token (readings 1.243e-03
# and 1.038e-02, H100 80GB HBM3 at 700 W). A control, the same bf16 model with
# its parameters rounded to float8_e4m3fn (3 mantissa bits to bf16's 7), has
# to land above the ``pred`` limit (7.129e-02), so that it separates bf16's
# rounding from a path that loses precision; the loss, a mean over 2048
# patches, does not (the control's 1.262e-03)
TOL_MAE_BF16_LOSS = 5e-3
TOL_MAE_BF16_PRED = 3e-2
MAE_KINDS = (("grouping", ("fps_", "knn_")), ("mini", ("mini_",))) + VIT_KINDS


def mae_model(dtype, seed=7):
    """``MaskedPointMAE`` at the full ``MaeConfig`` with seeded weights (Dense
    kernels lecun-normal, the mask token normal(0.02), BatchNorm affine and
    running statistics), drawn on the CPU."""
    from ppt_torch.nn import mae as nmae

    return seed_batchnorm(nmae.init_mae(nmae.MaskedPointMAE(dtype=dtype), seed), seed + 1)


def mae_inputs(B, seed):
    """Clouds on a 1/64 lattice of the unit cube (FPS and kNN pick alike on
    both devices) and the masking noise [B, 64], on the CPU."""
    from ppt_torch.nn import mae as nmae

    g = torch.Generator().manual_seed(seed)
    pts = (torch.randint(0, 65, (B, MAE_NPOINTS, 3), generator=g) / 64.0).float()
    return pts, nmae.masking_noise(g, B, nmae.MaeConfig().num_group)


def mae_call(model, pts, noise, train=False):
    dev = next(model.parameters()).device
    return model(pts.to(dev), noise.to(dev), train=train)


def mae_kernel_rows():
    """Rows 1-5 at MAE's shapes (B=32 x 1024 points, 64 groups of 32, the
    tokenizer 128 wide, blocks [32, 25 | 64, 192] x 6 heads): each against
    its plain version (indices exact, values to ``TOL``), bf16
    ``mini_forward`` at CO = 128 and 256; each timed with the launches
    queued, in rounds alternated with its library call (median of 5)."""
    B, N, G, K, C, H = MAE_BATCH, MAE_NPOINTS, 64, 32, 192, 6
    rows = {"fps_batched": fps_shape_rows(B, ((N, G, "MAE"),), "mae", 9)[0]}
    xyz = cloud(B, N, 43)
    center = torch.gather(xyz, 1, kgroup.fps_plain(xyz, G).long()[:, :, None].expand(-1, -1, 3))
    err = knn_gather_vs_plain("mae", xyz, center, K)

    def knn_library():  # the picks' coordinates minus the query's
        i = torch.topk(torch.cdist(center, xyz), K, dim=-1, largest=False).indices
        nb = torch.gather(xyz, 1, i.reshape(B, G * K, 1).expand(-1, -1, 3))
        return i, nb.reshape(B, G, K, 3) - center[:, :, None, :]

    t = alternated_ms({"ms": lambda: kgroup.knn_gather(K, xyz, center),
                       "library_ms": knn_library}, timer=queued_ms)
    bms, by = bound_ms(B * N * 12 + B * G * 12 + B * G * K * 16, B * G * N * 9, PEAK["f32"])
    rows["knn_gather"] = dict(t, max_abs_err=err, bound_ms=bms, bound_by=by,
                              plain_ms=gpu_time_ms(lambda: kgroup.knn_gather_plain(K, xyz, center)))

    # the group encoder on the groups the grouping gives, [32, 2048, 3]
    x = kgroup.knn_gather(K, xyz, center)[1].reshape(B, G * K, 3).contiguous()
    n = B * G * K
    rows["mini_forward"] = {}
    for co in (128, 256):
        w = mini_weights(co, co)
        entry = {}
        for dname, dt in DTYPES.items():
            got = kmini.mini_forward(K, dt, x, *w)
            again = kmini.mini_forward(K, dt, x, *w)
            want = kmini.mini_forward_plain(K, dt, x, *w)
            torch.cuda.synchronize()
            e, same = rel_err(got, want), torch.equal(got, again)
            print(f"[mae] mini_forward {dname} [{B}, {G * K}, 3] -> [{B}, {G}, {co}]: max rel err "
                  f"{e:.3e} (tol {TOL[dname]}); repeat identical {same}")
            check(bool(torch.isfinite(got.float()).all()) and e <= TOL[dname] and same,
                  f"mini_forward at CO={co} {dname}: error {e}, repeat identical {same}")
            entry[f"{dname}_rel_err"] = e
        if co == 128:
            ops = 2 * n * (3 * 128 + 128 * 256 + 256 * 512 + 512 * co) + 2 * B * G * 256 * 512
            wbytes = 2 * (3 * 128 + 128 + 128 * 256 + 256 + 2 * 256 * 512 + 512 + 512 * co + co)
            bms, by = bound_ms(n * 12 + B * G * co * 2 + wbytes, ops, PEAK["bf16"])
            dt = torch.bfloat16
            entry.update(alternated_ms(
                {"ms": lambda: kmini.mini_forward(K, dt, x, *w),
                 "library_ms": lambda: mini_library(K, dt, x, w),
                 "f32_ms": lambda: kmini.mini_forward(K, torch.float32, x, *w)}, timer=queued_ms))
            entry.update(bound_ms=bms, bound_by=by, tflops=ops / (entry["ms"] * 1e-3) / 1e12,
                         max_abs_err=float((kmini.mini_forward(K, dt, x, *w).float() - kmini.
                                            mini_forward_plain(K, dt, x, *w).float()).abs().max()),
                         plain_ms=gpu_time_ms(lambda: kmini.mini_forward_plain(K, dt, x, *w)))
        rows["mini_forward"][f"co{co}"] = entry

    w = mini_weights(128, 5)[:7]  # fw1, fb1, w2, b2, wg, wl, bsplit
    entry = {}
    for dname, dt in DTYPES.items():
        got = kmini.mini_stats(K, dt, x, *w)
        want = kmini.mini_stats_plain(K, dt, x, *w)
        torch.cuda.synchronize()
        errs = [rel_err(g, t) for g, t in zip(got, want)]
        print(f"[mae] mini_stats {dname} over {n} rows: max rel err sum_h {errs[0]:.3e}, "
              f"sumsq_h {errs[1]:.3e} (tol {TOL[dname]})")
        check(all(torch.isfinite(t).all() for t in got) and max(errs) <= TOL[dname],
              f"mini_stats at MAE's shape {dname}: {errs}")
        entry[f"{dname}_rel_err"] = max(errs)
    dt = torch.bfloat16
    entry.update(alternated_ms({"ms": lambda: kmini.mini_stats(K, dt, x, *w),
                                "library_ms": lambda: stats_library(K, dt, x, w)},
                               timer=queued_ms))
    ops = 2 * n * (3 * 128 + 128 * 256) + n * 256 * 257
    bms, by = bound_ms(n * 12 + 2 * B * G * 256 * 4 + 256 * 256 * 4
                       + 2 * (3 * 128 + 128 + 128 * 256 + 256), ops, PEAK["bf16"])
    got = kmini.mini_stats(K, dt, x, *w)
    want = kmini.mini_stats_plain(K, dt, x, *w)
    entry.update(bound_ms=bms, bound_by=by,
                 max_abs_err=max(float((g - t).abs().max()) for g, t in zip(got, want)),
                 plain_ms=gpu_time_ms(lambda: kmini.mini_stats_plain(K, dt, x, *w)))
    rows["mini_stats"] = entry

    rows["fused_vit_block"] = {}
    for L in (25, 64):
        entry = {}
        for dname, dt in DTYPES.items():
            xb, pos, dp, wb, _ = block_inputs(B, L, C, dt, L)
            got = kvit.fused_vit_block(xb, pos, dp, *wb, H)
            want = kvit.vit_block_plain(xb, pos, dp, *wb, H)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            print(f"[mae] fused_vit_block {dname} [{B}, {L}, {C}] x {H} heads: max rel err "
                  f"{e:.3e} (tol {TOL[dname]})")
            check(bool(torch.isfinite(got.float()).all()) and e <= TOL[dname],
                  f"fused_vit_block at L={L} {dname}: error {e}")
            entry[f"{dname}_rel_err"] = e
        rows_, hid = B * L, 4 * C
        ops = 2 * rows_ * (C * 3 * C + C * C + 2 * C * hid) + 4 * B * L * L * C
        wbytes = 2 * (C * 3 * C + C * C + 2 * C * hid) + 4 * (7 * C + hid)
        bms, by = bound_ms(3 * rows_ * C * 2 + B * 2 * 4 + wbytes, ops, PEAK["bf16"])
        entry.update(alternated_ms({"ms": lambda: kvit.fused_vit_block(xb, pos, dp, *wb, H),
                                    "library_ms": lambda: block_library(xb, pos, dp, wb, H)},
                                   timer=queued_ms))
        entry.update(bound_ms=bms, bound_by=by, max_abs_err=float((got.float() - want.float())
                                                                  .abs().max()),
                     plain_ms=gpu_time_ms(lambda: kvit.vit_block_plain(xb, pos, dp, *wb, H)))
        rows["fused_vit_block"][f"L{L}"] = entry
    print(f"[mae] rows 1-5 at MAE's shapes, ms (queued): {json.dumps(rows)}")
    return rows


def mae_card_vs_cpu():
    """The f32 forward on the card against the CPU's (same weights, clouds and
    noise; eval): the loss and ``pred`` within TOL_MAE_CPU; bf16 against f32
    on the card (the loss within TOL_MAE_BF16_LOSS, ``pred`` within
    TOL_MAE_BF16_PRED of its max) and the float8-weight control's ``pred``
    past that limit; then the first train
    step's gradients card against CPU within TOL_MAE_GRAD of the largest,
    the running statistics within TOL_MAE_CPU, and the card's launches."""
    B = MAE_BATCH
    cpu = mae_model(torch.float32)
    card = mae_model(torch.float32).to(DEV)
    bf16 = mae_model(torch.bfloat16).to(DEV)
    bf16.load_state_dict(card.state_dict())
    control = mae_model(torch.bfloat16).to(DEV)
    with torch.no_grad():
        for p, q in zip(control.parameters(), card.parameters()):
            p.copy_(q.to(torch.float8_e4m3fn).float())
    pts, noise = mae_inputs(B, 42)
    with torch.no_grad():
        t0 = time.perf_counter()
        lw, pw = mae_call(cpu, pts, noise)
        cpu_s = time.perf_counter() - t0
        lg, pg = mae_call(card, pts, noise)
        l16, p16 = mae_call(bf16, pts, noise)
        l8, p8 = mae_call(control, pts, noise)
    pred_err, loss_err = rel_err(pg.cpu(), pw), abs(float(lg) - float(lw)) / abs(float(lw))
    loss16, pred16 = abs(float(l16) - float(lg)) / abs(float(lg)), rel_err(p16, pg)
    loss8, pred8 = abs(float(l8) - float(lg)) / abs(float(lg)), rel_err(p8, pg)
    print(f"[mae] f32 forward B={B} x {MAE_NPOINTS}, card vs CPU: loss {float(lg):.6f} vs "
          f"{float(lw):.6f} (rel {loss_err:.3e}), pred max|diff|/max {pred_err:.3e} (limit "
          f"{TOL_MAE_CPU:g}; CPU {cpu_s:.1f} s); bf16 vs f32: loss rel {loss16:.3e} (limit "
          f"{TOL_MAE_BF16_LOSS:g}), pred {pred16:.3e} (limit {TOL_MAE_BF16_PRED:g}); "
          f"float8-weight control vs f32: loss rel {loss8:.3e}, pred {pred8:.3e}")
    check(tuple(pg.shape) == (B, 64, 32, 3) and bool(torch.isfinite(pg).all())
          and pred_err <= TOL_MAE_CPU and loss_err <= TOL_MAE_CPU,
          f"MAE's f32 forward on the card disagrees with the CPU's ({loss_err}, {pred_err})")
    check(p16.dtype == torch.float32 and bool(torch.isfinite(p16).all())
          and loss16 <= TOL_MAE_BF16_LOSS and pred16 <= TOL_MAE_BF16_PRED,
          f"MAE's bf16 forward against f32: loss {loss16}, pred {pred16}")
    check(pred8 > TOL_MAE_BF16_PRED, f"the float8-weight control's pred {pred8} stays within "
          f"the bf16 limit {TOL_MAE_BF16_PRED}")
    out = {"loss_rel": loss_err, "pred_diff_over_max": pred_err, "cpu_s": cpu_s,
           "bf16_loss_rel": loss16, "bf16_pred_diff_over_max": pred16,
           "control_loss_rel": loss8, "control_pred_diff_over_max": pred8}
    step = {}
    for tag, model in (("cpu", cpu), ("card", card)):
        _build.reset_launches()
        loss, _ = mae_call(model, pts, noise, train=True)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        step[tag] = ({k: g.cpu() for k, g in zip(names, grads)},
                     {k: v.cpu() for k, v in model.named_buffers()},
                     {k: v for k, v in _build.LAUNCHES.items() if v})
    ref = step["cpu"][0]
    top = max(float(g.abs().max()) for g in ref.values())
    worst = max(float((step["card"][0][k] - g).abs().max()) for k, g in ref.items()) / top
    dist = grad_dist(step["card"][0], ref)
    stats = max(rel_err(step["card"][1][k], v) for k, v in step["cpu"][1].items())
    launches = step["card"][2]
    print(f"[mae] f32 train step, card vs CPU: gradients max|diff| over the largest "
          f"{worst:.3e} (limit {TOL_MAE_GRAD:g}), distance {dist:.3e}; running statistics "
          f"{stats:.3e} (limit {TOL_MAE_CPU:g}); launches {json.dumps(launches)}")
    check(worst <= TOL_MAE_GRAD, f"MAE's f32 gradients on the card: {worst} of the largest")
    check(stats <= TOL_MAE_CPU, f"MAE's running statistics on the card: {stats}")
    check(launches == MAE_LAUNCHES, f"MAE's train forward and backward launched {launches}")
    out.update(grad_diff_over_max=worst, grad_dist=dist, stats_diff_over_max=stats)
    return out


def mae_train_steps(dtype):
    """MAE_STEPS ``torch.optim.Adam(lr=1e-3)`` train steps (masking drawn on
    the card, two seeded batches in turn): the first step's launches, the
    losses finite, the wall ms a step (the loss read every step); in bf16
    one more step under the profiler (busy, wall, idle share)."""
    from ppt_torch.nn import mae as nmae

    model = mae_model(dtype).to(DEV)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=DEV).manual_seed(3)
    batches = [mae_inputs(MAE_BATCH, 50 + i)[0].to(DEV) for i in range(2)]

    def step(pts):
        opt.zero_grad(set_to_none=True)
        loss, _ = model(pts, nmae.masking_noise(gen, MAE_BATCH, 64), train=True)
        loss.backward()
        opt.step()
        return loss.detach()

    _build.reset_launches()
    losses = [float(step(batches[0]))]
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    losses += [float(step(batches[i % 2])) for i in range(1, MAE_STEPS)]
    wall_ms = (time.perf_counter() - t0) / (MAE_STEPS - 1) * 1e3
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    out = {"losses": losses, "launches_per_step": launches, "wall_ms_per_step": wall_ms,
           "clouds_per_sec": MAE_BATCH / wall_ms * 1e3}
    if dtype == torch.bfloat16:
        out["profiled_step"] = kernel_split_ms(lambda: step(batches[0]), calls=2, kinds=MAE_KINDS)
    print(f"[mae] {name} Adam(1e-3), {MAE_STEPS} steps of {MAE_BATCH} x {MAE_NPOINTS}: losses "
          f"{[round(x, 5) for x in losses]}; launches a step {json.dumps(launches)}; "
          f"{wall_ms:.2f} ms a step after the first ({out['clouds_per_sec']:.1f} clouds/s)"
          + (f"; profiled {json.dumps(out['profiled_step'])}" if "profiled_step" in out else ""))
    check(all(math.isfinite(x) for x in losses), f"MAE {name} losses {losses}")
    check(launches == MAE_LAUNCHES, f"a MAE {name} train step launched {launches}")
    return out


def run_mae_slice(smi):
    t0 = time.perf_counter()
    out = {"kernels": mae_kernel_rows(), "card_vs_cpu": mae_card_vs_cpu(),
           "train": {"f32": mae_train_steps(torch.float32),
                     "bf16": mae_train_steps(torch.bfloat16)}, "card": smi}
    out["seconds"] = time.perf_counter() - t0
    print(f"[mae] phase 21 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: data-, tensor- and pipeline-parallel PPT-Base on the one card
# ---------------------------------------------------------------------------

PAR_DIR = _build.BUILD_DIR.parent / "chip_smoke_parallel"
PAR_BATCH, PAR_NPOINTS, PAR_PP_BATCH, PAR_MICRO = 32, 1024, 16, 4
PAR_LR = 0.05  # plain SGD: an updated leaf moves by lr times its gradient
# f32 on both sides. dp runs the one-process kernels on half the batch: only
# the BatchNorm sums and the gradient bucket add in another order. tp runs
# the unfused block with fused_mha over 3 heads a rank, its row-parallel
# products all-reduced: another route and another order. The updates are
# held by their distance over all leaves together (grad_dist), as phase 10
# holds the dVAE's: the readout's and the group encoder's max-pools route
# gradients to near-tied points, so one leaf alone is not well conditioned.
TOL_PAR = {"loss": 1e-5, "stats": 1e-4, "dp_update": 1e-3, "tp_update": 1e-3,
           "tp_logits": 1e-4, "pp_features": 1e-5, "pp_grads": 1e-4}


def par_spec(seed=0):
    """PPT-Base at full width in f32: PointBERT 384 x 12 blocks x 6 heads,
    512 groups of 32, encoder 256, DropPath 0.1; the text tower 512 x 12 x 8;
    32 context tokens; the 40 ModelNet40 classes."""
    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    return dict(point={}, text={}, classes=names, n_ctx=32, seed=seed)


def par_batch(B, seed):
    g = torch.Generator().manual_seed(seed)
    return {"pc": torch.rand(B, PAR_NPOINTS, 3, generator=g).numpy(),
            "label": torch.randint(0, 40, (B,), generator=g).numpy()}


def par_jobs():
    spec = par_spec()
    dp = dict(kind="step", name="dp", model=spec, batch=par_batch(PAR_BATCH, 5), head_type=3,
              lr=PAR_LR, mesh=dict(axes=("data",), shape=(2,)))
    tp = dict(dp, name="tp", logits=True, mesh=dict(axes=("data", "model"), shape=(1, 2)))
    pp = dict(kind="pipeline", name="pp", model=spec, batch={"pc": par_batch(PAR_PP_BATCH, 6)["pc"]},
              n_micro=PAR_MICRO, dp_axis=None, mesh=dict(axes=("pipe",), shape=(2,)))
    return [dp, tp, pp]


def par_update(out, start):
    return {k: v - start[k] for k, v in out["trainable"].items()}


def par_stats_rel(got, want):
    return max(rel_err(got[k], v) for k, v in want.items())


def run_parallel_slice(smi):
    """Phase 22: two ranks over gloo on the one card (NCCL refuses two ranks
    on one device; gloo's collectives and point-to-point carry the card's
    tensors through host memory), each PPT-Base step held against the same
    step in this process on the card: dp = 2 (one SGD step at global B = 32,
    16 a rank: the loss, every updated trainable tensor, the running
    statistics; the ranks' launch counts equal one process's), tp = 2 (the
    eval logits and the step, qkv / fc1 column- and proj / fc2 row-sharded,
    fused_mha over 3 heads a rank), pp = 2 (``pipelined_trunk_features``
    with 4 microbatches and the gradient of sum(features**2) against
    ``PointBert`` in one process; fused_vit_block 6 times a microbatch on
    each stage). Then a one-rank NCCL group runs the dp step here, its
    gradient bucket through NCCL's all-reduce on the card, held as dp's. The
    kernels are built before the ranks start."""
    from ppt_torch.parallel import launch, workers
    from ppt_torch.parallel.mesh import create_mesh

    t0 = time.perf_counter()
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    jobs = par_jobs()
    run = launch.start("ppt_torch.parallel.workers:run_jobs", 2, {"jobs": jobs},
                       workdir=str(PAR_DIR), device="cuda", backend="gloo", timeout=600)
    one = {"dp": workers.step_job(dict(jobs[0], mesh=None), "cuda"),
           "tp": workers.step_job(dict(jobs[1], mesh=None), "cuda")}
    model, _ = workers.build_ulip(jobs[2]["model"], "cuda")
    enc = model.point_encoder
    pts = torch.from_numpy(jobs[2]["batch"]["pc"]).to(DEV)
    _build.reset_launches()
    feats = enc(pts, train=False)
    params = dict(enc.named_parameters())
    grads = dict(zip(params, torch.autograd.grad((feats.float() ** 2).sum(),
                                                 list(params.values()))))
    torch.cuda.synchronize()
    one["pp"] = {"features": feats.detach().float().cpu(),
                 "grads": {k: g.float().cpu() for k, g in grads.items()},
                 "launches": {k: v for k, v in _build.LAUNCHES.items() if v}}
    start = {k: v.detach().float().cpu() for k, v in
             workers.build_ulip(jobs[0]["model"], "cpu")[0].named_parameters()}
    ranks = run.wait()
    spawn_s = run.seconds
    out = {"card": smi, "ranks": 2, "backend": "gloo", "tolerances": TOL_PAR,
           "rank_seconds": spawn_s}
    for r, res in enumerate(ranks):
        for name in ("dp", "tp"):
            got, want = res[name], one[name]
            loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            upd = grad_dist(par_update(got, start), par_update(want, start))
            stats = par_stats_rel(got["stats"], want["stats"])
            launches = {k: v for k, v in got["launches"].items() if v}
            row = {"loss": got["loss"], "loss_one_process": want["loss"], "loss_rel": loss,
                   "update_dist": upd, "stats_rel": stats, "launches": launches,
                   "launches_one_process": {k: v for k, v in want["launches"].items() if v}}
            if name == "tp":
                row["logits_rel"] = rel_err(got["logits"], want["logits"])
            print(f"[parallel] rank {r} {name}=2 PPT-Base f32 SGD({PAR_LR}) at B={PAR_BATCH} "
                  f"x {PAR_NPOINTS}: loss {got['loss']:.7f} vs one process {want['loss']:.7f} "
                  f"(rel {loss:.2e}, limit {TOL_PAR['loss']:g}); update distance {upd:.2e} "
                  f"(limit {TOL_PAR[name + '_update']:g}); running statistics rel "
                  f"{stats:.2e} (limit {TOL_PAR['stats']:g})"
                  + (f"; eval logits rel {row['logits_rel']:.2e} (limit "
                     f"{TOL_PAR['tp_logits']:g})" if name == "tp" else "")
                  + f"; launches {json.dumps(launches)}")
            check(math.isfinite(got["loss"]) and loss <= TOL_PAR["loss"],
                  f"{name}=2 loss {got['loss']} against one process {want['loss']}")
            check(upd <= TOL_PAR[name + "_update"], f"{name}=2 update distance {upd}")
            check(stats <= TOL_PAR["stats"], f"{name}=2 running statistics {stats}")
            if name == "dp":
                check(launches == row["launches_one_process"],
                      f"a dp=2 rank launched {launches}, one process "
                      f"{row['launches_one_process']}")
                for k in ("fps_batched", "knn_gather", "mini_forward", "mini_stats",
                          "fused_vit_block"):
                    check(launches.get(k, 0) > 0, f"the dp=2 step launched no {k}")
            else:
                check(row["logits_rel"] <= TOL_PAR["tp_logits"], f"tp=2 logits {row['logits_rel']}")
                check(launches.get("fused_mha", 0) == 12 and not launches.get("fused_vit_block"),
                      f"tp=2 must run 12 fused_mha over its heads, no fused block: {launches}")
            out.setdefault(name, {})[f"rank{r}"] = row
        got, want = res["pp"], one["pp"]
        f_rel = rel_err(got["features"], want["features"])
        g_dist = grad_dist(got["grads"], want["grads"])
        launches = {k: v for k, v in got["launches"].items() if v}
        print(f"[parallel] rank {r} pp=2 pipelined_trunk_features, {PAR_MICRO} microbatches of "
              f"{PAR_PP_BATCH // PAR_MICRO}: features rel {f_rel:.2e} (limit "
              f"{TOL_PAR['pp_features']:g}); gradient distance {g_dist:.2e} (limit "
              f"{TOL_PAR['pp_grads']:g}); launches {json.dumps(launches)} (one process "
              f"{json.dumps(want['launches'])})")
        check(f_rel <= TOL_PAR["pp_features"], f"pp=2 features {f_rel}")
        check(g_dist <= TOL_PAR["pp_grads"], f"pp=2 gradients {g_dist}")
        check(launches.get("fused_vit_block", 0) == 6 * PAR_MICRO,
              f"a pp=2 stage must run fused_vit_block 6 times a microbatch: {launches}")
        out.setdefault("pp", {})[f"rank{r}"] = {"features_rel": f_rel, "grad_dist": g_dist,
                                                "launches": launches}
    # one-rank NCCL group: the dp step's gradient bucket through NCCL
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{PAR_DIR / 'nccl_rendezvous'}",
                            world_size=1, rank=0)
    try:
        got = workers.step_job(dict(jobs[0], mesh=dict(axes=("data",), shape=(1,))), "cuda")
        backend = str(dist.get_backend())
    finally:
        dist.destroy_process_group()
    want = one["dp"]
    loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    upd = grad_dist(par_update(got, start), par_update(want, start))
    diff = max(float((got["trainable"][k] - v).abs().max()) for k, v in want["trainable"].items())
    print(f"[parallel] one-rank {backend} group: the dp step on cuda:0, its gradient bucket "
          f"through NCCL's all-reduce: loss {got['loss']:.7f} vs one process "
          f"{want['loss']:.7f} (rel {loss:.2e}, limit {TOL_PAR['loss']:g}); update distance "
          f"{upd:.2e} (limit {TOL_PAR['dp_update']:g}), max|diff| {diff:g} (the prompt's "
          "gradient sums its scatter in no fixed order, on the card as on the CPU)")
    check(backend == "nccl" and loss <= TOL_PAR["loss"] and upd <= TOL_PAR["dp_update"],
          f"the one-rank NCCL dp step against one process: loss {loss}, update {upd}")
    out["nccl"] = {"backend": backend, "loss": got["loss"], "loss_rel": loss,
                   "update_dist": upd, "max_diff": diff,
                   "launches": {k: v for k, v in got["launches"].items() if v}}
    out["seconds"] = time.perf_counter() - t0
    print(f"[parallel] phase 22 took {out['seconds']:.1f} s (the ranks {spawn_s:.1f} s)")
    return out


SPILL_FREE = ("ball_query_kernel", "ball_query_feats_kernel", "approx_match_warp_kernel",
              "nn_dists_kernel")


def build(names=_build.SOURCES):
    """Phase 2's build: one nvcc per source, in parallel; prints each entry
    function's registers and spills (-Xptxas -v) and fails if a kernel of
    SPILL_FREE spills."""
    t0 = time.perf_counter()
    times = _build.build_all(names, force=True)
    print(f"[build] {len(times)} sources built in parallel in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in sorted(times.items()))})")
    for name in names:
        entry, spills = None, ""
        for ln in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry, spills = m.group(1), ""
            m = re.search(r"\d+ bytes spill stores, \d+ bytes spill loads", ln)
            if m:
                spills = m.group(0)
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry:
                print(f"[build] {name}.cu {entry}: {m.group(1)} registers, {spills}")
                if any(k in entry for k in SPILL_FREE):
                    check(spills.startswith("0 bytes spill stores, 0 bytes spill loads"),
                          f"{entry} spills: {spills}")
                entry = None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("ballquery", "towers", "losses3d", "cloud", "recipes",
                                       "pretrained", "partseg", "probe", "tools", "zoo",
                                       "scenes", "scenetier", "mae", "parallel"),
                    help="build group.cu and run phase 3's ball-query checks and times alone "
                         "(ballquery) or phase 7's ball-query towers alone (towers); build "
                         "losses3d.cu and run phase 3's loss checks and times, nn_dists at "
                         "every (queries, split), then phase 10's dVAE step with recon='emd' "
                         "(losses3d); build cloud.cu and group.cu and run phase 3's "
                         "fps_single and knn_single checks and times beside rows 1-2, and the "
                         "grouping wrappers' host time a call (cloud); build the kernels "
                         "PointBERT's recipes run and run phase 13 (recipes); build the "
                         "kernels PPT-Base and PointMLP run and run phase 14 (pretrained); "
                         "build the kernels part segmentation runs and run phase 15 (partseg); "
                         "build the kernels feature extraction runs and run phase 16 (probe); "
                         "build the kernels the tools time and run phase 17 (tools); "
                         "build group.cu and run phase 18, the zoo (zoo); "
                         "build group.cu and run phase 19, scene segmentation (scenes); "
                         "build group.cu and vitblock.cu and run phase 3's FPS rows of the "
                         "ViT tier and phase 20, the scene tier's other modules (scenetier); "
                         "build group.cu, mini.cu and vitblock.cu, count mini.cu's and "
                         "vitblock.cu's wgmma, and run phase 21, the masked-point "
                         "autoencoder (mae); build the kernels PPT-Base runs and run phase "
                         "22, data-, tensor- and pipeline-parallel PPT-Base (parallel)")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"Python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ulip_models.init_weights = init_weights  # the seeded draws, kept by model

    if args.only == "ballquery":
        build(["group"])
        results = {}
        check_ballquery(results)
        print(json.dumps({"ballquery_kernels": {k: results[k] for k in BALL_KERNELS},
                          "feats_other_dtype": results["ball_query_gather_feats_other_dtype"]}))
        print(smi)
        return
    if args.only == "losses3d":
        build(["losses3d", "group", "mini"])  # the dVAE's step runs group.cu's and mini.cu's too
        results = {}
        check_losses3d(results)
        sweep = nn_plan_sweep()
        ds, stream, pc64 = pb_data()
        emd, _ = run_dvae_emd(pc64, stream, 250 * (len(ds) // DVAE_BATCH), 20)
        print(json.dumps({"losses3d_kernels": {k: results[k] for k in LOSS3D_KERNELS},
                          "nn_plan_sweep": sweep, "dvae_emd": emd}))
        print(smi)
        return
    if args.only == "cloud":
        build(["cloud", "group"])
        results = {}
        check_cloud(results)
        print(json.dumps({"cloud_kernels": {k: results[k] for k in CLOUD_KERNELS
                                            + ("fps_batched", "knn_gather")},
                          "host_us_a_call": results["host_us_a_call"]}))
        print(smi)
        return
    if args.only == "recipes":
        build(["group", "mini", "vitblock", "attention", "text"])
        print(json.dumps({"recipes": run_recipes_slice(smi)}))
        print(smi)
        return
    if args.only == "pretrained":
        build(["group", "mini", "vitblock", "attention"])
        print(json.dumps({"pretrained": run_pretrained_slice(smi)}))
        print(smi)
        return
    if args.only == "partseg":
        build(["group", "mini", "vitblock", "attention"])
        print(json.dumps({"partseg": run_partseg_slice(smi)}))
        print(smi)
        return
    if args.only == "probe":
        build(["group", "mini", "vitblock", "attention"])
        print(json.dumps({"probe": run_probe_slice(smi)}))
        print(smi)
        return
    if args.only == "tools":
        build([n for n in _build.SOURCES if n != "losses3d"])
        print(json.dumps({"tools17": run_tools17_slice(smi)}))
        print(smi)
        return
    if args.only == "zoo":
        build(["group"])
        print(json.dumps({"zoo": run_zoo_slice(smi)}))
        print(smi)
        return
    if args.only == "scenes":
        build(["group"])
        print(json.dumps({"sceneseg": run_scenes_slice(smi)}))
        print(smi)
        return
    if args.only == "scenetier":
        build(["group", "vitblock"])
        print(json.dumps({"vit_tier_fps_shapes": vit_fps_rows(),
                          "scenetier": run_scenetier_slice(smi)}))
        print(smi)
        return
    if args.only == "mae":
        build(["group", "mini", "vitblock"])
        sass = hopper_sass(["mini", "vitblock"])
        check(sass["mini"]["mini_forward_wgmma_kernel"]["instances"] == 2,
              "mini.cu builds mini_forward_wgmma_kernel at CO = 128 and 256")
        print(json.dumps({"mae": run_mae_slice(smi)}))
        print(smi)
        return
    if args.only == "parallel":
        build(["group", "mini", "vitblock", "attention"])
        print(json.dumps({"parallel": run_parallel_slice(smi)}))
        print(smi)
        return
    if args.only == "towers":
        build(["group"])
        print(json.dumps({"ballquery": run_ballquery_slice()[1]}))
        print(smi)
        return
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """The seconds since the previous lap, printed and kept by phase."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
        print(f"[phase] {name}: {laps[name]:.1f} s")

    build()
    sass = hopper_sass()
    check(sass["mini"]["mini_forward_wgmma_kernel"]["instances"] == 2,
          "mini.cu builds mini_forward_wgmma_kernel at CO = 128 and 256")
    lap("2 build, SASS")

    results = {}
    for check_fn in (check_grouping, check_mini, check_mini_stats, check_block, check_attention,
                     check_flash_bwd, check_tower, check_text, check_ballquery, check_losses3d,
                     check_cloud, check_variant):
        check_fn(results)
        lap(f"3 {check_fn.__name__}")
    launches, slice_stats = run_slice()
    lap("4 recognition")
    train_launches, train_stats = run_train_slice()
    launches["mini_stats"] = train_launches["mini_stats"]  # the train path's own kernel
    lap("5 prompt tuning")
    text_launches, text_stats = run_text_slice()
    text_stats["text_encode_ms"]["phase_4"] = slice_stats["text_tower_ms"]
    launches.update(text_launches)  # the fused text path's own kernels
    lap("6 text routes")
    ball_launches, ball_stats = run_ballquery_slice()
    launches.update(ball_launches)  # the ball-query towers' own kernels
    ball_stats["fps_by_shape"] = results.pop("fps_by_shape")
    ball_stats["host_us_a_call"] = results.pop("host_us_a_call")  # check_cloud's
    ball_stats["ball_query_gather_feats_other_dtype"] = results.pop(
        "ball_query_gather_feats_other_dtype")
    lap("7 ball-query towers")
    route_launches, route_stats = run_routes_slice()
    launches.update(route_launches)  # the other trunk routes' own kernels
    lap("8 trunk routes")
    long_launches, pretrain_stats = run_long_train_slice()
    # training through the long trunk: the pretraining window's count, the
    # prompt-tuning windows' beside it
    launches["flash_mha_bwd"] = long_launches["pretrain"]
    lap("9 long-trunk training")
    pb_launches, pb_stats = run_pretrain_pb_slice()
    launches.update(pb_launches)  # the dVAE's EMD step: approx_match
    lap("10 PointBERT pretraining")
    tool_launches, tool_stats = run_tools_slice()
    launches.update(tool_launches)  # the ablation probe's kernel
    lap("11 kernel tools")
    recipe_stats = run_recipes_slice(smi)  # its own counts, read per recipe
    lap("13 recipes")
    pretrained_stats = run_pretrained_slice(smi)  # its own counts, read per pass
    results["fps_batched"]["pointmlp_shapes"] = pretrained_stats["pn_mlp_fps"]
    results["fps_batched"]["pointmlp_launches_per_batch"] = (
        pretrained_stats["pn_mlp_validate"]["fps_batched_per_batch"])
    lap("14 pretrained")
    partseg_stats = run_partseg_slice(smi)  # its own counts, read per pass and per step
    for name, n in partseg_stats["validate"]["launches_per_batch"].items():
        results[name]["partseg_launches_per_batch"] = n
    results["mini_stats"]["partseg_launches_per_step"] = (
        partseg_stats["train_step_launches"]["mini_stats"])
    lap("15 partseg")
    probe_stats = run_probe_slice(smi)  # its own counts, read over feature_extract.main
    for name, n in probe_stats["extract"]["launches_per_batch"].items():
        results[name]["probe_launches_per_batch"] = n
    lap("16 probe")
    for name in SOURCES:
        if name in OFF_PATH_KERNELS:
            check(launches.get(name, 0) == 0, f"{name} is called by no module, yet was launched")
        else:
            check(launches.get(name, 0) > 0, f"{name} was launched on no path")

    prof_stats = run_profiles()
    lap("12 profiles")
    tools17_stats = run_tools17_slice(smi)  # its own counts, read in the loading process
    lap("17 tools")
    zoo_stats = run_zoo_slice(smi)  # its own counts, read per pass
    results["fps_batched"]["zoo_shapes"] = zoo_stats["fps_shapes"]
    results["fps_batched"]["zoo_launches_per_batch"] = {
        name: e["launches_per_batch"].get("fps_batched", 0)
        for name, e in zoo_stats["entries"].items()}
    lap("18 zoo")
    scene_stats = run_scenes_slice(smi)  # its own counts, read per step and per forward
    results["fps_batched"]["scene_shapes"] = scene_stats["fps_shapes"]
    results["fps_batched"]["scene_launches_per_step"] = {
        name: d["fps_batched_per_step"] for name, d in scene_stats["driver"].items()}
    lap("19 scenes")
    tier_stats = run_scenetier_slice(smi)  # its own counts, read per forward
    for name in ("fps_batched", "fused_vit_block"):
        results[name]["scenetier_launches_per_forward"] = {
            m: e["launches"].get(name, 0) for m, e in tier_stats["modules"].items()}
    lap("20 scene tier")
    mae_stats = run_mae_slice(smi)  # its own counts, read per step
    for name, row in mae_stats["kernels"].items():
        results[name]["mae"] = row
    for name, n in mae_stats["train"]["bf16"]["launches_per_step"].items():
        results[name]["mae_launches_per_step"] = n
    lap("21 mae")
    par_stats = run_parallel_slice(smi)  # the ranks' own counts, read per step
    for mode in ("dp", "tp", "pp"):
        for name, n in par_stats[mode]["rank0"]["launches"].items():
            results[name].setdefault("parallel_launches_per_step", {})[mode] = n
    lap("22 parallel")
    att, vit = sass["attention"], sass["vitblock"]
    results["mini_forward"]["sass"] = sass["mini"]["mini_forward_wgmma_kernel"]
    results["mini_stats"]["sass"] = sass["mini"]["mini_stats_wgmma_kernel"]
    results["fused_mha"]["sass"] = att["attention_wgmma_kernel"]
    results["flash_mha"]["sass"] = att["flash_fwd_wgmma_kernel"]
    results["flash_mha_bwd"]["sass"] = {k: v for k, v in att.items() if "flash_bwd" in k}
    for name in ("fused_vit_block", "fused_vit_block_readout", "fused_vit_tower", "vit_variant"):
        results[name]["sass"] = vit
    for name in TEXT_KERNELS:
        results[name]["sass"] = sass["text"]
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches.get(name, 0), **r))
        if name == "fused_text_tower":  # one kernel, two wrappers' counters
            kernels[-1]["launches_by_variant"] = text_stats["tower_launches_by_variant"]
        if name == "flash_mha_bwd":
            kernels[-1]["launches_by_path"] = long_launches
        print(f"[time] {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)}"
              f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(json.dumps({"text": text_stats}))
    print(json.dumps({"train": train_stats}))
    print(json.dumps({"ballquery": ball_stats}))
    print(json.dumps({"routes": route_stats}))
    print(json.dumps({"pretrain": pretrain_stats}))
    print(json.dumps({"pretrain_pb": pb_stats}))
    print(json.dumps({"tools": tool_stats}))
    print(json.dumps({"profile": prof_stats}))
    print(json.dumps({"recipes": recipe_stats}))
    print(json.dumps({"pretrained": pretrained_stats}))
    print(json.dumps({"partseg": partseg_stats}))
    print(json.dumps({"probe": probe_stats}))
    print(json.dumps({"tools17": tools17_stats}))
    print(json.dumps({"zoo": zoo_stats}))
    print(json.dumps({"sceneseg": scene_stats}))
    print(json.dumps({"scenetier": tier_stats}))
    print(json.dumps({"mae": mae_stats}))
    print(json.dumps({"parallel": par_stats}))
    print(json.dumps({"phase_seconds": laps}))
    print(json.dumps({"kernels": kernels, **slice_stats}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

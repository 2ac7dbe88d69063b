#!/usr/bin/env python3
"""Drive the PyTorch port's MF-ViT CA serving path (bf16, int8 W8A8 and
the XLA-level W8A8 trees of ``quantize_vit_params``; the reference
checkpoint layout and ``--attn-backend xla``), its ViT fine-tuning
path, its fusion training (``cli/fuse``, with the CA and the GPT head),
the ViT + CNN cross-attention head, its MoCo pretraining
(``cli/pretrain``), its data path (the device canvas store and the views
drawn on the card, which the training CLIs use by default, beside the
streaming and ``--aug-host`` feeds) and the whole-block kernel K15
(through ``tools/bench_block``) and the schedule variants T1-T7 (through
``tools/bench_mlp3d``, ``bench_pipelined``, ``bench_attn_pairs``,
``bench_rolling`` and ``bench_bwd_staged``) once on
an NVIDIA GPU, at 224 px and at 384 px (577 tokens: the long-sequence
path).

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, in order; any failure raises and exits non-zero:

1. environment: torch, CUDA, nvcc and Triton versions, the card's name and
   power limit (nvidia-smi); no CUDA -> exit 1 with no result;
2. build: the kernels of mfvit_tpu_torch/csrc, from source (build seconds);
3. every forward kernel (K1-K4) against its plain PyTorch version at
   serving shapes (ViT-S/16: B=8, N=197, D=384, 12 heads; fusion 3 heads
   of 128), bf16 inputs from a seeded generator, the plain version in fp32
   on the same bf16-rounded inputs: rel = max|diff| / max|ref| < 2e-2;
4. the serving slice through its entry point: 64 synthetic PNG pairs,
   vit_small and fusion weights from a seed, ``mfvit_tpu_torch.cli.infer.
   main`` at B=32 on the card; n, finite logits, launch counts (K1 24, K2
   22, K3 2, K4 1 per forward), and decision logits within rel 2e-2 of the
   plain path in bf16 on the card;
5. the int8 kernels K10 and K11 against their plain versions at vit_small
   block shapes (B=8 and B=32), a vit_base block (B=2, head_dim 64) and
   N=50 (B=8): bf16 x, int8 weights from ``quantize_weight_cols``; rel <
   2e-2 against the plain version in fp32 on the same values, and the
   branch (out - x) within I8_BRANCH_BAR of the plain version in bf16,
   a bar each of ``i8_controls`` (wrong versions of the kernel) must fail;
6. the int8 serving slice through its entry point: the same 64 pairs and
   checkpoint, ``infer.main`` with ``--int8`` at B=32; n, finite logits,
   launch counts (K10 24, K11 24, K4 1, every other kernel 0 per
   forward), top-1 agreement with the plain int8 path in bf16 on the card
   (I8_TOP1_MISSES says why no tighter end-to-end bar); then every K10/K11
   call of one int8 forward (48) held on its own input by the branch bars
   of phase 5, which every control must fail at every call; then
   checkpoint interop and ``--attn-backend`` (``run_interop``, vit_small,
   B=256): the ``save_serving`` file and the reference layout (``vits.py``
   branch ``.pth.tar``s, a ``Fus_CrossViT`` head) served alike bit for
   bit through K1-K4; whether ``tensorstore`` imports (if so a tree
   written in orbax's layout is read back, else ``infer`` on an orbax
   directory must exit naming the converter); ``infer
   --report-throughput`` on the kernel route and ``--attn-backend xla``
   (kernels, xla, xla, kernels): every kernel 0 on the XLA route, its
   decision logits within XLA_BAR of the kernels' in bf16 and within
   XLA_F32_BAR of the plain path in fp32, wrong attentions failing
   XLA_BAR, both routes' pairs/s and a profile of the XLA route; one
   ``finetune --attn-backend xla`` step, every kernel 0;
7. the stand-alone attention kernels K12 (packed qkv), K13 (B, H, N, dh)
   and K14 (transposed packed qkv) against their plain fp32 versions on
   the same bf16 values (rel < 2e-2) and against their plain bf16
   versions (fro_rel < MHSA_BAR, a bar each of ``mhsa_controls``, K1's
   rounding points, must fail) at vit_small (B=8, N=197, 12 heads of
   32), vit_small_ori (6 of 64), vit_base (D=768), head_dim 128 (N=300),
   N=50, N=376 and N=377 (the longest rows whose scores the core holds in
   shared memory, and the shortest it recomputes), N=577 and N=1025; K12
   equal to K14 bit for bit after the layout change (one core);
8. the XLA-level W8A8 path: vit_small MF-ViT CA from seeded weights, both
   branches through ``quantize_vit_params``, ``fused_forward`` at B=32 on
   the card: launch counts per paired forward K12 24, K4 1, every other
   kernel 0; finite logits; top-1 agreement with the plain path in bf16
   on all but I8_TOP1_MISSES pairs; then each of the 24 K12 calls of one
   forward held on its own input by both bars of phase 7; then the same
   at 384 px, B=4 (K12 at N=577);
9. the backward kernels K5 and K7 (K7 also through K3's backward) against
   their plain versions, all seven (nine) outputs, at vit_small block
   shapes (B=8 and B=32) and vit_base block shapes (B=2, D=768, 12 heads, hidden
   3072); bf16 inputs and cotangent, the plain backward in fp32 on the same
   values; rel < 2e-2 per output;
10. the training slice through its entry point: 64 synthetic PNGs in a
   ``--covid-ds`` layout and a MoCo ``.pth.tar`` from seeded weights;
   ``mfvit_tpu_torch.cli.finetune.main`` with ``-a vit_small
   --semi-supervised -b 32 --epochs 2 --draws 1`` (FT): the loss finite at
   every step, launch counts per step (K1 12, K2 11, K3 1, K5 12, K7 12)
   plus one forward per eval batch, the backbone changed; then LP (no
   ``--semi-supervised``): the CLI's frozen-backbone check passes and K5/K7
   count 0;
11. train-step parity: the kernel path and the plain path (bf16 on the
   card) from the same vit_small weights and batch (B=32), three SGD steps
   each: the loss per step within rel 1e-2, and each block's flattened
   first-step gradient within rel 5e-2;
12. the probe of K15's GEMM core: ``mfv_gemm_sm90`` (wgmma) beside
   ``gemm_ln`` (WMMA, K1's and K2's) on the same bf16 inputs at K1's qkv
   and K2's fc1 and fc2 shapes (B=8; bias, GELU, and bias + residual
   epilogues): the outputs that differ are printed and must be 0, each
   core within rel 2e-2 of the plain fp32 version; its MN-major forms
   (``mfv_gemm_mn``: K5's and K7's NN products dO, dh, dh1 and TN weight
   gradients dWqkv, dW1, dW2 with their column sums, over
   ``launch.k_split``'s slices) beside gemm_bwd.cuh's WMMA GEMMs
   (``mfv_gemm_bwd``, their former chains') at B=8 and B=256 (blocks that
   walk two tiles or more, each of more K stages than the ring holds): the
   outputs that differ must be 0, each within rel 2e-2 of plain fp32;
   then K5, K7 and K3's backward against the chains K5 and K7 ran before
   their redesign (the check-only ``fused_attention_block_bwd_wmma`` and
   ``fused_mlp_block_bwd_wmma``) at vit_small B=8, 32 and 256, vit_base
   B=2 and 16, N=50 at head_dim 32, 64 and 128 and head_dim 128 at N=208
   and 256: the outputs that differ, over all seven, must be 0, each
   within rel 2e-2 of the plain fp32 backward; then K1 and K2 against
   the chains they ran before their redesign (the check-only
   ``fused_attention_block_wmma`` and ``fused_mlp_block_wmma``: gemm_ln's
   WMMA GEMMs and attn_core.cuh's core) at K15's shapes, B=3 (a partial
   last row tile), D=128, 256 and 512, a vit_base block (D=768, K2's
   three-launch route), N=50 at B=64 and vit_base at B=16 (blocks that
   walk several attention pairs or GEMM tiles of more K slices than the
   ring holds): the outputs that differ must be 0, each within
   rel 2e-2 of its plain fp32 version, one launch of its own kernel a
   call; then K3 and K4 against their former designs (the check-only
   ``fused_mlp_block_final_ln_wmma`` and ``fused_fusion_cls_kv``): K3 at
   the same shapes, the outputs that differ 0; K4 at B=1, 3, 8 and 256,
   N=197 and 50, D=384 (3 heads) and 768 (3 and 12 heads), and at N=577
   (B=64 at D=384, B=16 at D=768, 3 heads): rel below
   K4_FORMER_BAR, which each control (``k4_controls``: u from W_v, the
   score scale undone) must fail; each within rel 2e-2 of its plain
   fp32 version, one launch of its own kernel a call; then K15 against the
   K1 -> K2 kernel chain on the same bf16 inputs (equal bit for bit) and its plain fp32 version (rel < 2e-2), its 13 gradients
   (``torch.autograd.grad``: K1's forward recomputed, K7, K5) against the
   plain fp32 backward (rel < 2e-2 each), at vit_small, vit_small_ori,
   N=50 and head_dim 128 (B=8), non-zero biases; launch counts K15 1 and
   every other kernel 0 per forward, K15, K1, K7 and K5 1 each per
   forward and backward; the vit_base block (D=768) refused with its
   ValueError;
13. K15's entry point, ``mfvit_tpu_torch.tools.bench_block`` (B=512, 12
   blocks, the K1 -> K2 chain and the K15 chain): launch counts K15, K1,
   K2 12 per chain of theirs, every other kernel 0; equal checksums; then
   one block on the tool's inputs: K15 within rel 2e-2 of its plain fp32
   version and equal to the K1 -> K2 pair bit for bit;
14. the schedule variants T6 (``mlp3d``, flat and per image), T7
   (``mlp3d_staged``), T3 (``mlp_pipe``), T4 (``attn_staged``), T1
   (``attn_pairs``), T2 (``attn_rolling``) and T5 (``staged_bwd``) at
   vit_small (B=8), N=50, B=3 (a ragged last row tile; T1, whose cb is
   even, skips it), B=6 (T1 at cb=2) and D=512, the attention variants
   also at vit_small_ori, head_dim 128 and head_dim 128 at N=208 (their
   limit), at every schedule argument their tools sweep (``mlp_pipe``'s
   with its controls, splits=1 at tm=128 and tm=64), non-zero biases (b2
   included), T5 on a bf16 cotangent: equal to K2 (T4, T1, T2: K1; T5: K5
   on all seven outputs) bit for bit, T6, T7 and T3 (on K2's tail), T2, T4,
   T1 and T5 (on K1's and K5's asynchronous cores and their siblings) also
   to their former designs (``mlp3d_wmma``, ``mlp3d_staged_wmma``,
   ``mlp_pipe_mma`` at its own default, ``attn_staged_wmma``,
   ``attn_pairs_wmma``, ``attn_rolling_wmma``, ``staged_bwd_former``), and
   within rel
   2e-2 of the plain fp32 version (each output); one call launches the
   variant once and no other kernel; every shape and argument the ops refuse (cb not dividing B, an
   odd cb for T1, (tm, splits) outside T3's set or tm=128 at D=512, D=768, head_dim
   128 past 208 tokens, a weight that requires grad) raises;
15. their entry points, ``mfvit_tpu_torch.tools.bench_mlp3d``,
   ``bench_pipelined``, ``bench_attn_pairs`` and ``bench_rolling`` (B=512,
   12 blocks) and ``bench_bwd_staged`` (B=256, chains of 12 backwards, dx
   fed back as g), the JAX tools' chains in their order: launch counts
   per tool equal to what its chains launch (and the bwd tool's agreement
   run, one K5 and one T5), every other kernel 0; every chain's checksum
   equal to the baseline's, and T5's agreement with K5 0 on every output;
   then one 12-block ``mlp3d staged cb=4`` chain: ``mlp3d_staged`` 12, K1
   12; then one block (T5: one backward, B=256) on the tools' inputs
   (B=512; the MLP variants on K1's output) at every argument the tools
   sweep: each variant equal to K2 (T4, T1, T2: K1; T5: K5) bit for bit
   (and to its former design) and within rel 2e-2
   of its plain fp32 version (the kernel report's
   error for the variants is from this run);
16. the fusion-training slice through ``mfvit_tpu_torch.cli.fuse.main``:
   64 synthetic pairs, both vit_small branches from seeded files with
   non-zero biases, B=32, one epoch; LP then ``--semi-supervised``: finite
   losses, launch counts per step (K1 24, K2 22, K3 2, K4 1, and K5 24, K7
   24 under ``--semi-supervised`` only) plus one paired forward per eval
   batch, the LP sanity-check line under LP only, ``model_best`` equal to
   the last state; then ``infer.main`` on that ``model_best`` over the 32
   val pairs: decision logits equal to ``eval_step`` on that state;
17. fusion train-step parity: kernel path and plain path (bf16 on the
   card) from the same weights and batch (B=32), three Adam steps, LP and
   ``--semi-supervised``: loss per step within rel 1e-2, the first-step
   gradient of the head and of each branch block within rel 5e-2; then
   phases 16 and 17 again under ``--fusion-arch gpt`` (the joint-sequence
   GPT head at its defaults: 8 blocks, 4 heads of 96, 394 tokens): per
   step and per eval batch the same counts with K4 0, ``infer
   --fusion-arch gpt`` on its ``model_best`` equal to ``eval_step``; and
   the ViT + CNN cross-attention head (``models.crossvit_cnn.
   fused_forward``: vit_small, resnet18, B=32): logits within rel 2e-2 of
   the plain path, K1 12, K2 11, K3 1 launched;
18. MoCo pretraining through ``mfvit_tpu_torch.cli.pretrain.main``:
   64 synthetic images, vit_small at full width from a seed, MoCo's
   default heads (projector 384 -> 4096 -> 4096 -> 256, predictor) and
   K=65536 queue, the v2 queue loss with the predictor on the keys, LARS
   with the warmup-cosine LR and the momentum ramp, B=32, two epochs (four
   steps), ``--export-torch``: finite losses, launch counts per step (K1
   24, K2 22, K3 2 over both towers, K5 12, K7 12 in the query tower's
   backward, every other kernel 0), the queue pointer at 4 x 32 mod K, and
   the exported ``.pth.tar`` read back through
   ``load_moco_pretrained_backbone`` equal to the base encoder; then three
   steps of the kernel path against the plain path (bf16 on the card, B=32)
   from the same state and batch: the loss per step within rel 1e-2, each
   query-tower block's gradient within rel 5e-2 with both encoders under
   the plain step's cotangent on their CLS features (the whole step's
   gradients, the CLS features and the enqueued keys printed beside,
   ungated: at random init the heads' BatchNorm-ReLU layers turn bf16
   rounding differences of the features into far larger ones); then one
   step each of ``--loss v3_symmetric`` (K1 48, K2 44, K3 4, K5 24, K7 24),
   vit_conv_small (11 blocks: K1 22, K2 20, K3 2, K5 11, K7 11) and
   resnet50 (no kernel of the port): finite losses and those counts;
   then ``pretrain.main`` under each of MoCo's other inputs (64 synthetic
   image pairs, B=32, two epochs): ``--in-chans 4`` (the stacked CXR-gray
   + Enh canvases), ``--aug-setting moco_v2 --crop-min 0.2`` (the BYOL
   aug2 stack's host floats) and ``--pairing enh_cxr --per-enh 0.5`` (q
   the enhanced image or the CXR, k the CXR, host floats): four finite
   losses, the launch counts per step of the first run exactly, every
   other kernel 0, the queue pointer at 128, a (384, 4, 16, 16) patch
   weight under ``--in-chans 4``; the three-step parity above on a
   4-channel vit_small state, at the same bars; and the e2e twin
   (``mfvit_tpu_torch.tools.e2e_workflow`` at vit_small, 224 px: pretrain
   ``--export-torch``, LP ``finetune`` from its ``.pth.tar``, ``fuse``
   from the LP ``model_best``, ``infer`` on fuse's): infer's metrics
   present and finite, K1, K3, K4 and K5 launched on the way, and its
   second half through the device canvas store (pretrain and LP finetune
   at the square resize, each store notice printed); the fuse and
   pretrain runs above train from the store too, at their default flags
   (its notice gated: 64 samples, none for the host-float inputs);
19. the data path: the store's training views on the card
   (``data/device_aug.py``: flip, rotation about the full canvas, crop,
   one gather, then the normalisation table) against their CPU versions
   given the same draws, B=256, 224 -> 224 and 256 -> 224, 3 and 4
   channels, one view and both views of ``augment_two_views_canvas``:
   each equal to its seeded replay bit for bit, and to the CPU version
   but for at most VIEW_TIE_PIXELS pixels within VIEW_TIE of a rounding
   tie (printed); the card generator's draws (corners over [0, 32] with
   both ends hit, flips at half, angles over [-10, 10), replayed); then
   ``finetune --semi-supervised`` at vit_small, B=16, two epochs over 128
   images, at the default flags (the store), ``--device-store-mb 0`` and
   ``--aug-host``: the exact launch counts of each, under
   ``torch.profiler`` no host-to-device copy above H2D_STEP_BYTES inside
   the store run's steps (the streaming run's, which must carry more, as
   the control), and the val logits through the eval store equal to the
   streaming eval's (max |diff| 0.0); then times: the view's ms at B=256,
   and the CLIs' own images/s (pairs/s) in their second epoch over 1,024
   synthetic images, ``finetune`` FT at B=16 and B=256, ``fuse`` LP and
   ``pretrain`` at B=32, each on the store, ``--device-store-mb 0`` and
   ``--aug-host`` (A B C C B A), and the fill's seconds per 1,000 images;
   then ``ddp`` (``run_ddp``): ``finetune`` FT and ``pretrain`` (the v2
   queue) at vit_small, B=256, on the store, plain and under the
   ``--dist-*`` flags on a one-process NCCL group (plain, group, group,
   plain): per run the exact launches of the plain run (K1-K3, K5, K7),
   an all-reduce on the group, the epoch-2 images/s; then two gloo ranks
   on cuda:0 from ``parallel.dist`` (``gloo_two_ranks``: three FT steps
   and three MoCo steps with BatchNorm heads, of the v2 queue on the
   kernel path in bf16 and of the v2 queue and v3 on the plain path in
   fp32, at B=32,
   against one process within ``train_parity``'s bars, the BN running
   statistics and the queue too (MoCo's gradients by their Frobenius
   error: a flipped ReLU rewrites one unit's row; in bf16 the keys of
   steps 2-3 printed), the ranks' states
   equal bit for bit), the phase's seconds;
20. times with CUDA events at B=256: each forward kernel (K10/K11
   included) and K5/K7 against its plain version (K5/K7 first held
   against the plain fp32 backward on the timed inputs), K5/K7 also at a
   vit_base block (B=64, D=768, hidden 3072: the widths of K6 and K8),
   and their launches one by one beside their former chains' under
   ``torch.profiler`` (``stage_times`` "k5", "k7", "k5_wmma", "k7_wmma"),
   K12, K13 and K14 against their plain versions and SDPA on the same
   values (for K14 on contiguous copies, the transposes counted; also at
   N=577, B=64), the end-to-end pairs/s of serving,
   kernel path against plain path, int8 against bf16 on the kernel path
   and the XLA-level W8A8 path against its plain path, the bf16 path and
   the int8 path, and the images/s of the FT train
   step, kernel path against plain path; the FT step also at B=16, the
   finetune CLI's default batch; K15 against the K1 -> K2 pair, its
   plain version and the library block (``nn.TransformerEncoderLayer``
   in inference mode on K15's weights, first held within rel 2e-2 of the
   plain fp32 version) at B=256, then K15's launches one by one under
   ``torch.profiler`` (``tools/compare_block.py::stage_times``), K1, K2,
   K3 and K4 against their former designs (kernel, former, former,
   kernel) and the launches of all eight one by one, and the
   GEMM cores alone at K1's qkv and K2's fc1 shapes (B=256; ms and
   TFLOP/s, wgmma against gemm_ln); the pairs/s of the fusion train step, LP and
   ``--semi-supervised``, kernel against plain path, at B=32 (the fuse
   CLI's default) and B=256, and with the GPT head at B=32; the GPT
   head's serving pairs/s at B=256 beside the CA head's, and the head
   alone at B=256 and 32 (forward, forward + backward, a
   ``torch.profiler`` breakdown by operator); each schedule variant at each argument its
   tool sweeps against its base kernel (variant, base, base, variant) and
   K1's, K2's and K5's plain versions, at B=256; the images/s of the
   MoCo v2-queue step, kernel against plain path, at B=256 and at B=16
   (the pretrain CLI's default), at B=256 also on 4-channel images, and a
   ``torch.profiler`` breakdown of the step at B=256 by operator; the
   images/s of each pretrain feed alone on the host (B=32: the default
   canvases, the 4-channel canvases, moco_v2's and enh_cxr's host
   floats; host-bound, the card untouched);
21. the long-sequence kernels: K9 against its plain fp32 version (rel <
   2e-2) at vit_small@384 (B=2, N=577, D=384, 12 heads), vit_small_ori@512
   (N=1025, 6 heads), vit_base@384 (D=768), head_dim 128 (N=300, 3 heads)
   and N=257, the first length past K1; K10 past 256 tokens
   (vit_small_ori@384: B=2, N=577, 6 heads) against its plain fp32
   version and on its branch bar, which the ``i8_controls`` must fail;
   then K9 and K11 against the chains they ran before their redesign (the
   check-only ``fused_attention_block_large_wmma``: gemm_ln's WMMA GEMMs
   and attn_long.cuh's core; ``fused_mlp_block_i8_mma``: gemm_i8.cuh's
   mma.sync GEMMs): K9 at vit_small@384 (B=2 and 64), vit_small_ori@512,
   vit_base@384, head_dim 128 at N=300 and 577, N=257 and N=1025 at
   head_dim 32; K11 at the shapes of phase 5, vit_small@384 (B=8), B=256
   and vit_base at B=64 (D=768, its four launches), and at vit_small B=8
   with fc1's weights scaled by 0.05 and by 1e-4 with b1 = 2 (the rows
   whose GELU max the tail's first pass takes on every value, and near
   ties): the outputs that
   differ must be 0, each within rel 2e-2 of its plain fp32 version, one
   launch of its own kernel a call; then K10 against the chain it ran
   before (the check-only ``fused_attention_block_i8_mma``: gemm_i8.cuh's
   mma.sync GEMMs, attn_core.cuh's or attn_long.cuh's core) at vit_small
   B=8, 32 and 256, vit_base B=2 and 64, N=50, 256 and 257,
   vit_small_ori@384 B=2 and 64 and head_dim 128 (N=300), by the op and on
   each of its two routes forced (``fused_attention_block_i8_route``): 0
   outputs differ, rel < 2e-2 against the plain fp32 version, the branch
   bar of phase 5, one launch of K10 a call of the op and none forced;
22. the serving slice at 384 px: 32 synthetic pairs, the checkpoint of
   phase 4 (saved at 224 px), ``infer.main`` with ``--img-size 384 --crop
   384`` at B=16; launch counts per forward K9 24, K2 22, K3 2, K4 1,
   every other kernel 0; decision logits within rel 2e-2 of the plain
   path in bf16;
23. the same with ``--int8``: the attention half of every block is K9 on
   the dequantized weights (the JAX package's route at vit_small@384);
   launch counts K9 24, K11 24, K4 1, K10 0; top-1 agreement with the
   plain int8 path on all but one pair;
24. FT at 384 px through ``finetune.main`` (B=8, one epoch over 32
   images): the loss finite at every step, launch counts per step K9 12,
   K2 11, K3 1, K7 12 and K5 0 (K9's backward is the fp32 recompute, plain
   PyTorch) plus one forward per eval batch, the backbone changed; then
   three-step train parity with the plain path (B=8);
25. times at 384 px: K9 and its plain version at vit_small@384 (B=64) and
   vit_small_ori@512 (B=16), K10 past 256 tokens (vit_small_ori@384), K2
   and K11 at vit_small@384 (B=64), K10 and K11 at vit_base (B=64) against
   their plain versions, the launches of K9, K10 and K11 and of their
   former chains one by one (``stage_times``: K9 at both its shapes, K11
   at vit_small B=256 and vit_base B=64, K10 at B=256, at 577 tokens and
   at vit_base B=64, its former chain at B=256), the serving pairs/s at
   B=64 (kernel path against plain path, int8 against bf16 and the
   XLA-level W8A8 path), the FT step's images/s at B=32 and K9's backward
   (the fp32 recompute) at B=32.

The last three lines are the end-to-end numbers, the kernel report (one
JSON object) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REL_BAR = 2e-2
# K10/K11 are held on their branch, out - x, against the plain int8 version
# in bf16 on the same input, which rounds where the kernels do: branch_rel
# below the kernel's bar. Where the fp32 sums of kernel and plain version
# run in different orders, a value near a rounding tie lands on the other
# side and flips an int8 code by one; those flips set the sound readings
# (K10 up to about 3e-3, K11 up to about 4e-4 on the H100). Each bar sits
# between them and the controls (``i8_controls``), wrong versions of the
# kernel that must fail it wherever the kernel is held.
I8_BRANCH_BAR = {"fused_attention_block_i8": 6e-3, "fused_mlp_block_i8": 2e-3}
# The int8 decision logits cannot be held tightly end to end: with random
# weights the one-code flips compound over 24 quantized block halves, so
# the int8 kernel path lies about as far from the plain int8 path (rel
# 2.6e-2-3.0e-2) as the bf16 path does (3.1e-2-4.0e-2). The end-to-end
# gate is top-1 agreement with the plain int8 path on all but
# I8_TOP1_MISSES pairs, which catches gross faults (one near-tie may
# flip); the per-call check along the path holds the kernels tightly.
I8_TOP1_MISSES = 1
# K12-K14 are also held against their plain version in bf16, which rounds
# where the kernels do: fro_rel = ||kernel - plain|| / ||plain|| below
# MHSA_BAR. There only the order of the fp32 sums differs, which flips a
# rare bf16 rounding of P or of the output (readings up to about 1.3e-4 on
# the H100). K1's rounding points in place of the TPU kernels'
# (``mhsa_controls``) read 1.1e-3-3.5e-3, about as far as the plain bf16
# version lies from the plain fp32 one, so REL_BAR cannot tell them; they
# must fail MHSA_BAR wherever a kernel is held.
MHSA_BAR = 4e-4
# K4 is held against its former design (the check-only
# ``fused_fusion_cls_kv``, k and v of every row): both sum in fp32 with the
# same bf16 rounding points, in other orders and associations, and the
# former normalises the CLS row for q in another order than for its k/v
# row, so a bf16 rounding of xn_0 may land on the other side of a tie.
# On the H100 sound runs read at most 7.4e-5 (max|diff| / max|ref|) and
# the controls (``k4_controls``: u from W_v in place of W_k, the score
# scale undone) 6.5e-2 and more; each control must fail the bar wherever
# K4 is held.
K4_FORMER_BAR = 2e-4
PARITY_LOSS_BAR, PARITY_GRAD_BAR = 1e-2, 5e-2
KERNELS = [  # name, CUDA source, the Pallas kernel body it replaces
    ("fused_attention_block", "mfvit_tpu_torch/csrc/fused_attn.cu",
     "mfvit_tpu/ops/fused_attn.py:28"),
    ("fused_mlp_block", "mfvit_tpu_torch/csrc/fused_mlp.cu",
     "mfvit_tpu/ops/fused_mlp.py:62"),
    ("fused_mlp_block_final_ln", "mfvit_tpu_torch/csrc/fused_mlp.cu",
     "mfvit_tpu/ops/fused_mlp.py:137"),
    ("fused_fusion_cls", "mfvit_tpu_torch/csrc/fused_fusion.cu",
     "mfvit_tpu/ops/fused_fusion.py:85"),
    ("fused_attention_block_bwd", "mfvit_tpu_torch/csrc/fused_attn_bwd.cu",
     "mfvit_tpu/ops/fused_attn.py:385"),
    ("fused_mlp_block_bwd", "mfvit_tpu_torch/csrc/fused_mlp_bwd.cu",
     "mfvit_tpu/ops/fused_mlp.py:246"),
    ("fused_attention_block_i8", "mfvit_tpu_torch/csrc/fused_int8.cu",
     "mfvit_tpu/ops/fused_int8.py:168"),
    ("fused_mlp_block_i8", "mfvit_tpu_torch/csrc/fused_int8.cu",
     "mfvit_tpu/ops/fused_int8.py:100"),
    ("fused_attention_block_large", "mfvit_tpu_torch/csrc/fused_attn_large.cu",
     "mfvit_tpu/ops/fused_attn.py:244"),
    ("mhsa_packed", "mfvit_tpu_torch/csrc/mhsa.cu",
     "mfvit_tpu/ops/attention.py:181"),
    ("mhsa", "mfvit_tpu_torch/csrc/mhsa.cu", "mfvit_tpu/ops/attention.py:78"),
    ("mhsa_packed_t", "mfvit_tpu_torch/csrc/mhsa.cu",
     "mfvit_tpu/ops/attention.py:295"),
    ("fused_transformer_block", "mfvit_tpu_torch/csrc/fused_block.cu",
     "mfvit_tpu/ops/fused_block.py:36"),
]
# the schedule variants of the JAX harness's tools: name, CUDA source, the
# Pallas kernel body it replaces, the kernel whose function it computes
VARIANTS = [
    ("mlp3d", "mfvit_tpu_torch/csrc/mlp3d.cu",
     "tools/bench_mlp3d.py:39", "fused_mlp_block"),
    ("mlp3d_staged", "mfvit_tpu_torch/csrc/mlp3d.cu",
     "tools/bench_mlp3d.py:138", "fused_mlp_block"),
    ("mlp_pipe", "mfvit_tpu_torch/csrc/mlp_pipe.cu",
     "tools/bench_pipelined.py:43", "fused_mlp_block"),
    ("attn_staged", "mfvit_tpu_torch/csrc/attn_staged.cu",
     "tools/bench_pipelined.py:118", "fused_attention_block"),
    ("attn_pairs", "mfvit_tpu_torch/csrc/attn_pairs.cu",
     "tools/bench_attn_pairs.py:37", "fused_attention_block"),
    ("attn_rolling", "mfvit_tpu_torch/csrc/attn_rolling.cu",
     "tools/bench_rolling.py:35", "fused_attention_block"),
    ("staged_bwd", "mfvit_tpu_torch/csrc/attn_bwd_staged.cuh",
     "tools/bench_bwd_staged.py:37", "fused_attention_block_bwd"),
]
ATTN_VARIANTS = ("attn_staged", "attn_pairs", "attn_rolling")
# the variants redesigned on K2's tail (T6, T7, T3) and on K1's and K5's
# asynchronous cores and their siblings (T2, T4, T1, T5), and their former
# designs (check-only ops of ops/mlp_variants.py and ops/attn_variants.py
# that count no launch)
FORMER_VARIANTS = {"mlp3d": "mlp3d_wmma", "mlp3d_staged": "mlp3d_staged_wmma",
                   "mlp_pipe": "mlp_pipe_mma",
                   "attn_staged": "attn_staged_wmma",
                   "attn_pairs": "attn_pairs_wmma",
                   "attn_rolling": "attn_rolling_wmma",
                   "staged_bwd": "staged_bwd_former"}


def former_kw(name: str, kw: dict, D: int) -> dict:
    """The schedule arguments a former design takes for ``kw``: T3's
    former design runs at its own default (tm=32 at D=512, where its
    (64, D) fp32 tile passes the registers; every argument of both gives
    K2's bits), the others at ``kw``."""
    if name != "mlp_pipe":
        return kw
    return {} if D <= 384 else dict(splits=2, tm=32)
KERNELS += [v[:3] for v in VARIANTS]
MHSA = ("mhsa_packed", "mhsa", "mhsa_packed_t")  # K12, K13, K14
PER_FORWARD = {"fused_attention_block": 24, "fused_mlp_block": 22,
               "fused_mlp_block_final_ln": 2, "fused_fusion_cls": 1}
# one vit_small forward (12 blocks) and one FT training step
PER_VIT_FORWARD = {"fused_attention_block": 12, "fused_mlp_block": 11,
                   "fused_mlp_block_final_ln": 1}
PER_FT_STEP = {"fused_attention_block_bwd": 12, "fused_mlp_block_bwd": 12}
# one int8 paired forward (--int8)
PER_I8_FORWARD = {"fused_attention_block_i8": 24, "fused_mlp_block_i8": 24,
                  "fused_fusion_cls": 1}
# the same at 384 px (577 tokens): K9 in place of K1; the int8 attention
# half is K9 on the dequantized weights, K10 does not run
PER_FORWARD_384 = {"fused_attention_block_large": 24, "fused_mlp_block": 22,
                   "fused_mlp_block_final_ln": 2, "fused_fusion_cls": 1}
PER_I8_FORWARD_384 = {"fused_attention_block_large": 24,
                      "fused_mlp_block_i8": 24, "fused_fusion_cls": 1}
PER_VIT_FORWARD_384 = {"fused_attention_block_large": 12,
                       "fused_mlp_block": 11, "fused_mlp_block_final_ln": 1}
PER_FT_STEP_384 = {"fused_mlp_block_bwd": 12}
# one paired forward of the XLA-level W8A8 path (quantize_vit_params), at
# 224 and 384 px
PER_QUANT_FORWARD = {"mhsa_packed": 24, "fused_fusion_cls": 1}
# one fusion training step (cli/fuse): the paired forward, and under
# --semi-supervised the backward of both branches (K4's backward is its
# plain recompute); one K15 forward and backward (K1 recompute, K7, K5)
PER_FUSION_STEP = {False: PER_FORWARD,
                   True: dict(PER_FORWARD, fused_attention_block_bwd=24,
                              fused_mlp_block_bwd=24)}
# the same under --fusion-arch gpt: the GPT head is plain PyTorch (XLA in
# JAX), so K4 never runs; both branches take the per-branch route
PER_GPT_FORWARD = {k: v for k, v in PER_FORWARD.items()
                   if k != "fused_fusion_cls"}
PER_GPT_FUSION_STEP = {semi: {k: v for k, v in c.items()
                              if k != "fused_fusion_cls"}
                       for semi, c in PER_FUSION_STEP.items()}
# the paired forward and the fusion step of each --fusion-arch
PER_ARCH_FORWARD = {"ca": PER_FORWARD, "gpt": PER_GPT_FORWARD}
PER_ARCH_STEP = {"ca": PER_FUSION_STEP, "gpt": PER_GPT_FUSION_STEP}
PER_K15_FWD = {"fused_transformer_block": 1}
PER_K15_FWD_BWD = {"fused_transformer_block": 1, "fused_attention_block": 1,
                   "fused_mlp_block_bwd": 1, "fused_attention_block_bwd": 1}
# the kernels of one block of tools/bench_block's chains, each once
PER_BENCH_BLOCK = {"fused_transformer_block": 1, "fused_attention_block": 1,
                   "fused_mlp_block": 1}
# per paired forward, by (img, int8); per ViT forward and FT step, by img
PER_PAIR = {(224, False): PER_FORWARD, (224, True): PER_I8_FORWARD,
            (384, False): PER_FORWARD_384, (384, True): PER_I8_FORWARD_384}
PER_VIT = {224: PER_VIT_FORWARD, 384: PER_VIT_FORWARD_384}
PER_STEP = {224: PER_FT_STEP, 384: PER_FT_STEP_384}
# the H100 SXM's published dense peaks at 700 W (NVIDIA data sheet)
PEAK = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12,
        # exp2 on the special function units: 16 results a clock on each
        # of 132 SMs at the 1.98 GHz boost clock (Hopper white paper)
        "sfu": 132 * 16 * 1.98e9}
HBM_BYTES_PER_S = 3.35e12


def rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def fro_rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return ((got - ref).norm() / ref.norm()).item()


def branch_rel(got, ref, x) -> float:
    """The error of a residual block's branch against the branch's own
    size, ||got - ref|| / ||ref - x|| in fp32: the residual x, which is
    most of the output, cancels."""
    got, ref, x = got.float(), ref.float(), x.float()
    return ((got - ref).norm() / (ref - x).norm()).item()


T0 = time.perf_counter()


def phase(name: str) -> None:
    torch.cuda.synchronize()
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def environment() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    from mfvit_tpu_torch.ops import build
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not importable")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    full_precision_sums()
    print("allow_tf32: matmul False, cudnn False; "
          "allow_bf16_reduced_precision_reduction: False")
    return smi[0]


def full_precision_sums() -> None:
    """The plain references' settings, in this process and in every rank
    it spawns: fp32 in full fp32, bf16 GEMMs with fp32 sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def block_inputs(g, B, D, dev, N=197):
    """One block's bf16 activations and weights, scaled so the attention
    and MLP branches are O(1) against the residual."""
    def r(*s, std=1.0):
        return (torch.randn(*s, generator=g) * std).to(dev)
    return dict(
        x=r(B, N, D).bfloat16(), ln_s=1 + r(D, std=0.1),
        ln_b=r(D, std=0.1), wqkv=r(3 * D, D, std=D ** -0.5).bfloat16(),
        bqkv=r(3 * D, std=0.1), wproj=r(D, D, std=D ** -0.5).bfloat16(),
        bproj=r(D, std=0.1), w1=r(4 * D, D, std=D ** -0.5).bfloat16(),
        b1=r(4 * D, std=0.1), w2=r(D, 4 * D, std=(4 * D) ** -0.5).bfloat16(),
        b2=r(D, std=0.1), fs=1 + r(D, std=0.1), fb=r(D, std=0.1))


def fusion_inputs(g, B, D, dev, N=197):
    def r(*s, std=1.0):
        return (torch.randn(*s, generator=g) * std).to(dev)
    flat = []
    for _ in range(2):
        flat += [1 + r(D, std=0.1), r(D, std=0.1),
                 r(D, D, std=D ** -0.5).bfloat16(),
                 r(2 * D, D, std=D ** -0.5).bfloat16(),
                 r(D, D, std=D ** -0.5).bfloat16(), r(D, std=0.1),
                 1 + r(D, std=0.1), r(D, std=0.1)]
    return r(B, N, D).bfloat16(), r(B, N, D).bfloat16(), flat


ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")


def kernel_calls(t, heads, tok_c, tok_e, flat, fusion_heads):
    """name -> (kernel call, plain call in the inputs' dtype, plain call in
    fp32 on the same values)."""
    from mfvit_tpu_torch.ops import fused_fusion as ff
    from mfvit_tpu_torch.ops import fused_mlp as fm
    m = [t[k] for k in MLP]
    m32 = [v.float() for v in m]
    f32 = [v.float() for v in flat]
    fin = (t["fs"], t["fb"])
    return {
        **base_calls(t, heads),
        "fused_mlp_block_final_ln": (
            lambda: fm.fused_mlp_block_final_ln(*m, *fin),
            lambda: fm.fused_mlp_block_final_ln_plain(*m, *fin),
            lambda: fm.fused_mlp_block_final_ln_plain(*m32, *fin)),
        "fused_fusion_cls": (
            lambda: torch.cat(ff.fused_fusion_cls(tok_c, tok_e, flat,
                                                  fusion_heads)),
            lambda: torch.cat(ff.fused_fusion_cls_plain(tok_c, tok_e, flat,
                                                        fusion_heads)),
            lambda: torch.cat(ff.fused_fusion_cls_plain(
                tok_c.float(), tok_e.float(), f32, fusion_heads))),
    }


def base_calls(t, heads: int) -> dict:
    """K1's and K2's (kernel, plain in the inputs' dtype, plain in fp32)
    on one block's inputs: the schedule variants' base kernels."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    scale = (t["x"].shape[-1] // heads) ** -0.5
    a, m = [t[k] for k in ATTN], [t[k] for k in MLP]
    a32, m32 = [v.float() for v in a], [v.float() for v in m]
    return {
        "fused_attention_block": (
            lambda: fa.fused_attention_block(*a, heads, scale),
            lambda: fa.fused_attention_block_plain(*a, heads, scale),
            lambda: fa.fused_attention_block_plain(*a32, heads, scale)),
        "fused_mlp_block": (
            lambda: fm.fused_mlp_block(*m),
            lambda: fm.fused_mlp_block_plain(*m),
            lambda: fm.fused_mlp_block_plain(*m32))}


def i8_ops():
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    return {"fused_attention_block_i8": fi8.fused_attention_block_i8,
            "fused_mlp_block_i8": fi8.fused_mlp_block_i8}


def i8_args(t, heads) -> dict:
    """name -> the arguments after x of K10 and K11, on the block's weights
    quantized per output channel."""
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    scale = (t["x"].shape[-1] // heads) ** -0.5
    q = {k: fi8.quantize_weight_cols(t[k]) for k in ("wqkv", "wproj", "w1",
                                                      "w2")}
    return {"fused_attention_block_i8": (
                t["ln_s"], t["ln_b"], *q["wqkv"], t["bqkv"], *q["wproj"],
                t["bproj"], heads, scale),
            "fused_mlp_block_i8": (
                t["ln_s"], t["ln_b"], *q["w1"], t["b1"], *q["w2"], t["b2"])}


def i8_calls(t, heads):
    """name -> (kernel call, plain call in the inputs' dtype, plain call in
    fp32 on the same values) for K10 and K11."""
    x, x32 = t["x"], t["x"].float()
    return {name: (lambda op=op, a=a: op(x, *a),
                   lambda op=op, a=a: op(x, *a, plain=True),
                   lambda op=op, a=a: op(x32, *a, plain=True))
            for (name, op), a in zip(i8_ops().items(),
                                     i8_args(t, heads).values())}


def i8_controls(name: str) -> dict:
    """label -> fn(x, a): wrong versions of K10 (``name`` its op) or K11,
    each the plain version with one fault: ``unquantized``, the plain bf16
    K1/K2 on the dequantized weights (no activation quantization); for
    K10 ``o in bf16``, the attention output rounded to bf16 before it is
    quantized (as K1 rounds it); for K11 ``h1 in bf16`` (K2's rounding
    point) and ``tanh GELU``."""
    import torch.nn.functional as F

    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    from mfvit_tpu_torch.ops import fused_mlp as fm

    @contextlib.contextmanager
    def patched(attr, value):
        old = getattr(fi8, attr)
        setattr(fi8, attr, value)
        try:
            yield
        finally:
            setattr(fi8, attr, old)

    def faulty(attr, value):
        def run(x, a):
            with patched(attr, value):
                return i8_ops()[name](x, *a, plain=True)
        return run

    dq = fi8.dequant_w
    if name == "fused_attention_block_i8":
        core = fi8.attn_core_plain
        return {
            "unquantized": lambda x, a: fa.fused_attention_block_plain(
                x, a[0], a[1], dq(a[2], a[3]), a[4], dq(a[5], a[6]), *a[7:]),
            "o in bf16": faulty("attn_core_plain",
                                lambda qkv, heads, scale, out_dtype=None:
                                core(qkv, heads, scale).float())}
    gelu = fi8._gelu
    return {
        "unquantized": lambda x, a: fm.fused_mlp_block_plain(
            x, a[0], a[1], dq(a[2], a[3]), a[4], dq(a[5], a[6]), a[7]),
        "h1 in bf16": faulty("_gelu", lambda h: gelu(h).bfloat16().float()),
        "tanh GELU": faulty("_gelu",
                            lambda h: F.gelu(h, approximate="tanh"))}


def hold_i8_branch(name: str, x, a, got) -> tuple:
    """The kernel's branch_rel against the plain int8 version in x's dtype
    on the same input, each control's ({label: rel}), and what fails: the
    kernel at or above its I8_BRANCH_BAR, or a control below it."""
    bar = I8_BRANCH_BAR[name]
    plain = i8_ops()[name](x, *a, plain=True)
    rk = branch_rel(got, plain, x)
    rcs = {k: branch_rel(fn(x, a), plain, x)
           for k, fn in i8_controls(name).items()}
    bad = [] if math.isfinite(rk) and rk < bar else [
        f"branch rel {rk} >= {bar}"]
    bad += [f"the control '{k}' passes (branch rel {v} < {bar}): the bar "
            "cannot tell it" for k, v in rcs.items() if not v >= bar]
    return rk, rcs, bad


def check_i8_kernels(dev) -> dict:
    """K10 and K11 at vit_small (B=8, B=32), vit_base (B=2) and N=50 block
    shapes: rel < REL_BAR against their plain fp32 versions, and the branch
    held by ``hold_i8_branch``. Every reading is printed before a failure
    raises. Returns the largest abs error at the vit_small shapes."""
    errs, bad = {}, []
    for label, B, N, D, heads in (("vit_small", 8, 197, 384, 12),
                                  ("vit_small", 32, 197, 384, 12),
                                  ("vit_base", 2, 197, 768, 12),
                                  ("N=50", 8, 50, 384, 12)):
        t = block_inputs(torch.Generator().manual_seed(3), B, D, dev, N=N)
        x, x32 = t["x"], t["x"].float()
        for name, a in i8_args(t, heads).items():
            op = i8_ops()[name]
            got = op(x, *a)
            torch.cuda.synchronize()
            ref = op(x32, *a, plain=True)
            r = rel(got, ref)
            err = (got.float() - ref).abs().max().item()
            rk, rcs, why = hold_i8_branch(name, x, a, got)
            where = f"{name} at {label} (B={B}, N={N}, D={D}, {heads} heads)"
            print(f"{where}: rel vs plain fp32 {r:.3e} (bar {REL_BAR}), "
                  f"max_abs_err {err:.3e}; branch rel vs plain bf16 {rk:.3e} "
                  f"(bar {I8_BRANCH_BAR[name]}); the controls' (must fail) "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rcs.items()))
            if not (math.isfinite(r) and r < REL_BAR):
                why.append(f"rel {r} >= {REL_BAR}")
            bad += [f"{where}: {w}" for w in why]
            if label == "vit_small":
                errs[name] = max(errs.get(name, 0.0), err)
    if bad:
        raise AssertionError("; ".join(bad))
    return errs


def check_long_kernels(dev) -> dict:
    """K9 at the shapes of the long-sequence path against its plain fp32
    version (rel < REL_BAR), and K10 past 256 tokens against its plain
    fp32 version and on its branch (``hold_i8_branch``). Every reading is
    printed before a failure raises. Returns the largest abs error of K9
    at vit_small@384."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    errs, bad = {}, []
    for label, B, N, D, heads in (("vit_small@384", 2, 577, 384, 12),
                                  ("vit_small_ori@512", 2, 1025, 384, 6),
                                  ("vit_base@384", 2, 577, 768, 12),
                                  ("head_dim 128", 2, 300, 384, 3),
                                  ("N=257", 2, 257, 384, 12)):
        t = block_inputs(torch.Generator().manual_seed(11), B, D, dev, N=N)
        a = [t[k] for k in ATTN]
        scale = (D // heads) ** -0.5
        got = fa.fused_attention_block_large(*a, heads, scale)
        torch.cuda.synchronize()
        ref = fa.fused_attention_block_plain(*[v.float() for v in a], heads,
                                             scale)
        r = rel(got, ref)
        err = (got.float() - ref).abs().max().item()
        x = t["x"].float()
        print(f"fused_attention_block_large at {label} (B={B}, N={N}, D={D}, "
              f"{heads} heads): rel {r:.3e} (bar {REL_BAR}), max_abs_err "
              f"{err:.3e} (the branch without the residual: rel "
              f"{rel(got.float() - x, ref - x):.3e})")
        if not (math.isfinite(r) and r < REL_BAR):
            bad.append(f"K9 at {label}: rel {r} >= {REL_BAR}")
        if label == "vit_small@384":
            errs["fused_attention_block_large"] = err
    name = "fused_attention_block_i8"
    t = block_inputs(torch.Generator().manual_seed(12), 2, 384, dev, N=577)
    x = t["x"]
    a = i8_args(t, 6)[name]
    got = i8_ops()[name](x, *a)
    torch.cuda.synchronize()
    r = rel(got, i8_ops()[name](x.float(), *a, plain=True))
    rk, rcs, why = hold_i8_branch(name, x, a, got)
    print(f"{name} at vit_small_ori@384 (B=2, N=577, D=384, 6 heads): rel vs "
          f"plain fp32 {r:.3e} (bar {REL_BAR}); branch rel vs plain bf16 "
          f"{rk:.3e} (bar {I8_BRANCH_BAR[name]}); the controls' (must fail) "
          + ", ".join(f"{k} {v:.3e}" for k, v in rcs.items()))
    if not (math.isfinite(r) and r < REL_BAR):
        why.append(f"rel {r} >= {REL_BAR}")
    bad += [f"K10 at N=577: {w}" for w in why]
    if bad:
        raise AssertionError("; ".join(bad))
    return errs


# K9 against its former chain: label, B, N, D, heads
LONG_FORMER_SHAPES = (("vit_small@384", 2, 577, 384, 12),
                      ("vit_small@384", 64, 577, 384, 12),
                      ("vit_small_ori@512", 2, 1025, 384, 6),
                      ("vit_base@384", 2, 577, 768, 12),
                      ("head_dim 128", 2, 300, 384, 3),
                      ("head_dim 128", 2, 577, 384, 3),
                      ("N=257", 2, 257, 384, 12),
                      ("N=1025, head_dim 32", 2, 1025, 384, 12))
# K11 against its former chain: ``check_i8_kernels``' shapes, vit_small@384
# and B=256 (the op's one-launch tail from I8T_TAIL_ROWS rows on, its four
# launches below; both routes are also forced at every D = 384 shape),
# vit_base (D=768: the four launches on the int8 wgmma core) at B=2 and
# B=64; then two inputs for the tail's first
# pass, which takes the GELU only of the values that can set a row's max
# (gemm_i8_sm90.cuh): fc1's weights scaled by 0.05 (a row's max below 0.5:
# every value taken) and by 1e-4 with b1 = 2 (near ties: many values within
# 1e-4 of the max). label, B, N, D, W1's scale, b1's value (None: as drawn)
I8_FORMER_SHAPES = (("vit_small", 8, 197, 384, 1.0, None),
                    ("vit_small", 32, 197, 384, 1.0, None),
                    ("vit_base", 2, 197, 768, 1.0, None),
                    ("N=50", 8, 50, 384, 1.0, None),
                    ("vit_small@384", 8, 577, 384, 1.0, None),
                    ("vit_small", 256, 197, 384, 1.0, None),
                    ("vit_base", 64, 197, 768, 1.0, None),
                    ("small fc1", 8, 197, 384, 0.05, None),
                    ("near ties", 8, 197, 384, 1e-4, 2.0))


def check_long_former(dev) -> dict:
    """K9 at LONG_FORMER_SHAPES and K11 at I8_FORMER_SHAPES against the
    chains they ran before (the check-only ``fused_attention_block_large_
    wmma`` and ``fused_mlp_block_i8_mma``): every rounding point and sum
    order kept, so the count of outputs that differ must be 0; each within
    REL_BAR of its plain fp32 version; one call launches its own kernel
    once and no other. K11 also on each route forced (the check-only
    ``fused_mlp_block_i8_route``, which counts no launch) at the tail's
    widths. Every reading is printed before a failure raises.
    Returns "K9 <label> B=<B> N=<N>" / "K11 ..." -> outputs that
    differ."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    cases = []
    for label, B, N, D, heads in LONG_FORMER_SHAPES:
        t = block_inputs(torch.Generator().manual_seed(18), B, D, dev, N=N)
        a = [t[k] for k in ATTN]
        scale = (D // heads) ** -0.5
        cases.append((f"K9 {label} B={B} N={N}", "fused_attention_block_large",
                      (B, N, D, heads),
                      lambda a=a, h=heads, s=scale:
                          fa.fused_attention_block_large(*a, h, s),
                      lambda a=a, h=heads, s=scale:
                          fa.fused_attention_block_large_wmma(*a, h, s),
                      lambda a=a, h=heads, s=scale:
                          fa.fused_attention_block_plain(
                              *[v.float() for v in a], h, s)))
    for label, B, N, D, w1_scale, b1 in I8_FORMER_SHAPES:
        t = block_inputs(torch.Generator().manual_seed(19), B, D, dev, N=N)
        t["w1"] = t["w1"] * w1_scale
        if b1 is not None:
            t["b1"] = torch.full_like(t["b1"], b1)
        m = i8_args(t, 12)["fused_mlp_block_i8"]
        x = t["x"]
        former = lambda x=x, m=m: fi8.fused_mlp_block_i8_mma(x, *m)
        plain32 = lambda x=x, m=m: fi8.fused_mlp_block_i8(
            x.float(), *m, plain=True)
        cases.append((f"K11 {label} B={B} N={N}", "fused_mlp_block_i8",
                      (B, N, D, 12),
                      lambda x=x, m=m: fi8.fused_mlp_block_i8(x, *m),
                      former, plain32))
        # both routes forced where the tail takes the width, whichever the
        # op takes at this M
        for tail in ((True, False) if D in fi8.I8T_WIDTHS else ()):
            cases.append((f"K11 {label} B={B} N={N}, "
                          f"{'tail' if tail else 'four launches'} forced",
                          None, (B, N, D, 12),
                          lambda x=x, m=m, tl=tail:
                              fi8.fused_mlp_block_i8_route(x, *m, tl),
                          former, plain32))
    out, bad = {}, []
    for where, name, (B, N, D, heads), kern, former, plain32 in cases:
        ops.reset_launch_counts()
        with torch.inference_mode():
            got = kern()
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            n_diff = (got != former()).sum().item()
            r = rel(got, plain32())
        print(f"{where} (N={N}, D={D}, {heads} heads): {n_diff} of "
              f"{got.numel()} outputs differ from its former chain; rel vs "
              f"plain fp32 {r:.3e} (bar {REL_BAR}); launches {counts}")
        if n_diff or not (math.isfinite(r) and r < REL_BAR) \
                or counts != ({name: 1} if name else {}):
            bad.append(f"{where}: {n_diff} outputs differ, rel {r}, "
                       f"launches {counts}")
        out[where] = n_diff
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# K10 against its former chain: both sides of its route split by M
# (vit_small B=8 and B=32 below I8Q_FUSED_WORK, B=256 above), vit_base
# (D=768, head_dim 64; 64-row tiles of the quantizing GEMM), N=50, either
# side of the asynchronous cores' NMAX (N=256 and 257), vit_small_ori@384
# (N=577, head_dim 64) and head_dim 128 (N=300). label, B, N, D, heads
K10_FORMER_SHAPES = (("vit_small", 8, 197, 384, 12),
                     ("vit_small", 32, 197, 384, 12),
                     ("vit_small", 256, 197, 384, 12),
                     ("vit_base", 2, 197, 768, 12),
                     ("vit_base", 64, 197, 768, 12),
                     ("N=50", 8, 50, 384, 12),
                     ("N=256", 8, 256, 384, 12),
                     ("N=257", 8, 257, 384, 12),
                     ("vit_small_ori@384", 2, 577, 384, 6),
                     ("vit_small_ori@384", 64, 577, 384, 6),
                     ("head_dim 128", 2, 300, 384, 3))


def check_k10_former(dev) -> dict:
    """K10 at K10_FORMER_SHAPES against the chain it ran before (the
    check-only ``fused_attention_block_i8_mma``: gemm_i8.cuh's mma.sync
    GEMMs, attn_core.cuh's or attn_long.cuh's core): every rounding point
    and sum order kept, so the count of outputs that differ must be 0; rel
    < REL_BAR against its plain fp32 version and the branch held by
    ``hold_i8_branch``; one call launches K10 once and no other kernel.
    Each route is also forced (the check-only
    ``fused_attention_block_i8_route``, which counts no launch) and held
    the same way. Every reading is printed before a failure raises.
    Returns "K10 <label> B=<B> N=<N>[, <route> forced]" -> outputs that
    differ."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    name = "fused_attention_block_i8"
    out, bad = {}, []
    for label, B, N, D, heads in K10_FORMER_SHAPES:
        t = block_inputs(torch.Generator().manual_seed(20), B, D, dev, N=N)
        x, a = t["x"], i8_args(t, heads)[name]
        with torch.inference_mode():
            former = fi8.fused_attention_block_i8_mma(x, *a)
            plain32 = fi8.fused_attention_block_i8(x.float(), *a, plain=True)
        for forced in (None, True, False):
            where = f"K10 {label} B={B} N={N}" + (
                "" if forced is None else
                f", {'three' if forced else 'five'} launches forced")
            ops.reset_launch_counts()
            with torch.inference_mode():
                got = (fi8.fused_attention_block_i8(x, *a) if forced is None
                       else fi8.fused_attention_block_i8_route(x, *a, forced))
                torch.cuda.synchronize()
                counts = {k: v for k, v in ops.launch_counts().items() if v}
                n_diff = (got != former).sum().item()
                r = rel(got, plain32)
                rk, rcs, why = hold_i8_branch(name, x, a, got)
            print(f"{where} (D={D}, {heads} heads): {n_diff} of "
                  f"{got.numel()} outputs differ from its former chain; rel "
                  f"vs plain fp32 {r:.3e} (bar {REL_BAR}); branch rel vs "
                  f"plain bf16 {rk:.3e} (bar {I8_BRANCH_BAR[name]}; the "
                  "controls' " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in rcs.items())
                  + f"); launches {counts}")
            if n_diff or not (math.isfinite(r) and r < REL_BAR) or why \
                    or counts != ({name: 1} if forced is None else {}):
                bad.append(f"{where}: {n_diff} outputs differ, rel {r}, "
                           f"{why}, launches {counts}")
            out[where] = n_diff
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def hold_i8_path(models, batch, dev) -> None:
    """Every K10/K11 call of one int8 paired forward (both branches, 48
    calls), held on the input the path gave it by ``hold_i8_branch``: the
    tight check of the path, free of the compounding of the decision
    logits."""
    from mfvit_tpu_torch.cli import infer
    from mfvit_tpu_torch.nn.vit import BlockOps
    from mfvit_tpu_torch.train.steps import make_fusion_forward
    calls = []

    def recording(name, op):
        def run(x, *a):
            out = op(x, *a)
            calls.append((name, x, a, out))
            return out
        return run

    saved = {k: models[k].plans[False] for k in ("cxr", "enh")}
    for k, plan in saved.items():
        models[k].plans[False] = tuple(
            BlockOps(recording("fused_attention_block_i8", o.attn),
                     recording("fused_mlp_block_i8", o.mlp), o.final_ln)
            for o in plan)
    try:
        make_fusion_forward()(models, *infer.prepare(batch, dev,
                                                     torch.bfloat16))
    finally:
        for k, plan in saved.items():
            models[k].plans[False] = plan
    reads = {k: ([], {}) for k in i8_ops()}  # kernel, controls per label
    bad = []
    for i, (name, x, a, out) in enumerate(calls):
        with torch.inference_mode():
            rk, rcs, why = hold_i8_branch(name, x, a, out)
        reads[name][0].append(rk)
        for k, v in rcs.items():
            reads[name][1].setdefault(k, []).append(v)
        bad += [f"call {i} ({name}): {w}" for w in why]
    for name, (rks, rcs) in reads.items():
        print(f"int8 path, {name} on its own input at each of its "
              f"{len(rks)} calls in one forward (B={batch[0].shape[0]}): "
              "branch rel vs plain bf16 " + ", ".join(f"{v:.2e}" for v in rks)
              + f" (max {max(rks):.3e}, bar {I8_BRANCH_BAR[name]}); the "
              "controls' (must fail) least " + ", ".join(
                  f"{k} {min(v):.3e}" for k, v in rcs.items()))
    if len(calls) != sum(PER_I8_FORWARD[k] for k in i8_ops()):
        bad.append(f"{len(calls)} K10/K11 calls in one forward")
    if bad:
        raise AssertionError("; ".join(bad))


def check_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    t = block_inputs(g, 8, 384, dev)
    tok_c, tok_e, flat = fusion_inputs(g, 8, 384, dev)
    errs = {}
    for name, (kern, _, plain32) in kernel_calls(t, 12, tok_c, tok_e, flat,
                                                 3).items():
        got = kern()
        torch.cuda.synchronize()
        ref = plain32()
        r = rel(got, ref)
        errs[name] = (got.float() - ref).abs().max().item()
        extra = ""
        if name in ("fused_attention_block", "fused_mlp_block"):
            x = t["x"].float()
            extra = (f" (the branch without the residual: rel "
                     f"{rel(got.float() - x, ref - x):.3e})")
        print(f"{name}: rel {r:.3e}, max_abs_err {errs[name]:.3e}{extra}")
        if not (math.isfinite(r) and r < REL_BAR):
            raise AssertionError(f"{name}: rel {r} >= {REL_BAR}")
    return errs


# K12-K14's shapes: label, B, N, D, heads
MHSA_SHAPES = (("vit_small", 8, 197, 384, 12), ("vit_small_ori", 8, 197, 384, 6),
               ("vit_base", 4, 197, 768, 12), ("head_dim 128", 2, 300, 384, 3),
               ("N=50", 8, 50, 384, 12), ("N=376", 2, 376, 384, 12),
               ("N=377", 2, 377, 384, 12), ("N=577", 2, 577, 384, 6),
               ("N=1025", 2, 1025, 384, 6))


def mhsa_calls(qkv, heads: int) -> dict:
    """name -> (kernel call, plain call in bf16, plain call in fp32 on the
    same values, SDPA on the same values) for K12, K13 and K14, each in its
    own layout of one packed bf16 qkv (B, N, 3D): K12 on it, K13 on
    contiguous q, k, v (B, H, N, dh), K14 on its transpose (B, 3D, N). SDPA
    is the library yardstick, never on the port's path: for K12 it takes
    strided views of the packed qkv (head_dim innermost, as its fused
    kernels need); for K14 it takes contiguous copies of the transposed
    layout's q, k, v and its output goes back to (B, D, N), the two
    transposes counted (on K14's strided views, whose last dimension has
    stride N, SDPA leaves its fused kernels; ``time_mhsa`` times that
    too, as a note)."""
    import torch.nn.functional as F

    from mfvit_tpu_torch.ops import attention as at
    scale = (qkv.shape[-1] // 3 // heads) ** -0.5
    q, k, v = (t.contiguous() for t in at._split(qkv, heads, False))
    qkv_t = qkv.transpose(1, 2).contiguous()
    views = {"mhsa_packed": at._split(qkv, heads, False), "mhsa": (q, k, v),
             "mhsa_packed_t": at._split(qkv_t, heads, True)}

    def sdpa(name):
        return lambda: F.scaled_dot_product_attention(*views[name],
                                                      scale=scale)

    def sdpa_t():
        q_t, k_t, v_t = (t.contiguous() for t in views["mhsa_packed_t"])
        return at._from_heads(F.scaled_dot_product_attention(
            q_t, k_t, v_t, scale=scale), True)
    return {
        "mhsa_packed": (
            lambda: at.mhsa_packed(qkv, heads, scale),
            lambda: at.mhsa_packed_plain(qkv, heads, scale),
            lambda: at.mhsa_packed_plain(qkv.float(), heads, scale),
            sdpa("mhsa_packed")),
        "mhsa": (
            lambda: at.mhsa(q, k, v, scale),
            lambda: at.mhsa_plain(q, k, v, scale),
            lambda: at.mhsa_plain(q.float(), k.float(), v.float(), scale),
            sdpa("mhsa")),
        "mhsa_packed_t": (
            lambda: at.mhsa_packed_t(qkv_t, heads, scale),
            lambda: at.mhsa_packed_t_plain(qkv_t, heads, scale),
            lambda: at.mhsa_packed_t_plain(qkv_t.float(), heads, scale),
            sdpa_t),
    }


def packed_qkv(B, N, D, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, 3 * D, generator=g).to(dev).bfloat16()


def mhsa_controls(scale: float) -> dict:
    """label -> fn(q, k, v, recip) on (B, H, N, dh): wrong versions of
    K12-K14 (K13 with ``recip``), each the plain version with one of K1's
    rounding points: ``P rounded first``, exp(s - max) rounded to bf16 and
    1/sum applied to the PV output; ``scale on q in bf16``, q * scale
    rounded to bf16 before the product, only where the scale is not a
    power of two (at head_dim 64 both orders give the same bits)."""
    from mfvit_tpu_torch.ops import attention as at

    def p_first(q, k, v, recip):
        s = (q.float() @ k.float().transpose(-1, -2)) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = p.to(v.dtype).float() @ v.float()
        return (o / p.sum(-1, keepdim=True)).to(q.dtype)
    ctl = {"P rounded first": p_first}
    if math.frexp(scale)[0] != 0.5:
        ctl["scale on q in bf16"] = lambda q, k, v, recip: at._attn_plain(
            (q.float() * scale).to(q.dtype), k, v, 1.0, recip)
    return ctl


def hold_mhsa(q, k, v, scale: float, recip: bool, got) -> tuple:
    """A K12-K14 output ``got`` (B, H, N, dh) against the plain version in
    bf16 on the same q, k, v: its fro_rel, each control's ({label: rel}),
    and what fails: the kernel at or above MHSA_BAR, or a control below
    it."""
    from mfvit_tpu_torch.ops import attention as at
    plain = at._attn_plain(q, k, v, scale, recip)
    rk = fro_rel(got, plain)
    rcs = {lab: fro_rel(fn(q, k, v, recip), plain)
           for lab, fn in mhsa_controls(scale).items()}
    bad = [] if math.isfinite(rk) and rk < MHSA_BAR else [
        f"rel vs plain bf16 {rk} >= {MHSA_BAR}"]
    bad += [f"the control '{lab}' passes (rel {v} < {MHSA_BAR}): the bar "
            "cannot tell it" for lab, v in rcs.items() if not v >= MHSA_BAR]
    return rk, rcs, bad


def check_mhsa_kernels(dev) -> dict:
    """K12, K13 and K14 at MHSA_SHAPES against their plain fp32 versions
    (rel < REL_BAR) and against their plain bf16 versions (``hold_mhsa``:
    fro_rel < MHSA_BAR, which every control must fail), and K12 equal to
    K14 bit for bit. Every reading is printed before a failure raises.
    Returns each one's largest abs error at vit_small."""
    from mfvit_tpu_torch.ops import attention as at
    errs, bad = {}, []
    for label, B, N, D, heads in MHSA_SHAPES:
        qkv = packed_qkv(B, N, D, dev, seed=15)
        scale = (D // heads) ** -0.5
        q, k, v = (t.contiguous() for t in at._split(qkv, heads, False))
        to_heads = {"mhsa_packed": lambda o: at._to_heads(o, heads, False),
                    "mhsa": lambda o: o,
                    "mhsa_packed_t": lambda o: at._to_heads(o, heads, True)}
        outs, reads, ctl = {}, [], {}
        with torch.inference_mode():
            for name, (kern, _, plain32, _) in mhsa_calls(qkv, heads).items():
                got = kern()
                torch.cuda.synchronize()
                ref = plain32()
                r = rel(got, ref)
                rk, rcs, why = hold_mhsa(q, k, v, scale, name == "mhsa",
                                         to_heads[name](got))
                outs[name] = got
                reads.append(f"{name} rel vs plain fp32 {r:.3e}, vs plain "
                             f"bf16 {rk:.3e}")
                for lab, val in rcs.items():
                    ctl[lab] = min(ctl.get(lab, math.inf), val)
                if not (math.isfinite(r) and r < REL_BAR):
                    why.append(f"rel {r} >= {REL_BAR}")
                bad += [f"{name} at {label}: {w}" for w in why]
                if label == "vit_small":
                    errs[name] = (got.float() - ref).abs().max().item()
        same = torch.equal(outs["mhsa_packed"],
                           outs["mhsa_packed_t"].transpose(1, 2))
        print(f"K12-K14 at {label} (B={B}, N={N}, D={D}, {heads} heads): "
              + ", ".join(reads) + f" (bars {REL_BAR}, {MHSA_BAR}); the "
              "controls' vs plain bf16 (must fail) " + ", ".join(
                  f"{lab} {val:.3e}" for lab, val in ctl.items())
              + f"; K12 == K14 bit for bit: {same}")
        if not same:
            bad.append(f"K12 and K14 differ at {label}")
    if bad:
        raise AssertionError("; ".join(bad))
    return errs


def quant_models(dev, img: int) -> dict:
    """vit_small MF-ViT CA from seeded weights at ``img`` px, both branches
    through ``quantize_vit_params``."""
    from mfvit_tpu_torch.models.fusion import Fusion
    from mfvit_tpu_torch.nn.vit import ViT, get_config, quantize_vit_params
    cfg = get_config("vit_small", img)
    gens = [torch.Generator().manual_seed(s) for s in (16, 17, 18)]
    return {"cxr": quantize_vit_params(ViT(cfg, 3, device=dev,
                                           generator=gens[0])).eval(),
            "enh": quantize_vit_params(ViT(cfg, 3, device=dev,
                                           generator=gens[1])).eval(),
            "fus": Fusion(3, cfg.dim, 3, device=dev,
                          generator=gens[2]).eval()}


def run_quant_path(dev, img: int, B: int) -> dict:
    """The XLA-level W8A8 path once through ``fused_forward`` (the serving
    forward, ``make_fusion_forward``) at batch B and ``img`` px: launch
    counts (PER_QUANT_FORWARD, every other kernel 0), finite logits, top-1
    agreement with the plain path in bf16 on all but I8_TOP1_MISSES pairs;
    then every K12 call of one forward held on its own input
    (``hold_quant_path``). Returns the launch counts."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.train.steps import make_fusion_forward
    models = quant_models(dev, img)
    g = torch.Generator().manual_seed(19)
    xc, xe = (torch.randn(B, img, img, 3, generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    mode = f"quant path at {img} px (B={B})"
    ops.reset_launch_counts()
    out = make_fusion_forward()(models, xc, xe)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"{mode} launch counts {counts} over 1 forward")
    want = {k: 0 for k in counts}
    want.update(PER_QUANT_FORWARD)
    if counts != want:
        raise AssertionError(f"{mode}: launch counts {counts} != {want}")
    logits = sum(out)
    if logits.shape != (B, 3) or not logits.isfinite().all():
        raise AssertionError(f"{mode}: bad logits {tuple(logits.shape)}")
    plain = make_fusion_forward(reference=True)(models, xc, xe)
    agree = (logits.argmax(-1) == sum(plain).argmax(-1)).float().mean().item()
    bar = 1 - I8_TOP1_MISSES / B
    print(f"{mode} decision logits: top-1 agreement with plain bf16 "
          f"{agree:.3f} (bar {bar:.3f}); for information: rel vs plain bf16 "
          f"{rel(logits, sum(plain)):.3e}; per output " + ", ".join(
              f"{k} {rel(a, b):.3e}"
              for k, a, b in zip(("fused", "cxr", "enh"), out, plain)))
    if not agree >= bar:
        raise AssertionError(f"{mode}: top-1 agreement {agree} < {bar}")
    hold_quant_path(models, xc, xe)
    return counts


def hold_quant_path(models, xc, xe) -> None:
    """Each K12 call of one paired forward of the quant path (24), held on
    the input the path gave it against K12's plain fp32 version (rel <
    REL_BAR) and its plain bf16 version (``hold_mhsa``, which every control
    must fail at every call): the tight check, free of the compounding of
    the logits."""
    from mfvit_tpu_torch.ops import attention as at
    from mfvit_tpu_torch.train.steps import make_fusion_forward
    calls = []
    orig = at.mhsa_from_packed

    def recording(qkv, heads, scale, plain=False):
        out = orig(qkv, heads, scale, plain=plain)
        calls.append((qkv, heads, scale, out))
        return out

    at.mhsa_from_packed = recording
    try:
        make_fusion_forward()(models, xc, xe)
    finally:
        at.mhsa_from_packed = orig
    rels, rks, ctl, bad = [], [], {}, []
    with torch.inference_mode():
        for i, (qkv, heads, scale, out) in enumerate(calls):
            rels.append(rel(out, at.mhsa_packed_plain(qkv.float(), heads,
                                                      scale)))
            rk, rcs, why = hold_mhsa(*at._split(qkv, heads, False), scale,
                                     False, at._to_heads(out, heads, False))
            rks.append(rk)
            for lab, val in rcs.items():
                ctl[lab] = min(ctl.get(lab, math.inf), val)
            if not (math.isfinite(rels[-1]) and rels[-1] < REL_BAR):
                why.append(f"rel {rels[-1]} >= {REL_BAR}")
            bad += [f"K12 call {i}: {w}" for w in why]
    N = calls[0][0].shape[1] if calls else 0
    print(f"quant path, K12 on its own input at each of its {len(rels)} "
          f"calls in one forward (N={N}): rel vs plain fp32 " + ", ".join(
              f"{r:.2e}" for r in rels) + f" (max {max(rels):.3e}, bar "
          f"{REL_BAR}); vs plain bf16 " + ", ".join(f"{r:.2e}" for r in rks)
          + f" (max {max(rks):.3e}, bar {MHSA_BAR}); the controls' (must "
          "fail) least " + ", ".join(f"{lab} {val:.3e}"
                                     for lab, val in ctl.items()))
    if len(calls) != PER_QUANT_FORWARD["mhsa_packed"]:
        bad.append(f"{len(calls)} K12 calls in one forward")
    if bad:
        raise AssertionError("; ".join(bad))


def time_mhsa(dev, label: str, B: int, N: int, D: int, heads: int,
              names=MHSA) -> dict:
    """name -> (kernel ms, plain ms, SDPA ms) of K12-K14 (those in
    ``names``) at one shape: each first held against its plain fp32
    version on the timed inputs, then kernel, plain, plain, kernel (the
    plain version in bf16) and SDPA on the same values (for K14 also, as
    a note, on its strided views)."""
    import torch.nn.functional as F

    from mfvit_tpu_torch.ops import attention as at
    qkv = packed_qkv(B, N, D, dev, seed=20)
    scale = (D // heads) ** -0.5
    times = {}
    with torch.inference_mode():
        for name, (kern, plain, plain32, sdpa) in mhsa_calls(
                qkv, heads).items():
            if name not in names:
                continue
            r = rel(kern(), plain32())
            if not (math.isfinite(r) and r < REL_BAR):
                raise AssertionError(f"{name} at {label} B={B}: rel {r}")
            k1, p1, p2, k2, s1 = (cuda_ms(f, n) for f, n in (
                (kern, 20), (plain, 3), (plain, 3), (kern, 20), (sdpa, 20)))
            times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, s1)
            note = ""
            if name == "mhsa_packed_t":
                views = at._split(qkv.transpose(1, 2).contiguous(), heads,
                                  True)
                ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    *views, scale=scale), 20)
                note = f"; SDPA on K14's strided views {ms:.4f} ms"
            print(f"{name} at {label} B={B} (N={N}, {heads} heads): rel vs "
                  f"plain fp32 {r:.3e}; kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.3f}/{p2:.3f} ms (bf16), SDPA {s1:.4f} ms{note}")
    return times


def profile_forward(fwd, models, xc, xe, iters: int = 2) -> dict:
    """One ``torch.profiler`` window over ``iters`` paired forwards (logits
    fetched each time) after a warm one: the host's ms per forward, the
    device's busy ms per forward (the profiler's own cost included), the
    launches per forward that waited for a full queue, the device ms per
    forward of each launching PyTorch operator (or autograd Function)
    with its calls, and each kernel's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sum(fwd(models, xc, xe)).cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            sum(fwd(models, xc, xe)).cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    avgs = prof.key_averages()
    kernels = {e.key: e.self_device_time_total / (iters * 1e3) for e in avgs
               if e.device_type == DeviceType.CUDA}
    # "Command Buffer Full" marks a launch that waited for room in the
    # queue (the host ahead of the device); the profiler also hands it the
    # device time of those kernels, which their operators already count
    full = {e.key: e.count // iters for e in avgs}.get("Command Buffer Full",
                                                         0)
    by_op = {e.key: (e.self_device_time_total / (iters * 1e3),
                     e.count // iters)
             for e in avgs if e.device_type == DeviceType.CPU
             and e.self_device_time_total > 0
             and e.key != "Command Buffer Full"}
    return {"wall_ms": wall_ms, "device_ms": sum(kernels.values()),
            "queue_full_per_forward": full, "kernels": kernels,
            "by_op": sorted(by_op.items(), key=lambda kv: -kv[1][0])}


def profile_quant(dev, B: int = 256) -> dict:
    """``profile_forward`` over two forwards of the quant path at batch B
    (224 px, the models of ``quant_models``): the twelve operators with
    the most device time and the time of K12's kernels."""
    from mfvit_tpu_torch.train.steps import make_fusion_forward
    models = quant_models(dev, 224)
    g = torch.Generator().manual_seed(21)
    xc, xe = (torch.randn(B, 224, 224, 3, generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    prof = profile_forward(make_fusion_forward(), models, xc, xe)
    wall, busy, full = (prof[k] for k in ("wall_ms", "device_ms",
                                          "queue_full_per_forward"))
    k12 = sum(v for k, v in prof["kernels"].items() if "mhsa::" in k)
    top = prof["by_op"][:12]
    print(f"quant path at B={B}, profiled: {wall:.1f} ms per forward "
          f"on the host clock, device busy {busy:.1f} ms per forward "
          f"({busy / wall:.1%}); launches that waited for a full "
          f"queue {full} per forward; device ms per forward by operator: "
          + "; ".join(f"{k} {v:.2f} ms x{n}" for k, (v, n) in top)
          + f"; K12's kernels {k12:.2f} ms")
    return {"wall_ms": wall, "device_ms": busy,
            "queue_full_per_forward": full,
            "by_op": [[k, v, n] for k, (v, n) in top], "k12_ms": k12}


def mhsa_bound(B: int, N: int, D: int, heads: int) -> tuple:
    """K12-K14: q, k, v read and o written once in bf16; QK^T and PV on the
    tensor cores; one exp a score on the special function units (above
    the bytes at N=577)."""
    return bound({"bf16": 2 * 2 * B * heads * N * N * (D // heads),
                  "sfu": B * heads * N * N}, 4 * B * N * D * 2)


def write_pairs(root: str, n: int, seed: int) -> str:
    import cv2

    from mfvit_tpu_torch.data.manifest import write_covid_manifest
    rng = np.random.default_rng(seed)
    for folder in ("data", "Train_Mix"):
        os.makedirs(os.path.join(root, "images", folder))
    names = [f"pair_{i:03d}.png" for i in range(n)]
    yy, xx = np.mgrid[0:256, 0:288]
    for i, fn in enumerate(names):
        for folder in ("data", "Train_Mix"):
            img = rng.integers(0, 60, (256, 288, 3), np.uint8)
            img += ((np.sin(xx / (9 + i % 7)) + np.cos(yy / 13)) * 90
                    + 100).astype(np.uint8)[..., None]
            cv2.imwrite(os.path.join(root, "images", folder, fn), img)
    man = os.path.join(root, "paired.txt")
    write_covid_manifest(man, os.path.join(root, "images"), names,
                         [i % 3 for i in range(n)])
    return man


def run_slice(dev, tmp: str, int8: bool, img: int = 224) -> dict:
    """The serving slice through ``infer.main`` (with ``--int8`` when
    ``int8``) at ``img`` px: 64 synthetic pairs at B=32 at 224 px, 32 at
    B=16 at 384 px. The first call writes the seeded serving checkpoint
    (224 px) into ``tmp``, the first at each size the pairs; later calls
    serve the same ones. Returns the run's launch counts."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import common, infer
    from mfvit_tpu_torch.exp.checkpoint import save_serving
    from mfvit_tpu_torch.models.fusion import Fusion
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train.steps import make_fusion_forward

    n, bs = (64, 32) if img == 224 else (32, 16)
    cfg = get_config("vit_small", img)
    pairs = os.path.join(tmp, f"pairs{img}")
    man = os.path.join(pairs, "paired.txt")
    ckpt = os.path.join(tmp, "serving.pt")
    if not os.path.exists(ckpt):
        c224 = get_config("vit_small")
        seeds = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
        save_serving(ckpt, ViT(c224, 3, generator=seeds[0]).state_dict(),
                     ViT(c224, 3, generator=seeds[1]).state_dict(),
                     Fusion(3, c224.dim, 3, generator=seeds[2]).state_dict())
    if not os.path.exists(man):
        os.makedirs(pairs)
        write_pairs(pairs, n, seed=0)
    argv = ["-a", "vit_small", "-b", str(bs), "--device", dev.type,
            "--img-size", str(img), "--crop", str(img),
            "--report-throughput", "--checkpoint", ckpt, "--manifest", man,
            "--output", os.path.join(tmp, "predictions.json"), "-j", "8"]
    argv_bf16 = list(argv)
    if int8:
        argv.append("--int8")
    mode = f"{'int8' if int8 else 'bf16'} at {img} px"

    ops.reset_launch_counts()
    out = infer.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    forwards = -(-n // bs) + 1 + infer.THROUGHPUT_ITERS
    print(f"{mode} launch counts {counts} over {forwards} forwards")
    # every kernel the path does not run (the backward ones, the other
    # serving mode's) counts 0
    want = {k: 0 for k in counts}
    want.update({k: v * forwards for k, v in PER_PAIR[img, int8].items()})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    logits = torch.tensor(out["logits"])
    if out["n"] != n or logits.shape != (n, 3) or not logits.isfinite().all():
        raise AssertionError(f"bad infer output: n={out['n']}, "
                             f"shape={tuple(logits.shape)}")

    # the same weights and batches through the plain path on the card
    args = infer.build_parser().parse_args(argv)
    models = infer.load_models(args, cfg, dev)
    loader = common.make_paired_loader(args, man)
    def outputs(models, dt, reference):  # (3, n, classes)
        fwd = make_fusion_forward(compute_dtype=dt, reference=reference)
        return torch.cat([torch.stack([o.cpu() for o in fwd(
            models, *infer.prepare(b, dev, dt))]) for b in loader], 1)[:, :n]

    plain16 = outputs(models, torch.bfloat16, True)
    plain32 = outputs(models, torch.float32, True)
    kern = outputs(models, torch.bfloat16, False)
    r16, r32 = rel(logits, plain16.sum(0)), rel(logits, plain32.sum(0))
    top1 = (logits.argmax(-1) == plain32.sum(0).argmax(-1)).float()
    per_output = ("; per output vs plain bf16: " + ", ".join(
        f"{k} {rel(kern[i], plain16[i]):.3e}"
        for i, k in enumerate(("fused", "cxr", "enh"))))
    if not int8:
        print(f"{mode} decision logits: rel vs plain bf16 {r16:.3e} (bar "
              f"{REL_BAR}); for information: rel vs plain fp32 {r32:.3e}, "
              f"top-1 agreement with plain fp32 {top1.mean().item():.3f}"
              + per_output)
        if not r16 < REL_BAR:
            raise AssertionError(f"{mode} decision logits rel {r16} >= "
                                 f"{REL_BAR}")
    else:
        agree = (logits.argmax(-1) == plain16.sum(0).argmax(-1)).float()
        top1_bar = 1 - I8_TOP1_MISSES / n
        bf16 = outputs(infer.load_models(
            infer.build_parser().parse_args(argv_bf16), cfg, dev),
            torch.bfloat16, False).sum(0)
        print(f"{mode} decision logits: top-1 agreement with plain bf16 "
              f"{agree.mean().item():.3f} (bar {top1_bar:.3f}); for "
              f"information: rel vs plain bf16 {r16:.3e}, vs plain fp32 "
              f"{r32:.3e}, the bf16 kernel path's on the same weights vs "
              f"plain bf16 {rel(bf16, plain16.sum(0)):.3e}; int8 against "
              f"that bf16 path: rel {rel(logits, bf16):.3e}, top-1 agreement "
              f"{(logits.argmax(-1) == bf16.argmax(-1)).float().mean():.3f}"
              + per_output)
        if not agree.mean().item() >= top1_bar:
            raise AssertionError(f"{mode} top-1 agreement "
                                 f"{agree.mean().item()} < {top1_bar}")
        if img == 224:  # K10 and K11 on every call (at 384 K10 is not run)
            hold_i8_path(models, next(iter(loader)), dev)
    print(f"{mode} infer: pairs_per_sec {out['pairs_per_sec']:.1f}, "
          f"pairs_per_sec_e2e {out['pairs_per_sec_e2e']:.1f} (B={bs}, n={n})")
    return counts


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(1)
    t = block_inputs(g, 256, 384, dev)
    tok_c, tok_e, flat = fusion_inputs(g, 256, 384, dev)
    calls = kernel_calls(t, 12, tok_c, tok_e, flat, 3)
    calls.update(i8_calls(t, 12))
    times = {}
    with torch.inference_mode():
        for name, (kern, plain, _) in calls.items():
            # kernel, plain, plain, kernel: the card's clock drifts
            k1, p1, p2, k2 = (cuda_ms(f, 10) for f in (kern, plain, plain,
                                                       kern))
            times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"{name} at B=256: kernel {k1:.3f}/{k2:.3f} ms, plain "
                  f"{p1:.3f}/{p2:.3f} ms (bf16)")
    return times


# K9's timed shapes: vit_small@384 at B=64, vit_small_ori@512 at B=16
K9_TIMED = (("vit_small@384", 64, 577, 384, 12),
            ("vit_small_ori@512", 16, 1025, 384, 6))
# the other halves timed at B=64: K10 past 256 tokens where it runs
# (vit_small_ori@384, 6 heads), K2 and K11 at vit_small@384, K10 and K11 at
# vit_base (224 px: D=768, K10's five launches, K11's four)
LONG_TIMED = (("fused_attention_block_i8", "vit_small_ori@384", 64, 577, 384,
               6),
              ("fused_mlp_block", "vit_small@384", 64, 577, 384, 12),
              ("fused_mlp_block_i8", "vit_small@384", 64, 577, 384, 12),
              ("fused_attention_block_i8", "vit_base", 64, 197, 768, 12),
              ("fused_mlp_block_i8", "vit_base", 64, 197, 768, 12))


# the launches timed one by one (``compare_block.stage_times``): K9 and its
# former chain at K9_TIMED, K11 and its former chain at vit_small B=256 and
# vit_base B=64 (its four launches on the wgmma core), K10 at both its
# sequence lengths and at vit_base B=64, its former chain at vit_small
# B=256; op, label, B, N, D, heads
STAGE_TIMED = tuple(
    [(op, label, B, N, D, h) for op in ("k9", "k9_wmma")
     for label, B, N, D, h in K9_TIMED]
    + [(op, label, B, 197, D, 12) for op in ("k11", "k11_mma")
       for label, B, D in (("vit_small", 256, 384), ("vit_base", 64, 768))]
    + [("k10", "vit_small", 256, 197, 384, 12),
       ("k10", "vit_small_ori@384", 64, 577, 384, 6),
       ("k10", "vit_base", 64, 197, 768, 12),
       ("k10_mma", "vit_small", 256, 197, 384, 12)])


def time_long_kernels(dev) -> dict:
    """K9 and its plain version (bf16) at ``K9_TIMED``, then K10, K2 and
    K11 at ``LONG_TIMED``, kernel, plain, plain, kernel; each kernel first
    held against its plain fp32 version on the timed inputs. "<name> at
    <label>" -> (kernel ms, plain ms)."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    times = {}
    shapes = [("fused_attention_block_large", *k) for k in K9_TIMED]
    for name, label, B, N, D, heads in shapes + list(LONG_TIMED):
        t = block_inputs(torch.Generator().manual_seed(13), B, D, dev, N=N)
        x, scale = t["x"], (D // heads) ** -0.5
        if name.endswith("_i8"):
            op, a = i8_ops()[name], i8_args(t, heads)[name]
            kern = functools.partial(op, x, *a)
            plain = functools.partial(op, x, *a, plain=True)
            plain32 = functools.partial(op, x.float(), *a, plain=True)
        else:
            a = [t[k] for k in (ATTN if name == "fused_attention_block_large"
                                else MLP)]
            op, ref = {"fused_attention_block_large": (
                           fa.fused_attention_block_large,
                           fa.fused_attention_block_plain),
                       "fused_mlp_block": (fm.fused_mlp_block,
                                           fm.fused_mlp_block_plain)}[name]
            extra = (heads, scale) if name == "fused_attention_block_large" \
                else ()
            kern = functools.partial(op, *a, *extra)
            plain = functools.partial(ref, *a, *extra)
            plain32 = functools.partial(ref, *[v.float() for v in a], *extra)
        with torch.inference_mode():
            r = rel(kern(), plain32())
            if not (math.isfinite(r) and r < REL_BAR):
                raise AssertionError(f"{name} at {label} B={B}: rel {r}")
            k1, p1, p2, k2 = (cuda_ms(f, n) for f, n in (
                (kern, 10), (plain, 3), (plain, 3), (kern, 10)))
        times[f"{name} at {label}"] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"{name} at {label} B={B}: rel vs plain fp32 {r:.3e}; kernel "
              f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms (bf16)")
    return times


def time_k9_backward(dev, B: int) -> float:
    """K9's backward, the fp32 recompute in plain PyTorch, at a
    vit_small@384 block and batch B with a bf16 cotangent, as the FT step
    runs it: ms per call."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    gen = torch.Generator().manual_seed(14)
    t = block_inputs(gen, B, 384, dev, N=577)
    g = torch.randn(B, 577, 384, generator=gen).to(dev).bfloat16()
    a = [g] + [t[k] for k in ATTN[:-1]]
    ms = cuda_ms(lambda: fa.fused_attention_block_bwd_f32(*a, 12, 32 ** -0.5),
                 3)
    print(f"K9's backward (fp32 recompute) at vit_small@384 B={B}: {ms:.3f} ms")
    return ms


def time_e2e(dev, B: int = 256, img: int = 224, int8: bool = True) -> dict:
    """Serving pairs/s at batch B and ``img`` px: the kernel path against
    the plain path (kernel, plain, plain, kernel), then, with ``int8``,
    the int8 kernel path against the bf16 kernel path on the same weights
    (int8, bf16, bf16, int8) and the XLA-level W8A8 path (``quant``,
    ``quantize_vit_params``) against its plain path, the bf16 path and the
    int8 path (quant, quant_plain, quant_plain, quant, quant, bf16, bf16,
    quant, quant, int8, int8, quant)."""
    import copy

    from mfvit_tpu_torch.models.fusion import Fusion
    from mfvit_tpu_torch.nn.vit import (ViT, get_config, quantize_vit_for_serving,
                                        quantize_vit_params)
    from mfvit_tpu_torch.train.steps import make_fusion_forward

    cfg = get_config("vit_small", img)
    gens = [torch.Generator().manual_seed(s) for s in (4, 5, 6, 7)]
    models = {"cxr": ViT(cfg, 3, device=dev, generator=gens[0]).eval(),
              "enh": ViT(cfg, 3, device=dev, generator=gens[1]).eval(),
              "fus": Fusion(3, cfg.dim, 3, device=dev,
                            generator=gens[2]).eval()}
    models_i8 = dict(models, **{k: quantize_vit_for_serving(
        copy.deepcopy(models[k])) for k in ("cxr", "enh") if int8})
    models_q = dict(models, **{k: quantize_vit_params(
        copy.deepcopy(models[k])) for k in ("cxr", "enh") if int8})
    xc = torch.randn(B, img, img, 3, generator=gens[3]).to(dev, torch.bfloat16)
    xe = torch.randn(B, img, img, 3, generator=gens[3]).to(dev, torch.bfloat16)
    kernel = make_fusion_forward()
    fwds = {"kernel": (kernel, models), "bf16": (kernel, models),
            "plain": (make_fusion_forward(reference=True), models),
            "int8": (kernel, models_i8), "quant": (kernel, models_q),
            "quant_plain": (make_fusion_forward(reference=True), models_q)}

    def rate(which: str, iters: int = 5) -> float:
        fwd, ms = fwds[which]
        sum(fwd(ms, xc, xe)).cpu()
        t0 = time.perf_counter()
        for _ in range(iters):
            sum(fwd(ms, xc, xe)).cpu()  # decision logits to the host
        return B * iters / (time.perf_counter() - t0)

    order = ("kernel", "plain", "plain", "kernel")
    if int8:
        order += ("int8", "bf16", "bf16", "int8",
                  "quant", "quant_plain", "quant_plain", "quant",
                  "quant", "bf16", "bf16", "quant",
                  "quant", "int8", "int8", "quant")
    runs = {k: [] for k in order}
    for which in order:
        runs[which].append(rate(which))
    out = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"end to end at B={B}, {img} px (logits fetched every forward): "
          + ", ".join(f"{k} {' / '.join(f'{r:.1f}' for r in v)} pairs/s"
                      for k, v in runs.items())
          + (" (kernel, plain: bf16; bf16, int8, quant: the kernel path; "
             "quant_plain: the quant path over K12's plain version)" if int8
             else " (bf16)"))
    return out


def bound(ops: dict, nbytes: float) -> tuple:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over their type's peak (the
    largest over the types, since the tensor cores and the CUDA cores run
    at once), and which of the two it is."""
    t_ops = max(n / PEAK[k] for k, n in ops.items())
    t_mem = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def kernel_bounds(B: int, N: int, D: int, heads: int, Hd: int,
                  fusion_heads: int) -> dict:
    """name -> (bound ms, bound_by) at these shapes: each input read once
    and each output written once, in the dtypes the kernels take."""
    M, dh = B * N, D // heads
    act = M * D * 2                         # one bf16 (B, N, D) tensor
    attn_nn = 2 * B * heads * N * N * dh    # one N x N x dh product
    w_attn, w_mlp = 4 * D * D * 2, 2 * D * Hd * 2
    # K1 and K9 (pl.CostEstimate at fused_attn.py:194, :360): the qkv and
    # proj GEMMs and the two attention products; K9's recomputed q k^T is
    # the kernel's own cost, not the function's
    attn = bound({"bf16": 2 * M * D * 4 * D + 2 * attn_nn}, 2 * act + w_attn)
    return {
        "fused_attention_block": attn,
        "fused_attention_block_large": attn,
        "fused_mlp_block": bound({"bf16": 4 * M * D * Hd}, 2 * act + w_mlp),
        "fused_mlp_block_final_ln": bound({"bf16": 4 * M * D * Hd},
                                          2 * act + w_mlp),
        # K4, both directions, in the absorbed form its kernels compute: per
        # (image, direction) the scores and z (2 N D each a head) and q, u,
        # o and proj (2 D D each), in fp32; the token streams read once
        # bound it
        "fused_fusion_cls": bound(
            {"fp32": 2 * B * (4 * N * D * fusion_heads + 8 * D * D)},
            2 * act + 2 * 4 * D * D * 2 + 2 * B * D * 4),
        # K5: qkv recompute, dO, dWqkv, dh on the tensor cores; S, PV, dP,
        # dV, dQ, dK; dWproj in fp32 as the TPU kernel keeps it
        "fused_attention_block_bwd": bound(
            {"bf16": 3 * 2 * M * D * 3 * D + 2 * M * D * D + 6 * attn_nn,
             "fp32": 2 * M * D * D},
            3 * act + w_attn + 4 * D * D * 4),
        # K7: fc1 recompute, g . W2, dW1, dW2, dh1
        "fused_mlp_block_bwd": bound({"bf16": 5 * 2 * M * D * Hd},
                                     3 * act + w_mlp + 2 * D * Hd * 4),
        # K10: int8 qkv and proj GEMMs, bf16 scores and PV; int8 weights
        "fused_attention_block_i8": bound(
            {"int8": 2 * M * D * 3 * D + 2 * M * D * D, "bf16": 2 * attn_nn},
            2 * act + 4 * D * D),
        # K11: int8 fc1 and fc2
        "fused_mlp_block_i8": bound({"int8": 4 * M * D * Hd},
                                    2 * act + 2 * D * Hd),
        # K15: K1's and K2's products; x read and the output written once
        "fused_transformer_block": bound(
            {"bf16": 2 * M * D * 4 * D + 2 * attn_nn + 4 * M * D * Hd},
            2 * act + w_attn + w_mlp),
    }


BWD_NAMES = ("dx", "dln_s", "dln_b", "dw_a", "db_a", "dw_b", "db_b")


def bwd_calls(t, g, heads):
    """name -> (kernel backward, plain backward in the inputs' dtype,
    plain backward in fp32 on the same values), each returning its
    gradients. K3's runs through its autograd Function: the epilogue
    LayerNorm backward, then K7 (nine gradients)."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    scale = (t["x"].shape[-1] // heads) ** -0.5
    a = [g] + [t[k] for k in ATTN[:-1]]
    m = [g] + [t[k] for k in MLP[:-1]]
    a32, m32 = [v.float() for v in a], [v.float() for v in m]

    def k3(plain, dtype):
        leaves = [t["x"].to(dtype)] + [t[k].float() for k in MLP[1:]]
        leaves += [t["fs"], t["fb"]]
        leaves = [v.detach().clone().requires_grad_() for v in leaves]
        out = fm.fused_mlp_block_final_ln(*leaves, plain=plain)
        return torch.autograd.grad(out, leaves, g.to(dtype))

    return {
        "fused_attention_block_bwd": (
            lambda: fa.fused_attention_block_bwd(*a, heads, scale),
            lambda: fa.fused_attention_block_bwd_plain(*a, heads, scale),
            lambda: fa.fused_attention_block_bwd_plain(*a32, heads, scale)),
        "fused_mlp_block_bwd": (
            lambda: fm.fused_mlp_block_bwd(*m),
            lambda: fm.fused_mlp_block_bwd_plain(*m),
            lambda: fm.fused_mlp_block_bwd_plain(*m32)),
        "fused_mlp_block_final_ln (backward)": (
            lambda: k3(False, torch.bfloat16), None,
            lambda: k3(True, torch.float32)),
    }


def hold_bwd(name: str, label: str, kern, plain32) -> float:
    """One backward's outputs against the plain fp32 backward on the same
    values, rel < REL_BAR each; returns the largest abs error."""
    got = kern()
    torch.cuda.synchronize()
    ref = plain32()
    rels = [rel(x, y) for x, y in zip(got, ref)]
    names = BWD_NAMES + ("d_final_s", "d_final_b")
    print(f"{name} at {label}: " + ", ".join(
        f"{n} {r:.3e}" for n, r in zip(names, rels)))
    if not all(math.isfinite(r) and r < REL_BAR for r in rels):
        raise AssertionError(f"{name} at {label}: rel {rels}")
    return max((x.float() - y).abs().max().item() for x, y in zip(got, ref))


def check_bwd_kernels(dev) -> dict:
    """K5 and K7 against their plain fp32 backward at vit_small block
    shapes (B=8, and B=32 as the FT run drives them) and vit_base (B=2);
    the largest abs error over the outputs at vit_small."""
    errs = {}
    for label, B, D in (("vit_small", 8, 384), ("vit_small", 32, 384),
                        ("vit_base", 2, 768)):
        gen = torch.Generator().manual_seed(2)
        t = block_inputs(gen, B, D, dev)
        g = torch.randn(B, 197, D, generator=gen).to(dev).bfloat16()
        for name, (kern, _, plain32) in bwd_calls(t, g, 12).items():
            err = hold_bwd(name, f"{label} (B={B}, D={D})", kern, plain32)
            if label == "vit_small" and name in {k[0] for k in KERNELS}:
                errs[name] = max(errs.get(name, 0.0), err)
    return errs


# K5 and K7 against the chains they ran before: label, B, N, D, heads
# (vit_small's blocks at B=8, 32 and 256; vit_base's, K6 and K8, at B=2 and
# 16; N=50 at head_dim 32, 64 and 128; head_dim 128 at N=208 and N=256, the
# attention-backward core's two- and one-slot rings)
BWD_FORMER_SHAPES = (("vit_small", 8, 197, 384, 12),
                     ("vit_small", 32, 197, 384, 12),
                     ("vit_small", 256, 197, 384, 12),
                     ("vit_base", 2, 197, 768, 12),
                     ("vit_base", 16, 197, 768, 12),
                     ("N=50, head_dim 32", 8, 50, 384, 12),
                     ("N=50, head_dim 64", 8, 50, 384, 6),
                     ("N=50, head_dim 128", 8, 50, 384, 3),
                     ("N=208, head_dim 128", 4, 208, 384, 3),
                     ("N=256, head_dim 128", 4, 256, 384, 3))


def check_bwd_former(dev) -> dict:
    """K5, K7 and K3's backward (its epilogue LayerNorm backward, then K7)
    at BWD_FORMER_SHAPES against the chains K5 and K7 ran before
    (``fused_attention_block_bwd_wmma``, ``fused_mlp_block_bwd_wmma``) on
    the same bf16 inputs: the count of outputs that differ, over all seven,
    must be 0 (every stage keeps its former one's rounding points and sum
    order), and each output within REL_BAR of the plain fp32 backward.
    Returns label -> [K5's, K7's, K3's outputs that differ]."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    out = {}
    for label, B, N, D, heads in BWD_FORMER_SHAPES:
        gen = torch.Generator().manual_seed(12)
        t = block_inputs(gen, B, D, dev, N=N)
        g = torch.randn(B, N, D, generator=gen).to(dev).bfloat16()
        scale = (D // heads) ** -0.5
        a = [g] + [t[k] for k in ATTN[:-1]]
        m = [g] + [t[k] for k in MLP[:-1]]
        g2 = fm.final_ln_bwd(g, *[t[k] for k in MLP], t["fs"])[0]
        m3 = [g2] + m[1:]
        halves = (
            ("fused_attention_block_bwd",
             lambda: fa.fused_attention_block_bwd(*a, heads, scale),
             lambda: fa.fused_attention_block_bwd_wmma(*a, heads, scale),
             lambda: fa.fused_attention_block_bwd_plain(
                 *[v.float() for v in a], heads, scale)),
            ("fused_mlp_block_bwd", lambda: fm.fused_mlp_block_bwd(*m),
             lambda: fm.fused_mlp_block_bwd_wmma(*m),
             lambda: fm.fused_mlp_block_bwd_plain(*[v.float() for v in m])),
            ("fused_mlp_block_final_ln's K7", lambda: fm.fused_mlp_block_bwd(*m3),
             lambda: fm.fused_mlp_block_bwd_wmma(*m3),
             lambda: fm.fused_mlp_block_bwd_plain(*[v.float() for v in m3])))
        out[f"{label} B={B} N={N}"] = diffs = []
        for name, kern, former, plain32 in halves:
            got = kern()
            ref = former()
            torch.cuda.synchronize()
            n_diff = sum((x != y).sum().item() for x, y in zip(got, ref))
            n_out = sum(x.numel() for x in got)
            rels = [rel(x, y) for x, y in zip(got, plain32())]
            print(f"{name} at {label} (B={B}, N={N}, D={D}, {heads} heads): "
                  f"{n_diff} of {n_out} outputs differ from its former chain; "
                  "rel vs plain fp32 " + ", ".join(
                      f"{n} {r:.3e}" for n, r in zip(BWD_NAMES, rels)))
            if n_diff or not all(math.isfinite(r) and r < REL_BAR
                                 for r in rels):
                raise AssertionError(f"{name} at {label} B={B}: {n_diff} "
                                     f"outputs differ, rel {rels}")
            diffs.append(n_diff)
    return out


BWD_STAGES = {f"{op} D={D}": (op, dict(B=B, D=D))
              for B, D in ((256, 384), (64, 768))
              for op in ("k5", "k7", "k5_wmma", "k7_wmma")}


def fresh_stage_times(specs: dict) -> dict:
    """``tools/compare_block.stage_times(dev, op, **kw)`` for each name ->
    (op, kw) of ``specs``, in order, in a fresh process of its own, whose
    lines print here: a ``torch.profiler`` window opened late in a long
    process loses launches (by the time phase of this script, some of
    K5's and all of K15's), one in a fresh process sees them all.
    name -> {kernel: ms}."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stages.json")
        code = ("import json, sys, torch\n"
                f"sys.path.insert(0, {here!r})\n"
                "from mfvit_tpu_torch.tools.compare_block import "
                "stage_times\n"
                "dev = torch.device('cuda')\n"
                f"out = {{k: stage_times(dev, op, **kw) for k, (op, kw) in "
                f"{specs!r}.items()}}\n"
                f"json.dump(out, open({path!r}, 'w'))\n")
        sys.stdout.flush()
        subprocess.run([sys.executable, "-c", code], check=True, cwd=here,
                       timeout=900)
        with open(path) as f:
            return json.load(f)


def write_covid_ds(root: str, n: int, seed: int, paired: bool = False,
                   n_eval: int = 0) -> str:
    """n synthetic PNGs in the ``--covid-ds`` layout (with ``paired`` an
    enhanced 'Train_Mix' image beside each 'data' one): every image in the
    train manifest (1_labeled_train_0.txt), the two halves as val and test
    (with ``n_eval``, the first n_eval and the next n_eval). Returns the
    manifest folder."""
    import cv2

    from mfvit_tpu_torch.data.manifest import write_covid_manifest
    rng = np.random.default_rng(seed)
    images = os.path.join(root, "images")
    man = os.path.join(root, "create_covid_dataset")
    folders = ("data", "Train_Mix") if paired else ("data",)
    for folder in folders:
        os.makedirs(os.path.join(images, folder))
    os.makedirs(man)
    names = [f"img_{i:03d}.png" for i in range(n)]
    labels = [i % 3 for i in range(n)]
    yy, xx = np.mgrid[0:256, 0:288]
    for i, fn in enumerate(names):
        for folder in folders:
            img = rng.integers(0, 60, (256, 288, 3), np.uint8)
            img += ((np.sin(xx / (9 + i % 7)) + np.cos(yy / 13)) * 60
                    + 100 + 30 * labels[i]).astype(np.uint8)[..., None]
            cv2.imwrite(os.path.join(images, folder, fn), img)
    half = n_eval or n // 2
    for fname, sl in (("1_labeled_train_0.txt", slice(0, n)),
                      ("val_ds.txt", slice(0, half)),
                      ("test_ds.txt", slice(half, 2 * half))):
        write_covid_manifest(os.path.join(man, fname), images, names[sl],
                             labels[sl])
    return man


def write_moco(path: str, cfg, seed: int) -> dict:
    """A MoCo ``.pth.tar`` in the reference layout from seeded weights:
    both towers' encoders under ``module.{base,momentum}_encoder.`` with a
    projector as their ``head.*``. Returns the base encoder's state."""
    from mfvit_tpu_torch.nn.vit import ViT
    sd = {}
    base = None
    for i, tower in enumerate(("base_encoder", "momentum_encoder")):
        enc = ViT(cfg, generator=torch.Generator().manual_seed(seed + i))
        state = enc.state_dict()
        base = base or state
        for k, v in state.items():
            sd[f"module.{tower}.{k}"] = v
        sd[f"module.{tower}.head.0.weight"] = torch.randn(
            256, cfg.dim, generator=torch.Generator().manual_seed(seed))
    torch.save({"epoch": 0, "arch": cfg.name, "state_dict": sd}, path)
    return base


def run_training(dev, tmp: str, img: int = 224) -> dict:
    """FT then LP through ``cli.finetune.main`` (vit_small, B=32, two
    epochs over 64 images) at 224 px; FT alone at 384 px (B=8, one epoch
    over 32 images). Returns the FT run's launch counts."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import finetune
    from mfvit_tpu_torch.nn.vit import get_config

    cfg = get_config("vit_small", img)
    n, bs, epochs = (64, 32, 2) if img == 224 else (32, 8, 1)
    man = write_covid_ds(os.path.join(tmp, "ds"), n, seed=5)
    moco = os.path.join(tmp, "moco.pth.tar")
    base = write_moco(moco, cfg, seed=6)
    argv = ["-a", "vit_small", "-b", str(bs), "--epochs", str(epochs),
            "--draws", "1", "--img-size", str(img), "--crop", str(img),
            "--pretrained", moco, "--covid-ds", man, "--lr", "0.01",
            "-j", "8", "-p", "1", "--device", dev.type]
    counts = {}
    for mode in ("FT", "LP") if img == 224 else ("FT",):
        root = os.path.join(tmp, mode)
        extra = ["--semi-supervised"] if mode == "FT" else []
        ops.reset_launch_counts()
        res = finetune.main(argv + extra + ["--storage-root", root])[0]
        torch.cuda.synchronize()
        got = ops.launch_counts()
        losses = res.extra["train_losses"]
        steps, evals = len(losses), res.extra["eval_batches"]
        fwd = steps + evals
        want = {k: 0 for k in got}  # K4, K10, K11 and, under LP, K5/K7
        want.update({k: v * fwd for k, v in PER_VIT[img].items()})
        if mode == "FT":
            want.update({k: v * steps for k, v in PER_STEP[img].items()})
        print(f"{mode} at {img} px: {steps} steps, {evals} eval batches, losses "
              + ", ".join(f"{v:.4f}" for v in losses)
              + f"; launch counts {got}")
        if steps != 4 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{mode}: losses {losses}")
        if got != want:
            raise AssertionError(f"{mode}: launch counts {got} != {want}")
        exp = next(os.scandir(root)).path
        last = torch.load(os.path.join(exp, "train_1_0", "last_checkpoint"),
                          weights_only=True)
        moved = [k for k, v in base.items() if not torch.equal(last[k], v)]
        print(f"{mode}: {len(moved)} of {len(base)} backbone entries "
              f"changed; test auc {res.test_auc:.4f}")
        if mode == "FT" and not any(k.startswith("blocks.") for k in moved):
            raise AssertionError("FT left the backbone blocks unchanged")
        if mode == "LP" and moved:
            raise AssertionError(f"LP changed frozen weights: {moved[:4]}")
        counts[mode] = got
    return counts["FT"]


def train_parity(dev, B: int = 32, img: int = 224) -> None:
    """Three SGD steps of the kernel path and of the plain path (bf16 on
    the card) from the same weights and batch of B images at ``img`` px."""
    import copy

    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train import optim, steps

    gen = torch.Generator().manual_seed(8)
    model0 = ViT(get_config("vit_small", img), 3, generator=gen)
    imgs = torch.randn(B, img, img, 3, generator=gen).to(dev).bfloat16()
    labels = torch.randint(0, 3, (B,), generator=gen).to(dev)
    runs = {}
    for ref in (False, True):
        model = copy.deepcopy(model0).to(dev)
        opt = optim.build_optimizer("sgd", model.named_parameters(), 0.01,
                                    momentum=0.9, weight_decay=1e-6)
        step, _ = steps.make_classifier_steps(reference=ref)
        losses, grads = [], None
        for i in range(3):
            loss, _ = step(model, opt, imgs, labels)
            losses.append(loss.item())
            if i == 0:
                grads = [torch.cat([p.grad.flatten() for p in blk.parameters()])
                         for blk in model.blocks]
        runs[ref] = (losses, grads)
    (lk, gk), (lp, gp) = runs[False], runs[True]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    grad_rel = [rel(a, b) for a, b in zip(gk, gp)]
    print(f"train-step parity (vit_small, B={B}, {img} px, 3 SGD steps): "
          "losses kernel "
          + ", ".join(f"{v:.5f}" for v in lk) + " plain "
          + ", ".join(f"{v:.5f}" for v in lp) + "; loss rel "
          + ", ".join(f"{v:.3e}" for v in loss_rel)
          + f" (bar {PARITY_LOSS_BAR}); first-step gradient rel per block "
          + ", ".join(f"{v:.3e}" for v in grad_rel)
          + f" (bar {PARITY_GRAD_BAR})")
    if not (max(loss_rel) < PARITY_LOSS_BAR
            and max(grad_rel) < PARITY_GRAD_BAR):
        raise AssertionError("train-step parity out of its bar")


def time_bwd(dev, label: str, B: int, D: int) -> dict:
    """K5 and K7 at a block of batch B and width D (12 heads, hidden 4D):
    each held against its plain fp32 backward on the timed inputs (the
    K-split geometry depends on B), then timed."""
    gen = torch.Generator().manual_seed(9)
    t = block_inputs(gen, B, D, dev)
    g = torch.randn(B, 197, D, generator=gen).to(dev).bfloat16()
    times = {}
    for name, (kern, plain, plain32) in bwd_calls(t, g, 12).items():
        hold_bwd(name, f"{label} (B={B}, D={D})", kern, plain32)
        if plain is None:
            continue
        k1, p1, p2, k2 = (cuda_ms(f, n) for f, n in ((kern, 10), (plain, 3),
                                                     (plain, 3), (kern, 10)))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"{name} at {label} B={B}: kernel {k1:.3f}/{k2:.3f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms (bf16)")
    return times


def time_train(dev, B: int, iters: int, img: int = 224) -> dict:
    """Images/s of the FT train step (forward, backward, SGD step, loss
    fetched every step) at batch B and ``img`` px, kernel path against
    plain path."""
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train import optim, steps

    gen = torch.Generator().manual_seed(10)
    imgs = torch.randn(B, img, img, 3, generator=gen).to(dev).bfloat16()
    labels = torch.randint(0, 3, (B,), generator=gen).to(dev)
    model = ViT(get_config("vit_small", img), 3, device=dev, generator=gen)
    opt = optim.build_optimizer("sgd", model.named_parameters(), 1e-4,
                                momentum=0.9)
    fns = {k: steps.make_classifier_steps(reference=k == "plain")[0]
           for k in ("kernel", "plain")}

    def rate(which: str) -> float:
        fns[which](model, opt, imgs, labels)[0].item()
        t0 = time.perf_counter()
        for _ in range(iters):
            fns[which](model, opt, imgs, labels)[0].item()
        return B * iters / (time.perf_counter() - t0)

    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        runs[which].append(rate(which))
    print(f"FT train step at B={B}, {img} px (bf16, forward + backward + SGD, loss "
          "fetched every step): " + ", ".join(
              f"{k} {' / '.join(f'{r:.1f}' for r in v)} images/s"
              for k, v in runs.items()))
    return {k: sum(v) / len(v) for k, v in runs.items()}


# K15's shapes: label, B, N, D, heads (head_dim 128 at D=384: 3 heads)
K15_SHAPES = (("vit_small", 8, 197, 384, 12),
              ("vit_small_ori", 8, 197, 384, 6), ("N=50", 8, 50, 384, 12),
              ("head_dim 128", 8, 197, 384, 3))
K15_KEYS = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj", "ln_s",
            "ln_b", "w1", "b1", "w2", "b2")
K15_GRADS = ("dx", "dln1_s", "dln1_b", "dwqkv", "dbqkv", "dwproj", "dbproj",
             "dln2_s", "dln2_b", "dw1", "db1", "dw2", "db2")


# The redesigned K1 and K2 against the chains they ran before (the
# check-only ``fused_attention_block_wmma`` and ``fused_mlp_block_wmma``):
# label, B, N, D, heads. K15's shapes, a partial last row tile (B=3: 591
# rows, 9 tiles of the tail's 64 rows and 5 of the GEMM's 128), the tail's
# other widths, and a vit_base block (D=768: K2's three-launch route); then
# shapes where a block of the attention core walks several (image, head)
# pairs of few query tiles (N=50, B=64) and where a GEMM block walks
# several tiles of more K slices than its ring holds (vit_base, B=16: fc1
# 12 slices, fc2 48, 7 stages): there a ring's wait, which tells the
# rounds of a stage apart by parity alone, passes on the round before
# unless the walk keeps in step with the ring.
HALVES_SHAPES = K15_SHAPES + (("B=3", 3, 197, 384, 12),
                              ("D=128", 4, 197, 128, 4),
                              ("D=256", 4, 197, 256, 4),
                              ("D=512", 4, 197, 512, 8),
                              ("vit_base", 2, 197, 768, 12),
                              ("N=50, B=64", 64, 50, 384, 12),
                              ("vit_base, B=16", 16, 197, 768, 12))


def check_halves(dev) -> dict:
    """K1 and K2 at HALVES_SHAPES on bf16 inputs with non-zero biases: equal
    bit for bit to the chains they ran before (every rounding point and sum
    order kept: the count of outputs that differ must be 0) and within
    REL_BAR of their plain fp32 versions; one call launches its own kernel
    once and no other. Returns label -> [K1's, K2's outputs that differ]."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    out = {}
    for label, B, N, D, heads in HALVES_SHAPES:
        t = block_inputs(torch.Generator().manual_seed(11), B, D, dev, N=N)
        scale = (D // heads) ** -0.5
        a, m = [t[k] for k in ATTN], [t[k] for k in MLP]
        a32, m32 = [v.float() for v in a], [v.float() for v in m]
        halves = (
            ("fused_attention_block",
             lambda: fa.fused_attention_block(*a, heads, scale),
             lambda: fa.fused_attention_block_wmma(*a, heads, scale),
             lambda: fa.fused_attention_block_plain(*a32, heads, scale)),
            ("fused_mlp_block", lambda: fm.fused_mlp_block(*m),
             lambda: fm.fused_mlp_block_wmma(*m),
             lambda: fm.fused_mlp_block_plain(*m32)))
        out[label] = []
        for name, kern, former, plain32 in halves:
            ops.reset_launch_counts()
            with torch.no_grad():
                got = kern()
                torch.cuda.synchronize()
                counts = {k: v for k, v in ops.launch_counts().items() if v}
                n_diff = (got != former()).sum().item()
                r = rel(got, plain32())
            print(f"{name} at {label} (B={B}, N={N}, D={D}, {heads} heads): "
                  f"{n_diff} of {got.numel()} outputs differ from its former "
                  f"chain; rel vs plain fp32 {r:.3e}; launches {counts}")
            if n_diff or not (math.isfinite(r) and r < REL_BAR) \
                    or counts != {name: 1}:
                raise AssertionError(f"{name} at {label}: {n_diff} outputs "
                                     f"differ, rel {r}, launches {counts}")
            out[label].append(n_diff)
    return out


# K4 against its former design: label, B, N, D, heads (the fusion heads
# that run, 3 at every width as the CLIs default: vit_small's, 3 heads of
# 128, and vit_base's, 3 of 256; 12 heads of 64 at vit_base's width; then
# both at 384 px, N=577, 37 chunks of the pass's 16-row ring)
K4_SHAPES = tuple((f"B={B}, N={N}, D={D}, {heads} heads", B, N, D, heads)
                  for B, N, D, heads in [
                      (B, N, D, heads) for B in (1, 3, 8, 256)
                      for N in (197, 50)
                      for D, heads in ((384, 3), (768, 3), (768, 12))]
                  + [(64, 577, 384, 3), (16, 577, 768, 3)])


def k4_controls(tok_c, tok_e, flat, heads: int) -> dict:
    """label -> a wrong K4 on these inputs, the kernel itself run on
    wrong operands: ``u from W_v`` (u_h built from W_v in place of W_k:
    wkv = [W_v; W_v]) and ``no scale`` (W_q times head_dim ** 0.5, so the
    scores' head_dim ** -0.5 is undone)."""
    from mfvit_tpu_torch.ops import fused_fusion as ff
    D = tok_c.shape[-1]
    swapped, unscaled = list(flat), list(flat)
    for d in (0, 8):
        wv = flat[d + 3][D:]
        swapped[d + 3] = torch.cat([wv, wv]).contiguous()
        unscaled[d + 2] = (flat[d + 2].float()
                           * (D // heads) ** 0.5).to(flat[d + 2].dtype)
    return {"u from W_v": lambda: torch.cat(ff._fusion_cuda(
                tok_c, tok_e, swapped, heads)),
            "no scale": lambda: torch.cat(ff._fusion_cuda(
                tok_c, tok_e, unscaled, heads))}


def check_heads(dev) -> dict:
    """K3 at HALVES_SHAPES against the chain it ran before
    (``fused_mlp_block_final_ln_wmma``: the outputs that differ must be 0)
    and K4 at K4_SHAPES against its former design (``fused_fusion_cls_kv``:
    rel < K4_FORMER_BAR, which every ``k4_controls`` entry must fail), each
    within REL_BAR of its plain fp32 version; one call launches its own
    kernel once and no other. Every reading is printed before a failure
    raises. Returns {"k3": label -> outputs that differ, "k4": label ->
    rel against the former design}."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ops import fused_fusion as ff
    from mfvit_tpu_torch.ops import fused_mlp as fm
    out, bad = {"k3": {}, "k4": {}}, []

    def launched(kern):
        ops.reset_launch_counts()
        got = kern()
        torch.cuda.synchronize()
        return got, {k: v for k, v in ops.launch_counts().items() if v}

    with torch.no_grad():
        for label, B, N, D, heads in HALVES_SHAPES:
            t = block_inputs(torch.Generator().manual_seed(11), B, D, dev, N=N)
            m, fin = [t[k] for k in MLP], (t["fs"], t["fb"])
            got, counts = launched(
                lambda: fm.fused_mlp_block_final_ln(*m, *fin))
            former = fm.fused_mlp_block_final_ln_wmma(*m, *fin)
            n_diff = (got != former).sum().item()
            ulps = (got.view(torch.int16).int()
                    - former.view(torch.int16).int()).abs().max().item()
            r = rel(got, fm.fused_mlp_block_final_ln_plain(
                *[v.float() for v in m], *fin))
            print(f"fused_mlp_block_final_ln at {label} (B={B}, N={N}, "
                  f"D={D}): {n_diff} of {got.numel()} outputs differ from its "
                  f"former "
                  f"chain (at most {ulps} ulps); rel vs plain fp32 {r:.3e}; "
                  f"launches {counts}")
            if n_diff or not (math.isfinite(r) and r < REL_BAR) \
                    or counts != {"fused_mlp_block_final_ln": 1}:
                bad.append(f"K3 at {label}: {n_diff} outputs differ, rel {r}, "
                           f"launches {counts}")
            out["k3"][label] = n_diff
        for label, B, N, D, heads in K4_SHAPES:
            tok_c, tok_e, flat = fusion_inputs(
                torch.Generator().manual_seed(12), B, D, dev, N=N)
            got, counts = launched(lambda: torch.cat(ff.fused_fusion_cls(
                tok_c, tok_e, flat, heads)))
            former = torch.cat(ff.fused_fusion_cls_kv(tok_c, tok_e, flat,
                                                      heads))
            rf = rel(got, former)
            r = rel(got, torch.cat(ff.fused_fusion_cls_plain(
                tok_c.float(), tok_e.float(), [v.float() for v in flat],
                heads)))
            rcs = {k: rel(fn(), former)
                   for k, fn in k4_controls(tok_c, tok_e, flat, heads).items()}
            print(f"fused_fusion_cls at {label}: rel vs its former design "
                  f"{rf:.3e} (bar {K4_FORMER_BAR}); rel vs plain fp32 "
                  f"{r:.3e}; controls " + ", ".join(
                      f"{k} {v:.3e}" for k, v in rcs.items())
                  + f"; launches {counts}")
            if not (math.isfinite(rf) and rf < K4_FORMER_BAR) \
                    or not (math.isfinite(r) and r < REL_BAR) \
                    or counts != {"fused_fusion_cls": 1}:
                bad.append(f"K4 at {label}: rel vs former {rf}, vs plain fp32 "
                           f"{r}, launches {counts}")
            bad += [f"K4 at {label}: the control '{k}' passes (rel {v} < "
                    f"{K4_FORMER_BAR})" for k, v in rcs.items()
                    if not v >= K4_FORMER_BAR]
            out["k4"][label] = rf
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def k15_calls(t, heads: int):
    """(K15, the K1 -> K2 kernel chain, K15's plain version) on one
    block's inputs, and K15's arguments."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_block as fb
    from mfvit_tpu_torch.ops import fused_mlp as fm
    a = [t[k] for k in K15_KEYS]
    scale = (t["x"].shape[-1] // heads) ** -0.5
    return ((lambda: fb.fused_transformer_block(*a, heads, scale)),
            (lambda: fm.fused_mlp_block(
                fa.fused_attention_block(*a[:7], heads, scale), *a[7:])),
            (lambda: fb.fused_transformer_block_plain(*a, heads, scale)), a)


def check_block_kernel(dev) -> float:
    """K15 at K15_SHAPES on bf16 inputs with non-zero biases: equal to the
    K1 -> K2 kernel chain bit for bit, within REL_BAR of its plain fp32
    version, and its 13 gradients (via torch.autograd.grad) each within
    REL_BAR of the plain fp32 backward; one forward launches K15 once and
    nothing else, a forward and backward K15, K1, K7 and K5 once each. At
    the vit_base block (D=768) it must raise the ValueError that names its
    limit. Returns the largest abs error at vit_small."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ops import fused_block as fb
    err = 0.0
    for label, B, N, D, heads in K15_SHAPES:
        gen = torch.Generator().manual_seed(15)
        t = block_inputs(gen, B, D, dev, N=N)
        k15, chain, _, a = k15_calls(t, heads)
        scale = (D // heads) ** -0.5
        ops.reset_launch_counts()
        with torch.no_grad():
            got = k15()
            torch.cuda.synchronize()
            fwd = {k: v for k, v in ops.launch_counts().items() if v}
            same = chain()
            ref = fb.fused_transformer_block_plain(*[v.float() for v in a],
                                                   heads, scale)
        r = rel(got, ref)
        n_diff = (got != same).sum().item()
        leaves = [v.detach().clone().requires_grad_() for v in a]
        g = torch.randn(B, N, D, generator=gen).to(dev).bfloat16()
        ops.reset_launch_counts()
        grads = torch.autograd.grad(
            fb.fused_transformer_block(*leaves, heads, scale), leaves, g)
        torch.cuda.synchronize()
        bwd = {k: v for k, v in ops.launch_counts().items() if v}
        l32 = [v.detach().float().requires_grad_() for v in a]
        want = torch.autograd.grad(fb.fused_transformer_block(
            *l32, heads, scale, plain=True), l32, g.float())
        rels = [rel(d, w) for d, w in zip(grads, want)]
        print(f"fused_transformer_block at {label} (B={B}, N={N}, D={D}, "
              f"{heads} heads): {n_diff} of {got.numel()} outputs differ "
              f"from the K1 -> K2 chain; rel vs plain fp32 {r:.3e}; "
              "gradients rel vs the plain fp32 backward " + ", ".join(
                  f"{n} {v:.2e}" for n, v in zip(K15_GRADS, rels))
              + f"; launches: forward {fwd}, forward + backward {bwd}")
        if n_diff:
            raise AssertionError(f"K15 at {label}: {n_diff} outputs differ "
                                 "from the K1 -> K2 chain")
        if not (math.isfinite(r) and r < REL_BAR
                and all(math.isfinite(v) and v < REL_BAR for v in rels)):
            raise AssertionError(f"K15 at {label}: rel {r}, gradients {rels}")
        if fwd != PER_K15_FWD or bwd != PER_K15_FWD_BWD:
            raise AssertionError(f"K15 at {label}: launches {fwd}, {bwd}")
        if label == "vit_small":
            err = (got.float() - ref).abs().max().item()
    t = block_inputs(torch.Generator().manual_seed(15), 1, 768, dev)
    try:
        fb.fused_transformer_block(*[t[k] for k in K15_KEYS], 12, 64 ** -0.5)
    except ValueError as e:
        print(f"fused_transformer_block at the vit_base block (D=768): "
              f"refused as it should be: {e}")
    else:
        raise AssertionError("K15 took D=768, past the limit it states")
    return err


# The probe of K15's GEMM core against K1's and K2's: label, N, K, epilogue
# (ops.gemm's), at M = 8 x 197 (K1's qkv, K2's fc1 and fc2 at B=8), and the
# labels also timed at B=256
PROBE_SHAPES = (("qkv", 1152, 384, "bias"), ("fc1", 1536, 384, "gelu"),
                ("fc2", 384, 1536, "bias"),
                ("fc2 + residual", 384, 1536, "resid"))
PROBE_TIMED = ("qkv", "fc1")


def probe_inputs(seed: int, M: int, N: int, K: int, dev) -> list:
    """a (M, K), w (N, K), bias (N,) fp32, resid (M, N) for one GEMM."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g).bfloat16()
    w = (torch.randn(N, K, generator=g) * K ** -0.5).bfloat16()
    b = torch.randn(N, generator=g) * 0.1
    r = torch.randn(M, N, generator=g).bfloat16()
    return [v.to(dev) for v in (a, w, b, r)]


def probe_gemm(dev, M: int = 8 * 197) -> dict:
    """The wgmma core (``ops.gemm.gemm_sm90``, K15's) beside the WMMA core
    (``gemm_ln``, K1's and K2's, no LN prologue) on the same bf16 inputs at
    PROBE_SHAPES: how many outputs differ (whether a wgmma k16 step rounds
    as mma.sync's does), each core within REL_BAR of the plain fp32
    version. Every count must be 0: K15 runs its sums on the wgmma core
    and is held equal to the K1 -> K2 chain bit for bit. Returns label ->
    outputs that differ."""
    from mfvit_tpu_torch.ops import gemm
    out = {}
    for label, N, K, epi in PROBE_SHAPES:
        a, w, b, r = probe_inputs(30, M, N, K, dev)
        with torch.inference_mode():
            got = gemm.gemm_sm90(a, w, b, epi, r)
            ref = gemm.gemm_ln(a, w, b, epi, r)
            plain = gemm.gemm_plain(a.float(), w.float(), b, epi, r.float())
        n = (got != ref).sum().item()
        r_sm90, r_ln = rel(got, plain), rel(ref, plain)
        print(f"probe {label} (M={M}, N={N}, K={K}, epilogue {epi}): {n} of "
              f"{got.numel()} outputs of the wgmma core differ from "
              f"gemm_ln's (max |diff| "
              f"{(got.float() - ref.float()).abs().max().item():.3e}); rel "
              f"vs plain fp32: wgmma {r_sm90:.3e}, gemm_ln {r_ln:.3e}")
        if not (math.isfinite(r_sm90) and r_sm90 < REL_BAR and r_ln < REL_BAR):
            raise AssertionError(f"probe {label}: rel {r_sm90}, {r_ln}")
        out[label] = n
    if any(out.values()):  # K15's bit-for-bit gates rest on equal sums
        raise AssertionError(f"the wgmma core differs from gemm_ln: {out}")
    return out


# The backward products of K5 and K7 at vit_small (D=384, hidden 1536):
# label, form (ops.gemm's), M-side and N-side widths, reduced width (None:
# the token rows, a TN product over launch.k_split's slices)
PROBE_BWD_SHAPES = (("dWqkv", "tn", 1152, 384, None),
                    ("dW2", "tn", 384, 1536, None),
                    ("dW1", "tn", 1536, 384, None),
                    ("dO", "nn", None, 384, 384),
                    ("dh", "nn_f32", None, 384, 1152),
                    ("dh1", "nn_f32", None, 384, 1536))


def probe_gemm_bwd(dev, rows=(8 * 197, 256 * 197)) -> dict:
    """The MN-major forms of the wgmma core (``ops.gemm.gemm_mn``, K5's and
    K7's products) beside gemm_bwd.cuh's WMMA GEMMs (``gemm_bwd``, their
    former chains') on the same bf16 inputs at PROBE_BWD_SHAPES, B=8 and
    B=256 (there a block walks two tiles or more, each of more K slices
    than the ring has stages): how many outputs (and column sums) differ,
    which must be 0, and each within REL_BAR of the plain fp32 version.
    Returns "label B=.." -> outputs that differ."""
    from mfvit_tpu_torch.ops import gemm, launch
    out = {}
    for M in rows:
        for label, form, mo, no, k in PROBE_BWD_SHAPES:
            g = torch.Generator().manual_seed(32)
            if form == "tn":
                S, kc = launch.k_split(M, (mo // 128) * (no // 128), 32)
                a = torch.randn(M, mo, generator=g).bfloat16().to(dev)
                b = torch.randn(M, no, generator=g).bfloat16().to(dev)
                shape = f"K={M}, M={mo}, N={no}, S={S}, kc={kc}"
            else:
                S, kc = 1, 0
                a = torch.randn(M, k, generator=g).bfloat16().to(dev)
                b = (torch.randn(k, no, generator=g) * k ** -0.5).bfloat16()
                b = b.to(dev)
                shape = f"M={M}, N={no}, K={k}"
            with torch.inference_mode():
                got = gemm.gemm_mn(a, b, form, S, kc)
                ref = gemm.gemm_bwd(a, b, form, S, kc)
                plain = gemm.gemm_bwd_plain(a, b, form)
            got, ref, plain = ((v,) if form != "tn" else v
                               for v in (got, ref, plain))
            n = sum((x != y).sum().item() for x, y in zip(got, ref))
            rs = [rel(x, y) for x, y in zip(got, plain)]
            rl = [rel(x, y) for x, y in zip(ref, plain)]
            print(f"probe {label} ({form}, {shape}): {n} of "
                  f"{sum(x.numel() for x in got)} outputs of the wgmma core "
                  f"differ from gemm_bwd.cuh's; rel vs plain fp32: wgmma "
                  + "/".join(f"{r:.3e}" for r in rs) + ", WMMA "
                  + "/".join(f"{r:.3e}" for r in rl))
            if not all(math.isfinite(r) and r < REL_BAR for r in rs + rl):
                raise AssertionError(f"probe {label}: rel {rs}, {rl}")
            out[f"{label} B={M // 197}"] = n
    if any(out.values()):  # K5's and K7's bit-for-bit gates rest on these
        raise AssertionError(f"the MN-major forms differ from gemm_bwd: {out}")
    return out


def time_gemm(dev, M: int = 256 * 197) -> dict:
    """The two cores at PROBE_TIMED's shapes at B=256, in turns (wgmma,
    gemm_ln, gemm_ln, wgmma). label -> (wgmma ms, gemm_ln ms, wgmma TFLOP/s,
    gemm_ln TFLOP/s)."""
    from mfvit_tpu_torch.ops import gemm
    out = {}
    for label, N, K, epi in PROBE_SHAPES:
        if label not in PROBE_TIMED:
            continue
        a, w, b, r = probe_inputs(31, M, N, K, dev)
        fns = (lambda: gemm.gemm_sm90(a, w, b, epi, r),
               lambda: gemm.gemm_ln(a, w, b, epi, r))
        with torch.inference_mode():
            s1, l1, l2, s2 = (cuda_ms(fns[i], 20) for i in (0, 1, 1, 0))
        flop = 2 * M * N * K
        ms = ((s1 + s2) / 2, (l1 + l2) / 2)
        out[label] = (*ms, flop / ms[0] / 1e9, flop / ms[1] / 1e9)
        print(f"GEMM {label} at B=256 (M={M}, N={N}, K={K}): wgmma core "
              f"{s1:.4f}/{s2:.4f} ms ({out[label][2]:.1f} TFLOP/s), gemm_ln "
              f"{l1:.4f}/{l2:.4f} ms ({out[label][3]:.1f} TFLOP/s)")
    return out


def run_bench_block(dev) -> tuple:
    """K15's main path, ``mfvit_tpu_torch.tools.bench_block.run`` (B=512,
    N=197, D=384, 12 blocks; pair, K15, K15, pair, each a warm-up and
    ``bench_block.ITERS`` timed chains): launch counts K15, K1 and K2 12
    per chain of theirs, every other kernel 0; both chains' checksums
    equal. Then, outside the counted run, one block on the tool's own
    inputs: K15 within REL_BAR of its plain version on the upcast inputs
    and equal to the K1 -> K2 pair bit for bit.
    Returns (counts, {name: (ms, checksum)})."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_block as fb
    from mfvit_tpu_torch.ops import fused_mlp as fm
    from mfvit_tpu_torch.tools import bench_block as bb
    ops.reset_launch_counts()
    res = bb.run(dev, 512, 12)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {k: 0 for k in counts}  # each chain ran 2 * (1 + bb.ITERS)
    want.update({k: v * 12 * 2 * (1 + bb.ITERS)
                 for k, v in PER_BENCH_BLOCK.items()})
    print(f"bench_block launch counts {counts}")
    if counts != want:
        raise AssertionError(f"bench_block launch counts {counts} != {want}")
    sums = [v[1] for v in res.values()]
    if not (math.isfinite(sums[0]) and sums[0] == sums[1]):
        raise AssertionError(f"bench_block checksums differ: {res}")
    x, p = bb.make_inputs(512, dev)
    a = [p[k] for k in bb.ATTN + bb.MLP]
    with torch.inference_mode():
        got = fb.fused_transformer_block(x, *a, bb.HEADS, bb.SCALE)
        pair = fm.fused_mlp_block(fa.fused_attention_block(
            x, *a[:6], bb.HEADS, bb.SCALE), *a[6:])
        ref = fb.fused_transformer_block_plain(
            x.float(), *[v.float() for v in a], bb.HEADS, bb.SCALE)
    r, n_diff = rel(got, ref), (got != pair).sum().item()
    del ref
    print(f"bench_block's inputs, one block (B=512): K15 rel vs plain fp32 "
          f"{r:.3e} (bar {REL_BAR}); {n_diff} of {got.numel()} outputs "
          "differ from the K1 -> K2 pair")
    if not (math.isfinite(r) and r < REL_BAR) or n_diff:
        raise AssertionError(f"K15 on bench_block's inputs: rel {r}, "
                             f"{n_diff} outputs differ from the pair")
    return counts, res


# The schedule variants' shapes: label, B, N, D, heads. The MLP variants
# run at the 12-head shapes (their heads do not matter); B=3 leaves
# mlp_pipe's last row tile ragged (591 rows: 79 of 128), and every N=197 image ends in
# a ragged tile of T6's and T7's per-image walks. T1 takes an even cb, so
# it skips B=3 and runs B=6 at cb=2; N=208 is the attention variants'
# limit at head_dim 128.
VARIANT_SHAPES = (("vit_small", 8, 197, 384, 12), ("N=50", 8, 50, 384, 12),
                  ("B=3", 3, 197, 384, 12), ("B=6", 6, 197, 384, 12),
                  ("D=512", 4, 197, 512, 8),
                  ("vit_small_ori", 8, 197, 384, 6),
                  ("head_dim 128", 8, 197, 384, 3),
                  ("head_dim 128, N=208", 8, 208, 384, 3))
# the schedule argument each op takes by default: the kernel report's time
VARIANT_DEFAULT = {"mlp3d": dict(cb=4, flat=True), "mlp3d_staged": dict(cb=4),
                   "mlp_pipe": dict(splits=2, tm=128), "attn_staged": dict(cb=2),
                   "attn_pairs": dict(cb=4), "attn_rolling": dict(cb=8),
                   "staged_bwd": dict(cb=2)}


def variant_settings(name: str, B: int, D: int) -> list:
    """The schedule arguments of ``name`` that its tool sweeps and the
    kernel takes at batch B and width D (cb=1 where no swept cb divides
    B, cb=2 for T1, none for T1 at an odd B); mlp_pipe's sweep holds its
    two controls (splits=1 at tm=128: no ping-pong; tm=64: K2's tile), and
    tm=128 only where D takes it."""
    from mfvit_tpu_torch.ops import mlp_variants as mv
    from mfvit_tpu_torch.tools import bench_attn_pairs as bap
    from mfvit_tpu_torch.tools import bench_bwd_staged as bbs
    from mfvit_tpu_torch.tools import bench_mlp3d as bm
    from mfvit_tpu_torch.tools import bench_pipelined as bp
    from mfvit_tpu_torch.tools import bench_rolling as br
    if name == "mlp_pipe":
        return [dict(splits=s, tm=tm) for s, tm in bp.PIPE_SWEEP
                if tm != mv.PIPE_ROWS or D in mv.PIPE_WIDTHS]
    if name == "attn_pairs" and B % 2:
        return []  # its cb is even
    sweep = {"attn_staged": bp.CBS, "attn_pairs": bap.CBS,
             "attn_rolling": br.CBS, "staged_bwd": bbs.CBS}.get(name, bm.CBS)
    cbs = ([cb for cb in sweep if B % cb == 0]
           or [2 if name == "attn_pairs" else 1])
    if name == "mlp3d":
        return [dict(cb=cb, flat=f) for f in (True, False) for cb in cbs]
    return [dict(cb=cb) for cb in cbs]


def variant_call(name: str, t, heads: int, kw: dict):
    """The variant ``name`` (or a former design named in FORMER_VARIANTS)
    on one block's inputs (T5: and the cotangent t["g"]) at schedule
    ``kw``."""
    from mfvit_tpu_torch.ops import attn_variants as av
    from mfvit_tpu_torch.ops import mlp_variants as mv
    a = [t[k] for k in ATTN]
    scale = (t["x"].shape[-1] // heads) ** -0.5
    if name.startswith("staged_bwd"):
        op = getattr(av, name)
        return lambda: op(t["g"], *a[:6], heads, scale, **kw)
    if name.startswith(ATTN_VARIANTS):
        op = getattr(av, name)
        return lambda: op(*a, heads, scale, **kw)
    op, m = getattr(mv, name), [t[k] for k in MLP]
    return lambda: op(*m, **kw)


def as_tuple(v) -> tuple:
    """A kernel's outputs as a tuple (T5 and K5 return seven)."""
    return v if isinstance(v, tuple) else (v,)


def variant_inputs(seed: int, B: int, N: int, D: int, dev) -> dict:
    """One block's inputs with a bf16 cotangent ``g`` for T5 and K5."""
    gen = torch.Generator().manual_seed(seed)
    t = block_inputs(gen, B, D, dev, N=N)
    t["g"] = torch.randn(B, N, D, generator=gen).to(dev).bfloat16()
    return t


def variant_bases(t, heads: int) -> dict:
    """The variants' base kernels on ``t``: name -> (kernel, plain in the
    inputs' dtype, plain in fp32), K1 and K2 from ``base_calls``, K5 from
    ``bwd_calls``."""
    calls = base_calls(t, heads)
    calls["fused_attention_block_bwd"] = bwd_calls(t, t["g"], heads)[
        "fused_attention_block_bwd"]
    return calls


def check_variant_kernels(dev) -> dict:
    """T6, T7, T3, T4, T1, T2 and T5 at VARIANT_SHAPES, bf16 inputs (and
    T5's cotangent) from a seed with non-zero biases (b2 included), at
    every schedule argument their tools sweep: equal to K2 (T4, T1, T2: K1;
    T5: K5 on all seven outputs) bit for bit, and to their former designs
    (FORMER_VARIANTS), within REL_BAR of the plain fp32
    version (each output); one call launches the variant once and no
    other kernel (the former designs count none). Then every shape and
    argument the ops refuse must raise."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ops import attn_variants as av
    from mfvit_tpu_torch.ops import mlp_variants as mv
    with torch.no_grad():
        for label, B, N, D, heads in VARIANT_SHAPES:
            t = variant_inputs(17, B, N, D, dev)
            base = {k: (as_tuple(kern()), as_tuple(plain32()))
                    for k, (kern, _, plain32) in variant_bases(t, heads).items()}
            for name, _, _, base_name in VARIANTS:
                if base_name == "fused_mlp_block" and heads != 12:
                    continue
                same, ref = base[base_name]
                for kw in variant_settings(name, B, D):
                    ops.reset_launch_counts()
                    got = as_tuple(variant_call(name, t, heads, kw)())
                    was = (as_tuple(variant_call(
                        FORMER_VARIANTS[name], t, heads,
                        former_kw(name, kw, D))())
                           if name in FORMER_VARIANTS else got)
                    torch.cuda.synchronize()
                    counts = {k: v for k, v in ops.launch_counts().items()
                              if v}
                    r = max(rel(a, b) for a, b in zip(got, ref))
                    n_diff = sum((a != b).sum().item()
                                 for a, b in zip(got, same))
                    n_former = sum((a != b).sum().item()
                                   for a, b in zip(got, was))
                    numel = sum(a.numel() for a in got)
                    print(f"{name} {kw} at {label} (B={B}, N={N}, D={D}, "
                          f"{heads} heads): rel vs plain fp32 {r:.3e}; "
                          f"{n_diff} of {numel} outputs differ from "
                          f"{base_name}" + (
                              f", {n_former} from its former design"
                              if name in FORMER_VARIANTS else "")
                          + f"; launches {counts}")
                    if n_diff or n_former or counts != {name: 1}:
                        raise AssertionError(
                            f"{name} {kw} at {label}: {n_diff} outputs off "
                            f"{base_name}, {n_former} off its former "
                            f"design, launches {counts}")
                    if not (math.isfinite(r) and r < REL_BAR):
                        raise AssertionError(f"{name} {kw} at {label}: rel "
                                             f"{r}")
        t = block_inputs(torch.Generator().manual_seed(17), 8, 384, dev)
        m, a = [t[k] for k in MLP], [t[k] for k in ATTN]
        wide = block_inputs(torch.Generator().manual_seed(17), 1, 768, dev)
        d512 = block_inputs(torch.Generator().manual_seed(17), 2, 512, dev)
        long = block_inputs(torch.Generator().manual_seed(17), 2, 384, dev,
                            N=209)
        la = [long[k] for k in ATTN]
        refusals = {
            "attn_pairs cb=1 (odd)": lambda: av.attn_pairs(
                *a, 12, 32 ** -0.5, cb=1),
            "attn_rolling cb=3 at B=8": lambda: av.attn_rolling(
                *a, 12, 32 ** -0.5, cb=3),
            "staged_bwd cb=3 at B=8": lambda: av.staged_bwd(
                a[0], *a[:6], 12, 32 ** -0.5, cb=3),
            "attn_pairs at head_dim 128, N=209": lambda: av.attn_pairs(
                *la, 3, 128 ** -0.5, cb=2),
            "attn_pairs_wmma cb=1 (odd)": lambda: av.attn_pairs_wmma(
                *a, 12, 32 ** -0.5, cb=1),
            "attn_pairs_wmma at head_dim 128, N=209": lambda:
                av.attn_pairs_wmma(*la, 3, 128 ** -0.5, cb=2),
            "attn_rolling at head_dim 128, N=209": lambda: av.attn_rolling(
                *la, 3, 128 ** -0.5, cb=2),
            "staged_bwd at head_dim 128, N=209": lambda: av.staged_bwd(
                la[0], *la[:6], 3, 128 ** -0.5, cb=2),
            "mlp3d cb=3 at B=8": lambda: mv.mlp3d(*m, cb=3),
            "mlp3d_staged cb=16 at B=8": lambda: mv.mlp3d_staged(*m, cb=16),
            "attn_staged cb=3 at B=8": lambda: av.attn_staged(
                *a, 12, 32 ** -0.5, cb=3),
            "mlp_pipe splits=3 tm=64": lambda: mv.mlp_pipe(*m, splits=3,
                                                           tm=64),
            "mlp_pipe splits=4 tm=32": lambda: mv.mlp_pipe(*m, splits=4,
                                                           tm=32),
            "mlp_pipe splits=2 tm=64": lambda: mv.mlp_pipe(*m, splits=2,
                                                           tm=64),
            "mlp_pipe tm=128 at D=512": lambda: mv.mlp_pipe(
                *[d512[k] for k in MLP], splits=2, tm=128),
            "mlp3d at D=768": lambda: mv.mlp3d(*[wide[k] for k in MLP],
                                               cb=1),
            "attn_staged at head_dim 128, N=209": lambda: av.attn_staged(
                *[long[k] for k in ATTN], 3, 128 ** -0.5, cb=2),
        }
    refusals["mlp3d on a weight that requires grad"] = lambda: mv.mlp3d(
        m[0], m[1], m[2], m[3].clone().requires_grad_(), *m[4:], cb=2)
    for what, call in refusals.items():
        try:
            call()
        except (ValueError, RuntimeError) as e:
            print(f"refused as it should be: {what}: {e}")
        else:
            raise AssertionError(f"{what} was taken")


def chain_kernels(name: str) -> tuple:
    """The kernels one block of the tool chain ``name`` launches."""
    attn = {"attn_staged": "attn_staged", "pairs": "attn_pairs",
            "rolling": "attn_rolling"}.get(name.split()[0],
                                           "fused_attention_block")
    if name.startswith("mlp3d"):
        mlp = "mlp3d_staged" if "staged" in name else "mlp3d"
    else:
        mlp = "mlp_pipe" if "mlp_pipe" in name else "fused_mlp_block"
    return attn, mlp


def run_variant_tools(dev, batch: int = 512, depth: int = 12) -> tuple:
    """The variants' main path: ``mfvit_tpu_torch.tools.bench_mlp3d.run``,
    ``bench_pipelined.run``, ``bench_attn_pairs.run`` and
    ``bench_rolling.run`` at B=512, 12 blocks, and ``bench_bwd_staged.run``
    at its B=256, 12 backwards a chain, each chain a warm-up and
    ``bench_block.ITERS`` timed runs. Launch counts per tool equal to what
    its chains launch (``bench_bwd_staged``: and its agreement run, one K5
    and one T5), every other kernel 0; every chain's checksum equal to the
    baseline's (each variant equals its base kernel bit for bit), and
    ``bench_bwd_staged``'s agreement 0 on every output. Then one 12-block
    ``mlp3d staged cb=4`` chain: ``mlp3d_staged`` 12 and K1 12. Then
    ``hold_variants_at_tool_size``. Returns (the variants' launches in the
    tools' runs, {tool: {chain: (ms, checksum)}}, {variant: largest abs
    error against plain fp32 at the tools' size})."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.tools import bench_attn_pairs as bap
    from mfvit_tpu_torch.tools import bench_block as bb
    from mfvit_tpu_torch.tools import bench_bwd_staged as bbs
    from mfvit_tpu_torch.tools import bench_mlp3d as bm
    from mfvit_tpu_torch.tools import bench_pipelined as bp
    from mfvit_tpu_torch.tools import bench_rolling as br
    launches, lines = {}, {}
    for tool in (bm, bp, bap, br, bbs):
        tag = tool.__name__.rsplit(".", 1)[-1]
        ops.reset_launch_counts()
        if tool is bbs:
            res, agree = tool.run(dev, bbs.BATCH, depth)
        else:
            res = tool.run(dev, batch, depth)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {k: 0 for k in counts}
        for name, cb, _ in tool.chains():
            if tool is bbs:
                kernels = ("staged_bwd",) if cb else (
                    "fused_attention_block_bwd",)
            else:
                kernels = chain_kernels(name)
            tb = bbs.BATCH if tool is bbs else batch
            for k in kernels:
                want[k] += depth * (1 + bb.ITERS) * (tb % (cb or 1) == 0)
        if tool is bbs:
            want["fused_attention_block_bwd"] += 1
            want["staged_bwd"] += 1
            if any(v != 0.0 for v in agree.values()):
                raise AssertionError(f"{tag}: T5 off K5 {agree}")
        print(f"{tag} launch counts {counts}")
        if counts != want:
            raise AssertionError(f"{tag} launch counts {counts} != {want}")
        sums = {k: v[1] for k, v in res.items()}
        base = next(iter(sums.values()))
        if not math.isfinite(base) or any(v != base for v in sums.values()):
            raise AssertionError(f"{tag} checksums differ: {sums}")
        launches.update({k: counts[k] for k, *_ in VARIANTS if counts[k]})
        lines[tag] = res
    x, p = bb.make_inputs(batch, dev)
    ops.reset_launch_counts()
    with torch.inference_mode():
        bm.chain_of(lambda *w: bm.mlp3d_staged(*w, cb=4))(x, p, depth)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"one {depth}-block mlp3d staged cb=4 chain: launches {counts}")
    if counts != {"mlp3d_staged": depth, "fused_attention_block": depth}:
        raise AssertionError(f"the staged chain launched {counts}")
    return launches, lines, hold_variants_at_tool_size(dev, batch)


def hold_variants_at_tool_size(dev, batch: int) -> dict:
    """One block of each variant on the tools' own inputs
    (``bench_block.make_inputs(batch)``; the MLP variants take K1's output,
    as in the first block of a chain; T5 one backward on
    ``bench_bwd_staged``'s B=256 inputs and g0) at every schedule argument
    its tool sweeps (``variant_settings``): equal to K2 (T4, T1, T2: K1;
    T5: K5, every output) on the same input bit for bit (and to their
    former designs), and within
    REL_BAR of its plain fp32 version (the op with ``plain=True`` on the
    upcast inputs; each output). The chains' checksums alone cannot tell a
    handful of wrong outputs among 38.7M. Returns the largest abs error
    against plain fp32 of each variant."""
    from mfvit_tpu_torch.ops import attn_variants as av
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    from mfvit_tpu_torch.ops import mlp_variants as mv
    from mfvit_tpu_torch.tools import bench_block as bb
    from mfvit_tpu_torch.tools import bench_bwd_staged as bbs
    x, p = bb.make_inputs(batch, dev)
    a, w = [p[k] for k in bb.ATTN], [p[k] for k in bb.MLP]
    g0, pb = bbs.make_bwd_inputs(bbs.BATCH, dev)
    ab = [pb["x"]] + [pb[k] for k in bb.ATTN[:-1]]
    errs = {}
    with torch.inference_mode():
        y = fa.fused_attention_block(x, *a, bb.HEADS, bb.SCALE)
        base = {"fused_attention_block": (y,),
                "fused_mlp_block": (fm.fused_mlp_block(y, *w),),
                "fused_attention_block_bwd": fa.fused_attention_block_bwd(
                    g0, *ab, bb.HEADS, bb.SCALE)}
        for name, _, _, base_name in VARIANTS:
            B = batch
            if name == "staged_bwd":
                B, inp, args = bbs.BATCH, g0, ab
                op = functools.partial(av.staged_bwd, heads=bb.HEADS,
                                       scale=bb.SCALE)
            elif name in ATTN_VARIANTS:
                inp, args = x, a
                op = functools.partial(getattr(av, name), heads=bb.HEADS,
                                       scale=bb.SCALE)
            else:
                inp, args, op = y, w, getattr(mv, name)
            args32 = [v.float() for v in args]
            for kw in variant_settings(name, B, bb.D):
                got = as_tuple(op(inp, *args, **kw))
                ref = as_tuple(op(inp.float(), *args32, **kw, plain=True))
                r = max(rel(u, v) for u, v in zip(got, ref))
                n_diff = sum((u != v).sum().item()
                             for u, v in zip(got, base[base_name]))
                if name in FORMER_VARIANTS:
                    former = FORMER_VARIANTS[name]
                    fop = (getattr(mv, former) if hasattr(mv, former)
                           else functools.partial(getattr(av, former),
                                                  heads=bb.HEADS,
                                                  scale=bb.SCALE))
                    was = as_tuple(fop(inp, *args,
                                       **former_kw(name, kw, bb.D)))
                    n_diff += sum((u != v).sum().item()
                                  for u, v in zip(got, was))
                errs[name] = max(errs.get(name, 0.0), max(
                    (u.float() - v).abs().max().item()
                    for u, v in zip(got, ref)))
                del ref
                print(f"the tools' inputs, one block (B={B}): {name} "
                      f"{kw}: rel vs plain fp32 {r:.3e} (bar {REL_BAR}); "
                      f"{n_diff} of {sum(u.numel() for u in got)} outputs "
                      f"differ from {base_name}" + (
                          " or its former design" if name in FORMER_VARIANTS
                          else ""))
                if n_diff or not (math.isfinite(r) and r < REL_BAR):
                    raise AssertionError(
                        f"{name} {kw} on the tools' inputs at B={B}: rel "
                        f"{r}, {n_diff} outputs differ from {base_name}")
    return errs


def time_variants(dev) -> dict:
    """Each variant at each schedule argument its tool sweeps against its
    base kernel at vit_small B=256, in one call (variant, base, base,
    variant), first held equal to the base kernel on the timed inputs; then
    the plain versions (K2's, K1's, K5's) twice each. Returns {(name,
    setting): (ms, base ms)} and {base name: plain ms}."""
    t = variant_inputs(18, 256, 197, 384, dev)
    calls = variant_bases(t, 12)
    out = {}
    with torch.inference_mode():
        for name, _, _, base_name in VARIANTS:
            kern = calls[base_name][0]
            for kw in variant_settings(name, 256, 384):
                var = variant_call(name, t, 12, kw)
                if not all(torch.equal(u, v) for u, v in zip(
                        as_tuple(var()), as_tuple(kern()))):
                    raise AssertionError(f"{name} {kw} differs from "
                                         f"{base_name} at B=256")
                v1, b1, b2, v2 = (cuda_ms(f, 10) for f in (var, kern, kern,
                                                           var))
                setting = " ".join(f"{k}={v}" for k, v in kw.items())
                out[(name, setting)] = ((v1 + v2) / 2, (b1 + b2) / 2)
                print(f"{name} {setting} at B=256: kernel {v1:.3f}/{v2:.3f} "
                      f"ms, {base_name} {b1:.3f}/{b2:.3f} ms")
        plain = {}
        for base_name, (_, plain_bf16, _) in calls.items():
            p1, p2 = cuda_ms(plain_bf16, 3), cuda_ms(plain_bf16, 3)
            plain[base_name] = (p1 + p2) / 2
            print(f"{base_name}'s plain version at B=256: {p1:.3f}/{p2:.3f} "
                  "ms (bf16)")
    return out, plain


class _Tee:
    """Stands in for sys.stdout: prints, and keeps a copy of the text."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _captured(main, argv) -> tuple:
    """(``main(argv)``, what it printed)."""
    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        res = main(argv)
    finally:
        sys.stdout = tee.out
    return res, "".join(tee.parts)


def _teed(main, argv) -> tuple:
    """(the first result of ``main(argv)``, what it printed)."""
    res, text = _captured(main, argv)
    return res[0], text


def fusion_head(arch: str, gen):
    """The vit_small fusion head of ``fuse``'s defaults for ``arch``: the
    CA head (3 heads) or the GPT head (8 blocks, 4 heads of 96, a
    394-token joint sequence), from ``gen``, on the CPU."""
    import argparse

    from mfvit_tpu_torch.cli.common import fusion_head as head
    from mfvit_tpu_torch.nn.vit import get_config
    args = argparse.Namespace(fusion_arch=arch, num_classes=3,
                              fusion_heads=3, cross_attn_depth=1,
                              multi_scale_enc_depth=1, gpt_layers=8)
    return head(args, get_config("vit_small"), gen)


def fusion_models(gen, arch: str = "ca"):
    """Two vit_small branches and the ``arch`` fusion head from ``gen``, on
    the CPU."""
    from torch import nn

    from mfvit_tpu_torch.nn.vit import ViT, get_config
    cfg = get_config("vit_small")
    return nn.ModuleDict({"cxr": ViT(cfg, 3, generator=gen),
                          "enh": ViT(cfg, 3, generator=gen),
                          "fus": fusion_head(arch, gen)})


def run_fusion(dev, tmp: str, arch: str = "ca") -> dict:
    """The fusion-training slice through ``cli.fuse.main --fusion-arch
    arch`` (vit_small, 224 px, B=32, one epoch over 64 synthetic pairs;
    the branches from seeded ViT files with non-zero biases, saved as
    ``finetune`` saves its ``model_best``; the GPT head at its default 8
    blocks): LP, then ``--semi-supervised``. Gates: two finite losses,
    launch counts per step (LP: K1 24, K2 22, K3 2, K4 1 (0 for the GPT
    head), K5 0, K7 0; ``--semi-supervised`` the same plus K5 24, K7 24)
    plus one paired forward per eval batch, the LP sanity-check line (and
    only under LP), ``model_best`` equal to the run's last state. Then
    ``infer.main --fusion-arch arch`` on the last run's ``model_best``
    over the 32 val pairs: its decision logits equal those of
    ``eval_step`` on that state. Returns the launch counts of the
    ``--semi-supervised`` run."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import common, fuse, infer
    from mfvit_tpu_torch.exp.checkpoint import load_serving
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train.steps import make_fusion_steps

    cfg = get_config("vit_small")
    man = write_covid_ds(os.path.join(tmp, "pairs"), 64, seed=7, paired=True)
    branches = []
    for b, seed in (("cxr", 21), ("enh", 22)):
        gen = torch.Generator().manual_seed(seed)
        vit = ViT(cfg, 3, generator=gen)
        nonzero_biases(vit, gen)
        path = os.path.join(tmp, f"{b}_model_best")
        torch.save(vit.state_dict(), path)
        branches += [f"--pretrained-{b}", path]
    head = ["--fusion-arch", arch]
    argv = ["-a", "vit_small", "-b", "32", "--epochs", "1", "--draws", "1",
            "--covid-ds", man, "--lr", "1e-3", "-j", "8", "-p", "1",
            "--device", dev.type] + head + branches
    counts = {}
    for semi in (False, True):
        mode = f"{arch} " + ("--semi-supervised" if semi else "LP")
        root = os.path.join(tmp, f"fuse_{arch}_" + ("semi" if semi else "lp"))
        ops.reset_launch_counts()
        tee = _Tee(sys.stdout)
        sys.stdout = tee
        try:
            res = fuse.main(argv + ["--storage-root", root]
                            + (["--semi-supervised"] if semi else []))[0]
        finally:
            sys.stdout = tee.out
        torch.cuda.synchronize()
        got = ops.launch_counts()
        losses = res.extra["train_losses"]
        steps, evals = len(losses), res.extra["eval_batches"]
        want = {k: 0 for k in got}
        want.update({k: v * steps
                     for k, v in PER_ARCH_STEP[arch][semi].items()})
        for k, v in PER_ARCH_FORWARD[arch].items():
            want[k] += v * evals
        text = "".join(tee.parts)
        sanity = "=> fusion sanity check passed." in text
        if STORE_NOTICE + "64 samples" not in text:
            raise AssertionError(f"fuse {mode}: no paired store notice")
        print(f"fuse {mode}: {steps} steps, {evals} eval batches, losses "
              + ", ".join(f"{v:.4f}" for v in losses)
              + f"; launch counts {got}; sanity-check line: {sanity}; test "
              f"auc {res.test_auc:.4f}")
        if steps != 2 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"fuse {mode}: losses {losses}")
        if got != want:
            raise AssertionError(f"fuse {mode}: launch counts {got} != {want}")
        if sanity == semi:
            raise AssertionError(f"fuse {mode}: sanity-check line {sanity}")
        sub = os.path.join(next(os.scandir(root)).path, "train_1_0")
        best = os.path.join(sub, "model_best")
        last = torch.load(os.path.join(sub, "last_checkpoint"),
                          weights_only=True)
        kept = torch.load(best, weights_only=True)
        if sorted(kept) != sorted(last) or not all(
                torch.equal(kept[k], last[k]) for k in last):
            raise AssertionError(f"fuse {mode}: model_best is not the run's "
                                 "last state")
        counts[semi] = got

    val = os.path.join(man, "val_ds.txt")
    argv = ["-a", "vit_small", "-b", "32", "--device", dev.type, "-j", "8",
            "--checkpoint", best, "--manifest", val, "--output",
            os.path.join(tmp, f"fuse_{arch}_predictions.json")] + head
    out = infer.main(argv)
    logits = torch.tensor(out["logits"])
    ck = load_serving(os.path.join(sub, "last_checkpoint"), cfg)
    models = fusion_models(torch.Generator().manual_seed(0), arch)
    for k, m in models.items():
        m.load_state_dict(ck[k], strict=True)
    models.to(dev).eval()
    _, eval_step = make_fusion_steps(fusion_arch=arch)
    args = infer.build_parser().parse_args(argv)
    loader = common.make_paired_loader(args, val)
    want = torch.cat([eval_step(models, *infer.prepare(b, dev, torch.bfloat16))
                      .float().cpu() for b in loader])[:out["n"]]
    d = (logits - want).abs().max().item()
    print(f"infer --fusion-arch {arch} on fuse's model_best: n {out['n']}, "
          f"decision logits max |diff| {d} against eval_step on the run's "
          "last state")
    if out["n"] != 32 or d != 0.0:
        raise AssertionError(f"infer --fusion-arch {arch} on fuse's "
                             f"model_best: n {out['n']}, max |diff| {d}")
    return counts[True]


def fusion_parity(dev, B: int = 32, arch: str = "ca") -> None:
    """Three Adam steps of the fusion train step with the ``arch`` head,
    the kernel path and the plain path (bf16 on the card) from the same
    weights and batch, LP and ``--semi-supervised``: the loss per step
    within PARITY_LOSS_BAR, the first-step gradient of the head (and under
    ``--semi-supervised`` of every branch block) within PARITY_GRAD_BAR."""
    import copy

    from mfvit_tpu_torch.cli.fuse import fusion_trainable_mask
    from mfvit_tpu_torch.train import optim, steps

    gen = torch.Generator().manual_seed(23)
    models0 = fusion_models(gen, arch)
    xc, xe = (torch.randn(B, 224, 224, 3, generator=gen).to(dev).bfloat16()
              for _ in range(2))
    labels = torch.randint(0, 3, (B,), generator=gen).to(dev)
    for semi in (False, True):
        runs = {}
        for ref in (False, True):
            models = copy.deepcopy(models0).to(dev)
            mask = (None if semi
                    else fusion_trainable_mask(models.named_parameters()))
            opt = optim.build_optimizer("adam", models.named_parameters(),
                                        1e-4, trainable_mask=mask)
            step, _ = steps.make_fusion_steps(freeze_backbones=not semi,
                                              reference=ref,
                                              fusion_arch=arch)
            losses, grads = [], None
            for i in range(3):
                loss, _ = step(models, opt, xc, xe, labels)
                losses.append(loss.item())
                if i == 0:
                    groups = [models["fus"]] + (
                        [*models["cxr"].blocks, *models["enh"].blocks]
                        if semi else [])
                    grads = [torch.cat([p.grad.flatten()
                                        for p in m.parameters()])
                             for m in groups]
            runs[ref] = (losses, grads)
        (lk, gk), (lp, gp) = runs[False], runs[True]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
        grad_rel = [rel(a, b) for a, b in zip(gk, gp)]
        mode = f"{arch} " + ("--semi-supervised" if semi else "LP")
        print(f"fusion train-step parity ({mode}, vit_small, B={B}, 3 Adam "
              "steps): losses kernel " + ", ".join(f"{v:.5f}" for v in lk)
              + " plain " + ", ".join(f"{v:.5f}" for v in lp)
              + "; loss rel " + ", ".join(f"{v:.3e}" for v in loss_rel)
              + f" (bar {PARITY_LOSS_BAR}); first-step gradient rel, head"
              + (" then each branch block" if semi else "") + " "
              + ", ".join(f"{v:.3e}" for v in grad_rel)
              + f" (bar {PARITY_GRAD_BAR})")
        if not (max(loss_rel) < PARITY_LOSS_BAR
                and max(grad_rel) < PARITY_GRAD_BAR):
            raise AssertionError(f"fusion train-step parity ({mode}) out of "
                                 "its bar")


def check_crossvit_cnn(dev, B: int = 32, seeds=(25, 28)) -> dict:
    """The ViT + CNN cross-attention head's forward
    (``models.crossvit_cnn.fused_forward``: a vit_small branch with
    non-zero biases, resnet18 and the head at its defaults, 3 heads of 64
    over the 7 x 7 x 512 map) at B=32, 224 px, bf16, for each seed: the
    kernel path against the plain path on the same weights and images.
    The ViT tokens the head reads and the logits each rel < REL_BAR (the
    serving slice's bar; the head at its init gives small logits, so the
    tokens are held too); the ViT branch launches K1 12, K2 11, K3 1 on
    the kernel path and nothing on the plain path. Returns the largest
    rel of each over the seeds."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.models import crossvit_cnn
    from mfvit_tpu_torch.nn import resnet
    from mfvit_tpu_torch.nn.vit import ViT, get_config

    worst = {"tokens": 0.0, "logits": 0.0}
    for seed in seeds:
        gen = torch.Generator().manual_seed(seed)
        vit = ViT(get_config("vit_small"), 3, generator=gen)
        nonzero_biases(vit, gen)
        cnn = resnet.ResNet(resnet.get_config("resnet18"), generator=gen)
        fus = crossvit_cnn.CrossViTCNN(generator=gen)
        vit, cnn, fus = (m.to(dev).eval() for m in (vit, cnn, fus))
        img = torch.randn(B, 224, 224, 3, generator=gen).to(dev,
                                                            torch.bfloat16)
        out, tok = {}, {}
        for ref in (False, True):
            ops.reset_launch_counts()
            with torch.inference_mode():
                out[ref] = crossvit_cnn.fused_forward(vit, cnn, fus, img,
                                                      reference=ref)
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            want = {} if ref else PER_VIT_FORWARD
            if counts != want:
                raise AssertionError(
                    f"crossvit_cnn.fused_forward (reference={ref}): launch "
                    f"counts {counts} != {want}")
            with torch.inference_mode():
                tok[ref] = vit(img, return_features=True, reference=ref)[0]
        r = {"tokens": rel(tok[False], tok[True]),
             "logits": rel(out[False], out[True])}
        finite = bool(torch.isfinite(out[False]).all())
        print(f"crossvit_cnn.fused_forward (vit_small + resnet18, B={B}, "
              f"bf16, seed {seed}): logits {tuple(out[False].shape)}, finite "
              f"{finite}; kernel path against plain path: ViT tokens rel "
              f"{r['tokens']:.3e}, logits rel {r['logits']:.3e} (bar "
              f"{REL_BAR}); launches {PER_VIT_FORWARD} on the kernel path, "
              "none on the plain path")
        if (not finite or out[False].shape != (B, 3)
                or not max(r.values()) < REL_BAR):
            raise AssertionError(f"crossvit_cnn.fused_forward: {r}")
        worst = {k: max(worst[k], r[k]) for k in worst}
    return worst


def nonzero_biases(model, gen) -> None:
    """Every bias of ``model`` N(0, 0.02), as a trained checkpoint's."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=gen)


@contextlib.contextmanager
def upcast_scores():
    """Within it the GPT head's scores are the fp32 product of the
    upcast q and k (its CPU route, and its CUDA route before the
    fp32-output GEMM), as the timings' comparison."""
    from mfvit_tpu_torch.models import gpt_fusion

    tensor_cores = gpt_fusion.bmm_f32
    gpt_fusion.bmm_f32 = lambda a, b: a.float() @ b.float()
    try:
        yield
    finally:
        gpt_fusion.bmm_f32 = tensor_cores


def check_score_product(head, tc, te, B: int) -> dict:
    """The GPT head's scores, ``nn.layers.bmm_f32`` (cuBLAS's fp32-output
    GEMM of the bf16 q and k), against the fp32 product of the upcast
    operands at the head's shape (B x 4 heads, 394 x 96): rel < 1e-5, as
    only the fp32 summation order differs. Then the head's logits on the
    two products: rel < REL_BAR (P is cast to bf16 after the softmax, so
    a score a rounding apart can move one P entry by a bf16 step). Also
    times one layer's score product both ways and returns the ms with
    its bound (q and k read, the fp32 scores written, at 3.35 TB/s; the
    products at bf16's 989 TFLOP/s take an eighth of that)."""
    from mfvit_tpu_torch.models import gpt_fusion

    g = torch.Generator().manual_seed(29)
    q, k = (torch.randn(B * 4, 394, 96, generator=g).to(tc.device,
                                                       torch.bfloat16)
            for _ in range(2))
    r_scores = rel(gpt_fusion.bmm_f32(q, k.mT), q.float() @ k.float().mT)
    ms = {"tensor_cores": cuda_ms(lambda: gpt_fusion.bmm_f32(q, k.mT), 10),
          "upcast": cuda_ms(lambda: q.float() @ k.float().mT, 10),
          "bound": (2 * q.numel() * 2 + B * 4 * 394 * 394 * 4) / 3.35e9}
    with torch.inference_mode():
        out = head(tc, te)
        with upcast_scores():
            upcast = head(tc, te)
    r_logits = rel(out, upcast)
    print(f"GPT head at B={B}: fp32-output score GEMM against the upcast "
          f"fp32 product rel {r_scores:.3e} (bar 1e-5); the head's logits "
          f"on the two rel {r_logits:.3e} (bar {REL_BAR}); one layer's "
          f"score product {ms['tensor_cores']:.3f} ms (upcast "
          f"{ms['upcast']:.3f}, bound {ms['bound']:.3f}, bytes)")
    if not r_scores < 1e-5 or not r_logits < REL_BAR:
        raise AssertionError(f"GPT score product: rel {r_scores}, logits "
                             f"{r_logits}")
    return ms


def time_gpt_head(dev, B: int) -> dict:
    """The GPT fusion head alone (vit_small's: 8 blocks, 4 heads of 96, a
    394-token joint sequence, bf16 with fp32 score products) on two seeded
    bf16 token streams at batch B: its forward and its forward + backward
    (the LP step's head), ms per call, two samples each, beside the same
    with ``upcast_scores`` (upcast, this, this, upcast); then one
    ``torch.profiler`` window over two forwards: the device ms per forward
    of the eight largest operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(26)
    head = fusion_head("gpt", gen).to(dev)
    tc, te = (torch.randn(B, 197, 384, generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))

    def fwd():
        with torch.inference_mode():
            return head(tc, te)

    def fwd_bwd():
        head(tc, te).sum().backward()

    score_ms = check_score_product(head, tc, te, B)
    def upcast(fn):
        def run():
            with upcast_scores():
                return fn()
        return run

    uf = [cuda_ms(fn, 5) for fn in (upcast(fwd), fwd, fwd, upcast(fwd))]
    ub = [cuda_ms(fn, 5) for fn in (upcast(fwd_bwd), fwd_bwd, fwd_bwd,
                                    upcast(fwd_bwd))]
    f1, f2, b1, b2 = uf[1], uf[2], ub[1], ub[2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fwd()
        torch.cuda.synchronize()
    by_op = {e.key: e.self_device_time_total / 2e3
             for e in prof.key_averages()
             if e.device_type == DeviceType.CPU
             and e.self_device_time_total > 0}
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    print(f"GPT fusion head at B={B} (upcast scores, these, these, upcast): "
          f"forward {'/'.join(f'{t:.3f}' for t in uf)} ms, forward + "
          f"backward {'/'.join(f'{t:.3f}' for t in ub)} ms; device ms per "
          "forward by operator: "
          + "; ".join(f"{k} {v:.2f}" for k, v in top))
    return {"forward_ms": (f1 + f2) / 2, "forward_backward_ms": (b1 + b2) / 2,
            "upcast_forward_ms": (uf[0] + uf[3]) / 2,
            "upcast_forward_backward_ms": (ub[0] + ub[3]) / 2,
            "profile_ms": dict(top), "score_product_ms": score_ms}


def time_gpt_serving(dev, B: int = 256) -> dict:
    """Serving pairs/s at batch B, 224 px, of ``make_fusion_forward(
    fusion_arch="gpt")``, the forward ``infer --fusion-arch gpt`` runs,
    beside the CA forward on the same branches and images: gpt,
    gpt_upcast, ca, gpt_plain, gpt_plain, ca, gpt_upcast, gpt (gpt_plain:
    the branches' plain versions; gpt_upcast: under ``upcast_scores``),
    the decision logits fetched every forward."""
    from mfvit_tpu_torch.train.steps import make_fusion_forward

    gen = torch.Generator().manual_seed(27)
    models = fusion_models(gen, "gpt").to(dev).eval()
    models_ca = dict(models, fus=fusion_head("ca", gen).to(dev).eval())
    xc, xe = (torch.randn(B, 224, 224, 3, generator=gen).to(dev,
                                                             torch.bfloat16)
              for _ in range(2))
    fwds = {"gpt": (make_fusion_forward(fusion_arch="gpt"), models),
            "gpt_plain": (make_fusion_forward(fusion_arch="gpt",
                                              reference=True), models),
            "ca": (make_fusion_forward(), models_ca)}

    def rate(which: str, iters: int = 5) -> float:
        fwd, ms = fwds[which.removesuffix("_upcast")]
        with (upcast_scores() if which.endswith("_upcast")
              else contextlib.nullcontext()):
            sum(fwd(ms, xc, xe)).cpu()
            t0 = time.perf_counter()
            for _ in range(iters):
                sum(fwd(ms, xc, xe)).cpu()
            return B * iters / (time.perf_counter() - t0)

    order = ("gpt", "gpt_upcast", "ca", "gpt_plain", "gpt_plain", "ca",
             "gpt_upcast", "gpt")
    runs = {k: [] for k in dict.fromkeys(order)}
    for which in order:
        runs[which].append(rate(which))
    print(f"serving --fusion-arch gpt at B={B}, 224 px (logits fetched every "
          "forward): " + ", ".join(
              f"{k} {' / '.join(f'{r:.1f}' for r in v)} pairs/s"
              for k, v in runs.items()))
    return {k: sum(v) / len(v) for k, v in runs.items()}


def moco_counts(per_tower_pass: dict, n_query: int, n_key: int) -> dict:
    """The launches of one MoCo step: each tower pass runs one ViT forward
    (``per_tower_pass``), each query pass also its backward (K5 and K7 a
    block)."""
    depth = per_tower_pass["fused_attention_block"]
    want = {k: v * (n_query + n_key) for k, v in per_tower_pass.items()}
    want.update(fused_attention_block_bwd=depth * n_query,
                fused_mlp_block_bwd=depth * n_query)
    return want


MOCO_INPUTS = (  # label, the pretrain flags of each new input
    ("in_chans_4", ["--in-chans", "4"]),
    ("moco_v2", ["--aug-setting", "moco_v2", "--crop-min", "0.2"]),
    ("enh_cxr", ["--pairing", "enh_cxr", "--per-enh", "0.5"]),
)


def pretrain_argv(man: str, root: str, dev, extra) -> list:
    """The ``cli.pretrain`` flags of this script's runs (vit_small, 224 px,
    MoCo's default heads and queue, B=32, two epochs, LARS with the
    warmup-cosine LR and the momentum ramp), then ``extra``."""
    return ["-a", "vit_small", "-b", "32", "--epochs", "2", "--draws", "1",
            "--cos", "--lr", "0.6", "--warmup-epochs", "1", "--moco-m-cos",
            "--moco-t", "0.2", "--stop-grad-conv1", "--covid-ds", man,
            "--storage-root", root, "--seed", "0", "-j", "8", "-p", "1",
            "--device", dev.type] + list(extra)


def run_pretrain(dev, tmp: str) -> dict:
    """MoCo pretraining through ``cli.pretrain.main`` (vit_small, 224 px,
    MoCo's default heads and K=65536 queue, v2 loss with the predictor on
    the keys, LARS with the warmup-cosine LR and the momentum ramp, B=32,
    two epochs over 64 synthetic images: four steps, ``--export-torch``).
    Gates: four finite losses, launch counts per step (K1 24, K2 22, K3 2,
    K5 12, K7 12, every other kernel 0), the queue pointer at 4 x 32 mod K
    in the last checkpoint, and the exported ``.pth.tar`` read back through
    ``load_moco_pretrained_backbone`` equal to that checkpoint's base
    encoder. Returns the launch counts per step."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import pretrain
    from mfvit_tpu_torch.exp.checkpoint import load_moco_pretrained_backbone
    from mfvit_tpu_torch.nn.vit import get_config

    man = write_covid_ds(os.path.join(tmp, "ds"), 64, seed=31)
    root = os.path.join(tmp, "moco")
    argv = pretrain_argv(man, root, dev, ["--export-torch"])
    ops.reset_launch_counts()
    res, text = _teed(pretrain.main, argv)
    torch.cuda.synchronize()
    if STORE_NOTICE + "64 samples" not in text:
        raise AssertionError("pretrain: no store notice")
    got = ops.launch_counts()
    losses = res.extra["train_losses"]
    steps = len(losses)
    per_step = moco_counts(PER_VIT_FORWARD, 1, 1)
    want = {k: 0 for k in got}
    want.update({k: v * steps for k, v in per_step.items()})
    print(f"pretrain (vit_small, B=32): {steps} steps, losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; launch counts {got}")
    if steps != 4 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"pretrain: losses {losses}")
    if got != want:
        raise AssertionError(f"pretrain: launch counts {got} != {want}")
    sub = os.path.join(next(os.scandir(root)).path, "train_1_0")
    last = torch.load(os.path.join(sub, "checkpoint_0001"),
                      weights_only=True)["state"]
    ptr = int(last["queue_ptr"])
    if ptr != 4 * 32 % 65536:
        raise AssertionError(f"pretrain: queue_ptr {ptr} != 128")
    back = load_moco_pretrained_backbone(
        os.path.join(sub, "checkpoint_torch.pth.tar"), get_config("vit_small"))
    enc = {k[len("base.encoder."):]: v for k, v in last.items()
           if k.startswith("base.encoder.")}
    differ = [k for k in enc if not torch.equal(back[k], enc[k])]
    print(f"pretrain: queue_ptr {ptr}; export read back: {len(back)} "
          f"entries, {len(differ)} differ from the base encoder")
    if set(back) != set(enc) or differ:
        raise AssertionError(f"pretrain export: {differ[:4]}, keys "
                             f"{sorted(set(back) ^ set(enc))[:4]}")
    return per_step


def run_pretrain_inputs(dev, tmp: str) -> dict:
    """``cli.pretrain.main`` under each input of MOCO_INPUTS (vit_small,
    224 px, B=32, two epochs over 64 synthetic image pairs, each row's
    'data' and 'Train_Mix' images: four steps), the launch counts set to 0
    just before each run and read just after. Gates per run: four finite
    losses, launch counts per step exactly ``moco_counts(PER_VIT_FORWARD,
    1, 1)`` (K1 24, K2 22, K3 2, K5 12, K7 12) and every other kernel 0,
    the queue pointer at 128 in the last checkpoint; for ``--in-chans 4``
    a (384, 4, 16, 16) patch weight. Returns {label: launches per step}."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import pretrain

    man = write_covid_ds(os.path.join(tmp, "ds"), 64, seed=35, paired=True)
    per_step = moco_counts(PER_VIT_FORWARD, 1, 1)
    out = {}
    for label, extra in MOCO_INPUTS:
        root = os.path.join(tmp, label)
        argv = pretrain_argv(man, root, dev, extra)
        ops.reset_launch_counts()
        res, text = _teed(pretrain.main, argv)
        torch.cuda.synchronize()
        # the canvas inputs train from the store, the host floats stream
        if (STORE_NOTICE + "64 samples" in text) != (label == "in_chans_4"):
            raise AssertionError(f"pretrain {label}: store notice "
                                 f"{STORE_NOTICE in text}")
        got = ops.launch_counts()
        losses = res.extra["train_losses"]
        steps = len(losses)
        want = {k: 0 for k in got}
        want.update({k: v * steps for k, v in per_step.items()})
        sub = os.path.join(next(os.scandir(root)).path, "train_1_0")
        last = torch.load(os.path.join(sub, "checkpoint_0001"),
                          weights_only=True)["state"]
        ptr = int(last["queue_ptr"])
        patch = tuple(last["base.encoder.patch_embed.proj.weight"].shape)
        print(f"pretrain {' '.join(extra)} (vit_small, B=32): {steps} "
              "steps, losses " + ", ".join(f"{v:.4f}" for v in losses)
              + f"; queue_ptr {ptr}; patch weight {patch}; launch counts "
              f"{got}")
        if steps != 4 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"pretrain {label}: losses {losses}")
        if got != want:
            raise AssertionError(f"pretrain {label}: launch counts {got} != "
                                 f"{want}")
        if ptr != 4 * 32 % 65536:
            raise AssertionError(f"pretrain {label}: queue_ptr {ptr} != 128")
        chans = 4 if label == "in_chans_4" else 3
        if patch != (384, chans, 16, 16):
            raise AssertionError(f"pretrain {label}: patch weight {patch}")
        out[label] = {k: v // steps for k, v in got.items() if v}
    return out


def time_pretrain_feeds(dev, tmp: str, epochs: int = 2) -> dict:
    """Images/s of each training feed ``cli.pretrain`` builds (B=32, -j 8,
    64 synthetic pairs at 256 x 288, ``epochs`` epochs, the first one's
    thread start included): the default two-view canvases, the stacked
    4-channel canvases, the BYOL moco_v2 host floats and the cross-modal
    host floats. Host work only (decode, PIL transforms, collation), so
    host-bound by construction; the card is not touched."""
    from mfvit_tpu_torch.cli import pretrain

    man = write_covid_ds(os.path.join(tmp, "feeds"), 64, seed=36,
                         paired=True)
    train = os.path.join(man, "1_labeled_train_0.txt")
    out = {}
    for label, extra in (("chexpert", []),) + MOCO_INPUTS:
        args = pretrain.build_parser().parse_args(
            pretrain_argv(man, tmp, dev, extra))
        loader, _ = pretrain.make_loader(args, train, 0)
        n = 0
        t0 = time.perf_counter()
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            for q, _, _ in loader:
                n += q.shape[0]
        out[label] = n / (time.perf_counter() - t0)
    print("pretrain feeds alone, host-bound (B=32, -j 8, "
          f"{os.cpu_count()} host cores): "
          + ", ".join(f"{k} {v:.1f} images/s" for k, v in out.items()))
    return out


def run_e2e_twin(dev, tmp: str) -> dict:
    """``mfvit_tpu_torch.tools.e2e_workflow`` at vit_small, 224 px:
    pretrain --export-torch, LP finetune from its .pth.tar, fuse from the
    LP model_best, infer on fuse's model_best. Gates: infer's metrics
    (AUC, top-1, precision, recall, F1) present and finite over the 8
    test pairs, and kernels launched on the way. Returns the metrics."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.tools import e2e_workflow

    ops.reset_launch_counts()
    out = e2e_workflow.main(["--root", os.path.join(tmp, "e2e"), "--device",
                             dev.type, "-a", "vit_small", "--img-size",
                             "224"])
    torch.cuda.synchronize()
    got = {k: v for k, v in ops.launch_counts().items() if v}
    metrics = out.get("metrics", {})
    print(f"e2e twin (vit_small, 224 px): infer on {out['n']} pairs, "
          f"metrics {metrics}; launch counts over the four stages {got}")
    names = {"auc", "top1", "precision", "recall", "f1"}
    if (out["n"] != 8 or set(metrics) < names
            or not all(math.isfinite(metrics[k]) for k in names)):
        raise AssertionError(f"e2e twin: {out['n']} pairs, {metrics}")
    for k in ("fused_attention_block", "fused_mlp_block_final_ln",
              "fused_fusion_cls", "fused_attention_block_bwd"):
        if not got.get(k):
            raise AssertionError(f"e2e twin: {k} never launched ({got})")
    return metrics


# The data path: the store's views on the card, the store's finetune runs
# and the CLIs' rates on each feed.
VIEW_TIE = 1e-4  # a differing pixel's exact source coordinate to a tie
VIEW_TIE_PIXELS = 64  # differing pixels allowed per view of B=256
H2D_STEP_BYTES = 4096  # the largest host-to-device copy inside a step
STORE_NOTICE = "=> device canvas store: "


def view_ties(got, want, draws, S: int) -> tuple:
    """(pixels where ``got`` != ``want``, the largest fp64 distance of
    such a pixel's source coordinate to a .5 tie): where the card's
    fp32 cos/sin or rounding can move a nearest-neighbour pick. Every
    difference without a rotation counts as at distance 1."""
    diff = (got != want).any(-1).nonzero().tolist()
    if not diff:
        return 0, 0.0
    if draws.deg is None:
        return len(diff), 1.0
    deg = draws.deg.cpu().double().numpy()
    tops, lefts = draws.tops.cpu().numpy(), draws.lefts.cpu().numpy()
    c = (S - 1) / 2.0
    worst = 0.0
    for b, y, x in diff:
        rad = deg[b] * math.pi / 180
        yy, xx = y + tops[b] - c, x + lefts[b] - c
        sx = math.cos(rad) * xx - math.sin(rad) * yy + c
        sy = math.sin(rad) * xx + math.cos(rad) * yy + c
        worst = max(worst, min(abs(sx - math.floor(sx) - 0.5),
                               abs(sy - math.floor(sy) - 0.5)))
    return len(diff), worst


def check_views(dev, B: int = 256) -> dict:
    """The store's training views on the card against their CPU versions
    given the same draws (bf16 out, rotate 10): ``augment_train_canvas``
    and both views of ``augment_two_views_canvas`` at 224 -> 224 and
    256 -> 224, 3 and 4 channels, B=256. Each view must equal its seeded
    replay from the same generator bit for bit, and the CPU version
    except at most VIEW_TIE_PIXELS pixels, each within VIEW_TIE of a
    rounding tie (printed). Then the card generator's draws: the crop
    corners cover [0, S - crop] with both ends hit, flips at about half,
    the angles over [-10, 10), one seed the same draws. Returns
    {case: (pixels differing, worst tie distance)}."""
    from mfvit_tpu_torch.data import device_aug as aug

    out = {}
    bf16 = torch.bfloat16
    for S, crop in ((224, 224), (256, 224)):
        for C, img_type in ((3, "data"), (4, "4ch")):
            canv = torch.from_numpy(np.random.default_rng(S + C).integers(
                0, 256, (B, S, S, C), dtype=np.uint8))
            cd = canv.to(dev)
            kw = dict(crop=crop, img_type=img_type, out_dtype=bf16)
            one = aug.augment_train_canvas(aug.epoch_generator(0, 0, 0, dev),
                                           cd, rotate_deg=10.0, **kw)
            two = aug.augment_two_views_canvas(
                aug.epoch_generator(0, 0, 1, dev), cd, rotate_deg=10.0, **kw)
            views = [("one", 0, one), ("q", 1, two[0]), ("k", 1, two[1])]
            gens = {e: aug.epoch_generator(0, 0, e, dev) for e in (0, 1)}
            for name, e, got in views:
                d = aug.draw_canvas_view(gens[e], cd.shape, crop=crop,
                                         rotate_deg=10.0)
                replay = aug.canvas_view(cd, d, **kw)
                if not torch.equal(got, replay):
                    raise AssertionError(f"view {name} {S}->{crop} C={C}: "
                                         "not its seeded replay")
                dc = aug.ViewDraws(*(t.cpu() for t in (d.flip, d.deg,
                                                       d.tops, d.lefts)))
                want = aug.canvas_view(canv, dc, **kw)
                n, worst = view_ties(got.cpu(), want, dc, S)
                label = f"{name} {S}->{crop} C={C}"
                out[label] = (n, worst)
                if n > VIEW_TIE_PIXELS or worst >= VIEW_TIE:
                    raise AssertionError(f"view {label}: {n} pixels differ "
                                         f"from the CPU, worst {worst}")
    print(f"store views on the card against the CPU (B={B}, bf16, rotate "
          "10; pixels differing, worst distance to a tie): "
          + ", ".join(f"{k} {n} ({w:.2e})" for k, (n, w) in out.items()))
    d = aug.draw_canvas_view(aug.epoch_generator(3, 0, 0, dev),
                             (65536, 256, 256, 3), crop=224)
    again = aug.draw_canvas_view(aug.epoch_generator(3, 0, 0, dev),
                                 (65536, 256, 256, 3), crop=224)
    flip = d.flip.float().mean().item()
    lo, hi = d.deg.min().item(), d.deg.max().item()
    ends = [(t.min().item(), t.max().item()) for t in (d.tops, d.lefts)]
    print(f"card draws (65536): tops and lefts {ends}, flip rate {flip:.4f},"
          f" angles [{lo:.4f}, {hi:.4f}]")
    if (ends != [(0, 32), (0, 32)] or not 0.49 < flip < 0.51
            or not (-10 <= lo < -9.99 and 9.99 < hi < 10)
            or not all(torch.equal(a, b) for a, b in zip(
                vars(d).values(), vars(again).values()))):
        raise AssertionError("card draws out of range or not replayed")
    return out


def time_views(dev, B: int = 256) -> dict:
    """ms of the store's view on the card at B=256 (bf16, rotate 10, 3
    channels): one view at 224 -> 224 and 256 -> 224, two views at 224,
    draws included; and the bound, the canvases read once and the view
    written once at 3.35 TB/s."""
    from mfvit_tpu_torch.data import device_aug as aug

    out = {}
    for S, crop, two in ((224, 224, False), (256, 224, False),
                         (224, 224, True)):
        cd = torch.from_numpy(np.random.default_rng(S).integers(
            0, 256, (B, S, S, 3), dtype=np.uint8)).to(dev)
        gen = aug.epoch_generator(0, 0, 0, dev)
        fn = aug.augment_two_views_canvas if two else aug.augment_train_canvas
        ms = cuda_ms(lambda: fn(gen, cd, crop=crop, img_type="data",
                                out_dtype=torch.bfloat16), 20)
        views = 2 if two else 1
        nbytes = B * S * S * 3 + views * B * crop * crop * 3 * 2
        label = f"{'two views' if two else 'one view'} {S}->{crop}"
        out[label] = {"ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    print(f"store view at B={B} (bf16): " + ", ".join(
        f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.4f})"
        for k, v in out.items()))
    return out


def h2d_in_steps(trace_path: str, steps_per_epoch: int) -> tuple:
    """From a ``torch.profiler`` chrome trace: the host-to-device copies
    issued inside each epoch's training steps (from the first step's
    start to the last step's end, steps marked ``mfv_train_step``), as
    (copies, their largest bytes, steps seen)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    size = {e["args"]["correlation"]: e["args"].get("bytes", 0)
            for e in events if e.get("cat") == "gpu_memcpy"
            and "HtoD" in e.get("name", "")}
    issued = [(e["ts"], size[e["args"]["correlation"]]) for e in events
              if e.get("cat") == "cuda_runtime"
              and e.get("args", {}).get("correlation") in size]
    marks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "mfv_train_step"
                   and e.get("cat") == "user_annotation")
    inside = []
    for i in range(0, len(marks), steps_per_epoch):
        epoch = marks[i:i + steps_per_epoch]
        lo, hi = epoch[0][0], epoch[-1][1]
        inside += [b for t, b in issued if lo <= t <= hi]
    return len(inside), max(inside, default=0), len(marks)


@contextlib.contextmanager
def marked_train_steps():
    """``steps.make_classifier_steps``'s train step inside a
    ``record_function("mfv_train_step")`` while the block runs."""
    from torch.profiler import record_function

    from mfvit_tpu_torch.train import steps

    orig = steps.make_classifier_steps

    def marked(**kw):
        train_step, eval_step = orig(**kw)

        def step(*a):
            with record_function("mfv_train_step"):
                return train_step(*a)
        return step, eval_step

    steps.make_classifier_steps = marked
    try:
        yield
    finally:
        steps.make_classifier_steps = orig


STORE_FEEDS = (("store", []), ("stream", ["--device-store-mb", "0"]),
               ("aug-host", ["--aug-host"]))


def run_store_finetune(dev, tmp: str) -> dict:
    """``finetune --semi-supervised`` at vit_small, 224 px, B=16, two
    epochs over 128 synthetic images (8 steps an epoch; 64 val, 64 test),
    three ways: the default flags (the device canvas store and eval
    stores), ``--device-store-mb 0`` and ``--aug-host``. Gates per run:
    16 finite losses, the exact launch counts (per step K1 12, K2 11, K3 1,
    K5 12, K7 12, per eval batch the forward's), the store notices in the
    store run only. The store and streaming runs under ``torch.profiler``:
    inside the store run's steps no host-to-device copy above
    H2D_STEP_BYTES (the streaming run's, printed beside it, carry the
    batch). Then the store run's last state evaluated on the val split
    through the eval store and through the streaming eval: logits max
    |diff| 0.0. Returns the per-run launches and the copies seen."""
    from torch.profiler import ProfilerActivity, profile

    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import common, finetune
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train import steps as steps_mod

    man = write_covid_ds(os.path.join(tmp, "ft"), 128, seed=41)
    argv = ["-a", "vit_small", "-b", "16", "--epochs", "2", "--draws", "1",
            "--covid-ds", man, "--lr", "0.01", "-j", "8", "-p", "1000",
            "--seed", "0", "--semi-supervised", "--device", dev.type]
    out = {}
    for label, extra in STORE_FEEDS:
        root = os.path.join(tmp, f"ft_{label}")
        ops.reset_launch_counts()
        tee = _Tee(sys.stdout)
        sys.stdout = tee
        prof = None
        try:
            if label == "aug-host":
                res = finetune.main(argv + extra + ["--storage-root", root])[0]
            else:
                with marked_train_steps(), profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    res = finetune.main(argv + extra
                                        + ["--storage-root", root])[0]
        finally:
            sys.stdout = tee.out
        torch.cuda.synchronize()
        got = ops.launch_counts()
        text = "".join(tee.parts)
        losses = res.extra["train_losses"]
        n_steps, evals = len(losses), res.extra["eval_batches"]
        want = {k: 0 for k in got}
        want.update({k: v * (n_steps + evals)
                     for k, v in PER_VIT_FORWARD.items()})
        want.update({k: v * n_steps for k, v in PER_FT_STEP.items()})
        notices = [ln for ln in text.splitlines() if "canvas store:" in ln]
        print(f"finetune FT, {label} feed (B=16, 128 images): {n_steps} "
              f"steps, {evals} eval batches; notices {notices}; launch "
              f"counts {got}")
        if n_steps != 16 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"finetune {label}: losses {losses}")
        if got != want:
            raise AssertionError(f"finetune {label}: launch counts {got} != "
                                 f"{want}")
        if (label == "store") != (len(notices) == 3):
            raise AssertionError(f"finetune {label}: store notices {notices}")
        run = {"launches": got}
        if prof is not None:
            path = os.path.join(tmp, f"trace_{label}.json")
            prof.export_chrome_trace(path)
            n, biggest, marks = h2d_in_steps(path, 8)
            run["h2d_copies_in_steps"], run["h2d_max_bytes"] = n, biggest
            print(f"  host-to-device copies inside the steps: {n} over "
                  f"{marks} steps, the largest {biggest} B")
            if marks != 16:
                raise AssertionError(f"profiler marked {marks} steps, not 16")
            if label == "store" and (n < 14 or biggest > H2D_STEP_BYTES):
                raise AssertionError(f"store run: {n} copies in its steps, "
                                     f"the largest {biggest} B")
            if label == "stream" and biggest <= H2D_STEP_BYTES:
                raise AssertionError("the streaming control shows no batch "
                                     f"copy in its steps ({biggest} B): the "
                                     "trace does not see the copies")
        out[label] = run
        if label == "store":
            exp = next(os.scandir(root)).path
            last = torch.load(os.path.join(exp, "train_1_0",
                                           "last_checkpoint"),
                              weights_only=True)

    args = finetune.build_parser().parse_args(argv)
    model = ViT(get_config("vit_small"), 3)
    model.load_state_dict(last)
    model.to(dev).eval()
    evaluate = finetune.make_evaluate(
        steps_mod.make_classifier_steps()[1], args, dev)
    val = os.path.join(man, "val_ds.txt")
    store = common.maybe_eval_device_store(args, val, "data", device=dev)
    loader = common.make_covid_loader(args, val, "data", training=False)
    got = evaluate(model, store, n_total=len(store.ds))
    want = evaluate(model, loader, n_total=len(loader.ds))
    d = float(np.abs(got[3] - want[3]).max())
    print(f"val through the eval store against the streaming eval: logits "
          f"max |diff| {d}, auc {got[0]:.4f} / {want[0]:.4f}")
    if d != 0.0 or got[:2] != want[:2]:
        raise AssertionError(f"eval store: max |diff| {d}")
    out["eval_store_logits_max_abs_diff"] = d
    return out


class EpochClock:
    """Times the CLIs' training epochs from outside: wraps
    ``common.store_batch_iter`` (each epoch's feed: from its first batch
    request to its exhaustion, the card synchronised there, so the fill
    and the eval passes fall outside) and ``common.maybe_device_store``
    (the fill, in seconds per 1,000 samples)."""

    def __init__(self):
        from mfvit_tpu_torch.cli import common
        self.common = common
        self.epochs, self.fills = [], []

    def __enter__(self):
        c = self.common
        self.orig = (c.store_batch_iter, c.maybe_device_store)
        feed, fill = self.orig

        def timed_feed(*a, **kw):
            it = feed(*a, **kw)

            def gen():
                t0, n = time.perf_counter(), 0
                for batch in it:
                    yield batch
                    n += 1
                torch.cuda.synchronize()
                self.epochs.append((n, time.perf_counter() - t0))
            return gen()

        def timed_fill(*a, **kw):
            t0 = time.perf_counter()
            store = fill(*a, **kw)
            torch.cuda.synchronize()
            if store is not None:
                self.fills.append(
                    (time.perf_counter() - t0) * 1000 / store.n)
            return store

        c.store_batch_iter, c.maybe_device_store = timed_feed, timed_fill
        return self

    def __exit__(self, *exc):
        c = self.common
        c.store_batch_iter, c.maybe_device_store = self.orig


def time_feeds(dev, tmp: str, n: int = 1024) -> dict:
    """The CLIs' own rates on each feed over n synthetic images (pairs for
    ``fuse``; 32 val, 32 test), two epochs a run, the second timed (the
    fill and the decode of the first epoch excluded; the decode cache is
    warm from the first run on): ``finetune`` FT at B=16 and B=256,
    ``fuse`` LP at B=32 (pairs/s), ``pretrain`` at B=32; each the store
    against ``--device-store-mb 0`` and ``--aug-host`` (``pretrain``'s
    host-stack views), in the order store, stream, aug-host, aug-host,
    stream, store. And the fill's seconds per 1,000 images (the first
    fill of each table shape: PNG decode from a warm file cache; later
    ones read the decode cache)."""
    from mfvit_tpu_torch.cli import finetune, fuse, pretrain
    from mfvit_tpu_torch.nn.vit import ViT, get_config

    man = write_covid_ds(os.path.join(tmp, "feeds"), n, seed=43,
                         paired=True, n_eval=32)
    branches = []
    for b, seed in (("cxr", 21), ("enh", 22)):
        path = os.path.join(tmp, f"feed_{b}")
        torch.save(ViT(get_config("vit_small"), 3, generator=torch.Generator()
                       .manual_seed(seed)).state_dict(), path)
        branches += [f"--pretrained-{b}", path]
    base = ["-a", "vit_small", "--epochs", "2", "--draws", "1", "--covid-ds",
            man, "-j", "8", "-p", "100000", "--seed", "0", "--device",
            dev.type]
    configs = (
        ("finetune FT B=16", finetune, 16,
         base + ["-b", "16", "--semi-supervised", "--lr", "0.01"]),
        ("finetune FT B=256", finetune, 256,
         base + ["-b", "256", "--semi-supervised", "--lr", "0.01"]),
        ("fuse LP B=32", fuse, 32, base + ["-b", "32", "--lr", "1e-3"]
         + branches),
        ("pretrain B=32", pretrain, 32,
         pretrain_argv(man, tmp, dev, ["-p", "100000"])),
    )
    rates, fills = {}, {}
    for label, cli, B, argv in configs:
        runs = {k: [] for k, _ in STORE_FEEDS}
        order = STORE_FEEDS + STORE_FEEDS[::-1]
        for i, (feed, extra) in enumerate(order):
            root = os.path.join(tmp, f"t_{len(rates)}_{i}")
            with EpochClock() as clock:
                cli.main(argv + extra + ["--storage-root", root])
            steps, sec = clock.epochs[-1]
            runs[feed].append(steps * B / sec)
            if clock.fills and label not in fills:
                fills[label] = clock.fills[0]
        rates[label] = runs
        print(f"{label}, epoch 2 ({'pairs' if cli is fuse else 'images'}/s, "
              "A B C C B A): " + ", ".join(
                  f"{k} {' / '.join(f'{r:.1f}' for r in v)}"
                  for k, v in runs.items()))
    print("store fill, s per 1,000 samples (first fill of each table): "
          + ", ".join(f"{k} {v:.3f}" for k, v in fills.items()))
    return {"rates": rates, "fill_s_per_1000": fills}

DDP_BATCH = 256


def ddp_flags() -> list:
    """The rendezvous flags of a one-process NCCL group on this host."""
    from mfvit_tpu_torch.parallel import dist
    return ["--dist-coordinator", f"127.0.0.1:{dist.free_port()}",
            "--dist-num-processes", "1", "--dist-process-id", "0"]


def run_ddp(dev, tmp: str) -> dict:
    """The training CLIs through their data-parallel entry point on the
    card: ``finetune`` FT on the device canvas store and ``pretrain`` (the
    v2 queue) at vit_small, 224 px, B=256, two epochs over 512 synthetic
    images (two steps an epoch), each run plain and under the
    ``--dist-*`` flags (a one-process NCCL group), in the order plain,
    group, group, plain, the launch counts set to 0 just before each run
    and read just after. Gates per run: four finite losses and the exact
    launches per step (and per eval batch) of the plain run, K1-K3, K5 and
    K7 among them; under the group an NCCL all-reduce that sums. Prints
    each run's epoch-2 images/s. Then ``gloo_two_ranks``. Returns the
    rates, the launches and the two-rank parity."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import finetune, pretrain
    from mfvit_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    man = write_covid_ds(os.path.join(tmp, "ddp"), 512, seed=45, n_eval=32)
    base = ["-a", "vit_small", "-b", str(DDP_BATCH), "--epochs", "2",
            "--draws", "1", "--covid-ds", man, "-j", "8", "-p", "100000",
            "--seed", "0", "--device", dev.type]
    ft_step = dict(PER_VIT_FORWARD)
    ft_step.update(PER_FT_STEP)
    configs = (
        ("finetune FT", finetune, base + ["--semi-supervised", "--lr",
                                          "0.01"], ft_step),
        ("pretrain v2 queue", pretrain,
         pretrain_argv(man, os.path.join(tmp, "unused"), dev,
                       ["-b", str(DDP_BATCH), "-p", "100000"]),
         moco_counts(PER_VIT_FORWARD, 1, 1)))
    out = {}
    for label, cli, argv, per_step in configs:
        rates, launches = {"plain": [], "group": []}, {}
        for i, mode in enumerate(("plain", "group", "group", "plain")):
            root = os.path.join(tmp, f"ddp_{len(out)}_{i}")
            extra = ddp_flags() if mode == "group" else []
            ops.reset_launch_counts()
            try:
                with EpochClock() as clock:
                    res, _ = _teed(cli.main, argv + extra
                                   + ["--storage-root", root])
                torch.cuda.synchronize()
                got = ops.launch_counts()
                if mode == "group":
                    t = torch.ones(4, device=dev)
                    torch.distributed.all_reduce(t)
                    if (torch.distributed.get_backend() != "nccl"
                            or t.tolist() != [1.0] * 4):
                        raise AssertionError(f"{label}: the group's "
                                             "all-reduce")
            finally:
                dist.shutdown()
            losses = res.extra["train_losses"]
            evals = res.extra.get("eval_batches", 0)
            want = {k: 0 for k in got}
            want.update({k: v * len(losses) for k, v in per_step.items()})
            for k, v in PER_VIT_FORWARD.items():
                want[k] += v * evals
            if len(losses) != 4 or not all(math.isfinite(v)
                                           for v in losses):
                raise AssertionError(f"{label} {mode}: losses {losses}")
            if got != want:
                raise AssertionError(f"{label} {mode}: launch counts {got} "
                                     f"!= {want}")
            launches.setdefault(mode, got)
            if got != launches["plain"]:
                raise AssertionError(f"{label}: launches under the group "
                                     f"{got} != the plain run's")
            steps, sec = clock.epochs[-1]
            rates[mode].append(steps * DDP_BATCH / sec)
        out[label] = {"images_per_sec_epoch2": rates,
                      "launches_per_run": launches["group"],
                      "steps_per_run": 4}
        print(f"{label} (vit_small, B={DDP_BATCH}, 4 steps, store): "
              f"launches plain = group = {launches['group']}; epoch 2 "
              "images/s (plain, group, group, plain): plain "
              + " / ".join(f"{r:.1f}" for r in rates["plain"]) + ", group "
              + " / ".join(f"{r:.1f}" for r in rates["group"]))
    out["gloo_two_ranks"] = gloo_two_ranks(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"ddp phase: {out['seconds']:.1f} s")
    return out


# (loss, fp32): the v2 queue on the kernel path, both losses on the plain
GLOO_MOCO_RUNS = (("v2_queue", False), ("v2_queue", True),
                  ("v3_symmetric", True))


def _gloo_rank(r: int, port: int, n: int, B: int, out_dir: str) -> None:
    """One rank of ``gloo_two_ranks`` (spawned): three kernel-path FT
    steps and three steps of each of GLOO_MOCO_RUNS on its rows of the
    global batches; the readings to ``out_dir``. An error fails the
    rank, and ``start_processes`` raises it with its traceback."""
    from mfvit_tpu_torch.parallel import dist
    full_precision_sums()
    dev = dist.init_distributed(f"127.0.0.1:{port}", n, r,
                                device_type="cuda", backend="gloo",
                                timeout_s=120)
    try:
        out = {"ft": _ft_steps(dev, r, n, B)}
        for loss, fp32 in GLOO_MOCO_RUNS:
            out[loss, fp32] = _moco_steps(dev, loss, fp32, r, n, B)
    finally:
        dist.shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))


def _ft_steps(dev, r: int = 0, n: int = 1, B: int = 32) -> dict:
    """Three SGD steps of the kernel path (bf16, vit_small, 224 px) from
    ``train_parity``'s weights and batch of B images, on rows [r B/n,
    (r + 1) B/n): losses, first-step gradients per block, end state."""
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train import optim, steps

    gen = torch.Generator().manual_seed(8)
    model = ViT(get_config("vit_small"), 3, generator=gen).to(dev)
    imgs = torch.randn(B, 224, 224, 3, generator=gen)
    labels = torch.randint(0, 3, (B,), generator=gen)
    b = B // n
    x = imgs[r * b:(r + 1) * b].to(dev).bfloat16()
    y = labels[r * b:(r + 1) * b].to(dev)
    opt = optim.build_optimizer("sgd", model.named_parameters(), 0.01,
                                momentum=0.9, weight_decay=1e-6)
    step, _ = steps.make_classifier_steps()
    losses, grads = [], None
    for i in range(3):
        loss, _ = step(model, opt, x, y)
        losses.append(loss.item())
        if i == 0:
            grads = [torch.cat([p.grad.flatten() for p in blk.parameters()])
                     .cpu() for blk in model.blocks]
    return {"losses": losses, "grads": grads,
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def _moco_steps(dev, loss: str, fp32: bool, r: int = 0, n: int = 1,
                B: int = 32) -> dict:
    """Three MoCo steps (LARS, LR 0.1) on ``pretrain_parity``'s vit_small
    state with its BatchNorm heads, ``loss`` the v2 queue or v3, on rows
    [r B/n, (r + 1) B/n) of one global batch: the kernel path in bf16,
    or (``fp32``) the plain path in fp32. Under a group the keys are
    all-gathered, the heads' BatchNorm statistics synced and v3's
    positives offset by the rank. The losses, the first-step gradients
    of each query block, the projector and the predictor, and the end
    state (BatchNorm running statistics, queue and its pointer
    included)."""
    from mfvit_tpu_torch.ssl import moco
    from mfvit_tpu_torch.train import optim

    gen = torch.Generator().manual_seed(32)
    model = moco_model("vit_small", gen, loss=loss).to(dev)
    q, k = moco_views(gen, B, dev)
    b = B // n
    q, k = q[r * b:(r + 1) * b], k[r * b:(r + 1) * b]
    if fp32:
        q, k = q.float(), k.float()
    opt = optim.build_optimizer("lars", model.trainable(), 0.1,
                                weight_decay=1e-6)
    step = moco.make_pretrain_step(
        model.cfg, reference=fp32,
        compute_dtype=torch.float32 if fp32 else torch.bfloat16)
    losses, grads = [], None
    for i in range(3):
        losses.append(step(model, opt, q, k, 0.99).item())
        if i == 0:
            groups = [*model.base.encoder.blocks, model.base.projector,
                      model.predictor]
            grads = [torch.cat([p.grad.flatten() for p in m.parameters()])
                     .cpu() for m in groups]
    return {"losses": losses, "grads": grads,
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def _hold_ranks(name: str, ranks: list, one: dict, B: int, queue: bool,
                fro: bool = False, later_keys: bool = True) -> dict:
    """Rank 0 of a two-rank run against one process at ``train_parity``'s
    bars: the loss per step (PARITY_LOSS_BAR), the first-step gradient
    of each group and, for MoCo, each BatchNorm running variance and the
    keys enqueued (PARITY_GRAD_BAR, relative), each running mean's error
    in its layer's standard deviations (PARITY_GRAD_BAR: a mean behind
    another BatchNorm is zero up to rounding, so relative to itself it
    measures noise), the queue pointer exactly; and the ranks' end states
    bit for bit. ``fro`` (MoCo): the gradients and the keys of all three
    steps are held by their relative Frobenius error, the first step's
    keys by the largest. The heads' BatchNorm-ReLU layers turn a last-bit
    change of a 16-row block's sums into a flipped ReLU now and then, and
    one flip rewrites one hidden unit's weight-gradient row (255 of the
    predictor's 2,105,344 entries on the card, in bf16 and in v3's fp32
    run alike), which the largest-entry measure reads as up to 24 %.
    Not ``later_keys`` (bf16 MoCo): the keys of steps 2-3 are printed,
    not held. The shared predictor's update carries that row into them
    (6.0e-2 Frobenius on the card, as ``pretrain_parity`` prints its
    own enqueued keys); the fp32 runs hold all three steps' keys.
    Prints the readings; returns them with the list of failures."""
    got = ranks[0]
    err = fro_rel if fro else rel
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                     one["losses"])]
    grad_rel = [err(a, b) for a, b in zip(got["grads"], one["grads"])]
    bn_rel = []  # a mean in its layer's standard deviations, a var rel
    for k, v in got["state"].items():
        if k.endswith("running_var"):
            bn_rel.append(rel(v, one["state"][k]))
        elif k.endswith("running_mean"):
            sd = one["state"][k[:-4] + "var"].float().max().sqrt()
            bn_rel.append(((v.float() - one["state"][k].float()).abs()
                           .max() / sd).item())
    differ = [k for k, v in got["state"].items()
              if any(not torch.equal(v, rk["state"][k]) for rk in ranks[1:])]
    out = {"loss_rel": loss_rel, "grad_rel_max": max(grad_rel),
           "entries_differ_between_ranks": len(differ)}
    fails = []
    if max(loss_rel) >= PARITY_LOSS_BAR:
        fails.append(f"{name} loss")
    if max(grad_rel) >= PARITY_GRAD_BAR:
        fails.append(f"{name} gradients")
    if differ:
        fails.append(f"{name} ranks differ ({differ[:3]})")
    line = (f"{name}: losses " + ", ".join(f"{v:.5f}" for v in
                                           got["losses"])
            + " / " + ", ".join(f"{v:.5f}" for v in one["losses"])
            + "; loss rel " + ", ".join(f"{v:.3e}" for v in loss_rel)
            + f" (bar {PARITY_LOSS_BAR}); first-step gradient "
            + ("Frobenius " if fro else "") + "rel per group max "
            + f"{max(grad_rel):.3e} (bar {PARITY_GRAD_BAR})")
    if fro:
        peak = max(rel(a, b) for a, b in zip(got["grads"], one["grads"]))
        out["grad_largest_entry_rel_max"] = peak
        line += f", largest-entry rel max {peak:.3e} (printed)"
    if bn_rel:
        out["bn_running_max"] = max(bn_rel)
        line += (f"; BatchNorm running statistics ({len(bn_rel)}) max "
                 f"{max(bn_rel):.3e} (means in standard deviations)")
        if max(bn_rel) >= PARITY_GRAD_BAR:
            fails.append(f"{name} BatchNorm running statistics")
    if queue:
        qg, qo = got["state"]["queue"], one["state"]["queue"]
        first, keys = rel(qg[:, :B], qo[:, :B]), err(qg[:, :3 * B],
                                                     qo[:, :3 * B])
        ptr = [int(got["state"]["queue_ptr"]), int(one["state"]["queue_ptr"])]
        out.update(queue_first_keys_rel=first, queue_keys_rel=keys,
                   queue_ptr=ptr)
        line += (f"; enqueued keys rel, first step {first:.3e}, all three "
                 + ("(Frobenius) " if fro else "") + f"{keys:.3e}"
                 + ("" if later_keys else " (printed)")
                 + f", queue_ptr {ptr}")
        if (first >= PARITY_GRAD_BAR or ptr[0] != ptr[1]
                or (later_keys and keys >= PARITY_GRAD_BAR)):
            fails.append(f"{name} queue")
    print(line + f"; entries that differ between the ranks {len(differ)}")
    out["failures"] = fails
    return out


def gloo_two_ranks(dev, n: int = 2, B: int = 32) -> dict:
    """n ranks on this one card (cuda:0) over a gloo group, from
    ``parallel.dist`` directly (NCCL refuses two ranks on one device):
    three FT steps of the kernel path, and three MoCo steps of the v2
    queue on the kernel path in bf16 and of the v2 queue and v3 on the
    plain path in fp32, on their row blocks of the global batch B, against the same
    steps in this process on the whole batch (``_hold_ranks``). A rank
    that fails fails the phase."""
    import tempfile as _tempfile

    import torch.multiprocessing as mp

    from mfvit_tpu_torch.parallel import dist
    with _tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_gloo_rank,
                           args=(dist.free_port(), n, B, out_dir),
                           nprocs=n, join=True, start_method="spawn")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(n)]
    print(f"gloo on CUDA tensors, {n} ranks on cuda:0 against one process "
          f"(vit_small, global B={B}, 3 steps each):")
    out = {"ft": _hold_ranks("FT (SGD, kernels, bf16)",
                             [rk["ft"] for rk in ranks],
                             _ft_steps(dev, B=B), B, queue=False)}
    for loss, fp32 in GLOO_MOCO_RUNS:
        how = "plain, fp32" if fp32 else "kernels, bf16"
        out[f"{loss}_{'fp32' if fp32 else 'bf16'}"] = _hold_ranks(
            f"MoCo {loss} (LARS, BN heads, {how})",
            [rk[loss, fp32] for rk in ranks],
            _moco_steps(dev, loss, fp32, B=B), B,
            queue=loss == "v2_queue", fro=True, later_keys=fp32)
    fails = [f for v in out.values() for f in v["failures"]]
    if fails:
        raise AssertionError(f"gloo two ranks out of the bars: {fails}")
    return out


def moco_model(name: str, gen, in_chans: int = 3, **kw):
    """A MoCo state on the CPU: MoCo's ViT defaults (or its ResNet ones)
    over ``name`` at 224 px, ``in_chans`` input channels."""
    from mfvit_tpu_torch.nn import resnet
    from mfvit_tpu_torch.nn.vit import get_config
    from mfvit_tpu_torch.ssl import moco

    if name.startswith("resnet"):
        return moco.MoCo(moco.MoCoConfig.resnet(**kw),
                         resnet.get_config(name), in_chans=in_chans,
                         generator=gen)
    return moco.MoCo(moco.MoCoConfig(**kw), get_config(name),
                     in_chans=in_chans, generator=gen)


def moco_views(gen, B: int, dev, in_chans: int = 3):
    return tuple(torch.randn(B, 224, 224, in_chans, generator=gen).to(dev)
                 .bfloat16() for _ in range(2))


def encoder_grads(model, imgs, cotangent, reference: bool) -> list:
    """The query tower's encoder (``stop_grad_conv1``, batch statistics)
    forward and backward under ``cotangent`` on its CLS features: the
    flattened gradient of each block."""
    model.zero_grad(set_to_none=True)
    feats = model.base.encoder(imgs, reference=reference,
                               stop_grad_conv1=True, bn_training=True)
    feats.backward(cotangent)
    return [torch.cat([p.grad.flatten() for p in blk.parameters()])
            for blk in model.base.encoder.blocks]


def pretrain_parity(dev, B: int = 32, in_chans: int = 3) -> dict:
    """Three MoCo v2-queue steps (LARS, LR 0.1) of the kernel path and of
    the plain path (bf16 on the card) from the same vit_small state (with
    ``in_chans`` input channels) and batch: the loss per step within PARITY_LOSS_BAR; then each query-tower
    block's gradient within PARITY_GRAD_BAR, both paths' encoders run
    forward and backward under one cotangent on their CLS features, the
    plain step's own. The whole first step's gradients are printed
    beside, ungated: at random init the MoCo heads' BatchNorm-ReLU layers
    turn the bf16 rounding differences of the CLS features into much
    larger gradient differences (ReLUs near zero flip), whatever the
    kernels; so are the CLS features and the enqueued keys. Returns the
    readings."""
    import copy

    from mfvit_tpu_torch.ssl import moco
    from mfvit_tpu_torch.train import optim

    gen = torch.Generator().manual_seed(32)
    model0 = moco_model("vit_small", gen, in_chans)
    q, k = moco_views(gen, B, dev, in_chans)
    runs = {}
    for ref in (False, True):
        model = copy.deepcopy(model0).to(dev)
        opt = optim.build_optimizer("lars", model.trainable(), 0.1,
                                    weight_decay=1e-6)
        step = moco.make_pretrain_step(model.cfg, reference=ref)
        feats = []
        hook = model.base.encoder.register_forward_hook(
            lambda mod, args, out: feats.append(out) or out.retain_grad())
        losses, grads = [], None
        for i in range(3):
            losses.append(step(model, opt, q, k, 0.99).item())
            if i == 0:
                hook.remove()
                groups = [*model.base.encoder.blocks, model.base.projector,
                          model.predictor]
                grads = [torch.cat([p.grad.flatten() for p in m.parameters()])
                         for m in groups]
        runs[ref] = (losses, grads, model.queue[:, :3 * B].clone(),
                     feats[0].detach(), feats[0].grad)
    (lk, gk, qk, fk, _), (lp, gp, qp, fp, cot) = runs[False], runs[True]
    shared = {ref: encoder_grads(copy.deepcopy(model0).to(dev), q, cot, ref)
              for ref in (False, True)}
    out = {"loss_rel": [abs(a - b) / abs(b) for a, b in zip(lk, lp)],
           "block_grad_rel": [rel(a, b) for a, b in zip(shared[False],
                                                         shared[True])],
           "step_grad_rel": [rel(a, b) for a, b in zip(gk, gp)],
           "cls_rel": rel(fk, fp), "keys_rel": rel(qk, qp)}
    print(f"pretrain-step parity (vit_small, {in_chans} channels, B={B}, "
          "3 LARS steps): losses "
          "kernel " + ", ".join(f"{v:.5f}" for v in lk) + " plain "
          + ", ".join(f"{v:.5f}" for v in lp) + "; loss rel "
          + ", ".join(f"{v:.3e}" for v in out["loss_rel"])
          + f" (bar {PARITY_LOSS_BAR}); gradient rel per query block under "
          "the plain step's cotangent "
          + ", ".join(f"{v:.3e}" for v in out["block_grad_rel"])
          + f" (bar {PARITY_GRAD_BAR}); ungated: the whole first step's "
          "gradient rel per block, projector, predictor "
          + ", ".join(f"{v:.3e}" for v in out["step_grad_rel"])
          + f", CLS features rel {out['cls_rel']:.3e}, enqueued keys rel "
          f"{out['keys_rel']:.3e}")
    if not (max(out["loss_rel"]) < PARITY_LOSS_BAR
            and max(out["block_grad_rel"]) < PARITY_GRAD_BAR):
        raise AssertionError(f"pretrain-step parity ({in_chans} channels) "
                             "out of its bar")
    return out


def pretrain_variants(dev, B: int = 32) -> dict:
    """One MoCo step each of ``--loss v3_symmetric`` (vit_small),
    vit_conv_small (the ConvStem, 11 blocks, bias-free qkv) and resnet50:
    a finite loss and the launch counts (v3: two query and two key passes;
    resnet50: no kernel of the port). Returns {label: counts}."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ssl import moco
    from mfvit_tpu_torch.train import optim

    gen = torch.Generator().manual_seed(33)
    conv = {k: 11 if k == "fused_attention_block" else
            10 if k == "fused_mlp_block" else v
            for k, v in PER_VIT_FORWARD.items()}
    cases = (("v3_symmetric", "vit_small", dict(loss="v3_symmetric"),
              moco_counts(PER_VIT_FORWARD, 2, 2)),
             ("vit_conv_small", "vit_conv_small", {},
              moco_counts(conv, 1, 1)),
             ("resnet50", "resnet50", {}, {}))
    out = {}
    for label, arch, kw, per_step in cases:
        model = moco_model(arch, gen, **kw).to(dev)
        opt = optim.build_optimizer("lars", model.trainable(), 0.1,
                                    weight_decay=1e-6)
        step = moco.make_pretrain_step(model.cfg)
        q, k = moco_views(gen, B, dev)
        ops.reset_launch_counts()
        loss = step(model, opt, q, k, 0.99).item()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want = {n: 0 for n in got}
        want.update(per_step)
        print(f"pretrain step {label} (B={B}): loss {loss:.4f}; launch "
              f"counts {got}")
        if not math.isfinite(loss) or got != want:
            raise AssertionError(f"pretrain {label}: loss {loss}, counts "
                                 f"{got} != {want}")
        out[label] = {n: v for n, v in got.items() if v}
        del model, opt
    return out


def time_pretrain(dev, B: int, iters: int, in_chans: int = 3) -> dict:
    """Images/s of the MoCo v2-queue step (vit_small, 224 px, MoCo's
    default heads and queue, LARS; the EMA, both towers, the backward, the
    optimizer and the enqueue, the loss fetched every step) at batch B on
    ``in_chans``-channel images, kernel path against plain path (kernel,
    plain, plain, kernel)."""
    from mfvit_tpu_torch.ssl import moco
    from mfvit_tpu_torch.train import optim

    gen = torch.Generator().manual_seed(34)
    model = moco_model("vit_small", gen, in_chans).to(dev)
    q, k = moco_views(gen, B, dev, in_chans)
    opt = optim.build_optimizer("lars", model.trainable(), 1e-3,
                                weight_decay=1e-6)
    fns = {w: moco.make_pretrain_step(model.cfg, reference=w == "plain")
           for w in ("kernel", "plain")}

    def rate(which: str) -> float:
        fns[which](model, opt, q, k, 0.99).item()
        t0 = time.perf_counter()
        for _ in range(iters):
            fns[which](model, opt, q, k, 0.99).item()
        return B * iters / (time.perf_counter() - t0)

    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        runs[which].append(rate(which))
    print(f"MoCo v2-queue step at B={B}, 224 px, {in_chans} channels "
          "(bf16, both towers + "
          "backward + LARS + enqueue, loss fetched every step): "
          + ", ".join(f"{w} {' / '.join(f'{r:.1f}' for r in v)} images/s"
                      for w, v in runs.items()))
    return {w: sum(v) / len(v) for w, v in runs.items()}


def profile_pretrain(dev, B: int = 256) -> dict:
    """One ``torch.profiler`` window over two MoCo v2-queue steps at batch
    B (vit_small, 224 px, the state of ``time_pretrain``): the device time
    per step by the PyTorch operator (or autograd Function) that launched
    it, the twelve largest with their calls per step, and the device's
    busy share of the window (the profiler's own cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mfvit_tpu_torch.ssl import moco
    from mfvit_tpu_torch.train import optim

    gen = torch.Generator().manual_seed(34)
    model = moco_model("vit_small", gen).to(dev)
    q, k = moco_views(gen, B, dev)
    opt = optim.build_optimizer("lars", model.trainable(), 1e-3,
                                weight_decay=1e-6)
    step = moco.make_pretrain_step(model.cfg)
    step(model, opt, q, k, 0.99).item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(model, opt, q, k, 0.99).item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    busy = sum(e.self_device_time_total / 2e3 for e in avgs
               if e.device_type == DeviceType.CUDA)
    by_op = {e.key: (e.self_device_time_total / 2e3, e.count // 2)
             for e in avgs if e.device_type == DeviceType.CPU
             and e.self_device_time_total > 0
             and e.key != "Command Buffer Full"}
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"MoCo step at B={B}, profiled: {wall_ms / 2:.1f} ms per step on "
          f"the host clock, device busy {busy:.1f} ms per step "
          f"({busy / (wall_ms / 2):.1%}); device ms per step by operator: "
          + "; ".join(f"{k} {v:.2f} ms x{n}" for k, (v, n) in top))
    return {"wall_ms": wall_ms / 2, "device_ms": busy,
            "by_op": [[k, v, n] for k, (v, n) in top]}


def library_block(t, heads: int):
    """K15's library yardstick: ``nn.TransformerEncoderLayer`` (pre-norm,
    exact GELU, eps 1e-6, packed qkv bias) in bf16 with K15's weights,
    which in inference mode is one call of PyTorch's fused encoder layer
    (``torch._transformer_encoder_layer_fwd``). The port never calls it.
    Returns (the call, the layer)."""
    x = t["x"]
    D = x.shape[-1]
    layer = torch.nn.TransformerEncoderLayer(
        D, heads, 4 * D, dropout=0.0, activation="gelu",
        layer_norm_eps=1e-6, batch_first=True, norm_first=True,
        device=x.device, dtype=torch.bfloat16).eval()
    sa = layer.self_attn
    with torch.no_grad():
        for dst, k in ((sa.in_proj_weight, "wqkv"), (sa.in_proj_bias, "bqkv"),
                       (sa.out_proj.weight, "wproj"),
                       (sa.out_proj.bias, "bproj"),
                       (layer.linear1.weight, "w1"), (layer.linear1.bias, "b1"),
                       (layer.linear2.weight, "w2"), (layer.linear2.bias, "b2"),
                       (layer.norm1.weight, "ln_s"), (layer.norm1.bias, "ln_b"),
                       (layer.norm2.weight, "ln_s"),
                       (layer.norm2.bias, "ln_b")):
            dst.copy_(t[k])
    return (lambda: layer(x)), layer


def time_block(dev) -> tuple:
    """K15 at vit_small B=256 against the K1 -> K2 pair (K15, pair, pair,
    K15), then its plain version twice, then the library block
    (``library_block``); K15 first held equal to the pair on the timed
    inputs, and the library block within REL_BAR of K15's plain fp32
    version (so it computes the same function). Returns (K15 ms, plain ms,
    library ms, pair ms)."""
    from mfvit_tpu_torch.ops import fused_block as fb
    t = block_inputs(torch.Generator().manual_seed(16), 256, 384, dev)
    k15, pair, plain, a = k15_calls(t, 12)
    lib, _ = library_block(t, 12)
    fast = []
    fused_layer = torch._transformer_encoder_layer_fwd
    with torch.inference_mode():
        if not torch.equal(k15(), pair()):
            raise AssertionError("K15 differs from K1 -> K2 at B=256")
        torch._transformer_encoder_layer_fwd = (
            lambda *args, **kw: fast.append(1) or fused_layer(*args, **kw))
        try:
            got = lib()
        finally:
            torch._transformer_encoder_layer_fwd = fused_layer
        r = rel(got, fb.fused_transformer_block_plain(
            *[v.float() for v in a], 12, 32 ** -0.5))
        if not (math.isfinite(r) and r < REL_BAR):
            raise AssertionError(f"the library block at B=256: rel {r} vs "
                                 "K15's plain fp32 version")
        k1, p1, p2, k2 = (cuda_ms(f, 10) for f in (k15, pair, pair, k15))
        q1, q2 = cuda_ms(plain, 3), cuda_ms(plain, 3)
        l1 = cuda_ms(lib, 10)
    print(f"fused_transformer_block at B=256: kernel {k1:.3f}/{k2:.3f} ms, "
          f"K1 -> K2 {p1:.3f}/{p2:.3f} ms, plain {q1:.3f}/{q2:.3f} ms "
          f"(bf16); library nn.TransformerEncoderLayer {l1:.3f} ms (bf16, "
          f"fused fast path {'taken' if fast else 'NOT taken'}; rel vs plain "
          f"fp32 {r:.3e})")
    return (k1 + k2) / 2, (q1 + q2) / 2, l1, (p1 + p2) / 2


# the halves timed against their former designs: op name -> the stage_times
# ops (``tools/compare_block.py``) of the kernel and of its former design
HALF_OPS = {"fused_attention_block": ("k1", "k1_wmma"),
            "fused_mlp_block": ("k2", "k2_wmma"),
            "fused_mlp_block_final_ln": ("k3", "k3_wmma"),
            "fused_fusion_cls": ("k4", "k4_kv")}


def time_halves(dev, B: int = 256) -> dict:
    """K1, K2, K3 and K4 at vit_small batch B (K4: the fusion head, 3 heads
    of 128) against the designs they ran before (kernel, former, former,
    kernel; CUDA events), each first held to it on the timed inputs (K1-K3
    equal, K4 within K4_FORMER_BAR). Returns name -> (ms, former ms)."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_fusion as ff
    from mfvit_tpu_torch.ops import fused_mlp as fm
    t = block_inputs(torch.Generator().manual_seed(16), B, 384, dev)
    tok_c, tok_e, flat = fusion_inputs(torch.Generator().manual_seed(16), B,
                                       384, dev)
    a, m, fin = [t[k] for k in ATTN], [t[k] for k in MLP], (t["fs"], t["fb"])
    scale = 32 ** -0.5
    halves = {"fused_attention_block": (
        lambda: fa.fused_attention_block(*a, 12, scale),
        lambda: fa.fused_attention_block_wmma(*a, 12, scale)),
        "fused_mlp_block": (lambda: fm.fused_mlp_block(*m),
                            lambda: fm.fused_mlp_block_wmma(*m)),
        "fused_mlp_block_final_ln": (
            lambda: fm.fused_mlp_block_final_ln(*m, *fin),
            lambda: fm.fused_mlp_block_final_ln_wmma(*m, *fin)),
        "fused_fusion_cls": (
            lambda: ff.fused_fusion_cls(tok_c, tok_e, flat, 3),
            lambda: ff.fused_fusion_cls_kv(tok_c, tok_e, flat, 3))}
    out = {}
    with torch.inference_mode():
        for name, (kern, former) in halves.items():
            got, ref = kern(), former()
            if name == "fused_fusion_cls":
                r = rel(torch.cat(got), torch.cat(ref))
                if not r < K4_FORMER_BAR:
                    raise AssertionError(f"K4 at B={B}: rel {r} vs its former "
                                         "design")
            elif not torch.equal(got, ref):
                raise AssertionError(f"{name} differs from its former chain "
                                     f"at B={B}")
            k1, f1, f2, k2 = (cuda_ms(fn, 20)
                              for fn in (kern, former, former, kern))
            out[name] = ((k1 + k2) / 2, (f1 + f2) / 2)
            print(f"{name} at B={B}: kernel {k1:.4f}/{k2:.4f} ms, its former "
                  f"design {f1:.4f}/{f2:.4f} ms")
    return out


def time_fusion(dev, B: int, iters: int, arch: str = "ca") -> dict:
    """Pairs/s of the fusion train step with the ``arch`` head (forward,
    backward, Adam, the loss fetched every step) at batch B, 224 px: LP and
    ``--semi-supervised``, each the kernel path against the plain path
    (kernel, plain, plain, kernel), on its own copy of the seeded models."""
    import copy

    from mfvit_tpu_torch.cli.fuse import fusion_trainable_mask
    from mfvit_tpu_torch.train import optim, steps

    gen = torch.Generator().manual_seed(24)
    models0 = fusion_models(gen, arch)
    xc, xe = (torch.randn(B, 224, 224, 3, generator=gen).to(dev).bfloat16()
              for _ in range(2))
    labels = torch.randint(0, 3, (B,), generator=gen).to(dev)
    out = {}
    for semi in (False, True):
        models = copy.deepcopy(models0).to(dev)
        mask = None if semi else fusion_trainable_mask(
            models.named_parameters())
        opt = optim.build_optimizer("adam", models.named_parameters(), 1e-5,
                                    trainable_mask=mask)
        fns = {k: steps.make_fusion_steps(freeze_backbones=not semi,
                                          reference=k == "plain",
                                          fusion_arch=arch)[0]
               for k in ("kernel", "plain")}
        torch.cuda.reset_peak_memory_stats()

        def rate(which: str) -> float:
            fns[which](models, opt, xc, xe, labels)[0].item()
            t0 = time.perf_counter()
            for _ in range(iters):
                fns[which](models, opt, xc, xe, labels)[0].item()
            return B * iters / (time.perf_counter() - t0)

        runs = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            runs[which].append(rate(which))
        mode = "semi" if semi else "lp"
        print(f"fusion train step ({arch} "
              f"{'--semi-supervised' if semi else 'LP'}) "
              f"at B={B} (bf16, forward + backward + Adam, loss fetched "
              "every step): " + ", ".join(
                  f"{k} {' / '.join(f'{r:.1f}' for r in v)} pairs/s"
                  for k, v in runs.items())
              + f"; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
        out[mode] = {k: sum(v) / len(v) for k, v in runs.items()}
        del models, opt
        torch.cuda.empty_cache()
    return out


# --attn-backend xla, decision logits at vit_small B=256, rel = max|diff| /
# max|ref|. In fp32 the XLA route computes the kernels' function with fp32
# sums in other orders (cuBLAS against the plain versions, the regrouped
# K4 sums against the full-sequence encode), so it is held to the plain
# fp32 path within XLA_F32_BAR: a few fp32 roundings of 1,536-term sums.
# In bf16 it rounds at some three times as many points as the kernels
# (each linear's product and then its bias sum, each of the exact GELU's
# four steps, P before P.V), so it sits further from the fp32 function than
# the kernels' rounding does; it is held to the kernel route within XLA_BAR
# (2.5 REL_BAR), a bar wrong attentions (``xla_controls``) must fail in
# the same run. On an H100 at 700 W the bf16 route sits 2.86e-2 from the
# kernels' logits, and the kernels' own bf16 logits 2.04e-2 from the plain
# fp32 path's; the fp32 gate is the one that holds the route's math.
XLA_F32_BAR = 1e-4
XLA_BAR = 2.5 * REL_BAR


def xla_controls(xla_route) -> dict:
    """Wrong versions of the XLA route's attention, which XLA_BAR must
    tell from the right one: the scores without their scale, and with
    the scale applied twice."""
    mhsa = xla_route.mhsa
    return {"unscaled scores": lambda qkv, heads, scale: mhsa(qkv, heads,
                                                             1.0),
            "scale squared": lambda qkv, heads, scale: mhsa(qkv, heads,
                                                           scale * scale)}


def write_orbax_tree(path: str, tree: dict) -> bool:
    """``tree`` (nested dicts and lists of numpy arrays) in orbax 0.11's
    layout, as the JAX package's ``save`` writes it: ``_METADATA`` (each
    leaf's path, ``key_type`` 1 for a list index and 2 for a dict key) and,
    where ``tensorstore`` is importable, every array as a zstd-compressed
    zarr array in an OCDBT store at ``path``. Returns whether the arrays
    were written."""
    entries, arrays = {}, []

    def walk(node, keys):
        if isinstance(node, (dict, list)) and node:
            kind = 2 if isinstance(node, dict) else 1
            for k, v in (node.items() if kind == 2 else enumerate(node)):
                walk(v, keys + [(str(k), kind)])
            return
        meta = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys]}
        if isinstance(node, (dict, list)):
            meta["value_metadata"] = {
                "value_type": "Dict" if isinstance(node, dict) else "List",
                "skip_deserialize": True}
        else:
            meta["value_metadata"] = {"value_type": "np.ndarray",
                                      "skip_deserialize": False}
            arrays.append((".".join(k for k, _ in keys), np.asarray(node)))
        entries[str(tuple(k for k, _ in keys))] = meta

    walk(tree, [])
    os.makedirs(path)
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    try:
        import tensorstore as ts
    except ImportError:
        return False
    ctx = ts.Context()
    for name, a in arrays:
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{path}/", "path": name},
            "metadata": {"compressor": {"id": "zstd", "level": 1},
                         "shape": list(a.shape), "chunks": list(a.shape),
                         "dtype": a.dtype.str}},
            create=True, context=ctx).result()
        store.write(a).result()
    return True


def _tree_equal(got, want) -> bool:
    if isinstance(want, dict):
        return (isinstance(got, dict) and sorted(got) == sorted(want)
                and all(_tree_equal(got[k], want[k]) for k in want))
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(_tree_equal(g, w) for g, w in zip(got, want)))
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def run_interop(dev, tmp: str, B: int = 256) -> dict:
    """Checkpoint interop and ``--attn-backend`` at vit_small, 224 px:

    - seeded serving weights (non-zero biases) written as a
      ``save_serving`` file and in the reference layout (each branch a
      ``.pth.tar`` of ``vits.py`` names, the head a ``Fus_CrossViT``
      ``.pth.tar``, both as DDP saves them: ``{'state_dict': ...}`` with
      ``module.``); each loaded as a user would (``infer.load_models``;
      ``load_vit_state`` and ``load_reference_fusion``) and served on one
      batch of B pairs through K1-K4 (the counts of one paired forward
      each): the decision logits equal bit for bit;
    - whether ``tensorstore`` is importable: if not, ``infer --checkpoint``
      on an orbax-layout directory must exit naming the converter; if so,
      a tree written in orbax's layout with tensorstore is read back by
      ``orbax_io.read_tree`` bit for bit;
    - ``infer`` with ``--report-throughput`` on B pairs at -b B, the kernel
      route and ``--attn-backend xla`` (kernel, xla, xla, kernel): launch
      counts (PER_FORWARD per forward, and every kernel 0 on the XLA
      route), the route line each prints first, the decision logits
      within XLA_BAR, and both routes' pairs/s;
    - one ``finetune --semi-supervised --attn-backend xla`` step (B=32): a
      finite loss, every kernel 0.
    Returns the numbers the report keeps."""
    import importlib.util

    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import finetune, infer
    from mfvit_tpu_torch.exp import checkpoint as ckpt
    from mfvit_tpu_torch.exp import orbax_io
    from mfvit_tpu_torch.models.fusion import Fusion
    from mfvit_tpu_torch.nn import xla_route
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train.steps import make_fusion_forward

    cfg = get_config("vit_small")
    gens = [torch.Generator().manual_seed(s) for s in (41, 42, 43)]
    src = {"cxr": ViT(cfg, 3, generator=gens[0]),
           "enh": ViT(cfg, 3, generator=gens[1]),
           "fus": Fusion(3, cfg.dim, 3, generator=gens[2])}
    for k, m in src.items():
        nonzero_biases(m, gens[0])
    native = os.path.join(tmp, "serving.pt")
    ckpt.save_serving(native, *(src[k].state_dict() for k in ("cxr", "enh",
                                                              "fus")))
    ref = {}
    for k, m in src.items():
        ref[k] = os.path.join(tmp, f"{k}.pth.tar")
        torch.save({"epoch": 0, "state_dict": {
            f"module.{n}": v for n, v in m.state_dict().items()}}, ref[k])
    pairs = os.path.join(tmp, "pairs")
    os.makedirs(pairs)
    man = write_pairs(pairs, B, seed=44)
    argv = ["-a", "vit_small", "-b", str(B), "--device", dev.type,
            "--checkpoint", native, "--manifest", man, "-j", "8",
            "--output", os.path.join(tmp, "predictions.json"),
            "--report-throughput"]
    args = infer.build_parser().parse_args(argv)
    models_native = infer.load_models(args, cfg, dev)
    models_ref = {"cxr": ViT(cfg, 3), "enh": ViT(cfg, 3),
                  "fus": Fusion(3, cfg.dim, 3)}
    for k in ("cxr", "enh"):
        models_ref[k].load_state_dict(ckpt.load_vit_state(ref[k], cfg),
                                      strict=True)
    ckpt.load_reference_fusion(ref["fus"], models_ref["fus"])
    for m in models_ref.values():
        m.to(dev).eval()
    from mfvit_tpu_torch.cli import common
    batch = next(iter(common.make_paired_loader(args, man)))
    xc, xe = infer.prepare(batch, dev, torch.bfloat16)
    fwd = make_fusion_forward()
    logits = {}
    for name, models in (("native", models_native),
                         ("reference layout", models_ref)):
        ops.reset_launch_counts()
        logits[name] = sum(fwd(models, xc, xe))
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want = {k: PER_FORWARD.get(k, 0) for k in got}
        if got != want:
            raise AssertionError(f"{name} load at B={B}: launch counts {got}"
                                 f" != {want}")
    same = torch.equal(logits["native"], logits["reference layout"])
    print(f"serving at B={B} from the save_serving file and from the "
          f"reference layout (vits.py branches, Fus_CrossViT head): logits "
          f"equal bit for bit: {same}; K1-K4 {PER_FORWARD} a forward each")
    if not same:
        raise AssertionError("the reference-layout load serves other logits")

    has_ts = importlib.util.find_spec("tensorstore") is not None
    print(f"tensorstore importable: {has_ts}")
    tree = {"cxr": {"cls": src["cxr"].cls_token.detach().numpy(),
                    "blocks": [{"w": blk.attn.qkv.weight.detach().numpy().T,
                                "b": blk.attn.qkv.bias.detach().numpy()}
                               for blk in src["cxr"].blocks[:2]]},
            "epoch": np.asarray(3, np.int32), "empty": {}}
    tdir = os.path.join(tmp, "orbax_model_best")
    if write_orbax_tree(tdir, tree) != has_ts:
        raise AssertionError("tensorstore wrote where it is missing, or not "
                             "where it is importable")
    if has_ts:
        read = orbax_io.read_tree(tdir)
        if not _tree_equal(read, tree):
            raise AssertionError("read_tree differs from the tree written")
        print("read_tree on a tree written in orbax's layout: equal bit for "
              "bit")
        refusal = None
    else:
        try:
            infer.main([tdir if a == native else a for a in argv])
        except SystemExit as e:
            refusal = str(e)
        else:
            raise AssertionError("infer read an orbax directory without "
                                 "tensorstore")
        if orbax_io.CONVERTER not in refusal or tdir not in refusal:
            raise AssertionError(f"the refusal names no converter: "
                                 f"{refusal}")
        print(f"infer --checkpoint <orbax dir> without tensorstore: "
              f"{refusal}")

    rates = {"kernels": [], "xla": []}
    outs = {}
    forwards = 1 + 1 + infer.THROUGHPUT_ITERS
    for route in ("kernels", "xla", "xla", "kernels"):
        extra = ["--attn-backend", "xla"] if route == "xla" else []
        ops.reset_launch_counts()
        out, text = _captured(infer.main, argv + extra)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want = {k: (0 if route == "xla" else PER_FORWARD.get(k, 0) * forwards)
                for k in got}
        if got != want:
            raise AssertionError(f"infer on the {route} route: launch counts "
                                 f"{got} != {want}")
        line = xla_route.describe("xla" if route == "xla" else None)
        if text.splitlines()[0] != line:
            raise AssertionError(f"infer's first line {text.splitlines()[0]!r}"
                                 f" is not {line!r}")
        rates[route].append(out["pairs_per_sec"])
        outs[route] = torch.tensor(out["logits"])
    r = rel(outs["xla"], outs["kernels"])
    agree = (outs["xla"].argmax(-1) == outs["kernels"].argmax(-1)).float()
    print(f"infer --attn-backend xla against the kernel route at B={B}: "
          f"decision logits rel {r:.3e} (bar {XLA_BAR}), top-1 agreement "
          f"{agree.mean():.4f}; pairs/s kernels "
          + " / ".join(f"{v:.1f}" for v in rates["kernels"]) + ", xla "
          + " / ".join(f"{v:.1f}" for v in rates["xla"])
          + " (bf16, device-resident batch, logits fetched every forward)")
    if not (math.isfinite(r) and r < XLA_BAR):
        raise AssertionError(f"--attn-backend xla: rel {r} vs the kernels")

    # the same batch on the card: the XLA route in fp32 against the plain
    # fp32 path, each bf16 route's distance from it, the control
    x32 = infer.prepare(batch, dev, torch.float32)
    plain32 = sum(make_fusion_forward(compute_dtype=torch.float32,
                                      reference=True)(models_native, *x32))
    xla32 = sum(make_fusion_forward(compute_dtype=torch.float32,
                                    attn_backend="xla")(models_native, *x32))
    xla_fwd = make_fusion_forward(attn_backend="xla")
    xla16 = sum(xla_fwd(models_native, xc, xe))
    r32, r16 = rel(xla32, plain32), rel(xla16, logits["native"])
    controls = {}
    for name, wrong in xla_controls(xla_route).items():
        keep = xla_route.mhsa
        xla_route.mhsa = wrong
        try:
            controls[name] = rel(sum(xla_fwd(models_native, xc, xe)),
                                 logits["native"])
        finally:
            xla_route.mhsa = keep
    print(f"the XLA route at B={B}: fp32 against the plain fp32 path rel "
          f"{r32:.3e} (bar {XLA_F32_BAR}); bf16 against the kernel route rel "
          f"{r16:.3e} (bar {XLA_BAR}); against the plain fp32 path the "
          f"kernels' bf16 logits rel {rel(logits['native'], plain32):.3e}, "
          f"the XLA route's {rel(xla16, plain32):.3e}; controls "
          + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()))
    if not (r32 < XLA_F32_BAR and r16 < XLA_BAR):
        raise AssertionError(f"the XLA route: fp32 rel {r32}, bf16 rel {r16}")
    if not all(v >= XLA_BAR for v in controls.values()):
        raise AssertionError(f"a wrong XLA route passes XLA_BAR: {controls}")
    prof = profile_forward(xla_fwd, models_native, xc, xe)
    print(f"the XLA route at B={B}, profiled: {prof['wall_ms']:.1f} ms per "
          f"forward on the host clock, device busy {prof['device_ms']:.1f} "
          f"ms ({prof['device_ms'] / prof['wall_ms']:.1%}); launches that "
          f"waited for a full queue {prof['queue_full_per_forward']} per "
          "forward; device ms per forward by operator: "
          + "; ".join(f"{k} {v:.2f} ms x{n}"
                      for k, (v, n) in prof["by_op"][:12]))

    man_ft = write_covid_ds(os.path.join(tmp, "ds"), 32, seed=45)
    ops.reset_launch_counts()
    (res,), text = _captured(finetune.main, [
        "-a", "vit_small", "-b", "32", "--epochs", "1", "--draws", "1",
        "--covid-ds", man_ft, "--lr", "0.01", "-j", "8", "-p", "1",
        "--device", dev.type, "--semi-supervised", "--attn-backend", "xla",
        "--storage-root", os.path.join(tmp, "ft_xla")])
    torch.cuda.synchronize()
    got = ops.launch_counts()
    losses = res.extra["train_losses"]
    print(f"finetune --attn-backend xla: {len(losses)} step, loss "
          f"{losses}; launch counts {got}")
    if (len(losses) != 1 or not all(math.isfinite(v) for v in losses)
            or any(got.values())
            or text.splitlines()[0] != xla_route.describe("xla")):
        raise AssertionError("finetune --attn-backend xla: losses "
                             f"{losses}, launch counts {got}")
    return {"reference_layout_equal": same, "tensorstore": has_ts,
            "xla_rel_vs_kernels": r, "xla_top1_agreement":
                agree.mean().item(), "xla_f32_rel_vs_plain_f32": r32,
            "xla_controls_rel": controls,
            "pairs_per_sec_B256": rates,
            "xla_profile_B256": {k: prof[k] for k in (
                "wall_ms", "device_ms", "queue_full_per_forward")}
            | {"by_op": [[k, v, n] for k, (v, n) in prof["by_op"][:12]]}}


def main() -> int:
    smi = environment()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    phase("build")
    from mfvit_tpu_torch.ops import build
    built = build.library_path().exists()
    t0 = time.perf_counter()
    build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}"
          + (" (already built)" if built else ""))

    phase("forward kernels against their plain versions (B=8)")
    errs = check_kernels(dev)

    with tempfile.TemporaryDirectory() as tmp:
        phase("the serving slice through mfvit_tpu_torch.cli.infer "
              "(vit_small, B=32)")
        counts = run_slice(dev, tmp, int8=False)

        phase("int8 kernels K10/K11 against their plain versions")
        errs.update(check_i8_kernels(dev))

        phase("the int8 serving slice through mfvit_tpu_torch.cli.infer "
              "--int8 (vit_small, B=32)")
        i8_counts = run_slice(dev, tmp, int8=True)
    counts.update({k: i8_counts[k] for k in PER_I8_FORWARD
                   if k != "fused_fusion_cls"})

    phase("checkpoint interop and --attn-backend: the save_serving file "
          "against the reference layout, tensorstore, infer on the kernel "
          "and the XLA route (vit_small, B=256), finetune --attn-backend xla")
    with tempfile.TemporaryDirectory() as tmp:
        interop = run_interop(dev, tmp)

    phase("stand-alone attention kernels K12/K13/K14 against their plain "
          "versions")
    errs.update(check_mhsa_kernels(dev))

    phase("the XLA-level W8A8 path: quantize_vit_params + fused_forward "
          "(vit_small, B=32)")
    q_counts = run_quant_path(dev, 224, 32)
    counts.update({k: q_counts[k] for k in MHSA})
    phase("the XLA-level W8A8 path at 384 px (vit_small, B=4)")
    run_quant_path(dev, 384, 4)

    phase("backward kernels against their plain versions")
    errs.update(check_bwd_kernels(dev))

    phase("the training slice through mfvit_tpu_torch.cli.finetune "
          "(vit_small, B=32, FT then LP)")
    with tempfile.TemporaryDirectory() as tmp:
        ft_counts = run_training(dev, tmp)
    counts.update({k: ft_counts[k] for k in PER_FT_STEP})

    phase("train-step parity, kernel path against plain path (B=32)")
    train_parity(dev)

    phase("K15's GEMM core against K1's and K2's: the probe (B=8); its "
          "MN-major forms against K5's and K7's former GEMMs (B=8, B=256)")
    probe = probe_gemm(dev)
    probe_bwd = probe_gemm_bwd(dev)
    phase("K5 and K7 (and K3's backward) against the chains they ran before "
          "(vit_small B=8/32/256, vit_base B=2/16, N=50 at head_dim "
          "32/64/128, head_dim 128 at N=208/256)")
    bwd_former = check_bwd_former(dev)
    phase("K1 and K2 against the chains they ran before (B=8; B=3; N=50; "
          "D=128-768)")
    halves_diff = check_halves(dev)
    phase("K3 and K4 against their former designs (K3 at the shapes above; "
          "K4 at B=1-256, N=197 and 50, D=384 and 768)")
    heads_former = check_heads(dev)
    phase("K15 against the K1 -> K2 chain and its plain versions (B=8)")
    errs["fused_transformer_block"] = check_block_kernel(dev)
    phase("K15's entry point: mfvit_tpu_torch.tools.bench_block (B=512, "
          "12 blocks)")
    bench_counts, bench = run_bench_block(dev)
    counts["fused_transformer_block"] = bench_counts["fused_transformer_block"]

    phase("schedule variants T6/T7/T3/T4/T1/T2/T5 against K2/K1/K5 and "
          "their plain versions (B=8; N=50; B=3; B=6; D=512)")
    check_variant_kernels(dev)
    phase("the variants' entry points: mfvit_tpu_torch.tools.bench_mlp3d, "
          "bench_pipelined, bench_attn_pairs, bench_rolling (B=512, 12 "
          "blocks) and bench_bwd_staged (B=256, 12 backwards)")
    variant_counts, variant_lines, variant_errs = run_variant_tools(dev)
    counts.update(variant_counts)
    errs.update(variant_errs)

    phase("the fusion-training slice through mfvit_tpu_torch.cli.fuse "
          "(vit_small, B=32, LP then --semi-supervised), then infer on its "
          "model_best")
    with tempfile.TemporaryDirectory() as tmp:
        run_fusion(dev, tmp)
    phase("fusion train-step parity, kernel path against plain path (B=32)")
    fusion_parity(dev)
    phase("the GPT fusion head through mfvit_tpu_torch.cli.fuse "
          "--fusion-arch gpt (vit_small, B=32, LP then --semi-supervised), "
          "then infer --fusion-arch gpt on its model_best; GPT fusion "
          "train-step parity (B=32); the ViT + CNN cross-attention head "
          "(B=32)")
    with tempfile.TemporaryDirectory() as tmp:
        run_fusion(dev, tmp, arch="gpt")
    fusion_parity(dev, arch="gpt")
    crossvit_rel = check_crossvit_cnn(dev)

    phase("MoCo pretraining through mfvit_tpu_torch.cli.pretrain "
          "(vit_small, B=32, two epochs, --export-torch); pretrain-step "
          "parity (B=32); one step of v3_symmetric, vit_conv_small and "
          "resnet50")
    with tempfile.TemporaryDirectory() as tmp:
        moco_per_step = run_pretrain(dev, tmp)
    moco_parity = pretrain_parity(dev)
    moco_variants = pretrain_variants(dev)
    phase("MoCo's other inputs through mfvit_tpu_torch.cli.pretrain "
          "(vit_small, B=32, two epochs: --in-chans 4, --aug-setting moco_v2 "
          "--crop-min 0.2, --pairing enh_cxr --per-enh 0.5); 4-channel "
          "pretrain-step parity (B=32); the e2e twin "
          "(mfvit_tpu_torch.tools.e2e_workflow, vit_small, 224 px)")
    with tempfile.TemporaryDirectory() as tmp:
        moco_inputs = run_pretrain_inputs(dev, tmp)
    moco_parity_4ch = pretrain_parity(dev, in_chans=4)
    with tempfile.TemporaryDirectory() as tmp:
        e2e_metrics = run_e2e_twin(dev, tmp)

    phase("the data path: the store's views on the card against the CPU "
          "(B=256); finetune FT through the store, --device-store-mb 0 and "
          "--aug-host (B=16, 128 images; launches, host-to-device copies "
          "per step, the eval store); the view's ms and the CLIs' rates on "
          "each feed (1,024 images)")
    view_ties_b256 = check_views(dev)
    with tempfile.TemporaryDirectory() as tmp:
        store_ft = run_store_finetune(dev, tmp)
    view_ms = time_views(dev)
    with tempfile.TemporaryDirectory() as tmp:
        feeds = time_feeds(dev, tmp)

    phase("ddp: finetune FT and pretrain (v2 queue) through the --dist-* "
          "flags on a one-process NCCL group against the plain runs "
          f"(vit_small, B={DDP_BATCH}, the store; launches, rates); two "
          "gloo ranks on cuda:0 against one process (FT and MoCo v2 queue "
          "and v3, B=32)")
    with tempfile.TemporaryDirectory() as tmp:
        ddp = run_ddp(dev, tmp)

    phase("times (B=256; K12-K14 also at N=577, B=64; K5/K7 also at a "
          "vit_base block, B=64; the fusion step also at B=32, and with the "
          "GPT head; GPT serving and the GPT head alone; the schedule "
          "variants against K1/K2)")
    times = time_kernels(dev)
    times.update(time_mhsa(dev, "vit_small", 256, 197, 384, 12))
    mhsa_577 = time_mhsa(dev, "vit_small@384", 64, 577, 384, 12)
    times.update(time_bwd(dev, "vit_small", 256, 384))
    base = time_bwd(dev, "vit_base", 64, 768)
    # every launch-by-launch breakdown of this phase and the 384-px one
    stages = fresh_stage_times({
        **BWD_STAGES, "k15": ("k15", {}),
        **{op: (op, {}) for pair in HALF_OPS.values() for op in pair},
        **{f"{op} {label} B={B}": (op, dict(B=B, D=D, N=N, heads=h))
           for op, label, B, N, D, h in STAGE_TIMED}})
    bwd_stages = {k: stages[k] for k in BWD_STAGES}
    e2e = time_e2e(dev)
    quant_profile = profile_quant(dev)
    train = time_train(dev, 256, 4)
    train_cli = time_train(dev, 16, 32)  # the finetune CLI's default -b
    k15_ms, k15_plain_ms, k15_lib_ms, pair_ms = time_block(dev)
    k15_stages = stages["k15"]
    halves = time_halves(dev)
    half_stages = {op: stages[op] for pair in HALF_OPS.values() for op in pair}
    gemm_times = time_gemm(dev)
    times["fused_transformer_block"] = (k15_ms, k15_plain_ms, k15_lib_ms)
    variant_times, base_plain = time_variants(dev)
    for name, _, _, base_name in VARIANTS:
        setting = " ".join(f"{k}={v}" for k, v in VARIANT_DEFAULT[name].items())
        times[name] = (variant_times[(name, setting)][0], base_plain[base_name],
                       None)
    fusion_cli = time_fusion(dev, 32, 8)  # the fuse CLI's default -b
    fusion_256 = time_fusion(dev, 256, 3)
    gpt_fusion_cli = time_fusion(dev, 32, 8, arch="gpt")
    gpt_serving = time_gpt_serving(dev)
    gpt_head = {B: time_gpt_head(dev, B) for B in (256, 32)}
    moco_256 = time_pretrain(dev, 256, 4)
    moco_4ch_256 = time_pretrain(dev, 256, 4, in_chans=4)
    moco_cli = time_pretrain(dev, 16, 32)  # the pretrain CLI's default -b
    moco_profile = profile_pretrain(dev)
    with tempfile.TemporaryDirectory() as tmp:
        moco_feeds = time_pretrain_feeds(dev, tmp)

    phase("long-sequence kernels K9 and K10 against their plain versions")
    errs.update(check_long_kernels(dev))
    phase("K9 and K11 against the chains they ran before (K9 at N=257-1025, "
          "head_dim 32/64/128; K11 at B=2-256, D=384 and 768, 224 and 384 px)")
    long_former = check_long_former(dev)
    phase("K10 against the chain it ran before (B=2-256, D=384 and 768, "
          "N=50-577, head_dim 32/64/128, both routes)")
    long_former.update(check_k10_former(dev))

    with tempfile.TemporaryDirectory() as tmp:
        phase("the serving slice at 384 px through mfvit_tpu_torch.cli.infer "
              "(vit_small, B=16)")
        counts["fused_attention_block_large"] = run_slice(
            dev, tmp, int8=False, img=384)["fused_attention_block_large"]
        phase("the int8 serving slice at 384 px through "
              "mfvit_tpu_torch.cli.infer --int8 (vit_small, B=16)")
        run_slice(dev, tmp, int8=True, img=384)

    phase("the training slice at 384 px through mfvit_tpu_torch.cli.finetune "
          "(vit_small, B=8, FT)")
    with tempfile.TemporaryDirectory() as tmp:
        run_training(dev, tmp, img=384)
    phase("train-step parity at 384 px, kernel path against plain path (B=8)")
    train_parity(dev, B=8, img=384)

    phase("times at 384 px (K9 at B=64 and B=16, K10, K2 and K11 at B=64, "
          "the launches of K9, K10 and K11 and of their former chains, "
          "serving B=64, FT B=32)")
    long_times = time_long_kernels(dev)
    times["fused_attention_block_large"] = long_times[
        "fused_attention_block_large at vit_small@384"]
    long_stages = {f"{op} {label} B={B}": stages[f"{op} {label} B={B}"]
                   for op, label, B, N, D, h in STAGE_TIMED}
    e2e_384 = time_e2e(dev, B=64, img=384)
    train_384 = time_train(dev, 32, 4, img=384)
    k9_bwd_384 = time_k9_backward(dev, 32)
    phase("done")

    bounds = kernel_bounds(256, 197, 384, 12, 1536, 3)
    base_bounds = kernel_bounds(64, 197, 768, 12, 3072, 3)
    long_bounds = {f"{name} at {label}": kernel_bounds(B, N, D, heads, 4 * D,
                                                       3)[name]
                   for name, label, B, N, D, heads in (
                       [("fused_attention_block_large", *k) for k in K9_TIMED]
                       + list(LONG_TIMED))}
    bounds["fused_attention_block_large"] = long_bounds[
        "fused_attention_block_large at vit_small@384"]
    bounds.update({k: mhsa_bound(256, 197, 384, 12) for k in MHSA})
    bounds.update({name: bounds[base] for name, _, _, base in VARIANTS})
    bound_577 = mhsa_bound(64, 577, 384, 12)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": times[name][2] if len(times[name]) > 2 else None}
        for name, src, rep in KERNELS]}
    print(json.dumps({"e2e_pairs_per_sec_B256": e2e,
                      "ft_train_images_per_sec_B256": train,
                      "ft_train_images_per_sec_B16": train_cli,
                      "vit_base_bwd_B64": {
                          k: {"ms": v[0], "plain_ms": v[1],
                              "bound_ms": base_bounds[k][0],
                              "bound_by": base_bounds[k][1]}
                          for k, v in base.items()},
                      "e2e_pairs_per_sec_384_B64": e2e_384,
                      "ft_train_images_per_sec_384_B32": train_384,
                      "k9_backward_fp32_ms_384_B32": k9_bwd_384,
                      "quant_profile_B256": quant_profile,
                      "mhsa_vit_small@384_B64": {
                          k: {"ms": v[0], "plain_ms": v[1], "sdpa_ms": v[2],
                              "bound_ms": bound_577[0],
                              "bound_by": bound_577[1]}
                          for k, v in mhsa_577.items()},
                      "k15_B256": {
                          "ms": k15_ms, "plain_ms": k15_plain_ms,
                          "library_ms": k15_lib_ms, "k1_then_k2_ms": pair_ms,
                          "bound_ms": bounds["fused_transformer_block"][0],
                          "stages_ms": k15_stages},
                      "halves_B256": {
                          name: {"ms": v[0], "former_design_ms": v[1],
                                 "stages_ms": half_stages[HALF_OPS[name][0]],
                                 "former_stages_ms":
                                     half_stages[HALF_OPS[name][1]]}
                          for name, v in halves.items()},
                      "halves_outputs_differ_from_former": halves_diff,
                      "k3_outputs_differ_from_former": heads_former["k3"],
                      "k4_rel_vs_former": heads_former["k4"],
                      "gemm_probe_outputs_differ_B8": probe,
                      "gemm_bwd_probe_outputs_differ": probe_bwd,
                      "bwd_outputs_differ_from_former": bwd_former,
                      "bwd_stages_ms": bwd_stages,
                      "gemm_B256": {
                          k: {"wgmma_ms": v[0], "gemm_ln_ms": v[1],
                              "wgmma_tflops": v[2], "gemm_ln_tflops": v[3]}
                          for k, v in gemm_times.items()},
                      "bench_block_B512_12_blocks_ms": {
                          k: v[0] for k, v in bench.items()},
                      "variants_B256": {
                          f"{n} {st}": {"ms": v[0], "base_ms": v[1]}
                          for (n, st), v in variant_times.items()},
                      "variant_tools_B512_12_blocks_ms": {
                          tool: {k: v[0] for k, v in res.items()}
                          for tool, res in variant_lines.items()},
                      "fusion_step_pairs_per_sec_B32": fusion_cli,
                      "fusion_step_pairs_per_sec_B256": fusion_256,
                      "gpt_fusion_step_pairs_per_sec_B32": gpt_fusion_cli,
                      "gpt_serving_pairs_per_sec_B256": gpt_serving,
                      "gpt_head_ms": gpt_head,
                      "crossvit_cnn_rel_B32": crossvit_rel,
                      "moco_step_images_per_sec_B256": moco_256,
                      "moco_step_4ch_images_per_sec_B256": moco_4ch_256,
                      "moco_feeds_images_per_sec_host_bound_B32": moco_feeds,
                      "moco_inputs_launches_per_step": moco_inputs,
                      "moco_step_parity_4ch_B32": moco_parity_4ch,
                      "e2e_twin_metrics": e2e_metrics,
                      "data_path": {
                          "view_pixels_differ_worst_tie_B256": view_ties_b256,
                          "store_finetune_B16": store_ft,
                          "view_ms_B256": view_ms,
                          "cli_rates_epoch2": feeds["rates"],
                          "fill_s_per_1000": feeds["fill_s_per_1000"]},
                      "moco_step_images_per_sec_B16": moco_cli,
                      "moco_launches_per_step": moco_per_step,
                      "moco_step_launches_other": moco_variants,
                      "moco_step_parity_B32": moco_parity,
                      "moco_step_profile_B256": moco_profile,
                      "long_B64_B16": {k: {
                          "ms": v[0], "plain_ms": v[1],
                          "bound_ms": long_bounds[k][0],
                          "bound_by": long_bounds[k][1]}
                          for k, v in long_times.items()},
                      "k9_k10_k11_stages_ms": long_stages,
                      "k9_k10_k11_outputs_differ_from_former": long_former,
                      "interop": interop,
                      "ddp": ddp,
                      "card": smi}))
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

"""Chip smoke test of the PyTorch/CUDA port (``audio_fewshot_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code):

1. versions, and the card's name and power limit from ``nvidia-smi``;
2. build the CUDA kernels from ``audio_fewshot_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together); a kernel that spills registers
   fails the run;
3. each kernel against its plain PyTorch version on the card, in float32
   with TF32 off, at the main-path shape, at the shapes phase 11's TTA cell
   gives it (its episode batch and its augmented segments), at phase 20's
   flat training batch (128, 64, 304) (timed too), at phase 22's resnet18Bdc
   shapes (4496, 64, 80) (timed, and against float64) and (75, 64, 80), at
   odd shapes
   (every padded width of the kernel on both of its load paths), and on three
   adversarial inputs (post-ReLU, near-duplicate rows, scaled by 30) where
   both are also held against a float64 evaluation (max abs error limit
   5e-4 each) beside a plain emulation of the kernel's arithmetic, with the
   kernel's, the plain version's and the bound's time;
   a timed call rotates over input buffers larger than the L2 cache together;
4. the slice: DeepBDC + resnet12Bdc episodic evaluation at full width
   (``deepbdc_5shot_iid_seed0`` as a dict, on a ``synthetic`` root of
   ``[1, 128, 157]`` log-mel segments, ragged query clips of up to 6
   segments, 16 episodes per step), through the port's ``Test``: the val
   calibration pass, one warm-up step and the test epochs, at the default
   bf16.  Kernel launch counts are reset just before it and read just after;
5. one float32 batch: segment logits on the card against the same model on
   the CPU;
6. the backward kernel against autograd through the plain version on the
   card, in float32 with TF32 off, at the training shape (75, 64, 304),
   phase 20's flat one (128, 64, 304) and phase 22's resnet18Bdc one (75,
   64, 80) (all three timed; the last against float64 too), at the odd
   shapes of
   phase 3 (every padded width on both load paths), with
   one element, with clusters of 8, 2 and 1 blocks and with slices walked in
   chunks (relative to the max abs, limit 1e-4), twice on one input (the
   same bits), and on
   the adversarial inputs plus all-zero rows, where the kernel, the plain
   version and a plain emulation of the kernel's arithmetic are also held
   against a float64 autograd (limit 5e-4 for the kernel); with the
   kernel's, the plain version's, the bound's and ``torch.bmm``'s time
   (eager calls over rotating buffers; the kernel's and ``torch.bmm``'s
   time as a CUDA graph of calls beside them, for context);
7. training: ``Trainer`` on ``deepbdc_5shot_iid_seed0`` at full width
   (``train.slice_config``: 75 segments a step, bf16 backbone, fp32 head,
   Adam, cosine LR, augmentation on; cut to 2 epochs of 40 episodes, 32
   val and test episodes), then a third epoch through the resume entry
   point, which must start at epoch 2 with the saved optimizer and
   scheduler state.  Launch counts are reset just before and read just
   after: the backward kernel must run once per train step;
8. a JSON line with each kernel's launches, error and times, then the card's
   ``nvidia-smi`` line, then ``{"ok": true, "device": {...}}`` as the last line
   (printed after phases 9-25, which run before it);
9. ProtoNet eval: ``proto_5shot_iid_seed0`` at full width (``eval.slice_config
   (classifier="ProtoNet")``: Conv64F with the 64 -> 1600 logits head, 16
   episodes per step, bf16) through ``Test``, with eps/s per epoch and the
   peak memory; the BDC kernels' launch counts, reset just before, must read
   0; then one float32 batch: segment logits on the card against the CPU;
10. ProtoNet training: ``train.slice_config(classifier="ProtoNet")`` through
   ``Trainer`` (2 epochs of 40 episodes), then a third epoch through the
   resume entry point, which must start at epoch 2; finite losses, train
   eps/s, ms a step, peak memory, BDC kernel launches 0;
11. DeepBDC eval with the energy-OOD TTA re-vote
   (``enhance_classification_via_energy``): the eval cell at 8 episodes a
   step, 32 test episodes, one epoch; the flagged clips and the augmented
   segments of each step, read from the step and held against the cell's
   (80 and 4800), TTA eps/s, the peak memory and the ``bdc_pool``
   launches; accuracies finite and within [0, 100].

12. the Conv64F local-descriptor heads' evaluation: DN4, ADM, ADM_KL,
   ConvMNet, ATLNet and MCL, each its shipped ``*_5shot_iid_seed0`` at full
   width (``eval.slice_config(classifier=...)``: Conv64F's [64, 4, 5] map,
   16 episodes a step, bf16 backbone, fp32 head) through ``Test``, cut to
   one epoch of 128 test episodes: eval eps/s of the epoch, ms a step,
   peak memory, BDC launches (must be 0), and one float32 episode's logits
   on the card against the CPU;
13. their training: each through ``Trainer`` for one epoch of 10 episodes
   with 16 val and test episodes (finite losses, train eps/s, ms a step, peak
   memory, BDC launches 0); then RelationNet: its shipped config must raise
   its error on the card, and at ``maxpool_last2: false`` (NOT the shipped
   geometry) one float32 episode card vs CPU and one such training epoch;
14. BPA: ProtoNet with ``use_bpa`` at full width through ``Test`` at phase
   12's cut (transport over [support ‖ query] sets of 25 + the query
   bucket, 281 rows), one float32 episode card vs CPU; DeepBDC with ``use_bpa`` and the TTA
   re-vote at phase 11's cut, whose ``bdc_pool`` launches must be phase
   11's count;
15. the heads on the plain resnet12 (MetaBaseline and DSN on its flat
   12800 features; FRN and CAN on its [640, 8, 9] map; MetaBaselineKendall
   and FEAT only train, in phase 16), each its shipped
   ``*_5shot_iid_seed0`` at full width through ``Test`` at one epoch of 32
   test episodes: eval eps/s of each epoch, ms a
   step, peak memory, BDC launches (must be 0), one float32 episode's logits
   on the card against the CPU, and the phase's wall;
16. their training, each one epoch at phase 13's cut with ``drop_rate`` 0.1
   as shipped (finite losses, train eps/s, ms a step, peak memory, BDC
   launches 0; Kendall's peak within 4 GiB of MetaBaseline's); then one
   MetaBaseline epoch started mid-ramp, from DropBlock counters at 30000 (the
   end of a shipped 30 x 1000-episode run): the share each DropBlock drops
   against 1 - keep; and one more epoch through resume, which must carry the
   counters on.
17. CPEANet on the class-aware vit_tiny (``cpea_5shot_iid_seed0`` at full
   width: 73 tokens of 192, 12 blocks, bf16 backbone, fp32 head) through
   ``Test`` at phase 12's cut (eval eps/s of each epoch, ms a step, peak
   memory, BDC launches 0), one float32 episode's logits on the card against
   the CPU (with cuDNN's deterministic algorithms, as every card-vs-CPU
   check: the configs' ``deterministic: true``), and one training epoch at
   phase 13's cut;
18. R2D2, MAML, ANIL and BOIL, each its shipped ``*_5shot_iid_seed0`` on
   Conv64F's 1600 flat features, the same way (MAML and ANIL adapt 10 inner
   steps an eval episode, BOIL evaluates NIL; MAML trains second order, two
   episodes a step); for the three MAML-family heads, on the card under
   ``no_grad`` as ``Test`` runs them, the adapted logits must differ from
   the unadapted ones (BOIL: one step against none) and no parameter may
   hold a ``.grad``; and R2D2MCL (no shipped config) on MCL's Conv64F map:
   one float32 episode card vs CPU.
19. MeTAL, LEO, VERSA and DMatchingNet on Conv64F's 1600 flat features and
   MTL on resnet12's 12800, each its shipped ``*_5shot_iid_seed0`` the same
   way (eval at phase 12's cut, fp32 card vs CPU with LEO's and VERSA's
   noise drawn on the CPU and handed to both, one training epoch at phase
   13's cut; BDC launches 0; LEO's losses held finite at its first step
   and then reported: the JAX package's own trainer drives LEO's shipped
   config to NaN on this data); then MeTAL's ``per_step_adapters`` path (no
   shipped config) with its adapters off identity and DMatchingNet's
   ``single`` branch, each one float32 episode card vs CPU.
20. the finetuning family and the pretrainers: Baseline and BaselinePlus
   on Conv64F's 1600 flat features, NegNet, RFSModel, SKDModel,
   MetabaselinePretrain and FEAT_Pretrain (no shipped config) on
   resnet12's 12800, DeepBDC_Pretrain on resnet12Bdc's 2080 BDC features,
   each its shipped ``*_5shot_iid_seed0`` at full width: eval through
   ``Test`` (Conv64F's at phase 12's cut, the others at phase 15's: eps/s,
   ms a step, peak memory), one float32 episode's logits card vs CPU (the
   probe heads' too: both ends converge to the same optimum), one training
   epoch on flat batches of 128 (7 steps over the synthetic root's 25 x 40
   clips; ms a step, segments through the backbones a second, finite
   losses) and one flat train step's loss card vs CPU (the first 32 rows
   of the first batch, dropout off).  BDC launches are reset before each
   cell and read after it: DeepBDC_Pretrain must launch the forward kernel
   once a backbone call of its eval and training passes and the backward
   kernel once a train step, every other cell neither.  Then its
   ``save_part`` checkpoint of ``emb_func`` loads into DeepBDC through
   ``pretrain_path`` (the weights held equal) for one eval epoch, and
   DeepBDC_Pretrain with ``val_type: stl`` (no shipped config) runs card vs
   CPU.
21. RENet and the last pretrainers, each its shipped ``*_5shot_iid_seed0``
   at full width: RENet on resnet12's [640, 8, 9] map (SCR and CCA) through
   ``Test`` at phase 15's cut (one epoch of 32 test episodes, 16 a step:
   eps/s, ms a step, peak memory), one float32 episode card vs CPU, one
   training epoch at phase 13's cut and the same epoch with the dual
   loader (``dataloader_num: 2``, flat batches of 12, from
   ``config/kos_fixture/renet_5shot.yaml``; NOT shipped traffic), each with
   one float32 train step's loss card vs CPU (DropBlock off); FRN_Pretrain
   (resnet12's map) and S2M2 (Conv64F's 1600 flat features) as phase 20's
   cells (eval, card vs CPU, one flat epoch of 7 steps of 128, a flat
   step's loss card vs CPU); MTLPretrain and MetabaselineKendallPretrain (no
   shipped config) one eval step of 16 episodes and one float32 episode
   card vs CPU.  No BDC kernel may launch in any of these cells.
22. the CNN backbones no shipped config names, each swapped into a shipped
   head's config at its JAX defaults (NOT shipped traffic): DeepBDC on
   resnet18Bdc (``bdc_pool`` at M = 80), MCL on resnet12_mcl, R2D2 on
   resnet12_r2d2, MTL on resnet12MTLofficial (8 episodes a step) and
   ProtoNet on WRN-28-10 (4 a step): eval through ``Test`` at phase 15's
   cut, one float32 episode card vs CPU (MTL at 5 inner steps), one
   training epoch at phase 13's cut, the BDC launches (a backbone call
   each, the backward one a train step, in the resnet18Bdc cell; 0 in the
   others); S2M2 on resnet18 as phase 20's cells; and IFSL's cycle:
   IfslPretrain (Conv64F, 25 classes) trains one flat epoch and saves
   ``emb_func`` and ``classifier``, the featuring run writes the [25, 1600]
   class means, and ``ifsl_5shot_iid_seed42`` (DMatchingNet) loads all
   three (held equal to what was written) for one eval epoch and a float32
   episode card vs CPU.
23. Swin (NOT shipped traffic): ProtoNet on swin_t at full width
   (``proto_5shot_iid_seed0`` with its backbone swapped, 768 mean features)
   through ``Test`` at phase 15's cut with ``dump_features`` (one
   ``featdata_*.npz`` an episode of the first test batch, 75 rows each
   held), one float32 episode card vs CPU, one training epoch at phase 13's
   cut with ``profile_steps: 2`` (its Chrome trace read back for CUDA kernel
   events); swin_mini one float32 episode card vs CPU.  BDC launches 0.
24. CLAP (NOT shipped traffic), on roots of waveforms made from the seed:
   the port's extraction CLI on the card with the full-width random-init
   HTSAT-tiny (10 s windows at 48 kHz; clips/s, peak memory, unit norms,
   eight clips' float32 embeddings card vs CPU), ProtoNet on
   ``CLAPEmbeddingBackbone`` over the embeddings (one eval epoch), ProtoNet
   with ``is_clap`` on 1-D waveforms of 480 000 samples (one eval epoch at
   phase 15's cut, one training epoch at phase 13's), and a ``Trainer``
   step from a ``save_params`` npz through ``checkpoint_path`` (the loaded
   weights held equal to the saved ones).  BDC launches 0.
25. episode-parallel (``parallel_phase``): the dry run's ProtoNet/Conv64F
   cell (3 SGD steps of 8 episodes, float32), the flagship's training cell
   (``deepbdc_5shot_iid_seed0`` at full width, 2 steps of 2 episodes, val
   and test 8 episodes 4 a step, float32, SGD) and its eval with the TTA (8
   episodes, 2 a step, float32) through ``Trainer`` and ``Test`` on one
   rank (a 1-rank NCCL group on a 1-card machine), over 2 gloo ranks that
   share card 0 (the 2-rank arithmetic with both CUDA kernels on every
   rank) and, where the machine has several cards, over one NCCL rank a
   card: each run's ranks, backend, wall, train ms a step and eval eps/s,
   every rank's BDC launches (both kernels on every rank), each run
   against the 1-rank one (ProtoNet at the CPU tests' limits; the
   flagship's first loss and every parameter after its first step held
   tightly, its later loss and parameters loosely, the calibration
   threshold, the per-episode accuracies, with the limits printed), two
   controls over the gloo ranks (no gradient all-reduce; BatchNorm moments
   per rank) that the first-step limits must catch, the gradient
   all-reduce's and the small all-reduces' share of a step timed between
   syncs; and the flat family over ranks: ``deepbdc_pretrain_5shot_iid_seed0``
   at full width (2 flat steps of the shipped 128, 64 rows a rank over 2,
   float32, SGD; both BDC kernels at (64, 64, 304) on each rank, which phases
   3 and 6 check; its val and test at the shipped one episode a step,
   replicated over 2 ranks), held at the flagship's limits with its flat step
   ms printed, and the dry run's Baseline, MetabaselinePretrain, S2M2 (its
   mixed rows), FEAT, MeTAL (both loss-net paths), a ``Trainer``'s replicated
   eval and IfslPretrain's featuring sums at its own limits; and the 17
   methods audited for ranks last: ``adm_5shot_iid_seed0`` at full width
   (2 steps of 2 episodes, val and test 4 episodes 2 a step, float32, SGD;
   ADM's head BatchNorm over the whole step's query rows) at the
   flagship's limits with its val and test logits,
   ``versa_5shot_iid_seed0``'s eval at full width (8 episodes, 4 a step,
   ragged queries; VERSA's trunk BatchNorm on both ranks' real rows in
   eval) on its logits and accuracies, and the dry run's 17 head scenarios
   (``HEAD_CELLS``), its ragged eval of RelationNet and VERSA and ``Test``'s
   replicated steps at its own limits.

To keep the script inside its time limit with phases 23-24, phase 15's
eval cut (phases 15 and 20-24) is one epoch of 32 test episodes, not 64,
and the card-vs-CPU episodes of the resnet12-family cells of phases 15, 20
and 21 take ``CPU_QUERIES`` (16) query segments, as phase 22's; with phase
25, phase 15 evaluates four of its six heads (MetaBaselineKendall's and
FEAT's eval, 25.6 s and 43.1 s of its 100.1 s on an H100 80GB HBM3 at 700
W, left out; phase 16 trains both), ``EVAL_CUT`` is one epoch of 128 test
episodes and ``HEAD_TRAIN_CUT`` one epoch of 10 train episodes; with the
flat family's cells, phase 25 no longer times the bf16 step with and
without ``deterministic`` nor phases 9 and 11's eval with and without
``transfer_ahead`` (both settled: 47.48 / 46.71 ms, and within +-5 %); with
the heads' cells of phase 25, phases 20-22 evaluate one step of 16 test
episodes (``LATE_EVAL_CUT``, not 32), and their training cells run val and
test passes of 8 episodes (``LATE_TRAIN_CUT``, ``FLAT_TRAIN_CUT``; 16
before).

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import copy
import inspect
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# peak rates of the variant the run names (NVIDIA data sheets, dense, without
# sparsity): float32 on the CUDA cores, and device-memory bandwidth
PEAKS = {
    "H100 SXM": {"fp32_flops": 67e12, "bytes": 3.35e12},
    "H100 PCIe": {"fp32_flops": 51e12, "bytes": 2.0e12},
}
ERR_LIMIT = 5e-4
# the backward kernel against autograd through the plain version, relative to
# the gradient's max abs; both sum in another order
GRAD_REL_LIMIT = 1e-4
# the main path's shape of the backward: one 5-way 5-shot 10-query episode
TRAIN_SHAPE = (75, 64, 304)
# float32 segment logits, card vs CPU: the convolutions sum in another order
# (cuDNN vs oneDNN) through 13 layers, and -|q-p|^2 = 2qp - |q|^2 - |p|^2
# cancels, so the limit is relative to the logits' scale
LOGIT_REL_LIMIT = 1e-3
# the Conv64F local-descriptor heads of phases 12 and 13 (RelationNet, which
# fails at the shipped geometry, is run apart)
METRIC_HEADS = ("DN4", "ADM", "ADM_KL", "ConvMNet", "ATLNet", "MCL")
# phase 13's cut of a training cell: 1 epoch of 10 episodes, 16 val and test
# (a step of 16 where a cell's test_episode_size is 16); 20 train episodes
# before phase 25 was added, when a whole call on an H100 80GB HBM3 at 700 W
# read 1113.6 s of its 1200 (cut to keep the script inside its time limit)
HEAD_TRAIN_CUT = {"epoch": 1, "train_episode": 10, "test_episode": 16}
# phases 12 and 14's eval cut: one test epoch of 128 episodes (8 steps of
# 16), so that its eps/s is read over several steps; a second epoch of 256
# repeated it within a few per cent and was cut, then the epoch to
# 128 (with phase 25), to keep the script inside its time limit
EVAL_CUT = {"test_episode": 128, "test_epoch": 1}
# the eval cut of phases 15 and 20-24 (phase 15's cut): one epoch of 32 test
# episodes, 2 steps of 16 (a resnet12 step takes ≈ 0.6 s; phase 12's cut took
# 200 s of phase 15; 64 episodes before phases 23-24 were added, cut to keep
# the script inside its time limit)
RESNET_EVAL_CUT = {"test_episode": 32, "test_epoch": 1}
# phases 15 and 16: the heads on the plain resnet12, with the map each sees
RESNET12_HEADS = ("MetaBaseline", "MetaBaselineKendall", "FEAT", "DSN", "FRN", "CAN")
# phase 15's cells since phase 25 was added (cut to keep the script inside its
# time limit): Kendall's eval (25.6 s, 5.4 s a step on an H100 80GB HBM3 at
# 700 W) and FEAT's (43.1 s, its 655 M-parameter head rebuilt on the CPU)
# left out; phase 16 still trains both
RESNET12_EVAL_HEADS = ("MetaBaseline", "DSN", "FRN", "CAN")
_FLAT = "resnet12's [640, 4, 5] avg-pooled map, 12800 features"
RESNET12_MAPS = {"MetaBaseline": _FLAT, "MetaBaselineKendall": _FLAT, "FEAT": _FLAT,
                 "DSN": _FLAT, "FRN": "resnet12's [640, 8, 9] map",
                 "CAN": "resnet12's [640, 8, 9] map"}
# Kendall's training recomputes its pair terms in the backward: its peak
# stays within this many GiB of MetaBaseline's
KENDALL_PEAK_MARGIN_GIB = 4.0
# phase 18: the meta heads on Conv64F's flat features; the MAML family's
# eval logits must move by more than this (relative to their scale) when
# they adapt
META_HEADS = ("R2D2", "MAML", "ANIL", "BOIL")
ADAPT_MIN_REL = 1e-3
# phase 19: MeTAL, LEO, VERSA and DMatchingNet on Conv64F's flat features,
# MTL on the plain resnet12's
SLICE9_HEADS = ("MeTAL", "MTL", "LEO", "VERSA", "DMatchingNet")
# heads whose shipped config the JAX package's own trainer drives to NaN on
# the synthetic root from random weights: their training epoch must start
# finite, and its later losses are reported, not held
DIVERGES = {"LEO": (
    "the JAX package's own run_trainer.py on this config (CPU, seed 1) reads "
    "103.95 at step 1 and NaN from step 2: the encoder's and decoder's "
    "exp(0.5 logvar) sample scales grow until a latent step overflows")}
# MTL's shipped 100 SGD steps at lr 0.01 over resnet12's 12800 features (norm
# ≈ 230 at random weights: lr·|x|² ≈ 500) oscillate chaotically: on one CPU
# its float32 and float64 logits part by 1.5e-7 of their scale at 5 steps,
# 1.5e-5 at 20 and 1.49 at 100.  Its float32 card-vs-CPU episode runs 5
# steps; the shipped 100 are held with a float64 head over shared features
MTL_CARD_ITER = 5
_CONV_FLAT = "Conv64F's 1600 flat features"
SLICE9_FEATURES = {
    "MeTAL": _CONV_FLAT + "; 5 inner steps an episode with both learned losses",
    "MTL": "resnet12's 12800 flat features; 100 inner steps an episode",
    "LEO": _CONV_FLAT + "; 5 latent and 5 fine-tune steps, frozen backbone",
    "VERSA": _CONV_FLAT + "; trunk BN over the whole batch, 10 samples",
    "DMatchingNet": _CONV_FLAT + "; 4 splits x (x, d) LSTM blocks, per-episode embeds",
}
# phase 20: the finetuning family and the pretrainers, with the features each
# head reads
_RESNET_FLAT = "resnet12's 12800 flat features"
SLICE10_FEATURES = {
    "Baseline": _CONV_FLAT + "; a linear head adapted 140 SGD steps an episode",
    "BaselinePlus": _CONV_FLAT + "; a cosine head adapted 140 SGD steps an episode",
    "NegNet": _RESNET_FLAT + "; a NegLayer adapted 140 SGD steps an episode",
    "RFSModel": _RESNET_FLAT + "; the L-BFGS probe (128 iterations) an episode",
    "SKDModel": _RESNET_FLAT + "; the L-BFGS probe, 4 flips x 128 in training",
    "MetabaselinePretrain": _RESNET_FLAT + "; cosine prototypes",
    "FEAT_Pretrain": _RESNET_FLAT + "; euclidean prototypes; NO shipped config",
    "DeepBDC_Pretrain": "resnet12Bdc's 2080 BDC features; BDC prototypes",
}
# one flat training epoch (7 steps of batch_size 128 over the 25 x 40 train
# clips) with 8 val and test episodes, 4 a step (at 16 a step the passes'
# 4496 segments would set the cell's peak memory, not the flat steps; 16
# episodes before the heads' cells of phase 25 were added, cut to keep the
# script inside its time limit)
FLAT_TRAIN_CUT = {"epoch": 1, "test_episode": 8}
# phases 20-22's eval cut (16 test episodes, one step of 16, WRN's 4 of 4)
# and their episodic training cells' (phase 13's with 8 val and test
# episodes, at most 8 a step), cut from RESNET_EVAL_CUT's 32 and
# HEAD_TRAIN_CUT's 16 when the
# heads' cells of phase 25 were added: the whole smoke read 995 s of its
# 1200 s on an H100 80GB HBM3 at 700 W, phases 20-22 386 s of it
LATE_EVAL_CUT = {"test_episode": 16, "test_epoch": 1}
LATE_TRAIN_CUT = {**HEAD_TRAIN_CUT, "test_episode": 8}
FLAT_EVAL_EPISODES = 4
# a flat train step's loss card vs CPU over the first rows of the first batch
# (NOT the shipped 128: a resnet12 forward of 128 rows takes seconds on the CPU)
FLAT_CHECK_ROWS = 32
# phase 20's flat training batch through resnet12Bdc's BDC pool
FLAT_SHAPE = (128, 64, 304)
# phase 25's DeepBDC_Pretrain flat batch of 128 over 2 ranks: each rank's
# shard through both BDC kernels
RANK_FLAT_SHAPE = (64, 64, 304)
# phase 21: the last pretrainers and RENet, with the features each reads
SLICE11_FEATURES = {
    "FRN_Pretrain": "resnet12's [640, 8, 9] map; 25 x 72 rows of cat_mat in training",
    "S2M2": _CONV_FLAT + "; mixup + 4 flips (640 rows a step); a cosine head adapted 140 "
            "SGD steps an episode",
    "MTLPretrain": _RESNET_FLAT + "; a linear learner from zero, 5 gradient steps; NO "
                   "shipped config",
    "MetabaselineKendallPretrain": _RESNET_FLAT + "; exact Kendall against the prototypes; "
                                   "NO shipped config",
}
RENET_FEATURES = "resnet12's [640, 8, 9] map; SCR 5 x 5 and CCA, one episode at a time"
# MTLPretrain's and MetabaselineKendallPretrain's eval: one step of 16 episodes
ONE_STEP_CUT = {"test_episode": 16, "test_epoch": 1}

# phase 22: the CNN backbones no shipped config names, each swapped into a
# shipped head's config at its JAX defaults (NOT shipped traffic), with the
# features each head reads; S2M2 trains on flat batches (phase 20's cell)
SLICE12_CELLS = {
    "DeepBDC:resnet18Bdc": "resnet18Bdc's 2080 BDC features of its [512, 8, 10] map: "
                           "bdc_pool at M = 80",
    "MCL:resnet12_mcl": "resnet12_mcl's [640, 8, 9] map",
    "R2D2:resnet12_r2d2": "resnet12_r2d2's 640 pooled features",
    "MTL:resnet12MTLofficial": "resnet12MTLofficial's 49280 flat features (NCHW); 100 inner "
                               "steps an episode",
    "ProtoNet:WRN": "WRN-28-10's 640 max-pooled features",
}
SLICE12_FLAT = {"S2M2:resnet18": "resnet18's 512 pooled features; mixup + 4 flips (640 rows a "
                                 "step); a cosine head adapted 140 SGD steps an episode"}
# the card-vs-CPU episodes of the heavy backbones take this many query
# segments (phase 22, and phases 15, 20 and 21's resnet12-family cells; 64
# before phases 23-24 were added): their float32 forwards on the host's CPU
# take 0.02 to 0.05 TFLOP a segment (WRN-28-10's ≈ 0.2, so fewer)
CPU_QUERIES = 16
WRN_CPU_QUERIES = 8
# resnet18Bdc's BDC pool: the [512, 8, 10] map of a [1, 128, 157] segment
M_RESNET18_BDC = 8 * 10
BDC18_TRAIN_SHAPE = (75, 64, M_RESNET18_BDC)

# phase 23: swin_t's training epoch traces steps 2-3 (``profile_start`` 2)
SWIN_PROFILE_STEPS = 2
# phase 24: the synthetic audio roots (5 classes x 16 clips: a 5-way 5-shot
# 10-query episode takes 15 a class), the extraction CLI's batch, and the
# clips of its float32 card-vs-CPU check
CLAP_CLASSES, CLAP_CLIPS = 5, 16
CLAP_CLI_BATCH = 8
CLAP_CPU_CLIPS = 8
# phase 25: the flagship over ranks, in float32 with TF32 off, so that 2
# ranks and 1 differ only in the order of their sums.  Training: 2 steps of
# 2 episodes (the shipped episode_size 1 does not split over 2 ranks), val
# and test 8 episodes, 4 a step (float32 activations of 16 episodes' ragged
# clips on two ranks that share the card ran out of its memory), SGD at lr
# 0.005 (Adam's first steps move each weight by about +-lr whatever its
# gradient's size, so a near-zero gradient's float32 rounding would show as
# a whole step).  Eval with the TTA: 8 test episodes, 2 a step (16 a step
# would embed 9600 augmented segments at once, 46 GiB for one float32
# activation, more than the H100's 80 GB had left; two ranks on one card
# ran out of it at 4 a step; phase 11 runs 8 a step in bf16)
PARALLEL_TRAIN_CUT = {"epoch": 1, "train_episode": 4, "test_episode": 8}
PARALLEL_EVAL_CUT = {"test_episode": 8, "test_epoch": 1, "test_episode_size": 2}
PARALLEL_RANKS = 2
# 2 ranks and 1 sum in other orders (the BatchNorm moments: two-pass over
# the ranks, ATen's kernel on one).  What does not compound is held
# tightly: the first step's loss and every parameter after the first step
# (|Δθ₁| against the 1-rank run's first update).  The float32 BDC gradient
# at random weights moves by 1-3 % of a tensor's scale with the order of
# the sums alone (one rank, either arithmetic, on the CPU: ROADMAP Queue C),
# and each later step compounds that (4 steps on an H100 80GB HBM3 at 700 W
# read a loss gap of 1.06e-3): the run stops after 2 steps, and the second
# step's loss and the parameters after both are held loosely.  The controls
# (``FAULTS``) must fail the tight limits
PARALLEL_FIRST_LOSS_RTOL = 1e-5
PARALLEL_FIRST_UPDATE_REL = 1e-2
PARALLEL_LOSS_RTOL = 2e-3
PARALLEL_UPDATE_REL = 5e-2
PARALLEL_THRESHOLD_RTOL = 1e-4
# the flagged clips of a TTA step: at most one swapped at the 20 % cut
PARALLEL_FLAG_SWAPS = 1
# a clip's vote may flip on a near tie when a convolution sees 8 episodes
# rather than 16: one clip of an episode's 50, at most, and 0.5 points on
# average over the episodes
PARALLEL_ACC_MAX, PARALLEL_ACC_MEAN = 2.0, 0.5
# phase 25's ProtoNet/Conv64F cell: the dry run's ``proto_train`` (the JAX
# package's mesh tests' cell, 3 SGD steps of 8 episodes, float32) at
# tests/test_torch_port_parallel.py's limits: the first loss rtol 1e-6, the
# others 2e-5, every parameter and statistic rtol 1e-3 / atol 5e-4, the
# eval logits rtol 1e-3 / atol 1e-2
PROTO_LIMITS = {"first_loss": 1e-6, "losses": 2e-5, "state": (1e-3, 5e-4),
                "logits": (1e-3, 1e-2)}
PARALLEL_TIMEOUT_S = 300
# phase 25's full-width flat cell: deepbdc_pretrain_5shot_iid_seed0
# (resnet12Bdc, planes 64/160/320/640, reduce_dim 64) trained 2 flat steps
# of the shipped batch_size 128 (64 rows a rank over 2 ranks) on a
# synthetic:25:15 root (375 train clips: 2 batches of 128; val and test
# need 15 clips a class for 5 shots and 10 queries), float32 with
# TF32 off, SGD at lr 0.005 (the flagship cell's, for its reasons), held
# at the flagship's limits; val and test 2 episodes each at the shipped
# episode_size 1, one a step, which 2 ranks run replicated; 2 more timed
# warm steps (``collective_times``)
PRETRAIN_ROOT = "synthetic:25:15"
PRETRAIN_CUT = {"epoch": 1, "test_episode": 2}
PRETRAIN_TIMED_STEPS = 2
# phase 25's full-width cells of the heads audited for ranks last, on the
# shipped Conv64F map (is_flatten and last_pool false), float32 with TF32
# off: adm_5shot_iid_seed0 trained 2 steps of 2 episodes (the shipped
# episode_size 1 cannot split over 2 ranks; ADM's head BatchNorm takes its
# moments over the whole step's query rows), val and test 4 episodes, 2 a
# step, SGD at lr 0.005 (the flagship cell's, for its reasons), 2 more timed
# warm steps, held at the flagship's limits and its eval logits at
# PROTO_LIMITS'; versa_5shot_iid_seed0 evaluated through Test (its trunk
# BatchNorm takes batch statistics in eval, over both ranks' real rows): 8
# test episodes, 4 a step (2 a rank), ragged queries at max_segments_per_clip
# 6 (the eval cells' cut), its logits at PROTO_LIMITS' and its accuracies at
# the flagship's
HEAD_RANKS_TRAIN_CUT = {"epoch": 1, "train_episode": 4, "test_episode": 4}
HEAD_RANKS_EVAL_CUT = {"test_episode": 8, "test_epoch": 1, "test_episode_size": 4}
HEAD_RANKS_TIMED_STEPS = 2

# the DropBlock counters at the end of a shipped 30 x 1000-episode run
RAMP_START = 30000
# Recorded, not measured by this script: the kernel's time before its redesign
# for Hopper, at the main-path shape (4496, 64, 304) on an NVIDIA H100 80GB
# HBM3 at 700 W.  Printed as context only, never in the `kernels` line.
BDC_POOL_MS_FIRST_DESIGN = 0.5667
L2_BYTES = 50 * 2 ** 20


def card_peaks(name: str):
    return PEAKS["H100 PCIe"] if "PCIe" in name else PEAKS["H100 SXM"]


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn`` from a CUDA graph of ``calls`` calls,
    replayed ``reps`` times: the card's time without the host's per-call
    work between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps=reps) / calls


def ptxas_report(log: str) -> tuple:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: the template
    arguments of ``bdc_pool_kernel<NB, TMA>`` (d padded to 16·NB; loads by
    tensor map or by 4-byte copies) or ``bdc_pool_backward_kernel<NB, TMA>``,
    registers, spills, shared memory.  Returns the lines and those among
    them that report a spill."""
    lines, spilled, name = [], [], None
    for line in log.splitlines():
        forward = re.search(r"bdc_pool_kernelILi(\d+)ELb([01])EE", line)
        backward = re.search(r"bdc_pool_backward_kernelILi(\d+)ELb([01])EE", line)
        if "Compiling entry function" in line and forward:
            name = f"d <= {16 * int(forward[1])}, {'tensor map' if forward[2] == '1' else 'scalar'} loads"
        elif "Compiling entry function" in line and backward:
            name = (f"backward, d <= {16 * int(backward[1])}, "
                    f"{'tensor map' if backward[2] == '1' else 'scalar'} loads")
        elif "spill" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", spills)):
                spilled.append(lines[-1])
            name = None
    return lines, spilled


def bdc_pool_smem_bytes(d: int) -> int:
    """Dynamic shared memory a ``bdc_pool`` launch asks for at this d (padded
    to Dp = 16·ceil(d/16)), as ``smem_bytes`` of the source lays it out: 1024
    bytes to align the ring, 3 stages of [Dp][64] floats, the gram
    [Dp][Dp + 8], the diagonal and the row means [Dp] each, 3 mbarriers."""
    dp = 16 * ((d + 15) // 16)
    return 1024 + 4 * (3 * dp * 64 + dp * (dp + 8) + 2 * dp) + 3 * 8


def rotating(xs):
    """Yield the buffers in turn, forever: no timed launch finds its input
    in the L2 cache that the launch before it filled."""
    i = 0
    while True:
        yield xs[i % len(xs)]
        i += 1


def adversarial_inputs(x, gen):
    """Inputs on which the rounding of the gram shows most: what the pool
    sees behind a ReLU, channel rows that (nearly) coincide, and a large
    scale."""
    import torch

    dup = x.clone()
    dup[:, 1] = dup[:, 0]
    dup[:, 3] = dup[:, 2] * (1.0 + 1e-4)
    dup[:, 5] = dup[:, 4] + 1e-3 * torch.randn(
        dup[:, 4].shape, device=x.device, generator=gen)
    dup[:, -1] = dup[:, 7]
    return {"post_relu": torch.relu(x - 0.5), "near_duplicate_rows": dup,
            "times_30": x * 30.0}


def bdc_bound_ms(b: int, d: int, m: int, peaks) -> tuple:
    """Least time for the fused BDC pool: the fp32 FLOPs of the gram's upper
    triangle, B·d(d+1)·M (the gram is symmetric and only the upper triangle
    is written; the epilogue's O(B·d²) is under 1 % at M = 304), against x
    read once and the upper triangle written once."""
    flops = 1.0 * b * d * (d + 1) * m
    nbytes = 4.0 * (b * d * m + 1 + b * d * (d + 1) // 2)
    t_ops = flops / peaks["fp32_flops"]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bdc_backward_bound_ms(b: int, d: int, m: int, peaks) -> tuple:
    """Least time for the BDC pool's backward: the fp32 FLOPs of the
    distances' upper triangle, B·d(d+1)·M, and of the [d, d] × [d, M]
    product, 2·B·d²·M, against x and the triu gradient read once and x̄ and
    the per-element log_t partials written once."""
    flops = 1.0 * b * d * (d + 1) * m + 2.0 * b * d * d * m
    nbytes = 4.0 * (2 * b * d * m + b * d * (d + 1) // 2 + 1 + b)
    t_ops = flops / peaks["fp32_flops"]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(ours, ref) -> float:
    """max |ours − ref| / max |ref|."""
    return ((ours.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def tta_cell() -> dict:
    """Phase 11's cell: the flagship's eval with the energy-OOD TTA, 32 test
    episodes, 8 a step, 10 augmentations of up to 6 segments a clip."""
    from audio_fewshot_tpu_torch.eval import slice_config

    cfg = slice_config(test_episode=32, test_epoch=1, test_episode_size=8)
    cfg.update(enhance_classification_via_energy=True, num_augmentations=10,
               tta_segments_per_clip=6)
    return cfg


def run_test(cfg):
    """``Test.test_loop`` on random weights from the config's seed: eval eps/s
    of each test epoch, ms a step at their mean, peak GiB, accuracy and the
    BDC kernels' launches (counts reset just before)."""
    import torch

    from audio_fewshot_tpu_torch.eval import Test
    from audio_fewshot_tpu_torch.models import build_method
    from audio_fewshot_tpu_torch.ops import bdc_cuda
    from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    with tempfile.TemporaryDirectory() as result_path:
        init_seed(int(cfg["seed"]))
        save_model_best(result_path, build_method(cfg))
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        test = Test(0, cfg, result_path, device="cuda")
        acc, _ = test.test_loop()
        torch.cuda.synchronize()
        launches = (bdc_cuda.launches, bdc_cuda.backward_launches)
    eps = test.epoch_eps
    return (eps, 1e3 * cfg["test_episode_size"] * len(eps) / sum(eps),
            torch.cuda.max_memory_allocated() / 2 ** 30, acc, launches)


def run_trainer(cfg, diverges=False):
    """``Trainer.train_loop``: its history (with each epoch's episode count),
    peak GiB and the BDC kernels' launches (counts reset just before).
    Fails on a non-finite loss or accuracy; with ``diverges`` (a config the
    JAX package's own trainer drives to NaN) on a non-finite first loss or
    accuracy only."""
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.ops import bdc_cuda

    torch.cuda.reset_peak_memory_stats()
    bdc_cuda.launches = bdc_cuda.backward_launches = 0
    trainer = train.Trainer(0, cfg, device="cuda")
    trainer.train_loop()
    torch.cuda.synchronize()
    launches = (bdc_cuda.launches, bdc_cuda.backward_launches)
    rows = [dict(r, train_eps_count=len(r["train_losses"])) for r in trainer.history]
    losses = [v for r in rows for v in r["train_losses"]]
    values = (losses[:1] if diverges else losses) + [
        r[k] for r in rows for k in ("val_acc", "test_acc")]
    if not rows or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{cfg['classifier']['name']} training: non-finite loss or accuracy")
    return rows, torch.cuda.max_memory_allocated() / 2 ** 30, launches


def hand_noise(method) -> None:
    """A head that samples (LEO, VERSA) draws from a CPU generator of its
    own, seeded 0, moved to the model's device: the same model on the card
    and on the CPU then samples the same noise."""
    import torch

    if hasattr(method, "noise"):
        gen = torch.Generator().manual_seed(0)
        method.noise.draw = lambda shape, like: torch.randn(shape, generator=gen).to(
            like.device, like.dtype)


def first_episode(cfg, g):
    """Episode 0 of the config's test loader and its first ``g`` query
    segments, on the host."""
    from audio_fewshot_tpu_torch.data import get_dataloader
    from audio_fewshot_tpu_torch.episode import EpisodeBatch

    full = next(iter(get_dataloader(cfg, "test")[0].epoch(0)))
    return EpisodeBatch(
        support=full.support[:1], query=full.query[:1, :g], query_clip=full.query_clip[:1, :g],
        query_mask=full.query_mask[:1, :g], support_target=full.support_target[:1],
        query_target=full.query_target[:1])


def float64_head_card_vs_cpu(cfg, g):
    """The head alone in float64 on the card and on the CPU over the same
    features (the CPU backbone's, float32): max|Δ|/max|logit|."""
    import torch

    from audio_fewshot_tpu_torch.models import build_method, eval_setting
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    init_seed(int(cfg["seed"]), cfg.get("deterministic"))  # cuDNN as the config says
    method_cpu = build_method(cfg).eval()
    batch = first_episode(cfg, g).to("cpu")
    with torch.no_grad():
        feats = method_cpu.embed(batch)
    method_gpu = copy.deepcopy(method_cpu).to("cuda")
    logits = []
    for method, device in ((method_gpu, "cuda"), (method_cpu, "cpu")):
        method.double().embed = lambda b, d=device: tuple(f.double().to(d) for f in feats)
        with torch.no_grad():
            logits.append(method(batch.to(device), eval_setting(cfg)).cpu())
    return rel_err(*logits)


def card_vs_cpu(cfg, g, prepare=None):
    """One float32 episode (episode 0 and its first ``g`` query segments):
    segment logits of the same model on the card and on the CPU, as
    max|Δ|/max|logit|, the argmax agreement and the logits' shape.
    ``prepare`` edits the CPU model before it is copied to the card; a
    sampling head gets the same noise on both (``hand_noise``)."""
    import torch

    from audio_fewshot_tpu_torch.models import build_method, eval_setting
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    init_seed(int(cfg["seed"]), cfg.get("deterministic"))  # cuDNN as the config says
    method_cpu = build_method(cfg).eval()
    if prepare is not None:
        prepare(method_cpu)
    method_gpu = copy.deepcopy(method_cpu).to("cuda")
    hand_noise(method_cpu)
    hand_noise(method_gpu)
    batch = first_episode(cfg, g)
    with torch.no_grad():
        on_gpu = method_gpu(batch.to("cuda"), eval_setting(cfg)).cpu()
        on_cpu = method_cpu(batch.to("cpu"), eval_setting(cfg))
    if not torch.isfinite(on_gpu).all():
        raise AssertionError(f"{cfg['classifier']['name']}: non-finite logits on the card")
    rel = ((on_gpu - on_cpu).abs().max() / on_cpu.abs().max()).item()
    return rel, (on_gpu.argmax(-1) == on_cpu.argmax(-1)).float().mean().item(), tuple(on_gpu.shape)


def metric_and_bpa_phases(ecfg, expected: int, g: int) -> None:
    """Phases 12-14: the Conv64F metric heads' evaluation and training, and
    BPA (ProtoNet eval; DeepBDC's TTA re-vote at phase 11's cell ``ecfg``,
    whose ``bdc_pool`` launches must be phase 11's ``expected``).  ``g``: the
    query segments of a card-vs-CPU episode."""
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.data import get_dataloader
    from audio_fewshot_tpu_torch.eval import Test, slice_config
    from audio_fewshot_tpu_torch.models import build_method
    from audio_fewshot_tpu_torch.models.heads import proto_net as proto_module
    from audio_fewshot_tpu_torch.ops import bdc_cuda
    from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    # -- 12. the Conv64F metric heads: evaluation ----------------------------------
    torch.backends.cudnn.allow_tf32 = True  # the bf16 runs' own defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    for head in METRIC_HEADS:
        hcfg = slice_config(classifier=head, **EVAL_CUT)
        eps, ms, peak_gib, acc, bdc_launches = run_test(hcfg)
        print(f"[metric-eval] {hcfg['tag']} at full width (Conv64F [64, 4, 5] map), bf16, "
              f"{hcfg['test_episode_size']} episodes a step, {hcfg['test_epoch']} epochs of "
              f"{hcfg['test_episode']} test episodes: accuracy {acc:.3f}, eval eps/s by epoch "
              f"{[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak memory "
              f"{peak_gib:.2f} GiB, BDC launches {bdc_launches} (expected 0)")
        if not math.isfinite(acc) or any(bdc_launches):
            raise AssertionError(f"{head} eval: accuracy {acc}, BDC launches {bdc_launches}")
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        rel, agree, shape = card_vs_cpu(slice_config(classifier=head, precision="fp32"), g)
        print(f"[metric-eval] {head} fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
              f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement {agree:.4f}")
        if not rel <= LOGIT_REL_LIMIT:
            raise AssertionError(f"float32 {head} card logits disagree with the CPU")
        torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    print(flush=True)

    # -- 13. the Conv64F metric heads: training ------------------------------------
    for head in METRIC_HEADS:
        with tempfile.TemporaryDirectory() as result_root:
            hcfg = train.slice_config(result_root, classifier=head, **HEAD_TRAIN_CUT)
            rows, peak_gib, bdc_launches = run_trainer(hcfg)
        for r in rows:
            print(f"[metric-train] {hcfg['tag']} at full width, bf16, augment on, epoch "
                  f"{r['epoch']} of {r['train_eps_count']} episodes: {r['train_eps']:.2f} train "
                  f"eps/s, step {r['step_ms']:.1f} ms, loss {r['train_losses'][0]:.4f} -> "
                  f"{r['train_losses'][-1]:.4f}, val acc {r['val_acc']:.3f}, test acc "
                  f"{r['test_acc']:.3f}; peak memory {peak_gib:.2f} GiB; BDC launches "
                  f"{bdc_launches} (expected 0)")
        if any(bdc_launches):
            raise AssertionError(f"{head} training: BDC launches {bdc_launches}")
    torch.cuda.empty_cache()
    # RelationNet: its shipped geometry fails (as in the JAX package); the
    # way out its error names, maxpool_last2: false, is run as such
    try:
        Test(0, slice_config(classifier="RelationNet"), None, device="cuda")
    except ValueError as err:
        print(f"[relationnet] the shipped relationnet_5shot_iid_seed0 raises on the card, as "
              f"intended: {err}")
    else:
        raise AssertionError("RelationNet built at the shipped geometry")
    rcfg32 = slice_config(classifier="RelationNet", precision="fp32")
    rcfg32["backbone"]["kwargs"]["maxpool_last2"] = False
    torch.backends.cudnn.allow_tf32 = False
    rel, agree, shape = card_vs_cpu(rcfg32, g)
    print(f"[relationnet] NOT the shipped geometry (maxpool_last2: false, a [64, 14, 17] map): "
          f"fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| {rel:.3e} (limit "
          f"{LOGIT_REL_LIMIT:g}), argmax agreement {agree:.4f}")
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError("float32 RelationNet card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as result_root:
        hcfg = train.slice_config(result_root, classifier="RelationNet", **HEAD_TRAIN_CUT)
        hcfg["backbone"]["kwargs"]["maxpool_last2"] = False
        rows, peak_gib, bdc_launches = run_trainer(hcfg)
    for r in rows:
        print(f"[relationnet] NOT the shipped geometry (maxpool_last2: false), bf16, epoch "
              f"{r['epoch']} of {r['train_eps_count']} episodes: {r['train_eps']:.2f} train eps/s, "
              f"step {r['step_ms']:.1f} ms, loss {r['train_losses'][0]:.4f} -> "
              f"{r['train_losses'][-1]:.4f}, val acc {r['val_acc']:.3f}, test acc "
              f"{r['test_acc']:.3f}; peak memory {peak_gib:.2f} GiB; BDC launches {bdc_launches}")
    if any(bdc_launches):
        raise AssertionError(f"RelationNet training: BDC launches {bdc_launches}")
    torch.cuda.empty_cache()
    print(flush=True)

    # -- 14. BPA: ProtoNet eval, and DeepBDC's TTA re-vote -------------------------
    bcfg = slice_config(classifier="ProtoNet", **EVAL_CUT)
    bcfg["classifier"]["kwargs"] = {"use_bpa": True}
    rows_seen = set()
    apply_bpa = proto_module.apply_bpa

    def bpa_spy(sup, qry, query_mask=None):
        rows_seen.add(sup.shape[1] + qry.shape[1])
        return apply_bpa(sup, qry, query_mask)

    proto_module.apply_bpa = bpa_spy
    try:
        eps, ms, peak_gib, acc, bdc_launches = run_test(bcfg)
    finally:
        proto_module.apply_bpa = apply_bpa
    n_rows = {b.support.shape[1] + b.query.shape[1]
              for e in range(bcfg["test_epoch"]) for b in get_dataloader(bcfg, "test")[0].epoch(e)}
    print(f"[bpa] proto_5shot_iid_seed0 with use_bpa at full width, bf16, "
          f"{bcfg['test_episode_size']} episodes a step, {bcfg['test_epoch']} epochs of "
          f"{bcfg['test_episode']} test episodes: accuracy {acc:.3f}, eval eps/s by epoch "
          f"{[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak memory {peak_gib:.2f} GiB; "
          f"transport over {sorted(rows_seen)}-row sets (expected {sorted(n_rows)}: 25 "
          f"support + the query bucket of each step); BDC launches {bdc_launches} (expected 0)")
    if rows_seen != n_rows or not math.isfinite(acc) or any(bdc_launches):
        raise AssertionError(f"ProtoNet BPA eval: rows {rows_seen}, accuracy {acc}, "
                             f"BDC launches {bdc_launches}")
    torch.backends.cudnn.allow_tf32 = False
    bcfg32 = slice_config(classifier="ProtoNet", precision="fp32")
    bcfg32["classifier"]["kwargs"] = {"use_bpa": True}
    rel, agree, shape = card_vs_cpu(bcfg32, g)
    print(f"[bpa] ProtoNet with use_bpa fp32 segment logits {shape}: card vs CPU "
          f"max|Δ|/max|logit| {rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement {agree:.4f}")
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError("float32 ProtoNet BPA card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    bpa_tta = copy.deepcopy(ecfg)
    bpa_tta["classifier"]["kwargs"] = {"use_bpa": True}
    with tempfile.TemporaryDirectory() as result_path:
        init_seed(int(bpa_tta["seed"]))
        save_model_best(result_path, build_method(bpa_tta))
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        t0 = time.time()
        test = Test(0, bpa_tta, result_path, device="cuda")
        acc, ci = test.test_loop()
        torch.cuda.synchronize()
        wall = time.time() - t0
        bpa_launches = bdc_cuda.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[bpa] deepbdc_5shot_iid_seed0 with use_bpa and the TTA re-vote, phase 11's cut: "
          f"accuracy {acc:.3f} ± {ci:.3f}, threshold {test.method.uncertain_global_threshold}, "
          f"TTA eps/s {[round(r, 2) for r in test.epoch_eps]}, "
          f"{1e3 * bpa_tta['test_episode_size'] / test.epoch_eps[0]:.1f} ms a step, peak memory "
          f"{peak_gib:.2f} GiB, {wall:.1f} s wall; bdc_pool launches {bpa_launches} (expected "
          f"{expected}, phase 11's count)")
    if not (math.isfinite(acc) and 0.0 <= acc <= 100.0 and bpa_launches == expected):
        raise AssertionError(f"DeepBDC BPA TTA: accuracy {acc}, bdc_pool launches "
                             f"{bpa_launches}, expected {expected}")
    del test
    torch.cuda.empty_cache()
    print(flush=True)


def dropblock_shares(method):
    """Forward hooks on the backbone's DropBlock modules: each call adds the
    share of its input's nonzero elements that it zeroed (a tensor on the
    card, read after the run).  Returns {block: [shares]} and the hooks."""
    shares, hooks = {}, []
    for i in (3, 4):
        drop = getattr(method.emb_func, f"layer{i}")[0].drop
        shares[i] = []

        def hook(mod, args, out, i=i):
            if mod.training:
                live = args[0] != 0
                shares[i].append(((out == 0) & live).sum() / live.sum())

        hooks.append(drop.register_forward_hook(hook))
    return shares, hooks


def resnet12_phases(g: int) -> None:
    """Phases 15-16: the six resnet12 heads' evaluation and training, the
    DropBlock ramp started mid-run, and its resume.  ``g``: the query
    segments of a card-vs-CPU episode."""
    import torch

    from audio_fewshot_tpu_torch import run_trainer_resume, train
    from audio_fewshot_tpu_torch.eval import slice_config
    from audio_fewshot_tpu_torch.ops import bdc_cuda

    # -- 15. the resnet12 heads: evaluation ----------------------------------------------------
    t_phase = time.time()
    torch.backends.cudnn.allow_tf32 = True  # the bf16 runs' own defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    for head in RESNET12_EVAL_HEADS:
        t0 = time.time()
        hcfg = slice_config(classifier=head, **RESNET_EVAL_CUT)
        eps, ms, peak_gib, acc, bdc_launches = run_test(hcfg)
        print(f"[resnet12-eval] {hcfg['tag']} at full width ({RESNET12_MAPS[head]}), bf16 "
              f"backbone, fp32 head, {hcfg['test_episode_size']} episodes a step, "
              f"{hcfg['test_epoch']} epochs of {hcfg['test_episode']} test episodes: "
              f"accuracy {acc:.3f}, eval eps/s by epoch {[round(r, 2) for r in eps]}, "
              f"{ms:.1f} ms a step, peak memory {peak_gib:.2f} GiB, BDC launches "
              f"{bdc_launches} (expected 0)")
        if not math.isfinite(acc) or any(bdc_launches):
            raise AssertionError(f"{head} eval: accuracy {acc}, BDC launches {bdc_launches}")
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        rel, agree, shape = card_vs_cpu(slice_config(classifier=head, precision="fp32"),
                                        CPU_QUERIES)
        print(f"[resnet12-eval] {head} fp32 segment logits {shape}: card vs CPU "
              f"max|Δ|/max|logit| {rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement "
              f"{agree:.4f}; {time.time() - t0:.1f} s for the head")
        if not rel <= LOGIT_REL_LIMIT:
            raise AssertionError(f"float32 {head} card logits disagree with the CPU")
        torch.backends.cudnn.allow_tf32 = True
        torch.cuda.empty_cache()
    print(f"[resnet12-eval] phase 15 wall {time.time() - t_phase:.1f} s", flush=True)
    print(flush=True)

    # -- 16. the resnet12 heads: training; the ramp mid-run and its resume ----------------------
    t_phase = time.time()
    peaks = {}
    for head in RESNET12_HEADS:
        with tempfile.TemporaryDirectory() as result_root:
            hcfg = train.slice_config(result_root, classifier=head, **HEAD_TRAIN_CUT)
            rows, peaks[head], bdc_launches = run_trainer(hcfg)
        beside = (f" (MetaBaseline's {peaks['MetaBaseline']:.2f} GiB; limit + "
                  f"{KENDALL_PEAK_MARGIN_GIB} GiB)" if head == "MetaBaselineKendall" else "")
        for r in rows:
            print(f"[resnet12-train] {hcfg['tag']} at full width, bf16, augment on, drop_rate "
                  f"0.1, epoch {r['epoch']} of {r['train_eps_count']} episodes: "
                  f"{r['train_eps']:.2f} train eps/s, step {r['step_ms']:.1f} ms, loss "
                  f"{r['train_losses'][0]:.4f} -> {r['train_losses'][-1]:.4f}, val acc "
                  f"{r['val_acc']:.3f}, test acc {r['test_acc']:.3f}; peak memory "
                  f"{peaks[head]:.2f} GiB{beside}; BDC launches {bdc_launches} (expected 0)")
        if any(bdc_launches):
            raise AssertionError(f"{head} training: BDC launches {bdc_launches}")
        torch.cuda.empty_cache()
    if peaks["MetaBaselineKendall"] > peaks["MetaBaseline"] + KENDALL_PEAK_MARGIN_GIB:
        raise AssertionError("MetaBaselineKendall's training keeps its pair activations: "
                             f"peak {peaks['MetaBaselineKendall']:.2f} GiB")
    # the ramp: one MetaBaseline epoch from the counters at 30000 (the end of
    # a shipped 30 x 1000-episode run), then one more through resume
    with tempfile.TemporaryDirectory() as result_root:
        hcfg = train.slice_config(result_root, classifier="MetaBaseline", **HEAD_TRAIN_CUT)
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        trainer = train.Trainer(0, hcfg, device="cuda")
        blocks = [getattr(trainer.method.emb_func, f"layer{i}")[0] for i in (3, 4)]
        for block in blocks:
            block.num_batches_tracked.fill_(RAMP_START)
        shares, hooks = dropblock_shares(trainer.method)
        trainer.train_loop()
        for hook in hooks:
            hook.remove()
        steps = sum(len(r["train_losses"]) for r in trainer.history)
        counts = [int(b.num_batches_tracked) for b in blocks]
        for i, block in zip((3, 4), blocks):
            measured = torch.stack(shares[i]).mean().item()
            keep = max(1.0 - block.drop_rate / block.drop_schedule_steps * counts[i - 3],
                       1.0 - block.drop_rate)
            print(f"[ramp] STARTED MID-RAMP (counters set to {RAMP_START} before the epoch, "
                  f"not a run from 0): layer{i} DropBlock dropped {measured:.4f} of its "
                  f"nonzero inputs a step over {len(shares[i])} train steps, expected about "
                  f"1 - keep = {1 - keep:.4f} (keep = max(1 - {block.drop_rate}/"
                  f"{block.drop_schedule_steps} x count, {1 - block.drop_rate}) at "
                  f"count {counts[i - 3]})")
            if not 0.5 * (1 - keep) <= measured <= 1.5 * (1 - keep):
                raise AssertionError(f"layer{i} DropBlock dropped {measured}, expected about "
                                     f"{1 - keep}")
        if counts != [RAMP_START + steps] * 2:
            raise AssertionError(f"the counters read {counts} after {steps} steps from "
                                 f"{RAMP_START}")
        resumed = run_trainer_resume.build_trainer(
            [trainer.result_dir, "--device", "cuda", "--epoch", str(hcfg["epoch"] + 1)])
        carried = [int(getattr(resumed.method.emb_func, f"layer{i}")[0].num_batches_tracked)
                   for i in (3, 4)]
        resumed.train_loop()
        after = [int(getattr(resumed.method.emb_func, f"layer{i}")[0].num_batches_tracked)
                 for i in (3, 4)]
        more = sum(len(r["train_losses"]) for r in resumed.history)
        print(f"[ramp] resumed at epoch {resumed.start_epoch}: the counters read {carried} "
              f"from the checkpoint (saved {counts}), {after} after {more} more steps; BDC "
              f"launches {(bdc_cuda.launches, bdc_cuda.backward_launches)} (expected 0)")
        if carried != counts or after != [c + more for c in counts] or (
                bdc_cuda.launches or bdc_cuda.backward_launches):
            raise AssertionError(f"resume: counters {carried} -> {after}, saved {counts}")
        del trainer, resumed
    torch.cuda.empty_cache()
    print(f"[resnet12-train] phase 16 wall {time.time() - t_phase:.1f} s", flush=True)
    print(flush=True)


def eval_and_train(head: str, label: str, what: str, g: int, card_cfg=None) -> None:
    """One head's eval cell through ``Test`` at ``EVAL_CUT`` (BDC launches
    0), one float32 episode card vs CPU (of ``card_cfg``'s model where it
    is given, else the shipped one's), one training epoch at
    ``HEAD_TRAIN_CUT`` (BDC launches 0; finite losses, but from the second
    step for a head of ``DIVERGES``).  ``what``: the model, for the log."""
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.eval import slice_config

    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = True  # the bf16 runs' own defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    hcfg = slice_config(classifier=head, **EVAL_CUT)
    eps, ms, peak_gib, acc, bdc_launches = run_test(hcfg)
    print(f"[{label}-eval] {hcfg['tag']} at full width ({what}), bf16 backbone, fp32 head, "
          f"{hcfg['test_episode_size']} episodes a step, {hcfg['test_epoch']} epochs of "
          f"{hcfg['test_episode']} test episodes: accuracy {acc:.3f}, eval eps/s by epoch "
          f"{[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak memory {peak_gib:.2f} GiB, "
          f"BDC launches {bdc_launches} (expected 0)", flush=True)
    if not math.isfinite(acc) or any(bdc_launches):
        raise AssertionError(f"{head} eval: accuracy {acc}, BDC launches {bdc_launches}")
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    rel, agree, shape = card_vs_cpu(
        card_cfg or slice_config(classifier=head, precision="fp32"), g)
    print(f"[{label}-eval] {head}{' (' + card_cfg['tag'] + ')' if card_cfg else ''} fp32 "
          f"segment logits {shape}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}; cuDNN's deterministic algorithms), argmax "
          f"agreement {agree:.4f}")
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError(f"float32 {head} card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as result_root:
        hcfg = train.slice_config(result_root, classifier=head, **HEAD_TRAIN_CUT)
        rows, peak_gib, bdc_launches = run_trainer(hcfg, diverges=head in DIVERGES)
    if head in DIVERGES:
        losses = [v for r in rows for v in r["train_losses"]]
        finite = next((i for i, v in enumerate(losses) if not math.isfinite(v)), len(losses))
        print(f"[{label}-train] {head}: {finite} of {len(losses)} steps' losses finite "
              f"({[round(v, 3) for v in losses[:finite]]}); {DIVERGES[head]}")
    for r in rows:
        print(f"[{label}-train] {hcfg['tag']} at full width, bf16, augment on, "
              f"{hcfg.get('episode_size', 1)} episode(s) a step, epoch {r['epoch']} of "
              f"{r['train_eps_count']} steps: {r['train_eps']:.2f} train eps/s, step "
              f"{r['step_ms']:.1f} ms, loss {r['train_losses'][0]:.4f} -> "
              f"{r['train_losses'][-1]:.4f}, val acc {r['val_acc']:.3f}, test acc "
              f"{r['test_acc']:.3f}; peak memory {peak_gib:.2f} GiB; BDC launches "
              f"{bdc_launches} (expected 0)")
    if any(bdc_launches):
        raise AssertionError(f"{head} training: BDC launches {bdc_launches}")
    torch.cuda.empty_cache()
    print(f"[{label}] {head}: {time.time() - t0:.1f} s", flush=True)


def adaptation_check(head: str) -> None:
    """On the card, as ``Test`` holds the method (eval mode, no parameter
    needing grad, ``no_grad``): the adapted logits of two float32 episodes
    against the unadapted ones (MAML, ANIL: ``test_iter`` steps against 0;
    BOIL: its one step against none, and NIL finite), and no ``.grad``
    written."""
    import torch

    from audio_fewshot_tpu_torch.data import get_dataloader
    from audio_fewshot_tpu_torch.eval import slice_config
    from audio_fewshot_tpu_torch.models import build_method, eval_setting
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = slice_config(classifier=head, precision="fp32")
    init_seed(int(cfg["seed"]))
    method = build_method(cfg).to("cuda").eval().requires_grad_(False)
    setting = eval_setting(cfg)
    full = next(iter(get_dataloader(cfg, "test")[0].epoch(0)))
    batch = full.replace(**{k: getattr(full, k)[:2] for k in (
        "support", "query", "query_clip", "query_mask", "support_target",
        "query_target")}, global_target=None).to("cuda")
    steps = 1 if head == "BOIL" else method.test_iter
    with torch.no_grad():
        adapted = method._run(batch, setting, steps)
        unadapted = method._run(batch, setting, 0)
        nil = method(batch, setting) if head == "BOIL" else adapted
    moved = rel_err(adapted, unadapted)
    grads = [n for n, p in method.named_parameters() if p.grad is not None]
    print(f"[meta-adapt] {head} under no_grad (eval mode, no parameter needing grad): "
          f"{steps} inner step(s) moved the logits {tuple(adapted.shape)} by "
          f"max|Δ|/max|logit| {moved:.3e} from the unadapted ones (must exceed "
          f"{ADAPT_MIN_REL:g}); parameters holding a .grad: {len(grads)} (expected 0)"
          + ("; NIL logits finite" if head == "BOIL" else ""))
    if not (moved > ADAPT_MIN_REL and torch.isfinite(adapted).all()
            and torch.isfinite(nil).all()) or grads:
        raise AssertionError(f"{head}: the eval step did not adapt ({moved}) or wrote grads")
    torch.backends.cudnn.allow_tf32 = True


def vit_and_meta_phases(g: int) -> None:
    """Phases 17-18: CPEANet on vit_tiny; R2D2, MAML, ANIL and BOIL on
    Conv64F, the MAML family's adaptation under ``no_grad``, and R2D2MCL.
    ``g``: the query segments of a card-vs-CPU episode."""
    import torch

    from audio_fewshot_tpu_torch.eval import slice_config

    # -- 17. CPEANet on vit_tiny -----------------------------------------------------------
    t_phase = time.time()
    eval_and_train("CPEANet", "cpea", "vit_tiny: 73 tokens of 192, 12 blocks; CPEA over "
                   "72 x 72 patch similarities", g)
    print(f"[cpea] phase 17 wall {time.time() - t_phase:.1f} s", flush=True)
    print(flush=True)

    # -- 18. R2D2 and the MAML family on Conv64F ------------------------------------------
    t_phase = time.time()
    for head in META_HEADS:
        eval_and_train(head, "meta", "Conv64F's 1600 flat features", g)
        if head != "R2D2":
            adaptation_check(head)
    mcfg = slice_config(classifier="MCL", precision="fp32")
    mcfg["classifier"] = {"name": "R2D2MCL", "kwargs": None}
    torch.backends.cudnn.allow_tf32 = False
    rel, agree, shape = card_vs_cpu(mcfg, g)
    print(f"[meta] R2D2MCL, NO shipped config (its JAX defaults: katz 0.5, gamma 20, gamma2 "
          f"10, on MCL's Conv64F [64, 4, 5] map): fp32 segment logits {shape}: card vs CPU "
          f"max|Δ|/max|logit| {rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement "
          f"{agree:.4f}")
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError("float32 R2D2MCL card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    print(f"[meta] phase 18 wall {time.time() - t_phase:.1f} s", flush=True)
    print(flush=True)


def gates_off_identity(method) -> None:
    """MeTAL's per-step adapters away from the identity: every step's
    multiplier and offset gates drawn N(0, 0.5²) from seed 0."""
    import torch

    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for adapter in (method.meta_loss_adapter, method.meta_query_loss_adapter):
            for step in adapter.loss_adapter:
                for gate in (step.multiplier_bias, step.offset_bias):
                    gate.copy_(0.5 * torch.randn(gate.shape, generator=gen))


def slice9_phase(g: int) -> None:
    """Phase 19: MeTAL, MTL, LEO, VERSA and DMatchingNet, each its shipped
    config through ``eval_and_train``; MeTAL's per-step path (no shipped
    config, its adapters off identity) and DMatchingNet's ``single`` branch
    card vs CPU.  ``g``: the query segments of a card-vs-CPU episode."""
    import torch

    from audio_fewshot_tpu_torch.eval import slice_config

    t_phase = time.time()
    for head in SLICE9_HEADS:
        card_cfg = None
        if head == "MTL":
            card_cfg = slice_config(classifier=head, precision="fp32")
            card_cfg["classifier"]["kwargs"]["inner_param"]["iter"] = MTL_CARD_ITER
            card_cfg["tag"] += f" at iter {MTL_CARD_ITER}, NOT the shipped 100"
        eval_and_train(head, "slice9", SLICE9_FEATURES[head], g, card_cfg)
        if head == "MTL":
            torch.backends.cudnn.allow_tf32 = False
            rel = float64_head_card_vs_cpu(slice_config(classifier=head, precision="fp32"), g)
            print(f"[slice9-eval] MTL's shipped 100 inner steps, the head in float64 over the "
                  f"CPU backbone's features: card vs CPU max|Δ|/max|logit| {rel:.3e} (limit "
                  f"{LOGIT_REL_LIMIT:g}; in float32 the 100 steps at lr 0.01 over features of "
                  f"norm ≈ 230 are chaotic)", flush=True)
            torch.backends.cudnn.allow_tf32 = True
            if not rel <= LOGIT_REL_LIMIT:
                raise AssertionError("MTL's float64 head disagrees on the card and the CPU")
    extra = []
    pcfg = slice_config(classifier="MeTAL", precision="fp32")
    pcfg["classifier"]["kwargs"]["inner_param"]["per_step_adapters"] = True
    extra.append(("MeTAL with per_step_adapters (NO shipped config; adapters off identity)",
                  pcfg, gates_off_identity))
    scfg = slice_config(classifier="DMatchingNet", precision="fp32")
    scfg["classifier"]["kwargs"]["ifsl_param"]["single"] = True
    extra.append(("DMatchingNet with single: true (NOT the shipped branch)", scfg, None))
    torch.backends.cudnn.allow_tf32 = False
    for label, cfg, prepare in extra:
        rel, agree, shape = card_vs_cpu(cfg, g, prepare)
        print(f"[slice9] {label}: fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
              f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement {agree:.4f}")
        if not rel <= LOGIT_REL_LIMIT:
            raise AssertionError(f"float32 {label} card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    print(f"[slice9] phase 19 wall {time.time() - t_phase:.1f} s", flush=True)
    print(flush=True)


def loss_card_vs_cpu(cfg, batch) -> tuple:
    """One train step's loss of the same float32 model of ``cfg`` (dropout
    and DropBlock off, NOT the shipped rate) on the card and on the CPU over
    the host ``batch``: (card loss, CPU loss, |Δ| / |CPU loss|)."""
    import torch

    from audio_fewshot_tpu_torch.models import build_method, train_setting
    from audio_fewshot_tpu_torch.models.backbones.layers import Dropout
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    from audio_fewshot_tpu_torch.registry import BACKBONES

    cfg = copy.deepcopy(cfg)
    if "drop_rate" in inspect.signature(BACKBONES.get(cfg["backbone"]["name"])).parameters:
        cfg["backbone"]["kwargs"]["drop_rate"] = 0.0
    init_seed(int(cfg["seed"]), cfg.get("deterministic"))  # cuDNN as the config says
    method_cpu = build_method(cfg).train()
    for module in method_cpu.modules():
        if isinstance(module, Dropout):
            module.rate = 0.0
    method_gpu = copy.deepcopy(method_cpu).to("cuda")
    setting = train_setting(cfg)
    with torch.no_grad():
        on_gpu = method_gpu.loss(batch.to("cuda"), setting)[0].item()
        on_cpu = method_cpu.loss(batch.to("cpu"), setting)[0].item()
    return on_gpu, on_cpu, abs(on_gpu - on_cpu) / abs(on_cpu)


def flat_loss_card_vs_cpu(head: str) -> tuple:
    """``loss_card_vs_cpu`` of the head's float32 eval cell over the first
    ``FLAT_CHECK_ROWS`` rows of the first batch of its train loader."""
    from audio_fewshot_tpu_torch.data import get_dataloader
    from audio_fewshot_tpu_torch.episode import FlatBatch
    from audio_fewshot_tpu_torch.eval import slice_config
    from audio_fewshot_tpu_torch.models.base import ModelType

    cfg = slice_config(classifier=head, precision="fp32")
    batch = next(iter(get_dataloader(cfg, "train", ModelType.FINETUNING)[0].epoch(0)))
    batch = FlatBatch(data=batch.data[:FLAT_CHECK_ROWS], target=batch.target[:FLAT_CHECK_ROWS])
    return loss_card_vs_cpu(cfg, batch)


def slice10_cell(head: str, g: int, label: str = "slice10", what: str = None) -> tuple:
    """Phase 20's cells of one head (phase 21's for FRN_Pretrain and S2M2,
    ``label`` their log's tag and ``what`` the features they read): eval
    through ``Test``, one float32 episode card vs CPU, one flat training
    epoch, one flat train step's loss card vs CPU.  Returns the BDC launches
    of its eval and of its training (each counted from 0) and the steps
    behind them: ((eval forward, eval backward, eval backbone calls), (train
    forward, train backward, train steps, val and test steps))."""
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.eval import SLICE_MODELS, slice_config

    t0 = time.time()
    conv = SLICE_MODELS[head]["backbone"]["name"] == "Conv64F"
    torch.backends.cudnn.allow_tf32 = True  # the bf16 runs' own defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    hcfg = slice_config(classifier=head, **(EVAL_CUT if conv else LATE_EVAL_CUT))
    eps, ms, peak_gib, acc, eval_launches = run_test(hcfg)
    eval_calls = hcfg["test_epoch"] * hcfg["test_episode"] // hcfg["test_episode_size"] + 1
    print(f"[{label}-eval] {hcfg['tag']} at full width ({what or SLICE10_FEATURES[head]}), bf16 "
          f"backbone, fp32 head, {hcfg['test_episode_size']} episodes a step, "
          f"{hcfg['test_epoch']} epoch(s) of {hcfg['test_episode']} test episodes: accuracy "
          f"{acc:.3f}, eval eps/s by epoch {[round(r, 2) for r in eps]}, {ms:.1f} ms a step, "
          f"peak memory {peak_gib:.2f} GiB, BDC launches {eval_launches} (backbone calls "
          f"{eval_calls})", flush=True)
    if not math.isfinite(acc):
        raise AssertionError(f"{head} eval: accuracy {acc}")
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    rel, agree, shape = card_vs_cpu(slice_config(classifier=head, precision="fp32"),
                                    g if conv else CPU_QUERIES)
    loss_gpu, loss_cpu, loss_rel = flat_loss_card_vs_cpu(head)
    print(f"[{label}-eval] {head} fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}; cuDNN's deterministic algorithms), argmax "
          f"agreement {agree:.4f}")
    print(f"[{label}-train] {head} fp32 flat train step loss over the first "
          f"{FLAT_CHECK_ROWS} rows of the first batch (dropout off, NOT shipped): card "
          f"{loss_gpu:.6f}, CPU {loss_cpu:.6f}, |Δ|/|loss| {loss_rel:.3e} (limit "
          f"{LOGIT_REL_LIMIT:g})", flush=True)
    if not (rel <= LOGIT_REL_LIMIT and loss_rel <= LOGIT_REL_LIMIT):
        raise AssertionError(f"float32 {head} disagrees on the card and the CPU")
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as result_root:
        tcfg = train.slice_config(result_root, classifier=head, **FLAT_TRAIN_CUT)
        tcfg["test_episode_size"] = FLAT_EVAL_EPISODES
        rows, peak_gib, train_launches = run_trainer(tcfg)
        extra = slice10_stage2(tcfg) if head == "DeepBDC_Pretrain" else None
    steps = sum(len(r["train_losses"]) for r in rows)
    val_steps = 2 * tcfg["test_episode"] // tcfg["test_episode_size"]
    for r in rows:
        print(f"[{label}-train] {tcfg['tag']} at full width, bf16, flat batches of "
              f"{tcfg['batch_size']}, epoch {r['epoch']} of {r['train_eps_count']} steps: "
              f"{r['train_segments_per_s']:.1f} segments/s through the backbones, step "
              f"{r['step_ms']:.1f} ms, loss {r['train_losses'][0]:.4f} -> "
              f"{r['train_losses'][-1]:.4f}, val acc {r['val_acc']:.3f}, test acc "
              f"{r['test_acc']:.3f}; peak memory {peak_gib:.2f} GiB; BDC launches "
              f"{train_launches}", flush=True)
    bdc = head == "DeepBDC_Pretrain"
    want_eval = (eval_calls, 0) if bdc else (0, 0)
    want_train = (steps + val_steps, steps) if bdc else (0, 0)
    if tuple(eval_launches) != want_eval or tuple(train_launches) != want_train:
        raise AssertionError(f"{head}: BDC launches eval {eval_launches} (expected {want_eval}), "
                             f"training {train_launches} (expected {want_train})")
    torch.cuda.empty_cache()
    print(f"[{label}] {head}: {time.time() - t0:.1f} s", flush=True)
    return (tuple(eval_launches), tuple(train_launches), extra)


def slice10_stage2(tcfg) -> tuple:
    """DeepBDC_Pretrain's ``save_part`` checkpoint of ``emb_func`` (written by
    the training run of ``tcfg``) loaded into DeepBDC through
    ``pretrain_path``: the loaded backbone must equal the saved one; then
    one eval epoch of DeepBDC's test loader.  Returns its BDC launches."""
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.ops import bdc_cuda

    name = "{}-{}-{}-{}-{}-{}".format(
        tcfg["classifier"]["name"], os.path.basename(tcfg["data_root"]),
        tcfg["backbone"]["name"], tcfg["way_num"], tcfg["shot_num"], tcfg["tag"])
    part = os.path.join(tcfg["result_root"], name, "checkpoints", "emb_func_best.pth")
    saved = torch.load(part, map_location="cpu", weights_only=True)
    with tempfile.TemporaryDirectory() as root:
        dcfg = train.slice_config(root, classifier="DeepBDC", **FLAT_TRAIN_CUT)
        dcfg.update(pretrain_path=part, test_episode_size=FLAT_EVAL_EPISODES)
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        trainer = train.Trainer(0, dcfg, device="cuda")
        loaded = trainer.method.state_dict()
        same = set(saved) == {k for k in loaded if k.startswith("emb_func.")} and all(
            torch.equal(loaded[k].cpu(), v) for k, v in saved.items())
        acc, ci = trainer._validate(0, trainer.test_loader[0], trainer.test_bank)
        torch.cuda.synchronize()
        launches = (bdc_cuda.launches, bdc_cuda.backward_launches)
        steps = len(trainer.test_loader[0])
    print(f"[slice10-stage2] DeepBDC_Pretrain's emb_func_best.pth ({len(saved)} tensors) "
          f"loaded into DeepBDC through pretrain_path: weights equal {same}; one eval epoch "
          f"of {dcfg['test_episode']} test episodes: accuracy {acc:.3f} ± {ci:.3f}, BDC "
          f"launches {launches} (expected ({steps}, 0))", flush=True)
    if not (same and math.isfinite(acc) and launches == (steps, 0)):
        raise AssertionError("DeepBDC did not load DeepBDC_Pretrain's emb_func, or its eval failed")
    return launches


def slice10_phase(g: int) -> tuple:
    """Phase 20: every head of ``SLICE10_FEATURES`` through ``slice10_cell``
    (DeepBDC_Pretrain with its stage 2), and DeepBDC_Pretrain at ``val_type:
    stl`` card vs CPU.  Returns DeepBDC_Pretrain's and its stage 2's BDC
    launches: (forward, backward)."""
    import torch

    from audio_fewshot_tpu_torch.eval import slice_config

    t_phase = time.time()
    forward = backward = 0
    for head in SLICE10_FEATURES:
        (ef, eb), (tf, tb, *_), extra = slice10_cell(head, g)
        forward += ef + tf + (extra[0] if extra else 0)
        backward += eb + tb + (extra[1] if extra else 0)
    scfg = slice_config(classifier="DeepBDC_Pretrain", precision="fp32")
    scfg["classifier"]["kwargs"]["val_type"] = "stl"
    torch.backends.cudnn.allow_tf32 = False
    rel, agree, shape = card_vs_cpu(scfg, CPU_QUERIES)
    print(f"[slice10] DeepBDC_Pretrain with val_type: stl (NO shipped config; the probe at "
          f"penalty_C 0.1): fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement {agree:.4f}")
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError("float32 DeepBDC_Pretrain (stl) card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    print(f"[slice10] phase 20 wall {time.time() - t_phase:.1f} s; DeepBDC_Pretrain's BDC "
          f"launches: forward {forward}, backward {backward}", flush=True)
    print(flush=True)
    return forward, backward


def renet_cells() -> None:
    """Phase 21's RENet cells: eval through ``Test`` at phase 15's cut, one
    float32 episode card vs CPU, one episodic training epoch at phase 13's
    cut, and the same epoch with the dual loader (``RENet:dual``:
    ``dataloader_num: 2``, flat batches of 12; NOT shipped traffic), each
    with one train step's loss card vs CPU (the episodic batch; the
    ``DualBatch`` of it and the first 12 flat rows).  BDC launches 0."""
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.data import get_dataloader
    from audio_fewshot_tpu_torch.episode import DualBatch
    from audio_fewshot_tpu_torch.eval import slice_config

    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = True  # the bf16 runs' own defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    hcfg = slice_config(classifier="RENet", **LATE_EVAL_CUT)
    eps, ms, peak_gib, acc, launches = run_test(hcfg)
    print(f"[slice11-eval] {hcfg['tag']} at full width ({RENET_FEATURES}), bf16 backbone, "
          f"fp32 head, {hcfg['test_episode_size']} episodes a step, {hcfg['test_epoch']} "
          f"epoch(s) of {hcfg['test_episode']} test episodes: accuracy {acc:.3f}, eval eps/s "
          f"by epoch {[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak memory "
          f"{peak_gib:.2f} GiB, BDC launches {launches} (expected 0)", flush=True)
    if not math.isfinite(acc) or any(launches):
        raise AssertionError(f"RENet eval: accuracy {acc}, BDC launches {launches}")
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    rel, agree, shape = card_vs_cpu(slice_config(classifier="RENet", precision="fp32"),
                                    CPU_QUERIES)
    print(f"[slice11-eval] RENet fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}; cuDNN's deterministic algorithms), argmax "
          f"agreement {agree:.4f}", flush=True)
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError("float32 RENet card logits disagree with the CPU")
    for cell in ("RENet", "RENet:dual"):
        torch.backends.cudnn.allow_tf32 = False
        lcfg = slice_config(classifier=cell, precision="fp32")
        loaders = get_dataloader(lcfg, "train")
        batch = next(iter(loaders[0].epoch(0)))
        if len(loaders) > 1:
            batch = DualBatch(episode=batch, flat=next(iter(loaders[1].epoch(0))))
        loss_gpu, loss_cpu, loss_rel = loss_card_vs_cpu(lcfg, batch)
        print(f"[slice11-train] {cell} fp32 train step loss over the first "
              f"{'dual ' if len(loaders) > 1 else ''}batch (DropBlock off, NOT shipped): card "
              f"{loss_gpu:.6f}, CPU {loss_cpu:.6f}, |Δ|/|loss| {loss_rel:.3e} (limit "
              f"{LOGIT_REL_LIMIT:g})", flush=True)
        if not loss_rel <= LOGIT_REL_LIMIT:
            raise AssertionError(f"float32 {cell} train loss disagrees on the card and the CPU")
        torch.backends.cudnn.allow_tf32 = True
        with tempfile.TemporaryDirectory() as result_root:
            tcfg = train.slice_config(result_root, classifier=cell, **LATE_TRAIN_CUT)
            rows, peak_gib, launches = run_trainer(tcfg)
        for r in rows:
            flat = (f" + a flat batch of {tcfg['batch_size']} (not shipped traffic)"
                    if cell == "RENet:dual" else "")
            print(f"[slice11-train] {tcfg['tag']} at full width, bf16, augment on, one "
                  f"episode{flat} a step, epoch {r['epoch']} of {r['train_eps_count']} steps: "
                  f"{r['train_eps']:.2f} train eps/s, step {r['step_ms']:.1f} ms, loss "
                  f"{r['train_losses'][0]:.4f} -> {r['train_losses'][-1]:.4f}, val acc "
                  f"{r['val_acc']:.3f}, test acc {r['test_acc']:.3f}; peak memory "
                  f"{peak_gib:.2f} GiB; BDC launches {launches} (expected 0)", flush=True)
        if any(launches):
            raise AssertionError(f"{cell} training: BDC launches {launches}")
        torch.cuda.empty_cache()
    print(f"[slice11] RENet: {time.time() - t0:.1f} s", flush=True)


def one_step_cell(head: str) -> None:
    """A head with no shipped config: one eval step through ``Test``
    (``ONE_STEP_CUT``; BDC launches 0) and one float32 episode card vs
    CPU."""
    import torch

    from audio_fewshot_tpu_torch.eval import slice_config

    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    hcfg = slice_config(classifier=head, **ONE_STEP_CUT)
    eps, ms, peak_gib, acc, launches = run_test(hcfg)
    print(f"[slice11-eval] {hcfg['tag']} at full width ({SLICE11_FEATURES[head]}), bf16 "
          f"backbone, fp32 head, one step of {hcfg['test_episode_size']} episodes: accuracy "
          f"{acc:.3f}, eval eps/s {[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak "
          f"memory {peak_gib:.2f} GiB, BDC launches {launches} (expected 0)", flush=True)
    if not math.isfinite(acc) or any(launches):
        raise AssertionError(f"{head} eval: accuracy {acc}, BDC launches {launches}")
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    rel, agree, shape = card_vs_cpu(slice_config(classifier=head, precision="fp32"),
                                    CPU_QUERIES)
    print(f"[slice11-eval] {head} fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement {agree:.4f}; "
          f"{time.time() - t0:.1f} s", flush=True)
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError(f"float32 {head} card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True


def slice11_phase(g: int) -> None:
    """Phase 21: RENet (``renet_cells``), FRN_Pretrain and S2M2 through
    ``slice10_cell`` (their BDC launches must be 0), MTLPretrain and
    MetabaselineKendallPretrain through ``one_step_cell``."""
    import torch

    t_phase = time.time()
    renet_cells()
    for head in ("FRN_Pretrain", "S2M2"):
        (ef, eb), (tf, tb, *_), _ = slice10_cell(head, g, "slice11", SLICE11_FEATURES[head])
        if any((ef, eb, tf, tb)):
            raise AssertionError(f"{head}: BDC launches in phase 21")
    for head in ("MTLPretrain", "MetabaselineKendallPretrain"):
        one_step_cell(head)
    torch.cuda.empty_cache()
    print(f"[slice11] phase 21 wall {time.time() - t_phase:.1f} s; BDC launches 0 in every "
          f"cell", flush=True)
    print(flush=True)


def bdc_backbone_calls(cfg) -> int:
    """The backbone calls of ``run_test`` on ``cfg``: DeepBDC's val
    calibration steps, the warm-up and the test steps."""
    from audio_fewshot_tpu_torch.data import get_dataloader

    return (len(get_dataloader(cfg, "val")[0]) + 1
            + cfg["test_epoch"] * len(get_dataloader(cfg, "test")[0]))


def slice12_cell(cell: str) -> tuple:
    """Phase 22's cell of a backbone swapped into a shipped head: eval through
    ``Test`` at phase 15's cut (at the cell's own episodes a step), one
    float32 episode card vs CPU (``CPU_QUERIES`` query segments,
    WRN's ``WRN_CPU_QUERIES``; MTL at ``MTL_CARD_ITER`` inner steps), one
    training epoch at phase 13's
    cut.  BDC launches: DeepBDC's a backbone call each (the backward one a
    train step), every other cell's 0.  Returns the (forward, backward)
    launches."""
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.eval import slice_config

    t0 = time.time()
    bdc = cell.startswith("DeepBDC")
    torch.backends.cudnn.allow_tf32 = True  # the bf16 runs' own defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    hcfg = slice_config(classifier=cell, **LATE_EVAL_CUT)
    eps, ms, peak_gib, acc, eval_launches = run_test(hcfg)
    want_eval = (bdc_backbone_calls(hcfg), 0) if bdc else (0, 0)
    print(f"[slice12-eval] {hcfg['tag']} at full width ({SLICE12_CELLS[cell]}), bf16 backbone, "
          f"fp32 head, {hcfg['test_episode_size']} episodes a step, {hcfg['test_epoch']} "
          f"epoch(s) of {hcfg['test_episode']} test episodes: accuracy {acc:.3f}, eval eps/s by "
          f"epoch {[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak memory "
          f"{peak_gib:.2f} GiB, BDC launches {eval_launches} (expected {want_eval})", flush=True)
    if not math.isfinite(acc) or tuple(eval_launches) != want_eval:
        raise AssertionError(f"{cell} eval: accuracy {acc}, BDC launches {eval_launches}")
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    ccfg = slice_config(classifier=cell, precision="fp32")
    note = ""
    if cell.startswith("MTL"):
        ccfg["classifier"]["kwargs"]["inner_param"]["iter"] = MTL_CARD_ITER
        note = f"; at {MTL_CARD_ITER} inner steps, NOT the shipped 100 (chaotic in float32)"
    rel, agree, shape = card_vs_cpu(ccfg, WRN_CPU_QUERIES if cell.endswith("WRN") else
                                    CPU_QUERIES)
    print(f"[slice12-eval] {cell} fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}; cuDNN's deterministic algorithms{note}), "
          f"argmax agreement {agree:.4f}", flush=True)
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError(f"float32 {cell} card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as result_root:
        tcfg = train.slice_config(result_root, classifier=cell, **LATE_TRAIN_CUT)
        tcfg["test_episode_size"] = min(hcfg["test_episode_size"], tcfg["test_episode"])
        rows, peak_gib, train_launches = run_trainer(tcfg)
    steps = sum(len(r["train_losses"]) for r in rows)
    val_steps = 2 * -(-tcfg["test_episode"] // tcfg["test_episode_size"])
    want_train = (steps + val_steps, steps) if bdc else (0, 0)
    for r in rows:
        print(f"[slice12-train] {tcfg['tag']} at full width, bf16, augment on, one episode a "
              f"step, epoch {r['epoch']} of {r['train_eps_count']} steps: {r['train_eps']:.2f} "
              f"train eps/s, step {r['step_ms']:.1f} ms, loss {r['train_losses'][0]:.4f} -> "
              f"{r['train_losses'][-1]:.4f}, val acc {r['val_acc']:.3f}, test acc "
              f"{r['test_acc']:.3f}; peak memory {peak_gib:.2f} GiB; BDC launches "
              f"{train_launches} (expected {want_train})", flush=True)
    if tuple(train_launches) != want_train:
        raise AssertionError(f"{cell} training: BDC launches {train_launches}")
    torch.cuda.empty_cache()
    print(f"[slice12] {cell}: {time.time() - t0:.1f} s", flush=True)
    return (eval_launches[0] + train_launches[0], eval_launches[1] + train_launches[1])


def ifsl_cycle(g: int) -> None:
    """Phase 22's IFSL cycle on the synthetic root, Conv64F's 1600 flat
    features, 25 classes, every path in one result root of its own:
    IfslPretrain trains one flat epoch and saves ``emb_func`` and
    ``classifier``; the featuring run over them writes the [25, 1600] class
    means; ``ifsl_5shot_iid_seed42`` (DMatchingNet) loads all three
    (``pretrain_path``, ``cls_path``, ``feature_path``; each held equal to
    what stages 1-2 wrote) and runs one eval epoch at phase 15's cut, then
    one float32 episode card vs CPU.  No BDC launch."""
    import numpy as np
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.eval import slice_config
    from audio_fewshot_tpu_torch.ops import bdc_cuda

    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        pcfg = train.slice_config(root, classifier="IfslPretrain", **FLAT_TRAIN_CUT)
        pcfg["test_episode_size"] = FLAT_EVAL_EPISODES
        rows, peak_gib, launches = run_trainer(pcfg)
        r = rows[0]
        print(f"[ifsl] stage 1: {pcfg['tag']} (Conv64F, 1600 features, 25 classes), one flat "
              f"epoch of {r['train_eps_count']} steps of {pcfg['batch_size']}: "
              f"{r['train_segments_per_s']:.1f} segments/s, step {r['step_ms']:.1f} ms, loss "
              f"{r['train_losses'][0]:.4f} -> {r['train_losses'][-1]:.4f}, val acc "
              f"{r['val_acc']:.3f}; peak memory {peak_gib:.2f} GiB; BDC launches {launches}",
              flush=True)
        ckpt = os.path.join(root, "{}-{}-{}-{}-{}-{}".format(
            "IfslPretrain", os.path.basename(pcfg["data_root"]), pcfg["backbone"]["name"],
            pcfg["way_num"], pcfg["shot_num"], pcfg["tag"]), "checkpoints")
        parts = {p: os.path.join(ckpt, f"{p}_last.pth") for p in ("emb_func", "classifier")}
        saved = {p: torch.load(f, map_location="cpu", weights_only=True)
                 for p, f in parts.items()}
        feature_path = os.path.join(root, "ifsl_features.npy")
        fcfg = copy.deepcopy(pcfg)
        fcfg["classifier"]["kwargs"].update(cls_classifier_path=parts["classifier"],
                                            ifsl_pretrain_param={
                                                "norm": False, "featuring": True,
                                                "feature_path": feature_path})
        fcfg.update(pretrain_path=parts["emb_func"], tag=pcfg["tag"] + "_featuring")
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        t1 = time.time()
        trainer = train.Trainer(0, fcfg, device="cuda")
        trainer.train_loop()
        torch.cuda.synchronize()
        means = np.load(feature_path)
        print(f"[ifsl] stage 2: the featuring run over stage 1's parts wrote {means.dtype} "
              f"{means.shape} to {os.path.basename(feature_path)} in {time.time() - t1:.1f} s "
              f"(Trainer set-up included); classes covered "
              f"{int((np.abs(means).sum(axis=1) > 0).sum())}", flush=True)
        if not (means.shape == (trainer.method.num_class, trainer.method.feat_dim)
                and np.isfinite(means).all()):
            raise AssertionError(f"featuring wrote {means.shape}")
        dcfg = train.slice_config(root, classifier="DMatchingNet:seed42",
                                  test_episode=LATE_EVAL_CUT["test_episode"])
        dcfg["classifier"]["kwargs"]["ifsl_param"].update(feature_path=feature_path,
                                                          cls_path=parts["classifier"])
        dcfg.update(pretrain_path=parts["emb_func"], test_episode_size=16)
        trainer = train.Trainer(0, dcfg, device="cuda")
        method = trainer.method
        own = method.state_dict()
        same = (all(torch.equal(own[k].cpu(), v) for k, v in saved["emb_func"].items() if k in own)
                and all(torch.equal(own["utils.linear." + k[len("classifier."):]].cpu(), v)
                        for k, v in saved["classifier"].items())
                and np.array_equal(method.utils.features.cpu().numpy(), means))
        t1 = time.time()
        acc, ci = trainer._validate(0, trainer.test_loader[0], trainer.test_bank)
        torch.cuda.synchronize()
        eval_s = time.time() - t1
        launches = (bdc_cuda.launches, bdc_cuda.backward_launches)
        print(f"[ifsl] stage 3: {dcfg['tag']} (DMatchingNet) read stage 1's emb_func and "
              f"classifier and stage 2's means: equal {same}; one eval epoch of "
              f"{dcfg['test_episode']} test episodes, {dcfg['test_episode_size']} a step: "
              f"accuracy {acc:.3f} ± {ci:.3f}, {dcfg['test_episode'] / eval_s:.2f} eval eps/s "
              f"(the first step's plans included); BDC launches {launches} (expected (0, 0))",
              flush=True)
        if not (same and math.isfinite(acc)) or any(launches):
            raise AssertionError("DMatchingNet did not read stages 1-2, or its eval failed")
        del trainer, method
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        ccfg = slice_config(classifier="DMatchingNet:seed42", precision="fp32")
        ccfg["classifier"]["kwargs"]["ifsl_param"].update(feature_path=feature_path,
                                                          cls_path=parts["classifier"])
        rel, agree, shape = card_vs_cpu(ccfg, g)
        print(f"[ifsl] stage 3 fp32 segment logits {shape} (both artifacts loaded): card vs "
              f"CPU max|Δ|/max|logit| {rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement "
              f"{agree:.4f}", flush=True)
        if not rel <= LOGIT_REL_LIMIT:
            raise AssertionError("float32 DMatchingNet (IFSL cycle) disagrees on the card and CPU")
        torch.backends.cudnn.allow_tf32 = True
    print(f"[ifsl] the cycle: {time.time() - t0:.1f} s", flush=True)


def slice12_phase() -> tuple:
    """Phase 22: every cell of ``SLICE12_CELLS`` through ``slice12_cell``,
    S2M2 on resnet18 through ``slice10_cell`` (flat training; no BDC
    launch), and ``ifsl_cycle``, each card-vs-CPU episode at
    ``CPU_QUERIES`` query segments (WRN's fewer).  Returns
    resnet18Bdc's BDC launches (forward, backward)."""
    import torch

    t_phase = time.time()
    forward = backward = 0
    for cell in SLICE12_CELLS:
        f, b = slice12_cell(cell)
        forward, backward = forward + f, backward + b
    for cell, what in SLICE12_FLAT.items():
        (ef, eb), (tf, tb, *_), _ = slice10_cell(cell, CPU_QUERIES, "slice12", what)
        if any((ef, eb, tf, tb)):
            raise AssertionError(f"{cell}: BDC launches in phase 22")
    ifsl_cycle(CPU_QUERIES)
    torch.cuda.empty_cache()
    print(f"[slice12] phase 22 wall {time.time() - t_phase:.1f} s; resnet18Bdc's BDC launches: "
          f"forward {forward}, backward {backward}", flush=True)
    print(flush=True)
    return forward, backward


def swin_phase() -> None:
    """Phase 23: ProtoNet on swin_t at full width (NOT shipped traffic):
    eval through ``Test`` at phase 15's cut with ``dump_features`` (one
    ``featdata_*.npz`` per episode of the first test batch, way · (shot +
    query) rows of 768), one float32 episode card vs CPU, one training epoch
    at phase 13's cut with ``profile_steps`` (its Chrome trace read back);
    swin_mini one float32 episode card vs CPU.  BDC launches 0."""
    import glob

    import numpy as np
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.eval import Test, slice_config
    from audio_fewshot_tpu_torch.models import build_method
    from audio_fewshot_tpu_torch.ops import bdc_cuda
    from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    t_phase = time.time()
    torch.backends.cudnn.allow_tf32 = True  # the bf16 runs' own defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = "ProtoNet:swin_t"
    hcfg = slice_config(classifier=cell, **RESNET_EVAL_CUT)
    hcfg["dump_features"] = True
    with tempfile.TemporaryDirectory() as result_path:
        init_seed(int(hcfg["seed"]))
        save_model_best(result_path, build_method(hcfg))
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        test = Test(0, hcfg, result_path, device="cuda")
        acc, _ = test.test_loop()
        torch.cuda.synchronize()
        launches = (bdc_cuda.launches, bdc_cuda.backward_launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = 5 * (5 + 10)
        width = test.method.emb_func.feature_dim(tuple(hcfg["spec_shape"]))
        dumps = []
        for path in sorted(test.feature_dumps):
            with np.load(path) as z:
                dumps.append((z["raw_features"].shape, bool(np.isfinite(z["raw_features"]).all()),
                              "features_2d" in z.files))
    eps = test.epoch_eps
    ms = 1e3 * hcfg["test_episode_size"] * len(eps) / sum(eps)
    print(f"[swin-eval] {hcfg['tag']} at full width (swin_t: stages 32x39, 16x19, 8x9, 4x4 at "
          f"windows 7, 7, 7, 4; 768 mean features), bf16 backbone, fp32 head, "
          f"{hcfg['test_episode_size']} episodes a step, {hcfg['test_epoch']} epoch of "
          f"{hcfg['test_episode']} test episodes: accuracy {acc:.3f}, eval eps/s "
          f"{[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak memory {peak_gib:.2f} GiB, "
          f"BDC launches {launches} (expected (0, 0))", flush=True)
    print(f"[swin-eval] dump_features: {len(dumps)} featdata npz (expected "
          f"{hcfg['test_episode_size']}, one an episode of the first test batch), raw_features "
          f"{sorted({d[0] for d in dumps})} (expected ({rows}, {width})), finite "
          f"{all(d[1] for d in dumps)}, features_2d written {sorted({d[2] for d in dumps})} "
          f"(only where sklearn imports)", flush=True)
    if not (math.isfinite(acc) and not any(launches) and len(dumps) == hcfg["test_episode_size"]
            and all(d[0] == (rows, width) and d[1] for d in dumps)):
        raise AssertionError(f"swin_t eval: accuracy {acc}, BDC launches {launches}, "
                             f"dumps {dumps}")
    del test
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    for name in (cell, "ProtoNet:swin_mini"):
        rel, agree, shape = card_vs_cpu(slice_config(classifier=name, precision="fp32"),
                                        CPU_QUERIES)
        print(f"[swin-eval] {name} fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
              f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement {agree:.4f}",
              flush=True)
        if not rel <= LOGIT_REL_LIMIT:
            raise AssertionError(f"float32 {name} card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as result_root:
        tcfg = train.slice_config(result_root, classifier=cell, **HEAD_TRAIN_CUT)
        tcfg["profile_steps"] = SWIN_PROFILE_STEPS
        rows_, peak_gib, launches = run_trainer(tcfg)
        traces = glob.glob(os.path.join(result_root, "*", "log_files", "profile", "*.json"))
        kernels = 0
        for trace in traces:
            with open(trace) as f:
                kernels += sum(e.get("cat") == "kernel" for e in json.load(f)["traceEvents"])
        sizes = [os.path.getsize(t) for t in traces]
    for r in rows_:
        print(f"[swin-train] {tcfg['tag']} at full width, bf16, augment on, one episode a step, "
              f"epoch {r['epoch']} of {r['train_eps_count']} steps (steps 2-3 under "
              f"torch.profiler): {r['train_eps']:.2f} train eps/s, step {r['step_ms']:.1f} ms, "
              f"loss {r['train_losses'][0]:.4f} -> {r['train_losses'][-1]:.4f}, val acc "
              f"{r['val_acc']:.3f}, test acc {r['test_acc']:.3f}; peak memory "
              f"{peak_gib:.2f} GiB; BDC launches {launches} (expected (0, 0))", flush=True)
    print(f"[swin-train] profile_steps {SWIN_PROFILE_STEPS}: {len(traces)} Chrome trace(s) "
          f"({[os.path.basename(t) for t in traces]}, {sizes} bytes) with {kernels} CUDA "
          f"kernel events", flush=True)
    if any(launches) or len(traces) != 1 or not kernels:
        raise AssertionError(f"swin_t training: BDC launches {launches}, traces {traces}, "
                             f"kernel events {kernels}")
    torch.cuda.empty_cache()
    print(f"[swin] phase 23 wall {time.time() - t_phase:.1f} s; BDC launches 0", flush=True)
    print(flush=True)


def _synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_batches(trainer, epoch: int):
    """``trainer``'s host batches from ``epoch`` on, epoch after epoch."""
    while True:
        yield from trainer._host_batches(epoch)
        epoch += 1


def collective_times(trainer, steps: int = 3) -> dict:
    """``steps`` more train steps of ``trainer`` (epoch 1's first batches)
    with every ``all_reduce`` timed between device syncs: the step's ms, the
    gradient all-reduce's (the one call over every parameter) and the rest's
    (the BatchNorm moments, forward and backward, and the loss mean), each
    a step.  The syncs slow the step; the share is of this timed step."""
    import torch
    import torch.distributed as dist

    device = trainer.device
    inner = dist.all_reduce
    calls = []

    def timed(tensor, *args, **kwargs):
        _synchronize(device)
        t0 = time.perf_counter()
        out = inner(tensor, *args, **kwargs)
        _synchronize(device)
        calls.append((tensor.numel(), time.perf_counter() - t0))
        return out

    n_params = sum(p.numel() for p in trainer.method.parameters() if p.requires_grad)
    trainer.method.train()  # the loop ends in eval mode, after its test pass
    batches = train_batches(trainer, 1)
    gen = torch.Generator().manual_seed(1)
    dist.all_reduce = timed
    try:
        step_s = []
        for _ in range(steps):
            batch = trainer._device_batch(next(batches), trainer.train_bank)
            if trainer.augment:
                batch = trainer._augment_batch(batch, gen)
            _synchronize(device)
            t0 = time.perf_counter()
            trainer._train_step(batch)
            _synchronize(device)
            step_s.append(time.perf_counter() - t0)
    finally:
        dist.all_reduce = inner
    grad = [t for n, t in calls if n > n_params]
    rest = [t for n, t in calls if n <= n_params]
    return {"step_ms": 1e3 * sum(step_s) / steps, "grad_ms": 1e3 * sum(grad) / steps,
            "other_ms": 1e3 * sum(rest) / steps, "other_calls": len(rest) // steps}


# phase 25's controls: a sharding broken on purpose, which the limits must catch
FAULTS = {
    "gradients": "no gradient all-reduce (each rank steps on its own shard's gradient)",
    "batchnorm": "BatchNorm moments per rank (not over every rank's rows)",
}


def recorded_logits(method) -> list:
    """A list that receives every later forward's logits of ``method``, in
    the one-rank order (gathered over the ranks where its rows span them),
    on the host."""
    from audio_fewshot_tpu_torch.parallel import gather_rows, sharded_world

    out = []
    forward = method.forward

    def record(*args, **kwargs):
        logits = forward(*args, **kwargs)
        out.append(gather_rows(logits.detach(), sharded_world()).cpu())
        return logits

    method.forward = record
    return out


def flagship_cell(world, cfg: dict, timed_steps: int = 3, fault=None,
                  logits: bool = False) -> dict:
    """The flagship training cell through ``Trainer`` (its ``train_loop``:
    the steps, a val and a test pass, the checkpoints on rank 0): the
    history, the first step's loss, every parameter before the loop, after
    its first step and after it, each as one vector, and
    ``collective_times`` of ``timed_steps`` more (warm) steps; with
    ``logits``, those of its val and test steps.  ``fault`` (a key of
    ``FAULTS``) breaks the sharding for a control run."""
    import torch

    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.models.backbones import layers

    def params():
        return torch.cat([p.detach().float().reshape(-1).cpu()
                          for p in trainer.method.parameters()])

    trainer = train.Trainer(0, copy.deepcopy(cfg), device=world.device)
    start, first = params(), {}
    step = trainer._train_step

    def first_step(batch):
        out = step(batch)
        if not first:
            first.update(loss=float(out["loss"]), params=params())
        return out

    trainer._train_step = first_step
    eval_logits = recorded_logits(trainer.method) if logits else None
    patched = {"gradients": (train, "all_reduce_gradients", lambda params_, world_: None),
               "batchnorm": (layers, "rows_sharded", lambda: False)}.get(fault)
    saved = patched and getattr(patched[0], patched[1])
    if patched:
        setattr(patched[0], patched[1], patched[2])
    try:
        t0 = time.time()
        trainer.train_loop()
        _synchronize(world.device)
        wall = time.time() - t0
    finally:
        if patched:
            setattr(patched[0], patched[1], saved)
    trainer._train_step = step
    return {"history": trainer.history, "params0": start, "first": first, "params": params(),
            "wall": wall, "logits": eval_logits,
            "collectives": collective_times(trainer, timed_steps) if timed_steps else None}


def eval_cell(world, cfg: dict) -> dict:
    """A full-width eval through ``Test`` at the seed's weights: every
    step's logits (the warm-up's first), the per-episode accuracies, the
    mean, eval eps/s and the loop's wall."""
    from audio_fewshot_tpu_torch.eval import Test

    test = Test(0, copy.deepcopy(cfg), None, device=world.device)
    logits = recorded_logits(test.method)
    t0 = time.time()
    mean, _ = test.test_loop()
    _synchronize(world.device)
    return {"logits": logits, "episode_accs": test.episode_accs, "mean": mean,
            "eps": test.epoch_eps, "wall": time.time() - t0}


#: phase 25's scenarios beside the dry run's (module-level: the ranks
#: import this script by name and look them up)
PARALLEL_SCENARIOS = {"flagship_cell": flagship_cell, "eval_cell": eval_cell}


def parallel_cells(root: str, tag: str, controls: bool = False) -> dict:
    """Phase 25's plan under ``root`` for the run ``tag``: the dry run's
    ProtoNet/Conv64F cell, the flagship's training cell
    (``train.slice_config`` at ``PARALLEL_TRAIN_CUT``, 2 episodes a step,
    float32, SGD) and its TTA eval (``eval.slice_config`` at
    ``PARALLEL_EVAL_CUT``, float32) over a random-weight checkpoint from the
    seed; the full-width DeepBDC_Pretrain flat cell (``PRETRAIN_CUT``);
    the dry run's flat, FEAT and MeTAL scenarios (``FLAT_PLAN``, its
    replicated eval and featuring pass under ``root``); the full-width ADM
    training and VERSA eval cells (``HEAD_RANKS_TRAIN_CUT``,
    ``HEAD_RANKS_EVAL_CUT``) and the dry run's 17 heads of ``HEAD_CELLS``
    with its ragged eval and ``Test``'s replicated steps (``head_plan``);
    with ``controls``, the flagship's training cell again under each of
    ``FAULTS``."""
    from audio_fewshot_tpu_torch import dryrun_multigpu as dry
    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.eval import slice_config
    from audio_fewshot_tpu_torch.models import build_method
    from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    def training(run):
        cfg = train.slice_config(os.path.join(root, run), **PARALLEL_TRAIN_CUT)
        cfg.update(episode_size=2, test_episode_size=4, precision="fp32",
                   optimizer={"name": "SGD", "kwargs": {"lr": 0.005}, "other": None})
        return cfg

    ecfg = slice_config(precision="fp32", **PARALLEL_EVAL_CUT)
    ecfg["enhance_classification_via_energy"] = True
    weights = os.path.join(root, "eval_weights")
    if not os.path.isdir(weights):
        init_seed(int(ecfg["seed"]))
        save_model_best(weights, build_method(ecfg))
    pretrain = train.slice_config(os.path.join(root, f"{tag}_pretrain"),
                                  classifier="DeepBDC_Pretrain", **PRETRAIN_CUT)
    pretrain.update(data_root=PRETRAIN_ROOT, precision="fp32",
                    optimizer={"name": "SGD", "kwargs": {"lr": 0.005}, "other": None})
    adm = train.slice_config(os.path.join(root, f"{tag}_adm"), classifier="ADM",
                             **HEAD_RANKS_TRAIN_CUT)
    adm.update(episode_size=2, test_episode_size=2, precision="fp32",
               optimizer={"name": "SGD", "kwargs": {"lr": 0.005}, "other": None})
    versa = slice_config(classifier="VERSA", precision="fp32", **HEAD_RANKS_EVAL_CUT)
    plan = {"proto_train": {}, "flagship_cell": {"cfg": training(tag)},
            "tta_eval": {"cfg": ecfg, "result_path": weights},
            "flagship_cell:pretrain": {"cfg": pretrain, "timed_steps": PRETRAIN_TIMED_STEPS},
            **dry.FLAT_PLAN, **dry.flat_root_plan(os.path.join(root, tag)),
            "flagship_cell:adm": {"cfg": adm, "timed_steps": HEAD_RANKS_TIMED_STEPS,
                                  "logits": True},
            "eval_cell:versa": {"cfg": versa}, **dry.head_plan(os.path.join(root, tag))}
    for fault in FAULTS if controls else ():
        plan[f"flagship_cell:{fault}"] = {"cfg": training(f"{tag}_{fault}"), "timed_steps": 0,
                                          "fault": fault}
    return plan


def flagship_gaps(cell: dict, ref: dict) -> dict:
    """A training cell's gaps from the 1-rank run's: each loss's relative
    gap, and |Δθ| against the 1-rank run's update after the first step and
    after the last."""
    losses = [v for r in cell["history"] for v in r["train_losses"]]
    ref_losses = [v for r in ref["history"] for v in r["train_losses"]]
    first = ref["first"]["params"] - ref["params0"]
    update = ref["params"] - ref["params0"]
    return {"losses": losses, "ref_losses": ref_losses,
            "rel": [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses, strict=True)],
            "first_loss": abs(cell["first"]["loss"] - ref["first"]["loss"])
            / abs(ref["first"]["loss"]),
            "first_update": float((cell["first"]["params"] - ref["first"]["params"]).norm()
                                  / first.norm()),
            "update": float((cell["params"] - ref["params"]).norm() / update.norm()),
            "update_share": float(update.norm() / ref["params"].norm())}


def first_step_held(g: dict) -> bool:
    return (g["first_loss"] <= PARALLEL_FIRST_LOSS_RTOL
            and g["first_update"] <= PARALLEL_FIRST_UPDATE_REL)


def proto_gaps(many: dict, one: dict) -> dict:
    """The ProtoNet cell's gaps from the 1-rank run's, each as a multiple of
    its ``PROTO_LIMITS`` limit (at most 1 holds)."""
    import torch

    def worst(a, b, rtol, atol):
        a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    a, b = many["proto_train"], one["proto_train"]
    lim = PROTO_LIMITS
    return {"first_loss": worst(a["losses"][:1], b["losses"][:1], lim["first_loss"], 0.0),
            "losses": worst(a["losses"], b["losses"], lim["losses"], 0.0),
            "state": max(worst(a["state"][k], b["state"][k], *lim["state"]) for k in b["state"]),
            "logits": worst(a["logits"], b["logits"], *lim["logits"])}


def parallel_compare(label: str, many: dict, one: dict) -> None:
    """Rank 0's results of a run over ranks against the 1-rank run's: the
    ProtoNet cell at the CPU tests' limits; the flagship's losses, every
    parameter after the first step and after the last (against the 1-rank
    run's update), the calibration threshold, the flagged clips of each TTA
    step and the per-episode accuracies; fails past the limits."""
    import torch

    proto = proto_gaps(many, one)
    print(f"[parallel] {label} against 1 rank, ProtoNet/Conv64F (3 SGD steps of 8 episodes, "
          f"float32): each gap as a multiple of its limit (at most 1 holds) "
          f"{ {k: f'{v:.3e}' for k, v in proto.items()} }; limits {PROTO_LIMITS}; losses "
          f"{many['proto_train']['losses']} against {one['proto_train']['losses']}", flush=True)
    g = flagship_gaps(many["flagship_cell"], one["flagship_cell"])
    ta, tb = many["tta_eval"]["threshold"], one["tta_eval"]["threshold"]
    th_rel = abs(ta - tb) / abs(tb)
    acc = torch.tensor(many["tta_eval"]["episode_accs"][0])
    acc_ref = torch.tensor(one["tta_eval"]["episode_accs"][0])
    dacc = (acc - acc_ref).abs()
    swaps = [len(set(a.tolist()) ^ set(b.tolist())) // 2 for a, b in zip(
        many["tta_eval"]["flagged"], one["tta_eval"]["flagged"], strict=True)]
    print(f"[parallel] {label} against 1 rank, the flagship: train losses "
          f"{[round(v, 6) for v in g['losses']]} against {[round(v, 6) for v in g['ref_losses']]}"
          f", rel {[f'{v:.2e}' for v in g['rel']]} (limits {PARALLEL_FIRST_LOSS_RTOL:g} first, "
          f"{PARALLEL_LOSS_RTOL:g}); every parameter after the first step |Δθ| / |1 rank's "
          f"first update| {g['first_update']:.3e} (limit {PARALLEL_FIRST_UPDATE_REL:g}), after "
          f"the last |Δθ| / |1 rank's update| {g['update']:.3e} (limit {PARALLEL_UPDATE_REL:g}; "
          f"|update| / |θ| {g['update_share']:.3e}); calibration threshold rel {th_rel:.3e} "
          f"(limit {PARALLEL_THRESHOLD_RTOL:g}); flagged clips swapped per TTA step {swaps} "
          f"(limit {PARALLEL_FLAG_SWAPS}); per-episode accuracies of {len(acc)} episodes: max "
          f"|Δ| {dacc.max().item():.3f}, mean {dacc.mean().item():.4f} (limits "
          f"{PARALLEL_ACC_MAX:g}, {PARALLEL_ACC_MEAN:g})", flush=True)
    if not (max(proto.values()) <= 1.0 and first_step_held(g)
            and max(g["rel"]) <= PARALLEL_LOSS_RTOL and g["update"] <= PARALLEL_UPDATE_REL
            and th_rel <= PARALLEL_THRESHOLD_RTOL and max(swaps) <= PARALLEL_FLAG_SWAPS
            and len(acc) == len(acc_ref) and dacc.max() <= PARALLEL_ACC_MAX
            and dacc.mean() <= PARALLEL_ACC_MEAN):
        raise AssertionError(f"{label} disagrees with the 1-rank run")
    flat_compare(label, many, one)
    head_compare(label, many, one)
    for fault, what in FAULTS.items():
        key = f"flagship_cell:{fault}"
        if key not in many:
            continue
        c = flagship_gaps(many[key], one["flagship_cell"])
        print(f"[parallel] {label}, control: {what}: first loss rel {c['first_loss']:.3e} "
              f"(limit {PARALLEL_FIRST_LOSS_RTOL:g}), every parameter after the first step "
              f"|Δθ| / |1 rank's first update| {c['first_update']:.3e} (limit "
              f"{PARALLEL_FIRST_UPDATE_REL:g}): "
              f"{'held, so the limits do not see it' if first_step_held(c) else 'caught'}",
              flush=True)
        if first_step_held(c):
            raise AssertionError(f"{label}: the control '{what}' passes the first-step limits")


def flat_compare(label: str, many: dict, one: dict) -> None:
    """The flat family's cells of a run over ranks against the 1-rank run's:
    the dry run's flat, FEAT, MeTAL, replicated-eval and featuring
    scenarios at its own limits (``dryrun_multigpu.mismatch``: rtol 1e-3 /
    atol 5e-4, eval logits atol 1e-2), and the full-width DeepBDC_Pretrain
    cell at the flagship's (the first loss and every parameter after the
    first step tightly, the second step loosely; the replicated val and
    test accuracies within ``PARALLEL_ACC_MAX``); fails past them."""
    from audio_fewshot_tpu_torch import dryrun_multigpu as dry

    names = [*dry.FLAT_PLAN, *dry.flat_root_plan("")]
    gaps = {n: dry.mismatch(dry.compared(n, many[n]), dry.compared(n, one[n])) for n in names}
    print(f"[parallel] {label} against 1 rank, the dry run's flat family, FEAT and MeTAL "
          f"(each gap as a multiple of its limit: rtol 1e-3 / atol 5e-4, eval logits atol "
          f"1e-2) { {k: f'{v:.3e}' for k, v in gaps.items()} }; seconds over the ranks "
          f"{ {k: round(many[k + ':s'], 2) for k in names} }", flush=True)
    g = flagship_gaps(many["flagship_cell:pretrain"], one["flagship_cell:pretrain"])
    accs = [(r[k], q[k]) for r, q in zip(many["flagship_cell:pretrain"]["history"],
                                         one["flagship_cell:pretrain"]["history"], strict=True)
            for k in ("val_acc", "test_acc")]
    dacc = max(abs(a - b) for a, b in accs)
    print(f"[parallel] {label} against 1 rank, DeepBDC_Pretrain/resnet12Bdc at full width (2 "
          f"flat steps of 128, float32, SGD): losses {[round(v, 6) for v in g['losses']]} "
          f"against {[round(v, 6) for v in g['ref_losses']]}, rel {[f'{v:.2e}' for v in g['rel']]}"
          f" (limits {PARALLEL_FIRST_LOSS_RTOL:g} first, {PARALLEL_LOSS_RTOL:g}); every parameter "
          f"after the first step |Δθ| / |1 rank's first update| {g['first_update']:.3e} (limit "
          f"{PARALLEL_FIRST_UPDATE_REL:g}), after the last |Δθ| / |1 rank's update| "
          f"{g['update']:.3e} (limit {PARALLEL_UPDATE_REL:g}; |update| / |θ| "
          f"{g['update_share']:.3e}); replicated val and test accuracy (ours, 1 rank's) {accs}, "
          f"max |Δ| {dacc:.3f} (limit {PARALLEL_ACC_MAX:g})", flush=True)
    if not (max(gaps.values()) <= 1.0 and first_step_held(g)
            and max(g["rel"]) <= PARALLEL_LOSS_RTOL and g["update"] <= PARALLEL_UPDATE_REL
            and dacc <= PARALLEL_ACC_MAX):
        raise AssertionError(f"{label}: the flat family's cells disagree with the 1-rank run")


def head_compare(label: str, many: dict, one: dict) -> None:
    """The cells of the heads audited for ranks last, over ranks against 1
    rank: the dry run's 17 heads, ragged eval and ``Test``'s replicated
    steps at its own limits; the full-width ADM cell at the flagship's
    (and its val and test logits at ``PROTO_LIMITS``'); the full-width VERSA
    eval's logits at ``PROTO_LIMITS``' and its accuracies at the
    flagship's; fails past them."""
    import torch

    from audio_fewshot_tpu_torch import dryrun_multigpu as dry

    names = list(dry.head_plan(""))
    gaps = {n: dry.mismatch(dry.compared(n, many[n]), dry.compared(n, one[n])) for n in names}
    print(f"[parallel] {label} against 1 rank, the dry run's 17 heads, ragged eval and Test's "
          f"replicated steps (each gap as a multiple of its limit: rtol 1e-3 / atol 5e-4, eval "
          f"logits atol 1e-2) { {k: f'{v:.3e}' for k, v in gaps.items()} }; seconds over the "
          f"ranks { {k: round(many[k + ':s'], 2) for k in names} }", flush=True)
    for n in (n for n, v in gaps.items() if v > 1.0):
        print(f"[parallel] {label}: {n} past its limits, by key "
              f"{ {k: f'{dry.mismatch(many[n][k], one[n][k], key=k):.3e}' for k in one[n]} }; "
              f"losses {many[n].get('losses')} against {one[n].get('losses')}", flush=True)
    rtol, atol = PROTO_LIMITS["logits"]
    adm, adm_one = many["flagship_cell:adm"], one["flagship_cell:adm"]
    g = flagship_gaps(adm, adm_one)
    adm_logits = dry.mismatch(adm["logits"], adm_one["logits"], rtol, atol)
    adm_acc = max(abs(r[k] - q[k]) for r, q in zip(adm["history"], adm_one["history"],
                                                   strict=True)
                  for k in ("val_acc", "test_acc"))
    print(f"[parallel] {label} against 1 rank, adm_5shot_iid_seed0 at full width (2 steps of 2 "
          f"episodes, float32, SGD): losses {[round(v, 6) for v in g['losses']]} against "
          f"{[round(v, 6) for v in g['ref_losses']]}, rel {[f'{v:.2e}' for v in g['rel']]} "
          f"(limits {PARALLEL_FIRST_LOSS_RTOL:g} first, {PARALLEL_LOSS_RTOL:g}); every parameter "
          f"after the first step |Δθ| / |1 rank's first update| {g['first_update']:.3e} (limit "
          f"{PARALLEL_FIRST_UPDATE_REL:g}), after the last |Δθ| / |1 rank's update| "
          f"{g['update']:.3e} (limit {PARALLEL_UPDATE_REL:g}); val and test logits of "
          f"{sum(len(x) for x in adm['logits'])} episodes: gap {adm_logits:.3e} of the limit "
          f"(rtol {rtol:g}, atol {atol:g}); val / test accuracy max |Δ| {adm_acc:.3f} (limit "
          f"{PARALLEL_ACC_MAX:g})", flush=True)
    versa, versa_one = many["eval_cell:versa"], one["eval_cell:versa"]
    versa_logits = dry.mismatch(versa["logits"], versa_one["logits"], rtol, atol)
    acc = torch.tensor(versa["episode_accs"][0])
    dacc = (acc - torch.tensor(versa_one["episode_accs"][0])).abs()
    print(f"[parallel] {label} against 1 rank, versa_5shot_iid_seed0 eval at full width ("
          f"{len(acc)} episodes, ragged queries, float32): logits of every step (the warm-up's "
          f"too) gap {versa_logits:.3e} of the limit (rtol {rtol:g}, atol {atol:g}); "
          f"per-episode accuracies max |Δ| {dacc.max().item():.3f}, mean {dacc.mean().item():.4f}"
          f" (limits {PARALLEL_ACC_MAX:g}, {PARALLEL_ACC_MEAN:g})", flush=True)
    if not (max(gaps.values()) <= 1.0 and first_step_held(g)
            and max(g["rel"]) <= PARALLEL_LOSS_RTOL and g["update"] <= PARALLEL_UPDATE_REL
            and adm_logits <= 1.0 and adm_acc <= PARALLEL_ACC_MAX and versa_logits <= 1.0
            and dacc.max() <= PARALLEL_ACC_MAX and dacc.mean() <= PARALLEL_ACC_MEAN):
        raise AssertionError(f"{label}: the heads' cells disagree with the 1-rank run")


def head_report(label: str, result: dict, smi: str) -> None:
    """The full-width ADM and VERSA cells of a run: ADM's ms a step and a
    warm step, its losses and accuracies; VERSA's eval eps/s, accuracy and
    wall; fails on a value that is not finite."""
    adm, versa = result["flagship_cell:adm"], result["eval_cell:versa"]
    losses = [v for r in adm["history"] for v in r["train_losses"]]
    values = losses + [adm["history"][-1][k] for k in ("val_acc", "test_acc")] + [versa["mean"]]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: non-finite ADM loss or accuracy, or VERSA accuracy")
    print(f"[parallel] {label}: adm_5shot_iid_seed0 at full width, a step of 2 episodes: "
          f"{adm['history'][0]['step_ms']:.1f} ms ({len(losses)} steps, the first cold; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}), {adm['collectives']['step_ms']:.1f} ms a "
          f"warm step ({HEAD_RANKS_TIMED_STEPS} more, between syncs; the gradient all-reduce "
          f"{adm['collectives']['grad_ms']:.1f} ms, the {adm['collectives']['other_calls']} "
          f"small ones {adm['collectives']['other_ms']:.1f} ms); its training, val and test "
          f"{adm['wall']:.1f} s, val / test accuracy {adm['history'][-1]['val_acc']:.3f} / "
          f"{adm['history'][-1]['test_acc']:.3f}; versa_5shot_iid_seed0 eval at full width "
          f"({HEAD_RANKS_EVAL_CUT['test_episode_size']} episodes a step): eps/s "
          f"{[round(v, 2) for v in versa['eps']]}, accuracy {versa['mean']:.3f}, its loop "
          f"{versa['wall']:.1f} s; {smi}", flush=True)


def parallel_report(label: str, results: list, wall: float, smi: str) -> tuple:
    """One line per run: ranks, backend, wall, train ms a step, eval eps/s;
    the BDC launches summed over the ranks (each rank must launch both, the
    3 warm steps of ``collective_times`` included)."""
    launches = [r["launches"] for r in results]
    if any(f == 0 or b == 0 for f, b in launches):
        raise AssertionError(f"{label}: a rank launched no BDC kernel: {launches}")
    cell, tta = results[0]["flagship_cell"], results[0]["tta_eval"]
    warm = cell["collectives"]["step_ms"]
    losses = [v for r in cell["history"] for v in r["train_losses"]]
    pre = results[0]["flagship_cell:pretrain"]
    pre_losses = [v for r in pre["history"] for v in r["train_losses"]]
    values = losses + [cell["history"][-1][k] for k in ("val_acc", "test_acc")] + [
        tta["mean"], tta["threshold"]] + results[0]["proto_train"]["losses"] + pre_losses + [
        pre["history"][-1][k] for k in ("val_acc", "test_acc")]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: non-finite loss, accuracy or threshold")
    print(f"[parallel] {label}: {len(results)} rank(s), {wall:.1f} s wall (start-up, "
          f"training {cell['wall']:.1f} s, TTA eval); train {cell['history'][0]['step_ms']:.1f} "
          f"ms a step of 2 episodes ({len(losses)} steps, the first cold; loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}), {warm:.1f} ms a warm step (3 more, between syncs); TTA "
          f"eval eps/s {[round(v, 2) for v in tta['eps']]}, accuracy "
          f"{tta['mean']:.3f}, threshold {tta['threshold']:.6f}; launches per rank (bdc_pool, "
          f"bdc_pool_backward) {launches}; {smi}", flush=True)
    print(f"[parallel] {label}: DeepBDC_Pretrain/resnet12Bdc at full width, a flat step of "
          f"128 ({128 // len(results)} rows a rank): {pre['history'][0]['step_ms']:.1f} ms a "
          f"step ({len(pre_losses)} steps, the first cold; loss {pre_losses[0]:.4f} -> "
          f"{pre_losses[-1]:.4f}), {pre['collectives']['step_ms']:.1f} ms a warm step "
          f"({PRETRAIN_TIMED_STEPS} more, between syncs; the gradient all-reduce "
          f"{pre['collectives']['grad_ms']:.1f} ms, the {pre['collectives']['other_calls']} "
          f"small ones {pre['collectives']['other_ms']:.1f} ms); its training, val and test "
          f"{pre['wall']:.1f} s, val / test accuracy {pre['history'][-1]['val_acc']:.3f} / "
          f"{pre['history'][-1]['test_acc']:.3f}; {smi}", flush=True)
    head_report(label, results[0], smi)
    return sum(f for f, _ in launches), sum(b for _, b in launches)


def parallel_phase(smi: str) -> tuple:
    """Phase 25: the dry run's ProtoNet cell, the flagship's training cell
    and its TTA eval, the full-width DeepBDC_Pretrain flat cell and the dry
    run's flat family, FEAT and MeTAL on one rank (a 1-rank NCCL group on a
    1-card machine), over ``PARALLEL_RANKS`` gloo ranks that share card 0
    (with the controls of ``FAULTS``), and, where the machine has several
    cards, over one NCCL rank a card and over ``PARALLEL_RANKS`` NCCL
    ranks; each run against the 1-rank one.  Returns the BDC launches of
    every run (each rank launches both kernels)."""
    import torch
    import torch.distributed as dist

    from audio_fewshot_tpu_torch import dryrun_multigpu as dry
    from audio_fewshot_tpu_torch.ops import bdc_cuda
    from audio_fewshot_tpu_torch.parallel import World

    t_phase = time.time()
    cards = torch.cuda.device_count()
    forward = backward = 0
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        # one rank, in this process
        t0 = time.time()
        group = cards == 1  # the card count's NCCL world is this one rank
        if group:
            dist.init_process_group("nccl", init_method=f"file://{root}/rdzv1", world_size=1,
                                    rank=0)
        try:
            bdc_cuda.launches = bdc_cuda.backward_launches = 0
            one = dry.run_scenarios(World(0, 1, torch.device("cuda", 0)),
                                    parallel_cells(root, "one"), PARALLEL_SCENARIOS)
            torch.cuda.synchronize()
            one["launches"] = (bdc_cuda.launches, bdc_cuda.backward_launches)
        finally:
            if group:
                dist.destroy_process_group()
        label = "1 NCCL rank (the card count)" if group else "1 rank"
        f, b = parallel_report(label, [one], time.time() - t0, smi)
        forward, backward = forward + f, backward + b
        torch.cuda.empty_cache()  # the ranks below share this card's memory
        # two gloo ranks on card 0: the 2-rank arithmetic with both kernels
        t0 = time.time()
        gloo = dry.run_ranks(PARALLEL_RANKS, parallel_cells(root, "gloo", controls=True),
                             "cuda:0", "gloo", init_method=f"file://{root}/rdzv2",
                             timeout=PARALLEL_TIMEOUT_S, scenarios=PARALLEL_SCENARIOS)
        label = f"{PARALLEL_RANKS} gloo ranks sharing cuda:0 (the 2-rank arithmetic)"
        f, b = parallel_report(label, gloo, time.time() - t0, smi)
        forward, backward = forward + f, backward + b
        shares = gloo[0]["flagship_cell"]["collectives"]
        print(f"[parallel] {label}, {shares['other_calls']} small all-reduces a step (the "
              f"BatchNorm moments forward and backward, the loss mean) and one over every "
              f"gradient, each timed between device syncs over 3 more steps: step "
              f"{shares['step_ms']:.1f} ms, gradient all-reduce {shares['grad_ms']:.1f} ms "
              f"({100 * shares['grad_ms'] / shares['step_ms']:.1f} %), the small ones "
              f"{shares['other_ms']:.1f} ms ({100 * shares['other_ms'] / shares['step_ms']:.1f} "
              f"%); {smi}", flush=True)
        parallel_compare(label, gloo[0], one)
        for n in sorted({cards, PARALLEL_RANKS}) if cards > 1 else ():
            t0 = time.time()
            nccl = dry.run_ranks(n, parallel_cells(root, f"nccl{n}"), "cuda", "nccl",
                                 init_method=f"file://{root}/rdzv_nccl{n}",
                                 timeout=PARALLEL_TIMEOUT_S, scenarios=PARALLEL_SCENARIOS)
            label = f"{n} NCCL ranks, one a card"
            f, b = parallel_report(label, nccl, time.time() - t0, smi)
            forward, backward = forward + f, backward + b
            shares = nccl[0]["flagship_cell"]["collectives"]
            print(f"[parallel] {label}: step {shares['step_ms']:.1f} ms, gradient all-reduce "
                  f"{shares['grad_ms']:.1f} ms, the {shares['other_calls']} small ones "
                  f"{shares['other_ms']:.1f} ms (timed between syncs); {smi}", flush=True)
            parallel_compare(label, nccl[0], one)
    print(f"[parallel] phase 25 wall {time.time() - t_phase:.1f} s; BDC launches: forward "
          f"{forward}, backward {backward}", flush=True)
    print(flush=True)
    return forward, backward


def audio_root(root: str, classes: int, clips: int, seed: int, samples=None) -> str:
    """A root of ``classes`` x ``clips`` waveforms made from ``seed``: a
    sine at a class frequency in noise.  With ``samples``: 1-D float32
    ``.npy`` clips of that length at 48 kHz; else 2 to 4 s clips, wav (PCM
    int16 at 16, 22.05 or 48 kHz) and ``.npy`` (float32 at 48 kHz) in turn."""
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    for c in range(classes):
        cdir = os.path.join(root, f"class_{c:02d}")
        os.makedirs(cdir)
        for k in range(clips):
            rate = 48000 if samples or k % 2 else (16000, 22050, 48000)[k // 2 % 3]
            n = samples or int(rng.uniform(2.0, 4.0) * rate)
            t = np.arange(n) / rate
            x = (0.3 * np.sin(2 * np.pi * (220.0 * (c + 1)) * t)
                 + 0.1 * rng.normal(size=n)).astype(np.float32)
            if samples or k % 2:
                np.save(os.path.join(cdir, f"clip_{k:02d}.npy"), x)
            else:
                with wave.open(os.path.join(cdir, f"clip_{k:02d}.wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(rate)
                    w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return root


def clap_phase() -> None:
    """Phase 24: the CLAP path on the card, NOT shipped traffic.  (a) the
    extraction CLI on a root of wav and npy clips with the full-width
    random-init HTSAT-tiny (10 s windows at 48 kHz): clips/s, peak memory,
    unit norms, eight clips' float32 embeddings card vs CPU; (b) ProtoNet on
    ``CLAPEmbeddingBackbone`` over them, one eval epoch; (c) ProtoNet with
    ``is_clap`` on a root of 1-D waveforms of 480 000 samples, one eval epoch
    at phase 15's cut and one training epoch at phase 13's; (d) the encoder
    saved with ``save_params`` and trained one step through ``Trainer``
    from its ``checkpoint_path``, the loaded weights held equal to the saved
    ones.  BDC launches 0."""
    import glob

    import numpy as np
    import torch

    from audio_fewshot_tpu_torch import extract_clap_embeddings as cli
    from audio_fewshot_tpu_torch import train
    from audio_fewshot_tpu_torch.eval import slice_config
    from audio_fewshot_tpu_torch.models.backbones.clap_encoder import (
        CLAPAudioEncoder, fit_waveform, resample_linear, save_params)
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    t_phase = time.time()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        # -- (a) the extraction CLI ---------------------------------------------------------
        audio = audio_root(os.path.join(root, "audio"), CLAP_CLASSES, CLAP_CLIPS, seed=0)
        emb_root = os.path.join(root, "embeddings")
        stats = cli.main(["--audio_root", audio, "--out", emb_root, "--allow-random-init",
                          "--batch", str(CLAP_CLI_BATCH)])
        files = sorted(glob.glob(os.path.join(emb_root, "*", "*.npy")))
        embs = np.stack([np.load(f) for f in files])
        norms = np.linalg.norm(embs, axis=-1)
        print(f"[clap-a] extract_clap_embeddings on the card: {stats['clips']} clips (wav int16 "
              f"at 16 / 22.05 / 48 kHz and npy at 48 kHz, 2-4 s, tiled to 10 s at 48 kHz), "
              f"HTSAT-tiny at full width (random init, seed 0; bf16 body), batches of "
              f"{CLAP_CLI_BATCH}: {stats['clips'] / stats['seconds']:.2f} clips/s over "
              f"{stats['seconds']:.1f} s (host reads and resamples included), peak memory "
              f"{stats['peak_gib']:.2f} GiB; {len(files)} files {embs.shape[1:]} float32, "
              f"norms {norms.min():.6f} .. {norms.max():.6f} (limit 1 ± 1e-3)", flush=True)
        if not (len(files) == stats["clips"] == CLAP_CLASSES * CLAP_CLIPS
                and embs.shape[1:] == (512,) and np.abs(norms - 1).max() <= 1e-3):
            raise AssertionError(f"extraction: {len(files)} files, shape {embs.shape}, norms "
                                 f"{norms.min()} .. {norms.max()}")
        waves = []
        for f in sorted(os.listdir(os.path.join(audio, "class_00")))[:CLAP_CPU_CLIPS]:
            path = os.path.join(audio, "class_00", f)
            x, sr = cli.read_wav(path) if f.endswith(".wav") else (np.load(path), 48000)
            waves.append(fit_waveform(resample_linear(x, sr)))
        waves = torch.from_numpy(np.stack(waves))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        init_seed(0)
        enc_cpu = CLAPAudioEncoder(dtype=torch.float32).eval()
        enc_gpu = copy.deepcopy(enc_cpu).to("cuda")
        with torch.no_grad():
            on_gpu = enc_gpu(waves.to("cuda")).cpu()
            on_cpu = enc_cpu(waves)
        rel = ((on_gpu - on_cpu).abs().max() / on_cpu.abs().max()).item()
        bf16_gap = np.abs(on_gpu.numpy() - embs[:CLAP_CPU_CLIPS]).max()
        print(f"[clap-a] {CLAP_CPU_CLIPS} clips' float32 embeddings {tuple(on_gpu.shape)}: card "
              f"vs CPU max|Δ|/max|emb| {rel:.3e} (limit {LOGIT_REL_LIMIT:g}); the CLI's bf16 "
              f"body {bf16_gap:.3e} from the float32 card (not a limit)", flush=True)
        if not (torch.isfinite(on_gpu).all() and rel <= LOGIT_REL_LIMIT):
            raise AssertionError("float32 CLAP embeddings disagree on the card and the CPU")
        del enc_gpu, enc_cpu
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True

        # -- (b) ProtoNet on the extracted embeddings ----------------------------------------
        bcfg = slice_config(classifier="ProtoNet:CLAPEmbeddingBackbone", **RESNET_EVAL_CUT)
        bcfg["data_root"] = emb_root
        eps, ms, peak_gib, acc, launches = run_test(bcfg)
        print(f"[clap-b] {bcfg['tag']} over the {len(files)} embeddings ({CLAP_CLASSES} classes "
              f"in every split), {bcfg['test_episode_size']} episodes a step, one epoch of "
              f"{bcfg['test_episode']}: accuracy {acc:.3f}, eval eps/s "
              f"{[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak memory {peak_gib:.2f} "
              f"GiB, BDC launches {launches} (expected (0, 0))", flush=True)
        if not math.isfinite(acc) or any(launches):
            raise AssertionError(f"ProtoNet on CLAP embeddings: accuracy {acc}, BDC {launches}")

        # -- (c) is_clap on 1-D waveforms ----------------------------------------------------
        wave_root = audio_root(os.path.join(root, "waves"), CLAP_CLASSES, CLAP_CLIPS, seed=1,
                               samples=480_000)
        ccfg = slice_config(classifier="ProtoNet:is_clap", **RESNET_EVAL_CUT)
        ccfg["data_root"] = wave_root
        eps, ms, peak_gib, acc, launches = run_test(ccfg)
        print(f"[clap-c] {ccfg['tag']} (the random-init HTSAT-tiny in place of Conv64F; bf16 "
              f"body) on {CLAP_CLASSES} x {CLAP_CLIPS} 1-D waveforms of 480000 samples, "
              f"{ccfg['test_episode_size']} episodes a step, one epoch of "
              f"{ccfg['test_episode']}: accuracy {acc:.3f}, eval eps/s "
              f"{[round(r, 2) for r in eps]}, {ms:.1f} ms a step, peak memory {peak_gib:.2f} "
              f"GiB, BDC launches {launches} (expected (0, 0))", flush=True)
        if not math.isfinite(acc) or any(launches):
            raise AssertionError(f"is_clap eval: accuracy {acc}, BDC launches {launches}")
        torch.cuda.empty_cache()
        tcfg = train.slice_config(os.path.join(root, "results"), classifier="ProtoNet:is_clap",
                                  **HEAD_TRAIN_CUT)
        # waveforms: no spectrogram augmentation or statistics, and every
        # class of the root in every split (no KOS split file)
        tcfg.update(data_root=wave_root, augment=False, mean_std_file=None,
                    class_per_split=None)
        rows, peak_gib, launches = run_trainer(tcfg)
        for r in rows:
            print(f"[clap-c] {tcfg['tag']} training, bf16 body, one episode a step (75 "
                  f"waveforms), epoch {r['epoch']} of {r['train_eps_count']} steps: "
                  f"{r['train_eps']:.2f} train eps/s, step {r['step_ms']:.1f} ms, loss "
                  f"{r['train_losses'][0]:.4f} -> {r['train_losses'][-1]:.4f}, val acc "
                  f"{r['val_acc']:.3f}, test acc {r['test_acc']:.3f}; peak memory "
                  f"{peak_gib:.2f} GiB; BDC launches {launches} (expected (0, 0))", flush=True)
        if any(launches):
            raise AssertionError(f"is_clap training: BDC launches {launches}")
        torch.cuda.empty_cache()

        # -- (d) checkpoint_path -----------------------------------------------------------
        init_seed(1)
        saved = CLAPAudioEncoder()
        ckpt = os.path.join(root, "clap.npz")
        save_params(ckpt, saved)
        dcfg = copy.deepcopy(tcfg)
        dcfg["backbone"]["kwargs"]["checkpoint_path"] = ckpt
        dcfg.update(result_root=os.path.join(root, "results_ckpt"), train_episode=1,
                    test_episode=16, test_episode_size=16)
        trainer = train.Trainer(0, dcfg, device="cuda")
        own = trainer.method.emb_func.state_dict()
        same = set(own) == set(saved.state_dict()) and all(
            torch.equal(own[k].cpu(), v) for k, v in saved.state_dict().items())
        trainer.train_loop()
        loss = trainer.history[0]["train_losses"]
        print(f"[clap-d] save_params -> {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB npz -> "
              f"Trainer with backbone.kwargs.checkpoint_path: loaded weights equal the saved "
              f"ones {same}; one train step, loss {loss}", flush=True)
        if not (same and len(loss) == 1 and math.isfinite(loss[0])):
            raise AssertionError("the CLAP checkpoint did not load, or its train step failed")
        del trainer
    torch.cuda.empty_cache()
    print(f"[clap] phase 24 wall {time.time() - t_phase:.1f} s; BDC launches 0", flush=True)
    print(flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from audio_fewshot_tpu_torch.data import get_dataloader
    from audio_fewshot_tpu_torch.episode import EpisodeBatch
    from audio_fewshot_tpu_torch.eval import Test, slice_config
    from audio_fewshot_tpu_torch.models import build_method, eval_setting
    from audio_fewshot_tpu_torch.ops import bdc_cuda
    from audio_fewshot_tpu_torch.ops.bdc import (
        bdc_from_gram, bdc_pool, bdc_pool_triu_vjp, bdc_pool_triu_vjp_cluster,
        gram_split_tf32, triuvec)
    from audio_fewshot_tpu_torch import run_trainer_resume, train
    from audio_fewshot_tpu_torch.registry import CLASSIFIERS
    from audio_fewshot_tpu_torch.utils.checkpoint import LAST, load_last, save_model_best
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    # -- 1. versions and card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {kind}")
    print(f"nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -------------------------------------------------------------
    t0 = time.time()
    builds = {"bdc_pool": (bdc_cuda.library, bdc_cuda.library_path),
              "bdc_pool_backward": (bdc_cuda.backward_library, bdc_cuda.backward_library_path)}
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for future in [pool.submit(load) for load, _ in builds.values()]:
            future.result()
    print(f"[build] {', '.join(builds)} built (one nvcc each, in parallel) and "
          f"loaded in {time.time() - t0:.2f} s")
    for name, (_, path) in builds.items():
        report, spilled = ptxas_report(path().with_suffix(".log").read_text())
        for line in report:
            print(f"[build] {name}: {line}")
        if spilled or not report:
            raise AssertionError(f"{name} spills registers (or ptxas reported nothing): {spilled}")
    print("[build] bdc_pool dynamic shared memory asked at launch: " + ", ".join(
        f"d = {d}: {bdc_pool_smem_bytes(d)} B" for d in (16, 64, 128)))
    print(flush=True)

    # -- 3. kernel vs plain ---------------------------------------------------
    cfg = slice_config()
    setting = eval_setting(cfg)
    probe = next(iter(get_dataloader(cfg, "test")[0].epoch(0)))
    b_main = probe.support.shape[0] * (probe.support.shape[1] + probe.query.shape[1])
    m_main = (128 // 8) * (157 // 8)  # stage-4 map of a [1, 128, 157] segment
    del probe
    # phase 11's cell, and the batches it gives the kernel: its calibration
    # and test steps, and the augmented segments of its flagged clips
    ecfg = tta_cell()
    b_tta = set()
    for split in ("val", "test"):
        probe = next(iter(get_dataloader(ecfg, split)[0].epoch(0)))
        b_tta.add(probe.support.shape[0] * (probe.support.shape[1] + probe.query.shape[1]))
    tta_flagged = max(1, int(CLASSIFIERS.get("DeepBDC").ood_fraction
                             * math.prod(probe.query_target.shape)))
    tta_cap = min(ecfg["tta_segments_per_clip"], probe.query.shape[1])
    tta_augmented = tta_flagged * tta_cap * ecfg["num_augmentations"]
    del probe
    gen = torch.Generator(device="cuda").manual_seed(0)
    log_t = torch.full((1, 1), math.log(1.0 / (2.0 * m_main)), device="cuda")
    max_err = 0.0
    times = {}
    # (B, d, M, floats the base pointer is off a 16-byte boundary): an M that
    # is no multiple of 4 and the shifted pointer take the kernel's scalar
    # loads, the others its tensor-map loads; each path runs at every padded
    # d = 16, 32, ..., 128
    # timed, with the gram's bmm beside: the main path's two shapes, phase
    # 20's flat batch and phase 22's resnet18Bdc eval step (M = 80)
    timed = {(1200, m_main), (b_main, m_main), (FLAT_SHAPE[0], m_main),
             (b_main, M_RESNET18_BDC), (RANK_FLAT_SHAPE[0], m_main)}
    for b, d, m, shift in [
            (1200, 64, m_main, 0), (b_main, 64, m_main, 0), (FLAT_SHAPE[0], 64, m_main, 0),
            (*RANK_FLAT_SHAPE, 0),
            (b_main, 64, M_RESNET18_BDC, 0), (BDC18_TRAIN_SHAPE[0], 64, M_RESNET18_BDC, 0),
            *[(b, 64, m_main, 0) for b in sorted(b_tta | {tta_augmented})], (2, 16, 45, 0),
            (3, 100, 77, 0), (5, 128, 33, 0), (3, 128, 40, 0), (2, 100, 76, 0),
            (2, 96, 300, 0), (2, 80, 64, 0), (3, 48, 8, 0), (4, 32, 12, 0),
            (2, 16, 8, 0), (2, 64, m_main, 1), (2, 32, 13, 0), (2, 48, 9, 0),
            (2, 80, 65, 0), (2, 96, 301, 0)]:
        x = torch.randn((b * d * m + shift,), device="cuda", generator=gen)
        x = x[shift:].view(b, d, m)
        tri, full = bdc_cuda.bdc_pool_triu(x, log_t, return_full=True)
        ref = bdc_pool(x, log_t)
        torch.cuda.synchronize()
        err_tri = (tri - triuvec(ref)).abs().max().item()
        err_full = (full - ref).abs().max().item()
        print(f"[kernel] bdc_pool {(b, d, m)}{' off 16-byte alignment' if shift else ''}: "
              f"max_abs_err triu {err_tri:.3e} "
              f"full {err_full:.3e} (limit {ERR_LIMIT:g})")
        if not (err_tri <= ERR_LIMIT and err_full <= ERR_LIMIT):
            raise AssertionError(f"bdc_pool kernel disagrees with plain at {(b, d, m)}")
        max_err = max(max_err, err_tri, err_full)
        if m == M_RESNET18_BDC or (b, d, m) == RANK_FLAT_SHAPE:
            x64 = x.double()
            err64 = (full.double() - bdc_from_gram(torch.bmm(x64, x64.mT), log_t)).abs().max().item()
            what = ("phase 22's resnet18Bdc" if m == M_RESNET18_BDC
                    else "phase 25's DeepBDC_Pretrain shard a rank")
            print(f"[kernel] bdc_pool {(b, d, m)} ({what}): max_abs_err vs "
                  f"float64 {err64:.3e} (limit {ERR_LIMIT:g})")
            if not err64 <= ERR_LIMIT:
                raise AssertionError(f"bdc_pool kernel is off float64 at {(b, d, m)}")
            del x64
        del tri, full, ref
        if d == 64 and (b, m) in timed:
            # enough buffers that together they exceed the L2 cache twice over
            n_buf = max(1, math.ceil(2 * L2_BYTES / (4 * x.numel())))
            xs = [x] + [torch.randn((b, d, m), device="cuda", generator=gen)
                        for _ in range(n_buf - 1)]
            feed = rotating(xs)
            ms = time_ms(lambda: bdc_cuda.bdc_pool_triu(next(feed), log_t))
            plain_ms = time_ms(lambda: triuvec(bdc_pool(next(feed), log_t)))
            gram_ms = time_ms(lambda: torch.bmm(y := next(feed), y.mT))
            bound_ms, bound_by = bdc_bound_ms(b, d, m, peaks)
            times[(b, m)] = (ms, plain_ms, bound_ms, bound_by)
            print(f"[kernel] bdc_pool {(b, d, m)}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"over {n_buf} input buffer(s) in turn; "
                  "library: none (no single PyTorch call computes the BDC pool)")
            print(f"[kernel] context: torch.bmm(x, x.mT) alone, the gram and not "
                  f"the function, {gram_ms:.4f} ms")
            if (b, m) == (b_main, m_main):
                print(f"[kernel] context: a recorded constant, not measured in this "
                      f"run: before its redesign for Hopper the kernel took "
                      f"{BDC_POOL_MS_FIRST_DESIGN} ms at this shape on an NVIDIA "
                      f"H100 80GB HBM3 at 700 W")
            del xs, feed
        del x
    # the three adversarial inputs, both routes against float64 on the card
    base = torch.randn((64, 64, m_main), device="cuda", generator=gen)
    for case, x in adversarial_inputs(base, gen).items():
        tri, full = bdc_cuda.bdc_pool_triu(x, log_t, return_full=True)
        ref = bdc_pool(x, log_t)
        x64 = x.double()
        truth = bdc_from_gram(torch.bmm(x64, x64.mT), log_t)
        err_plain = max((tri - triuvec(ref)).abs().max().item(),
                        (full - ref).abs().max().item())
        err_kernel64 = (full.double() - truth).abs().max().item()
        err_plain64 = (ref.double() - truth).abs().max().item()
        # diagnosis only: the kernel's arithmetic in plain PyTorch.  If this
        # is off too the split is too coarse, if only the kernel is, it has a bug
        split = bdc_from_gram(gram_split_tf32(x), log_t)
        err_split64 = (split.double() - truth).abs().max().item()
        print(f"[kernel] bdc_pool {case} {tuple(x.shape)}: kernel vs plain "
              f"{err_plain:.3e}; vs float64: kernel {err_kernel64:.3e}, plain "
              f"{err_plain64:.3e}, split-TF32 emulation {err_split64:.3e} "
              f"(limit {ERR_LIMIT:g})")
        if not (err_plain <= ERR_LIMIT and err_kernel64 <= ERR_LIMIT):
            raise AssertionError(f"bdc_pool kernel is off on the {case} input")
        max_err = max(max_err, err_plain)
        del x, tri, full, ref, x64, truth, split
    del base
    print(flush=True)

    # -- 4. the slice ---------------------------------------------------------
    with tempfile.TemporaryDirectory() as result_path:
        init_seed(int(cfg["seed"]))
        save_model_best(result_path, build_method(cfg))  # random weights from the seed
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        t0 = time.time()
        test = Test(0, cfg, result_path, device="cuda")
        acc, ci = test.test_loop()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, eval_backward = bdc_cuda.launches, bdc_cuda.backward_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    th = test.method.uncertain_global_threshold
    n_epochs = int(cfg["test_epoch"])
    backbone_calls = len(test.val_loader[0]) + 1 + n_epochs * len(test.test_loader[0])
    print(f"[slice] accuracy {acc:.3f} ± {ci:.3f}, threshold {th}, "
          f"{wall:.1f} s wall (setup + calibration + warm-up + {n_epochs} epochs)")
    print(f"[slice] eps/s per epoch {[round(r, 2) for r in test.epoch_eps]}, "
          f"peak memory {peak_gib:.2f} GiB, bdc_pool launches {launches} "
          f"(backbone calls {backbone_calls}), batch of {b_main} segments")
    if not (math.isfinite(acc) and th is not None and math.isfinite(th)):
        raise AssertionError(f"non-finite slice result: acc {acc}, threshold {th}")
    if launches != backbone_calls or eval_backward:
        raise AssertionError(f"bdc_pool launched {launches} times, expected {backbone_calls}; "
                             f"bdc_pool_backward {eval_backward} times in evaluation")
    del test
    torch.cuda.empty_cache()
    print(flush=True)

    # -- 5. one float32 batch: card vs CPU -------------------------------------
    cfg32 = slice_config(precision="fp32")
    init_seed(int(cfg32["seed"]))
    method_cpu = build_method(cfg32).eval()
    method_gpu = copy.deepcopy(method_cpu).cuda()
    full_batch = next(iter(get_dataloader(cfg32, "test")[0].epoch(0)))
    g = 64  # episode 0 and its first 64 query segments (each scored alone)
    batch = EpisodeBatch(
        support=full_batch.support[:1], query=full_batch.query[:1, :g],
        query_clip=full_batch.query_clip[:1, :g], query_mask=full_batch.query_mask[:1, :g],
        support_target=full_batch.support_target[:1],
        query_target=full_batch.query_target[:1],
    )
    with torch.no_grad():
        on_gpu = method_gpu(batch.to("cuda"), setting).cpu()
        on_cpu = method_cpu(batch.to("cpu"), setting)
    rel = ((on_gpu - on_cpu).abs().max() / on_cpu.abs().max()).item()
    print(f"[fp32] segment logits {tuple(on_gpu.shape)}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement "
          f"{(on_gpu.argmax(-1) == on_cpu.argmax(-1)).float().mean().item():.4f}")
    if not (torch.isfinite(on_gpu).all() and rel <= LOGIT_REL_LIMIT):
        raise AssertionError("float32 card logits disagree with the CPU")
    print(flush=True)

    # -- 6. backward kernel vs plain -------------------------------------------
    bwd_err = 0.0
    bwd_times = None
    for b, d, m, shift in [
            (*TRAIN_SHAPE, 0), (*FLAT_SHAPE, 0), (*BDC18_TRAIN_SHAPE, 0), (*RANK_FLAT_SHAPE, 0),
            (2, 16, 45, 0),
            (3, 100, 77, 0), (5, 128, 33, 0),
            (3, 128, 40, 0), (2, 100, 76, 0), (2, 96, 300, 0), (2, 80, 64, 0),
            (3, 48, 8, 0), (4, 32, 12, 0), (2, 16, 8, 0), (2, 64, m_main, 1),
            (2, 32, 13, 0), (2, 48, 9, 0), (2, 80, 65, 0), (2, 96, 301, 0),
            # one element; clusters of 8, 2 and 1; slices walked in chunks
            (1, 64, m_main, 0), (7, 64, m_main, 0), (140, 16, 20, 0),
            (300, 32, 36, 0), (2, 64, 1200, 0), (3, 48, 1201, 0)]:
        x = torch.randn((b * d * m + shift,), device="cuda", generator=gen)
        x = x[shift:].view(b, d, m)
        gy = torch.randn((b, d * (d + 1) // 2), device="cuda", generator=gen)
        cluster = bdc_cuda.backward_library().bdc_pool_backward_cluster(b, m)
        lt = torch.full((1, 1), math.log(1.0 / (2.0 * m)), device="cuda")
        gx, gt = bdc_cuda.bdc_pool_triu_backward(x, lt, gy)
        px, pt = bdc_pool_triu_vjp(x, lt, gy)
        torch.cuda.synchronize()
        ex, et = rel_err(gx, px), rel_err(gt, pt)
        print(f"[backward] {(b, d, m)}{' off 16-byte alignment' if shift else ''}, "
              f"clusters of {cluster}: "
              f"kernel vs plain, relative to the max abs: x {ex:.3e}, log_t {et:.3e} "
              f"(limit {GRAD_REL_LIMIT:g}); max abs {(gx - px).abs().max().item():.3e}")
        if not (ex <= GRAD_REL_LIMIT and et <= GRAD_REL_LIMIT):
            raise AssertionError(f"bdc_pool_backward disagrees with plain at {(b, d, m)}")
        bwd_err = max(bwd_err, (gx - px).abs().max().item(), (gt - pt).abs().max().item())
        if (b, d, m) in (BDC18_TRAIN_SHAPE, RANK_FLAT_SHAPE):
            tx, tt = bdc_pool_triu_vjp(x.double(), lt.double(), gy.double())
            k64, p64 = max(rel_err(gx, tx), rel_err(gt, tt)), max(rel_err(px, tx), rel_err(pt, tt))
            what = ("phase 22's resnet18Bdc training" if (b, d, m) == BDC18_TRAIN_SHAPE
                    else "phase 25's DeepBDC_Pretrain shard a rank")
            print(f"[backward] {(b, d, m)} ({what}): vs float64, "
                  f"relative to the max abs: kernel {k64:.3e}, plain {p64:.3e} (limit "
                  f"{ERR_LIMIT:g} for the kernel)")
            if not k64 <= ERR_LIMIT:
                raise AssertionError(f"bdc_pool_backward is off float64 at {(b, d, m)}")
            del tx, tt
        if (b, d, m) in (TRAIN_SHAPE, FLAT_SHAPE, BDC18_TRAIN_SHAPE, RANK_FLAT_SHAPE):
            # deterministic: a second launch on the same input, the same bits
            gx2, gt2 = bdc_cuda.bdc_pool_triu_backward(x, lt, gy)
            if not (torch.equal(gx, gx2) and torch.equal(gt, gt2)):
                raise AssertionError("bdc_pool_backward gives other bits on a second launch")
            print(f"[backward] {(b, d, m)}: a second launch gives the same bits")
            del gx2, gt2
            n_buf = max(1, math.ceil(2 * L2_BYTES / (4 * (2 * x.numel() + gy.numel()))))
            pairs = [(x, gy)] + [
                (torch.randn((b, d, m), device="cuda", generator=gen),
                 torch.randn((b, d * (d + 1) // 2), device="cuda", generator=gen))
                for _ in range(n_buf - 1)]
            feed = rotating(pairs)

            def on_next(fn):
                xx, yy = next(feed)
                return fn(xx, lt, yy)

            ms = time_ms(lambda: on_next(bdc_cuda.bdc_pool_triu_backward))
            plain_ms = time_ms(lambda: on_next(bdc_pool_triu_vjp))
            # context: the card's time without the host's per-call work
            # (Python, ctypes, the tensor map) between calls
            graph_kernel_ms = graph_ms(lambda: on_next(bdc_cuda.bdc_pool_triu_backward))
            ls = [torch.randn((b, d, d), device="cuda", generator=gen) for _ in range(n_buf)]
            lfeed = rotating(list(zip(ls, [p[0] for p in pairs])))
            bmm_ms = time_ms(lambda: torch.bmm(*next(lfeed)))
            graph_bmm_ms = graph_ms(lambda: torch.bmm(*next(lfeed)))
            bound_ms, bound_by = bdc_backward_bound_ms(b, d, m, peaks)
            if (b, d, m) == TRAIN_SHAPE:
                bwd_times = (ms, plain_ms, bound_ms, bound_by)
            print(f"[backward] {(b, d, m)}, clusters of {cluster}: kernel {ms:.4f} ms, "
                  f"plain (autograd) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), eager calls over {n_buf} input buffer(s) in turn; "
                  "library: none (no single PyTorch call computes it)")
            print(f"[backward] context: torch.bmm(L, x), the [d, d] x [d, M] product "
                  f"alone, {bmm_ms:.4f} ms; as a CUDA graph of 20 calls: the wrapper "
                  f"(the kernel, the sum of the log_t partials) {graph_kernel_ms:.4f} ms, "
                  f"torch.bmm {graph_bmm_ms:.4f} ms")
            del pairs, feed, ls, lfeed
        del x, gy, gx, px
    # adversarial inputs: the plain version, through the gram, loses the
    # distance of nearly equal rows; the kernel sums squared differences
    base = torch.randn((64, 64, m_main), device="cuda", generator=gen)
    cases = adversarial_inputs(base, gen)
    zero = torch.relu(base)
    zero[:, 0] = 0.0
    zero[:, 9] = 0.0
    cases["zero_rows"] = zero
    lt = torch.full((1, 1), math.log(1.0 / (2.0 * m_main)), device="cuda")
    gy = torch.randn((64, 64 * 65 // 2), device="cuda", generator=gen)
    for case, x in cases.items():
        gx, gt = bdc_cuda.bdc_pool_triu_backward(x, lt, gy)
        px, pt = bdc_pool_triu_vjp(x, lt, gy)
        tx, tt = bdc_pool_triu_vjp(x.double(), lt.double(), gy.double())
        ex, et = bdc_pool_triu_vjp_cluster(  # diagnosis: the kernel's arithmetic
            x, lt, gy, cluster=bdc_cuda.backward_library().bdc_pool_backward_cluster(64, m_main))
        k64 = max(rel_err(gx, tx), rel_err(gt, tt))
        p64 = max(rel_err(px, tx), rel_err(pt, tt))
        e64 = max(rel_err(ex, tx), rel_err(et, tt))
        vs_plain = max(rel_err(gx, px), rel_err(gt, pt))
        print(f"[backward] {case} {tuple(x.shape)}: kernel vs plain {vs_plain:.3e}; vs "
              f"float64: kernel {k64:.3e}, plain {p64:.3e}, emulation {e64:.3e} "
              f"(limits: kernel {ERR_LIMIT:g} vs float64, {GRAD_REL_LIMIT:g} + plain's "
              "own error vs plain)")
        if not (k64 <= ERR_LIMIT and vs_plain <= GRAD_REL_LIMIT + p64):
            raise AssertionError(f"bdc_pool_backward is off on the {case} input")
        del gx, px, tx, ex
    del base, cases, zero
    torch.cuda.empty_cache()
    print(flush=True)

    # -- 7. training ------------------------------------------------------------
    with tempfile.TemporaryDirectory() as result_root:
        tcfg = train.slice_config(result_root)
        print("[train] deepbdc_5shot_iid_seed0 at full width, bf16, augment on; cut: "
              f"epoch 30 -> {tcfg['epoch']}, train_episode 1000 -> {tcfg['train_episode']}, "
              f"val/test episodes 600 -> {tcfg['test_episode']}, synthetic root; then one "
              "more epoch through the resume entry point")
        torch.backends.cudnn.allow_tf32 = True  # the bf16 run's own defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        t0 = time.time()
        trainer = train.Trainer(0, tcfg, device="cuda")
        trainer.train_loop()
        ckpt = os.path.join(trainer.ckpt_dir, LAST)
        saved = load_last(ckpt)
        resumed = run_trainer_resume.build_trainer(
            [trainer.result_dir, "--device", "cuda", "--epoch", str(tcfg["epoch"] + 1)])
        if resumed.start_epoch != tcfg["epoch"]:
            raise AssertionError(f"resumed at epoch {resumed.start_epoch}, not {tcfg['epoch']}")
        if resumed.scheduler.state_dict() != saved["scheduler"]:
            raise AssertionError("the resumed scheduler state is not the saved one")
        state = resumed.optimizer.state_dict()["state"]
        if len(state) != len(saved["optimizer"]["state"]) or any(
                not torch.equal(state[k]["exp_avg_sq"].cpu(), v["exp_avg_sq"])
                or int(state[k]["step"]) != int(v["step"])
                for k, v in saved["optimizer"]["state"].items()):
            raise AssertionError("the resumed optimizer state is not the saved one")
        resumed.train_loop()
        torch.cuda.synchronize()
        wall = time.time() - t0
        train_launches = bdc_cuda.launches
        train_backward = bdc_cuda.backward_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    history = trainer.history + resumed.history
    steps = sum(len(r["train_losses"]) for r in history)
    for r in history:
        print(f"[train] epoch {r['epoch']}: {r['train_eps']:.2f} train eps/s, step "
              f"{r['step_ms']:.1f} ms, loss {r['train_losses'][0]:.4f} -> "
              f"{r['train_losses'][-1]:.4f}, val acc {r['val_acc']:.3f} ± {r['val_ci']:.3f}, "
              f"test acc {r['test_acc']:.3f} ± {r['test_ci']:.3f}")
    first_loss, last_loss = history[0]["train_losses"][0], history[-1]["train_losses"][-1]
    print(f"[train] {steps} train steps of {TRAIN_SHAPE[0]} segments in {wall:.1f} s wall "
          f"(setup, val/test, checkpoints, resume included); loss first {first_loss:.4f}, "
          f"last {last_loss:.4f}; peak memory {peak_gib:.2f} GiB; launches: bdc_pool "
          f"{train_launches}, bdc_pool_backward {train_backward} (train steps {steps}); "
          f"resumed at epoch {resumed.start_epoch} with the saved optimizer and scheduler state")
    losses = [v for r in history for v in r["train_losses"]]
    accs = [r[k] for r in history for k in ("val_acc", "test_acc")]
    if not all(math.isfinite(v) for v in losses + accs):
        raise AssertionError("non-finite training loss or accuracy")
    if train_backward != steps or train_launches < steps:
        raise AssertionError(f"bdc_pool_backward launched {train_backward} times for "
                             f"{steps} train steps (bdc_pool {train_launches})")
    del trainer, resumed
    torch.cuda.empty_cache()
    print(flush=True)

    # -- 9. ProtoNet eval -------------------------------------------------------
    pcfg = slice_config(classifier="ProtoNet")
    with tempfile.TemporaryDirectory() as result_path:
        init_seed(int(pcfg["seed"]))
        save_model_best(result_path, build_method(pcfg))  # random weights from the seed
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        t0 = time.time()
        test = Test(0, pcfg, result_path, device="cuda")
        acc, ci = test.test_loop()
        torch.cuda.synchronize()
        wall = time.time() - t0
        proto_launches = (bdc_cuda.launches, bdc_cuda.backward_launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[proto-eval] proto_5shot_iid_seed0 at full width (Conv64F, 64 -> 1600 head), bf16, "
          f"{pcfg['test_episode_size']} episodes a step: accuracy {acc:.3f} ± {ci:.3f}, "
          f"{wall:.1f} s wall (setup + warm-up + {pcfg['test_epoch']} epochs)")
    print(f"[proto-eval] eps/s per epoch {[round(r, 2) for r in test.epoch_eps]}, peak memory "
          f"{peak_gib:.2f} GiB; launches bdc_pool {proto_launches[0]}, bdc_pool_backward "
          f"{proto_launches[1]} (expected 0)")
    if not math.isfinite(acc) or any(proto_launches):
        raise AssertionError(f"ProtoNet eval: accuracy {acc}, BDC launches {proto_launches}")
    del test
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg32 = slice_config(classifier="ProtoNet", precision="fp32")
    init_seed(int(pcfg32["seed"]))
    method_cpu = build_method(pcfg32).eval()
    method_gpu = copy.deepcopy(method_cpu).cuda()
    full_batch = next(iter(get_dataloader(pcfg32, "test")[0].epoch(0)))
    batch = EpisodeBatch(
        support=full_batch.support[:1], query=full_batch.query[:1, :g],
        query_clip=full_batch.query_clip[:1, :g], query_mask=full_batch.query_mask[:1, :g],
        support_target=full_batch.support_target[:1],
        query_target=full_batch.query_target[:1],
    )
    with torch.no_grad():
        on_gpu = method_gpu(batch.to("cuda"), eval_setting(pcfg32)).cpu()
        on_cpu = method_cpu(batch.to("cpu"), eval_setting(pcfg32))
    rel = ((on_gpu - on_cpu).abs().max() / on_cpu.abs().max()).item()
    print(f"[proto-eval] fp32 segment logits {tuple(on_gpu.shape)}: card vs CPU "
          f"max|Δ|/max|logit| {rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement "
          f"{(on_gpu.argmax(-1) == on_cpu.argmax(-1)).float().mean().item():.4f}")
    if not (torch.isfinite(on_gpu).all() and rel <= LOGIT_REL_LIMIT):
        raise AssertionError("float32 ProtoNet card logits disagree with the CPU")
    del method_cpu, method_gpu, full_batch, batch
    print(flush=True)

    # -- 10. ProtoNet training --------------------------------------------------
    with tempfile.TemporaryDirectory() as result_root:
        tcfg = train.slice_config(result_root, classifier="ProtoNet")
        print("[proto-train] proto_5shot_iid_seed0 at full width, bf16, augment on; cut: "
              f"epoch 30 -> {tcfg['epoch']}, train_episode 1000 -> {tcfg['train_episode']}, "
              f"val/test episodes 600 -> {tcfg['test_episode']}, synthetic root; then one "
              "more epoch through the resume entry point")
        torch.backends.cudnn.allow_tf32 = True  # the bf16 run's own defaults
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        t0 = time.time()
        trainer = train.Trainer(0, tcfg, device="cuda")
        trainer.train_loop()
        resumed = run_trainer_resume.build_trainer(
            [trainer.result_dir, "--device", "cuda", "--epoch", str(tcfg["epoch"] + 1)])
        if resumed.start_epoch != tcfg["epoch"]:
            raise AssertionError(f"ProtoNet resumed at epoch {resumed.start_epoch}, "
                                 f"not {tcfg['epoch']}")
        resumed.train_loop()
        torch.cuda.synchronize()
        wall = time.time() - t0
        proto_launches = (bdc_cuda.launches, bdc_cuda.backward_launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    history = trainer.history + resumed.history
    for r in history:
        print(f"[proto-train] epoch {r['epoch']}: {r['train_eps']:.2f} train eps/s, step "
              f"{r['step_ms']:.1f} ms, loss {r['train_losses'][0]:.4f} -> "
              f"{r['train_losses'][-1]:.4f}, val acc {r['val_acc']:.3f} ± {r['val_ci']:.3f}, "
              f"test acc {r['test_acc']:.3f} ± {r['test_ci']:.3f}")
    steps = sum(len(r["train_losses"]) for r in history)
    print(f"[proto-train] {steps} train steps of {TRAIN_SHAPE[0]} segments in {wall:.1f} s wall "
          f"(setup, val/test, checkpoints, resume included); peak memory {peak_gib:.2f} GiB; "
          f"launches bdc_pool {proto_launches[0]}, bdc_pool_backward {proto_launches[1]} "
          f"(expected 0); resumed at epoch {resumed.start_epoch}")
    values = [v for r in history for v in r["train_losses"]] + [
        r[k] for r in history for k in ("val_acc", "test_acc")]
    if not all(math.isfinite(v) for v in values) or any(proto_launches):
        raise AssertionError(f"ProtoNet training: non-finite loss or accuracy, or BDC "
                             f"launches {proto_launches}")
    del trainer, resumed
    torch.cuda.empty_cache()
    print(flush=True)

    # -- 11. DeepBDC eval with the energy-OOD TTA re-vote ------------------------
    with tempfile.TemporaryDirectory() as result_path:
        init_seed(int(ecfg["seed"]))
        save_model_best(result_path, build_method(ecfg))  # random weights from the seed
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        t0 = time.time()
        test = Test(0, ecfg, result_path, device="cuda")
        # what each TTA step did: its flagged clips (``ood_topk``'s output)
        # and the augmented segments it embedded (``embed_segments``' input)
        observed = []
        ood_topk, embed_segments = test.method.ood_topk, test.method.embed_segments

        def topk_spy(uncertains):
            top_idx = ood_topk(uncertains)
            observed.append([top_idx.shape[0], None])
            return top_idx

        def embed_spy(segments):
            observed[-1][1] = segments.shape[0]
            return embed_segments(segments)

        test.method.ood_topk, test.method.embed_segments = topk_spy, embed_spy
        acc, ci = test.test_loop()
        torch.cuda.synchronize()
        wall = time.time() - t0
        tta_launches = bdc_cuda.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = test.test_loader[0]
    # the val calibration steps, then the warm-up and each test step: the
    # episode batch and the augmented segments are two backbone calls
    expected = len(test.val_loader[0]) + 2 * (1 + len(per_step))
    print(f"[tta] deepbdc_5shot_iid_seed0 eval with enhance_classification_via_energy, bf16, "
          f"{ecfg['test_episode_size']} episodes a step, {ecfg['test_episode']} test episodes: "
          f"accuracy {acc:.3f} ± {ci:.3f}, {wall:.1f} s wall (setup + calibration + warm-up + "
          "1 epoch)")
    print(f"[tta] read from each of the {len(observed)} TTA steps (warm-up included): flagged "
          f"clips {sorted({k for k, _ in observed})}, augmented segments "
          f"{sorted({n for _, n in observed})} (expected {tta_flagged} and {tta_augmented}: "
          f"{tta_flagged} clips x {tta_cap} segments x {ecfg['num_augmentations']} copies); "
          f"TTA eps/s {[round(r, 2) for r in test.epoch_eps]}; peak memory {peak_gib:.2f} GiB")
    print(f"[tta] bdc_pool launches {tta_launches} (expected {expected}: calibration steps, "
          "then two backbone calls a TTA step)")
    if len(observed) != 1 + len(per_step) or any(
            o != [tta_flagged, tta_augmented] for o in observed):
        raise AssertionError(f"TTA steps flagged and augmented {observed}, expected "
                             f"{1 + len(per_step)} x {[tta_flagged, tta_augmented]}")
    if not (math.isfinite(acc) and 0.0 <= acc <= 100.0 and math.isfinite(ci)):
        raise AssertionError(f"TTA eval: accuracy {acc} ± {ci}")
    if tta_launches != expected:
        raise AssertionError(f"bdc_pool launched {tta_launches} times in the TTA phase, "
                             f"expected {expected}")
    del test
    torch.cuda.empty_cache()
    print(flush=True)

    metric_and_bpa_phases(ecfg, expected, g)
    resnet12_phases(g)
    vit_and_meta_phases(g)
    slice9_phase(g)
    pre_forward, pre_backward = slice10_phase(g)
    slice11_phase(g)
    r18_forward, r18_backward = slice12_phase()
    swin_phase()
    clap_phase()
    par_forward, par_backward = parallel_phase(smi)

    # -- 8. report --------------------------------------------------------------
    ms, plain_ms, bound_ms, bound_by = times[(b_main, m_main)]
    bms, bplain_ms, bbound_ms, bbound_by = bwd_times
    print(json.dumps({"kernels": [{
        "name": "bdc_pool",
        "route": "cuda",
        "source": "audio_fewshot_tpu_torch/csrc/bdc_pool.cu",
        "replaces": "audio_fewshot_tpu/ops/bdc_pallas.py:23",
        "launches": launches + pre_forward + r18_forward + par_forward,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "bdc_pool_backward",
        "route": "cuda",
        "source": "audio_fewshot_tpu_torch/csrc/bdc_pool_backward.cu",
        "replaces": "audio_fewshot_tpu/ops/bdc.py:23",
        "launches": train_backward + pre_backward + r18_backward + par_backward,
        "max_abs_err": bwd_err,
        "ms": bms,
        "plain_ms": bplain_ms,
        "bound_ms": bbound_ms,
        "bound_by": bbound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   (printed after phases 9-22, which run before it);
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
   one epoch of 256 test episodes: eval eps/s of the epoch, ms a step,
   peak memory, BDC launches (must be 0), and one float32 episode's logits
   on the card against the CPU;
13. their training: each through ``Trainer`` for one epoch of 20 episodes
   with 16 val and test episodes (finite losses, train eps/s, ms a step, peak
   memory, BDC launches 0); then RelationNet: its shipped config must raise
   its error on the card, and at ``maxpool_last2: false`` (NOT the shipped
   geometry) one float32 episode card vs CPU and one such training epoch;
14. BPA: ProtoNet with ``use_bpa`` at full width through ``Test`` at phase
   12's cut (transport over [support ‖ query] sets of 25 + the query
   bucket, 281 rows), one float32 episode card vs CPU; DeepBDC with ``use_bpa`` and the TTA
   re-vote at phase 11's cut, whose ``bdc_pool`` launches must be phase
   11's count;
15. the heads on the plain resnet12 (MetaBaseline, MetaBaselineKendall,
   FEAT, DSN on its flat 12800 features; FRN and CAN on its [640, 8, 9]
   map), each its shipped ``*_5shot_iid_seed0`` at full width through
   ``Test`` at one epoch of 64 test episodes (Kendall at one epoch of 32:
   its exact pair count takes seconds a step): eval eps/s of each epoch, ms a
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
   the CPU (with cuDNN's deterministic algorithms, in phase 18 too), and one
   training epoch at phase 13's cut;
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
   ``Test`` at phase 15's cut (one epoch of 64 test episodes, 16 a step:
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

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
# phase 13's cut of a training cell: 1 epoch of 20 episodes, 16 val and test
HEAD_TRAIN_CUT = {"epoch": 1, "train_episode": 20, "test_episode": 16}
# phases 12 and 14's eval cut: one test epoch of 256 episodes (16 steps of
# 16), so that its eps/s is read over many steps; a second such epoch
# repeated it within a few per cent and was cut to keep the script inside
# its time limit
EVAL_CUT = {"test_episode": 256, "test_epoch": 1}
# the resnet12-family eval cut of phases 15 and 20: one epoch of 64 test
# episodes, 4 steps of 16 (a step takes ≈ 0.6 s; phase 12's cut took 200 s
# of phase 15)
RESNET_EVAL_CUT = {"test_episode": 64, "test_epoch": 1}
# phases 15 and 16: the heads on the plain resnet12, with the map each sees
RESNET12_HEADS = ("MetaBaseline", "MetaBaselineKendall", "FEAT", "DSN", "FRN", "CAN")
_FLAT = "resnet12's [640, 4, 5] avg-pooled map, 12800 features"
RESNET12_MAPS = {"MetaBaseline": _FLAT, "MetaBaselineKendall": _FLAT, "FEAT": _FLAT,
                 "DSN": _FLAT, "FRN": "resnet12's [640, 8, 9] map",
                 "CAN": "resnet12's [640, 8, 9] map"}
# Kendall's exact eval counts 81.9 M channel pairs for each of 16 x 256
# queries and 5 prototypes: seconds a step, so a cut of its own
KENDALL_EVAL_CUT = {"test_episode": 32, "test_epoch": 1}
KENDALL_CPU_QUERIES = 16
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
# clips) with 16 val and test episodes, 4 a step (at 16 a step the passes'
# 4496 segments would set the cell's peak memory, not the flat steps)
FLAT_TRAIN_CUT = {"epoch": 1, "test_episode": 16}
FLAT_EVAL_EPISODES = 4
# a flat train step's loss card vs CPU over the first rows of the first batch
# (NOT the shipped 128: a resnet12 forward of 128 rows takes seconds on the CPU)
FLAT_CHECK_ROWS = 32
# phase 20's flat training batch through resnet12Bdc's BDC pool
FLAT_SHAPE = (128, 64, 304)
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
# phase 22's card-vs-CPU episodes take this many query segments (its
# backbones' float32 forwards on the host's CPU: 0.02 to 0.05 TFLOP a
# segment; WRN-28-10's ≈ 0.2, so fewer)
SLICE12_CPU_QUERIES = 16
WRN_CPU_QUERIES = 8
# resnet18Bdc's BDC pool: the [512, 8, 10] map of a [1, 128, 157] segment
M_RESNET18_BDC = 8 * 10
BDC18_TRAIN_SHAPE = (75, 64, M_RESNET18_BDC)

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

    init_seed(int(cfg["seed"]))
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

    init_seed(int(cfg["seed"]))
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
    for head in RESNET12_HEADS:
        t0 = time.time()
        cut = KENDALL_EVAL_CUT if head == "MetaBaselineKendall" else RESNET_EVAL_CUT
        hcfg = slice_config(classifier=head, **cut)
        eps, ms, peak_gib, acc, bdc_launches = run_test(hcfg)
        note = (" (Kendall's own cut: its exact pair count takes seconds a step, so "
                f"{cut['test_epoch']} epoch(s) of {cut['test_episode']} episodes)"
                if cut is KENDALL_EVAL_CUT else "")
        print(f"[resnet12-eval] {hcfg['tag']} at full width ({RESNET12_MAPS[head]}), bf16 "
              f"backbone, fp32 head, {hcfg['test_episode_size']} episodes a step, "
              f"{hcfg['test_epoch']} epochs of {hcfg['test_episode']} test episodes{note}: "
              f"accuracy {acc:.3f}, eval eps/s by epoch {[round(r, 2) for r in eps]}, "
              f"{ms:.1f} ms a step, peak memory {peak_gib:.2f} GiB, BDC launches "
              f"{bdc_launches} (expected 0)")
        if not math.isfinite(acc) or any(bdc_launches):
            raise AssertionError(f"{head} eval: accuracy {acc}, BDC launches {bdc_launches}")
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        gh = KENDALL_CPU_QUERIES if head == "MetaBaselineKendall" else g
        rel, agree, shape = card_vs_cpu(slice_config(classifier=head, precision="fp32"), gh)
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


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for a card-vs-CPU check of phases
    17-18.  The default convolution gradients accumulate in an order that
    varies between runs; MAML's 10 inner steps amplify that through conv1's
    weight gradient (a sum over 502 k positions that cancels to ~0.5 % of
    its terms): its fp32 logits read 2.0e-4 to 4.8e-4 from the CPU's over
    three runs on one NVIDIA H100, 1.58e-5 in every run with these
    algorithms."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


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
    with cudnn_deterministic():
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
    with cudnn_deterministic():
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
        with cudnn_deterministic():
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
    init_seed(int(cfg["seed"]))
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
    hcfg = slice_config(classifier=head, **(EVAL_CUT if conv else RESNET_EVAL_CUT))
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
    with cudnn_deterministic():
        rel, agree, shape = card_vs_cpu(slice_config(classifier=head, precision="fp32"), g)
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
    with cudnn_deterministic():
        rel, agree, shape = card_vs_cpu(scfg, g)
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


def renet_cells(g: int) -> None:
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
    hcfg = slice_config(classifier="RENet", **RESNET_EVAL_CUT)
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
    with cudnn_deterministic():
        rel, agree, shape = card_vs_cpu(slice_config(classifier="RENet", precision="fp32"), g)
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
        with cudnn_deterministic():
            loss_gpu, loss_cpu, loss_rel = loss_card_vs_cpu(lcfg, batch)
        print(f"[slice11-train] {cell} fp32 train step loss over the first "
              f"{'dual ' if len(loaders) > 1 else ''}batch (DropBlock off, NOT shipped): card "
              f"{loss_gpu:.6f}, CPU {loss_cpu:.6f}, |Δ|/|loss| {loss_rel:.3e} (limit "
              f"{LOGIT_REL_LIMIT:g})", flush=True)
        if not loss_rel <= LOGIT_REL_LIMIT:
            raise AssertionError(f"float32 {cell} train loss disagrees on the card and the CPU")
        torch.backends.cudnn.allow_tf32 = True
        with tempfile.TemporaryDirectory() as result_root:
            tcfg = train.slice_config(result_root, classifier=cell, **HEAD_TRAIN_CUT)
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


def one_step_cell(head: str, g: int) -> None:
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
    gh = KENDALL_CPU_QUERIES if head == "MetabaselineKendallPretrain" else g
    with cudnn_deterministic():
        rel, agree, shape = card_vs_cpu(slice_config(classifier=head, precision="fp32"), gh)
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
    renet_cells(g)
    for head in ("FRN_Pretrain", "S2M2"):
        (ef, eb), (tf, tb, *_), _ = slice10_cell(head, g, "slice11", SLICE11_FEATURES[head])
        if any((ef, eb, tf, tb)):
            raise AssertionError(f"{head}: BDC launches in phase 21")
    for head in ("MTLPretrain", "MetabaselineKendallPretrain"):
        one_step_cell(head, g)
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
    float32 episode card vs CPU (``SLICE12_CPU_QUERIES`` query segments,
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
    hcfg = slice_config(classifier=cell, **RESNET_EVAL_CUT)
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
    with cudnn_deterministic():
        rel, agree, shape = card_vs_cpu(ccfg, WRN_CPU_QUERIES if cell.endswith("WRN") else
                                        SLICE12_CPU_QUERIES)
    print(f"[slice12-eval] {cell} fp32 segment logits {shape}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}; cuDNN's deterministic algorithms{note}), "
          f"argmax agreement {agree:.4f}", flush=True)
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError(f"float32 {cell} card logits disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as result_root:
        tcfg = train.slice_config(result_root, classifier=cell, **HEAD_TRAIN_CUT)
        tcfg["test_episode_size"] = hcfg["test_episode_size"]
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
                                  test_episode=RESNET_EVAL_CUT["test_episode"])
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
        with cudnn_deterministic():
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
    ``SLICE12_CPU_QUERIES`` query segments (WRN's fewer).  Returns
    resnet18Bdc's BDC launches (forward, backward)."""
    import torch

    t_phase = time.time()
    forward = backward = 0
    for cell in SLICE12_CELLS:
        f, b = slice12_cell(cell)
        forward, backward = forward + f, backward + b
    for cell, what in SLICE12_FLAT.items():
        (ef, eb), (tf, tb, *_), _ = slice10_cell(cell, SLICE12_CPU_QUERIES, "slice12", what)
        if any((ef, eb, tf, tb)):
            raise AssertionError(f"{cell}: BDC launches in phase 22")
    ifsl_cycle(SLICE12_CPU_QUERIES)
    torch.cuda.empty_cache()
    print(f"[slice12] phase 22 wall {time.time() - t_phase:.1f} s; resnet18Bdc's BDC launches: "
          f"forward {forward}, backward {backward}", flush=True)
    print(flush=True)
    return forward, backward


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
    ecfg = slice_config(test_episode=32, test_epoch=1, test_episode_size=8)
    ecfg.update(enhance_classification_via_energy=True, num_augmentations=10,
                tta_segments_per_clip=6)
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
             (b_main, M_RESNET18_BDC)}
    for b, d, m, shift in [
            (1200, 64, m_main, 0), (b_main, 64, m_main, 0), (FLAT_SHAPE[0], 64, m_main, 0),
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
        if m == M_RESNET18_BDC:
            x64 = x.double()
            err64 = (full.double() - bdc_from_gram(torch.bmm(x64, x64.mT), log_t)).abs().max().item()
            print(f"[kernel] bdc_pool {(b, d, m)} (phase 22's resnet18Bdc): max_abs_err vs "
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
            (*TRAIN_SHAPE, 0), (*FLAT_SHAPE, 0), (*BDC18_TRAIN_SHAPE, 0), (2, 16, 45, 0),
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
        if (b, d, m) == BDC18_TRAIN_SHAPE:
            tx, tt = bdc_pool_triu_vjp(x.double(), lt.double(), gy.double())
            k64, p64 = max(rel_err(gx, tx), rel_err(gt, tt)), max(rel_err(px, tx), rel_err(pt, tt))
            print(f"[backward] {(b, d, m)} (phase 22's resnet18Bdc training): vs float64, "
                  f"relative to the max abs: kernel {k64:.3e}, plain {p64:.3e} (limit "
                  f"{ERR_LIMIT:g} for the kernel)")
            if not k64 <= ERR_LIMIT:
                raise AssertionError(f"bdc_pool_backward is off float64 at {(b, d, m)}")
            del tx, tt
        if (b, d, m) in (TRAIN_SHAPE, FLAT_SHAPE, BDC18_TRAIN_SHAPE):
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

    # -- 8. report --------------------------------------------------------------
    ms, plain_ms, bound_ms, bound_by = times[(b_main, m_main)]
    bms, bplain_ms, bbound_ms, bbound_by = bwd_times
    print(json.dumps({"kernels": [{
        "name": "bdc_pool",
        "route": "cuda",
        "source": "audio_fewshot_tpu_torch/csrc/bdc_pool.cu",
        "replaces": "audio_fewshot_tpu/ops/bdc_pallas.py:23",
        "launches": launches + pre_forward + r18_forward,
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
        "launches": train_backward + pre_backward + r18_backward,
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

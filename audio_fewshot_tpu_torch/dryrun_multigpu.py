"""Episode-parallel dry run over N ranks at tiny shapes (the port's
counterpart of ``__graft_entry__.dryrun_multichip``): one sharded step each
of ProtoNet/Conv64F training, a ragged ProtoNet eval with the majority
vote, flagship DeepBDC/resnet12Bdc training, RENet's dual (episodic + flat)
step, DeepBDC's energy-OOD TTA eval through ``Test``, a MAML outer step
(``torch.autograd.grad`` in its inner loop) and CPEANet on a small
VisionTransformer; flat (FINETUNING) steps of Baseline, MetabaselinePretrain
and S2M2 (its mixup partners from every rank), FEAT, MeTAL on both loss-net
paths, a ``Trainer``'s replicated eval of 3 episodes a step and IfslPretrain's
featuring pass, ``Test``'s replicated steps at 3 episodes a step, and two
steps of each of the 17 heads of ``HEAD_CELLS`` (the local-descriptor and
resnet12 episodic heads, LEO, VERSA, MTL, RelationNet, CAN, DMatchingNet)
with a ragged eval of RelationNet and VERSA, run over N ranks and over
one; every number the N-rank run gives must be the one-rank run's, up to
the order of its float32 sums (``mismatch``, ``COMPARED``).

    python -m audio_fewshot_tpu_torch.dryrun_multigpu --nproc 2 [--device cpu]

``--device cpu``: gloo ranks on the CPU; else one card a rank (NCCL), or
``--backend gloo --device cuda:0`` for ranks that share one card.  It prints
each scenario's ``mismatch`` against one rank and exits non-zero where the
results are not within ``--rtol`` / ``--atol`` of it.  ``run_ranks`` is the
same run from Python: the tests and ``chip_smoke.py`` call it with cells of
their own (``SCENARIOS`` names the scenarios, and ``scenarios=`` adds a
caller's; each takes ``(world, **inputs)`` and returns CPU tensors and
numbers).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import datetime
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .config import Config
from .episode import (DualBatch, FlatBatch, make_dense_episode_batch,
                      pack_ragged_episode_batch)
from .eval import Test
from .models import build_method, eval_setting, train_setting
from .optim import build_optimizer
from .parallel import World, gather_rows, get_mesh, shard_batch, sharded_rows
from .parallel.launch import spawn
from .train import sharded_train_step
from .utils.checkpoint import save_model_best
from .utils.seed import init_seed

SPEC = (1, 24, 30)
_CONV64F_MAP = {"name": "Conv64F", "kwargs": {"is_flatten": False, "last_pool": False,
                                              "maxpool_last2": False, "num_channels": 1}}


def proto_config(**over) -> Dict[str, Any]:
    """The cell of the JAX package's mesh tests: ProtoNet on Conv64F's map,
    float32, 3-way 2-shot 2-query, SGD at lr 0.05, 8 episodes a step."""
    cfg = {"backbone": copy.deepcopy(_CONV64F_MAP),
           "classifier": {"name": "ProtoNet", "kwargs": None},
           "modality": "audio", "precision": "fp32", "way_num": 3, "shot_num": 2,
           "query_num": 2, "augment_times": 1, "episode_size": 8, "seed": 0,
           "spec_shape": list(SPEC),
           "optimizer": {"name": "SGD", "kwargs": {"lr": 0.05}}}
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


def episode_batches(n_steps: int, episodes: int = 8, spec=SPEC, seed: int = 0,
                    global_classes: int = 0) -> List[Any]:
    """``n_steps`` dense 3-way 2-shot 2-query host batches of normal draws
    (the JAX package's ``test_shard_equivalence._batches``); with
    ``global_classes`` also dataset-level targets."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        sup = rng.normal(size=(episodes, 6) + tuple(spec)).astype(np.float32)
        qry = rng.normal(size=(episodes, 6) + tuple(spec)).astype(np.float32)
        gt = (rng.integers(0, global_classes, size=(episodes, 12)).astype(np.int32)
              if global_classes else None)
        out.append(make_dense_episode_batch(sup, qry, 3, 2, 2, global_target=gt))
    return out


def _method(cfg: Dict[str, Any], state: Optional[str], device: torch.device):
    """The config's method (its seed's weights, or ``state``) on ``device``;
    float32 means float32 (no TF32), and cuDNN as ``deterministic`` says,
    as ``Trainer`` and ``Test`` set them."""
    if cfg.get("precision", "bf16") == "fp32":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    init_seed(int(cfg.get("seed", 0)), cfg.get("deterministic"))
    method = build_method(cfg)
    if state:
        method.load_state_dict(torch.load(state, map_location="cpu"))
    return method.to(device)


def _cpu_state(method) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in method.state_dict().items()}


def _train(world: World, cfg: Dict[str, Any], batches: Sequence[Any], state: Optional[str],
           eval_batch=None, prepare: Optional[Callable] = None) -> Dict[str, Any]:
    """``batches`` as train steps (each rank its shard): the losses, the
    state after the first step and after the last, then the eval-mode
    logits of ``eval_batch`` gathered over the ranks.  ``prepare(method)``
    runs on the built method first."""
    method = _method(cfg, state, world.device).train()
    if prepare is not None:
        prepare(method)
    optimizer = build_optimizer(cfg, method)
    setting = train_setting(cfg)
    losses, first = [], None
    for b in batches:
        losses.append(float(sharded_train_step(method, optimizer, shard_batch(b, world),
                                               setting, world)["loss"]))
        first = first or _cpu_state(method)
    out = {"losses": losses, "first_state": first, "state": _cpu_state(method)}
    if eval_batch is not None:
        method.eval()
        with torch.no_grad():
            logits = method(shard_batch(eval_batch, world), eval_setting(cfg))
        out["logits"] = gather_rows(logits, world).cpu()
    return out


# -- the scenarios ------------------------------------------------------------------------------

def proto_train(world: World, state=None, steps: int = 3) -> Dict[str, Any]:
    """ProtoNet/Conv64F: ``steps`` SGD steps, the losses, the parameters and
    statistics after them, and the eval logits of the first batch."""
    batches = episode_batches(steps)
    return _train(world, proto_config(), batches, state, eval_batch=batches[0])


def batchnorm(world: World) -> Dict[str, Any]:
    """A ``BatchNorm`` in train mode over rows sharded across the ranks,
    plain and masked: the output, the input's and the affine parameters'
    gradients (of a fixed random cotangent) and the running statistics."""
    from .models.backbones.layers import BatchNorm

    rng = np.random.default_rng(3)
    n = 8
    x_all = rng.normal(1.5, 2.0, size=(n, 4, 5, 6))
    cot_all = rng.normal(size=x_all.shape)
    mask_all = np.array([1, 0, 1, 1, 1, 1, 0, 1], dtype=bool)
    weight, bias = rng.normal(1.0, 0.2, size=4), rng.normal(0.0, 0.2, size=4)
    rows = world.rows(n)
    out: Dict[str, Any] = {}
    for name, mask in (("plain", None), ("masked", mask_all)):
        bn = BatchNorm(4).to(world.device).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(weight))
            bn.bias.copy_(torch.from_numpy(bias))
        x = torch.from_numpy(x_all[rows]).to(world.device, torch.float32).requires_grad_()
        m = None if mask is None else torch.from_numpy(mask[rows]).to(world.device)
        with sharded_rows():
            y = bn(x, m)
        (y * torch.from_numpy(cot_all[rows]).to(y)).sum().backward()
        # each rank holds its rows' share of the affine gradients: sum them
        affine = torch.cat([bn.weight.grad, bn.bias.grad])
        if world.size > 1:
            dist.all_reduce(affine)
        out[name] = {"y": gather_rows(y.detach(), world).cpu(),
                     "dx": gather_rows(x.grad, world).cpu(), "d_affine": affine.cpu(),
                     "running_mean": bn.running_mean.cpu(), "running_var": bn.running_var.cpu()}
    return out


def ragged_eval(world: World, state=None) -> Dict[str, Any]:
    """ProtoNet's eval of a ragged batch (clips of 1-2 segments, G = 16)
    with the majority vote: the per-episode accuracies, in rank order."""
    cfg = proto_config()
    rng = np.random.default_rng(5)
    e = 8
    repeats = rng.integers(1, 3, size=(e * 6,))
    sup = rng.normal(size=(e, 6) + SPEC).astype(np.float32)
    segs = rng.normal(size=(int(repeats.sum()),) + SPEC).astype(np.float32)
    batch = pack_ragged_episode_batch(sup, segs, repeats, 3, 2, 2, bucket_sizes=(16,))
    method = _method(cfg, state, world.device).eval()
    with torch.no_grad():
        local = shard_batch(batch, world)
        acc = method.eval_episode_accuracy(method(local, eval_setting(cfg)), local)
    return {"episode_accs": gather_rows(acc, world).cpu()}


def flagship_train(world: World, state=None, steps: int = 2) -> Dict[str, Any]:
    """DeepBDC/resnet12Bdc (``reduce_dim`` 8) at [1, 24, 30], 8 episodes a
    step: the losses and the parameters after ``steps`` steps."""
    cfg = proto_config(
        classifier={"name": "DeepBDC", "kwargs": None},
        backbone={"name": "resnet12Bdc", "kwargs": {"num_channels": 1, "reduce_dim": 8}})
    return _train(world, cfg, episode_batches(steps, seed=2), state)


def renet_config(**over) -> Dict[str, Any]:
    return proto_config(classifier={"name": "RENet", "kwargs": {"feat_dim": 64,
                                                                "num_class": 6}},
                        dataloader_num=2, batch_size=16, **over)


def dual_batches(n_steps: int, seed: int = 1) -> List[Any]:
    """RENet's dual steps: 8 episodes with dataset-level targets and a flat
    batch of 16 (the JAX package's ``_renet_dual_batches``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        sup = rng.normal(size=(8, 6) + SPEC).astype(np.float32)
        qry = rng.normal(size=(8, 6) + SPEC).astype(np.float32)
        gt = rng.integers(0, 6, size=(8, 12)).astype(np.int32)
        ep = make_dense_episode_batch(sup, qry, 3, 2, 2, global_target=gt)
        flat = FlatBatch(data=rng.normal(size=(16,) + SPEC).astype(np.float32),
                         target=rng.integers(0, 6, size=(16,)).astype(np.int32))
        out.append(DualBatch(episode=ep, flat=flat))
    return out


def dual_train(world: World, state=None, steps: int = 2) -> Dict[str, Any]:
    """RENet's dual step (``dataloader_num: 2``): both halves sharded, the
    SCR and backbone statistics over every rank's rows, CCA per episode."""
    return _train(world, renet_config(), dual_batches(steps), state)


def maml_config(**over) -> Dict[str, Any]:
    return proto_config(classifier={"name": "MAML", "kwargs": {
        "inner_param": {"lr": 0.01, "train_iter": 2, "test_iter": 2}}}, **over)


def maml_train(world: World, state=None, steps: int = 1) -> Dict[str, Any]:
    """One MAML outer step: second-order inner loops of ``autograd.grad``
    per episode, the outer gradients averaged over the ranks."""
    return _train(world, maml_config(), episode_batches(steps), state)


def cpea_config(**over) -> Dict[str, Any]:
    return proto_config(
        classifier={"name": "CPEANet", "kwargs": {"in_dim": 32}},
        backbone={"name": "VisionTransformer", "kwargs": {
            "patch_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 2, "mlp_ratio": 2.0,
            "num_channels": 1}}, spec_shape=[1, 24, 32], **over)


def cpea_train(world: World, state=None, steps: int = 1) -> Dict[str, Any]:
    """CPEANet on a depth-2 VisionTransformer at [1, 24, 32]."""
    return _train(world, cpea_config(), episode_batches(steps, spec=(1, 24, 32)), state)


#: the other heads ``MethodBase.shardable`` admits, on the cell's Conv64F map
HEADS = {
    "MetaBaseline": {"name": "MetaBaseline", "kwargs": None},
    "R2D2": {"name": "R2D2", "kwargs": None},
    "ANIL": {"name": "ANIL", "kwargs": {"inner_param": {"lr": 0.01, "train_iter": 2,
                                                        "test_iter": 2}}},
    "BOIL": {"name": "BOIL", "kwargs": {"inner_param": {"extractor_lr": 0.01,
                                                        "classifier_lr": 0.01},
                                        "testing_method": "NIL"}},
}


def head_step(world: World, head: str, steps: int = 2) -> Dict[str, Any]:
    """``steps`` SGD steps of a head of ``HEADS`` on the cell: the losses
    and the state after the first step."""
    return _train(world, proto_config(classifier=copy.deepcopy(HEADS[head])),
                  episode_batches(steps, seed=4), None)


#: the flat (FINETUNING) heads on the cell's Conv64F map (384 features),
#: 6 train classes; DeepBDC_Pretrain on resnet12Bdc at ``reduce_dim`` 8
FLAT_HEADS = ("Baseline", "BaselinePlus", "NegNet", "RFSModel", "SKDModel",
              "MetabaselinePretrain", "FEAT_Pretrain", "DeepBDC_Pretrain", "FRN_Pretrain",
              "MTLPretrain", "MetabaselineKendallPretrain", "IfslPretrain", "S2M2")
FLAT_CLASSES = 6


def flat_config(head: str = "Baseline", **over) -> Dict[str, Any]:
    """``head`` on the cell (float32, SGD at lr 0.05), trained on flat
    batches of 8 rows of ``FLAT_CLASSES`` classes and evaluated 3-way 2-shot
    2-query (its eval adaptation cut to 3 steps)."""
    cfg = proto_config(classifier={"name": head, "kwargs": {
        "num_class": FLAT_CLASSES, "inner_param": {"inner_train_iter": 3,
                                                   "inner_batch_size": 4}}},
        batch_size=8)
    if head == "DeepBDC_Pretrain":
        cfg["backbone"] = {"name": "resnet12Bdc", "kwargs": {"num_channels": 1, "reduce_dim": 8}}
    cfg.update(over)
    return cfg


def flat_batches(n_steps: int, rows: int = 8, seed: int = 6) -> List[FlatBatch]:
    """``n_steps`` flat batches of ``rows`` normal draws on the cell's
    segments and targets among ``FLAT_CLASSES``."""
    rng = np.random.default_rng(seed)
    return [FlatBatch(data=rng.normal(size=(rows,) + SPEC).astype(np.float32),
                      target=rng.integers(0, FLAT_CLASSES, size=(rows,)).astype(np.int32))
            for _ in range(n_steps)]


def flat_train(world: World, head: str = "Baseline", state=None, steps: int = 2,
               evaluate: bool = False) -> Dict[str, Any]:
    """``steps`` flat SGD steps of 8 rows of a ``FLAT_HEADS`` head (4 a rank
    over 2): the losses and the state after the first step and after the
    last; with ``evaluate``, the eval logits of 8 episodes."""
    eval_batch = episode_batches(1, seed=7)[0] if evaluate else None
    return _train(world, flat_config(head), flat_batches(steps), state, eval_batch)


def pretrain_train(world: World, state=None) -> Dict[str, Any]:
    """MetabaselinePretrain: two flat steps and its cosine-prototype eval
    logits."""
    return flat_train(world, "MetabaselinePretrain", state, evaluate=True)


def s2m2_train(world: World, state=None, steps: int = 2) -> Dict[str, Any]:
    """S2M2's flat steps (input mixup over the whole batch, the four flips):
    the losses, the states and each step's mixed rows and partner targets,
    gathered in rank order."""
    mixed: List[torch.Tensor] = []

    def spy(method):
        mix = method.mix

        def recorded(x, y):
            lam, rows, partners = mix(x, y)
            mixed.append(torch.cat([gather_rows(rows, world).flatten(1),
                                    gather_rows(partners, world)[:, None].to(rows)], 1).cpu())
            return lam, rows, partners

        method.mix = recorded

    out = _train(world, flat_config("S2M2"), flat_batches(steps), state, prepare=spy)
    out["mixed"] = mixed
    return out


def _no_dropout(method) -> None:
    """Every Dropout of ``method`` the identity: over several ranks each
    rank draws masks of its own (``layers.seed_dropout``)."""
    from .models.backbones.layers import Dropout

    for m in method.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


FEAT = {"name": "FEAT", "kwargs": {"temperature": 1.0, "temperature2": 1.0, "balance": 0.5,
                                   "mode": "euclidean"}}


def metal_head(per_step: bool) -> Dict[str, Any]:
    """MeTAL with 2 inner steps, the default loss nets or ``per_step_adapters``
    (the JAX package's mesh tests' cell)."""
    return {"name": "MeTAL", "kwargs": {"inner_param": {
        "lr": 0.01, "train_iter": 2, "test_iter": 2, "per_step_adapters": per_step},
        "way_num": 3}}


#: FEAT's SGD learning rate: its first loss is 6.6 (euclidean logits of ~3e2
#: at temperature 1), and a step at the cell's 0.05 (or at 0.005) makes the
#: second step ill-conditioned: on one rank, input rows moved by 1e-7 of
#: themselves move the parameters after it by 0.95 of the limits at 0.005,
#: by 4e-4 of them at 5e-4
FEAT_LR = 5e-4


def feat_config(**over) -> Dict[str, Any]:
    """FEAT on the cell's map (its attention 384 wide) at SGD ``FEAT_LR``."""
    return proto_config(classifier=copy.deepcopy(FEAT),
                        optimizer={"name": "SGD", "kwargs": {"lr": FEAT_LR}}, **over)


def feat_train(world: World, state=None, steps: int = 2) -> Dict[str, Any]:
    """FEAT's two SGD steps of 8 episodes (Dropout the identity) and the
    eval logits."""
    batches = episode_batches(steps)
    return _train(world, feat_config(), batches, state, eval_batch=batches[0],
                  prepare=_no_dropout)


def metal_train(world: World, per_step: bool = False, state=None,
                steps: int = 2) -> Dict[str, Any]:
    """MeTAL on the cell (second-order inner loops of all episodes at once):
    two SGD steps and the eval logits, by default or ``per_step``."""
    batches = episode_batches(steps)
    return _train(world, proto_config(classifier=metal_head(per_step)), batches, state,
                  eval_batch=batches[0])


def trainer_config(root: str, head: str = "Baseline", **over) -> Dict[str, Any]:
    """A flat ``Trainer`` cell under ``root``: ``head`` on Conv64F's map at
    the cell's segments, a ``synthetic:4:4`` root (16 train clips: an epoch
    of 2 flat steps of 8), val and test 3 episodes of 3-way 2-shot 2-query
    (clips of up to 2 segments), one step each: 3 episodes do not split
    over 2 ranks."""
    cfg = flat_config(head, data_root="synthetic:4:4", result_root=root, epoch=1,
                      test_episode=3, test_episode_size=3, max_segments_per_clip=2,
                      segment_bucket_sizes=[16], prefetch=0, log_interval=1)
    cfg["classifier"]["kwargs"]["num_class"] = 4
    cfg.update(over)
    return cfg


@contextlib.contextmanager
def _no_tensorboard():
    """The ``Trainer``'s TensorBoard writer disabled on every rank (the dry
    run reads no event file, and importing tensorboard takes seconds)."""
    from . import train
    from .utils.meters import TensorboardWriter

    saved = train.TensorboardWriter
    train.TensorboardWriter = lambda log_dir, enabled=True: TensorboardWriter(log_dir, False)
    try:
        yield
    finally:
        train.TensorboardWriter = saved


def _trainer(world: World, cfg: Dict[str, Any], state: Optional[str] = None):
    from .train import Trainer

    with _no_tensorboard():
        trainer = Trainer(0, copy.deepcopy(cfg), device=world.device)
    if state:
        trainer.method.load_state_dict(torch.load(state, map_location="cpu"))
    _no_dropout(trainer.method)
    return trainer


def trainer_train(world: World, cfg: Dict[str, Any], state: Optional[str] = None
                  ) -> Dict[str, Any]:
    """``Trainer.train_loop`` of a cell (from ``state`` when given; Dropout
    the identity): each epoch's train losses and val / test accuracy."""
    trainer = _trainer(world, cfg, state)
    trainer.train_loop()
    return {"history": [{k: r[k] for k in ("train_losses", "val_acc", "test_acc")}
                        for r in trainer.history]}


def replicated_eval(world: World, root: str) -> Dict[str, Any]:
    """Baseline's val and test passes through ``Trainer._validate`` at 3
    episodes a step (replicated over 2 ranks): each pass's per-episode
    accuracies, mean and CI."""
    from . import train

    trainer = _trainer(world, trainer_config(root))
    accs: List[List[float]] = []
    summary = train.mean_confidence_interval

    def recorded(values):
        accs.append(list(values))
        return summary(values)

    train.mean_confidence_interval = recorded
    try:
        passes = [trainer._validate(0, trainer.val_loader[0], trainer.val_bank),
                  trainer._validate(0, trainer.test_loader[0], trainer.test_bank)]
    finally:
        train.mean_confidence_interval = summary
    return {"episode_accs": accs, "passes": passes}


def ifsl_featuring(world: World, root: str) -> Dict[str, Any]:
    """IfslPretrain's featuring pass (``Trainer.run_featuring``) on the
    cell's root: the per-class sums and counts over the epoch's flat
    batches (each rank's shard, added over the ranks) and the saved
    means."""
    cfg = trainer_config(root, "IfslPretrain")
    feature_path = os.path.join(root, "ifsl_features.npy")
    cfg["classifier"]["kwargs"]["ifsl_pretrain_param"] = {
        "norm": True, "featuring": True, "feature_path": feature_path}
    trainer = _trainer(world, cfg)
    sums, counts, steps = trainer.featuring_sums()
    trainer.run_featuring()
    if world.size > 1:
        dist.barrier()  # rank 0 has written the means
    return {"sums": sums.cpu(), "counts": counts.cpu(), "steps": steps,
            "means": torch.from_numpy(np.load(feature_path))}


def tta_config(root: str = "synthetic:10:12", **over) -> Dict[str, Any]:
    """A small DeepBDC eval with the energy-OOD TTA (``reduce_dim`` 8,
    [1, 32, 40], 5-way 5-shot 3-query, ragged clips of up to 3 segments, 4
    episodes a step)."""
    cfg = {"classifier": {"name": "DeepBDC", "kwargs": None},
           "backbone": {"name": "resnet12Bdc", "kwargs": {"num_channels": 1, "reduce_dim": 8}},
           "data_root": root, "spec_shape": [1, 32, 40], "way_num": 5, "shot_num": 5,
           "query_num": 3, "test_episode": 8, "test_episode_size": 4, "test_epoch": 1,
           "max_segments_per_clip": 3, "segment_bucket_sizes": [48], "precision": "fp32",
           "seed": 0, "prefetch": 0, "enhance_classification_via_energy": True,
           "num_augmentations": 3}
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


def tta_eval(world: World, cfg=None, result_path: Optional[str] = None) -> Dict[str, Any]:
    """DeepBDC's eval through ``Test`` with the TTA: the calibration
    threshold, each step's flagged clips (the whole step's, on every rank)
    and the per-episode accuracies."""
    cfg = cfg or tta_config()
    test = Test(0, copy.deepcopy(cfg), result_path, device=world.device)
    flagged: List[torch.Tensor] = []
    topk = test.method.ood_topk

    def spy(uncertains):
        idx = topk(uncertains)
        flagged.append(idx.cpu())
        return idx

    test.method.ood_topk = spy
    mean, ci = test.test_loop()
    return {"threshold": test.method.uncertain_global_threshold, "flagged": flagged,
            "episode_accs": test.episode_accs, "mean": mean, "ci": ci,
            "eps": test.epoch_eps}


def replicated_test(world: World, root: str) -> Dict[str, Any]:
    """ProtoNet's ``Test`` on a ``synthetic:4:4`` root at 3 episodes a step
    (2 steps; 3 do not split over 2 ranks, so they run replicated): the
    per-episode accuracies, the mean and the CI."""
    cfg = proto_config(data_root="synthetic:4:4", result_root=root, test_episode=6,
                       test_episode_size=3, test_epoch=1, max_segments_per_clip=2,
                       segment_bucket_sizes=[16], prefetch=0)
    test = Test(0, cfg, None, device=world.device)
    mean, ci = test.test_loop()
    return {"episode_accs": test.episode_accs, "mean": mean, "ci": ci,
            "replicated": test.replicated}


# -- the heads audited for ranks last -----------------------------------------------------------

def _resnet12(keep_map: bool = False) -> Dict[str, Any]:
    """The port's resnet12 tests' narrow resnet12 (planes 8/12/16/20; no
    Dropout or DropBlock, whose masks each rank draws for itself): a [20, 1,
    1] map at the cell's segments, flat or kept."""
    kwargs = {"num_channels": 1, "planes": [8, 12, 16, 20], "drop_rate": 0.0}
    if keep_map:
        kwargs.update(is_flatten=False, avg_pool=False)
    return {"name": "resnet12", "kwargs": kwargs}


#: RelationNet's segments: its two 3 x 3 VALID convs and pools need a map of
#: 8 x 8 or more (Conv64F's [64, 8, 8] here; the cell's 2 x 3 leaves none)
RELATION_SPEC = (1, 72, 72)
#: CAN's global classes (its global cross-entropy's targets)
CAN_CLASSES = 6
#: ADM_KL's SGD learning rate: its KL of 6 descriptors' near-singular 64 x
#: 64 covariances starts at a loss of 65.5; on one rank, support rows moved
#: by 1e-7 of themselves move the second step's loss by 3.7e-5 at
#: ``FEAT_LR`` (the limit is 2e-5), by 6.2e-6 at 5e-5
ADM_KL_LR = 5e-5
#: RelationNet's: the JAX package's float32 step over 1 device and over 2
#: (flax's one-pass BatchNorm variance) leaves parameters 1.5 times the
#: limits apart after two steps at 0.05
RELATION_LR = 5e-3
#: the 17 heads audited for ranks last, each on the cell (3-way 2-shot
#: 2-query, float32, SGD at lr 0.05) with what it needs: the cell's Conv64F
#: map (DSN, FRN, MetaBaselineKendall and MTL on ``_resnet12``; DMatchingNet
#: on its flat logits head, whose BatchNorm1d keeps running statistics), inner loops
#: of 2 steps, VERSA at 4 samples of 32 (its Dropout, and ConvMNet's, the
#: identity: drawn per rank), LEO's latent at 16; FRN and
#: MetaBaselineKendall at SGD ``FEAT_LR``: at 0.05, on one rank, support rows
#: moved by 1e-7 of themselves move the state after the second step by 11.5
#: and 7.9 times the limits (ADM_KL's by 3.8: ``ADM_KL_LR``); ConvMNet at
#: ``FEAT_LR`` too: its first loss is 15.5 (the softmax of covariance scores
#: in the hundreds saturates), and on an H100 2 ranks and 1 parted by 4.5
#: times the limits after two steps at 0.05 (0.05 times them on the CPU)
HEAD_CELLS: Dict[str, Dict[str, Any]] = {
    "DN4": {"classifier": {"name": "DN4", "kwargs": {"n_k": 3}}},
    "ADM": {"classifier": {"name": "ADM", "kwargs": {"n_k": 3}}},
    "ADM_KL": {"classifier": {"name": "ADM_KL", "kwargs": None},
               "optimizer": {"name": "SGD", "kwargs": {"lr": ADM_KL_LR}}},
    "ConvMNet": {"classifier": {"name": "ConvMNet", "kwargs": None},
                 "optimizer": {"name": "SGD", "kwargs": {"lr": FEAT_LR}}},
    "ATLNet": {"classifier": {"name": "ATLNet", "kwargs": None}},
    "MCL": {"classifier": {"name": "MCL", "kwargs": None}},
    "R2D2MCL": {"classifier": {"name": "R2D2MCL", "kwargs": None}},
    "RelationNet": {"classifier": {"name": "RelationNet", "kwargs": None},
                    "spec_shape": list(RELATION_SPEC),
                    "optimizer": {"name": "SGD", "kwargs": {"lr": RELATION_LR}}},
    "CAN": {"classifier": {"name": "CAN", "kwargs": {"num_classes": CAN_CLASSES}}},
    "LEO": {"classifier": {"name": "LEO", "kwargs": {
        "hid_dim": 16, "inner_para": {"iter": 2, "lr": 1.0, "finetune_iter": 2,
                                      "finetune_lr": 0.1}}}},
    "VERSA": {"classifier": {"name": "VERSA", "kwargs": {"sample_num": 4, "d_theta": 32}}},
    "DMatchingNet": {"classifier": {"name": "DMatchingNet", "kwargs": {
        "ifsl_param": {"class_num": CAN_CLASSES}}},
        "backbone": {"name": "Conv64F", "kwargs": {**_CONV64F_MAP["kwargs"], "is_flatten": True}}},
    "DSN": {"classifier": {"name": "DSN", "kwargs": {"discriminative": True}},
            "backbone": _resnet12()},
    "FRN": {"classifier": {"name": "FRN", "kwargs": None}, "backbone": _resnet12(True),
            "optimizer": {"name": "SGD", "kwargs": {"lr": FEAT_LR}}},
    "MetaBaselineKendall": {"classifier": {"name": "MetaBaselineKendall", "kwargs": None},
                            "backbone": _resnet12(),
                            "optimizer": {"name": "SGD", "kwargs": {"lr": FEAT_LR}}},
    "MTL": {"classifier": {"name": "MTL", "kwargs": {"inner_param": {"iter": 2, "lr": 0.01}}},
            "backbone": _resnet12()},
}
#: the heads whose BatchNorm takes batch statistics in eval too
RAGGED_HEADS = ("RelationNet", "VERSA")
#: controls: a repair undone on purpose, which a test's limits must see
HEAD_FAULTS = {
    "disc_sum": "DSN's orthogonality sum taken per rank (not times the world size)",
    "local_mean": "LEO's inner support loss the mean over this rank's rows",
    "draws": "LEO's and VERSA's noise drawn at this rank's shape",
    "head_bn": "the head's BatchNorm moments taken per rank",
    "running_stats": "DMatchingNet's running statistics the mean of this rank's episodes",
}


def head_config(head: str, **over) -> Dict[str, Any]:
    """``head``'s cell of ``HEAD_CELLS`` (``over`` replacing its keys)."""
    return proto_config(**{**copy.deepcopy(HEAD_CELLS[head]), **over})


@contextlib.contextmanager
def _undone(fault: Optional[str], head: str):
    """``fault`` (a key of ``HEAD_FAULTS``, or None) in force: the name its
    repair reads replaced, in the head's module (``head_bn``: its
    ``sharded_rows``, a no-op) or in the module the repair lives in."""
    if fault is None:
        yield
        return
    from .models.backbones import layers
    from .models.heads import dsn, ifsl, leo
    from .registry import CLASSIFIERS

    module, name, value = {
        "disc_sum": (dsn, "sharded_world", lambda: None),
        "local_mean": (leo, "sharded_world", lambda: None),
        "draws": (layers, "sharded_world", lambda: None),
        "head_bn": (sys.modules[CLASSIFIERS.get(head).__module__], "sharded_rows",
                    contextlib.nullcontext),
        "running_stats": (ifsl, "sharded_world", lambda: None)}[fault]
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _fed(draws: Sequence[np.ndarray]) -> Callable:
    """A ``GaussianNoise.draw`` that returns the given array of the shape
    asked (the whole step's, over several ranks too)."""
    by_shape = {tuple(a.shape): a for a in draws}

    def draw(shape, like):
        return torch.as_tensor(by_shape[tuple(shape)], dtype=like.dtype, device=like.device)

    return draw


def head_train(world: World, head: str, state=None, steps: int = 2, seed: int = 4,
               fault: Optional[str] = None, draws: Optional[Sequence[np.ndarray]] = None,
               **over) -> Dict[str, Any]:
    """``steps`` SGD steps of 8 episodes of a ``HEAD_CELLS`` head (config
    keys ``over``), Dropout the identity: the losses, the state after the
    first step and after the last, and the eval logits of the first batch;
    with ``draws``, the sampler's noise given (by shape); under ``fault``
    for a control."""
    cfg = head_config(head, **over)
    batches = episode_batches(steps, spec=tuple(cfg["spec_shape"]), seed=seed,
                              global_classes=CAN_CLASSES if head == "CAN" else 0)

    def prepare(method):
        _no_dropout(method)
        if draws:
            method.noise.draw = _fed(draws)

    with _undone(fault, head):
        return _train(world, cfg, batches, state, eval_batch=batches[0], prepare=prepare)


def head_ragged_eval(world: World, head: str, state=None,
                     fault: Optional[str] = None) -> Dict[str, Any]:
    """A ``RAGGED_HEADS`` head's eval logits of 8 ragged episodes (query
    clips of 1-2 segments in a bucket of 16 rows, so that each rank holds
    its own count of real rows), gathered in rank order, and each
    episode's real query rows."""
    cfg = head_config(head)
    spec = tuple(cfg["spec_shape"])
    rng = np.random.default_rng(5)
    e = 8
    repeats = rng.integers(1, 3, size=(e * 6,))
    sup = rng.normal(size=(e, 6) + spec).astype(np.float32)
    segs = rng.normal(size=(int(repeats.sum()),) + spec).astype(np.float32)
    batch = pack_ragged_episode_batch(sup, segs, repeats, 3, 2, 2, bucket_sizes=(16,))
    method = _method(cfg, state, world.device).eval()
    local = shard_batch(batch, world)
    with _undone(fault, head), torch.no_grad():
        logits = method(local, eval_setting(cfg))
    return {"logits": gather_rows(logits, world).cpu(),
            "real_rows": gather_rows((local.query_mask > 0).sum(dim=1), world).cpu()}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def divisibility(world: World) -> Dict[str, Any]:
    """The message of ``get_mesh`` when the world does not divide a knob."""
    try:
        get_mesh(None, {"episode_size": world.size + 1}, world.device)
    except ValueError as err:
        return {"message": str(err)}
    return {"message": None}


SCENARIOS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "proto_train": proto_train, "batchnorm": batchnorm, "ragged_eval": ragged_eval,
    "flagship_train": flagship_train, "dual_train": dual_train, "tta_eval": tta_eval,
    "maml_train": maml_train, "cpea_train": cpea_train, "divisibility": divisibility,
    "head_step": head_step, "flat_train": flat_train,
    "pretrain_train": pretrain_train, "s2m2_train": s2m2_train, "feat_train": feat_train,
    "metal_train": metal_train, "trainer_train": trainer_train,
    "replicated_eval": replicated_eval, "ifsl_featuring": ifsl_featuring,
    "replicated_test": replicated_test, "head_train": head_train,
    "head_ragged_eval": head_ragged_eval,
}


# -- running them -----------------------------------------------------------------------------

def run_scenarios(world: World, plan: Dict[str, Dict[str, Any]],
                  scenarios: Optional[Dict[str, Callable[..., Dict[str, Any]]]] = None
                  ) -> Dict[str, Any]:
    """``{name: inputs}`` → ``{name: result, name + ":s": seconds}``; a name
    (up to a ``:``) is looked up in ``scenarios`` first, then in
    ``SCENARIOS``."""
    table = {**SCENARIOS, **(scenarios or {})}
    out: Dict[str, Any] = {}
    for name, inputs in plan.items():
        t0 = time.time()
        out[name] = table[name.partition(":")[0]](world, **(inputs or {}))
        _synchronize(world.device)
        out[name + ":s"] = time.time() - t0
        if world.device.type == "cuda":  # ranks may share the card
            torch.cuda.empty_cache()
    return out


def _rank(rank: int, init_method: str, backend: str, device: str,
          plan: Dict[str, Dict[str, Any]], scenarios, out_dir: str, timeout: float) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else torch.device("cuda", rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(os.environ["WORLD_SIZE"]), rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        world = get_mesh(device=dev)
        from .ops import bdc_cuda

        bdc_cuda.launches = bdc_cuda.backward_launches = 0
        result = run_scenarios(world, plan, scenarios)
        result["launches"] = (bdc_cuda.launches, bdc_cuda.backward_launches)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(nproc: int, plan: Dict[str, Dict[str, Any]], device: str = "cpu",
              backend: Optional[str] = None, init_method: Optional[str] = None,
              timeout: float = 600.0, threads: Optional[int] = None,
              scenarios: Optional[Dict[str, Callable[..., Dict[str, Any]]]] = None
              ) -> List[Dict[str, Any]]:
    """``plan`` over ``nproc`` ranks (``backend``: gloo on the CPU, NCCL on
    cards by default); each rank's results (rank 0 first).  ``scenarios``:
    more scenario functions (module-level, so the ranks import them by
    name).  The ranks' collectives and the whole run fail after
    ``timeout`` seconds."""
    backend = backend or ("gloo" if torch.device(device).type == "cpu" else "nccl")
    with tempfile.TemporaryDirectory() as out_dir:
        spawn(_rank, nproc, (backend, device, plan, scenarios, out_dir, timeout),
              init_method=init_method, timeout=timeout, threads=threads)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(nproc)]


#: result keys that describe the run, not its results: times, and whether
#: ``Test`` ran its steps replicated (over ranks, not on one)
TIMINGS = ("eps", "replicated")
#: eval logits: ProtoNet's -|q - p|^2 = 2 q.p - |q|^2 - |p|^2 cancels, so 2
#: ranks and one part by up to 4e-3 of logits near 50 (on the CPU and on
#: the card alike); tests/test_torch_port_parallel.py's atol
LOGITS_ATOL = 1e-2
#: the keys held of the scenarios whose float32 gradients at random weights
#: move by 1-3 % of a tensor's scale with the order of the sums alone (the
#: BDC pool's, RENet's CCA: ROADMAP Queue C), which each later step
#: compounds: their losses and the state after the first step, as the
#: tests hold them; every other scenario's whole result
COMPARED = {"flagship_train": ("losses", "first_state"),
            "dual_train": ("losses", "first_state")}


def mismatch(a: Any, b: Any, rtol: float = 1e-3, atol: float = 5e-4, key: str = "") -> float:
    """How far two results (nested dicts, lists, tensors, numbers; times
    left out) are apart: the largest |a − b| / (atol + rtol·|b|) over their
    values (at most 1: ``allclose``; the JAX package's tolerances for
    parameters after its mesh tests' steps by default; ``LOGITS_ATOL`` for
    ``logits``); infinite where their structure differs.  The ``flagged``
    clips of a TTA step are compared as sets: ``torch.topk`` lists them by
    value, and near-equal values may swap places."""
    if isinstance(b, dict):
        return max((mismatch(a[k], b[k], rtol, atol, k) for k in b if k not in TIMINGS),
                   default=0.0)
    if isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return float("inf")
        return max((mismatch(x, y, rtol, atol, key) for x, y in zip(a, b)), default=0.0)
    if a is None or b is None or isinstance(b, str):
        return 0.0 if a == b else float("inf")
    ta, tb = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    if ta.shape != tb.shape:
        return float("inf")
    if ta.numel() == 0:
        return 0.0
    if key == "flagged":
        ta, tb = ta.sort().values, tb.sort().values
    if key == "logits":
        atol = max(atol, LOGITS_ATOL)
    return float(((ta - tb).abs() / (atol + rtol * tb.abs())).max())


def compared(name: str, result: Dict[str, Any]) -> Dict[str, Any]:
    """The part of scenario ``name``'s result that ``main`` holds."""
    keys = COMPARED.get(name.partition(":")[0])
    return result if keys is None else {k: result[k] for k in keys}


def default_plan(root: str) -> Dict[str, Dict[str, Any]]:
    """Every scenario at its tiny cell; the TTA eval over a random-weight
    checkpoint saved under ``root``."""
    cfg = tta_config()
    init_seed(int(cfg["seed"]))
    save_model_best(root, build_method(cfg))
    return {"proto_train": {}, "batchnorm": {}, "ragged_eval": {}, "flagship_train": {},
            "dual_train": {}, "tta_eval": {"cfg": cfg, "result_path": root},
            "maml_train": {}, "cpea_train": {}, **FLAT_PLAN, **flat_root_plan(root),
            **head_plan(root)}


#: the flat family's, FEAT's and MeTAL's scenarios that need no files
FLAT_PLAN = {"flat_train": {"evaluate": True}, "pretrain_train": {}, "s2m2_train": {},
             "feat_train": {}, "metal_train": {}, "metal_train:per_step": {"per_step": True}}


def flat_root_plan(root: str) -> Dict[str, Dict[str, Any]]:
    """The scenarios that run a ``Trainer`` on a synthetic root, their
    result directories under ``root``: the replicated eval and IFSL's
    featuring pass."""
    return {"replicated_eval": {"root": os.path.join(root, "replicated")},
            "ifsl_featuring": {"root": os.path.join(root, "featuring")}}


def head_plan(root: str) -> Dict[str, Dict[str, Any]]:
    """The 17 heads of ``HEAD_CELLS`` (two steps each), the ragged eval of
    ``RAGGED_HEADS`` and ``Test``'s replicated steps (its result directory
    under ``root``)."""
    return {**{f"head_train:{h}": {"head": h} for h in HEAD_CELLS},
            **{f"head_ragged_eval:{h}": {"head": h} for h in RAGGED_HEADS},
            "replicated_test": {"root": os.path.join(root, "replicated_test")}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", default="cuda",
                        help="cpu (gloo), cuda (a card a rank) or cuda:0 (ranks share it)")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default by device)")
    parser.add_argument("--rtol", type=float, default=1e-3)
    parser.add_argument("--atol", type=float, default=5e-4)
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("dryrun_multigpu: no CUDA device is available; pass --device cpu",
              file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as root:
        plan = default_plan(root)
        threads = (max(1, (os.cpu_count() or 1) // args.nproc)
                   if torch.device(args.device).type == "cpu" else None)
        many = run_ranks(args.nproc, plan, args.device, args.backend, threads=threads)
        dev = torch.device(args.device)
        one = run_scenarios(World(0, 1, dev if dev.type == "cpu" or dev.index is not None
                                  else torch.device("cuda", 0)), plan)
    worst = 0.0
    for name in plan:
        diff = mismatch(compared(name, many[0][name]), compared(name, one[name]), args.rtol,
                        args.atol)
        worst = max(worst, diff)
        print(f"dryrun_multigpu({args.nproc}): {name}: max |Δ| / (atol + rtol·|one rank|) "
              f"{diff:.3e}; {many[0][name + ':s']:.1f} s on {args.nproc} ranks, "
              f"{one[name + ':s']:.1f} s on one")
    ok = worst <= 1.0
    print(f"dryrun_multigpu({args.nproc}): {'ok' if ok else 'FAILED'} (worst {worst:.3e}; "
          f"rtol {args.rtol:g}, atol {args.atol:g})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

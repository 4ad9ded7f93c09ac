"""JAX package variables → the port's state dict.

The port's own copy of ``_invert_convnf`` / ``_invert_resnet12`` /
``_invert_resnet12bdc`` / ``_invert_vit_class_aware`` in
``audio_fewshot_tpu/utils/torch_convert.py``, and
the inverses of its ``_convert_r2d2emb`` / ``_convert_convmcl`` /
``_convert_resnet18`` / ``_convert_resnet18bdc`` / ``_convert_wrn`` /
``_convert_resnet12_dense`` / ``_convert_resnet12mtl`` (which have no
inverter there; resnet12MTLofficial's ``MtlConv`` shift goes to
``mtl_bias``, the stem's reference ``bias`` at 0): flax conv kernels HWIO → torch OIHW, Dense kernels
[in, out] → Linear [out, in]; BatchNorm ``scale``/``bias`` (params) and
``mean``/``var`` (batch_stats) → ``weight``/``bias``/``running_mean``/
``running_var``.  resnet12 / resnet12woLSC / resnet12Bdc also carry their
DropBlock ramp counters (``batch_stats[layer{3,4}]["num_batches_tracked"]``
→ ``layer{3,4}.0.num_batches_tracked``, int64) where the variables hold
them, which the JAX package's inverter drops.  The heads with parameters
(ADM, ConvMNet, ATLNet, RelationNet, MetaBaseline, FEAT, FRN, CAN, CPEANet,
R2D2 and R2D2MCL, the MAML family, MTL, MeTAL, LEO, VERSA, DMatchingNet,
RENet, and the global ``classifier`` (and SKDModel's and S2M2's
``rot_classifier``) of the finetuning family and the pretrainers,
FRN_Pretrain's ``frn_layer`` and MTLPretrain's ``pre_fc``) map onto the
reference torch names, the port's copy of ``invert_{adm,
convmnet,atlnet,relationnet,metabaseline,feat,frn,can,cpea,r2d2,maml,mtl,
leo,versa,dmatchingnet,renet,frn_pretrain,mtl_pretrain}_head_params``,
``invert_metal_per_step_params`` and ``_invert_lstm_cell`` in
``tools/cross_framework_parity.py`` (MeTAL's default path has no reference
counterpart: flax's names; S2M2's cosine head keeps the effective weight as
``classifier.weight``, where the reference splits it into ``weight_g`` and
``weight_v``).  The variables arrive as nested
dicts of numpy arrays, so this module needs no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch


def _conv(w) -> np.ndarray:
    """flax Conv [kh, kw, I, O] → torch Conv2d [O, I, kh, kw]."""
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _linear(w) -> np.ndarray:
    """flax Dense [in, out] → torch Linear [out, in]."""
    return np.ascontiguousarray(np.asarray(w).transpose(1, 0))


def _bn(state: Dict[str, np.ndarray], key: str, params: Dict, stats: Dict) -> None:
    state[key + ".weight"] = np.asarray(params["scale"])
    state[key + ".bias"] = np.asarray(params["bias"])
    state[key + ".running_mean"] = np.asarray(stats["mean"])
    state[key + ".running_var"] = np.asarray(stats["var"])
    state[key + ".num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _resnet12(params, stats, state) -> None:
    for i in range(1, 5):
        blk = f"layer{i}.0"
        p, s = params[f"layer{i}"], stats[f"layer{i}"]
        for j in range(1, 4):
            state[f"{blk}.conv{j}.weight"] = _conv(p[f"conv{j}"]["kernel"])
            _bn(state, f"{blk}.bn{j}", p[f"bn{j}"]["BatchNorm_0"], s[f"bn{j}"]["BatchNorm_0"])
        if "downsample_conv" in p:
            state[f"{blk}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            _bn(state, f"{blk}.downsample.1",
                p["downsample_bn"]["BatchNorm_0"], s["downsample_bn"]["BatchNorm_0"])
        if "num_batches_tracked" in s:
            # DropBlock's ramp counter (stages 3 and 4 with drop_rate > 0)
            state[f"{blk}.num_batches_tracked"] = np.asarray(s["num_batches_tracked"],
                                                             dtype=np.int64)


def _bdc_head(params, stats, state) -> None:
    """``BdcHead``: ``bdc_pool.reduce_conv`` / ``reduce_bn`` →
    ``bdc_pool.conv_dr_block.{0,1}``, ``log_temperature`` → ``temperature``."""
    head_p, head_s = params["bdc_pool"], stats.get("bdc_pool", {})
    if "reduce_conv" in head_p:
        state["bdc_pool.conv_dr_block.0.weight"] = _conv(head_p["reduce_conv"]["kernel"])
        _bn(state, "bdc_pool.conv_dr_block.1",
            head_p["reduce_bn"]["BatchNorm_0"], head_s["reduce_bn"]["BatchNorm_0"])
    state["bdc_pool.temperature"] = np.asarray(head_p["log_temperature"])


def _resnet12bdc(params, stats, state) -> None:
    _resnet12(params, stats, state)
    _bdc_head(params, stats, state)


def _two_conv_block(params, stats, state, src: str, dst: str, names) -> None:
    """A ``BasicBlock2`` (flax ``conv{1,2}`` / ``bn{1,2}`` /
    ``downsample_conv`` / ``downsample_bn``) under ``dst`` with the
    reference's ``names`` for those six."""
    p, s = params[src], stats[src]
    for j, (conv, bn) in enumerate((names[:2], names[2:4]), start=1):
        state[f"{dst}.{conv}.weight"] = _conv(p[f"conv{j}"]["kernel"])
        _bn(state, f"{dst}.{bn}", p[f"bn{j}"]["BatchNorm_0"], s[f"bn{j}"]["BatchNorm_0"])
    if "downsample_conv" in p:
        state[f"{dst}.{names[4]}.weight"] = _conv(p["downsample_conv"]["kernel"])
        _bn(state, f"{dst}.{names[5]}", p["downsample_bn"]["BatchNorm_0"],
            s["downsample_bn"]["BatchNorm_0"])


def _blocks(params):
    """The flax names ``{prefix}{i}_{b}`` of a backbone's blocks, with
    ``(i, b)``, in order."""
    found = (re.fullmatch(r"(?:layer|block)(\d+)_(\d+)", name) for name in params)
    return sorted((int(m[1]), int(m[2]), m[0]) for m in found if m)


def _resnet18(params, stats, state) -> None:
    """resnet18: ``conv1`` / ``bn1`` and ``layer{i}_{b}`` →
    ``layer{i}.{b}.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``."""
    state["conv1.weight"] = _conv(params["conv1"]["kernel"])
    _bn(state, "bn1", params["bn1"]["BatchNorm_0"], stats["bn1"]["BatchNorm_0"])
    for i, b, name in _blocks(params):
        _two_conv_block(params, stats, state, name, f"layer{i}.{b}",
                        ("conv1", "bn1", "conv2", "bn2", "downsample.0", "downsample.1"))


def _resnet18bdc(params, stats, state) -> None:
    """resnet18Bdc: ``conv1`` / ``bn1`` → ``trunk.0`` / ``trunk.1``;
    ``layer{s}_{b}`` → ``trunk.{4 + 2(s − 1) + b}.{C1,BN1,C2,BN2,shortcut,
    BNshortcut}``; the BDC head."""
    state["trunk.0.weight"] = _conv(params["conv1"]["kernel"])
    _bn(state, "trunk.1", params["bn1"]["BatchNorm_0"], stats["bn1"]["BatchNorm_0"])
    for s, b, name in _blocks(params):
        _two_conv_block(params, stats, state, name, f"trunk.{4 + 2 * (s - 1) + b}",
                        ("C1", "BN1", "C2", "BN2", "shortcut", "BNshortcut"))
    _bdc_head(params, stats, state)


def _wrn(params, stats, state) -> None:
    """WRN: ``conv1``, the final ``bn1``, ``block{g}_{b}``'s ``bn1`` /
    ``conv1`` / ``bn2`` / ``conv2`` / ``shortcut`` →
    ``block{g}.layer.{b}.{bn1,conv1,bn2,conv2,convShortcut}``."""
    state["conv1.weight"] = _conv(params["conv1"]["kernel"])
    _bn(state, "bn1", params["bn1"]["BatchNorm_0"], stats["bn1"]["BatchNorm_0"])
    for g, b, name in _blocks(params):
        p, s, pre = params[name], stats[name], f"block{g}.layer.{b}"
        for j in (1, 2):
            state[f"{pre}.conv{j}.weight"] = _conv(p[f"conv{j}"]["kernel"])
            _bn(state, f"{pre}.bn{j}", p[f"bn{j}"]["BatchNorm_0"], s[f"bn{j}"]["BatchNorm_0"])
        if "shortcut" in p:
            state[f"{pre}.convShortcut.weight"] = _conv(p["shortcut"]["kernel"])


def _mtl_conv(state, key: str, p: Dict, bias: bool = False) -> None:
    """``MtlConv``: ``kernel`` → ``weight``, ``mtl_scale`` [1, 1, I, O] →
    ``mtl_weight`` [O, I, 1, 1], the shift → ``mtl_bias``; with the
    reference's ``bias`` (the stem), that at 0, so that the reference's sum
    ``bias + mtl_bias`` is the shift."""
    state[key + ".weight"] = _conv(p["kernel"])
    state[key + ".mtl_weight"] = _conv(p["mtl_scale"])
    state[key + ".mtl_bias"] = np.asarray(p["mtl_bias"])
    if bias:
        state[key + ".bias"] = np.zeros_like(state[key + ".mtl_bias"])


def _resnet12mtl(params, stats, state) -> None:
    """resnet12MTLofficial: the stem ``conv1`` (with ``bias``) / ``bn1`` and
    ``layer{i}_{b}`` → ``layer{i}.{b}.{conv1,bn1,conv2,bn2,downsample.0,
    downsample.1}``."""
    _mtl_conv(state, "conv1", params["conv1"], bias=True)
    _bn(state, "bn1", params["bn1"]["BatchNorm_0"], stats["bn1"]["BatchNorm_0"])
    for i, b, name in _blocks(params):
        p, s, pre = params[name], stats[name], f"layer{i}.{b}"
        for j in (1, 2):
            _mtl_conv(state, f"{pre}.conv{j}", p[f"conv{j}"])
            _bn(state, f"{pre}.bn{j}", p[f"bn{j}"]["BatchNorm_0"], s[f"bn{j}"]["BatchNorm_0"])
        if "downsample_conv" in p:
            _mtl_conv(state, f"{pre}.downsample.0", p["downsample_conv"])
            _bn(state, f"{pre}.downsample.1", p["downsample_bn"]["BatchNorm_0"],
                s["downsample_bn"]["BatchNorm_0"])


def _convnf(params, stats, state) -> None:
    """Conv64F / Conv32F / Conv64F_MCL: ``layer{i}`` = ConvBnAct
    (``Conv_0``, with a bias unless bias-free, and ``BatchNorm_0``) →
    ``layer{i}.0`` / ``layer{i}.1``; Conv64F's logits head → ``logits.1``
    (BN1d) and ``logits.2`` (Linear)."""
    for i in range(1, 5):
        seq = f"layer{i}"
        state[f"{seq}.0.weight"] = _conv(params[seq]["Conv_0"]["kernel"])
        if "bias" in params[seq]["Conv_0"]:
            state[f"{seq}.0.bias"] = np.asarray(params[seq]["Conv_0"]["bias"])
        _bn(state, f"{seq}.1", params[seq]["BatchNorm_0"]["BatchNorm_0"],
            stats[seq]["BatchNorm_0"]["BatchNorm_0"])
    if "logits_dense" in params:
        _bn(state, "logits.1", params["logits_bn"]["BatchNorm_0"],
            stats["logits_bn"]["BatchNorm_0"])
        state["logits.2.weight"] = _linear(params["logits_dense"]["kernel"])
        state["logits.2.bias"] = np.asarray(params["logits_dense"]["bias"])


def _r2d2emb(params, stats, state) -> None:
    """R2D2Embedding: flax ``block{i}_conv`` / ``block{i}_bn`` → reference
    ``block{i}.0`` / ``block{i}.1``."""
    for i in range(1, 5):
        blk = f"block{i}"
        state[f"{blk}.0.weight"] = _conv(params[f"{blk}_conv"]["kernel"])
        state[f"{blk}.0.bias"] = np.asarray(params[f"{blk}_conv"]["bias"])
        _bn(state, f"{blk}.1", params[f"{blk}_bn"]["BatchNorm_0"],
            stats[f"{blk}_bn"]["BatchNorm_0"])


def _vit(params, stats, state) -> None:
    """The class-aware ViT: flax ``patch_embed`` (HWIO) → ``patch_embed.proj``
    (OIHW); ``block{i}``'s MHA ``query`` / ``key`` / ``value`` head-split
    kernels ``[dim, heads, hd]`` → the packed ``blocks.{i}.attn.qkv`` rows
    (q | k | v), ``out`` ``[heads, hd, dim]`` → ``attn.proj``; ``fc1`` /
    ``fc2`` → ``mlp.fc1`` / ``mlp.fc2``; LayerNorm ``scale`` → ``weight``."""
    state["patch_embed.proj.weight"] = _conv(params["patch_embed"]["kernel"])
    state["patch_embed.proj.bias"] = np.asarray(params["patch_embed"]["bias"])
    state["cls_token"] = np.asarray(params["cls_token"])
    state["pos_embed"] = np.asarray(params["pos_embed"])
    if "norm" in params:
        state["norm.weight"] = np.asarray(params["norm"]["scale"])
        state["norm.bias"] = np.asarray(params["norm"]["bias"])
    blocks = sorted((k for k in params if k.startswith("block")), key=lambda k: int(k[5:]))
    for i, name in enumerate(blocks):
        b, pre = params[name], f"blocks.{i}"
        dim = np.asarray(b["fc2"]["kernel"]).shape[-1]
        for ln in ("norm1", "norm2"):
            state[f"{pre}.{ln}.weight"] = np.asarray(b[ln]["scale"])
            state[f"{pre}.{ln}.bias"] = np.asarray(b[ln]["bias"])
        attn = b["attn"]
        state[f"{pre}.attn.qkv.weight"] = np.concatenate(
            [_linear(np.asarray(attn[k]["kernel"]).reshape(dim, dim))
             for k in ("query", "key", "value")])
        state[f"{pre}.attn.qkv.bias"] = np.concatenate(
            [np.asarray(attn[k]["bias"]).reshape(dim) for k in ("query", "key", "value")])
        state[f"{pre}.attn.proj.weight"] = _linear(np.asarray(attn["out"]["kernel"]).reshape(dim, dim))
        state[f"{pre}.attn.proj.bias"] = np.asarray(attn["out"]["bias"])
        for fc in ("fc1", "fc2"):
            state[f"{pre}.mlp.{fc}.weight"] = _linear(b[fc]["kernel"])
            state[f"{pre}.mlp.{fc}.bias"] = np.asarray(b[fc]["bias"])


_CONVERTERS = {
    "Conv64F": _convnf,
    "Conv32F": _convnf,
    "Conv64F_MCL": _convnf,  # the same layer{i} = (bias-free conv, BN) layout
    "R2D2Embedding": _r2d2emb,
    "resnet12": _resnet12,
    "resnet12woLSC": _resnet12,  # no downsample in stage 4
    "resnet12Bdc": _resnet12bdc,
    "resnet12_mcl": _resnet12,  # the same layer{i}.0 keys; stride in the pools
    "resnet12_r2d2": _resnet12,
    "resnet12MTLofficial": _resnet12mtl,
    "resnet18": _resnet18,
    "resnet18Bdc": _resnet18bdc,
    "WRN": _wrn,
    "vit_tiny": _vit,
    "vit_small": _vit,
    "VisionTransformer": _vit,
    "ViT": _vit,
}


def _head_bn(state, key: str, params: Dict, stats: Dict) -> None:
    """A head's BN: the running statistics default to 0 and 1 where the
    variables hold none.  No ``num_batches_tracked`` (the reference
    inverters give none; ``load_state_dict`` fills it)."""
    scale = np.asarray(params["scale"])
    state[key + ".weight"] = scale
    state[key + ".bias"] = np.asarray(params["bias"])
    state[key + ".running_mean"] = np.asarray(stats.get("mean", np.zeros_like(scale)))
    state[key + ".running_var"] = np.asarray(stats.get("var", np.ones_like(scale)))


def _head(params: Dict, stats: Dict):
    """A head's parameters and statistics, the modules under ``head`` (every
    head converter takes the whole method's trees: CAN's modules sit beside
    ``emb_func`` under their own names)."""
    return params["head"], stats.get("head", {})


def _adm_head(params, stats, state) -> None:
    """ADM's mixer: ``norm`` → ``adm_layer.normLayer`` (BatchNorm1d(2·way)),
    ``mix`` [2] → ``adm_layer.fcLayer.weight`` [1, 1, 2]."""
    head, stats = _head(params, stats)
    _head_bn(state, "adm_layer.normLayer", head["norm"], stats.get("norm", {}))
    state["adm_layer.fcLayer.weight"] = np.asarray(head["mix"]).reshape(1, 1, 2)


def _convmnet_head(params, stats, state) -> None:
    """ConvMNet's scorer: ``kernel`` [hw, 1] / ``bias`` →
    ``convm_layer.conv1dLayer.2`` (Conv1d(1, 1, hw))."""
    head = params["head"]
    state["convm_layer.conv1dLayer.2.weight"] = np.asarray(head["kernel"])[:, 0].reshape(1, 1, -1)
    state["convm_layer.conv1dLayer.2.bias"] = np.asarray(head["bias"])


def _atlnet_head(params, stats, state) -> None:
    """ATLNet: ``w_conv`` / ``w_bn`` → ``atlLayer.W.0`` / ``.1``; ``psi1`` /
    ``psi2`` → ``atlLayer.attenLayer.f_psi.0`` / ``.2``."""
    head, stats = _head(params, stats)
    state["atlLayer.W.0.weight"] = _conv(head["w_conv"]["kernel"])
    _head_bn(state, "atlLayer.W.1", head["w_bn"]["BatchNorm_0"],
             stats.get("w_bn", {}).get("BatchNorm_0", {}))
    for ours, theirs in (("psi1", "f_psi.0"), ("psi2", "f_psi.2")):
        state[f"atlLayer.attenLayer.{theirs}.weight"] = _linear(head[ours]["kernel"])
        state[f"atlLayer.attenLayer.{theirs}.bias"] = np.asarray(head[ours]["bias"])


def _relationnet_head(params, stats, state) -> None:
    """RelationNet: ``conv1`` / ``bn1`` / ``conv2`` / ``bn2`` →
    ``relation_layer.layers.{0,1,4,5}``; ``fc1`` / ``fc2`` →
    ``relation_layer.fc.{0,2}``."""
    head, stats = _head(params, stats)
    for ours, theirs in (("conv1", "layers.0"), ("conv2", "layers.4")):
        state[f"relation_layer.{theirs}.weight"] = _conv(head[ours]["kernel"])
        state[f"relation_layer.{theirs}.bias"] = np.asarray(head[ours]["bias"])
    for ours, theirs in (("bn1", "layers.1"), ("bn2", "layers.5")):
        _head_bn(state, f"relation_layer.{theirs}", head[ours]["BatchNorm_0"],
                 stats.get(ours, {}).get("BatchNorm_0", {}))
    for ours, theirs in (("fc1", "fc.0"), ("fc2", "fc.2")):
        state[f"relation_layer.{theirs}.weight"] = _linear(head[ours]["kernel"])
        state[f"relation_layer.{theirs}.bias"] = np.asarray(head[ours]["bias"])


def _metabaseline_head(params, stats, state) -> None:
    """MetaBaseline: ``temp`` (a scalar) → ``temp``."""
    head = params["head"]
    state["temp"] = np.asarray(head["temp"])


def _feat_head(params, stats, state) -> None:
    """FEAT's set attention: ``w_q`` / ``w_k`` / ``w_v`` (bias-free) / ``fc``
    / ``ln`` → ``slf_attn.w_qs`` / ``w_ks`` / ``w_vs`` / ``fc`` /
    ``layer_norm``."""
    head = params["head"]
    for ours, theirs in (("w_q", "w_qs"), ("w_k", "w_ks"), ("w_v", "w_vs")):
        state[f"slf_attn.{theirs}.weight"] = _linear(head[ours]["kernel"])
    state["slf_attn.fc.weight"] = _linear(head["fc"]["kernel"])
    state["slf_attn.fc.bias"] = np.asarray(head["fc"]["bias"])
    state["slf_attn.layer_norm.weight"] = np.asarray(head["ln"]["scale"])
    state["slf_attn.layer_norm.bias"] = np.asarray(head["ln"]["bias"])


def _frn_head(params, stats, state) -> None:
    """FRN: ``scale`` (a scalar) / ``r`` [2] → ``frn_layer.scale`` [1] /
    ``frn_layer.r``."""
    head = params["head"]
    state["frn_layer.scale"] = np.asarray(head["scale"]).reshape(1)
    state["frn_layer.r"] = np.asarray(head["r"])


def _dense_as_conv1x1(w) -> np.ndarray:
    """flax Dense [in, out] → torch 1×1 Conv2d [out, in, 1, 1]."""
    return np.ascontiguousarray(np.asarray(w).T[:, :, None, None])


def _can_head(params, stats, state) -> None:
    """CAN (its modules are ``cam`` and ``global_fc``, not ``head``):
    ``cam.conv1`` / ``bn1`` / ``conv2`` → ``cam_layer.cam.conv1.conv``
    / ``conv1.bn`` / ``conv2``; ``global_fc`` → ``cam_layer.classifier``."""
    cam = params["cam"]
    state["cam_layer.cam.conv1.conv.weight"] = _dense_as_conv1x1(cam["conv1"]["kernel"])
    state["cam_layer.cam.conv1.conv.bias"] = np.asarray(cam["conv1"]["bias"])
    _head_bn(state, "cam_layer.cam.conv1.bn", cam["bn1"]["BatchNorm_0"],
             stats.get("cam", {}).get("bn1", {}).get("BatchNorm_0", {}))
    state["cam_layer.cam.conv2.weight"] = _dense_as_conv1x1(cam["conv2"]["kernel"])
    state["cam_layer.cam.conv2.bias"] = np.asarray(cam["conv2"]["bias"])
    state["cam_layer.classifier.weight"] = _dense_as_conv1x1(params["global_fc"]["kernel"])
    state["cam_layer.classifier.bias"] = np.asarray(params["global_fc"]["bias"])


def _cpea_head(params, stats, state) -> None:
    """CPEA: ``fc1_hidden`` / ``fc1_out`` / ``fc_norm1`` / ``fc2_hidden`` /
    ``fc2_out`` → ``CPEA.fc1.fc1`` / ``CPEA.fc1.fc2`` / ``CPEA.fc_norm1`` /
    ``CPEA.fc2.fc1`` / ``CPEA.fc2.fc2``."""
    head = params["head"]
    for ours, theirs in (("fc1_hidden", "fc1.fc1"), ("fc1_out", "fc1.fc2"),
                         ("fc2_hidden", "fc2.fc1"), ("fc2_out", "fc2.fc2")):
        state[f"CPEA.{theirs}.weight"] = _linear(head[ours]["kernel"])
        state[f"CPEA.{theirs}.bias"] = np.asarray(head[ours]["bias"])
    state["CPEA.fc_norm1.weight"] = np.asarray(head["fc_norm1"]["scale"])
    state["CPEA.fc_norm1.bias"] = np.asarray(head["fc_norm1"]["bias"])


def _r2d2_head(params, stats, state) -> None:
    """R2D2 / R2D2MCL: the scalars ``alpha`` / ``beta`` / ``gamma`` →
    ``classifier.alpha`` / ``beta`` / ``gamma`` [1]."""
    head = params["head"]
    for k in ("alpha", "beta", "gamma"):
        state[f"classifier.{k}"] = np.asarray(head[k]).reshape(1)


def _maml_head(params, stats, state) -> None:
    """MAML / ANIL / BOIL: the ``classifier`` Dense (beside ``emb_func``, not
    under ``head``) → ``classifier.layers.0``."""
    head = params["classifier"]
    state["classifier.layers.0.weight"] = _linear(head["kernel"])
    state["classifier.layers.0.bias"] = np.asarray(head["bias"])


def _mtl_head(params, stats, state) -> None:
    """MTL: the base learner's ``classifier.fc`` Dense →
    ``base_learner.fc1_w`` [way, D] / ``fc1_b`` (the reference's ``vars.{0,1}``
    alias the same tensors)."""
    head = params["classifier"]["fc"]
    state["base_learner.fc1_w"] = _linear(head["kernel"])
    state["base_learner.fc1_b"] = np.asarray(head["bias"])


def _linear_entries(state, key: str, dense: Dict, bias: bool = True) -> None:
    state[key + ".weight"] = _linear(dense["kernel"])
    if bias:
        state[key + ".bias"] = np.asarray(dense["bias"])


def _metal_head(params, stats, state) -> None:
    """MeTAL: the ``classifier`` Dense as the MAML family's; the default
    path's ``MetaLossNet`` s (``step_emb`` ``embedding`` → ``step_emb.weight``,
    ``fc1`` / ``fc2``, flax's names: no reference counterpart); the per-step
    path's stacked ``w1`` / ``b1`` / ``w2`` / ``b2`` [steps, …] →
    ``layer_dict.step{i}.linear{1,2}.{weights,bias}`` and the adapters' →
    ``loss_adapter.{i}.linear{1,2}.{weight,bias}``, ``{multiplier,offset}_bias``."""
    _maml_head(params, stats, state)
    for name in ("meta_loss", "meta_query_loss"):
        sub = params[name]
        if "w1" not in sub:
            state[f"{name}.step_emb.weight"] = np.asarray(sub["step_emb"]["embedding"])
            for fc in ("fc1", "fc2"):
                _linear_entries(state, f"{name}.{fc}", sub[fc])
            continue
        for i in range(np.asarray(sub["w1"]).shape[0]):
            pre = f"{name}.layer_dict.step{i}"
            for j in (1, 2):
                state[f"{pre}.linear{j}.weights"] = _linear(np.asarray(sub[f"w{j}"])[i])
                state[f"{pre}.linear{j}.bias"] = np.asarray(sub[f"b{j}"])[i]
        sub = params[f"{name}_adapter"]
        for i in range(np.asarray(sub["w1"]).shape[0]):
            pre = f"{name}_adapter.loss_adapter.{i}"
            for j in (1, 2):
                state[f"{pre}.linear{j}.weight"] = _linear(np.asarray(sub[f"w{j}"])[i])
                state[f"{pre}.linear{j}.bias"] = np.asarray(sub[f"b{j}"])[i]
            for k in ("multiplier_bias", "offset_bias"):
                state[f"{pre}.{k}"] = np.asarray(sub[k])[i]


def _leo_head(params, stats, state) -> None:
    """LEO: ``encoder.encoder`` → ``encoder.encoder_func``, the bias-free
    ``relation{i}`` → ``encoder.relation_net.{2i}``, ``decoder.decoder`` →
    ``decoder.decoder_func``."""
    enc = params["encoder"]
    _linear_entries(state, "encoder.encoder_func", enc["encoder"])
    for i in range(3):
        _linear_entries(state, f"encoder.relation_net.{2 * i}", enc[f"relation{i}"], bias=False)
    _linear_entries(state, "decoder.decoder_func", params["decoder"]["decoder"])


def _versa_head(params, stats, state) -> None:
    """VERSA: the trunk's ``h_dense`` / ``h_bn`` → ``h.0`` / ``h.1`` (its
    running statistics too), the ψ predictors' ``Dense_{i}`` →
    ``{weight,bias}_{mean,logvar}.layers.{2i}``."""
    head = params["head"]
    _linear_entries(state, "h.0", head["h_dense"])
    _head_bn(state, "h.1", head["h_bn"]["BatchNorm_0"],
             stats.get("head", {}).get("h_bn", {}).get("BatchNorm_0", {}))
    for psi in ("weight_mean", "weight_logvar", "bias_mean", "bias_logvar"):
        for i in range(3):
            _linear_entries(state, f"{psi}.layers.{2 * i}", params["psi"][psi][f"Dense_{i}"])


def _lstm_cell(tree: Dict):
    """flax ``OptimizedLSTMCell`` → torch (weight_ih, weight_hh, bias_ih,
    bias_hh), gates stacked i|f|g|o; flax's one bias per gate (on the hidden
    kernels) → ``bias_ih``, ``bias_hh`` zero."""
    w_ih = np.concatenate([_linear(tree[f"i{g}"]["kernel"]) for g in "ifgo"])
    w_hh = np.concatenate([_linear(tree[f"h{g}"]["kernel"]) for g in "ifgo"])
    b_ih = np.concatenate([np.asarray(tree[f"h{g}"]["bias"]) for g in "ifgo"])
    return w_ih, w_hh, b_ih, np.zeros_like(b_ih)


def _dmatchingnet_head(params, stats, state) -> None:
    """DMatchingNet: ``pretrain_cls`` → ``utils.linear``; each split's
    ``block{j}`` (``single``) or ``x_block{j}`` / ``d_block{j}`` →
    ``blocks.{j}`` / ``x_blocks.{j}`` / ``d_blocks.{j}``: its forward and
    reverse support LSTM cells (``OptimizedLSTMCell_0`` / ``_1``) →
    ``G_encoder.*_l0`` / ``*_l0_reverse``, its FCE cell → ``FCE.lstmcell``."""
    _linear_entries(state, "utils.linear", params["pretrain_cls"])
    for name in sorted(k for k in params if "block" in k):
        kind, j = name.rstrip("0123456789"), name[len(name.rstrip("0123456789")):]
        pre = f"{kind}s.{j}"
        for cell, sfx in (("OptimizedLSTMCell_0", ""), ("OptimizedLSTMCell_1", "_reverse")):
            for key, val in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                                _lstm_cell(params[name][cell])):
                state[f"{pre}.G_encoder.{key}_l0{sfx}"] = val
        for key, val in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                            _lstm_cell(params[name]["fce"]["cell"])):
            state[f"{pre}.FCE.lstmcell.{key}"] = val


def _renet_head(params, stats, state) -> None:
    """RENet: ``scr`` (``conv_in`` / ``bn_in``, ``conv{1,2}`` / ``bn{1,2}``,
    ``conv_out`` / ``bn_out``) → ``scr_layer.model.1.{conv1x1_in, conv1,
    conv2, conv1x1_out}.{0,1}``; ``cca`` (``cca_1x1`` / ``cca_bn``, each
    ``cca_module.sep{1,2}``'s ``conv_uv`` / ``bn_uv``, ``conv_hw`` /
    ``bn_hw``, ``proj`` / ``bn_proj``) → ``cca_layer.cca_1x1.{0,1}``,
    ``cca_layer.cca_module.conv.{0,2}.{conv2, conv1, proj}.{0,1}``; ``fc``.
    3 × 3 kernels over the (u, v) or (h, w) plane become the reference's
    (1, k, k) or (k, k, 1) Conv3d kernels; running statistics default to 0
    and 1 where the variables hold none."""
    def bn(key, p, s):
        _head_bn(state, key, p["BatchNorm_0"], (s or {}).get("BatchNorm_0", {}))

    scr_p, scr_s = params["scr"], stats.get("scr", {})
    base = "scr_layer.model.1"
    state[f"{base}.conv1x1_in.0.weight"] = _conv(scr_p["conv_in"]["kernel"])
    bn(f"{base}.conv1x1_in.1", scr_p["bn_in"], scr_s.get("bn_in"))
    for i in ("1", "2"):
        state[f"{base}.conv{i}.0.weight"] = _conv(scr_p["conv" + i]["kernel"])[:, :, None]
        bn(f"{base}.conv{i}.1", scr_p["bn" + i], scr_s.get("bn" + i))
    state[f"{base}.conv1x1_out.0.weight"] = _conv(scr_p["conv_out"]["kernel"])
    bn(f"{base}.conv1x1_out.1", scr_p["bn_out"], scr_s.get("bn_out"))
    cca_p, cca_s = params["cca"], stats.get("cca", {})
    state["cca_layer.cca_1x1.0.weight"] = _conv(cca_p["cca_1x1"]["kernel"])
    bn("cca_layer.cca_1x1.1", cca_p["cca_bn"], cca_s.get("cca_bn"))
    for name, idx in (("sep1", 0), ("sep2", 2)):
        sep, seps = cca_p["cca_module"][name], cca_s.get("cca_module", {}).get(name, {})
        pre = f"cca_layer.cca_module.conv.{idx}"
        state[f"{pre}.conv2.0.weight"] = _conv(sep["conv_uv"]["kernel"])[..., None]
        bn(f"{pre}.conv2.1", sep["bn_uv"], seps.get("bn_uv"))
        state[f"{pre}.conv1.0.weight"] = _conv(sep["conv_hw"]["kernel"])[:, :, None]
        bn(f"{pre}.conv1.1", sep["bn_hw"], seps.get("bn_hw"))
        if "proj" in sep:
            state[f"{pre}.proj.0.weight"] = _conv(sep["proj"]["kernel"])
            bn(f"{pre}.proj.1", sep["bn_proj"], seps.get("bn_proj"))
    _linear_entries(state, "fc", params["fc"])


def _frn_pretrain_head(params, stats, state) -> None:
    """FRN_Pretrain: ``frn_head``'s ``scale`` (a scalar) / ``r`` / ``cat_mat``
    → ``frn_layer.scale`` [1] / ``frn_layer.r`` / ``frn_layer.cat_mat``."""
    head = params["frn_head"]
    state["frn_layer.scale"] = np.asarray(head["scale"]).reshape(1)
    state["frn_layer.r"] = np.asarray(head["r"])
    state["frn_layer.cat_mat"] = np.asarray(head["cat_mat"])


def _mtl_pretrain_head(params, stats, state) -> None:
    """MTLPretrain: the ``classifier``'s ``fc1`` / ``fc2`` → ``pre_fc.0`` /
    ``pre_fc.2``."""
    head = params["classifier"]
    _linear_entries(state, "pre_fc.0", head["fc1"])
    _linear_entries(state, "pre_fc.2", head["fc2"])


def _global_head(params, stats, state) -> None:
    """The finetuning family's and the pretrainers' global head: the
    ``classifier`` Dense (beside ``emb_func``) → ``classifier`` (no bias on
    the cosine heads, whose Dense has none); SKDModel's ``rot_classifier``
    too."""
    for name in ("classifier", "rot_classifier"):
        if name in params:
            _linear_entries(state, name, params[name], bias="bias" in params[name])


_HEAD_CONVERTERS = {
    "ADM": _adm_head,
    "ConvMNet": _convmnet_head,
    "ATLNet": _atlnet_head,
    "RelationNet": _relationnet_head,
    "MetaBaseline": _metabaseline_head,
    "FEAT": _feat_head,
    "FRN": _frn_head,
    "CAN": _can_head,
    "CPEANet": _cpea_head,
    "R2D2": _r2d2_head,
    "R2D2MCL": _r2d2_head,
    "MAML": _maml_head,
    "ANIL": _maml_head,
    "BOIL": _maml_head,
    "MTL": _mtl_head,
    "MeTAL": _metal_head,
    "METAL": _metal_head,
    "LEO": _leo_head,
    "VERSA": _versa_head,
    "DMatchingNet": _dmatchingnet_head,
    "RENet": _renet_head,
    "FRN_Pretrain": _frn_pretrain_head,
    "MTLPretrain": _mtl_pretrain_head,
    **{name: _global_head for name in (
        "Baseline", "BaselinePlus", "NegNet", "RFSModel", "SKDModel", "S2M2",
        "MetabaselinePretrain", "MetabaselineKendallPretrain", "FEAT_Pretrain",
        "DeepBDC_Pretrain", "IfslPretrain")},
}


def head_state_dict_from_jax(variables: Dict[str, Any],
                             classifier: str) -> Dict[str, np.ndarray]:
    """The head's entries of a method's state dict (method-level keys, the
    reference torch names) from the JAX package's ``params["head"]`` and
    ``batch_stats["head"]`` (CAN: its ``cam`` and ``global_fc`` modules; the
    MAML family: its ``classifier``); empty for a head without parameters."""
    state: Dict[str, np.ndarray] = {}
    if classifier in _HEAD_CONVERTERS:
        _HEAD_CONVERTERS[classifier](variables["params"], variables.get("batch_stats", {}), state)
    return state


def state_dict_from_jax(
    variables: Dict[str, Any], backbone_name: str, prefix: str = "",
    classifier: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Backbone state dict from the JAX package's variable tree.

    ``variables``: ``{"params": {"emb_func": ...}, "batch_stats": {...}}`` or
    an already-sliced backbone tree, as nested dicts of numpy arrays.  Keys
    get ``prefix`` (``"emb_func."`` for a whole method).  ``classifier``
    (with a whole method's variables): also its head's weights, under the
    method-level keys of ``head_state_dict_from_jax``."""
    if backbone_name not in _CONVERTERS:
        raise KeyError(
            f"no converter for backbone {backbone_name!r}; supported: {sorted(_CONVERTERS)}"
        )
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if "emb_func" in params:
        params = params["emb_func"]
        stats = stats.get("emb_func", {})
    state: Dict[str, np.ndarray] = {}
    _CONVERTERS[backbone_name](params, stats, state)
    state = {prefix + k: v for k, v in state.items()}
    if classifier is not None:
        state.update(head_state_dict_from_jax(variables, classifier))
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}

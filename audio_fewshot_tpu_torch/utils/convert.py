"""JAX package variables → the port's state dict.

The port's own copy of ``_invert_convnf`` / ``_invert_resnet12`` /
``_invert_resnet12bdc`` / ``_invert_vit_class_aware`` in
``audio_fewshot_tpu/utils/torch_convert.py``, and
the inverses of its ``_convert_r2d2emb`` / ``_convert_convmcl`` (which have
no inverter there): flax conv kernels HWIO → torch OIHW, Dense kernels
[in, out] → Linear [out, in]; BatchNorm ``scale``/``bias`` (params) and
``mean``/``var`` (batch_stats) → ``weight``/``bias``/``running_mean``/
``running_var``.  resnet12 / resnet12woLSC / resnet12Bdc also carry their
DropBlock ramp counters (``batch_stats[layer{3,4}]["num_batches_tracked"]``
→ ``layer{3,4}.0.num_batches_tracked``, int64) where the variables hold
them, which the JAX package's inverter drops.  The heads with parameters
(ADM, ConvMNet, ATLNet, RelationNet, MetaBaseline, FEAT, FRN, CAN, CPEANet,
R2D2 and R2D2MCL, the MAML family) map onto the reference torch names, the
port's copy of ``invert_{adm,convmnet,atlnet,relationnet,metabaseline,feat,
frn,can,cpea,r2d2,maml}_head_params``
in ``tools/cross_framework_parity.py``.  The variables arrive as nested
dicts of numpy arrays, so this module needs no JAX.
"""

from __future__ import annotations

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


def _resnet12bdc(params, stats, state) -> None:
    _resnet12(params, stats, state)
    head_p, head_s = params["bdc_pool"], stats.get("bdc_pool", {})
    if "reduce_conv" in head_p:
        state["bdc_pool.conv_dr_block.0.weight"] = _conv(head_p["reduce_conv"]["kernel"])
        _bn(state, "bdc_pool.conv_dr_block.1",
            head_p["reduce_bn"]["BatchNorm_0"], head_s["reduce_bn"]["BatchNorm_0"])
    state["bdc_pool.temperature"] = np.asarray(head_p["log_temperature"])


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

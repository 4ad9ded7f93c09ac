"""The Swin family of the PyTorch port against the JAX package on the CPU.

A small ``SwinTransformer`` (embed 16, depths (2, 2), heads (2, 4), head_dim
8, downscaling (4, 2), window 4) on ``[1, 24, 40]`` segments: stage 0's 6 ×
10 map pads to 8 × 12 and its shifted block shifts by 2; stage 1's 3 × 5 map
clamps the window to 3, pads to 3 × 6 and shifts.  The JAX package's tree is
drawn with numpy (``test_torch_port_meta2.draw_tree``: kernels and the
relative-position tables N(0, 1/fan_in)) with random biases and LayerNorm
scales, carried across by ``utils.convert.state_dict_from_jax``.

Tolerances:
- float32 forwards, both ``is_flatten`` values, ``final_norm`` on and off:
  1e-5 of the output's max abs (``FORWARD_TOL``); the factory's bf16 against
  the JAX package's bf16: 3e-2 (``BF16_TOL``: 8 bits of mantissa through
  four blocks and two merges);
- the input gradient and every parameter's of Σ out·r, and a ProtoNet train
  step on the small Swin (loss, logits, every gradient), float32 against
  float32 (no BN anywhere): 1e-4 of each gradient's max abs (``GRAD_TOL``),
  the loss and logits 1e-5 of the logits' scale;
- ``remat``: the plain run's gradients to 1e-6 (``REMAT_TOL``);
- parameter shapes at ``[1, 128, 157]`` against ``jax.eval_shape`` of the
  JAX init, for all five factories, and the converter's trips: exact.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.episode import make_dense_episode_batch as jax_dense_batch  # noqa: E402
from audio_fewshot_tpu.models.backbones.swin import SwinTransformer as JaxSwin  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting  # noqa: E402
from audio_fewshot_tpu.registry import BACKBONES as JAX_BACKBONES  # noqa: E402
from audio_fewshot_tpu.registry import CLASSIFIERS as JAX_CLASSIFIERS  # noqa: E402
from audio_fewshot_tpu.utils.torch_convert import convert_backbone_state_dict  # noqa: E402
from audio_fewshot_tpu_torch.episode import make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.swin import (  # noqa: E402
    SWIN_FACTORS, SwinTransformer, shift_attn_mask)
from audio_fewshot_tpu_torch.registry import BACKBONES  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    state_dict_from_jax, swin_jax_params)

from test_torch_port_meta2 import draw_tree  # noqa: E402
from test_torch_port_metric import _rel  # noqa: E402
from test_torch_port_resnet12_heads import _check_step  # noqa: E402

FORWARD_TOL = 1e-5
BF16_TOL = 3e-2
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-5
REMAT_TOL = 1e-6
SPEC = (1, 24, 40)
SMALL = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), head_dim=8,
             downscaling_factors=(4, 2), window_size=4)
FULL = (1, 128, 157)
N = 3


def _x(n=N, seed=0):
    return np.random.default_rng(seed).normal(size=(n,) + SPEC).astype(np.float32)


def _jax_swin(dtype=jnp.float32, **kw):
    return JaxSwin(**SMALL, dtype=dtype, **kw)


def _perturbed(tree, rng):
    """``tree`` with every 1-D leaf (biases, LayerNorm scales and biases)
    moved by N(0, 0.1²), so that each must land where it belongs."""
    return jax.tree_util.tree_map(
        lambda a: a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype) if a.ndim == 1 else a, tree)


@functools.lru_cache(maxsize=None)
def jax_variables(final_norm=True):
    shapes = jax.eval_shape(lambda k: _jax_swin(final_norm=final_norm).init(k, _x(1)),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, draw_tree(shapes, np.random.default_rng(0)))
    return _perturbed(dict(tree), np.random.default_rng(1))


def port_swin(final_norm=True, dtype=torch.float32, **kw):
    model = SwinTransformer(**SMALL, final_norm=final_norm, dtype=dtype, spec_shape=SPEC, **kw)
    model.load_state_dict(state_dict_from_jax(jax_variables(final_norm), "swin_t"))
    return model


@pytest.mark.parametrize("is_flatten", [True, False], ids=["flat", "map"])
@pytest.mark.parametrize("final_norm", [True, False], ids=["norm", "no_norm"])
def test_swin_forward_matches_jax(is_flatten, final_norm):
    """Padded, shifted and clamped windows, the merges' (c, kh, kw) order,
    the per-head tables (i − j), the final LayerNorm and both outputs."""
    x = _x()
    ref = np.asarray(_jax_swin(is_flatten=is_flatten, final_norm=final_norm).apply(
        jax_variables(final_norm), x))
    model = port_swin(final_norm, is_flatten=is_flatten)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == ((N, 32) if is_flatten else (N, 32, 3, 5))
    assert _rel(ours, ref) <= FORWARD_TOL
    assert model.feature_dim(SPEC) == int(np.prod(ours.shape[1:]))


def test_swin_blocks_pad_shift_and_clamp():
    """The small model meets every case of the block: stage 0 pads 6 × 10 to
    8 × 12 and shifts by 2; stage 1 clamps the window 4 to its 3 × 5 map,
    pads to 3 × 6 and shifts; the mask holds −100 where the roll joined
    regions, and its (padded) canvas is the JAX package's."""
    model = port_swin()
    (s0, s1) = model.stages()
    b0, b1 = s0.blocks()[1], s1.blocks()[1]
    assert (b0.ws, b0.shift, b0.padded()) == (4, 2, (8, 12))
    assert (b1.ws, b1.shift, b1.padded()) == (3, 2, (3, 6))
    assert s0.blocks()[0].shift == 0
    from audio_fewshot_tpu.models.backbones.swin import shift_attn_mask as jax_mask

    np.testing.assert_array_equal(s0.attn_mask.numpy(), np.asarray(jax_mask(8, 12, 4, 2)))
    np.testing.assert_array_equal(shift_attn_mask(3, 6, 3, 2).numpy(),
                                  np.asarray(jax_mask(3, 6, 3, 2)))
    assert (s0.attn_mask == -100).any()
    with pytest.raises(ValueError, match="built for"):
        model(torch.zeros((1, 1, 24, 41)))


def test_swin_bf16_matches_jax_bf16():
    """The default bf16 compute against the JAX package's bf16 module."""
    x = _x()
    ref = np.asarray(_jax_swin(dtype=jnp.bfloat16).apply(jax_variables(), x))
    f32 = np.asarray(_jax_swin().apply(jax_variables(), x))
    model = port_swin(dtype=torch.bfloat16)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float32
    assert _rel(ours, ref) <= BF16_TOL and _rel(ours, f32) <= BF16_TOL


def _jax_grads(x, r):
    module = _jax_swin(is_flatten=False)

    def f(params, xx):
        return jnp.sum(module.apply({"params": params}, xx) * r)

    gp, gx = jax.grad(f, argnums=(0, 1))(jax_variables()["params"], x)
    return jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx)


def _port_grads(model, x, r):
    xt = torch.from_numpy(x).requires_grad_(True)
    (model(xt) * torch.from_numpy(r)).sum().backward()
    return {k: p.grad for k, p in model.named_parameters()}, xt.grad.numpy()


def test_swin_input_and_parameter_gradients_match_jax():
    """d Σ out·r over the NCHW map (train mode: Swin has no BN or dropout),
    with respect to the input and to every parameter."""
    x = _x(seed=1)
    r = np.random.default_rng(2).normal(size=(N, 32, 3, 5)).astype(np.float32)
    ref_p, ref_x = _jax_grads(x, r)
    model = port_swin(is_flatten=False).train()
    grads, gx = _port_grads(model, x, r)
    assert _rel(gx, ref_x) <= GRAD_TOL
    ref = {k: v.numpy() for k, v in state_dict_from_jax({"params": ref_p}, "swin_t").items()}
    assert set(ref) == set(grads)
    largest = max(np.abs(v).max() for v in ref.values())
    for key, g in grads.items():
        tol = GRAD_TOL * max(np.abs(ref[key]).max(), 0.1 * largest)
        assert np.abs(g.numpy() - ref[key]).max() <= tol, key


def test_swin_remat_recomputes_the_same_gradients():
    x = _x(seed=1)
    r = np.random.default_rng(2).normal(size=(N, 32, 3, 5)).astype(np.float32)
    plain, gx = _port_grads(port_swin(is_flatten=False).train(), x, r)
    remat, gx_remat = _port_grads(port_swin(is_flatten=False, remat=True).train(), x, r)
    assert np.abs(gx - gx_remat).max() <= REMAT_TOL * np.abs(gx).max()
    for key, g in plain.items():
        assert (remat[key] - g).abs().max() <= REMAT_TOL * g.abs().max(), key


WAY, SHOT, QUERY = 3, 2, 2
SETTING = EpisodeSetting(way=WAY, shot=SHOT, query=QUERY)


def proto_swin_config():
    return {"classifier": {"name": "ProtoNet", "kwargs": None},
            "backbone": {"name": "swin_t", "kwargs": dict(SMALL, num_channels=1)},
            "modality": "audio", "precision": "fp32", "way_num": WAY, "shot_num": SHOT,
            "query_num": QUERY, "spec_shape": list(SPEC)}


def test_protonet_on_swin_train_step_matches_jax():
    """One ProtoNet train step on the small Swin: loss, logits and every
    gradient, float32 in both packages."""
    rng = np.random.default_rng(3)
    sup = rng.normal(size=(1, WAY * SHOT) + SPEC).astype(np.float32)
    qry = rng.normal(size=(1, WAY * QUERY) + SPEC).astype(np.float32)
    jb = jax_dense_batch(sup, qry, WAY, SHOT, QUERY)
    pb = make_dense_episode_batch(sup, qry, WAY, SHOT, QUERY).to("cpu")
    # the JAX package's swin_t factory pins its widths: ProtoNet around the small module
    jax_method = JAX_CLASSIFIERS.get("ProtoNet")(emb_func=_jax_swin(), way_num=WAY,
                                                 shot_num=SHOT, query_num=QUERY)
    params = {"emb_func": jax_variables()["params"]}

    def loss_fn(p):
        return jax_method.loss({"params": p}, jb, SETTING, jax.random.PRNGKey(1))

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ref_grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads)}, "swin_t",
        prefix="emb_func.").items()}
    method = build_method(proto_swin_config())
    method.load_state_dict(state_dict_from_jax(jax_variables(), "swin_t", prefix="emb_func."))
    method.train()
    loss_t, out_t = method.loss(pb, SETTING)
    loss_t.backward()
    named = dict(method.named_parameters())
    assert set(named) == set(ref_grads)
    _check_step(named, {}, loss_t, out_t,
                (float(loss), np.asarray(out.seg_logits), ref_grads, {}),
                {"logits": LOGIT_TOL, "grads": GRAD_TOL, "vanishing": 1e-3, "stats": 0.0})


@pytest.mark.parametrize("name", list(SWIN_FACTORS))
def test_factory_parameter_shapes_match_the_jax_init(name):
    """Each factory at ``[1, 128, 157]``: the port's keys and shapes are the
    JAX init's (``jax.eval_shape``) carried across, stage 3's clamped
    window included (swin_t/s/b/l: 4 × 4 → a 7 × 7 table, no shift;
    swin_mini: 10 × 13, window 7 throughout)."""
    x = jnp.zeros((1,) + FULL, jnp.float32)
    shapes = jax.eval_shape(lambda k: JAX_BACKBONES.build(name).init(k, x), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(zeros, name).items()}
    with torch.device("meta"):
        model = BACKBONES.build(name, spec_shape=FULL)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    last = model.stages()[-1].blocks()
    ws = {"swin_mini": 7}.get(name, 4)
    assert [b.ws for b in last] == [ws] * len(last)
    assert last[-1].shift == (3 if name == "swin_mini" else 0)
    assert last[0].attention_block.fn.fn.rel_pos_bias.shape[0] == (2 * ws - 1) ** 2
    assert model.feature_dim(FULL) == {"swin_mini": 384, "swin_b": 1024,
                                       "swin_l": 1536}.get(name, 768)


def _to_reference(state):
    """The port's Swin state dict under the reference's keys: no qkv bias,
    one scalar table a block indexed (j − i) (head 0's, flipped on both
    displacement axes), no final norm."""
    ref = {}
    for key, val in state.items():
        val = val.numpy()
        if key.endswith("to_qkv.bias") or key.startswith("norm."):
            continue
        if key.endswith("rel_pos_bias"):
            side = int(round(np.sqrt(val.shape[0])))
            ref[key.replace("rel_pos_bias", "pos_embedding")] = np.flip(
                val[:, 0].reshape(side, side), (0, 1)).copy()
            continue
        ref[key] = val
    return ref


def test_converter_round_trips():
    """JAX tree → ``state_dict_from_jax`` → ``swin_jax_params`` gives the
    tree back exactly.  Through the reference's keys (the JAX package's
    ``convert_backbone_state_dict``) it comes back only where the tree holds
    no more than the reference: with zero qkv biases and tables equal
    across heads; a tree with its own qkv biases and per-head tables does
    not survive that trip (ROADMAP Queue C)."""
    variables = jax_variables()
    state = state_dict_from_jax(variables, "swin_t")
    back = swin_jax_params(state, SMALL["downscaling_factors"])
    flat_in = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, val in flat_in:
        np.testing.assert_array_equal(flat_out[path], val, err_msg=jax.tree_util.keystr(path))

    def reference_trip(tree):
        port = state_dict_from_jax(tree, "swin_t")
        return convert_backbone_state_dict(_to_reference(port), "swin_t", tree)["params"]

    def reference_shaped(tree):
        def fix(path, a):
            key = path[-1].key
            if key == "bias" and path[-2].key == "qkv":
                return np.zeros_like(a)
            if key == "rel_pos_bias":
                return np.repeat(a[:, :1], a.shape[1], axis=1)
            return a
        return {"params": jax.tree_util.tree_map_with_path(fix, tree["params"])}

    shaped = reference_shaped(variables)
    for path, val in jax.tree_util.tree_leaves_with_path(shaped["params"]):
        got = dict(jax.tree_util.tree_leaves_with_path(reference_trip(shaped)))[path]
        np.testing.assert_array_equal(np.asarray(got), val, err_msg=jax.tree_util.keystr(path))
    lost = dict(jax.tree_util.tree_leaves_with_path(reference_trip(variables)))
    changed = [jax.tree_util.keystr(p) for p, v in flat_in if not np.array_equal(lost[p], v)]
    assert changed and all("qkv" in p or "rel_pos_bias" in p for p in changed)


@pytest.mark.parametrize("cell", ["ProtoNet:swin_t", "ProtoNet:swin_mini"])
def test_chip_cells_swap_only_the_backbone(cell):
    """``chip_smoke.py``'s phase-23 cells are the shipped ProtoNet cell with
    the backbone swapped at its JAX defaults; swin_t's 768 and swin_mini's
    384 flat features at ``[1, 128, 157]``."""
    from audio_fewshot_tpu_torch.eval import slice_config

    ours, shipped = slice_config(classifier=cell), slice_config(classifier="ProtoNet")
    differ = {k for k in set(ours) | set(shipped) if ours.get(k) != shipped.get(k)}
    assert differ <= {"backbone", "tag"}
    name = cell.partition(":")[2]
    assert ours["backbone"] == {"name": name, "kwargs": {"num_channels": 1}}
    with torch.device("meta"):
        method = build_method(ours)
    assert method.emb_func.feature_dim(FULL) == {"swin_t": 768, "swin_mini": 384}[name]

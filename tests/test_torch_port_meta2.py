"""MTL, MeTAL (both loss-net paths), LEO and VERSA of the PyTorch port
against the JAX package on the CPU, at the same weights: the JAX package's
variable trees drawn with numpy (its compiled inits alone take 2-10 s each
on the CPU), random BN statistics, biases and, on MeTAL's per-step path,
adapter gates, carried across by ``utils/convert.py``.

Geometry: MeTAL, LEO and VERSA on ``test_torch_port_meta.py``'s Conv64F
(``is_flatten``, ``[1, 81, 90]`` segments, 1600 features, 3-way 2-shot
2-query); MTL on ``test_torch_port_resnet12_heads.py``'s narrow resnet12
(planes 8/12/16/20 on ``[1, 96, 112]``, 120 features flat, 3-way 3-shot
2-query).  Each head as shipped (MeTAL 5 + 5 steps at 0.01, MTL 100 at
0.01, LEO's latent and fine-tune loops 5 + 5 at 0.01, VERSA 10 samples of
d_theta 256), but LEO's ``hid_dim`` 16 and MTL's inner loop 10 steps;
MeTAL's per-step path (no shipped config) with 5 + 5 steps.

The JAX references are jitted and made once per file: the backbone's
features come from one jitted embedding per backbone (float64 blocks, the
map rounded to float32 as both packages cast it), shared by the heads;
each head's reference is the JAX method's own ``forward`` or ``loss``
(``jax.grad`` through its ``lax.scan``, second order) with ``embed``
returning those features, and the backbone's gradient is the jitted VJP
of the same embedding at the head's feature cotangents (the chain rule
the JAX package's whole-method ``jax.grad`` applies).  LEO's and VERSA's
Gaussian draws are the arrays the JAX package draws from its keys
(``PRNGKey(0)`` in eval; the loss's key split as its ``loss`` splits it),
handed to both packages' samplers.

Tolerances (relative to the logits' scale, or to a gradient's max abs):
- eval logits against the float64 JAX head: the port in float32 to 1e-4
  (``LOGIT_TOL``), with float64 blocks to 3e-5 (``F64_LOGIT_TOL``; MeTAL's
  per-step path 1e-4: its float32 head alone is 2.8e-5 off); the real rows
  with and without 2 bucket-padded query rows, 1e-6 (``PAD_TOL``; the
  per-step path 2e-5, exact with a float64 head); at zero noise the port's
  float64 head over the JAX features, 1e-10 (``HEAD64_TOL``);
- one train step, Dropout the identity in both packages: loss and logits
  3e-5 of the logits' scale, every gradient 5e-4 of its max abs (a tenth of
  the largest where that is more; ``GRAD_TOL``), running statistics 1e-5,
  the port with float64 and with float32 blocks (MTL with float32 resnet12
  blocks 2e-2, ``F32_RESNET_TOLS``: measured 1.0e-2, as the JAX package's
  own float32 resnet12 steps); LEO's frozen-backbone
  step with the port's float64 head over the JAX features, 1e-10 (loss,
  logits) and 1e-9 (gradients; measured 1.8e-11), and in float32 end to
  end its loss and logits at 1e-4 (``check_leo_step``); the first-order
  step (MTL, MeTAL, LEO) must miss the gradients by more than ten times
  ``GRAD_TOL``.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.heads import metal as jax_metal  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.episode import segment_targets  # noqa: E402
from audio_fewshot_tpu_torch.eval import SLICE_MODELS, slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.base import masked_cross_entropy  # noqa: E402
from audio_fewshot_tpu_torch.models.heads import metal  # noqa: E402
from audio_fewshot_tpu_torch.train import slice_config as train_cell  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    head_state_dict_from_jax, state_dict_from_jax)
from tools.cross_framework_parity import (  # noqa: E402
    invert_leo_head_params, invert_maml_head_params, invert_metal_per_step_params,
    invert_mtl_head_params, invert_versa_head_params)

import test_torch_port_meta as conv_geom  # noqa: E402
import test_torch_port_resnet12_heads as resnet_geom  # noqa: E402
from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_metric import _rel, _running, no_dropout  # noqa: E402,F401
from test_torch_port_resnet12_heads import _check_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4
F64_LOGIT_TOL = 3e-5
PAD_TOL = 1e-6
HEAD64_TOL = 1e-10
HEAD64_STEP_TOLS = {"logits": HEAD64_TOL, "grads": 1e-9, "vanishing": 1e-9, "stats": 0.0}
# MeTAL's per-step path at random adapter gates amplifies float32 rounding:
# its real rows move 8.6e-6 of the scale with the padding in float32, not at
# all with a float64 head (``test_metal_per_step_padding_is_exact_in_float64``)
PAD_TOLS = {"MeTAL:per_step": 2e-5}
# and its float32 head alone is 2.8e-5 of the scale off a float64 one: the
# float64 blocks cannot bring it nearer than the float32 port
F64_LOGIT_TOLS = {"MeTAL:per_step": LOGIT_TOL}
GRAD_TOL = 5e-4
STEP_TOLS = {"logits": 3e-5, "grads": GRAD_TOL, "vanishing": 1e-3, "stats": 1e-5}
# MTL with float32 resnet12 blocks: 1.0e-2 of a gradient's max abs from the
# JAX package's float64 step (6.7e-7 with float64 blocks; the JAX package's
# own float32 resnet12 step is 7e-3 to 5e-2 off its float64 one)
F32_RESNET_TOLS = dict(STEP_TOLS, grads=2e-2, vanishing=2e-2)
KWARGS = {
    "MTL": {"inner_param": {"iter": 10, "lr": 0.01}},
    "MeTAL": {"inner_param": {"lr": 0.01, "train_iter": 5, "test_iter": 5}},
    "MeTAL:per_step": {"inner_param": {"lr": 0.01, "train_iter": 5, "test_iter": 5,
                                       "per_step_adapters": True}},
    "LEO": {"hid_dim": 16, "kl_weight": 0.001, "encoder_penalty_weight": 1e-9,
            "orthogonality_penalty_weight": 0.001,
            "inner_para": {"iter": 5, "lr": 0.01, "finetune_iter": 5, "finetune_lr": 0.01}},
    "VERSA": {"sample_num": 10, "d_theta": 256, "drop_rate": 0.5},
}
HEADS = list(KWARGS)


def _resnet(name):
    return name == "MTL"


def geometry(name):
    """(setting, the batch maker) of ``name``'s backbone."""
    if _resnet(name):
        return resnet_geom.SETTING, resnet_geom._batches
    return conv_geom.SETTING, functools.partial(conv_geom.batches, "Conv64F")


def head_config(name, dtype=None, drop_rate=0.1):
    """The head on its test backbone, float32 (``MeTAL:per_step``: the
    per-step path)."""
    if _resnet(name):
        cfg = resnet_geom.head_config(name, dtype=dtype, drop_rate=drop_rate)
    else:
        cfg = conv_geom.meta_config("Conv64F", dtype=dtype)
    cfg["classifier"] = {"name": name.partition(":")[0], "kwargs": KWARGS[name]}
    return cfg


def _backbone(name):
    return "resnet12" if _resnet(name) else "Conv64F"


@functools.lru_cache(maxsize=None)
def _backbone_variables(backbone):
    """The JAX package's backbone tree (its shapes from ``init``, traced, not
    compiled: resnet12's compiled init alone takes 10 s here), drawn with
    numpy: kernels N(0, 1/fan_in), BN scale 1 and the rest 0 (then
    randomised by ``randomize_batchnorm``)."""
    name = "MTL" if backbone == "resnet12" else "MeTAL"
    setting, make = geometry(name)
    method = jax_build_method(head_config(name))
    x = method._flatten_inputs(make(1)[0])[:1]
    shapes = jax.eval_shape(lambda key: method.emb_func.init(method._rngs(key), x, train=True),
                            jax.random.PRNGKey(0))
    return draw_tree(shapes, np.random.default_rng(0))


def draw_tree(shapes, rng):
    """numpy draws for a tree of JAX shapes: every weight of two axes or more
    (kernels, embeddings, MeTAL's stacked per-step weights) N(0, 1/fan_in),
    fan_in the product of all axes but the last; BN scale and variance 1;
    the rest 0."""
    def draw(path, leaf):
        key = path[-1].key
        if len(leaf.shape) >= 2:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, size=leaf.shape).astype(leaf.dtype)
        return (np.ones if key in ("scale", "var") else np.zeros)(leaf.shape, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def jax_variables(name):
    """The JAX method's variables: its backbone's tree from
    ``_backbone_variables``, its head's the tree of the JAX package's own
    ``_init_head`` (traced; the heads read only the features' shape), both
    drawn with numpy (``draw_tree``), with random BN statistics and biases;
    on the per-step path random adapter gates and loss-net biases (their
    zero init makes the adapters identities)."""
    setting, make = geometry(name)
    jb, _ = make(1)
    method = jax_build_method(head_config(name))
    width = 120 if _resnet(name) else 1600

    def init_head(key):
        head = {"params": {}, "batch_stats": {}}
        method._init_head(head, method._rngs(key), jnp.zeros((2, width)), jb, setting)
        return head

    head = draw_tree(jax.eval_shape(init_head, jax.random.PRNGKey(0)),
                     np.random.default_rng(2))
    variables = {}
    method._merge_init(variables, "emb_func", _backbone_variables(_backbone(name)))
    for col, tree in head.items():
        variables.setdefault(col, {}).update(tree)
    rng = np.random.default_rng(1)
    variables = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, variables), rng)
    if name == "MeTAL:per_step":
        params = variables["params"]
        for net in ("meta_loss", "meta_query_loss", "meta_loss_adapter",
                    "meta_query_loss_adapter"):
            for key, val in params[net].items():
                if key in ("b1", "b2", "multiplier_bias", "offset_bias"):
                    params[net][key] = rng.normal(0.0, 0.5, size=val.shape).astype(np.float32)
    return variables


def as_port(variables, name, params=None, stats=None):
    """The port's state dict (numpy) of ``variables`` with ``params`` or
    ``batch_stats`` in place of their own."""
    tree = {"params": variables["params"] if params is None else params,
            "batch_stats": variables.get("batch_stats", {}) if stats is None else stats}
    return {k: v.numpy() for k, v in state_dict_from_jax(
        tree, _backbone(name), prefix="emb_func.", classifier=name.partition(":")[0]).items()}


def port_method(name, variables, dtype=torch.float32, drop_rate=0.1):
    method = build_method(head_config(name, drop_rate=drop_rate))
    method.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in as_port(variables, name).items()})
    if dtype == torch.float64:  # the blocks only: the features and the head stay float32
        emb = method.emb_func
        emb.dtype = dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(dtype)
    return method


# -- the JAX references --------------------------------------------------------------------

def _jax_method64(name, drop_rate):
    """The JAX method with float64 blocks (resnet12's at ``drop_rate``), its
    shape-sized modules made."""
    setting, make = geometry(name)
    with jax.enable_x64(True):
        method = jax_build_method(head_config(name, dtype="float64", drop_rate=drop_rate))
        jb = make(1)[0]
        jax.eval_shape(lambda key: method.init_variables(key, jb, setting),
                       jax.random.PRNGKey(0))
    return method


class _fed_normal:
    """``jax.random.normal`` returns the given array of the shape asked while
    a reference is traced (the JAX heads draw their noise through it; LEO
    draws its decoder noise from one key at every decode)."""

    def __init__(self, arrays):
        self.arrays = {tuple(a.shape): a for a in arrays}
        assert len(self.arrays) == len(arrays)

    def __enter__(self):
        self.orig = jax.random.normal

        def normal(key, shape=(), dtype=None):
            return self.arrays[tuple(shape)]

        jax.random.normal = normal

    def __exit__(self, *exc):
        jax.random.normal = self.orig


class _no_flax_dropout:
    def __enter__(self):
        self.orig = flax_nn.Dropout.__call__
        flax_nn.Dropout.__call__ = lambda self, x, *a, **k: x

    def __exit__(self, *exc):
        flax_nn.Dropout.__call__ = self.orig


def _embed_fn(name, train):
    """The jitted JAX embedding of ``name``'s backbone (float64 blocks, one
    compile per backbone and mode, the heads' variables as arguments): eval
    ``(variables, batch) → (sup, qry)``; train ``(variables, batch, ct_sup,
    ct_qry) → (sup, qry, batch_stats updates, the backbone's VJP at the
    cotangents)``, Dropout off."""
    return _backbone_embed_fn("MTL" if _resnet(name) else "MeTAL", train)


@functools.lru_cache(maxsize=None)
def _backbone_embed_fn(name, train):
    method = _jax_method64(name, 0.0 if train else 0.1)
    if not train:
        return jax.jit(lambda v, b: method.embed(v, b, train=False)[:2])

    def fn(variables, batch, ct_sup, ct_qry):
        def emb(p):
            v = {**variables, "params": {**variables["params"], "emb_func": p}}
            with _no_flax_dropout():
                sup, qry, upd = method.embed(v, batch, train=True, rng=jax.random.PRNGKey(1))
            return (sup, qry), upd

        (sup, qry), vjp, upd = jax.vjp(emb, variables["params"]["emb_func"], has_aux=True)
        return sup, qry, upd, vjp((ct_sup, ct_qry))[0]

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _head_fn(name, train):
    """The jitted JAX ``forward`` (eval) or ``value_and_grad`` of ``loss``
    over (params, support features, query features) (train) of ``name``
    with ``embed`` returning the given features and ``jax.random.normal``
    the given noise."""
    setting, _ = geometry(name)
    method = _jax_method64(name, 0.0 if train else 0.1)

    def with_feats(sup, qry, noise, call):
        method.embed = lambda *a, **k: (sup, qry, {})
        with _fed_normal(noise), _no_flax_dropout():
            return call()

    if not train:
        return jax.jit(lambda v, b, sup, qry, noise: with_feats(
            sup, qry, noise, lambda: method.forward(v, b, setting)))

    def loss(params, others, batch, sup, qry, noise):
        return with_feats(sup, qry, noise, lambda: method.loss(
            {**others, "params": params}, batch, setting, jax.random.PRNGKey(1)))

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 3, 4), has_aux=True))


def jax_noise(name, key, e, g):
    """The Gaussian draws the JAX package takes from ``key`` for ``e``
    episodes of ``g`` query rows: LEO's latent and decoder draws (``key``
    split), VERSA's samples (``key``'s second half in ``loss``, ``key``
    itself in ``forward``); none for the other heads."""
    setting, _ = geometry(name)
    if name == "LEO":
        r_enc, r_dec = jax.random.split(key)
        hid = KWARGS["LEO"]["hid_dim"]
        return [np.asarray(jax.random.normal(r_enc, (e, setting.way, hid))),
                np.asarray(jax.random.normal(r_dec, (e, setting.way, 1600)))]
    if name == "VERSA":
        return [np.asarray(jax.random.normal(key, (KWARGS["VERSA"]["sample_num"], e, g,
                                                   setting.way)))]
    return []


def _wide(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)


@functools.lru_cache(maxsize=None)
def eval_reference(name, zero_noise=False):
    """Float64 JAX eval logits of two episodes with 2 bucket-padded query
    rows, with the noise they used; the port's padded and unpadded batches."""
    variables = jax_variables(name)
    _, make = geometry(name)
    jb, pb = make(2, pad=2, seed=5)
    _, dense = make(2, seed=5)
    with jax.enable_x64(True):
        noise = jax_noise(name, jax.random.PRNGKey(0), 2, jb.query.shape[1])
        if zero_noise:
            noise = [np.zeros_like(n) for n in noise]
        wide = _wide(variables)
        sup, qry = _embed_fn(name, False)(wide, jb)
        ref = np.asarray(_head_fn(name, False)(wide, jb, sup, qry, noise))
    return ref, noise, pb, dense


@functools.lru_cache(maxsize=None)
def step_reference(name):
    """One float64 JAX train step on one episode (Dropout off): (loss,
    logits, gradients, running statistics) under the port's names, its
    noise and the port's batch.  LEO embeds in eval mode with no gradient,
    as its ``loss`` does."""
    variables = resnet_geom._without_counters(jax_variables(name))
    _, make = geometry(name)
    jb, pb = make(1, seed=2)
    with jax.enable_x64(True):
        wide = _wide(variables)
        others = {k: v for k, v in wide.items() if k != "params"}
        noise = jax_noise(name, jax.random.split(jax.random.PRNGKey(1))[1]
                          if name == "VERSA" else jax.random.PRNGKey(1), 1, jb.query.shape[1])
        if name == "LEO":
            sup, qry = _embed_fn(name, False)(wide, jb)
        else:
            method = _jax_method64(name, 0.0)
            zeros = [np.zeros(s.shape, s.dtype) for s in jax.eval_shape(
                lambda v, b: method.embed(v, b, train=False)[:2], wide, jb)]
            sup, qry, _, _ = _embed_fn(name, True)(wide, jb, *zeros)
        (loss, out), (grads, g_sup, g_qry) = _head_fn(name, True)(
            wide["params"], others, jb, sup, qry, noise)
        grads = jax.tree_util.tree_map(np.asarray, grads)
        stats = {}
        feats = [torch.from_numpy(np.asarray(f)) for f in (sup, qry)]
        if name != "LEO":
            _, _, upd, g_emb = _embed_fn(name, True)(wide, jb, g_sup.astype(sup.dtype),
                                                     g_qry.astype(qry.dtype))
            grads["emb_func"] = jax.tree_util.tree_map(np.asarray, g_emb)
            stats = dict(jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
            stats.update(jax.tree_util.tree_map(np.asarray, (out.updates or {}).get(
                "batch_stats", {})))
    port_stats = {k: v for k, v in as_port(variables, name, stats={
        **variables.get("batch_stats", {}), **stats}).items()
        if k.endswith(("mean", "var"))} if stats else {}
    return (float(loss), np.asarray(out.seg_logits), as_port(variables, name, params=grads),
            port_stats), noise, pb, feats


def feed_noise(method, arrays):
    """The port's sampler draws ``arrays`` in turn, cut to the shape asked
    (VERSA's unpadded batch takes the padded draws' real rows); returns the
    list of the shapes drawn."""
    drawn, state = [], {"i": 0}

    def draw(shape, like):
        arr = arrays[state["i"] % len(arrays)]
        state["i"] += 1
        drawn.append(tuple(shape))
        cut = arr[tuple(slice(0, n) for n in shape)]
        return torch.tensor(cut, dtype=like.dtype)

    if hasattr(method, "noise"):
        method.noise.draw = draw
    return drawn


# -- eval logits ---------------------------------------------------------------------------

def check_eval_logits(name, zero_noise=False):
    ref, noise, pb, dense = eval_reference(name, zero_noise)
    setting, _ = geometry(name)
    g = setting.way * setting.query
    for dtype, tol in ((torch.float32, LOGIT_TOL),
                       (torch.float64, F64_LOGIT_TOLS.get(name, F64_LOGIT_TOL))):
        method = port_method(name, jax_variables(name), dtype).eval()
        drawn = feed_noise(method, noise)
        with torch.no_grad():
            ours = method(pb, setting).numpy()
            unpadded = method(dense, setting).numpy()
        assert ours.shape == ref.shape == (2, g + 2, setting.way)
        assert _rel(ours, ref) <= tol, (dtype, _rel(ours, ref))
        np.testing.assert_allclose(ours[:, :g], unpadded, rtol=0,
                                   atol=PAD_TOLS.get(name, PAD_TOL) * np.abs(ref).max())
        assert len(drawn) == 2 * len(noise)
    assert np.ptp(ref[:, :g], axis=-1).max() > 10 * LOGIT_TOL * np.abs(ref).max()


@pytest.mark.parametrize("name", HEADS)
def test_eval_logits_match_jax_and_ignore_bucket_padding(name):
    """Eval logits of two episodes with 2 bucket-padded query rows against
    the JAX package's float64 evaluation (LEO and VERSA on the draws of its
    ``PRNGKey(0)``); the real rows' are the port's own on the unpadded
    batch.  MeTAL's per-step path at adapter gates off identity."""
    check_eval_logits(name)


@pytest.mark.parametrize("name", ["LEO", "VERSA"])
def test_eval_logits_at_zero_noise_match_jax(name):
    """With every Gaussian draw zero (the samplers' means), in both
    packages: the port's head in float64 over the JAX package's features
    against its float64 head, to 1e-10 of the scale (``HEAD64_TOL``).  LEO's
    mean-only weights make its logits a near cancellation: with the port's
    own float32 features they read up to 8.7e-4 of the scale off."""
    ref, noise, pb, _ = eval_reference(name, zero_noise=True)
    setting, make = geometry(name)
    jb = make(2, pad=2, seed=5)[0]
    with jax.enable_x64(True):
        feats = [torch.from_numpy(np.asarray(f)) for f in _embed_fn(name, False)(
            _wide(jax_variables(name)), jb)]
    method = port_method(name, jax_variables(name)).eval().double()
    method.embed = lambda batch: tuple(feats)
    drawn = feed_noise(method, noise)
    with torch.no_grad():
        ours = method(pb, setting).numpy()
    assert len(drawn) == len(noise) and not any(n.any() for n in noise)
    assert _rel(ours, ref) <= HEAD64_TOL


def test_metal_per_step_padding_is_exact_in_float64():
    """With a float64 head over the same features, the per-step path's real
    rows are the same with and without bucket padding to 1e-12 of the scale
    (the masked sums add their zeros in another order)."""
    name = "MeTAL:per_step"
    setting, make = geometry(name)
    _, pb = make(2, pad=2, seed=5)
    _, dense = make(2, seed=5)
    method = port_method(name, jax_variables(name)).eval()
    with torch.no_grad():
        feats = {id(b): tuple(f.double() for f in method.embed(b)) for b in (pb, dense)}
        method.double()
        method.embed = lambda b: feats[id(b)]
        padded, unpadded = method(pb, setting), method(dense, setting)
    assert _rel(padded[:, :setting.way * setting.query].numpy(), unpadded.numpy()) <= 1e-12


# -- one train step ---------------------------------------------------------------------------

SECOND_ORDER = ("MTL", "MeTAL", "MeTAL:per_step", "LEO")


def _first_order_grads(method, pb, setting):
    if type(method).__name__ == "LEO":
        loss, _ = method.loss(pb, setting, second_order=False)
    else:
        n = method.inner_iter if hasattr(method, "inner_iter") else method.train_iter
        logits = method._run(pb, setting, n, second_order=False)
        loss = masked_cross_entropy(logits, segment_targets(pb), pb.query_mask)
    loss.backward()
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in method.named_parameters()}


@pytest.mark.parametrize("name", HEADS)
def test_train_step_matches_jax_float64(name, no_dropout):
    """Loss, logits, every gradient (the backbone's through the features,
    the head's and the learned losses' through the inner loops, second
    order) and the running statistics of one train step against the JAX
    package's float64 step; for the heads with an inner loop the first-order
    step misses the gradients.  LEO: the backbone gets no gradient and keeps
    its statistics."""
    ref, noise, pb, feats = step_reference(name)
    setting, _ = geometry(name)
    variables = resnet_geom._without_counters(jax_variables(name))
    if name == "LEO":
        check_leo_step(ref, noise, pb, feats)
    else:
        f32 = F32_RESNET_TOLS if _resnet(name) else STEP_TOLS
        for dtype, tols in ((torch.float64, STEP_TOLS), (torch.float32, f32)):
            method = port_method(name, variables, dtype, drop_rate=0.0).train()
            feed_noise(method, noise)
            loss, out = method.loss(pb, setting)
            loss.backward()
            named = dict(method.named_parameters())
            for p in named.values():  # a loss-net bias, an unused step's set: 0 in JAX
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _check_step(named, _running(method), loss, out, ref, tols)
            assert _running(method)
    if name not in SECOND_ORDER:
        return
    method = port_method(name, variables, torch.float64, drop_rate=0.0).train()
    if name == "LEO":
        method.double().embed = lambda batch: tuple(feats)
    feed_noise(method, noise)
    first = _first_order_grads(method, pb, setting)
    grads = ref[2]
    largest = max(np.abs(grads[k]).max() for k in first)
    missed = max(np.abs(g.double().numpy() - grads[k].reshape(g.shape)).max()
                 / max(np.abs(grads[k]).max(), 0.1 * largest) for k, g in first.items())
    assert missed > 10 * GRAD_TOL


def check_leo_step(ref, noise, pb, feats):
    """LEO's backbone is frozen (no gradient, no statistics), so its step is
    the head's over the features: the port's head in float64 over the JAX
    package's features against its float64 step (``HEAD64_STEP_TOLS``), and
    the float32 port end to end, its loss and logits at ``LOGIT_TOL``.  Its
    gradients are ill-conditioned at these weights (the features moved by
    4e-7 move them by 5e-3 even in float64), so the float32 port's are not
    held to ``GRAD_TOL``."""
    setting, _ = geometry("LEO")
    variables = jax_variables("LEO")
    method = port_method("LEO", variables).train().double()
    method.embed = lambda batch: tuple(feats)
    feed_noise(method, noise)
    loss, out = method.loss(pb, setting)
    loss.backward()
    named = {k: p for k, p in method.named_parameters() if not k.startswith("emb_func.")}
    _check_step(named, {}, loss, out, ref, HEAD64_STEP_TOLS)
    method = port_method("LEO", variables).train()
    feed_noise(method, noise)
    loss, out = method.loss(pb, setting)
    loss.backward()
    assert all(p.grad is None for k, p in method.named_parameters() if k.startswith("emb_func."))
    assert not _running(method) or all(torch.equal(v, torch.from_numpy(
        np.asarray(as_port(variables, "LEO")[k]))) for k, v in _running(method).items())
    assert abs(loss.item() - ref[0]) <= LOGIT_TOL * max(np.abs(ref[1]).max(), ref[0])
    assert _rel(out.seg_logits.detach().numpy(), ref[1]) <= LOGIT_TOL


# -- the pieces ---------------------------------------------------------------------------------

def test_metal_normalisations_are_bessel_corrected_and_masked():
    """``_normalize`` divides by the ddof=1 standard deviation (+ 1e-12) over
    each episode's whole array; ``_normalize_rows`` over the real rows only,
    as the JAX package's."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 7))
    ours = metal._normalize(torch.from_numpy(x)).numpy()
    flat = x.reshape(3, -1)
    expect = (x - flat.mean(1)[:, None, None]) / (flat.std(1, ddof=1)[:, None, None] + 1e-12)
    np.testing.assert_allclose(ours, expect, rtol=1e-12)
    assert _rel(ours, (x - flat.mean(1)[:, None, None]) / flat.std(1)[:, None, None]) > 1e-3
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], np.float64)
    rows = metal._normalize_rows(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    with jax.enable_x64(True):
        for e in range(3):
            ref = np.asarray(jax_metal._normalize_rows(x[e], mask[e]))
            np.testing.assert_allclose(rows[e], ref, rtol=1e-12, atol=1e-12)
            assert np.allclose(np.asarray(jax_metal._normalize(x[e])), ours[e])


def test_metal_step_limits():
    """The per-step path sizes its nets by ``test_iter``: a longer
    ``train_iter`` raises, as the default path past 64 steps; the step
    embedding has 64 rows, the adapters start as identities."""
    cfg = head_config("MeTAL:per_step")
    cfg["classifier"]["kwargs"] = {"inner_param": {"train_iter": 6, "test_iter": 5,
                                                   "per_step_adapters": True}}
    with pytest.raises(ValueError, match="test_iter"):
        build_method(cfg)
    cfg["classifier"]["kwargs"] = {"inner_param": {"train_iter": 5, "test_iter": 65}}
    with pytest.raises(ValueError, match="64"):
        build_method(cfg)
    method = build_method(head_config("MeTAL:per_step"))
    assert len(method.meta_loss.layer_dict) == len(method.meta_loss_adapter.loss_adapter) == 5
    x = torch.randn(2, 3)
    assert all(torch.equal(m, torch.zeros(2)) and torch.equal(o, torch.zeros(2))
               for m, o in method.meta_loss_adapter(x, 0))
    assert build_method(head_config("MeTAL")).meta_loss.step_emb.weight.shape == (64, 8)


def test_leo_reuses_one_decoder_draw_and_freezes_the_backbone():
    """An LEO forward draws twice, the latent's ``[E, way, hid]`` and the
    decoder's ``[E, way, D]``, the latter reused at every latent step and
    at the final decode; an eval forward repeats its draws; ``loss`` runs
    the backbone in eval mode under ``no_grad`` while the module trains."""
    method = port_method("LEO", jax_variables("LEO"))
    _, pb = geometry("LEO")[1](2, seed=3)
    setting = geometry("LEO")[0]
    calls = []
    draw = method.noise.draw
    method.noise.draw = lambda shape, like: calls.append(tuple(shape)) or draw(shape, like)
    with torch.no_grad():
        first = method.eval()(pb, setting)
        again = method(pb, setting)
    assert calls == [(2, 3, 16), (2, 3, 1600)] * 2
    assert torch.equal(first, again)
    method.train()
    loss, _ = method.loss(pb, setting)
    assert method.emb_func.training and loss.requires_grad
    assert all(v.grad_fn is None for v in method._features(pb))


def test_versa_batch_statistics_span_the_batch():
    """VERSA's trunk BN normalises over the support and real query rows of
    every episode at once, in eval too: an episode's logits move when
    another episode's support changes (the backbone's running statistics
    alone would not move them), and the running statistics a train step
    leaves are the masked batch moments of the trunk's Linear."""
    method = port_method("VERSA", jax_variables("VERSA")).eval()
    setting, make = geometry("VERSA")
    _, pb = make(2, pad=2, seed=3)
    feed_noise(method, [np.zeros((10, 2, 8, 3))])
    other = pb.replace(support=pb.support.clone())
    other.support[1] *= 2.0
    with torch.no_grad():
        base, moved = method(pb, setting), method(other, setting)
    assert not torch.allclose(base[0], moved[0])
    before = method.h[1].running_mean.clone()
    rows = []
    hook = method.h[0].register_forward_hook(lambda mod, args, out: rows.append(out.detach()))
    with torch.no_grad():
        method.train().loss(pb, setting)
    hook.remove()
    real = torch.cat([torch.ones(pb.support.shape[:2], dtype=torch.bool),
                      pb.query_mask > 0], dim=1)
    real = torch.cat([real[:, :6].reshape(-1), real[:, 6:].reshape(-1)])
    for mean, close in ((rows[0][real].mean(0), True), (rows[0].mean(0), False)):
        expect = 0.9 * before + 0.1 * mean
        assert torch.allclose(method.h[1].running_mean, expect, atol=1e-6) == close


# -- the weights across --------------------------------------------------------------------

INVERTERS = {"MTL": invert_mtl_head_params, "LEO": invert_leo_head_params,
             "VERSA": invert_versa_head_params,
             "MeTAL:per_step": lambda v: {**invert_maml_head_params(v),
                                          **invert_metal_per_step_params(v)}}


@pytest.mark.parametrize("name", HEADS)
def test_head_weights_cross_under_the_reference_names(name):
    """``utils/convert.py``'s head entries are ``tools/cross_framework_parity.py``'s
    inverters' (MTL's ``vars.{0,1}`` aliases excepted: the port holds
    ``fc1_w`` / ``fc1_b`` once), MeTAL's default path under flax's names,
    and the whole converted state loads into the port strictly."""
    variables = jax_variables(name)
    ours = head_state_dict_from_jax(variables, name.partition(":")[0])
    if name in INVERTERS:
        ref = INVERTERS[name](variables)
        if name == "MTL":
            for i, key in enumerate(("fc1_w", "fc1_b")):
                np.testing.assert_array_equal(ref.pop(f"base_learner.vars.{i}"),
                                              ref[f"base_learner.{key}"])
        assert set(ours) == set(ref)
        for key, val in ref.items():
            np.testing.assert_array_equal(ours[key], val, err_msg=key)
    else:
        params = variables["params"]["meta_loss"]
        np.testing.assert_array_equal(ours["meta_loss.step_emb.weight"],
                                      params["step_emb"]["embedding"])
        np.testing.assert_array_equal(ours["meta_loss.fc1.weight"], params["fc1"]["kernel"].T)
    method = build_method(head_config(name))
    head_keys = {k for k in method.state_dict()
                 if not k.startswith("emb_func.") and not k.endswith("num_batches_tracked")}
    assert head_keys == set(ours)
    port_method(name, variables)


# -- the chip cells ------------------------------------------------------------------------------

SHIPPED = {"MeTAL": "metal", "MTL": "mtl", "LEO": "leo", "VERSA": "versa",
           "DMatchingNet": "ifsl"}


@pytest.mark.parametrize("kind", ["eval", "train"])
@pytest.mark.parametrize("name", list(SHIPPED))
def test_chip_cells_are_the_shipped_configs_cut_to_size(name, kind, tmp_path):
    """The cells ``chip_smoke.py`` runs are each head's shipped
    ``*_5shot_iid_seed0.yaml`` (``backbones/Conv64F.yaml``; MTL's
    ``backbones/resnet12.yaml``) with its headers but for the cuts they
    name; each builds at full width (1600 flat Conv64F features, 12800 of
    resnet12 for MTL)."""
    shipped = Config(os.path.join(REPO, "config", SHIPPED[name],
                                  f"{SHIPPED[name]}_5shot_iid_seed0.yaml")).get_config_dict()
    assert name in SLICE_MODELS
    if kind == "eval":
        cell = eval_cell(classifier=name, test_episode=32, test_epoch=1)
        cuts = {"test_episode": (600, 32), "test_epoch": (5, 1), "test_episode_size": (None, 16),
                "max_segments_per_clip": (8, 6), "spec_shape": (None, [1, 128, 157])}
        kept = ("classifier", "backbone", "modality", "test_way", "test_shot", "test_query",
                "augment_times", "seed", "ood", "tag", "episode_size")
    else:
        cell = train_cell(str(tmp_path), classifier=name, epoch=1, train_episode=20,
                          test_episode=16)
        cuts = {"epoch": (30, 1), "train_episode": (1000, 20), "test_episode": (600, 16),
                "result_root": ("./results", str(tmp_path)), "tb_scale": (1000 / 600, 20 / 16),
                "spec_shape": (None, [1, 128, 157])}
        kept = [k for k in shipped if k not in cuts and k != "includes"]
    for key, (full, cut) in cuts.items():
        assert (shipped.get(key), cell.get(key)) == (full, cut), key
    for key in kept:
        assert cell.get(key) == shipped.get(key), key
    if kind == "train":
        return
    model = build_method(cell)
    width = model.emb_func.feature_dim(cell["spec_shape"])
    assert width == (12800 if name == "MTL" else 1600)
    head = {"MeTAL": lambda m: m.classifier.layers[0].weight,
            "MTL": lambda m: m.base_learner.fc1_w,
            "LEO": lambda m: m.encoder.encoder_func.weight,
            "VERSA": lambda m: m.h[0].weight.T,
            "DMatchingNet": lambda m: m.utils.linear.weight}[name](model)
    assert width in head.shape

"""DMatchingNet (IFSL over a matching network) of the PyTorch port against
the JAX package on the CPU, at the same weights (the JAX package's trees
drawn with numpy as in ``test_torch_port_meta2.py``, random BN statistics
and biases, carried across by ``utils/convert.py``).

Geometry: ``test_torch_port_meta.py``'s Conv64F (``is_flatten``, ``[1, 81,
90]`` segments, 1600 features, 3-way 2-shot 2-query), its BNs on batch
statistics and its logits BN1d on running ones, as ``build_method`` gives
DMatchingNet; ``ifsl_param`` as shipped (25 classes, temp 10) but 2 splits
(two 800-wide blocks), the other options at one variant.  The JAX
DMatchingNet runs in float32 only (its flax LSTM carries are float32), so
every reference is the JAX package's float32 evaluation, jitted once.

Tolerances (relative to the logits' scale, or to a gradient's max abs):
- one ``MatchingNetLayer`` (the bidirectional support LSTM, the FCE loop)
  against flax's at random weights and biases: 1e-5 (``LAYER_TOL``);
- log-probabilities (eval, the dual branch through the whole method: each
  episode's support and query embedded apart, the query call masked):
  1e-4 (``LOGIT_TOL``); the real rows with and without 2 bucket-padded
  query rows: 1e-6 (``PAD_TOL``);
- the heads alone over the same features (the ``single`` branch, the
  options variant, a train step's loss, log-probabilities, head gradients
  and feature gradients): 1e-4 of the scale, gradients 1e-3 of their max
  abs (``HEAD_GRAD_TOL``; float32 through two LSTMs and their backward);
- the logits BN1d's running statistics after a train-mode pass over two
  episodes against the JAX package's mean of the episodes' updates: 1e-5.
"""

import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.heads import ifsl as jax_ifsl  # noqa: E402
from audio_fewshot_tpu_torch.episode import segment_targets  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.heads import ifsl  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    _lstm_cell, head_state_dict_from_jax, state_dict_from_jax)
from tools.cross_framework_parity import invert_dmatchingnet_head_params  # noqa: E402

import test_torch_port_meta as conv_geom  # noqa: E402
from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_meta2 import _backbone_variables, _no_flax_dropout, draw_tree  # noqa: E402
from test_torch_port_metric import _rel, _running, no_dropout  # noqa: E402,F401

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
PAD_TOL = 1e-6
HEAD_GRAD_TOL = 1e-3
STATS_TOL = 1e-5
SETTING = conv_geom.SETTING
WAY, SHOT, QUERY = SETTING.way, SETTING.shot, SETTING.query
BASE = {"n_splits": 2, "class_num": 25, "temp": 10.0}
VARIANTS = {
    "dual": {},
    "single": {"single": True},
    # the d-feature as the class-mean features' projection, centred and
    # normalised splits, harmonic fusion
    "options": {"d_feature": "ed", "preprocess_before_split": "cl2n",
                "preprocess_after_split": "l2n", "normalize_d": True, "normalize_ed": True,
                "logit_fusion": "harmonic"},
}


def batches(e, pad=0, seed=0):
    return conv_geom.batches("DMatchingNet", e, pad=pad, seed=seed)


@functools.lru_cache(maxsize=None)
def class_features(tmpdir):
    """A ``feature_path`` file of random class-mean features [25, 1600]."""
    path = f"{tmpdir}/class_features.npy"
    np.save(path, np.random.default_rng(7).normal(size=(25, 1600)).astype(np.float32))
    return path


def config(variant="dual", feature_path=None):
    cfg = conv_geom.meta_config("Conv64F")
    param = dict(BASE, **VARIANTS[variant])
    if variant == "options":
        param["feature_path"] = feature_path
    cfg["classifier"] = {"name": "DMatchingNet", "kwargs": {"ifsl_param": param}}
    return cfg


@pytest.fixture(scope="module")
def feature_path(tmp_path_factory):
    return class_features(str(tmp_path_factory.mktemp("ifsl")))


def _concrete_features(method):
    """The class-mean features ``_init_head`` sets, as concrete arrays (a
    traced init leaves them traced)."""
    feats = (np.load(method.feature_path).astype(np.float32) if method.feature_path
             else np.zeros((method.class_num, 1600), np.float32))
    if method.normalize_d:
        feats = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-5)
    method.features = jnp.asarray(feats)
    method.mean_features = jnp.asarray(feats.mean(axis=0))
    return method


@functools.lru_cache(maxsize=None)
def jax_method(variant, feature_path=None):
    """The JAX method, its blocks made by a traced ``_init_head``."""
    method = jax_build_method(config(variant, feature_path))
    jb = batches(1)[0]
    jax.eval_shape(lambda key: method._init_head({"params": {}}, method._rngs(key),
                                                 jnp.zeros((2, 1600)), jb, SETTING),
                   jax.random.PRNGKey(0))
    return _concrete_features(method)


@functools.lru_cache(maxsize=None)
def jax_variables(variant, feature_path=None):
    """The JAX package's tree, the backbone's (``_backbone_variables``) and
    the head's (its ``_init_head``, traced: compiled, the LSTM blocks' init
    alone takes 13-19 s here), drawn with numpy (``draw_tree``), with random
    BN statistics and biases (the LSTMs' included)."""
    method = jax_build_method(config(variant, feature_path))
    jb = batches(1)[0]

    def init_head(key):
        head = {"params": {}}
        method._init_head(head, method._rngs(key), jnp.zeros((2, 1600)), jb, SETTING)
        return head

    head = draw_tree(jax.eval_shape(init_head, jax.random.PRNGKey(0)),
                     np.random.default_rng(2))
    variables = {}
    method._merge_init(variables, "emb_func", _backbone_variables("Conv64F"))
    variables["params"].update(head["params"])
    return randomize_batchnorm(jax.tree_util.tree_map(np.asarray, variables),
                               np.random.default_rng(1))


@functools.lru_cache(maxsize=None)
def _built(variant, feature_path=None):
    """The port's method, built once per variant (the 800-wide LSTMs'
    orthogonal draws take seconds)."""
    return build_method(config(variant, feature_path))


def port_method(variant, variables, feature_path=None):
    method = copy.deepcopy(_built(variant, feature_path))
    state = state_dict_from_jax(variables, "Conv64F", prefix="emb_func.",
                                classifier="DMatchingNet")
    keys = method.state_dict().keys()
    # the batch-statistics BNs of the blocks hold no running statistics
    assert all(k.endswith(("running_mean", "running_var", "num_batches_tracked"))
               for k in set(state) - set(keys))
    method.load_state_dict({k: v for k, v in state.items() if k in keys})
    return method


# -- the LSTM gates ------------------------------------------------------------------------

def test_matching_net_layer_matches_flax():
    """One ``MatchingNetLayer`` (bidirectional support LSTM, ``g = support +
    fwd + bwd``, then the FCE attention LSTM over the queries) against the
    JAX package's at random weights and gate biases: flax's i|f|g|o kernels
    and its one bias per gate map onto torch's stacked ``weight_ih`` /
    ``weight_hh`` and ``bias_ih`` (``bias_hh`` 0)."""
    d, rng = 8, np.random.default_rng(3)
    support = rng.normal(size=(6, d)).astype(np.float32)
    query = rng.normal(size=(5, d)).astype(np.float32)
    layer = jax_ifsl.MatchingNetLayer(feat_dim=d)
    variables = jax.jit(layer.init)(jax.random.PRNGKey(0), support, query)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(
        0.0, 0.3, size=a.shape).astype(np.float32), variables)
    g_ref, f_ref = jax.jit(layer.apply)(variables, support, query)
    ours = ifsl.MatchingNetLayer(d)
    p = variables["params"]
    state = {}
    for cell, sfx in (("OptimizedLSTMCell_0", ""), ("OptimizedLSTMCell_1", "_reverse")):
        for key, val in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"), _lstm_cell(p[cell])):
            state[f"G_encoder.{key}_l0{sfx}"] = torch.from_numpy(val)
    for key, val in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                        _lstm_cell(p["fce"]["cell"])):
        state[f"FCE.lstmcell.{key}"] = torch.from_numpy(val)
    ours.load_state_dict(state)
    with torch.no_grad():
        g, f = ours(torch.from_numpy(support)[None], torch.from_numpy(query)[None])
    assert _rel(g[0].numpy(), np.asarray(g_ref)) <= LAYER_TOL
    assert _rel(f[0].numpy(), np.asarray(f_ref)) <= LAYER_TOL
    assert _rel(f[0].numpy(), query) > 0.1  # the FCE moved the queries


# -- eval: the whole method --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward():
    method = jax_method("dual")
    return jax.jit(lambda v, b: method.forward(v, b, SETTING))


def test_eval_logits_match_jax_and_ignore_bucket_padding():
    """The shipped dual branch through the whole method: two episodes with 2
    bucket-padded query rows, each episode's support and query embedded in
    calls of their own on batch statistics (the query call masked to its
    real rows), the logits BN1d on running statistics; the real rows' are
    the port's own on the unpadded batch."""
    variables = jax_variables("dual")
    jb, pb = batches(2, pad=2, seed=5)
    _, dense = batches(2, seed=5)
    ref = np.asarray(_jax_forward()(variables, jb))
    method = port_method("dual", variables).eval()
    with torch.no_grad():
        ours = method(pb, SETTING).numpy()
        unpadded = method(dense, SETTING).numpy()
    g = WAY * QUERY
    assert ours.shape == ref.shape == (2, g + 2, WAY)
    assert _rel(ours, ref) <= LOGIT_TOL
    np.testing.assert_allclose(ours[:, :g], unpadded, rtol=0, atol=PAD_TOL * np.abs(ref).max())
    assert np.ptp(ref[:, :g], axis=-1).max() > 10 * LOGIT_TOL * np.abs(ref).max()
    # log-probabilities: each row's probabilities sum to 1 (+ way · 1e-6)
    np.testing.assert_allclose(np.exp(ours).sum(-1), 1.0 + WAY * 1e-6, atol=1e-5)


# -- the heads over given features ---------------------------------------------------------------

def _features(variant, variables, e, seed, feature_path=None):
    """The port's eval features of ``e`` episodes (2 padded rows), numpy."""
    _, pb = batches(e, pad=2, seed=seed)
    method = port_method(variant, variables, feature_path).eval()
    with torch.no_grad():
        sup, qry = method._embed(pb)
    return sup.numpy(), qry.numpy(), pb


@functools.lru_cache(maxsize=None)
def _jax_head(variant, feature_path=None, grad=False):
    """The JAX package's ``_episode_logprobs`` vmapped over the episodes
    (eval) or the value and gradient, over the head's parameters and the
    features, of the masked NLL of its ``loss`` (train)."""
    method = jax_method(variant, feature_path)

    def logprobs(params, sup, qry):
        return jax.vmap(lambda s, q: method._episode_logprobs(
            {"params": params}, s, q, WAY, SHOT))(sup, qry)

    if not grad:
        return jax.jit(logprobs)

    def loss(params, sup, qry, target, mask):
        lp = logprobs(params, sup, qry)
        nll = -jnp.take_along_axis(lp, target[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0), lp

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))


def _head_params(variables):
    return {k: v for k, v in variables["params"].items() if k != "emb_func"}


@pytest.mark.parametrize("variant", ["single", "options"])
def test_head_logprobs_match_jax(variant, feature_path):
    """The ``single`` branch (one block per split over ``[split ‖ pd]``, the
    counterfactual the support's mean split) and the options variant (``ed``
    from the ``feature_path`` class means, ``cl2n`` / ``l2n`` splits,
    harmonic fusion) over the port's features, against the JAX package's."""
    path = feature_path if variant == "options" else None
    variables = jax_variables(variant, path)
    sup, qry, pb = _features(variant, variables, 2, 6, path)
    ref = np.asarray(_jax_head(variant, path)(_head_params(variables), sup, qry))
    method = port_method(variant, variables, path).eval()
    with torch.no_grad():
        ours = method._logprobs(torch.from_numpy(sup), torch.from_numpy(qry), WAY, SHOT).numpy()
    assert _rel(ours, ref) <= LOGIT_TOL
    assert np.ptp(ref, axis=-1).max() > 10 * LOGIT_TOL * np.abs(ref).max()


def test_train_step_head_matches_jax(no_dropout):
    """The dual branch's train loss (the masked NLL of the log-probabilities)
    over given features: loss, log-probabilities, every head gradient and
    the features' gradients against ``jax.grad`` (jitted, 2 splits); the
    pretrained classifier, under ``no_grad``, gets none, nor the LSTMs'
    ``bias_hh``."""
    variables = jax_variables("dual")
    sup, qry, pb = _features("dual", variables, 2, 8)
    target = segment_targets(pb).long()
    mask = pb.query_mask
    (ref_loss, ref_lp), (g_params, g_sup, g_qry) = _jax_head("dual", grad=True)(
        _head_params(variables), sup, qry, target.numpy().astype(np.int32), mask.numpy())
    method = port_method("dual", variables).train()
    t_sup, t_qry = (torch.from_numpy(x).requires_grad_() for x in (sup, qry))
    method._embed = lambda batch: (t_sup, t_qry)
    loss, out = method.loss(pb, SETTING)
    loss.backward()
    scale = np.abs(np.asarray(ref_lp)).max()
    assert abs(loss.item() - float(ref_loss)) <= LOGIT_TOL * max(scale, float(ref_loss))
    assert _rel(out.seg_logits.detach().numpy(), np.asarray(ref_lp)) <= LOGIT_TOL
    grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": {**variables["params"], **jax.tree_util.tree_map(np.asarray, g_params)},
         "batch_stats": variables["batch_stats"]},
        "Conv64F", prefix="emb_func.", classifier="DMatchingNet").items()}
    named = {k: p for k, p in method.named_parameters() if not k.startswith("emb_func.")}
    assert method.utils.linear.weight.grad is None and method.utils.linear.bias.grad is None
    named = {k: p for k, p in named.items() if not k.startswith("utils.")}
    # flax's one bias per gate is bias_ih; bias_hh stays 0 and takes no gradient
    assert all(p.grad is None for k, p in named.items() if ".bias_hh" in k)
    named = {k: p for k, p in named.items() if ".bias_hh" not in k}
    largest = max(np.abs(grads[k]).max() for k in named)
    for key, p in named.items():
        ref = grads[key].reshape(p.shape)
        tol = HEAD_GRAD_TOL * max(np.abs(ref).max(), 0.1 * largest)
        assert np.abs(p.grad.numpy() - ref).max() <= tol, key
    for ours, ref in ((t_sup.grad, g_sup), (t_qry.grad, g_qry)):
        assert _rel(ours.numpy(), np.asarray(ref)) <= HEAD_GRAD_TOL


# -- the logits BN1d in training -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_train_run():
    method = jax_method("dual")

    def run(variables, batch):
        with _no_flax_dropout():
            return method._run(variables, batch, SETTING, True, jax.random.PRNGKey(1))

    return jax.jit(run)


def test_logits_bn1d_statistics_are_the_mean_over_episodes(no_dropout):
    """A train-mode pass over two episodes: the logits BN1d's EMA compounds
    support → query within an episode, and the statistics it leaves are the
    mean of the episodes' (the JAX package's), not torch's in-place
    compounding across episodes; the log-probabilities match too."""
    variables = jax_variables("dual")
    jb, pb = batches(2, seed=9)
    ref_lp, updates = _jax_train_run()(variables, jb)
    stats = jax.tree_util.tree_map(np.asarray, updates["batch_stats"]["emb_func"]["logits_bn"])
    ref_mean, ref_var = stats["BatchNorm_0"]["mean"], stats["BatchNorm_0"]["var"]
    method = port_method("dual", variables).train()
    with torch.no_grad():
        ours = method(pb, SETTING)
    bn = method.emb_func.logits[1]
    assert _rel(ours.numpy(), np.asarray(ref_lp)) <= LOGIT_TOL
    np.testing.assert_allclose(bn.running_mean.numpy(), ref_mean, rtol=STATS_TOL, atol=STATS_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), ref_var, rtol=STATS_TOL, atol=STATS_TOL)
    # compounded across the episodes in place, the statistics would differ
    method = port_method("dual", variables).train()
    with torch.no_grad():
        for e in range(2):
            method._embed_role(pb.support[e])
            method._embed_role(pb.query[e], pb.query_mask[e] > 0)
    assert _rel(method.emb_func.logits[1].running_mean.numpy(), ref_mean) > 1e-3


# -- the weights across, the options ------------------------------------------------------------

@pytest.mark.parametrize("variant", ["dual", "single"])
def test_head_weights_cross_under_the_reference_names(variant):
    """``utils/convert.py``'s head entries are ``tools/cross_framework_parity.py``'s
    ``invert_dmatchingnet_head_params``' (``utils.linear``, each block's
    ``G_encoder`` / ``FCE.lstmcell``), and the state loads strictly."""
    variables = jax_variables(variant)
    ours = head_state_dict_from_jax(variables, "DMatchingNet")
    ref = invert_dmatchingnet_head_params(variables, n_splits=2, single=variant == "single")
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key], val, err_msg=key)
    method = port_method(variant, variables)
    assert {k for k in method.state_dict() if not k.startswith("emb_func.")} == set(ref)
    assert not _running(method, "emb_func.layer")  # the blocks: batch statistics only
    assert _running(method, "emb_func.logits")


def test_options_that_raise(feature_path, tmp_path):
    """A ``cls_path`` file that does not hold IfslPretrain's ``classifier``
    part (``test_torch_port_ifsl_cycle.py`` loads one that does), an unknown
    preprocess mode and a ``feature_path`` of the wrong shape raise."""
    cfg = config()
    not_a_part = str(tmp_path / "emb_func_best.pth")
    torch.save({"emb_func.layer1.0.weight": torch.zeros(1)}, not_a_part)
    cfg["classifier"]["kwargs"]["ifsl_param"]["cls_path"] = not_a_part
    with pytest.raises(KeyError, match="classifier"):
        build_method(cfg)
    cfg = config()
    cfg["classifier"]["kwargs"]["ifsl_param"]["preprocess_after_split"] = "dl2n"
    with pytest.raises(ValueError, match="dl2n"):
        build_method(cfg)
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((3, 1600), np.float32))
    with pytest.raises(ValueError, match="feature_path"):
        build_method(config("options", bad))
    assert build_method(config("options", feature_path)).utils.features.shape == (25, 1600)

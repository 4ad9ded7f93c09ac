"""The Conv64F local-descriptor metric heads of the PyTorch port (DN4, ADM,
ADM_KL, ConvMNet, ATLNet, MCL, RelationNet) against the JAX package on the
CPU, at the same weights (the JAX package's random init with random BN
statistics, carried across by ``utils/convert.py``, head weights included).

Conv64F with ``is_flatten: false, last_pool: false``, as the shipped
configs, at ``[1, 108, 135]`` segments: the shipped 4×5 map (the shipped
``[1, 128, 157]`` gives it too), 5-way 2-shot 2-query.  RelationNet fails at
that map in both packages and is held at ``maxpool_last2: false`` on
``[1, 81, 90]`` segments (a 9×10 map; its relation map is 1×2, so the
flatten order shows).  Dropout is the identity on both sides in train-mode
parity (the packages cannot draw the same masks).

Tolerances:
- eval logits, float32 against the JAX package's float32: rtol 1e-4 with
  atol 1e-4 · max|ref| (``LOGIT_TOL``); ADM and ADM_KL alike (measured:
  3.2e-6 and 6.3e-6 of the scale);
- real rows' logits with and without 6 bucket-padded query rows: 1e-6 of
  the scale (``PAD_TOL``; the port against itself);
- one train step of the whole method against the JAX package with a
  float64 Conv64F and a float64 head (train-mode BN is in every chain; the
  map is rounded to float32 in both packages and the port's head is
  float32), the port with a float32 and with a float64 Conv64F
  (``STEP_TOLS``): logits and loss to 1e-5 of the logits' scale, gradients
  to 1e-4 of their max abs (``GRAD_TOL``, as ``test_torch_port_proto.py``),
  a gradient that vanishes in exact arithmetic (a conv bias before a
  train-mode BN) to 1e-3 of the largest, running statistics 1e-5.  Measured
  on the episode of seed 2: gradients 4.2e-5, vanishing ones 3.6e-4
  (ADM_KL).  ADM's float32 head (the KL of rank-19 covariances + 0.01·I,
  normalised over the batch by its mixer's BN) is held at 1e-4 on the
  logits and the running statistics (``ADM_STEP_TOLS``; measured on seeds
  2-6: 1.2e-5 and 1.7e-5).  On the episodes of seeds 3-6 the float32
  Conv64F's first-layer weight gradients read up to 1e-2 of their max in
  the JAX package's own float32 step as in the port's (float32 rounding
  through four train-mode BNs), so the float32 step is held on seed 2's
  episode and the float64 one on seeds 2 and 3;
- the head alone on given maps (``HEAD_TOLS``): the port in float64 to
  1e-6 (``F64_TOL``) of a float64 JAX head; in float32, logits 1e-5,
  gradients 1e-4, running statistics 1e-5.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.episode import make_dense_episode_batch as jax_dense_batch  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting  # noqa: E402
from audio_fewshot_tpu.models.heads.dn4 import dn4_logits as jax_dn4_logits  # noqa: E402
from audio_fewshot_tpu.models.heads import local_metrics as jax_lm  # noqa: E402
from audio_fewshot_tpu.models.heads import mcl as jax_mcl  # noqa: E402
from audio_fewshot_tpu.models.init import init_weights as jax_init_weights  # noqa: E402
import audio_fewshot_tpu_torch.eval as port_eval_module  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.episode import make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.eval import SLICE_MODELS, Test, slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method, eval_setting  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.layers import Dropout  # noqa: E402
from audio_fewshot_tpu_torch.models.heads import local_metrics, mcl  # noqa: E402
from audio_fewshot_tpu_torch.models.heads.dn4 import dn4_logits  # noqa: E402
from audio_fewshot_tpu_torch.models.init import init_weights  # noqa: E402
from audio_fewshot_tpu_torch.train import slice_config as train_cell  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    head_state_dict_from_jax, state_dict_from_jax)
from tools.cross_framework_parity import (  # noqa: E402
    invert_adm_head_params, invert_atlnet_head_params, invert_convmnet_head_params,
    invert_relationnet_head_params)

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4
PAD_TOL = 1e-6
F64_TOL = 1e-6
GRAD_TOL = 1e-4
STATS_TOL = 1e-5
SETTING = EpisodeSetting(way=5, shot=2, query=2)
SPEC = (1, 108, 135)        # Conv64F leaves the shipped 4×5 map
RELATION_SPEC = (1, 81, 90)  # 9×10 at maxpool_last2: false
HEADS = ["DN4", "ADM", "ADM_KL", "ConvMNet", "ATLNet", "MCL", "RelationNet"]
INVERTERS = {"ADM": invert_adm_head_params, "ConvMNet": invert_convmnet_head_params,
             "ATLNet": invert_atlnet_head_params, "RelationNet": invert_relationnet_head_params}


def head_config(name, dtype=None, **over):
    """The shipped head on Conv64F (``is_flatten``/``last_pool`` false) at
    the test's small geometry, float32."""
    kwargs = {"is_flatten": False, "last_pool": False, "num_channels": 1}
    if name == "RelationNet":
        kwargs["maxpool_last2"] = False
    if dtype:
        kwargs["dtype"] = dtype
    cfg = {"classifier": {"name": name, "kwargs": None},
           "backbone": {"name": "Conv64F", "kwargs": kwargs},
           "modality": "audio", "precision": "fp32", "way_num": 5, "shot_num": 2,
           "query_num": 2, "spec_shape": list(RELATION_SPEC if name == "RelationNet" else SPEC)}
    cfg.update(over)
    return cfg


def _batches(name, e, pad=0, seed=0):
    """The same dense episodes for both packages; with ``pad``, that many
    bucket-padded query rows (noise, mask 0) after the real ones."""
    spec = RELATION_SPEC if name == "RelationNet" else SPEC
    rng = np.random.default_rng(seed)
    sup = rng.normal(size=(e, 10) + spec).astype(np.float32)
    qry = rng.normal(size=(e, 10) + spec).astype(np.float32)
    jb, pb = jax_dense_batch(sup, qry, 5, 2, 2), make_dense_episode_batch(sup, qry, 5, 2, 2)
    if pad:
        extra = rng.normal(size=(e, pad) + spec).astype(np.float32)
        fields = dict(query=np.concatenate([qry, extra], axis=1),
                      query_clip=np.concatenate([pb.query_clip, np.zeros((e, pad), np.int32)], 1),
                      query_mask=np.concatenate([pb.query_mask, np.zeros((e, pad), np.float32)], 1))
        jb, pb = jb.replace(**fields), pb.replace(**fields)
    return jb, pb.to("cpu")


_VARIABLES = {}


def _jax_variables(name):
    """The JAX head's initial variables (random BN statistics and head
    biases), made once per head."""
    if name not in _VARIABLES:
        jb, _ = _batches(name, 1)
        variables = jax_build_method(head_config(name)).init_variables(
            jax.random.PRNGKey(0), jb, SETTING)
        _VARIABLES[name] = randomize_batchnorm(
            jax.tree_util.tree_map(np.asarray, variables), np.random.default_rng(1))
    return _VARIABLES[name]


def _port_method(name, variables, dtype=torch.float32):
    method = build_method(head_config(name))
    method.load_state_dict(state_dict_from_jax(variables, "Conv64F", prefix="emb_func.",
                                               classifier=name))
    if dtype == torch.float64:  # the blocks only: the map and the head stay float32
        emb = method.emb_func
        emb.dtype = dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(dtype)
    return method


def _as_port(variables, name, params=None, stats=None):
    """``variables`` with ``params`` (gradients) or ``batch_stats`` (updates)
    in place of its own, under the port's state-dict names."""
    tree = {"params": variables["params"] if params is None else params,
            "batch_stats": variables.get("batch_stats", {}) if stats is None else stats}
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, "Conv64F", prefix="emb_func.",
                                                          classifier=name).items()}


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout made the identity in both packages."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


# -- the head functions -------------------------------------------------------------

def test_head_functions_match_jax():
    """``dn4_logits``, the KL of descriptor Gaussians, ``topk_cosine_sim`` and
    MCL's probabilities on random maps (float32)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 7, 16, 3, 4)).astype(np.float32)
    s = rng.normal(size=(2, 15, 16, 3, 4)).astype(np.float32)
    tq, ts = torch.from_numpy(q), torch.from_numpy(s)
    for ours, ref in (
            (dn4_logits(tq, ts, 5, 3, 3), jax_dn4_logits(q, s, 5, 3, 3)),
            (mcl.mcl_logits(tq, ts, 5, 3), jax_mcl.mcl_logits(q, s, 5, 3)),
            (local_metrics.cov_similarity(tq, ts, 5, 3),
             jax_lm.ConvMNet(None)._cov_sim(q, s, 5, 3))):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL * np.abs(np.asarray(ref)).max())
    qd, sd = local_metrics.to_descriptors(tq), local_metrics.to_descriptors(ts).reshape(2, 5, 36, 16)
    jqd, jsd = np.asarray(jax_lm._to_descriptors(q)), np.asarray(jax_lm._to_descriptors(s))
    ref = -jax_lm.kl_gaussian_batch(*jax_lm._descriptor_moments(jqd),
                                    *jax_lm._descriptor_moments(jsd.reshape(2, 5, 36, 16)))
    assert _rel(local_metrics.neg_kl(qd, sd).numpy(), ref) <= LOGIT_TOL
    qn, sn = local_metrics.l2_normalize(qd, -1), local_metrics.l2_normalize(sd, -1)
    ref = jax_lm.topk_cosine_sim(qn.numpy(), sn.numpy(), 3)
    assert _rel(local_metrics.topk_cosine_sim(qn, sn, 3).numpy(), ref) <= LOGIT_TOL


# -- eval logits and bucket padding ---------------------------------------------------

@pytest.mark.parametrize("name", HEADS)
def test_eval_logits_match_jax_and_ignore_bucket_padding(name):
    """Eval-mode segment logits of two episodes with 6 bucket-padded query
    rows against the JAX package's float32 ``forward`` on the same rows; the
    real rows' logits are the port's own on the unpadded batch (RelationNet's
    masked BN, ADM's running-statistics mixer)."""
    variables = _jax_variables(name)
    jax_method = jax_build_method(head_config(name))
    jb, pb = _batches(name, 2, pad=6, seed=5)
    ref = np.asarray(jax.jit(lambda v, b: jax_method.forward(v, b, SETTING))(variables, jb))
    method = _port_method(name, variables).eval()
    _, dense = _batches(name, 2, seed=5)
    with torch.no_grad():
        ours = method(pb, SETTING).numpy()
        unpadded = method(dense, SETTING).numpy()
    assert ours.shape == ref.shape == (2, 16, 5)
    np.testing.assert_allclose(ours, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL * np.abs(ref).max())
    np.testing.assert_allclose(ours[:, :10], unpadded, rtol=0, atol=PAD_TOL * np.abs(ref).max())
    assert np.ptp(ref[:, :10], axis=-1).max() > 1e-3 * np.abs(ref).max()  # the classes differ


# -- one train step ---------------------------------------------------------------------

def _jax_loss_and_grads(jax_method, variables, batch):
    non_params = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        return jax_method.loss({**non_params, "params": params}, batch, SETTING,
                               jax.random.PRNGKey(1))

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return (float(loss), np.asarray(out.seg_logits), jax.tree_util.tree_map(np.asarray, grads),
            jax.tree_util.tree_map(np.asarray, (out.updates or {}).get("batch_stats", {})))


def _check_step(named, running, loss, out, ref, tols):
    """The port's step against ``ref`` = (loss, logits, gradients, running
    statistics) under the port's names: the gradients of ``named`` (name →
    tensor) and the ``running`` statistics (name → tensor).  ``tols``:
    logits (and the loss, relative to the logits' scale), gradients
    (relative to their max abs, or to a tenth of the largest where that is
    more), gradients that vanish in exact arithmetic (relative to the
    largest), running statistics."""
    ref_loss, ref_logits, grads, stats = ref
    scale = np.abs(ref_logits).max()
    largest = max(np.abs(grads[k]).max() for k in named)
    assert loss.item() > 0.1  # not a saturated softmax
    assert abs(loss.item() - ref_loss) <= tols["logits"] * scale
    assert _rel(out.seg_logits.detach().numpy(), ref_logits) <= tols["logits"]
    for key, p in named.items():
        ref = grads[key].reshape(p.shape)
        if np.abs(ref).max() <= 1e-9 * largest:
            tol = tols["vanishing"] * largest
        else:
            tol = tols["grads"] * max(np.abs(ref).max(), 0.1 * largest)
        assert np.abs(p.grad.double().numpy() - ref).max() <= tol, key
    for key, val in running.items():
        np.testing.assert_allclose(val.double().numpy(), stats[key], rtol=tols["stats"],
                                   atol=tols["stats"], err_msg=key)


def _running(method, prefix=""):
    return {k: v for k, v in method.state_dict().items()
            if k.startswith(prefix) and k.endswith(("running_mean", "running_var"))}


# the whole step: the port against the JAX package built with a float64
# Conv64F, whose map is rounded to float32 in both and meets a float64 head
# in the JAX package (the port's head: float32)
STEP_TOLS = {"logits": 1e-5, "grads": GRAD_TOL, "vanishing": 1e-3, "stats": STATS_TOL}
# ADM: the port's float32 head takes the KL of rank-19 covariances (+ 0.01·I)
# and normalises the [-KL ‖ cosine] scores over the batch (measured on seeds
# 2-6: logits to 1.2e-5 of their scale, the mixer's running statistics to
# 1.7e-5)
ADM_STEP_TOLS = dict(STEP_TOLS, logits=1e-4, stats=1e-4)


def _step_reference(name, variables, seed):
    """One train step of the JAX package with a float64 Conv64F and a float64
    head on the episode of ``seed``: (loss, logits, gradients, running
    statistics) under the port's names, and the port's batch."""
    jb, pb = _batches(name, 1, seed=seed)
    with jax.enable_x64(True):
        jax_method = jax_build_method(head_config(name, dtype="float64"))
        embed = jax_method.embed

        def embed_wide(*args, **kwargs):
            sup, qry, updates = embed(*args, **kwargs)
            return sup.astype(np.float64), qry.astype(np.float64), updates

        jax_method.embed = embed_wide
        wide = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        ref_loss, ref_logits, ref_grads, ref_stats = _jax_loss_and_grads(jax_method, wide, jb)
    return (ref_loss, ref_logits, _as_port(variables, name, params=ref_grads),
            _as_port(variables, name, stats=ref_stats)), pb


def _check_port_step(name, variables, dtype, pb, ref):
    method = _port_method(name, variables, dtype).train()
    loss, out = method.loss(pb, SETTING)
    loss.backward()
    named = dict(method.named_parameters())
    assert len(named) == 16 + N_HEAD_PARAMS.get(name, 0)
    _check_step(named, _running(method), loss, out, ref,
                ADM_STEP_TOLS if name == "ADM" else STEP_TOLS)


@pytest.mark.parametrize("name", HEADS)
def test_train_step_matches_jax(name, no_dropout):
    """Logits, loss, every gradient (head and backbone) and every BN's running
    statistics (ATLNet's shared ``W`` BN updated twice, query then support;
    the ADM mixer's; RelationNet's kept ones) after one train step, the port
    in float32 and with a float64 Conv64F, against the JAX package with a
    float64 Conv64F and a float64 head (train-mode BN is in every chain: the
    JAX package's float32 one-pass variance is not the reference)."""
    variables = _jax_variables(name)
    ref, pb = _step_reference(name, variables, seed=2)
    for dtype in (torch.float32, torch.float64):
        _check_port_step(name, variables, dtype, pb, ref)


@pytest.mark.parametrize("name", HEADS)
def test_train_step_float64_matches_jax_on_another_episode(name, no_dropout):
    """The step of ``test_train_step_matches_jax`` with a float64 Conv64F on
    a second episode, at the same tolerances."""
    variables = _jax_variables(name)
    ref, pb = _step_reference(name, variables, seed=3)
    _check_port_step(name, variables, torch.float64, pb, ref)


N_HEAD_PARAMS = {"ADM": 3, "ConvMNet": 2, "ATLNet": 7, "RelationNet": 12}
# the head alone on given maps: float64 in both, and the port's float32
HEAD_TOLS = {torch.float64: {"logits": F64_TOL, "grads": F64_TOL, "vanishing": F64_TOL,
                             "stats": F64_TOL},
             torch.float32: {"logits": 1e-5, "grads": GRAD_TOL, "vanishing": GRAD_TOL,
                             "stats": STATS_TOL}}


@pytest.mark.parametrize("name", HEADS)
def test_head_step_matches_jax_float64(name, no_dropout):
    """The head alone in train mode on given post-ReLU maps (the backbone's
    ``embed`` replaced by them in both packages): logits, loss, the
    gradients of the head's parameters and of the maps, and the head's
    running statistics, against the JAX head in float64 (parameters and
    maps), the port in float64 and in float32.  The JAX package's own
    float32 head is not the reference: its BNs take the batch variance in one
    pass."""
    variables = _jax_variables(name)
    jb, pb = _batches(name, 1, seed=2)
    c, h, w = build_method(head_config(name)).emb_func.map_shape(head_config(name)["spec_shape"])
    rng = np.random.default_rng(7)
    maps = [np.maximum(rng.normal(size=(1, 10, c, h, w)), 0.0) for _ in range(2)]
    head_vars = {col: {"head": tree["head"]} for col, tree in variables.items() if "head" in tree}
    with jax.enable_x64(True):
        jax_method = jax_build_method(head_config(name, dtype="float64"))
        wide = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), head_vars)
        wide.setdefault("params", {})

        def head_loss(params, sup, qry):
            jax_method.embed = lambda *a, **k: (sup, qry, {})
            return jax_method.loss({**wide, "params": params}, jb, SETTING, jax.random.PRNGKey(1))

        (ref_loss, ref_out), (g_params, g_sup, g_qry) = jax.value_and_grad(
            head_loss, argnums=(0, 1, 2), has_aux=True)(wide["params"], *maps)
        ref_stats = (ref_out.updates or {}).get("batch_stats", {})
        grads = head_state_dict_from_jax({"params": jax.tree_util.tree_map(
            np.asarray, g_params), "batch_stats": wide.get("batch_stats", {})}, name)
        stats = head_state_dict_from_jax({"params": wide["params"], "batch_stats":
                                          jax.tree_util.tree_map(np.asarray, ref_stats)}, name)
        grads.update({"maps.support": np.asarray(g_sup), "maps.query": np.asarray(g_qry)})
        ref = (float(ref_loss), np.asarray(ref_out.seg_logits), grads, stats)
    for dtype in (torch.float64, torch.float32):
        method = _port_method(name, variables).to(dtype).train()
        sup, qry = (torch.tensor(m, dtype=dtype, requires_grad=True) for m in maps)
        method.embed = lambda batch: (sup, qry)
        loss, out = method.loss(pb, SETTING)
        loss.backward()
        named = {"maps.support": sup, "maps.query": qry, **{
            k: p for k, p in method.named_parameters() if not k.startswith("emb_func.")}}
        assert len(named) == 2 + N_HEAD_PARAMS.get(name, 0)
        running = {k: v for k, v in _running(method).items() if not k.startswith("emb_func.")}
        assert set(running) == set(stats) - {k for k in stats if not k.endswith(
            ("running_mean", "running_var"))}
        _check_step(named, running, loss, out, ref, HEAD_TOLS[dtype])


# -- RelationNet at the shipped geometry ---------------------------------------------------

def test_relationnet_fails_at_the_shipped_map_in_both_packages():
    """At the shipped geometry (a 4×5 map) the relation layer's second conv
    leaves nothing: the JAX package fails in ``fc1``'s init, the port raises
    a ``ValueError`` that names the map and the way out when it builds."""
    cfg = head_config("RelationNet", spec_shape=list(SPEC))
    cfg["backbone"]["kwargs"]["maxpool_last2"] = True
    jb, _ = _batches("DN4", 1)
    with pytest.raises(ZeroDivisionError):
        jax_build_method(cfg).init_variables(jax.random.PRNGKey(0), jb, SETTING)
    with pytest.raises(ValueError, match=r"4x5 map.*maxpool_last2: false"):
        build_method(cfg)
    with pytest.raises(ValueError, match=r"4x5 map"):
        build_method(eval_cell(classifier="RelationNet"))


def test_map_shape_reaches_the_heads_that_declare_it():
    """torch infers no shapes: ``build_method`` hands ConvMNet, ATLNet and
    RelationNet Conv64F's ``(c, h, w)`` from ``spec_shape``; a backbone
    that states no map shape, or a flat Conv64F, raises."""
    assert build_method(head_config("ConvMNet")).convm_layer.conv1dLayer[2].kernel_size == (20,)
    assert build_method(head_config("ATLNet")).atlLayer.W[0].in_channels == 64
    assert build_method(head_config("RelationNet")).relation_layer.fc[0].in_features == 64 * 2
    assert not hasattr(build_method(head_config("DN4")), "map_shape")
    mcl_backbone = head_config("ConvMNet", backbone={"name": "Conv64F_MCL",
                                                     "kwargs": {"num_channels": 1}})
    with pytest.raises(NotImplementedError, match="Conv64F_MCL"):
        build_method(mcl_backbone)
    flat = head_config("ATLNet")
    flat["backbone"]["kwargs"]["is_flatten"] = True
    with pytest.raises(ValueError, match="is_flatten"):
        build_method(flat)


# -- the weights across -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(INVERTERS))
def test_head_weights_cross_under_the_reference_names(name):
    """``utils/convert.py``'s head entries are ``tools/cross_framework_parity.py``'s
    inverters', key for key and value for value, and load into the port's
    method strictly (``num_batches_tracked`` filled by ``load_state_dict``)."""
    variables = _jax_variables(name)
    ours = head_state_dict_from_jax(variables, name)
    ref = INVERTERS[name](variables)
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key], val, err_msg=key)
    method = build_method(head_config(name))
    head_keys = {k for k in method.state_dict()
                 if not k.startswith("emb_func.") and not k.endswith("num_batches_tracked")}
    assert head_keys == set(ref)
    method.load_state_dict(state_dict_from_jax(variables, "Conv64F", prefix="emb_func.",
                                               classifier=name))
    for key, val in ref.items():
        np.testing.assert_array_equal(method.state_dict()[key].numpy(), val, err_msg=key)
    assert head_state_dict_from_jax(_jax_variables("DN4"), "DN4") == {}


@pytest.mark.parametrize("name", sorted(INVERTERS))
def test_init_weights_redraws_the_head_kernels_jax_redraws(name):
    """``init_type`` redraws exactly the head weights the JAX package's
    ``init_weights`` redraws (its rank ≥ 2 ``kernel`` leaves: not ADM's
    ``mix``, nor biases or norm scales), with kaiming's standard deviation
    (within 10 % where a weight has ≥ 1000 entries)."""
    variables = _jax_variables(name)
    before = head_state_dict_from_jax(variables, name)
    redrawn = jax_init_weights(variables["params"], "kaiming", jax.random.PRNGKey(3))
    after = head_state_dict_from_jax({**variables, "params": jax.tree_util.tree_map(
        np.asarray, redrawn)}, name)
    ref_changed = {k for k in before if not np.array_equal(before[k], after[k])}
    method = _port_method(name, variables)
    init_weights(method, "kaiming", torch.Generator().manual_seed(0))
    state = method.state_dict()
    changed = {k for k in before if not np.array_equal(before[k], state[k].numpy())}
    assert changed == ref_changed and (changed or name == "ADM")
    for key in changed:
        w = state[key]
        if w.numel() >= 1000:
            fan_in, _ = torch.nn.init._calculate_fan_in_and_fan_out(w)
            assert float(w.std()) == pytest.approx((2.0 / fan_in) ** 0.5, rel=0.1), key


# -- Test.test_loop end to end --------------------------------------------------------------

def loop_config(name, **over):
    return Config(None, head_config(
        name, data_root="synthetic:10:12", test_episode=2, test_episode_size=2, test_epoch=1,
        max_segments_per_clip=3, segment_bucket_sizes=[32], seed=0, prefetch=0, **over)
    ).get_config_dict()


@pytest.mark.parametrize("name", ["DN4", "ADM"])
def test_test_loop_matches_jax(name, tmp_path, monkeypatch):
    """The port's ``Test`` reading the JAX package's weights from its
    model_best.pth: the episode accuracies of a test epoch over ragged,
    bucket-padded episodes, and their segment logits, are the JAX
    package's."""
    cfg = loop_config(name)
    setting = eval_setting(cfg)
    variables = _jax_variables(name)
    jax_method = jax_build_method(cfg)

    @jax.jit
    def jax_step(v, b):
        logits = jax_method.forward(v, b, setting)
        return logits, jax_method.eval_episode_accuracy(logits, b)

    ref = [jax_step(variables, b) for b in jax_get_dataloader(cfg, "test")[0].epoch(0)]
    method = _port_method(name, variables)
    save_model_best(str(tmp_path), method)
    seen = []
    inner = port_eval_module.mean_confidence_interval
    monkeypatch.setattr(port_eval_module, "mean_confidence_interval",
                        lambda values, *a, **k: (seen.append(list(values)), inner(values, *a, **k))[1])
    test = Test(0, cfg, str(tmp_path), device="cpu")
    test.test_loop()
    assert test.val_loader is None
    np.testing.assert_allclose(seen[0], [a for _, acc in ref for a in np.asarray(acc)],
                               rtol=1e-6)
    for host_batch, (ref_logits, _) in zip(get_dataloader(cfg, "test")[0].epoch(0), ref,
                                           strict=True):
        with torch.no_grad():
            logits = test.method(host_batch.to("cpu"), setting).numpy()
        ref_logits = np.asarray(ref_logits)
        assert logits.shape == ref_logits.shape == (2, 32, 5)
        np.testing.assert_allclose(logits, ref_logits, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL * np.abs(ref_logits).max())


# -- the chip cells ---------------------------------------------------------------------------

SHIPPED = {"DN4": "dn4", "ADM": "adm", "ADM_KL": "adm_kl", "ConvMNet": "convmnet",
           "ATLNet": "atlnet", "MCL": "mcl", "RelationNet": "relationnet"}


@pytest.mark.parametrize("kind", ["eval", "train"])
@pytest.mark.parametrize("name", HEADS)
def test_chip_cells_are_the_shipped_head_configs_cut_to_size(name, kind, tmp_path):
    """The cells ``chip_smoke.py`` runs are each head's shipped
    ``*_5shot_iid_seed0.yaml`` with its headers but for the cuts they name;
    each builds at full width (RelationNet raises its error there)."""
    shipped = Config(os.path.join(REPO, "config", SHIPPED[name],
                                  f"{SHIPPED[name]}_5shot_iid_seed0.yaml")).get_config_dict()
    assert name in SLICE_MODELS
    if kind == "eval":
        cell = eval_cell(classifier=name, test_episode=32, test_epoch=1)
        cuts = {"test_episode": (600, 32), "test_epoch": (5, 1), "test_episode_size": (None, 16),
                "max_segments_per_clip": (8, 6), "spec_shape": (None, [1, 128, 157])}
        kept = ("classifier", "backbone", "modality", "test_way", "test_shot", "test_query",
                "augment_times", "seed", "ood", "tag")
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
        assert cell.get(key) == shipped[key], key
    assert cell["precision"] == "bf16"
    if name == "RelationNet":
        with pytest.raises(ValueError, match="maxpool_last2: false"):
            build_method(cell)
        return
    model = build_method(cell)
    assert model.needs_feature_map
    assert model.emb_func.map_shape(cell["spec_shape"]) == (64, 4, 5)

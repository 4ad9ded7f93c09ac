"""The six resnet12 metric heads of the PyTorch port (MetaBaseline,
MetaBaselineKendall, FEAT, DSN, FRN, CAN) against the JAX package on the
CPU, at the same weights (the JAX package's random init with random BN
statistics, carried across by ``utils/convert.py``, head weights and the
DropBlock counters included).

resnet12 at planes 8/12/16/20 on ``[1, 96, 112]`` segments: a [20, 6, 7]
map, [20, 2, 3] after the 5×5 avg pool (120 features flat, flattened NHWC in
both packages), 3-way 3-shot 2-query.  FRN and CAN take the map
(``is_flatten: false, avg_pool: false``), as their shipped configs.

Tolerances (relative to the logits' scale, or to a gradient's max abs):
- eval logits, float32 against the JAX package's float32: 1e-5
  (``LOGIT_TOL``); DSN's SVD and FRN's solve go through LAPACK in both
  packages in another order: 1e-4 (``LAPACK_TOL``); Kendall's exact sign
  counts are integers and equal exactly (``test_kendall_exact_counts``);
- one train step against the JAX package with a float64 resnet12 (its
  features rounded to float32 in both packages, as both cast the map) and a
  float64 head, DropBlock and Dropout at rate 0 on both sides and FEAT's
  ``SetAttention`` built with ``dropout=attn_dropout=0.0`` on the JAX side
  (the packages cannot draw the same masks): loss and logits 1e-5, every
  gradient 1e-4 of its max abs (a tenth of the largest where that is more;
  ``GRAD_TOL``), running statistics 1e-5, the port with a float32 and with
  a float64 resnet12 (``STEP_TOLS``; the float32 port at ``F32_STEP_TOLS``).
  DSN's step, through both packages' SVDs, is held at the same limits: on
  the CPU its float64 port reads loss 3.6e-8, logits 2.4e-7, gradients
  2.7e-6 of their max abs, and the float32 port's gradients 2.6e-3.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.episode import make_dense_episode_batch as jax_dense_batch  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting  # noqa: E402
from audio_fewshot_tpu.models.heads import kendall as jax_kendall  # noqa: E402
from audio_fewshot_tpu.models.heads.feat import SetAttention as JaxSetAttention  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.episode import make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.eval import SLICE_MODELS, slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.heads import kendall  # noqa: E402
from audio_fewshot_tpu_torch.registry import CLASSIFIERS  # noqa: E402
from audio_fewshot_tpu_torch.train import slice_config as train_cell  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    head_state_dict_from_jax, state_dict_from_jax)
from tools.cross_framework_parity import (  # noqa: E402
    invert_can_head_params, invert_feat_head_params, invert_frn_head_params,
    invert_metabaseline_head_params)

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_metric import _rel, _running  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-5
LAPACK_TOL = 1e-4
GRAD_TOL = 1e-4
STATS_TOL = 1e-5
WAY, SHOT, QUERY = 3, 3, 2
SETTING = EpisodeSetting(way=WAY, shot=SHOT, query=QUERY)
SPEC = (1, 96, 112)
PLANES = [8, 12, 16, 20]
HEADS = ["MetaBaseline", "MetaBaselineKendall", "FEAT", "DSN", "FRN", "CAN"]
# this file's heads; ``test_torch_port_resnet12_maps.py`` holds the others
FLAT_HEADS = ["MetaBaseline", "MetaBaselineKendall", "FEAT"]
MAP_HEADS = ("FRN", "CAN")
KWARGS = {"FEAT": {"hdim": 640, "temperature": 1.0, "temperature2": 1.0, "balance": 0.5,
                   "mode": "euclidean"},
          "DSN": {"discriminative": True}, "CAN": {"scale_cls": 7, "num_classes": 25}}
INVERTERS = {"MetaBaseline": invert_metabaseline_head_params, "FEAT": invert_feat_head_params,
             "FRN": invert_frn_head_params, "CAN": invert_can_head_params}
N_HEAD_PARAMS = {"MetaBaseline": 1, "FEAT": 7, "FRN": 2, "CAN": 8}
STEP_TOLS = {"logits": LOGIT_TOL, "grads": GRAD_TOL, "vanishing": 1e-3, "stats": STATS_TOL}
# the port with a float32 resnet12: float32 rounding through 13 train-mode
# BNs at 8-20 channels.  The JAX package's own float32 step is 7e-3
# (MetaBaseline, Kendall) to 5e-2 (FRN) of each gradient's max abs off its
# float64 step; the port's 3e-3 and 2.3e-4
F32_STEP_TOLS = dict(STEP_TOLS, grads=1e-2, vanishing=1e-2)


def head_config(name, dtype=None, drop_rate=0.1, **over):
    """The shipped head on resnet12 at the test's small geometry, float32."""
    kwargs = {"num_channels": 1, "planes": PLANES, "drop_rate": drop_rate}
    if name in MAP_HEADS:
        kwargs.update(is_flatten=False, avg_pool=False)
    if dtype:
        kwargs["dtype"] = dtype
    cfg = {"classifier": {"name": name, "kwargs": dict(KWARGS.get(name, {}))},
           "backbone": {"name": "resnet12", "kwargs": kwargs},
           "modality": "audio", "precision": "fp32", "way_num": WAY, "shot_num": SHOT,
           "query_num": QUERY, "spec_shape": list(SPEC)}
    cfg.update(over)
    return cfg


def _batches(e, pad=0, seed=0):
    """The same dense episodes for both packages (global targets for CAN);
    with ``pad``, that many bucket-padded query rows (noise, mask 0)."""
    rng = np.random.default_rng(seed)
    sup = rng.normal(size=(e, WAY * SHOT) + SPEC).astype(np.float32)
    qry = rng.normal(size=(e, WAY * QUERY) + SPEC).astype(np.float32)
    glob = rng.integers(0, 25, size=(e, WAY * (SHOT + QUERY)))
    jb = jax_dense_batch(sup, qry, WAY, SHOT, QUERY, global_target=glob)
    pb = make_dense_episode_batch(sup, qry, WAY, SHOT, QUERY, global_target=glob)
    if pad:
        extra = rng.normal(size=(e, pad) + SPEC).astype(np.float32)
        fields = dict(query=np.concatenate([qry, extra], axis=1),
                      query_clip=np.concatenate([pb.query_clip, np.zeros((e, pad), np.int32)], 1),
                      query_mask=np.concatenate([pb.query_mask, np.zeros((e, pad), np.float32)], 1))
        jb, pb = jb.replace(**fields), pb.replace(**fields)
    return jb, pb.to("cpu")


_VARIABLES = {}


def _jax_variables(name):
    """The JAX method's initial variables (drop_rate 0.1: the DropBlock
    counters exist) with random BN statistics, made once per head."""
    if name not in _VARIABLES:
        jb, _ = _batches(1)
        method = jax_build_method(head_config(name))
        variables = jax.jit(lambda key: method.init_variables(key, jb, SETTING))(
            jax.random.PRNGKey(0))
        variables = randomize_batchnorm(
            jax.tree_util.tree_map(np.asarray, variables), np.random.default_rng(1))
        for block in ("layer3", "layer4"):
            variables["batch_stats"]["emb_func"][block]["num_batches_tracked"] = np.asarray(
                7 if block == "layer3" else 11, np.int32)
        _VARIABLES[name] = variables
    return _VARIABLES[name]


def _jax_method(cfg):
    """The JAX method, its shape-sized modules made (CAN's ``cam`` is built
    in ``init_variables``)."""
    method = jax_build_method(cfg)
    jb = _batches(1)[0]
    jax.eval_shape(lambda key: method.init_variables(key, jb, SETTING), jax.random.PRNGKey(0))
    return method


def _without_counters(variables):
    stats = {k: dict(v) for k, v in variables["batch_stats"].items()}
    stats["emb_func"] = {k: {kk: vv for kk, vv in v.items() if kk != "num_batches_tracked"}
                         for k, v in stats["emb_func"].items()}
    return {**variables, "batch_stats": stats}


def _port_method(name, variables, drop_rate=0.1, dtype=torch.float32):
    method = build_method(head_config(name, drop_rate=drop_rate))
    method.load_state_dict(state_dict_from_jax(variables, "resnet12", prefix="emb_func.",
                                               classifier=name))
    if dtype == torch.float64:  # the blocks only: the features and the head stay float32
        emb = method.emb_func
        emb.dtype = dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(dtype)
    return method


def _as_port(variables, name, params=None, stats=None):
    tree = {"params": variables["params"] if params is None else params,
            "batch_stats": variables.get("batch_stats", {}) if stats is None else stats}
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, "resnet12", prefix="emb_func.",
                                                          classifier=name).items()}


# -- eval logits --------------------------------------------------------------------------

def check_eval_logits(name):
    """Eval-mode segment logits of two episodes with 2 bucket-padded query
    rows against the JAX package's float32 ``forward``; the real rows' are
    the port's own on the unpadded batch."""
    variables = _jax_variables(name)
    jax_method = _jax_method(head_config(name))
    jb, pb = _batches(2, pad=2, seed=5)
    forward = lambda v, b: jax_method.forward(v, b, SETTING)  # noqa: E731
    # Kendall op by op: jitted, XLA recomputes the features inside each
    # gather and the (0, 0) padding pairs of the last chunk count ±1, not 0
    # (ROADMAP Queue C)
    ref = np.asarray((forward if name == "MetaBaselineKendall" else jax.jit(forward))(
        variables, jb))
    method = _port_method(name, variables).eval()
    _, dense = _batches(2, seed=5)
    with torch.no_grad():
        ours = method(pb, SETTING).numpy()
        unpadded = method(dense, SETTING).numpy()
    tol = LAPACK_TOL if name in ("DSN", "FRN") else LOGIT_TOL
    assert ours.shape == ref.shape == (2, WAY * QUERY + 2, WAY)
    assert _rel(ours, ref) <= tol
    np.testing.assert_allclose(ours[:, :WAY * QUERY], unpadded, rtol=0,
                               atol=LOGIT_TOL * np.abs(ref).max())
    # the classes differ by more than ten times the tolerance
    assert np.ptp(ref[:, :WAY * QUERY], axis=-1).max() > 10 * tol * np.abs(ref).max()


def _check_step(named, running, loss, out, ref, tols):
    """The port's step against ``ref`` = (loss, logits, gradients, running
    statistics) under the port's names, as ``test_torch_port_metric.py``'s,
    but the loss relative to the larger of the logits' scale and the loss
    (FRN's auxiliary term is ~60 times the cross-entropy)."""
    ref_loss, ref_logits, grads, stats = ref
    scale = np.abs(ref_logits).max()
    largest = max(np.abs(grads[k]).max() for k in named)
    assert abs(loss.item() - ref_loss) <= tols["logits"] * max(scale, abs(ref_loss))
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


# -- one train step -------------------------------------------------------------------------

def _step_reference(name, variables, seed):
    """One train step of the JAX package with a float64 resnet12 and a
    float64 head on the episode of ``seed``, DropBlock, Dropout and FEAT's
    attention dropouts at 0: (loss, logits, gradients, running statistics)
    under the port's names, and the port's batch."""
    jb, pb = _batches(1, seed=seed)
    variables = _without_counters(variables)
    with jax.enable_x64(True):
        jax_method = _jax_method(head_config(name, dtype="float64", drop_rate=0.0))
        if name == "FEAT":
            jax_method.modules["head"] = JaxSetAttention(hdim=640, dropout=0.0,
                                                         attn_dropout=0.0)
        embed = jax_method.embed

        def embed_wide(*args, **kwargs):
            sup, qry, updates = embed(*args, **kwargs)
            return sup.astype(np.float64), qry.astype(np.float64), updates

        jax_method.embed = embed_wide
        wide = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        non_params = {k: v for k, v in wide.items() if k != "params"}

        def loss_fn(params):
            return jax_method.loss({**non_params, "params": params}, jb, SETTING,
                                   jax.random.PRNGKey(1))

        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(wide["params"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
        stats = jax.tree_util.tree_map(np.asarray, out.updates["batch_stats"])
    return (float(loss), np.asarray(out.seg_logits), _as_port(variables, name, params=grads),
            _as_port(variables, name, stats=stats)), pb


def check_train_step(name):
    """Logits, loss, every gradient (head and backbone) and every BN's running
    statistics (CAN's bottleneck BN keeps its second call's update, as the
    JAX package's) after one train step, the port in float32 and with a
    float64 resnet12, against the JAX package's float64 step."""
    variables = _jax_variables(name)
    ref, pb = _step_reference(name, variables, seed=2)
    for dtype, tols in ((torch.float64, STEP_TOLS), (torch.float32, F32_STEP_TOLS)):
        method = _port_method(name, _without_counters(variables), 0.0, dtype).train()
        if name == "FEAT":
            method.slf_attn.dropout.rate = method.slf_attn.attn_dropout.rate = 0.0
        loss, out = method.loss(pb, SETTING)
        loss.backward()
        named = dict(method.named_parameters())
        assert len(named) == 48 + N_HEAD_PARAMS.get(name, 0)
        _check_step(named, _running(method), loss, out, ref, tols)


@pytest.mark.parametrize("name", FLAT_HEADS)
def test_eval_logits_match_jax(name):
    check_eval_logits(name)


@pytest.mark.parametrize("name", FLAT_HEADS)
def test_train_step_matches_jax_float64(name):
    check_train_step(name)


# -- the weights across -----------------------------------------------------------------------

def check_head_weights(name):
    """``utils/convert.py``'s head entries are ``tools/cross_framework_parity.py``'s
    inverters', key for key and value for value, and load into the port's
    method strictly (BN ``num_batches_tracked`` filled by ``load_state_dict``;
    the DropBlock counters carried)."""
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
    method.load_state_dict(state_dict_from_jax(variables, "resnet12", prefix="emb_func.",
                                               classifier=name))
    state = method.state_dict()
    for key, val in ref.items():
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(val), err_msg=key)
    assert int(state["emb_func.layer3.0.num_batches_tracked"]) == 7
    assert int(state["emb_func.layer4.0.num_batches_tracked"]) == 11


@pytest.mark.parametrize("name", ["MetaBaseline", "FEAT"])
def test_head_weights_cross_under_the_reference_names(name):
    check_head_weights(name)
    for head in ("MetaBaselineKendall", "DSN"):  # no parameters
        assert head_state_dict_from_jax(_jax_variables(head), head) == {}


# -- Kendall ---------------------------------------------------------------------------------

def _kendall_inputs(seed=0, d=40):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 5, d)).astype(np.float32)
    p = rng.normal(size=(2, 3, d)).astype(np.float32)
    q[..., 7] = q[..., 3]  # ties: sign 0
    p[0, :, 11] = p[0, :, 2]
    return q, p


@pytest.mark.parametrize("budget", [1, 50, kendall.EXACT_BUDGET])
def test_kendall_exact_counts(budget):
    """The exact sign counts are integers, the same over any strip width, the
    JAX package's (op by op; a float32 sum, exact at 780 pairs) and a numpy
    count over ``np.triu_indices``, ties scoring 0."""
    q, p = _kendall_inputs()
    ours = kendall.kendall_exact_counts(torch.from_numpy(q), torch.from_numpy(p), budget).numpy()
    i, j = np.triu_indices(q.shape[-1], k=1)
    brute = np.einsum("egp,ewp->egw", np.sign(q[..., i] - q[..., j]),
                      np.sign(p[..., i] - p[..., j]))
    np.testing.assert_array_equal(ours, brute)
    ref = np.asarray(jax_kendall.kendall_logits(q, p, exact=True), np.float64)
    np.testing.assert_array_equal(ours, np.rint(ref * len(i)))
    scores = kendall.kendall_logits(torch.from_numpy(q), torch.from_numpy(p), exact=True)
    assert scores.dtype == torch.float32
    np.testing.assert_array_equal(scores.numpy(), (brute / len(i)).astype(np.float32))


@pytest.mark.parametrize("budget", [1, 300, kendall.SOFT_BUDGET])
def test_kendall_soft_score_and_its_recomputing_backward(budget):
    """The train score Σ tanh(β/2 ΔqΔp) of ``_SoftKendall`` (any strip width)
    and its gradients, whose backward recomputes each strip, against the JAX
    package's 2σ(βΔqΔp) − 1 chunked scan and ``jax.grad`` in float64
    (1e-10 relative); the float32 score against float64 at 1e-5."""
    q, p = _kendall_inputs(seed=1)
    w = np.random.default_rng(2).normal(size=(2, 5, 3))
    with jax.enable_x64(True):
        def total(qq, pp):
            return jax_kendall.kendall_logits(qq, pp, beta=0.7, temperature=1.0) * 780

        ref = np.asarray(total(q.astype(np.float64), p.astype(np.float64)))
        gq, gp = jax.grad(lambda qq, pp: jnp.sum(total(qq, pp) * w), argnums=(0, 1))(
            q.astype(np.float64), p.astype(np.float64))
    tq = torch.tensor(q, dtype=torch.float64, requires_grad=True)
    tp = torch.tensor(p, dtype=torch.float64, requires_grad=True)
    out = kendall._SoftKendall.apply(tq, tp, 0.7, budget)
    (out * torch.from_numpy(w)).sum().backward()
    assert _rel(out.detach().numpy(), ref) <= 1e-10
    assert _rel(tq.grad.numpy(), np.asarray(gq)) <= 1e-10
    assert _rel(tp.grad.numpy(), np.asarray(gp)) <= 1e-10
    scores = kendall.kendall_logits(torch.from_numpy(q), torch.from_numpy(p), beta=0.7,
                                    temperature=1.0)
    assert _rel(scores.detach().numpy() * 780, ref) <= 1e-5


def test_kendall_strips_cover_every_pair_once():
    for d, width in ((2, 1), (40, 1), (40, 100), (121, 500), (12800, 2 ** 15)):
        rows = list(kendall.strips(d, width))
        assert rows[0][0] == 0 and rows[-1][1] == d - 1
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(rows, rows[1:]))
        assert all(a1 > a0 for a0, a1 in rows)
        assert all((a1 - a0) * (d - a0) <= max(width, d - a0) for a0, a1 in rows)
    assert kendall.num_pairs(12800) == 81_913_600


def test_diffkendall_is_an_alias_of_metabaselinekendall():
    assert CLASSIFIERS.get("DiffKendall") is CLASSIFIERS.get("MetaBaselineKendall")
    assert type(build_method(head_config("DiffKendall"))).__name__ == "MetaBaselineKendall"
    with pytest.raises(ValueError, match="duplicate"):
        CLASSIFIERS.register_alias("DiffKendall", "MetaBaseline")
    with pytest.raises(KeyError, match="unknown classifier"):
        CLASSIFIERS.register_alias("Nothing", "NoSuchHead")


# -- FEAT's train batch ----------------------------------------------------------------------

def test_feat_regulariser_needs_way_major_unpadded_queries():
    """The regulariser reshapes the queries as [E, way, query, d]: a padded
    (eval-style) batch is refused, not misread."""
    method = build_method(head_config("FEAT")).train()
    _, padded = _batches(1, pad=2)
    with pytest.raises(ValueError, match="way-major"):
        method.loss(padded, SETTING)
    assert method.slf_attn.w_qs.weight.shape == (120, 120)  # the feature width, not hdim


# -- the chip cells ----------------------------------------------------------------------------

SHIPPED = {"MetaBaseline": "metabaseline", "MetaBaselineKendall": "kendall", "FEAT": "feat",
           "DSN": "dsn", "FRN": "frn", "CAN": "can"}


@pytest.mark.parametrize("kind", ["eval", "train"])
@pytest.mark.parametrize("name", HEADS)
def test_chip_cells_are_the_shipped_head_configs_cut_to_size(name, kind, tmp_path):
    """The cells ``chip_smoke.py`` runs are each head's shipped
    ``*_5shot_iid_seed0.yaml`` with its headers but for the cuts they name;
    each (but FEAT, whose 12800-wide attention is 655 M parameters) builds at
    full width, the shipped resnet12 with drop_rate 0.1."""
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
    if name == "FEAT" or kind == "train":
        return
    model = build_method(cell)
    assert model.emb_func.layer3[0].drop.block_size == 5
    assert model.emb_func.layer1[0].drop.rate == 0.1
    shape = model.emb_func.map_shape(cell["spec_shape"])
    assert shape == ((640, 8, 9) if name in MAP_HEADS else (640, 4, 5))

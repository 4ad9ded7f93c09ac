"""The last pretrainers of the PyTorch port (FRN_Pretrain, S2M2,
MTLPretrain, MetabaselineKendallPretrain) against the JAX package on the
CPU, at the same weights (the JAX package's variable trees drawn with numpy,
``test_torch_port_meta2.draw_tree``, with random BN statistics, carried
across by ``utils/convert.py``), and their shipped configs.

Geometry: FRN_Pretrain on a narrow resnet12's [64, 6, 7] map (planes
8/12/16/64 on ``[1, 96, 112]``: 64 channels over 42 positions, so SᵀS of a
class's rows of ``cat_mat`` is rank-deficient, as at the shipped 640 over
72), S2M2 on Conv64F's 1600 flat features
(``[1, 81, 90]``), MTLPretrain and MetabaselineKendallPretrain on the narrow
resnet12's 120 flat features (``test_torch_port_finetuning.py``'s cases),
``num_class`` 7, flat batches of 8.

Tolerances:
- eval logits over shared float32 features: MTLPretrain's 5 gradient steps
  and Kendall's exact score against the JAX float32 heads, 1e-5 of the
  logits' scale (``EVAL_TOL``); FRN_Pretrain's (on [64, 2, 3] maps, 12 pool
  rows a class) against a float64 JAX head: the port solves in float64 and
  reconstructs in float32, the JAX float32 head does both in float32, which
  at the shipped width put FRN's logits 3.5e-4 off float64 (here the JAX
  float32 head reads 8.0e-8 off its float64 one, the port 8.0e-8): 1e-5; S2M2's cosine adaptation (140 steps) against the JAX
  float64 head, the port in float32: 1e-4 (``finetuning.ADAPT_F32_TOL``);
- one flat train step of the whole method against the JAX package with a
  float64 backbone and a float64 head: loss and logits 1e-5 of the logits'
  scale, gradients 1e-4 of their max abs (a tenth of the largest where that
  is more), running statistics 1e-5, the port with float64 blocks
  (``STEP_TOLS``; measured: gradients 1.6e-6 and 1.3e-5) and float32 ones
  (``F32_STEP_TOLS``: float32 rounding through the backbone's train-mode
  BNs); MTLPretrain and MetabaselineKendallPretrain
  through ``test_torch_port_finetuning.check_flat_step``'s limits.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.episode import FlatBatch as JaxFlatBatch  # noqa: E402
from audio_fewshot_tpu.episode import make_dense_episode_batch as jax_dense_batch  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting as JaxSetting  # noqa: E402
from audio_fewshot_tpu_torch import run_trainer  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import FlatLoader, get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.episode import FlatBatch, make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.eval import slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.layers import Dropout  # noqa: E402
from audio_fewshot_tpu_torch.models.base import EpisodeSetting, ModelType  # noqa: E402
from audio_fewshot_tpu_torch.train import slice_config as train_cell  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    head_state_dict_from_jax, state_dict_from_jax)
from tools.cross_framework_parity import (  # noqa: E402
    invert_frn_pretrain_head_params, invert_global_linear_head_params,
    invert_mtl_pretrain_head_params, invert_s2m2_head_params)

import test_torch_port_finetuning as ft  # noqa: E402
from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_flat import no_tensorboard  # noqa: E402,F401
from test_torch_port_meta2 import draw_tree  # noqa: E402
from test_torch_port_metric import _rel, _running  # noqa: E402
from test_torch_port_resnet12_heads import _check_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_TOL = 1e-5
STEP_TOLS = {"logits": 1e-5, "grads": 1e-4, "vanishing": 1e-3, "stats": 1e-5}
# float32 blocks (measured: FRN_Pretrain's gradients 4.0e-4, S2M2's
# logits 3.9e-6)
F32_STEP_TOLS = {"FRN_Pretrain": dict(STEP_TOLS, grads=2e-3, vanishing=1e-2),
                 "S2M2": dict(STEP_TOLS, logits=3e-5)}
NUM_CLASS, BATCH = 7, 8
SETTING = EpisodeSetting(way=5, shot=2, query=2)
JAX_SETTING = JaxSetting(way=5, shot=2, query=2)
SPECS = {"FRN_Pretrain": (1, 96, 112), "S2M2": (1, 81, 90)}
BACKBONES = {
    "FRN_Pretrain": {"name": "resnet12", "kwargs": {
        "num_channels": 1, "planes": [8, 12, 16, 64], "drop_rate": 0.0, "is_flatten": False,
        "avg_pool": False}},
    "S2M2": {"name": "Conv64F", "kwargs": {"is_flatten": True, "num_channels": 1}},
}


def config(name, dtype=None):
    bk = {"name": BACKBONES[name]["name"], "kwargs": dict(BACKBONES[name]["kwargs"])}
    if dtype:
        bk["kwargs"]["dtype"] = dtype
    return {"classifier": {"name": name, "kwargs": {"num_class": NUM_CLASS}}, "backbone": bk,
            "modality": "audio", "precision": "fp32", "way_num": 5, "shot_num": 2,
            "query_num": 2, "spec_shape": list(SPECS[name])}


def flat_batch(name, seed=2):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(BATCH,) + SPECS[name]).astype(np.float32)
    return data, rng.integers(0, NUM_CLASS, size=BATCH).astype(np.int32)


def jax_method(cfg, name):
    """The JAX method with its shape-sized heads made (FRN_Pretrain builds
    ``frn_head`` in ``init_variables``) and its variables' shapes."""
    method = jax_build_method(cfg)
    data, target = flat_batch(name)
    shapes = jax.eval_shape(lambda key: method.init_variables(
        key, JaxFlatBatch(data=jnp.asarray(data[:2]), target=jnp.asarray(target[:2])),
        JAX_SETTING), jax.random.PRNGKey(0))
    return method, shapes


_VARIABLES = {}


def jax_variables(name):
    """numpy draws of the JAX method's variables, random BN statistics;
    FRN_Pretrain's ``scale`` 1.3 and ``r`` (0.4, −0.3), off their init."""
    if name not in _VARIABLES:
        _, shapes = jax_method(config(name), name)
        tree = draw_tree(shapes, np.random.default_rng(0))
        tree = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, tree),
                                   np.random.default_rng(1))
        if name == "FRN_Pretrain":
            tree["params"]["frn_head"].update(scale=np.asarray(1.3, np.float32),
                                              r=np.asarray([0.4, -0.3], np.float32))
        _VARIABLES[name] = tree
    return _VARIABLES[name]


def port_method(name, variables, dtype=torch.float32):
    method = build_method(config(name))
    method.load_state_dict(state_dict_from_jax(variables, BACKBONES[name]["name"],
                                               prefix="emb_func.", classifier=name))
    if dtype == torch.float64:  # the blocks only: both packages cast the map
        emb = method.emb_func
        emb.dtype = dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(dtype)
    return method


def as_port(name, variables, params=None, stats=None):
    tree = {"params": variables["params"] if params is None else params,
            "batch_stats": variables.get("batch_stats", {}) if stats is None else stats}
    return {k: v.numpy() for k, v in state_dict_from_jax(
        tree, BACKBONES[name]["name"], prefix="emb_func.", classifier=name).items()}


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout (Conv64F's logits head) the identity in both packages."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)


def _wide(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64) if np.issubdtype(
        np.asarray(a).dtype, np.floating) else a, tree)


def s2m2_draws(batch_size, rng):
    """The λ and the permutation the JAX S2M2 draws from ``rng`` in
    ``jax_flat_step`` (under ``enable_x64``, which changes the draws)."""
    with jax.enable_x64(True):
        r_lam, r_perm, _ = jax.random.split(rng, 3)
        lam = float(jax.random.beta(r_lam, 2.0, 2.0))
        perm = np.array(jax.random.permutation(r_perm, batch_size))
    return lam, perm


def jax_flat_step(name):
    """One JAX flat train step with a float64 backbone and a float64 head
    at ``PRNGKey(1)``: (loss, logits, gradients, running statistics) under
    the port's names."""
    variables = jax_variables(name)
    data, target = flat_batch(name)
    with jax.enable_x64(True):
        method, _ = jax_method(config(name, dtype="float64"), name)
        wide = _wide(variables)
        non_params = {k: v for k, v in wide.items() if k != "params"}
        batch = JaxFlatBatch(data=jnp.asarray(data), target=jnp.asarray(target))

        def loss_fn(params):
            return method.loss({**non_params, "params": params}, batch, JAX_SETTING,
                               jax.random.PRNGKey(1))

        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(wide["params"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
        stats = method.merge_updates({"batch_stats": variables["batch_stats"]},
                                     out.updates)["batch_stats"]
        stats = jax.tree_util.tree_map(np.asarray, stats)
    return (float(loss), np.asarray(out.seg_logits), as_port(name, variables, params=grads),
            as_port(name, variables, stats=stats))


def check_whole_step(name):
    """The port's flat step (float64 and float32 blocks) against
    ``jax_flat_step``; S2M2 handed the JAX package's λ and permutation."""
    ref = jax_flat_step(name)
    data, target = flat_batch(name)
    batch = FlatBatch(data=data, target=target).to("cpu")
    lam, perm = s2m2_draws(BATCH, jax.random.PRNGKey(1))
    for dtype, tols in ((torch.float64, STEP_TOLS), (torch.float32, F32_STEP_TOLS[name])):
        method = port_method(name, jax_variables(name), dtype).train()
        if name == "S2M2":
            method.mixup.draw = lambda b: (lam, perm)
        loss, out = method.loss(batch, SETTING)
        loss.backward()
        named = dict(method.named_parameters())
        _check_step(named, _running(method), loss, out, ref, tols)


# -- FRN_Pretrain --------------------------------------------------------------------------------

def test_frn_pretrain_eval_logits_match_a_float64_jax_head():
    """Query log-probabilities of each episode's positions reconstructed
    from its class pools (scaled by 1/√640, ``r`` and ``scale`` off their
    init) over shared float32 maps, against the JAX head in float64."""
    variables = jax_variables("FRN_Pretrain")
    rng = np.random.default_rng(6)
    sup = np.maximum(rng.normal(size=(2, 10, 64, 2, 3)), 0).astype(np.float32)
    qry = np.maximum(rng.normal(size=(2, 10, 64, 2, 3)), 0).astype(np.float32)
    holder = np.zeros((2, 10, 1, 1, 1), np.float32)
    with jax.enable_x64(True):
        jm, _ = jax_method(config("FRN_Pretrain"), "FRN_Pretrain")
        jm.embed = lambda *a, **k: (sup.astype(np.float64), qry.astype(np.float64), {})
        ref = np.asarray(jm.forward(_wide(variables), jax_dense_batch(holder, holder, 5, 2, 2),
                                    JAX_SETTING))
    ours = port_method("FRN_Pretrain", variables).eval()
    ours.embed = lambda batch: (torch.from_numpy(sup), torch.from_numpy(qry))
    with torch.no_grad():
        got = ours(make_dense_episode_batch(holder, holder, 5, 2, 2).to("cpu"), SETTING).numpy()
    assert got.shape == ref.shape == (2, 10, 5)
    assert _rel(got, ref) <= EVAL_TOL
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)


def test_frn_pretrain_train_step_matches_jax_float64():
    """The NLL of the position-averaged negative reconstruction distances
    to ``cat_mat``: loss, log-probabilities, every gradient (backbone,
    ``scale``, ``cat_mat``) and every running statistic; ``r`` is frozen in
    both (a buffer here, a stop-gradient there)."""
    check_whole_step("FRN_Pretrain")
    method = build_method(config("FRN_Pretrain"))
    assert "frn_layer.r" in dict(method.named_buffers())
    assert {k for k, _ in method.named_parameters() if not k.startswith("emb_func.")} == {
        "frn_layer.scale", "frn_layer.cat_mat"}


def test_frn_pretrain_reads_the_map_of_the_shipped_config():
    """The shipped config names the plain resnet12, which flattens: the JAX
    package fails on it at init (unpacking the flat features as a map); the
    port asks the backbone for the map (``backbone_kwarg_defaults``), a
    [640, 8, 9] one at ``[1, 128, 157]``, so ``cat_mat`` is [25, 72, 640]."""
    cfg = Config(os.path.join(REPO, "config", "frn_pretrain",
                              "frn_pretrain_5shot_iid_seed0.yaml")).get_config_dict()
    cfg.update(spec_shape=[1, 128, 157], precision="fp32")
    method = build_method(cfg)
    assert not method.emb_func.is_flatten and not method.emb_func.avg_pool
    assert tuple(method.frn_layer.cat_mat.shape) == (25, 72, 640)
    small = dict(cfg, spec_shape=[1, 32, 40])
    small["backbone"] = dict(cfg["backbone"], kwargs=dict(cfg["backbone"]["kwargs"],
                                                          planes=[8, 12, 16, 20]))
    jm = jax_build_method(small)
    data = jnp.zeros((2, 1, 32, 40))
    with pytest.raises(ValueError, match="not enough values to unpack"):
        jax.eval_shape(lambda key: jm.init_variables(
            key, JaxFlatBatch(data=data, target=jnp.zeros(2, jnp.int32)), JAX_SETTING),
            jax.random.PRNGKey(0))


# -- S2M2 ------------------------------------------------------------------------------------

def test_s2m2_train_step_matches_jax_float64(no_dropout):
    """Input mixup at the JAX package's λ and permutation + the four flips'
    class CE and ``rot_classifier``'s CE: loss, logits, every gradient and
    the running statistics after the step (the second call's: one update
    by the flipped batch, as the JAX package's ``merge_updates``)."""
    check_whole_step("S2M2")


def test_s2m2_keeps_only_the_flipped_batchs_statistics(no_dropout):
    """After an S2M2 step each BN's running statistics are one momentum
    update by the flipped batch from where the step started, as if the
    mixup call had not run (torch's two train-mode calls would apply two)."""
    variables = jax_variables("S2M2")
    data, target = flat_batch("S2M2")
    x = torch.from_numpy(data)
    method = port_method("S2M2", variables).train()
    method.loss(FlatBatch(data=data, target=target).to("cpu"), SETTING)
    alone = port_method("S2M2", variables).train()
    with torch.no_grad():
        alone.flat_features(torch.cat([x, x.flip(-1), x.flip(-2), x.flip((-2, -1))]))
    got, want = _running(method), _running(alone)
    assert len(got) == 10
    for key in got:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6)
    start = as_port("S2M2", variables)
    assert any(not np.allclose(got[k].numpy(), start[k]) for k in got)


def test_s2m2_draws_from_its_own_seeded_generator():
    """λ ~ Beta(2, 2) and the permutation come from a host numpy generator
    that ``seed_dropout`` reseeds: the same seed, the same draws."""
    from audio_fewshot_tpu_torch.models.backbones.layers import seed_dropout

    method = build_method(config("S2M2"))
    seed_dropout(method, 5)
    first = [method.mixup.draw(8) for _ in range(3)]
    seed_dropout(method, 5)
    again = [method.mixup.draw(8) for _ in range(3)]
    for (lam, perm), (lam2, perm2) in zip(first, again):
        assert lam == lam2 and 0.0 < lam < 1.0
        np.testing.assert_array_equal(perm, perm2)
        assert sorted(perm) == list(range(8))
    assert len({lam for lam, _ in first}) == 3
    assert method.backbone_rows(128) == 640


def test_s2m2_eval_adapts_the_cosine_head_as_jax():
    """S2M2's eval: the cosine head from the class prototypes, 140 SGD
    steps an episode (the finetuning defaults), over shared features."""
    sup, sup_y, qry = ft._episode_features(2)
    with jax.enable_x64(True):
        jm = jax_build_method(config("S2M2"))
        n_steps = jm._adapt_steps(25)
        ref = np.asarray(jax.jit(jax.vmap(lambda s, y, q: jm._episode_head_logits(
            s, y, q, n_steps, way=5)))(sup, sup_y, qry))
    ours = build_method(config("S2M2"))
    assert ours._adapt_steps(25) == n_steps == 140
    got = ours.episode_head_logits(torch.tensor(sup, dtype=torch.float32),
                                   torch.from_numpy(sup_y),
                                   torch.tensor(qry, dtype=torch.float32), 5)
    assert _rel(got.numpy(), ref) <= ft.ADAPT_F32_TOL


# -- MTLPretrain and MetabaselineKendallPretrain ----------------------------------------------

@pytest.mark.parametrize("case", ["MTLPretrain", "MetabaselineKendallPretrain"])
def test_global_pretrain_step_matches_jax(case):
    """MTLPretrain's ``pre_fc`` (Linear 1000 → ReLU → Linear) and
    MetabaselineKendallPretrain's linear head: one flat train step."""
    ft.check_flat_step(case)


@pytest.mark.parametrize("case", ["MTLPretrain", "MetabaselineKendallPretrain"])
def test_global_pretrain_eval_logits_match_jax(case):
    """MTLPretrain: a linear learner from zero, 5 plain gradient steps at lr
    0.01 on each episode's support; MetabaselineKendallPretrain: the exact
    Kendall score against the prototypes.  Over shared float32 features,
    against the JAX float32 heads."""
    e, shot, query = 2, 2, 3
    rng = np.random.default_rng(12)
    d = 120
    sup = (np.maximum(rng.normal(size=(e, 5 * shot, d)), 0) + 0.5 * np.repeat(
        rng.normal(size=(e, 5, d)), shot, axis=1)).astype(np.float32)
    qry = np.maximum(rng.normal(size=(e, 5 * query, d)), 0).astype(np.float32)
    holder = np.zeros((e, 5 * shot, 1, 1, 1), np.float32)
    q_holder = np.zeros((e, 5 * query, 1, 1, 1), np.float32)
    jm = jax_build_method(ft.config(case))
    jm.embed = lambda *a, **k: (sup, qry, {})
    ref = np.asarray(jm.forward({}, jax_dense_batch(holder, q_holder, 5, shot, query),
                                JaxSetting(5, shot, query)))
    ours = build_method(ft.config(case)).eval()
    ours.embed = lambda batch: (torch.from_numpy(sup), torch.from_numpy(qry))
    with torch.no_grad():
        got = ours(make_dense_episode_batch(holder, q_holder, 5, shot, query).to("cpu"),
                   EpisodeSetting(5, shot, query)).numpy()
    assert got.shape == ref.shape == (e, 5 * query, 5)
    assert _rel(got, ref) <= EVAL_TOL
    assert np.ptp(ref, axis=-1).max() > 10 * EVAL_TOL * np.abs(ref).max()
    if case == "MTLPretrain":
        assert ours.adapt_iter == jm.adapt_iter == 5


# -- the weights across -----------------------------------------------------------------------

def _reference_entries(name, variables):
    if name == "FRN_Pretrain":
        return invert_frn_pretrain_head_params(variables)
    if name == "MTLPretrain":
        return invert_mtl_pretrain_head_params(variables)
    return invert_global_linear_head_params(variables, "classifier")


@pytest.mark.parametrize("name", ["FRN_Pretrain", "MTLPretrain", "MetabaselineKendallPretrain",
                                  "S2M2"])
def test_head_weights_cross_under_the_reference_names(name):
    """``utils/convert.py``'s head entries against ``tools/cross_framework_parity.py``'s
    inverters, key for key and value for value; S2M2's cosine head kept as
    its effective weight, which the reference's weight-normed ``disclass.L``
    (``weight_g`` · ``weight_v`` / ‖``weight_v``‖) reconstructs, and its
    ``rot_classifier`` as the reference's ``classifier_rot``.  Each loads
    into the port's method strictly."""
    variables = jax_variables(name) if name in BACKBONES else ft.jax_variables(name)
    ours = head_state_dict_from_jax(variables, name)
    if name == "S2M2":
        ref = invert_s2m2_head_params(variables)
        v, g = ref["disclass.L.weight_v"], ref["disclass.L.weight_g"]
        np.testing.assert_allclose(ours["classifier.weight"],
                                   g * v / np.linalg.norm(v, axis=1, keepdims=True), rtol=1e-6)
        for key in ("weight", "bias"):
            np.testing.assert_array_equal(ours[f"rot_classifier.{key}"],
                                          ref[f"classifier_rot.{key}"])
        assert set(ours) == {"classifier.weight", "rot_classifier.weight", "rot_classifier.bias"}
    else:
        ref = _reference_entries(name, variables)
        assert set(ours) == set(ref)
        for key, val in ref.items():
            np.testing.assert_array_equal(ours[key], val, err_msg=key)
    backbone = BACKBONES[name]["name"] if name in BACKBONES else "resnet12"
    method = build_method(config(name) if name in BACKBONES else ft.config(name))
    method.load_state_dict(state_dict_from_jax(variables, backbone, prefix="emb_func.",
                                               classifier=name))


# -- the shipped configs and the chip cells -------------------------------------------------

SHIPPED = {"FRN_Pretrain": "frn_pretrain", "S2M2": "s2m2"}


def _small(cfg, root):
    """A shipped config at a CPU-sized geometry, as
    ``test_torch_port_pretrains._small``."""
    name = cfg["backbone"]["name"]
    cfg.update(spec_shape={"Conv64F": [1, 81, 90]}.get(name, [1, 32, 40]),
               data_root="synthetic:6:16", batch_size=16, epoch=1, test_episode=2,
               test_episode_size=2, max_segments_per_clip=2, precision="fp32",
               result_root=str(root), prefetch=0)
    if name == "resnet12":
        cfg["backbone"]["kwargs"]["planes"] = [8, 12, 16, 20]
    return cfg


@pytest.mark.parametrize("name", list(SHIPPED))
def test_every_shipped_config_builds_loads_flat_and_trains(name, tmp_path, no_tensorboard):
    """Every shipped config naming the head builds its method and a flat
    train loader; its ``*_5shot_iid_seed0.yaml`` trains one epoch through
    ``run_trainer`` on the CPU at a small geometry."""
    paths = sorted(p for p in glob.glob(os.path.join(REPO, "config", "**", "*.yaml"),
                                        recursive=True)
                   if "kos_fixture" not in p and f"name: {name}\n" in open(p).read())
    assert len(paths) == 18
    for path in paths:
        cfg = _small(Config(path).get_config_dict(), tmp_path)
        method = build_method(cfg)
        assert method.model_type == ModelType.FINETUNING
        loader = get_dataloader(cfg, "train", method.model_type)[0]
        assert isinstance(loader, FlatLoader) and loader.sampler.batch_size == 16
    source = SHIPPED[name]
    leaf = os.path.join(REPO, "config", source, f"{source}_5shot_iid_seed0.yaml")
    over = _small({"backbone": {"name": "resnet12" if name == "FRN_Pretrain" else "Conv64F",
                                "kwargs": {}}}, tmp_path)
    argv = ["--yaml_path", leaf, "--device", "cpu"]
    for key in ("spec_shape", "data_root", "batch_size", "epoch", "test_episode",
                "test_episode_size", "max_segments_per_clip", "precision", "result_root",
                "prefetch"):
        argv += [f"--{key}", str(over[key])]
    if "planes" in over["backbone"]["kwargs"]:
        argv += ["--backbone.kwargs.planes", "[8, 12, 16, 20]"]
    trainer = run_trainer.main(argv)
    record = trainer.history[0]
    assert len(record["train_losses"]) == 96 // 16
    assert all(np.isfinite(record["train_losses"])) and np.isfinite(record["test_acc"])


FEATURES = {"FRN_Pretrain": None, "S2M2": 1600, "MTLPretrain": 12800,
            "MetabaselineKendallPretrain": 12800}


@pytest.mark.parametrize("kind", ["eval", "train"])
@pytest.mark.parametrize("name", list(FEATURES))
def test_chip_cells_are_the_shipped_configs_cut_to_size(name, kind, tmp_path):
    """The cells ``chip_smoke.py`` runs: each head's shipped
    ``*_5shot_iid_seed0.yaml`` with its headers but for the cuts they name
    (MTLPretrain and MetabaselineKendallPretrain, which ship none:
    MetabaselinePretrain's with their own name); each builds at full width."""
    source = SHIPPED.get(name, "metabaseline_pretrain")
    shipped = Config(os.path.join(REPO, "config", source,
                                  f"{source}_5shot_iid_seed0.yaml")).get_config_dict()
    if name not in SHIPPED:
        shipped["classifier"]["name"] = name
        shipped["tag"] = eval_cell(classifier=name)["tag"]
    if kind == "eval":
        cell = eval_cell(classifier=name, test_episode=64, test_epoch=1)
        cuts = {"test_episode": (600, 64), "test_epoch": (5, 1), "test_episode_size": (None, 16),
                "max_segments_per_clip": (8, 6), "spec_shape": (None, [1, 128, 157])}
        kept = ("classifier", "backbone", "modality", "test_way", "test_shot", "test_query",
                "augment_times", "seed", "ood", "tag", "batch_size")
    else:
        cell = train_cell(str(tmp_path), classifier=name, epoch=1, test_episode=16)
        cuts = {"epoch": (30, 1), "train_episode": (1000, 40), "test_episode": (600, 16),
                "result_root": ("./results", str(tmp_path)), "tb_scale": (1000 / 600, 40 / 16),
                "spec_shape": (None, [1, 128, 157])}
        kept = [k for k in shipped if k not in cuts and k != "includes"]
    for key, (full, cut) in cuts.items():
        assert (shipped.get(key), cell.get(key)) == (full, cut), key
    for key in kept:
        assert cell.get(key) == shipped[key], key
    model = build_method(cell)
    assert model.model_type == ModelType.FINETUNING
    if name == "FRN_Pretrain":
        assert tuple(model.frn_layer.cat_mat.shape) == (25, 72, 640)
    elif name == "MTLPretrain":
        assert (model.pre_fc[0].in_features, model.pre_fc[2].out_features) == (12800, 25)
    else:
        assert model.classifier.in_features == FEATURES[name]

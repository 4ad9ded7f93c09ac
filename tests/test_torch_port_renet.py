"""RENet of the PyTorch port against the JAX package on the CPU, at the same
weights (the JAX package's random init with random BN statistics, carried
across by ``utils/convert.py``, the SCR, CCA and ``fc`` weights included).

Geometry: 3-way 3-shot 2-query episodes on Conv64F's [64, 4, 5] map
(``last_pool: false`` at ``[1, 108, 135]``, the shipped 4×5 map) and on a
narrow resnet12's [20, 6, 7] map (planes 8/12/16/20 on ``[1, 96, 112]``,
``is_flatten``/``avg_pool`` false as the shipped config).

Tolerances (relative to the logits' scale, or to a gradient's max abs):
- SCR (the port's offset-by-offset form) against the JAX ``SCRLayer`` in
  float32, eval and train mode: outputs and running statistics 1e-5
  (``LAYER_TOL``); CCA on one episode with bucket-padded queries: 1e-5;
- eval logits of the whole method, float32 against the JAX package's
  float32: 1e-5 (``LOGIT_TOL``); the real rows' logits with and without 2
  bucket-padded query rows an episode: 1e-5 of the scale (the port against
  itself); an episode's logits alone and in a batch of two: 1e-6;
- one train step (episodic CE + the global ``fc`` CE) against the JAX
  package with a float64 backbone and a float64 head, as
  ``test_torch_port_resnet12_heads.py`` holds the resnet12 heads: loss and
  logits 1e-5, gradients 1e-4 of their max abs (a tenth of the largest
  where that is more; 1e-3 of the largest for one that vanishes in exact
  arithmetic), running statistics 1e-5, the port with a float64 backbone
  (``STEP_TOLS``; measured: gradients 1.1e-6 on Conv64F, 1.7e-6 on
  resnet12) and with a float32 one (``F32_STEP_TOLS``, gradients 2e-3:
  float32 rounding through the backbone's train-mode BNs; measured 4.3e-4
  and 4.1e-4).
"""

import glob
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
from audio_fewshot_tpu.models.heads import renet as jax_renet  # noqa: E402
from audio_fewshot_tpu_torch import run_trainer  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import EpisodicLoader, get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.episode import make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.eval import slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.base import ModelType  # noqa: E402
from audio_fewshot_tpu_torch.models.heads import renet  # noqa: E402
from audio_fewshot_tpu_torch.train import slice_config as train_cell  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    head_state_dict_from_jax, state_dict_from_jax)
from tools.cross_framework_parity import invert_renet_head_params  # noqa: E402

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_flat import no_tensorboard  # noqa: E402,F401
from test_torch_port_metric import _rel, _running  # noqa: E402
from test_torch_port_resnet12_heads import _check_step, _without_counters  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-5
BATCH_TOL = 1e-6
STEP_TOLS = {"logits": 1e-5, "grads": 1e-4, "vanishing": 1e-3, "stats": 1e-5}
F32_STEP_TOLS = dict(STEP_TOLS, grads=2e-3, vanishing=1e-2)
WAY, SHOT, QUERY = 3, 3, 2
SETTING = EpisodeSetting(way=WAY, shot=SHOT, query=QUERY)
SPECS = {"Conv64F": (1, 108, 135), "resnet12": (1, 96, 112)}
BACKBONES = {
    "Conv64F": {"name": "Conv64F", "kwargs": {"is_flatten": False, "last_pool": False,
                                              "num_channels": 1}},
    "resnet12": {"name": "resnet12", "kwargs": {"is_flatten": False, "avg_pool": False,
                                                "num_channels": 1, "planes": [8, 12, 16, 20]}},
}
MAPS = {"Conv64F": (64, 4, 5), "resnet12": (20, 6, 7)}


def renet_config(backbone, dtype=None, drop_rate=None, **over):
    """RENet on ``backbone`` at the test's small geometry, float32."""
    kwargs = dict(BACKBONES[backbone]["kwargs"])
    if dtype:
        kwargs["dtype"] = dtype
    if drop_rate is not None and backbone == "resnet12":
        kwargs["drop_rate"] = drop_rate
    cfg = {"classifier": {"name": "RENet", "kwargs": {"feat_dim": MAPS[backbone][0],
                                                      "num_class": 25}},
           "backbone": {"name": BACKBONES[backbone]["name"], "kwargs": kwargs},
           "modality": "audio", "precision": "fp32", "way_num": WAY, "shot_num": SHOT,
           "query_num": QUERY, "spec_shape": list(SPECS[backbone])}
    cfg.update(over)
    return cfg


def batches(backbone, e, pad=0, seed=0):
    """The same dense episodes for both packages, with global targets; with
    ``pad``, that many bucket-padded query rows (noise, mask 0)."""
    spec = SPECS[backbone]
    rng = np.random.default_rng(seed)
    sup = rng.normal(size=(e, WAY * SHOT) + spec).astype(np.float32)
    qry = rng.normal(size=(e, WAY * QUERY) + spec).astype(np.float32)
    glob_t = rng.integers(0, 25, size=(e, WAY * (SHOT + QUERY)))
    jb = jax_dense_batch(sup, qry, WAY, SHOT, QUERY, global_target=glob_t)
    pb = make_dense_episode_batch(sup, qry, WAY, SHOT, QUERY, global_target=glob_t)
    if pad:
        extra = rng.normal(size=(e, pad) + spec).astype(np.float32)
        fields = dict(query=np.concatenate([qry, extra], axis=1),
                      query_clip=np.concatenate([pb.query_clip, np.zeros((e, pad), np.int32)], 1),
                      query_mask=np.concatenate([pb.query_mask, np.zeros((e, pad), np.float32)], 1))
        jb, pb = jb.replace(**fields), pb.replace(**fields)
    return jb, pb.to("cpu")


_VARIABLES = {}


def jax_variables(backbone):
    """The JAX method's initial variables (resnet12 at drop_rate 0.1: the
    DropBlock counters exist, set to 7 and 11) with random BN statistics,
    made once per backbone."""
    if backbone not in _VARIABLES:
        jb, _ = batches(backbone, 1)
        method = jax_build_method(renet_config(backbone))
        variables = jax.jit(lambda key: method.init_variables(key, jb, SETTING))(
            jax.random.PRNGKey(0))
        variables = randomize_batchnorm(
            jax.tree_util.tree_map(np.asarray, variables), np.random.default_rng(1))
        if backbone == "resnet12":
            for block, count in (("layer3", 7), ("layer4", 11)):
                variables["batch_stats"]["emb_func"][block]["num_batches_tracked"] = \
                    np.asarray(count, np.int32)
        _VARIABLES[backbone] = variables
    return _VARIABLES[backbone]


def port_method(backbone, variables, dtype=torch.float32, drop_rate=None):
    """The port's RENet at ``variables``; ``dtype`` float64: its backbone's
    blocks only (both packages cast the map to float32)."""
    method = build_method(renet_config(backbone, drop_rate=drop_rate))
    method.load_state_dict(state_dict_from_jax(variables, backbone, prefix="emb_func.",
                                               classifier="RENet"))
    if dtype == torch.float64:
        emb = method.emb_func
        emb.dtype = dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(dtype)
    return method


def as_port(variables, backbone, params=None, stats=None):
    tree = {"params": variables["params"] if params is None else params,
            "batch_stats": variables.get("batch_stats", {}) if stats is None else stats}
    return {k: v.numpy() for k, v in state_dict_from_jax(
        tree, backbone, prefix="emb_func.", classifier="RENet").items()}


# -- SCR and CCA ------------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_scr_offset_form_matches_jax(train):
    """The port's SCR (its 1×1 conv offset by offset, no [N, c, h, w, 5, 5]
    correlation) against the JAX ``SCRLayer`` at the method's weights:
    outputs, and in train mode the batch statistics' running updates."""
    variables = jax_variables("resnet12")
    c, h, w = MAPS["resnet12"]
    x = np.random.default_rng(3).normal(size=(8, c, h, w)).astype(np.float32)
    tree = {"params": variables["params"]["scr"], "batch_stats": variables["batch_stats"]["scr"]}
    ref, updates = jax_renet.SCRLayer().apply(tree, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                              train=train, mutable=["batch_stats"])
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    method = port_method("resnet12", variables)
    scr = method.scr_layer.train(train)
    with torch.no_grad():
        ours = scr(torch.from_numpy(x)).numpy()
    assert _rel(ours, ref) <= LAYER_TOL
    if train:
        stats = as_port(variables, "resnet12", stats={
            **variables["batch_stats"], "scr": jax.tree_util.tree_map(
                np.asarray, updates["batch_stats"])})
        running = _running(method, "scr_layer.")
        assert len(running) == 8
        for key, val in running.items():
            np.testing.assert_allclose(val.numpy(), stats[key], rtol=LAYER_TOL,
                                       atol=LAYER_TOL, err_msg=key)


@pytest.mark.parametrize("layout", ["leading", "scattered"])
def test_cca_matches_jax_on_an_episode_with_padded_queries(layout):
    """One episode's CCA (per-episode batch statistics over the real query
    rows, ``cca_bn`` apart for the support and the query) against the JAX
    ``CCALayer``: the similarities and the pooled centred queries.  The real
    rows lead (as the loaders pack them: the statistics from a leading
    slice) or are scattered (the masked statistics)."""
    variables = jax_variables("Conv64F")
    c, h, w = MAPS["Conv64F"]
    rng = np.random.default_rng(4)
    spt = rng.normal(size=(WAY * SHOT, c, h, w)).astype(np.float32)
    qry = rng.normal(size=(WAY * QUERY + 3, c, h, w)).astype(np.float32)
    mask = np.arange(qry.shape[0]) < WAY * QUERY
    if layout == "scattered":
        mask = mask[rng.permutation(len(mask))]
    tree = {"params": variables["params"]["cca"]}
    layer = jax_renet.CCALayer(feat_dim=c, temperature=0.2, temperature_attn=5.0)
    (sims, pooled), _ = layer.apply(tree, jnp.asarray(spt), jnp.asarray(qry), WAY, SHOT,
                                    train=True, qry_mask=jnp.asarray(mask),
                                    mutable=["batch_stats"])
    cca = port_method("Conv64F", variables).cca_layer
    assert cca.temperature == 0.2
    with torch.no_grad():
        ours, ours_pooled = cca(torch.from_numpy(spt), torch.from_numpy(qry), WAY, SHOT,
                                torch.from_numpy(mask))
    assert _rel(ours.numpy(), np.asarray(sims)) <= LAYER_TOL
    assert _rel(ours_pooled.numpy(), np.asarray(pooled)) <= LAYER_TOL
    # the real rows' similarities do not see the padded rows
    with torch.no_grad():
        dense, _ = cca(torch.from_numpy(spt), torch.from_numpy(qry[mask]), WAY, SHOT)
    assert _rel(ours[torch.from_numpy(mask)].numpy(), dense.numpy()) <= LAYER_TOL


def test_batch_statistics_of_the_leading_rows_are_the_masked_ones():
    """``BatchNormNd`` without running statistics: its statistics over the
    first ``rows`` rows equal its masked statistics with those rows marked,
    and over all rows the library's training ``batch_norm`` (float64,
    1e-12), with and without gradients."""
    bn = renet.BatchNormNd(4, use_running_statistics=False).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    x = torch.randn(7, 4, 3, 5, dtype=torch.float64)
    mask = torch.arange(7) < 5
    with torch.no_grad():
        torch.testing.assert_close(bn(x, rows=5), bn(x, mask), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(bn(x), torch.nn.functional.batch_norm(
            x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(bn(x.clone().requires_grad_()), bn(x), rtol=1e-12, atol=1e-12)
    # with gradients (a padded train batch): the same values and gradients
    xg = x.clone().requires_grad_()
    out = bn(xg, rows=5)
    ref_x = x.clone().requires_grad_()
    ref = bn(ref_x, mask)
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)
    weights = torch.randn_like(x)
    grads = torch.autograd.grad((out * weights).sum(), [xg, bn.weight])
    ref_grads = torch.autograd.grad((ref * weights).sum(), [ref_x, bn.weight])
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_one_by_one_maps_raise_as_in_the_jax_package():
    """A 1×1 map (the shipped ``last_pool: true`` on Conv64F) makes the
    unbiased variance over one position 0/0: both packages raise."""
    cca = renet.CCALayer(8)
    with pytest.raises(ValueError, match="RENet CCA needs spatial feature maps, got 1x1"):
        cca(torch.zeros(3, 8, 1, 1), torch.zeros(2, 8, 1, 1), 3, 1)
    with pytest.raises(ValueError, match="RENet CCA needs spatial feature maps, got 1x1"):
        jax_renet.CCALayer(feat_dim=8).init(jax.random.PRNGKey(0), jnp.zeros((3, 8, 1, 1)),
                                            jnp.zeros((2, 8, 1, 1)), 3, 1, train=False)


# -- the whole method -------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["Conv64F", "resnet12"])
def test_eval_logits_match_jax(backbone):
    """Eval-mode segment logits of two episodes with 2 bucket-padded query
    rows each against the JAX package's float32 ``forward``; the real rows'
    equal the port's own on the unpadded batch, and each episode's equal
    its own alone (CCA's statistics are per episode)."""
    variables = jax_variables(backbone)
    jax_method = jax_build_method(renet_config(backbone))
    jb, pb = batches(backbone, 2, pad=2, seed=5)
    ref = np.asarray(jax.jit(lambda v, b: jax_method.forward(v, b, SETTING))(variables, jb))
    method = port_method(backbone, variables).eval()
    _, dense = batches(backbone, 2, seed=5)
    with torch.no_grad():
        ours = method(pb, SETTING).numpy()
        unpadded = method(dense, SETTING).numpy()
        first = method(dense.replace(**{f: getattr(dense, f)[:1] for f in (
            "support", "query", "query_clip", "query_mask", "support_target", "query_target",
            "global_target")}), SETTING).numpy()
    assert ours.shape == ref.shape == (2, WAY * QUERY + 2, WAY)
    assert _rel(ours, ref) <= LOGIT_TOL
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours[:, :WAY * QUERY], unpadded, rtol=0, atol=LOGIT_TOL * scale)
    np.testing.assert_allclose(first[0], unpadded[0], rtol=0, atol=BATCH_TOL * scale)
    # the classes differ by more than ten times the tolerance
    assert np.ptp(ref[:, :WAY * QUERY], axis=-1).max() > 10 * LOGIT_TOL * scale


def jax_step_reference(backbone, variables, batch, drop_rate=0.0):
    """One JAX train step (``loss`` and its gradient) with a float64 backbone
    and a float64 head: (loss, logits, gradients, running statistics and
    DropBlock counters) under the port's names."""
    with jax.enable_x64(True):
        jax_method = jax_build_method(renet_config(backbone, dtype="float64",
                                                   drop_rate=drop_rate))
        embed = jax_method.embed

        def embed_wide(*args, **kwargs):
            sup, qry, updates = embed(*args, **kwargs)
            return sup.astype(np.float64), qry.astype(np.float64), updates

        jax_method.embed = embed_wide
        wide = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype,
                                                                 np.floating) else a, variables)
        non_params = {k: v for k, v in wide.items() if k != "params"}

        def loss_fn(params):
            return jax_method.loss({**non_params, "params": params}, batch, SETTING,
                                   jax.random.PRNGKey(1))

        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(wide["params"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
        stats = jax_method.merge_updates(
            {"batch_stats": variables["batch_stats"]}, out.updates)["batch_stats"]
        stats = jax.tree_util.tree_map(np.asarray, stats)
    return (float(loss), np.asarray(out.seg_logits), as_port(variables, backbone, params=grads),
            as_port(variables, backbone, stats=stats))


@pytest.mark.parametrize("backbone", ["Conv64F", "resnet12"])
def test_train_step_matches_jax_float64(backbone):
    """λ_epi · the episodic CE + the global CE of ``fc`` over the pooled
    centred queries: loss, logits, every gradient (backbone, SCR, CCA,
    ``fc``) and every running statistic after one step, against the JAX
    package's float64 step; DropBlock at rate 0 (the packages cannot draw
    the same blocks)."""
    variables = _without_counters(jax_variables(backbone)) if backbone == "resnet12" \
        else jax_variables(backbone)
    jb, pb = batches(backbone, 1, seed=2)
    ref = jax_step_reference(backbone, variables, jb)
    for dtype, tols in ((torch.float64, STEP_TOLS), (torch.float32, F32_STEP_TOLS)):
        method = port_method(backbone, variables, dtype, drop_rate=0.0).train()
        loss, out = method.loss(pb, SETTING)
        loss.backward()
        named = dict(method.named_parameters())
        assert len([k for k in named if not k.startswith("emb_func.")]) == 35
        _check_step(named, _running(method), loss, out, ref, tols)


def test_training_needs_global_targets_laid_out_as_the_queries():
    method = port_method("Conv64F", jax_variables("Conv64F")).train()
    _, pb = batches("Conv64F", 1)
    with pytest.raises(ValueError, match="requires global targets"):
        method.loss(pb.replace(global_target=None), SETTING)
    _, padded = batches("Conv64F", 1, pad=2)
    with pytest.raises(ValueError, match="layout mismatch"):
        method.loss(padded, SETTING)


def test_head_weights_cross_under_the_reference_names():
    """``utils/convert.py``'s RENet entries are ``tools/cross_framework_parity.py``'s
    ``invert_renet_head_params``', key for key and value for value (the
    reference's Conv3d kernel shapes), and load into the port's method
    strictly."""
    variables = jax_variables("resnet12")
    ours = head_state_dict_from_jax(variables, "RENet")
    ref = invert_renet_head_params(variables)
    assert set(ours) == set(ref) and len(ref) == 57
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key], val, err_msg=key)
    method = build_method(renet_config("resnet12"))
    head_keys = {k for k in method.state_dict()
                 if not k.startswith("emb_func.") and not k.endswith("num_batches_tracked")}
    assert head_keys == set(ref)
    assert method.state_dict()["scr_layer.model.1.conv1.0.weight"].shape == (64, 64, 1, 3, 3)
    assert method.state_dict()["cca_layer.cca_module.conv.0.conv2.0.weight"].shape == \
        (1, 1, 3, 3, 1)
    method.load_state_dict(state_dict_from_jax(variables, "resnet12", prefix="emb_func.",
                                               classifier="RENet"))


# -- the shipped configs and the chip cells -------------------------------------------------

def _small(cfg, root):
    """A shipped RENet config at a CPU-sized geometry: a narrow resnet12
    ([20, 2, 2] maps of ``[1, 32, 40]`` segments), a synthetic root of 6
    classes × 24 clips (a 10-shot 10-query episode needs 20), 2 train and 2 test episodes, one epoch."""
    cfg.update(spec_shape=[1, 32, 40], data_root="synthetic:6:24", epoch=1, train_episode=2,
               test_episode=2, test_episode_size=2, max_segments_per_clip=2,
               precision="fp32", result_root=str(root), prefetch=0)
    cfg["backbone"]["kwargs"]["planes"] = [8, 12, 16, 20]
    return cfg


def test_every_shipped_renet_config_builds_and_trains(tmp_path, no_tensorboard):
    """Every shipped RENet config (all shots, seeds, iid and ood; the
    ``kos_fixture`` one needs generated data) builds its method on the
    [640, 8, 9] map of ``[1, 128, 157]`` and an episodic train loader; its
    ``renet_5shot_iid_seed0.yaml`` trains one epoch through ``run_trainer``
    on the CPU at a small geometry."""
    paths = sorted(p for p in glob.glob(os.path.join(REPO, "config", "**", "*.yaml"),
                                        recursive=True)
                   if "kos_fixture" not in p and "name: RENet\n" in open(p).read())
    assert len(paths) == 18
    for path in paths:
        cfg = Config(path).get_config_dict()
        full = build_method(dict(cfg, spec_shape=[1, 128, 157]))
        assert full.scr_layer.model[1].conv1x1_in[0].in_channels == 640
        assert full.fc.in_features == 640 and full.fc.out_features == 25
        cfg = _small(cfg, tmp_path)
        method = build_method(cfg)
        assert method.model_type == ModelType.METRIC
        loaders = get_dataloader(cfg, "train", method.model_type)
        assert len(loaders) == 1 and isinstance(loaders[0], EpisodicLoader)
    leaf = os.path.join(REPO, "config", "renet", "renet_5shot_iid_seed0.yaml")
    over = _small({"backbone": {"kwargs": {}}}, tmp_path)
    argv = ["--yaml_path", leaf, "--device", "cpu", "--backbone.kwargs.planes", "[8, 12, 16, 20]"]
    for key in ("spec_shape", "data_root", "epoch", "train_episode", "test_episode",
                "test_episode_size", "max_segments_per_clip", "precision", "result_root",
                "prefetch"):
        argv += [f"--{key}", str(over[key])]
    trainer = run_trainer.main(argv)
    record = trainer.history[0]
    assert len(record["train_losses"]) == 2
    assert all(np.isfinite(record["train_losses"])) and np.isfinite(record["test_acc"])


@pytest.mark.parametrize("kind", ["eval", "train", "dual"])
def test_chip_cells_are_the_shipped_config_cut_to_size(kind, tmp_path):
    """The RENet cells ``chip_smoke.py`` runs: ``renet_5shot_iid_seed0.yaml``
    with its headers but for the cuts they name; the dual cell adds the
    fixture's ``dataloader_num: 2, batch_size: 12`` (NOT shipped traffic)
    and gets an episodic and a flat train loader."""
    shipped = Config(os.path.join(REPO, "config", "renet",
                                  "renet_5shot_iid_seed0.yaml")).get_config_dict()
    if kind == "eval":
        cell = eval_cell(classifier="RENet", test_episode=64, test_epoch=1)
        cuts = {"test_episode": (600, 64), "test_epoch": (5, 1), "test_episode_size": (None, 16),
                "max_segments_per_clip": (8, 6), "spec_shape": (None, [1, 128, 157])}
        kept = ("classifier", "backbone", "modality", "test_way", "test_shot", "test_query",
                "augment_times", "seed", "ood", "tag")
    else:
        cell = train_cell(str(tmp_path), classifier="RENet" if kind == "train" else "RENet:dual",
                          epoch=1, train_episode=20, test_episode=16)
        cuts = {"epoch": (30, 1), "train_episode": (1000, 20), "test_episode": (600, 16),
                "result_root": ("./results", str(tmp_path)), "tb_scale": (1000 / 600, 20 / 16),
                "spec_shape": (None, [1, 128, 157])}
        if kind == "dual":
            cuts.update(dataloader_num=(1, 2), batch_size=(128, 12),
                        tag=("renet_5shot_iid_seed0", "renet_5shot_dual_not_shipped"))
        kept = [k for k in shipped if k not in cuts and k != "includes"]
    for key, (full, cut) in cuts.items():
        assert (shipped.get(key), cell.get(key)) == (full, cut), key
    for key in kept:
        assert cell.get(key) == shipped[key], key
    model = build_method(cell)
    assert isinstance(model, renet.RENet)
    assert model.fc.in_features == 640
    loaders = get_dataloader(cell, "train", model.model_type)
    assert len(loaders) == (2 if kind == "dual" else 1)

"""IFSL's three-stage cycle in the PyTorch port against the JAX package on
the CPU, at the size of ``tests/test_ifsl_pipeline.py`` (``synthetic:8:10``,
``[1, 32, 24]`` segments, Conv64F's [64, 2, 3] map: 384 flat
features, 8 classes), and DeepBDC on resnet18Bdc through ``Test``.

Stage 1's weights are the JAX package's IfslPretrain tree drawn with numpy
(random BN statistics), saved as each package's ``emb_func`` and
``classifier`` part files (the port's carried across by
``utils.convert.state_dict_from_jax``).  Stage 2 is each package's
``Trainer`` with ``featuring: true`` loading them (``pretrain_path``,
``cls_classifier_path``); stage 3 each package's ``Trainer`` building
DMatchingNet on the stage-1 ``emb_func`` with both artifacts
(``feature_path``, ``cls_path``).  IfslPretrain's flat train step is held
by ``test_torch_port_finetuning.check_flat_step``.

Tolerances: the featuring means and ``compute_class_features``: 1e-5 of
their max abs (``FEATURE_TOL``); DMatchingNet's log-probabilities and
DeepBDC's logits: 1e-5 of their scale (``LOGIT_TOL``); the loaded weights
and artifacts: exact.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.episode import FlatBatch as JaxFlatBatch  # noqa: E402
from audio_fewshot_tpu.episode import make_dense_episode_batch as jax_dense_batch  # noqa: E402
from audio_fewshot_tpu.eval import Test as JaxTest  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting as JaxSetting  # noqa: E402
from audio_fewshot_tpu.train import Trainer as JaxTrainer  # noqa: E402
from audio_fewshot_tpu.utils.checkpoint import SaveType as JaxSaveType  # noqa: E402
from audio_fewshot_tpu.utils.checkpoint import save_model as jax_save_model  # noqa: E402
from audio_fewshot_tpu.utils.checkpoint import save_variables  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.episode import make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.eval import Test  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method, eval_setting  # noqa: E402
from audio_fewshot_tpu_torch.models.base import EpisodeSetting  # noqa: E402
from audio_fewshot_tpu_torch.train import Trainer  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import SaveType, save_model, save_model_best  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

import test_torch_port_finetuning as ft  # noqa: E402
from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_flat import no_tensorboard  # noqa: E402,F401
from test_torch_port_flat import no_tensorboard_writers  # noqa: E402
from test_torch_port_meta2 import draw_tree  # noqa: E402
from test_torch_port_metric import _rel  # noqa: E402

FEATURE_TOL = 1e-5
LOGIT_TOL = 1e-5
NUM_CLASS = 8  # synthetic:8:* -> the train split's 8 classes
WAY, SHOT, QUERY = 3, 2, 3
SPEC = (1, 32, 24)
PARTS = ("emb_func", "classifier")


def _cfg(root, classifier, **extra):
    """``tests/test_ifsl_pipeline.py``'s configuration."""
    cfg = {
        "data_root": "synthetic:8:10", "spec_shape": list(SPEC), "modality": "audio",
        "mean_std_file": None,
        "backbone": {"name": "Conv64F", "kwargs": {"is_flatten": False, "last_pool": False,
                                                   "maxpool_last2": False, "num_channels": 1}},
        "classifier": classifier,
        "optimizer": {"name": "Adam", "kwargs": {"lr": 3e-3}, "other": None},
        "lr_scheduler": {"name": "StepLR", "kwargs": {"gamma": 1.0, "step_size": 10}},
        "way_num": WAY, "shot_num": SHOT, "query_num": QUERY,
        "test_way": WAY, "test_shot": SHOT, "test_query": QUERY,
        "episode_size": 1, "train_episode": 6, "test_episode": 4, "batch_size": 16,
        "epoch": 1, "test_epoch": 1, "val_per_epoch": 1, "save_interval": 100,
        "save_part": list(PARTS), "log_interval": 1000, "seed": 0, "precision": "fp32",
        "result_root": str(root), "prefetch": 0, "warmup": 0, "augment_times": 1,
        "max_segments_per_clip": 1,
    }
    cfg.update(extra)
    return cfg


def _pretrain(featuring, feature_path=None, cls_classifier_path=None, norm=False):
    return {"name": "IfslPretrain", "kwargs": {
        "num_class": NUM_CLASS,
        "inner_param": {"inner_train_iter": 3, "inner_batch_size": 4,
                        "inner_optim": {"lr": 1e-2}},
        "cls_classifier_path": cls_classifier_path,
        "ifsl_pretrain_param": {"norm": norm, "featuring": featuring,
                                "feature_path": feature_path}}}


def _dmatching(feature_path, cls_path):
    """``config/synthetic/ifsl_dmatching_smoke.yaml``'s head."""
    return {"name": "DMatchingNet", "kwargs": {"inner_param": {}, "ifsl_param": {
        "n_splits": 4, "class_num": NUM_CLASS, "temp": 10.0, "d_feature": "ed",
        "fusion": "concat", "logit_fusion": "product", "single": True,
        "use_counterfactual": True, "feature_path": feature_path, "cls_path": cls_path}}}


def _port_state(variables, classifier):
    return state_dict_from_jax(variables, "Conv64F", prefix="emb_func.", classifier=classifier)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """IfslPretrain's weights (the JAX tree drawn with numpy) and each
    package's ``{part}_last.pth`` files: ``{"jax": {part: path}, "port":
    {part: path}}``."""
    root = tmp_path_factory.mktemp("ifsl_stage1")
    method = jax_build_method(_cfg(root, _pretrain(False)))
    example = JaxFlatBatch(data=jnp.zeros((2,) + SPEC), target=jnp.zeros((2,), jnp.int32))
    shapes = jax.eval_shape(lambda k: method.init_variables(k, example, JaxSetting(WAY, SHOT, QUERY)),
                            jax.random.PRNGKey(0))
    variables = randomize_batchnorm(
        jax.tree_util.tree_map(np.asarray, draw_tree(shapes, np.random.default_rng(0))),
        np.random.default_rng(1))
    jax_save_model(str(root / "jax"), variables, 0, JaxSaveType.LAST,
                   train_state={"best_val_acc": -1.0, "best_test_acc": -1.0}, save_part=list(PARTS))
    port = build_method(_cfg(root, _pretrain(False)))
    port.load_state_dict(_port_state(variables, "IfslPretrain"))
    save_model(str(root / "port"), port, 0, SaveType.LAST, save_part=PARTS)
    paths = {pkg: {p: str(root / pkg / f"{p}_last.pth") for p in PARTS} for pkg in ("jax", "port")}
    return variables, paths


@pytest.fixture(scope="module")
def stage2(stage1, tmp_path_factory):
    """Each package's featuring run over the stage-1 parts: the trainers and
    the ``.npy`` paths."""
    _, paths = stage1
    root = tmp_path_factory.mktemp("ifsl_stage2")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        no_tensorboard_writers(mp)
        for pkg, make in (("jax", JaxTrainer), ("port", Trainer)):
            feature_path = str(root / f"{pkg}_features.npy")
            cfg = _cfg(root / pkg, _pretrain(True, feature_path, paths[pkg]["classifier"]),
                       epoch=5, pretrain_path=paths[pkg]["emb_func"])
            trainer = make(0, cfg) if pkg == "jax" else make(0, cfg, device="cpu")
            trainer.train_loop(0)
            out[pkg] = (trainer, feature_path)
    return out


def test_featuring_writes_the_jax_class_means(stage1, stage2):
    """The port's featuring ``.npy`` is the JAX package's, float32 [8, 384],
    every class covered; it loaded the stage-1 classifier
    (``cls_classifier_path``) and backbone (``pretrain_path``) and left them
    unchanged, and wrote a LAST checkpoint with both parts."""
    variables, _ = stage1
    (_, jax_path), (trainer, port_path) = stage2["jax"], stage2["port"]
    ours, ref = np.load(port_path), np.load(jax_path)
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (NUM_CLASS, 384)
    assert _rel(ours, ref) <= FEATURE_TOL
    assert np.all(np.linalg.norm(ours, axis=1) > 0)
    expected = _port_state(variables, "IfslPretrain")
    for key, val in trainer.method.state_dict().items():
        torch.testing.assert_close(val, expected[key], rtol=0, atol=0, msg=key)
    for part in PARTS:
        assert os.path.isfile(os.path.join(trainer.ckpt_dir, f"{part}_last.pth"))


@pytest.mark.parametrize("normalize", [False, True])
def test_compute_class_features_matches_jax(stage1, normalize):
    """``compute_class_features`` over a labelled set with one class unseen
    (its row stays zero), with and without the L2 normalisation."""
    variables, _ = stage1
    rng = np.random.default_rng(4)
    data = rng.normal(size=(12,) + SPEC).astype(np.float32)
    targets = rng.integers(0, NUM_CLASS - 1, size=12).astype(np.int32)
    jm = jax_build_method(_cfg("unused", _pretrain(False)))
    ref = np.asarray(jm.compute_class_features(variables, jnp.asarray(data), jnp.asarray(targets),
                                               normalize=normalize))
    method = build_method(_cfg("unused", _pretrain(False)))
    method.load_state_dict(_port_state(variables, "IfslPretrain"))
    with torch.no_grad():
        ours = method.eval().compute_class_features(torch.from_numpy(data),
                                                    torch.from_numpy(targets), normalize).numpy()
    assert _rel(ours, ref) <= FEATURE_TOL
    assert not np.any(ours[NUM_CLASS - 1])


def test_featuring_requires_a_feature_path(tmp_path, no_tensorboard):
    """``featuring: true`` without ``feature_path`` fails when the loop
    starts, naming the knob (the JAX package's ``run_featuring`` asserts
    it, ``tests/test_ifsl_pipeline.py``)."""
    trainer = Trainer(0, _cfg(tmp_path, _pretrain(True)), device="cpu")
    with pytest.raises(ValueError, match="feature_path"):
        trainer.train_loop(0)


def test_dmatchingnet_reads_both_artifacts(stage1, stage2, tmp_path, no_tensorboard):
    """Stage 3: DMatchingNet's ``utils.linear`` is the stage-1 classifier
    (``cls_path``), its class-mean features the featuring ``.npy``
    (``feature_path``), its backbone the stage-1 ``emb_func``
    (``pretrain_path``, its BN running statistics left out); with the JAX
    package's LSTM blocks carried across, its eval log-probabilities are
    the JAX package's over the same episodes."""
    variables, paths = stage1
    trainers = {}
    for pkg in ("jax", "port"):
        cfg = _cfg(tmp_path / pkg, _dmatching(stage2[pkg][1], paths[pkg]["classifier"]),
                   pretrain_path=paths[pkg]["emb_func"])
        trainers[pkg] = JaxTrainer(0, cfg) if pkg == "jax" else Trainer(0, cfg, device="cpu")
    jt, pt = trainers["jax"], trainers["port"]
    method = pt.method
    stage1_state = _port_state(variables, "IfslPretrain")
    for key in ("weight", "bias"):
        torch.testing.assert_close(method.utils.linear.state_dict()[key],
                                   stage1_state[f"classifier.{key}"], rtol=0, atol=0)
    np.testing.assert_array_equal(method.utils.features.numpy(), np.load(stage2["port"][1]))
    for key, val in method.emb_func.state_dict().items():
        torch.testing.assert_close(val, stage1_state[f"emb_func.{key}"], rtol=0, atol=0)
    blocks = {k: v for k, v in _port_state(jt.variables, "DMatchingNet").items()
              if k.startswith("blocks.")}
    assert blocks
    method.load_state_dict(blocks, strict=False)

    rng = np.random.default_rng(6)
    sup = rng.normal(size=(2, WAY * SHOT) + SPEC).astype(np.float32)
    qry = rng.normal(size=(2, WAY * QUERY) + SPEC).astype(np.float32)
    jb = jax_dense_batch(sup, qry, WAY, SHOT, QUERY)
    pb = make_dense_episode_batch(sup, qry, WAY, SHOT, QUERY).to("cpu")
    ref = np.asarray(jax.jit(lambda v, b: jt.method.forward(v, b, JaxSetting(WAY, SHOT, QUERY)))(
        jt.variables, jb))
    with torch.no_grad():
        ours = method.eval()(pb, EpisodeSetting(WAY, SHOT, QUERY)).numpy()
    assert ours.shape == ref.shape
    assert _rel(ours, ref) <= LOGIT_TOL


def test_ifsl_pretrain_flat_train_step_matches_jax():
    """IfslPretrain's flat train step (global CE through ``classifier`` on
    Conv64F's 1600 flat features): loss, logits and every gradient against
    the JAX package's float64 step, at ``test_torch_port_finetuning``'s
    tolerances."""
    ft.ALL_CASES.setdefault("IfslPretrain", ("IfslPretrain", "Conv64F", {}))
    ft.check_flat_step("IfslPretrain")


def _bdc_config(**over):
    cfg = {
        "classifier": {"name": "DeepBDC", "kwargs": None},
        "backbone": {"name": "resnet18Bdc",
                     "kwargs": {"num_channels": 1, "reduce_dim": 8, "fused_bdc": False}},
        "data_root": "synthetic:10:12", "spec_shape": [1, 32, 40],
        "way_num": 5, "shot_num": 5, "query_num": 3,
        "test_episode": 4, "test_episode_size": 2, "test_epoch": 1,
        "max_segments_per_clip": 3, "segment_bucket_sizes": [48],
        "precision": "fp32", "seed": 0, "prefetch": 0,
    }
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


def test_deepbdc_on_resnet18bdc_through_test_matches_jax(tmp_path):
    """DeepBDC on resnet18Bdc (a [512, 2, 3] map into the plain BDC pool at
    ``reduce_dim`` 8) through each package's ``Test`` at the same weights:
    the segment logits of the test loader's first batch (by the method
    ``Test`` built), the accuracy and the calibration threshold."""
    cfg = _bdc_config()
    jax_method = jax_build_method(cfg)
    setting = eval_setting(cfg)
    example = next(iter(jax_get_dataloader(cfg, "test")[0].epoch(0)))
    shapes = jax.eval_shape(lambda k: jax_method.init_variables(k, example, setting),
                            jax.random.PRNGKey(0))
    variables = randomize_batchnorm(
        jax.tree_util.tree_map(np.asarray, draw_tree(shapes, np.random.default_rng(0))),
        np.random.default_rng(1))
    variables["params"]["emb_func"]["bdc_pool"]["log_temperature"] = np.full(
        (1, 1), np.log(1.0 / 12.0), np.float32)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(os.path.join(jax_dir, "checkpoints"))
    save_variables(os.path.join(jax_dir, "checkpoints", "model_best.pth"), variables)
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(variables, "resnet18Bdc", prefix="emb_func."))
    save_model_best(port_dir, method)

    ref_test, test = JaxTest(0, cfg, jax_dir), Test(0, cfg, port_dir, device="cpu")
    jb = example
    pb = next(iter(get_dataloader(cfg, "test")[0].epoch(0))).to("cpu")
    ref = np.asarray(jax.jit(lambda v, b: jax_method.forward(v, b, setting))(variables, jb))
    with torch.no_grad():
        ours = test.method(pb, setting).numpy()
    assert ours.shape == ref.shape
    assert _rel(ours, ref) <= LOGIT_TOL
    ref_acc = ref_test.test_loop()
    acc = test.test_loop()
    assert acc == pytest.approx(ref_acc, rel=1e-5)
    assert test.method.uncertain_global_threshold == pytest.approx(
        ref_test.method.uncertain_global_threshold, rel=1e-4)

"""The pretrainers of the PyTorch port (MetabaselinePretrain, FEAT_Pretrain,
DeepBDC_Pretrain) against the JAX package on the CPU, the ``save_part`` →
``pretrain_path`` flow into the methods they pretrain for, the chip cells of
the eight heads of the finetuning slice, and every shipped config of those
heads through the port's loaders and ``run_trainer``.

Geometry and weights as ``test_torch_port_finetuning.py`` (whose helpers
this file uses): MetabaselinePretrain and FEAT_Pretrain on the narrow
resnet12 (120 features), DeepBDC_Pretrain on resnet12Bdc at ``reduce_dim``
8 on ``[1, 16, 20]`` segments (a 2 × 2 stage-4 map, 36 BDC features, the
JAX package's plain BDC path), flat batches of 8.

Tolerances:
- the metric validation heads over shared float32 features against the
  JAX heads: 1e-5 of the logits' scale (``EVAL_TOL``; both in float32);
  DeepBDC_Pretrain's ``stl`` probe: centred logits within 2e-3
  (``finetuning.PROBE_ATOL``);
- one flat train step: ``finetuning.STEP_TOLS`` and ``F32_STEP_TOLS`` of
  the backbone (resnet12Bdc's gradients 5e-4 of their max abs with either
  blocks, measured 1.6e-4 and 1.8e-4; MetabaselinePretrain's float32
  resnet12 2e-2, measured 4.4e-3);
- the checkpoint round trip: the loaded backbone equals the saved one
  exactly.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402

from audio_fewshot_tpu.episode import make_dense_episode_batch as jax_dense_batch  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting as JaxSetting  # noqa: E402
from audio_fewshot_tpu_torch import run_trainer  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import FlatLoader, get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.episode import make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.eval import SLICE_MODELS, slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.base import EpisodeSetting, ModelType  # noqa: E402
from audio_fewshot_tpu_torch.train import Trainer, slice_config as train_cell  # noqa: E402

import test_torch_port_finetuning as ft  # noqa: E402
from test_torch_port_flat import no_tensorboard  # noqa: E402,F401
from test_torch_port_metric import _rel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_TOL = 1e-5


# -- validation heads -------------------------------------------------------------------------

@pytest.mark.parametrize("case, shot", [
    ("MetabaselinePretrain", 5), ("FEAT_Pretrain", 5), ("DeepBDC_Pretrain", 5),
    ("DeepBDC_Pretrain", 1), ("DeepBDC_Pretrain:stl", 5)])
def test_validation_logits_match_jax(case, shot):
    """Each pretrainer's eval logits over the same episode features: cosine
    prototypes, euclidean prototypes, DeepBDC's shot-switched prototypes
    (euclidean at 5 shots, the raw dot product at 1) and, with ``val_type:
    stl``, the probe at ``penalty_C`` 0.1 on normalised features."""
    _, backbone, _ = ft.ALL_CASES[case]
    e, query = 2, 3
    rng = np.random.default_rng(11)
    d = ft.FEAT_DIM[backbone]
    sup = (np.maximum(rng.normal(size=(e, 5 * shot, d)), 0) + 0.5 * np.repeat(
        rng.normal(size=(e, 5, d)), shot, axis=1)).astype(np.float32)
    qry = np.maximum(rng.normal(size=(e, 5 * query, d)), 0).astype(np.float32)
    placeholder = np.zeros((e, 5 * shot, 1, 1, 1), np.float32)
    q_placeholder = np.zeros((e, 5 * query, 1, 1, 1), np.float32)
    jb = jax_dense_batch(placeholder, q_placeholder, 5, shot, query)
    pb = make_dense_episode_batch(placeholder, q_placeholder, 5, shot, query).to("cpu")
    jm = jax_build_method(ft.config(case))
    jm.embed = lambda *a, **k: (sup, qry, {})
    ref = np.asarray(jm.forward({}, jb, JaxSetting(5, shot, query)))
    ours = build_method(ft.config(case)).eval()
    ours.embed = lambda batch: (torch.from_numpy(sup), torch.from_numpy(qry))
    with torch.no_grad():
        got = ours(pb, EpisodeSetting(5, shot, query)).numpy()
    assert got.shape == ref.shape == (e, 5 * query, 5)
    if case.endswith("stl"):
        centred = lambda x: x - x.mean(-1, keepdims=True)  # noqa: E731
        np.testing.assert_allclose(centred(got), centred(ref), atol=ft.PROBE_ATOL, rtol=0)
    else:
        assert _rel(got, ref) <= EVAL_TOL


def test_val_type_must_be_meta_or_stl():
    with pytest.raises(ValueError, match="val_type"):
        build_method(ft.config("DeepBDC_Pretrain", val_type="proto"))


# -- training -----------------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["MetabaselinePretrain", "DeepBDC_Pretrain",
                                  "DeepBDC_Pretrain:distill"])
def test_flat_train_step_matches_jax(case):
    """One flat train step of the global linear head: MetabaselinePretrain
    on resnet12, DeepBDC_Pretrain through resnet12Bdc's BDC pool (the plain
    path on the CPU; the kernels run it on the card) with and without a
    hand-set distillation teacher."""
    ft.check_flat_step(case)


def test_global_head_reads_the_bdc_features():
    method = build_method(ft.config("DeepBDC_Pretrain"))
    assert method.classifier.in_features == 8 * 9 // 2 == ft.FEAT_DIM["resnet12Bdc"]
    full = build_method(eval_cell(classifier="DeepBDC_Pretrain"))
    assert full.classifier.in_features == 64 * 65 // 2 == 2080


# -- save_part → pretrain_path ----------------------------------------------------------------

def _pretrain_config(root, name, **over):
    backbone = ({"name": "resnet12Bdc", "kwargs": {"num_channels": 1, "reduce_dim": 8}}
                if "BDC" in name.upper() else
                {"name": "Conv64F", "kwargs": {"is_flatten": True, "num_channels": 1}})
    spec = [1, 16, 20] if backbone["name"] == "resnet12Bdc" else [1, 81, 90]
    cfg = {"classifier": {"name": name, "kwargs": {"num_class": 10} if "Pretrain" in name
                          else None},
           "backbone": backbone, "data_root": "synthetic:5:8", "spec_shape": spec,
           "batch_size": 20, "way_num": 5, "shot_num": 2, "query_num": 2, "epoch": 1,
           "train_episode": 2, "test_episode": 4, "test_episode_size": 2,
           "max_segments_per_clip": 3, "segment_bucket_sizes": [48], "precision": "fp32",
           "seed": 0, "prefetch": 0, "result_root": str(root), "save_part": ["emb_func"]}
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


@pytest.mark.parametrize("stage1, stage2", [("DeepBDC_Pretrain", "DeepBDC"),
                                            ("MetabaselinePretrain", "MetaBaseline")])
def test_emb_func_checkpoint_feeds_the_next_stage(tmp_path, stage1, stage2, no_tensorboard):
    """Stage 1 trains on flat batches and writes ``emb_func_best.pth``;
    stage 2 loads it through ``pretrain_path`` (the backbone equal to the
    saved one, its own head untouched) and trains and evaluates on
    episodes."""
    first = Trainer(0, _pretrain_config(tmp_path / "one", stage1), device="cpu")
    first.train_loop()
    assert len(first.history[0]["train_losses"]) == 2  # 40 clips in batches of 20
    part = os.path.join(first.ckpt_dir, "emb_func_best.pth")
    saved = torch.load(part, weights_only=True)
    assert saved and all(k.startswith("emb_func.") for k in saved)
    second = Trainer(0, _pretrain_config(tmp_path / "two", stage2, pretrain_path=part),
                     device="cpu")
    state = second.method.state_dict()
    assert {k for k in state if k.startswith("emb_func.")} == set(saved)
    for key, val in saved.items():
        torch.testing.assert_close(state[key], val, rtol=0, atol=0)
    second.train_loop()
    assert np.isfinite(second.history[0]["test_acc"])


# -- the chip cells -------------------------------------------------------------------------------

SHIPPED = {"Baseline": "baseline", "BaselinePlus": "baseline_plus", "NegNet": "negnet",
           "RFSModel": "rfs", "SKDModel": "skd", "MetabaselinePretrain": "metabaseline_pretrain",
           "DeepBDC_Pretrain": "deepbdc_pretrain"}
FEATURES = {"Conv64F": 1600, "resnet12": 12800, "resnet12Bdc": 2080}


@pytest.mark.parametrize("kind", ["eval", "train"])
@pytest.mark.parametrize("name", list(SHIPPED) + ["FEAT_Pretrain"])
def test_chip_cells_are_the_shipped_configs_cut_to_size(name, kind, tmp_path):
    """The cells ``chip_smoke.py`` runs are each head's shipped
    ``*_5shot_iid_seed0.yaml`` with its headers but for the cuts they name
    (FEAT_Pretrain, which ships none: MetabaselinePretrain's with its own
    name); each builds at full width with its global head over the
    backbone's flat features."""
    source = SHIPPED.get(name, "metabaseline_pretrain")
    shipped = Config(os.path.join(REPO, "config", source,
                                  f"{source}_5shot_iid_seed0.yaml")).get_config_dict()
    if name == "FEAT_Pretrain":
        shipped["classifier"]["name"] = name
        shipped["tag"] = "feat_pretrain_no_shipped_config"
    if kind == "eval":
        cell = eval_cell(classifier=name, test_episode=32, test_epoch=1)
        cuts = {"test_episode": (600, 32), "test_epoch": (5, 1), "test_episode_size": (None, 16),
                "max_segments_per_clip": (8, 6), "spec_shape": (None, [1, 128, 157])}
        kept = ("classifier", "backbone", "modality", "test_way", "test_shot", "test_query",
                "augment_times", "seed", "ood", "tag", "batch_size")
    else:
        cell = train_cell(str(tmp_path), classifier=name, epoch=1, test_episode=16)
        # train_episode is cut as in every training cell; a flat epoch does
        # not read it (len(FlatSampler) steps)
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
    assert model.classifier.in_features == FEATURES[cell["backbone"]["name"]]
    assert model.classifier.out_features == 25


# -- every shipped config -----------------------------------------------------------------------

def _small(cfg, root):
    """A shipped config at a CPU-sized geometry: small segments (a 2 × 2
    stage-4 map for resnet12Bdc), narrow resnet12, a synthetic root of 6
    classes × 16 clips (5 val classes for 5-shot 10-query episodes), flat
    batches of 16, one epoch."""
    name = cfg["backbone"]["name"]
    cfg.update(spec_shape={"Conv64F": [1, 81, 90], "resnet12": [1, 32, 40]}.get(name, [1, 16, 20]),
               data_root="synthetic:6:16", batch_size=16, epoch=1, test_episode=2,
               test_episode_size=2, max_segments_per_clip=2, precision="fp32",
               result_root=str(root), prefetch=0)
    if name == "resnet12":
        cfg["backbone"]["kwargs"]["planes"] = [8, 12, 16, 20]
    return cfg


@pytest.mark.parametrize("name", list(SHIPPED))
def test_every_shipped_config_builds_loads_flat_and_trains(name, tmp_path, no_tensorboard):
    """Every shipped config naming the head (all shots, seeds, iid and
    ood; the fixture configs under ``config/kos_fixture`` need generated
    data and are left out) builds its method and a flat train loader; its
    ``*_5shot_iid_seed0.yaml`` trains one epoch through ``run_trainer`` on
    the CPU at a small geometry."""
    paths = sorted(p for p in glob.glob(os.path.join(REPO, "config", "**", "*.yaml"),
                                        recursive=True)
                   if "kos_fixture" not in p and f"name: {name}\n" in open(p).read())
    assert len(paths) == 18
    for path in paths:
        cfg = _small(Config(path).get_config_dict(), tmp_path)
        assert cfg["classifier"]["name"] == name
        method = build_method(cfg)
        assert method.model_type == ModelType.FINETUNING
        loader = get_dataloader(cfg, "train", method.model_type)[0]
        assert isinstance(loader, FlatLoader) and loader.sampler.batch_size == 16
    source = SHIPPED[name]
    leaf = os.path.join(REPO, "config", source, f"{source}_5shot_iid_seed0.yaml")
    overrides = _small({"backbone": {"name": SLICE_MODELS[name]["backbone"]["name"],
                                     "kwargs": {}}}, tmp_path)
    argv = ["--yaml_path", leaf, "--device", "cpu"]
    for key in ("spec_shape", "data_root", "batch_size", "epoch", "test_episode",
                "test_episode_size", "max_segments_per_clip", "precision", "result_root",
                "prefetch"):
        argv += [f"--{key}", str(overrides[key])]
    if "planes" in overrides["backbone"]["kwargs"]:
        argv += ["--backbone.kwargs.planes", "[8, 12, 16, 20]"]
    trainer = run_trainer.main(argv)
    record = trainer.history[0]
    assert len(record["train_losses"]) == 96 // 16
    assert all(np.isfinite(record["train_losses"])) and np.isfinite(record["test_acc"])

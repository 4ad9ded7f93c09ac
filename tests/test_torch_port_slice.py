"""The DeepBDC/resnet12Bdc eval slice of the PyTorch port against the JAX
package: segment logits, clip uncertainties, episode accuracies, OOD flags,
the energy calibration pass (both policies) and the whole ``Test.test_loop``
on a small synthetic loader (spec [1, 32, 40], reduce_dim 8, 5-way 5-shot,
ragged queries of up to 3 segments), at the same weights, in float32.  The
JAX side runs the XLA ``bdc_pool`` (``fused_bdc: false``); the Pallas
kernel's parity is ``test_torch_port_bdc.py``'s job.  Also: the port and
``chip_smoke.py`` import nothing of JAX, and the entry points never drift
to the CPU or skip TTA silently."""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402

from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.eval import Test as JaxTest  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.heads.deepbdc import bdc_proto_logits as jax_bdc_proto_logits  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting  # noqa: E402
from audio_fewshot_tpu.parallel import get_mesh  # noqa: E402
from audio_fewshot_tpu.utils.checkpoint import save_variables  # noqa: E402
from audio_fewshot_tpu_torch import run_test  # noqa: E402
from audio_fewshot_tpu_torch.config import Config, save_config  # noqa: E402
from audio_fewshot_tpu_torch.data import get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.eval import Test  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method, eval_setting  # noqa: E402
from audio_fewshot_tpu_torch.models.heads.deepbdc import bdc_proto_logits  # noqa: E402
from audio_fewshot_tpu_torch.utils import resolve_device  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import load_model, save_model_best  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 in both packages; logits are -|q-p|^2 over 36-d BDC vectors, whose
# 2qp - |q|^2 - |p|^2 form cancels, so the tolerance scales with the logits
RTOL = 1e-4
# episode accuracies are float32 means of the same votes: XLA and torch
# round k/n · 100 to neighbouring float32 values
ACC_RTOL = 1e-6


def slice_config(**over):
    cfg = {
        "classifier": {"name": "DeepBDC", "kwargs": None},
        "backbone": {"name": "resnet12Bdc",
                     "kwargs": {"num_channels": 1, "reduce_dim": 8, "fused_bdc": False}},
        "data_root": "synthetic:10:12", "spec_shape": [1, 32, 40],
        "way_num": 5, "shot_num": 5, "query_num": 3,
        "test_episode": 4, "test_episode_size": 2, "test_epoch": 2,
        "max_segments_per_clip": 3, "segment_bucket_sizes": [48],
        "precision": "fp32", "seed": 0, "prefetch": 0,
    }
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


@pytest.fixture(scope="module")
def models():
    """The JAX method with random non-trivial weights, and the port's method
    holding the same weights."""
    cfg = slice_config()
    jax_method = jax_build_method(cfg)
    setting = eval_setting(cfg)
    example = next(iter(jax_get_dataloader(cfg, "test")[0].epoch(0)))
    variables = jax_method.init_variables(jax.random.PRNGKey(0), example, setting)
    variables = randomize_batchnorm(
        jax.tree_util.tree_map(np.asarray, variables), np.random.default_rng(1)
    )
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(variables, "resnet12Bdc", prefix="emb_func."))
    return cfg, setting, jax_method, variables, method.eval()


def _close(ours, ref, rtol=RTOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_forward_uncertainty_accuracy_and_flags_match_jax(models):
    cfg, setting, jax_method, variables, method = models
    jax_forward = jax.jit(lambda v, b: jax_method.forward(v, b, setting))
    batches = zip(jax_get_dataloader(cfg, "test")[0].epoch(0),
                  get_dataloader(cfg, "test")[0].epoch(0), strict=True)
    for jax_batch, host_batch in batches:
        batch = host_batch.to("cpu")
        ref_logits = jax_forward(variables, jax_batch)
        with torch.no_grad():
            logits = method(batch, setting)
        assert logits.shape == ref_logits.shape == (2, 48, 5)
        _close(logits, ref_logits)

        u, ok = method.clip_uncertainty(logits, batch)
        ref_u, ref_ok = jax_method.clip_uncertainty(ref_logits, jax_batch)
        _close(u, ref_u)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
        np.testing.assert_allclose(
            method.eval_episode_accuracy(logits, batch).numpy(),
            np.asarray(jax_method.eval_episode_accuracy(ref_logits, jax_batch)),
            rtol=ACC_RTOL,
        )
        np.testing.assert_array_equal(
            method.ood_mask(u).numpy(), np.asarray(jax_method.ood_mask(ref_u))
        )


@pytest.mark.parametrize("shot", [1, 5])
def test_head_over_features_matches_jax(models, shot):
    """Euclid for shot > 1, raw dot product for 1-shot, through the
    ``feature_logits`` hook."""
    _, _, jax_method, _, method = models
    rng = np.random.default_rng(shot)
    sup = rng.normal(size=(2, 5 * shot, 36)).astype(np.float32)
    qry = rng.normal(size=(2, 7, 36)).astype(np.float32)
    setting = EpisodeSetting(way=5, shot=shot, query=3)
    ref = jax_method.feature_logits(sup, qry, setting)
    ours = method.feature_logits(torch.from_numpy(sup), torch.from_numpy(qry), setting)
    _close(ours, ref)
    _close(bdc_proto_logits(torch.from_numpy(qry), torch.from_numpy(sup), 5, shot),
           jax_bdc_proto_logits(qry, sup, 5, shot))


def test_embed_segments_matches_jax(models):
    _, _, jax_method, variables, method = models
    x = np.random.default_rng(4).normal(size=(3, 1, 32, 40)).astype(np.float32)
    with torch.no_grad():
        ours = method.embed_segments(torch.from_numpy(x))
    _close(ours, jax_method.embed_segments(variables, x))


@pytest.mark.parametrize("policy", ["mean", "overall"])
def test_calibrate_threshold_matches_jax(models, policy, tmp_path):
    cfg, setting, jax_method, variables, method = models
    ref = jax_method.calibrate_threshold(
        variables, jax_get_dataloader(cfg, "val")[0], setting, get_mesh(1),
        policy=policy, dump_path=str(tmp_path / "ref.npz"),
    )
    ours = method.calibrate_threshold(
        get_dataloader(cfg, "val")[0], setting, policy=policy,
        dump_path=str(tmp_path / "ours.npz"),
    )
    assert ours is not None and ref is not None
    assert ours == pytest.approx(ref, rel=RTOL)
    assert method.uncertains_mean == pytest.approx(jax_method.uncertains_mean, rel=RTOL)
    assert method.uncertains_std == pytest.approx(jax_method.uncertains_std, rel=RTOL)
    with np.load(tmp_path / "ours.npz", allow_pickle=True) as a, \
            np.load(tmp_path / "ref.npz", allow_pickle=True) as b:
        for ua, ub in zip(a["uncertains"], b["uncertains"], strict=True):
            _close(np.asarray(ua, np.float32), np.asarray(ub, np.float32))
        for ca, cb in zip(a["is_corrects"], b["is_corrects"], strict=True):
            np.testing.assert_array_equal(np.asarray(ca, bool), np.asarray(cb, bool))


def test_test_loop_matches_jax_end_to_end(models, tmp_path):
    """The same weights saved once as the JAX package's model_best.pth and
    once as the port's give the same accuracy, CI and threshold."""
    cfg, _, jax_method, variables, method = models
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(os.path.join(jax_dir, "checkpoints"))
    save_variables(os.path.join(jax_dir, "checkpoints", "model_best.pth"), variables)
    save_model_best(port_dir, method)

    ref_test = JaxTest(0, cfg, jax_dir)
    ref = ref_test.test_loop()
    test = Test(0, cfg, port_dir, device="cpu")
    ours = test.test_loop()
    assert ours == pytest.approx(ref, rel=10 * ACC_RTOL)
    assert test.method.uncertain_global_threshold == pytest.approx(
        ref_test.method.uncertain_global_threshold, rel=RTOL
    )
    assert len(test.epoch_eps) == cfg["test_epoch"]
    assert os.path.isfile(os.path.join(port_dir, "uncertainty_data.npz"))


def _port_files():
    root = os.path.join(REPO, "audio_fewshot_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_nothing_of_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "audio_fewshot_tpu", "tools")
    offenders = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert len(_port_files()) > 20
    scanned = {os.path.relpath(p, os.path.join(REPO, "audio_fewshot_tpu_torch")) for p in _port_files()}
    assert {"models/backbones/conv_four.py", "models/backbones/layers.py", "models/init.py",
            "models/heads/proto_net.py", "models/__init__.py", "utils/aggregate.py",
            "utils/convert.py", "ops/audio_augmentations.py", "eval.py", "train.py",
            "profile_eval.py", "profile_train.py", "models/heads/dn4.py",
            "models/heads/local_metrics.py", "models/heads/mcl.py", "models/heads/atl_net.py",
            "models/heads/relation_net.py", "ops/bpa.py", "models/backbones/resnet.py",
            "models/heads/meta_baseline.py", "models/heads/dsn.py", "models/heads/frn.py",
            "models/heads/feat.py", "models/heads/can.py", "models/heads/kendall.py",
            "models/losses.py", "registry.py", "models/heads/metal.py", "models/heads/mtl.py",
            "models/heads/leo.py", "models/heads/versa.py", "models/heads/ifsl.py",
            "models/heads/finetuning.py", "models/heads/pretrains.py", "data/loader.py",
            "data/sampler.py", "episode.py", "models/backbones/resnet18.py",
            "models/backbones/wrn.py", "parallel/__init__.py", "parallel/collectives.py",
            "parallel/mesh.py", "parallel/launch.py", "dryrun_multigpu.py"} <= scanned
    assert not offenders, offenders


def test_entry_points_never_drift_to_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Test(0, slice_config())
    save_config(slice_config(test_epoch=1), str(tmp_path / "config.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_test.main([str(tmp_path)])
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_runs_on_the_cpu_when_asked(tmp_path, caplog):
    save_config(slice_config(test_epoch=1), str(tmp_path / "config.yaml"))
    run_test.main([str(tmp_path), "--device", "cpu", "--test_episode", "2",
                   "--test_episode_size", "2"])
    log = open(os.path.join(tmp_path, "log_files", "DeepBDC-resnet12Bdc-test.log")).read()
    assert "Test epoch 0: Acc@1" in log and "Aggregated: Acc@1" in log
    assert "uncertainty threshold" in log


@pytest.mark.parametrize("precision, tf32_after", [("bf16", True), ("fp32", False)])
def test_only_fp32_runs_switch_tf32_off(monkeypatch, precision, tf32_after):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    build_method(slice_config(precision=precision))  # the builder leaves them alone
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    Test(0, slice_config(precision=precision, test_episode=2), device="cpu")
    assert torch.backends.cudnn.allow_tf32 is tf32_after
    assert torch.backends.cuda.matmul.allow_tf32 is tf32_after


def test_chip_cell_is_the_full_width_config():
    from audio_fewshot_tpu_torch.eval import slice_config as chip_cell

    cfg = chip_cell(test_episode=32, precision="fp32")
    assert cfg["backbone"] == {"name": "resnet12Bdc",
                               "kwargs": {"num_channels": 1, "reduce_dim": 64}}
    assert cfg["spec_shape"] == [1, 128, 157]
    assert (cfg["test_way"], cfg["test_shot"], cfg["test_query"]) == (5, 5, 10)
    assert (cfg["test_episode"], cfg["test_episode_size"]) == (32, 16)
    assert cfg["precision"] == "fp32" and cfg["classifier"]["name"] == "DeepBDC"


def test_tta_config_raises_instead_of_skipping(monkeypatch, tmp_path):
    """A TTA config runs the energy-OOD re-vote on every test step (the
    warm-up and each epoch's), seeded: two runs give the same accuracies.
    Without the Clean statistics it raises instead of skipping the TTA."""
    from audio_fewshot_tpu_torch import eval as port_eval

    calls = []
    inner = port_eval.tta_eval_step

    def counting(*args, **kwargs):
        calls.append(kwargs["num_augmentations"])
        return inner(*args, **kwargs)

    monkeypatch.setattr(port_eval, "tta_eval_step", counting)
    cfg = slice_config(enhance_classification_via_energy=True, num_augmentations=3,
                       test_episode=2, test_epoch=1)
    runs = []
    for _ in range(2):
        test = Test(0, cfg, device="cpu")
        runs.append(test.test_loop())
    assert calls == [3] * 4  # warm-up + one step, twice
    assert runs[0] == runs[1] and 0.0 <= runs[0][0] <= 100.0
    assert test.enhance_via_energy and test.tta_segments_per_clip == 3
    with pytest.raises(FileNotFoundError, match="Clean normalization stats"):
        Test(0, slice_config(enhance_classification_via_energy=True,
                             tta_mean_std_file=str(tmp_path / "absent.npy")),
             device="cpu").test_loop()


def test_jax_checkpoint_is_refused_with_a_pointer_to_the_converter(models, tmp_path):
    _, _, _, variables, method = models
    path = str(tmp_path / "model_best.pth")
    save_variables(path, variables)
    with pytest.raises(ValueError, match="state_dict_from_jax"):
        load_model(path, method)

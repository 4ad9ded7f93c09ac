"""``dump_features`` of the PyTorch port against the JAX package on the CPU:
``utils.features.dump_episode_features`` and ``Test``'s dump of the first
test batch, ProtoNet on Conv64F (``is_flatten``, ``[1, 81, 90]``, query clips
of up to 3 segments; ``test_torch_port_proto``'s cell and its JAX weights).

Tolerances: ``raw_features`` 1e-5 of their max abs (``FEATURE_TOL``; float32
Conv64F in both packages, 1600 features); the keys, row counts, the
first-segment rows and the metadata: exact.
"""

import glob
import logging
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.utils import features as jax_features  # noqa: E402
from audio_fewshot_tpu_torch.data import get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.eval import Test  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.utils import features  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

from test_torch_port_proto import _jax_variables, proto_config  # noqa: E402

FEATURE_TOL = 1e-5
KEYS = {"raw_features", "shot", "way", "query", "timestamp", "normalize", "method"}


def _jax_dump(cfg, out_dir):
    batch = next(iter(jax_get_dataloader(cfg, "test")[0].epoch(0)))
    return jax_features.dump_episode_features(jax_build_method(cfg), _jax_variables(), batch,
                                              str(out_dir))


def _port_method(cfg):
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(_jax_variables(), "Conv64F", prefix="emb_func."))
    return method.eval()


def test_dump_episode_features_matches_jax(tmp_path):
    """One npz per episode of the batch; ``raw_features`` [5 · (2 + 2),
    1600] in per-class blocks, each query clip by its first valid segment,
    as the JAX package's; ``features_2d`` where sklearn imports."""
    cfg = proto_config()
    ref_paths = _jax_dump(cfg, tmp_path / "jax")
    batch = next(iter(get_dataloader(cfg, "test")[0].epoch(0))).to("cpu")
    assert int(batch.query_mask.sum()) > batch.query_target.numel()  # multi-segment clips
    paths = features.dump_episode_features(_port_method(cfg), batch, str(tmp_path / "port"))
    assert len(paths) == len(ref_paths) == cfg["test_episode_size"]
    for ours, ref in zip(paths, ref_paths, strict=True):
        with np.load(ours) as a, np.load(ref) as b:
            assert set(a.files) == set(b.files) and KEYS <= set(a.files)
            assert a["raw_features"].shape == b["raw_features"].shape == (20, 1600)
            diff = np.abs(a["raw_features"] - b["raw_features"]).max()
            assert diff <= FEATURE_TOL * np.abs(b["raw_features"]).max()
            for key in ("shot", "way", "query", "normalize", "method", "projection_used"):
                assert a[key] == b[key], key
            assert a["features_2d"].shape == (20, 2)


def test_first_segment_rows_warn_on_an_empty_clip(caplog):
    """A query clip with no valid segment gets a zero row and a warning, as
    in the JAX package."""
    rng = np.random.default_rng(0)
    qry = rng.normal(size=(6, 4)).astype(np.float32)
    clip_ids = np.array([0, 0, 1, 2, 2, 2])
    mask = np.array([0, 1, 1, 0, 0, 0], np.float32)
    logger = logging.getLogger("features-test")
    with caplog.at_level(logging.WARNING, logger="features-test"):
        rows = features._first_segment_rows(qry, clip_ids, mask, 3, logger)
    ref = jax_features._first_segment_rows(qry, clip_ids, mask, 3)
    np.testing.assert_array_equal(rows, ref)
    np.testing.assert_array_equal(rows, np.stack([qry[1], qry[2], np.zeros(4, np.float32)]))
    assert "[2]" in caplog.text


def test_projection_without_sklearn_warns(monkeypatch, caplog):
    """Without sklearn (as on the card's machine) the dump keeps its raw
    features, warns, and writes no ``features_2d``."""
    for name in ("sklearn", "sklearn.decomposition", "sklearn.manifold",
                 "sklearn.preprocessing"):
        monkeypatch.setitem(sys.modules, name, None)
    logger = logging.getLogger("features-test")
    with caplog.at_level(logging.WARNING, logger="features-test"):
        coords, used = features._project_2d(np.ones((6, 3), np.float32), True, "tsne", logger)
    assert coords is None and used == "none" and "sklearn unavailable" in caplog.text


def test_test_loop_dumps_the_first_test_batch(tmp_path):
    """``Test`` with ``dump_features``: ``plots/featdata_*.npz`` for each
    episode of the first test batch under the result dir, the same features
    as the JAX package's dump of that batch, then its test epochs."""
    cfg = proto_config(dump_features=True, test_epoch=1)
    save_model_best(str(tmp_path), _port_method(cfg))
    test = Test(0, cfg, str(tmp_path), device="cpu")
    test.test_loop()
    assert sorted(test.feature_dumps) == sorted(glob.glob(str(tmp_path / "plots" / "*.npz")))
    ref_paths = _jax_dump(cfg, tmp_path / "jax")
    assert len(test.feature_dumps) == len(ref_paths) == cfg["test_episode_size"]
    for ours, ref in zip(sorted(test.feature_dumps), ref_paths, strict=True):
        with np.load(ours) as a, np.load(ref) as b:
            assert a["raw_features"].shape == (20, 1600)
            diff = np.abs(a["raw_features"] - b["raw_features"]).max()
            assert diff <= FEATURE_TOL * np.abs(b["raw_features"]).max()
    assert len(test.epoch_eps) == 1

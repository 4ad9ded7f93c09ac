"""The CLAP path of the PyTorch port against the JAX package on the CPU: the
log-mel front end, HTSAT's fold, the encoder (``mini_encoder``: a 1 s
window at 16 kHz, 16 mel bins, a 64 × 64 image, Swin embed 24, depths (1,
1), heads (2, 4), window 4), its flat npz both ways, the extraction CLI,
``CLAPEmbeddingBackbone``, ``build_method``'s ``is_clap`` and the
``Trainer``'s ``checkpoint_path`` load.

The JAX encoder's body is bf16 whatever the config says; its float32
oracle is composed here of the JAX package's own pieces on the same
``htsat`` params: ``log_mel_spectrogram``, ``fold_spectrogram``,
``SwinTransformer(dtype=float32)`` and the two projections.

Tolerances:
- log-mel of noise: 1e-5 of its max abs (``MEL_TOL``; float32 rFFT and
  mel product in another order); of silence: exactly log(1e-10) in both;
- the float32 encoder against the float32 oracle: 1e-5 absolute on the
  unit-norm embeddings (``EMB_TOL``); the bf16 encoder against the JAX
  package's bf16 one (the whole ``mini_encoder``, and the extraction CLI
  against the JAX tool): 5e-3 (``BF16_TOL``; 8 bits of mantissa through
  the body);
- the fold, the npz files and the substitutions: exact.
"""

import os
import subprocess
import sys
import wave as wave_mod

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.models.backbones import clap_encoder as jax_ce  # noqa: E402
from audio_fewshot_tpu.models.backbones.clap import (  # noqa: E402
    CLAPEmbeddingBackbone as JaxEmbeddingBackbone)
from audio_fewshot_tpu.models.backbones.swin import SwinTransformer as JaxSwin  # noqa: E402
from audio_fewshot_tpu.ops.mel import log_mel_spectrogram as jax_log_mel  # noqa: E402
from audio_fewshot_tpu_torch import extract_clap_embeddings  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones import clap_encoder as ce  # noqa: E402
from audio_fewshot_tpu_torch.ops.mel import log_mel_spectrogram  # noqa: E402
from audio_fewshot_tpu_torch.registry import BACKBONES  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL_TOL = 1e-5
EMB_TOL = 1e-5
BF16_TOL = 5e-3
MINI = jax_ce.mini_encoder()
N = 3


def _wave(n=N, samples=16000, seed=0):
    return np.random.default_rng(seed).normal(size=(n, samples)).astype(np.float32)


_PARAMS = {}


def jax_params():
    """The JAX mini encoder's random init, with non-zero biases and
    LayerNorm scales so that each must land."""
    if not _PARAMS:
        params = jax.tree_util.tree_map(
            np.asarray, MINI.init(jax.random.PRNGKey(0), _wave(1))["params"])
        rng = np.random.default_rng(1)
        _PARAMS["p"] = jax.tree_util.tree_map(
            lambda a: a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype) if a.ndim == 1 else a,
            params)
    return _PARAMS["p"]


def jax_float32_oracle(params, wave):
    """The JAX encoder's computation in float32, from the JAX package's own
    pieces (its module runs its body in bf16)."""
    mel = jax_log_mel(wave, num_mels=MINI.num_mels, n_fft=MINI.n_fft, hop=MINI.hop,
                      sample_rate=MINI.sample_rate, fmin=MINI.fmin, fmax=MINI.fmax)
    body = JaxSwin(embed_dim=MINI.swin_embed_dim, depths=MINI.depths, num_heads=MINI.num_heads,
                   downscaling_factors=(4, 2, 2, 2), window_size=MINI.window_size,
                   head_dim=MINI.swin_embed_dim // MINI.num_heads[0], is_flatten=True,
                   dtype=jnp.float32)
    x = body.apply({"params": params["htsat"]}, MINI.fold_spectrogram(mel))
    x = jax.nn.relu(x @ params["proj0"]["kernel"] + params["proj0"]["bias"])
    x = x @ params["proj1"]["kernel"] + params["proj1"]["bias"]
    return np.asarray(x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12))


def port_encoder(dtype=torch.float32, params=None):
    enc = ce.mini_encoder(dtype=dtype)
    enc.load_state_dict(state_dict_from_jax({"params": params or jax_params()}, "CLAPBackbone"))
    return enc.eval()


def _embed(enc, wave):
    with torch.no_grad():
        return enc(torch.from_numpy(wave)).numpy()


@pytest.mark.parametrize("kind", ["noise", "silence", "short"])
def test_log_mel_matches_jax(kind):
    """KOS geometry (128 mel bins, n_fft 2048, hop 700 at 22.05 kHz): noise
    (7 frames), silence (exactly log 1e-10) and a clip shorter than n_fft
    (zero-padded to one frame)."""
    samples = {"noise": 6300, "silence": 6300, "short": 1500}[kind]
    wave = _wave(2, samples, seed=3) * (0.0 if kind == "silence" else 1.0)
    ref = np.asarray(jax_log_mel(wave))
    ours = log_mel_spectrogram(torch.from_numpy(wave)).numpy()
    assert ours.shape == ref.shape == (2, 128, 1 + max(samples - 2048, 0) // 700)
    if kind == "silence":
        np.testing.assert_array_equal(ours, np.full_like(ours, np.log(np.float32(1e-10))))
        np.testing.assert_array_equal(ref, ours)
    else:
        assert np.abs(ours - ref).max() <= MEL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("frames", [200, 300], ids=["pad", "crop"])
def test_fold_spectrogram_matches_jax(frames):
    """T padded with 0 (log domain) or cropped to spec_size · freq_ratio =
    256, then the four chunks stacked along the frequency axis; a wrong
    number of mel bins raises."""
    mel = np.random.default_rng(4).normal(size=(2, 16, frames)).astype(np.float32)
    ref = np.asarray(MINI.fold_spectrogram(jnp.asarray(mel)))
    enc = ce.mini_encoder()
    ours = enc.fold_spectrogram(torch.from_numpy(mel)).numpy()
    assert ours.shape == ref.shape == (2, 1, 64, 64)
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="expected 16 mel bins"):
        enc.fold_spectrogram(torch.zeros((1, 15, 256)))


def test_encoder_matches_the_float32_jax_oracle():
    wave = _wave()
    ours = _embed(port_encoder(), wave)
    ref = jax_float32_oracle(jax_params(), wave)
    assert ours.shape == ref.shape == (N, 512)
    assert np.abs(ours - ref).max() <= EMB_TOL
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-5)


def test_bf16_mini_encoder_matches_jax():
    """The whole ``mini_encoder`` at its bf16 body in both packages."""
    wave = _wave(seed=2)
    ref = np.asarray(MINI.apply({"params": jax_params()}, wave))
    ours = _embed(port_encoder(torch.bfloat16), wave)
    assert np.abs(ours - ref).max() <= BF16_TOL


def test_npz_both_ways(tmp_path):
    """JAX ``save_params`` → the port's ``load_checkpoint``, and the port's
    ``save_params`` → JAX ``load_params``: the same tree, the same
    embeddings."""
    wave = _wave(seed=5)
    jax_file, port_file = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ce.save_params(jax_file, jax_params())
    enc = ce.mini_encoder(dtype=torch.float32)
    ce.load_checkpoint(enc, jax_file)
    ref = jax_float32_oracle(jax_params(), wave)
    assert np.abs(_embed(enc, wave) - ref).max() <= EMB_TOL
    ce.save_params(port_file, enc)
    loaded = jax_ce.load_params(port_file)
    assert (jax.tree_util.tree_structure(loaded)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(jnp.asarray, jax_params())))
    for path, val in jax.tree_util.tree_leaves_with_path(jax_params()):
        got = dict(jax.tree_util.tree_leaves_with_path(loaded))[path]
        np.testing.assert_array_equal(np.asarray(got), val, err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="jax.npz does not match"):
        ce.load_checkpoint(ce.mini_encoder(swin_embed_dim=32), jax_file)


def _audio_root(root, classes=2, clips=3):
    """wav (int16, 8 kHz and 16 kHz) and npy (float32 at 16 kHz) clips of
    0.4 to 1.3 s."""
    rng = np.random.default_rng(6)
    for c in range(classes):
        cdir = root / f"cls_{c}"
        cdir.mkdir(parents=True)
        for k in range(clips):
            n = int(rng.integers(6000, 21000))
            x = rng.normal(0.0, 0.1, size=n).astype(np.float32)
            if k % 2 == 0:
                with wave_mod.open(str(cdir / f"clip_{k}.wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(8000 if k == 2 else 16000)
                    w.writeframes((x * 32767).astype("<i2").tobytes())
            else:
                np.save(cdir / f"clip_{k}.npy", x)
    return root


def test_extraction_cli_matches_the_jax_tool(tmp_path):
    """The port's CLI (``--device cpu``) and the JAX tool on one audio root
    and one npz checkpoint: the same files, and embeddings within the bf16
    limit; without weights the CLI refuses."""
    audio = _audio_root(tmp_path / "audio")
    ckpt = str(tmp_path / "clap.npz")
    jax_ce.save_params(ckpt, jax_params())
    common = ["--audio_root", str(audio), "--mini", "--checkpoint", ckpt,
              "--sample_rate", "16000", "--batch", "2"]
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "extract_clap_embeddings.py"),
         *common, "--out", str(tmp_path / "jax"), "--cpu"],
        capture_output=True, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    stats = extract_clap_embeddings.main([*common, "--out", str(tmp_path / "port"),
                                          "--device", "cpu"])
    assert stats["clips"] == 6
    for cls in ("cls_0", "cls_1"):
        names = sorted(os.listdir(tmp_path / "jax" / cls))
        assert names == sorted(os.listdir(tmp_path / "port" / cls)) and len(names) == 3
        for name in names:
            ref = np.load(tmp_path / "jax" / cls / name)
            ours = np.load(tmp_path / "port" / cls / name)
            assert ours.shape == (512,) and ours.dtype == np.float32
            assert abs(np.linalg.norm(ours) - 1.0) < 1e-3
            assert np.abs(ours - ref).max() <= BF16_TOL, (cls, name)
    with pytest.raises(SystemExit, match="--allow-random-init"):
        extract_clap_embeddings.main(["--audio_root", str(audio), "--out", str(tmp_path / "x"),
                                      "--device", "cpu"])


def test_extraction_cli_runs_on_the_card_unless_asked(tmp_path):
    """Without ``--device`` the CLI asks for the card, and raises here where
    there is none: it never drifts to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_clap_embeddings.main(["--audio_root", str(tmp_path), "--out",
                                      str(tmp_path / "out"), "--allow-random-init"])


def test_embedding_backbone_matches_jax():
    """Pre-extracted embeddings pass through flat, float32, and through the
    optional ``proj``; the factory drops ``num_channels`` and ``dtype``."""
    x = np.random.default_rng(7).normal(size=(4, 1, 1, 512)).astype(np.float32)
    module = JaxEmbeddingBackbone(project_dim=32)
    params = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(0), x)["params"])
    ref = np.asarray(module.apply({"params": params}, x))
    ours = BACKBONES.build("CLAPEmbeddingBackbone", project_dim=32, num_channels=1,
                           dtype=torch.bfloat16)
    ours.load_state_dict(state_dict_from_jax({"params": params}, "CLAPEmbeddingBackbone"))
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    plain = BACKBONES.build("CLAPEmbeddingBackbone", num_channels=1)
    np.testing.assert_array_equal(plain(torch.from_numpy(x)).numpy(), x.reshape(4, 512))
    assert plain.feature_dim() == 512 and ours.feature_dim() == 32


def _clap_config(**over):
    cfg = {"is_clap": True, "way_num": 3, "shot_num": 1, "query_num": 2,
           "backbone": {"name": "Conv64F", "kwargs": {
               "is_flatten": True, "last_pool": True, "maxpool_last2": True,
               "allow_random_init": True}},
           "classifier": {"name": "ProtoNet", "kwargs": None},
           "modality": "audio", "precision": "fp32"}
    cfg.update(over)
    return cfg


def test_is_clap_substitutes_the_encoder():
    """``is_clap: true`` on a Conv64F config builds ``CLAPBackbone`` with
    only the CLAP opt-in keys (the JAX package's substitution); without an
    opt-in it raises naming ``checkpoint_path``; a CLAP-named backbone keeps
    its own kwargs."""
    from audio_fewshot_tpu.models import build_method as jax_build_method
    from audio_fewshot_tpu.models.backbones.clap_encoder import CLAPAudioEncoder as JaxEncoder

    method = build_method(_clap_config())
    assert isinstance(method.emb_func, ce.CLAPAudioEncoder)
    assert isinstance(jax_build_method(_clap_config()).emb_func, JaxEncoder)
    # the body in bf16 whatever precision says, as the JAX package's
    assert method.emb_func.htsat.dtype == torch.bfloat16
    assert method.emb_func.proj0.weight.shape == (512, 768)
    with pytest.raises(ValueError, match="checkpoint_path"):
        build_method(_clap_config(backbone={"name": "Conv64F", "kwargs": {"is_flatten": True}}))
    kept = build_method(_clap_config(backbone={"name": "CLAPEmbeddingBackbone",
                                               "kwargs": {"project_dim": 16}}))
    assert kept.emb_func.feature_dim() == 16


def test_trainer_loads_the_clap_checkpoint(tmp_path, monkeypatch):
    """``checkpoint_path`` on a CLAP encoder: the npz's weights in
    ``emb_func`` when the ``Trainer`` starts (before ``pretrain_path`` and
    resume), then a train step on 1-D waveform clips; a file for another
    variant raises, naming it."""
    import audio_fewshot_tpu_torch.train as port_train_module
    from audio_fewshot_tpu_torch.config import Config
    from audio_fewshot_tpu_torch.utils.meters import TensorboardWriter

    class NoWriter(TensorboardWriter):  # importing tensorboard costs seconds; nothing reads it
        def __init__(self, log_dir):
            self.step, self._writer = 0, None

    monkeypatch.setattr(port_train_module, "TensorboardWriter", NoWriter)

    root = tmp_path / "waves"
    rng = np.random.default_rng(8)
    for c in range(3):
        (root / f"c{c}").mkdir(parents=True)
        for k in range(3):
            np.save(root / f"c{c}" / f"{k}.npy", rng.normal(size=16000).astype(np.float32))
    ckpt = str(tmp_path / "clap.npz")
    jax_ce.save_params(ckpt, jax_params())
    mini = {k: getattr(MINI, k) for k in ("sample_rate", "n_fft", "hop", "num_mels", "fmin",
                                          "fmax", "spec_size", "swin_embed_dim", "window_size")}
    mini.update(depths=list(MINI.depths), num_heads=list(MINI.num_heads))
    cfg = _clap_config(
        backbone={"name": "CLAPBackbone", "kwargs": {**mini, "checkpoint_path": ckpt}},
        data_root=str(root), result_root=str(tmp_path / "results"), epoch=1, train_episode=1,
        test_episode=1, episode_size=1, augment=False, seed=0,
        optimizer={"name": "SGD", "kwargs": {"lr": 0.0}, "other": None})
    cfg = Config(None, cfg).get_config_dict()
    saved = port_encoder(params=jax_params()).state_dict()
    trainer = port_train_module.Trainer(0, cfg, device="cpu")
    own = trainer.method.emb_func.state_dict()
    assert set(own) == set(saved)
    for key, val in saved.items():
        torch.testing.assert_close(own[key], val, rtol=0, atol=0, msg=key)
    trainer.train_loop()
    assert np.isfinite(trainer.history[0]["train_losses"]).all()
    cfg["backbone"]["kwargs"]["swin_embed_dim"] = 32
    with pytest.raises(ValueError, match="clap.npz does not match"):
        port_train_module.Trainer(0, cfg, device="cpu")

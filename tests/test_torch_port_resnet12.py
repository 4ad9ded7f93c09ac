"""The plain resnet12 / resnet12woLSC of the PyTorch port and its DropBlock
against the JAX package on the CPU, at weights moved across with
``utils.convert.state_dict_from_jax`` and random BN statistics: eval
features (flat in NHWC order, and as a map), the DropBlock mask for the same
seeds, the train-mode forward with DropBlock (resnet12 and resnet12Bdc) for
the same seeds, the keep-rate ramp's γ, and the ramp counter through
training, eval, conversion, checkpoints and a resumed ``Trainer``.

resnet12 at planes 8/12/16/20 on ``[1, 96, 112]`` segments: a [20, 6, 7]
map, [20, 2, 3] after the avg pool.  resnet12woLSC's registration fixes its
planes (64/128/256/512), so it is held at them on ``[1, 32, 40]``
segments (a [512, 2, 2] map).
Tolerances: float32 features 1e-5 of their scale (13 convolutions summed in
another order); masks and counters exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.models.backbones.layers import DropBlock as JaxDropBlock  # noqa: E402
from audio_fewshot_tpu.models.backbones.resnet import ResNet12BDC as JaxResNet12BDC  # noqa: E402
from audio_fewshot_tpu.registry import BACKBONES as JAX_BACKBONES  # noqa: E402
from audio_fewshot_tpu.utils.torch_convert import invert_backbone_params  # noqa: E402
import audio_fewshot_tpu_torch.train as port_train_module  # noqa: E402
from audio_fewshot_tpu_torch import run_trainer_resume  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones import layers  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.resnet import ResNet12, ResNet12BDC  # noqa: E402
from audio_fewshot_tpu_torch.registry import BACKBONES  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import LAST, load_last, save_model  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import SaveType  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402
from audio_fewshot_tpu_torch.utils.meters import TensorboardWriter  # noqa: E402

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402

FEAT_TOL = 1e-5
PLANES = (8, 12, 16, 20)
SPEC = (1, 96, 112)
KEYS = {"params": jax.random.PRNGKey(0), "dropblock": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(2)}


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _inputs(n=3, seed=0, spec=SPEC):
    return np.random.default_rng(seed).normal(size=(n,) + spec).astype(np.float32)


_VARIABLES = {}


def _jax_pair(name, drop_rate=0.1, **kw):
    """The JAX backbone (float32) and its variables, initialised in train
    mode as ``init_variables`` does (drop_rate > 0: the counters exist),
    with random BN statistics; and the port's backbone holding them."""
    key = (name, drop_rate)  # ``is_flatten`` / ``avg_pool`` change no variable
    planes = {} if name != "resnet12" else {"planes": PLANES}
    if name == "resnet12Bdc":
        module = JaxResNet12BDC(reduce_dim=8, drop_rate=drop_rate, dtype=jnp.float32, **kw)
        port = ResNet12BDC(reduce_dim=8, drop_rate=drop_rate, dtype=torch.float32, **kw)
    else:
        module = JAX_BACKBONES.build(name, drop_rate=drop_rate, dtype=jnp.float32,
                                     **planes, **kw)
        port = BACKBONES.build(name, drop_rate=drop_rate, dtype=torch.float32, **planes, **kw)
    if key not in _VARIABLES:
        x = _inputs(1, spec=(1, 32, 40) if name == "resnet12woLSC" else SPEC)
        variables = jax.jit(lambda k: module.init(k, jnp.asarray(x), train=True))(KEYS)
        _VARIABLES[key] = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, dict(variables)),
                                              np.random.default_rng(1))
    port.load_state_dict(state_dict_from_jax(_VARIABLES[key], name))
    return module, _VARIABLES[key], port


@pytest.mark.parametrize("name", ["resnet12", "resnet12woLSC"])
def test_converter_is_the_jax_package_inverter_plus_the_counters(name):
    """``state_dict_from_jax`` gives ``invert_backbone_params``' entries,
    value for value, plus the two DropBlock counters (which the JAX
    package's inverter drops); they are the port's state-dict keys."""
    _, variables, port = _jax_pair(name)
    ours = state_dict_from_jax(variables, name, prefix="emb_func.")
    ref = invert_backbone_params(variables, name)
    counters = {f"emb_func.layer{i}.0.num_batches_tracked" for i in (3, 4)}
    assert set(ours) - set(ref) == counters
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
    assert set(port.state_dict()) == {k[len("emb_func."):] for k in ours}
    assert all(ours[k].dtype == torch.int64 for k in counters)
    if name == "resnet12woLSC":
        assert port.layer4[0].downsample is None and not port.layer4[0].use_residual
        assert port.layer4[0].conv1.out_channels == 512


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "map"])
@pytest.mark.parametrize("name", ["resnet12", "resnet12woLSC"])
def test_features_match_jax_in_eval(name, flat):
    """Eval features of the same weights: flat after the avg pool (NHWC
    order), or the map (``is_flatten`` and ``avg_pool`` off)."""
    spec = (1, 32, 40) if name == "resnet12woLSC" else SPEC
    module, variables, port = _jax_pair(name, is_flatten=flat, avg_pool=flat)
    x = _inputs(spec=spec)
    ref = np.asarray(jax.jit(lambda v, xx: module.apply(v, xx, train=False))(variables, x))
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    assert _rel(ours, ref) <= FEAT_TOL
    c, h, w = port.map_shape(spec)
    assert ours.shape[1:] == ((h * w * c,) if flat else (c, h, w))


def test_flatten_order_is_nhwc_at_a_map_larger_than_one():
    """The JAX package flattens the avg-pooled [20, 2, 3] map in NHWC order
    (the reference: NCHW); the port follows it, and the two orders differ."""
    _, _, flat = _jax_pair("resnet12")
    _, _, maps = _jax_pair("resnet12", is_flatten=False)
    x = torch.from_numpy(_inputs())
    with torch.no_grad():
        f, m = flat.eval()(x), maps.eval()(x)
    assert m.shape == (3, 20, 2, 3)
    torch.testing.assert_close(f, m.permute(0, 2, 3, 1).reshape(3, -1), rtol=0, atol=0)
    assert not torch.allclose(f, m.reshape(3, -1))


# -- DropBlock --------------------------------------------------------------------------------

def _seeded_bernoulli(monkeypatch, seeds, gammas):
    """``jax.random.bernoulli`` (looked up by the JAX ``DropBlock`` at call
    time) returning the port's seeds in turn, NHWC, and recording γ."""
    queue = list(seeds)

    def bernoulli(key, p, shape):
        gammas.append(float(p))
        s = queue.pop(0).permute(0, 2, 3, 1).numpy()
        assert s.shape == tuple(shape)
        return jnp.asarray(s, bool)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)


@pytest.mark.parametrize("block_size, hw", [(5, (9, 11)), (4, (9, 11)), (2, (6, 7)),
                                            (3, (3, 8)), (5, (4, 5))],
                         ids=["bs5", "bs4_even", "bs2_even", "bs3_clipped", "bs5_to_4"])
def test_dropblock_mask_matches_jax_for_the_same_seeds(monkeypatch, block_size, hw):
    """The port's mask from its own seeds against the JAX ``DropBlock`` fed the
    same seeds: even block sizes (flax's asymmetric "SAME" pool padding),
    a block clipped to the map, and the rescale over the whole tensor."""
    x = torch.from_numpy(_inputs(2, seed=3, spec=(6,) + hw)) + 3.0
    drop = layers.DropBlock(block_size).train()
    drop.reseed(5)
    seeds = []
    draw = drop.draw_seeds
    drop.draw_seeds = lambda xx, g: seeds.append(draw(xx, g)) or seeds[-1]
    ours = drop(x, 0.2)
    assert seeds[0].shape[-2:] == tuple(n - min(block_size, *hw) + 1 for n in hw)
    assert 0 < seeds[0].mean() < 0.5
    gammas = []
    _seeded_bernoulli(monkeypatch, seeds, gammas)
    ref = JaxDropBlock(block_size=block_size).apply(
        {}, jnp.asarray(x.permute(0, 2, 3, 1).numpy()), 0.2, True,
        rngs={"dropblock": jax.random.PRNGKey(0)})
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-6)
    assert gammas == [pytest.approx(0.2)]
    dropped = (ours == 0).float().mean().item()
    assert 0 < dropped < 1
    assert drop.eval()(x, 0.2) is x


def ramp_gamma(count, feat, rate=0.1, steps=40000, bs=5):
    """γ in float32 as both packages compute it (1 − keep cancels: at count
    1 it carries float32's rounding of 1 − 2.5e-6)."""
    f32 = np.float32
    keep = np.maximum(f32(1.0) - f32(rate / steps) * f32(count), f32(1.0 - rate))
    return float((f32(1.0) - keep) / f32(bs ** 2) * f32(feat ** 2)
                 / f32(max((feat - bs + 1) ** 2, 1)))


def _no_dropout(monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x: x)


@pytest.mark.parametrize("start", [0, 29999], ids=["ramp_start", "ramp_30000"])
@pytest.mark.parametrize("name", ["resnet12", "resnet12Bdc"])
def test_train_forward_with_dropblock_matches_jax(monkeypatch, name, start):
    """One train-mode forward with drop_rate 0.1 (Dropout made the identity
    in both packages; they cannot draw the same Bernoulli masks of it): the
    features, γ of stages 3 and 4 and the counters after the call (start +
    1) and the BN running statistics, the JAX package fed the port's
    DropBlock seeds.  resnet12Bdc's DropBlock (drop_rate > 0) runs too."""
    _no_dropout(monkeypatch)
    module, variables, port = _jax_pair(name)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    for i in (3, 4):
        variables["batch_stats"][f"layer{i}"]["num_batches_tracked"] = np.asarray(start, np.int32)
    port.load_state_dict(state_dict_from_jax(variables, name))
    layers.seed_dropout(port, 11)
    seeds = []
    for i in (3, 4):
        drop = getattr(port, f"layer{i}")[0].drop
        draw = drop.draw_seeds
        drop.draw_seeds = (lambda d: lambda xx, g: seeds.append(d(xx, g)) or seeds[-1])(draw)
    x = _inputs(4, seed=7)
    ours = port.train()(torch.from_numpy(x)).detach().numpy()
    gammas = []
    _seeded_bernoulli(monkeypatch, seeds, gammas)
    ref, updates = module.apply(variables, jnp.asarray(x), train=True, rngs=KEYS,
                                mutable=["batch_stats"])
    assert _rel(ours, ref) <= FEAT_TOL
    feats = (12, 6) if name == "resnet12" else (12, 12)  # the stage maps' heights
    expected = [ramp_gamma(start + 1, f) for f in feats]
    assert gammas == pytest.approx(expected, rel=1e-6)
    assert [float(getattr(port, f"layer{i}")[0].gamma(f)) for i, f in zip((3, 4), feats)] \
        == pytest.approx(expected, rel=1e-6)
    state = port.state_dict()
    ref_state = state_dict_from_jax({"params": variables["params"],
                                     "batch_stats": updates["batch_stats"]}, name)
    for key, val in ref_state.items():
        if key in ("layer3.0.num_batches_tracked", "layer4.0.num_batches_tracked"):
            assert int(state[key]) == int(val) == start + 1, key
        elif key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), val.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)


def test_ramp_gamma_at_counters_0_1_and_30000():
    """γ = (1 − keep)/bs² · feat²/max((feat − bs + 1)², 1), keep = max(1 −
    rate/40000 · count, 1 − rate), at the shipped geometry's stage maps
    (heights 16 and 8): 0 at count 0, the first step's at 1, and 1 − keep =
    0.075 at 30000 (the end of a 30 × 1000 run); the floor after 40000."""
    model = ResNet12(drop_rate=0.1)
    for count, keep in ((0, 1.0), (1, 1 - 0.1 / 40000), (30000, 0.925), (40000, 0.9),
                        (90000, 0.9)):
        for i, feat in ((3, 16), (4, 8)):
            block = getattr(model, f"layer{i}")[0]
            block.num_batches_tracked.fill_(count)
            assert float(block.gamma(feat)) == pytest.approx(ramp_gamma(count, feat), rel=1e-6,
                                                             abs=1e-12)
            # the float64 formula, but for float32's rounding of 1 − keep
            want = (1 - keep) / 25 * feat ** 2 / (feat - 4) ** 2
            assert float(block.gamma(feat)) == pytest.approx(want, rel=0.03, abs=1e-12)
    assert float(model.layer3[0].gamma(16)) > 0 and float(model.layer3[0].gamma(3)) > 0


def test_counter_counts_train_forwards_only_and_survives_a_checkpoint(tmp_path):
    """The counter (int64 buffer ``layer{3,4}.0.num_batches_tracked``) adds
    one per train-mode forward, none in eval, and is saved and loaded with
    the model; a JAX train apply's counter converts across."""
    port = ResNet12(planes=PLANES, dtype=torch.float32)
    x = torch.from_numpy(_inputs(2))
    port.train()
    port(x)
    port(x)
    with torch.no_grad():
        port.eval()(x)
    for i in (3, 4):
        buf = getattr(port, f"layer{i}")[0].num_batches_tracked
        assert buf.dtype == torch.int64 and int(buf) == 2
    assert not hasattr(port.layer1[0], "num_batches_tracked")
    assert isinstance(port.layer1[0].drop, layers.Dropout)
    save_model(str(tmp_path), port, 0, SaveType.LAST)
    again = ResNet12(planes=PLANES, dtype=torch.float32)
    again.load_state_dict(load_last(os.path.join(str(tmp_path), LAST))["state_dict"])
    assert int(again.layer4[0].num_batches_tracked) == 2
    assert not hasattr(ResNet12(planes=PLANES, drop_rate=0.0).layer3[0], "num_batches_tracked")
    module, variables, _ = _jax_pair("resnet12")
    _, updates = module.apply(variables, jnp.asarray(_inputs(2)), train=True, rngs=KEYS,
                              mutable=["batch_stats"])
    moved = state_dict_from_jax({"params": variables["params"], **updates}, "resnet12")
    assert int(moved["layer3.0.num_batches_tracked"]) == 1


def test_seed_dropout_reseeds_dropblock():
    """``seed_dropout`` gives every Dropout and DropBlock its own seed: the
    same seed draws the same masks, another seed others."""
    a = ResNet12(planes=PLANES, dtype=torch.float32).train()
    b = ResNet12(planes=PLANES, dtype=torch.float32).train()
    b.load_state_dict(a.state_dict())
    for m in (a, b):
        for i in (3, 4):
            getattr(m, f"layer{i}")[0].num_batches_tracked.fill_(39999)
    x = torch.from_numpy(_inputs(2))
    layers.seed_dropout(a, 3)
    layers.seed_dropout(b, 3)
    seeds = {a.layer3[0].drop.seed, a.layer4[0].drop.seed, a.layer1[0].drop.seed}
    assert len(seeds) == 3
    torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    layers.seed_dropout(b, 4)
    assert not torch.allclose(a(x), b(x))


def test_resnet12_trains_and_resumes_with_its_counters(tmp_path, monkeypatch):
    """MetaBaseline on resnet12 (drop_rate 0.1) through ``Trainer``: the
    counters count the train steps, not the val and test passes, and a resumed
    run carries them on."""

    class NoWriter(TensorboardWriter):
        def __init__(self, log_dir):
            self.step, self._writer = 0, None

    monkeypatch.setattr(port_train_module, "TensorboardWriter", NoWriter)
    cfg = Config(None, {
        "classifier": {"name": "MetaBaseline", "kwargs": None},
        "backbone": {"name": "resnet12", "kwargs": {"num_channels": 1, "planes": list(PLANES)}},
        "data_root": "synthetic:10:12", "spec_shape": [1, 32, 40],
        "way_num": 3, "shot_num": 2, "query_num": 2, "epoch": 1, "train_episode": 3,
        "test_episode": 2, "test_episode_size": 2, "max_segments_per_clip": 2,
        "precision": "fp32", "seed": 0, "prefetch": 0, "augment": False,
        "result_root": str(tmp_path), "save_interval": 1, "log_interval": 1,
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001}, "other": None},
    }).get_config_dict()
    trainer = port_train_module.Trainer(0, cfg, device="cpu")
    trainer.train_loop()
    counters = lambda t: [int(getattr(t.method.emb_func, f"layer{i}")[0].num_batches_tracked)  # noqa: E731
                          for i in (3, 4)]
    assert counters(trainer) == [3, 3]
    resumed = run_trainer_resume.build_trainer([trainer.result_dir, "--device", "cpu",
                                                "--epoch", "2"])
    assert counters(resumed) == [3, 3]
    resumed.train_loop()
    assert counters(resumed) == [6, 6]
    assert all(np.isfinite(r["train_losses"]).all() for r in resumed.history)

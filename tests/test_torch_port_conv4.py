"""The four-conv backbones of the PyTorch port (Conv64F, Conv32F,
R2D2Embedding, Conv64F_MCL) against the JAX modules, at weights moved across
with ``utils.convert.state_dict_from_jax`` and random BatchNorm statistics:
forward with eval BN and with train BN (and its running-statistics update),
the flatten order at a last map larger than 1×1, the mask-restricted BN
against flax's ``mask=``, the converters round-tripped through the JAX
package's ``convert_backbone_state_dict``, the kwargs each factory drops,
the empty-pool error, and the port's dropout on its own.

Float32 in both packages (the JAX modules built with ``dtype=float32``).
Dropout cannot draw JAX's masks, so train-mode parity makes it the identity
on both sides inside the test.  Tolerances, relative to the output's max
abs: 2e-5 with eval BN, 1e-4 with train BN (flax takes the batch variance
in one pass, torch in two)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.models.backbones import conv_four as jconv  # noqa: E402
from audio_fewshot_tpu.utils.torch_convert import (  # noqa: E402
    convert_backbone_state_dict, invert_backbone_params)
from audio_fewshot_tpu_torch.models.backbones.layers import (  # noqa: E402
    BatchNorm, BatchNorm1d, Dropout, floor_power, seed_dropout)
from audio_fewshot_tpu_torch.registry import BACKBONES  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402

EVAL_TOL = 2e-5   # of the output's max abs, eval BN
TRAIN_TOL = 1e-4  # of the output's max abs, train BN
STATS_TOL = 1e-5  # BN running statistics, rtol and atol

# name → (JAX module, port factory kwargs, input shape); every last map but
# Conv64F's at 81 × 90 is larger than 1 × 1
CASES = {
    "Conv64F_flatten": ("Conv64F", dict(is_flatten=True), (4, 1, 81, 90)),
    "Conv64F_map": ("Conv64F", dict(is_flatten=False), (4, 1, 81, 90)),
    "Conv64F_no_last_pools": ("Conv64F", dict(is_flatten=True, last_pool=False,
                                              maxpool_last2=False, leaky_relu=True),
                              (3, 1, 27, 30)),
    "Conv32F": ("Conv32F", dict(), (4, 1, 24, 30)),
    "Conv32F_flatten": ("Conv32F", dict(is_flatten=True), (4, 1, 24, 30)),
    "R2D2Embedding": ("R2D2Embedding", dict(), (4, 1, 24, 30)),
    "Conv64F_MCL": ("Conv64F_MCL", dict(), (4, 1, 32, 40)),
}


def jax_module(name, kwargs):
    kw = dict(kwargs, dtype=jnp.float32)
    if name == "Conv64F":
        return jconv.ConvNF(features=64, **kw)
    return {"Conv32F": jconv.Conv32F, "R2D2Embedding": jconv.R2D2Embedding,
            "Conv64F_MCL": jconv.Conv64FMCL}[name](**kw)


def port_module(name, kwargs, shape, dtype=torch.float32):
    extra = {"spec_shape": shape[1:]} if name == "Conv64F" else {}
    return BACKBONES.build(name, num_channels=shape[1], dtype=dtype, **kwargs, **extra)


def jax_variables(module, x, seed=1):
    init = jax.jit(lambda k, a: module.init(k, a, train=False))
    variables = init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    return randomize_batchnorm(jax.tree_util.tree_map(np.asarray, dict(variables)),
                               np.random.default_rng(seed))


_CACHE = {}


def case_setup(case):
    """The JAX module's variables, the input of ``case``, and the module's
    outputs with eval BN and with train BN (dropout off) and its train-mode
    batch statistics, from one compiled call (made once)."""
    if case not in _CACHE:
        name, kwargs, shape = CASES[case]
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        module = jax_module(name, kwargs)
        variables = jax_variables(module, x)

        def both(v, a):
            ref_eval = module.apply(v, a, train=False)
            ref_train, upd = module.apply(v, a, train=True, mutable=["batch_stats"],
                                          rngs={"dropout": jax.random.PRNGKey(2)})
            return ref_eval, ref_train, upd["batch_stats"]

        with pytest.MonkeyPatch.context() as mp:  # dropout off
            mp.setattr(flax_nn.Dropout, "__call__", lambda self, y, *a, **k: y)
            outs = jax.tree_util.tree_map(np.asarray, jax.jit(both)(variables, x))
        _CACHE[case] = (variables, x) + tuple(outs)
    return _CACHE[case]


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout made the identity in both packages."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, train, no_dropout):
    name, kwargs, shape = CASES[case]
    variables, x, ref_eval, ref_train, batch_stats = case_setup(case)
    model = port_module(name, kwargs, shape)
    model.load_state_dict(state_dict_from_jax(variables, name))
    model.train(train)
    out = model(torch.from_numpy(x))
    ref = ref_train if train else ref_eval
    assert out.dtype == torch.float32
    assert tuple(out.shape) == ref.shape
    assert _rel(out.detach().numpy(), ref) <= (TRAIN_TOL if train else EVAL_TOL)
    if train:
        stats = state_dict_from_jax({"params": variables["params"],
                                     "batch_stats": batch_stats}, name)
        n = 0
        for key, val in model.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(val.numpy(), stats[key].numpy(),
                                           rtol=STATS_TOL, atol=STATS_TOL, err_msg=key)
                n += 1
        assert n == 2 * (4 + int("logits_bn" in variables["params"]))


def test_flatten_order_is_nhwc_at_a_last_map_larger_than_one():
    """At [162, 170] Conv64F's last map is 2 × 2: the logits head sees the
    NHWC-flattened map, as in the JAX package (the reference flattens
    NCHW)."""
    shape = (2, 1, 162, 170)
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    module = jax_module("Conv64F", dict(is_flatten=True))
    variables = jax_variables(module, x)
    model = port_module("Conv64F", dict(is_flatten=True), shape).eval()
    model.load_state_dict(state_dict_from_jax(variables, "Conv64F"))
    assert model.pooled_hw(162, 170) == (2, 2) and model.logits[2].in_features == 64 * 4
    ref = np.asarray(jax.jit(lambda v, a: module.apply(v, a, train=False))(variables, x))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
        assert _rel(out, ref) <= EVAL_TOL
        # the same head over the NCHW-flattened map gives other logits
        maps = port_module("Conv64F", dict(is_flatten=False), shape).eval()
        maps.load_state_dict({k: v for k, v in model.state_dict().items()
                              if not k.startswith("logits")})
        chw = maps(torch.from_numpy(x)).reshape(2, -1)
        other = model.logits[2](model.logits[1](chw)).numpy()
    assert _rel(other, ref) > 1e-2


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_masked_batchnorm_matches_flax_mask(kind):
    """Batch statistics over the masked rows only, for the output and for
    the running-statistics update; the padded rows change no valid row."""
    rng = np.random.default_rng(4)
    shape = (6, 5, 4, 3) if kind == "2d" else (6, 5)
    x = (rng.normal(size=shape) * 2.0 + 1.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], bool)
    nhwc = x.transpose(0, 2, 3, 1) if kind == "2d" else x
    fmask = mask.reshape((-1,) + (1,) * (nhwc.ndim - 1))
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(nhwc))
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                            "bias": rng.normal(size=5).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(size=5).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}}
    ref, upd = bn.apply(variables, jnp.asarray(nhwc), mask=jnp.asarray(fmask),
                        mutable=["batch_stats"])
    ref = np.asarray(ref)
    if kind == "2d":
        ref = ref.transpose(0, 3, 1, 2)
    ours = (BatchNorm(5) if kind == "2d" else BatchNorm1d(5)).train()
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        ours.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        ours.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        ours.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    out = ours(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(out[mask], ref[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=STATS_TOL, atol=STATS_TOL)
    np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=STATS_TOL, atol=STATS_TOL)
    # the valid rows alone, unmasked, normalise the same
    alone = (BatchNorm(5) if kind == "2d" else BatchNorm1d(5)).train()
    alone.load_state_dict({k: v for k, v in ours.state_dict().items()})
    np.testing.assert_allclose(alone(torch.from_numpy(x[mask])).detach().numpy(), out[mask],
                               rtol=1e-5, atol=1e-5)
    # batch-statistics BN (no running statistics) takes the mask too; eval
    # with running statistics ignores it
    stat_free = BatchNorm(5, use_running_statistics=False) if kind == "2d" else \
        BatchNorm1d(5, use_running_statistics=False)
    stat_free.eval()
    np.testing.assert_allclose(stat_free(torch.from_numpy(x), torch.from_numpy(mask))
                               .detach().numpy()[mask],
                               stat_free(torch.from_numpy(x[mask])).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    ours.eval()
    torch.testing.assert_close(ours(torch.from_numpy(x), torch.from_numpy(mask)),
                               ours(torch.from_numpy(x)), rtol=0, atol=0)


def test_sample_mask_matches_jax_through_conv64f(no_dropout):
    """Batch-statistics Conv64F (the MAML family's mode) over a padded batch:
    the valid rows' outputs equal the JAX module's with ``sample_mask``."""
    shape = (5, 1, 81, 90)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], bool)
    kwargs = dict(is_flatten=True, use_running_statistics=False,
                  logits_bn_running_statistics=False)
    module = jax_module("Conv64F", kwargs)
    variables = jax_variables(module, x)
    ref = np.asarray(jax.jit(lambda v, a, m: module.apply(
        v, a, train=False, sample_mask=m, mutable=["batch_stats"])[0])(variables, x, mask))
    model = port_module("Conv64F", kwargs, shape).eval()
    state = state_dict_from_jax(variables, "Conv64F")
    model.load_state_dict({k: v for k, v in state.items()
                           if not k.endswith(("running_mean", "running_var", "tracked"))})
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert _rel(out[mask], ref[mask]) <= TRAIN_TOL


@pytest.mark.parametrize("case", ["Conv64F_flatten", "Conv64F_map", "Conv32F", "R2D2Embedding",
                                  "Conv64F_MCL"])
def test_converter_round_trips_through_the_jax_package(case):
    """JAX variables → the port's state dict (reference key names) → the JAX
    package's ``convert_backbone_state_dict`` gives the variables back, bit
    for bit; the keys are the port module's own."""
    name, kwargs, shape = CASES[case]
    variables = case_setup(case)[0]
    state = state_dict_from_jax(variables, name, prefix="emb_func.")
    ours = port_module(name, kwargs, shape).state_dict()
    assert {k[len("emb_func."):] for k in state} == set(ours)
    for key, val in state.items():
        assert tuple(val.shape) == tuple(ours[key[len("emb_func."):]].shape), key
    back = convert_backbone_state_dict({k: v.numpy() for k, v in state.items()}, name, variables)
    for col in ("params", "batch_stats"):
        flat_ref = jax.tree_util.tree_leaves_with_path(variables[col])
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert len(flat_ref) == len(flat_back)
        for path, leaf in flat_ref:
            np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))
    if name in ("Conv64F", "Conv32F"):  # the JAX package has these inverters
        ref = invert_backbone_params(variables, name)
        assert set(ref) == set(state)
        for key, val in ref.items():
            np.testing.assert_array_equal(state[key].numpy(), val, err_msg=key)
    if case == "Conv64F_flatten":
        assert {"layer1.0.weight", "layer1.1.running_mean", "logits.1.running_var",
                "logits.2.weight", "logits.2.bias"} <= set(ours)


@pytest.mark.parametrize("name, dropped", [
    ("Conv64F", {"is_bdc": True, "keep_prob": 0.9, "avg_pool": True}),
    ("Conv32F", {"last_pool": True, "maxpool_last2": False}),
])
def test_factories_drop_the_kwargs_the_jax_package_drops(name, dropped):
    kwargs = dict(dropped, is_flatten=True, leaky_relu=None)  # None: the YAML ~
    jax_factory = {"Conv64F": jconv.conv64f, "Conv32F": jconv.conv32f}[name]
    ref = jax_factory(**dict(kwargs))
    ours = BACKBONES.build(name, num_channels=1, **dict(kwargs))
    assert ours.is_flatten and ref.is_flatten and ref.leaky_relu is False
    with pytest.raises(TypeError):
        BACKBONES.build(name, num_channels=1, no_such_knob=1)


def test_too_small_an_input_pools_to_empty():
    """Conv64F pools three or four times by 3: below 81 on a side nothing is
    left, and both packages say so."""
    x = np.zeros((1, 1, 40, 90), np.float32)
    module = jax_module("Conv64F", dict(is_flatten=False))
    with pytest.raises(ValueError, match="empty tensor"):
        jax.eval_shape(lambda a: module.init(jax.random.PRNGKey(0), a, train=False), x)
    model = port_module("Conv64F", dict(is_flatten=False), (1, 1, 128, 157)).eval()
    with pytest.raises(ValueError, match="empty tensor"):
        model(torch.from_numpy(x))
    assert model(torch.zeros(1, 1, 81, 90)).shape == (1, 64, 1, 1)


def test_logits_head_is_sized_as_the_reference_at_the_shipped_geometry():
    model = port_module("Conv64F", dict(is_flatten=True), (1, 1, 128, 157))
    assert floor_power(128, 3, 4) == floor_power(157, 3, 4) == 1
    assert (model.logits[1].num_features, model.logits[2].in_features,
            model.logits[2].out_features) == (64, 64, 1600)


def test_bf16_blocks_give_float32_features():
    shape = (2, 1, 81, 90)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=shape).astype(np.float32))
    fp32 = port_module("Conv64F", dict(is_flatten=True), shape).eval()
    bf16 = port_module("Conv64F", dict(is_flatten=True), shape, dtype=torch.bfloat16).eval()
    bf16.load_state_dict(fp32.state_dict())
    with torch.no_grad():
        a, b = fp32(x), bf16(x)
    assert b.dtype == torch.float32 and all(p.dtype == torch.float32 for p in bf16.parameters())
    assert ((a - b).abs().max() / a.abs().max()).item() < 5e-2


def test_dropout_keeps_with_its_rate_and_scales_by_it():
    """Rate 0.3: keeps about 0.7 of the entries, scaled by 1/0.7; the same
    seed gives the same mask, another seed another; the identity in eval;
    the mask never comes from the global RNG."""
    drop = Dropout(0.3).train()
    x = torch.ones(200, 500)
    drop.reseed(11)
    torch.manual_seed(0)
    a = drop(x)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    drop.reseed(11)
    torch.manual_seed(123)  # the global RNG plays no part
    torch.testing.assert_close(drop(x), a, rtol=0, atol=0)
    drop.reseed(12)
    assert not torch.equal(drop(x) != 0, kept)
    assert torch.equal(drop.eval()(x), x)
    model = port_module("R2D2Embedding", {}, (1, 1, 24, 30))
    seed_dropout(model, 5)
    seeds = [m.seed for m in model.modules() if isinstance(m, Dropout)]
    assert len(seeds) == 2 and len(set(seeds)) == 2

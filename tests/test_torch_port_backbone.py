"""resnet12Bdc of the PyTorch port against the JAX module, at weights moved
across with ``utils.convert.state_dict_from_jax`` and random BatchNorm
running statistics (so the BN mapping is really exercised).  The planes are
fixed in both packages; only the spatial size (32×40) and the BDC width
(reduce_dim 8) are cut."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.models.backbones.resnet import ResNet12BDC as JaxResNet12BDC  # noqa: E402
from audio_fewshot_tpu.utils.torch_convert import invert_backbone_params  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.resnet import ResNet12BDC  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def xdist_torch_threads():
    """Under pytest-xdist, the host's cores shared out among its workers as
    torch CPU threads while a port test module runs (every port test module
    imports this fixture; ``test_torch_port_metric.py`` holds ADM's steps
    with float64 heads, since its float32 sums move with the thread count:
    its module docstring says which).  torch gives
    each process one OpenMP thread per core, so the workers' threads would
    outnumber the cores many times over and wait on each other: a Conv64F
    MAML eval forward that takes 3.4 s alone took 257 s in each of six such
    processes at once, and 6-8 s with one thread each (an 8-core host).  In
    one process the count stays torch's; it is restored after the module,
    so the JAX package's tests keep theirs."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
    yield
    torch.set_num_threads(before)


# float32 in both; 13 convolutions sum in another order than XLA's
RTOL, ATOL = 1e-4, 1e-5
SHAPE = (4, 1, 32, 40)


def randomize_batchnorm(tree, rng):
    """Non-trivial BN scale/bias (params) and mean/var (batch_stats)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = randomize_batchnorm(val, rng)
            continue
        val = np.asarray(val)
        if key in ("scale", "var"):
            val = rng.uniform(0.5, 1.5, size=val.shape).astype(np.float32)
        elif key in ("bias", "mean"):
            val = rng.normal(0.0, 0.2, size=val.shape).astype(np.float32)
        out[key] = val
    return out


@pytest.fixture(scope="module")
def jax_model():
    module = JaxResNet12BDC(reduce_dim=8, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)
    variables = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, dict(variables)),
                                    np.random.default_rng(1))
    return module, variables, x


def test_state_dict_keys_are_the_reference_names(jax_model):
    _, variables, _ = jax_model
    ours = ResNet12BDC(reduce_dim=8).state_dict()
    converted = state_dict_from_jax(variables, "resnet12Bdc")
    assert set(converted) == set(ours)
    for key in ("layer1.0.conv1.weight", "layer1.0.bn1.running_mean",
                "layer4.0.downsample.0.weight", "bdc_pool.conv_dr_block.0.weight",
                "bdc_pool.conv_dr_block.1.running_var", "bdc_pool.temperature"):
        assert key in ours
    for key, val in converted.items():
        assert tuple(val.shape) == tuple(ours[key].shape), key


def test_converter_matches_the_jax_package_inverter(jax_model):
    _, variables, _ = jax_model
    ours = state_dict_from_jax(variables, "resnet12Bdc", prefix="emb_func.")
    ref = invert_backbone_params(variables, "resnet12Bdc")
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)


def test_features_match_jax_in_fp32(jax_model):
    module, variables, x = jax_model
    ref = np.asarray(module.apply(variables, jnp.asarray(x), train=False))
    model = ResNet12BDC(reduce_dim=8, dtype=torch.float32).eval()
    model.load_state_dict(state_dict_from_jax(variables, "resnet12Bdc"))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (SHAPE[0], 8 * 9 // 2)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_bf16_backbone_feeds_an_fp32_head(jax_model):
    _, variables, x = jax_model
    state = state_dict_from_jax(variables, "resnet12Bdc")
    fp32 = ResNet12BDC(reduce_dim=8, dtype=torch.float32).eval()
    bf16 = ResNet12BDC(reduce_dim=8, dtype=torch.bfloat16).eval()
    fp32.load_state_dict(state)
    bf16.load_state_dict(state)
    seen = []
    bf16.bdc_pool.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    with torch.no_grad():
        a = fp32(torch.from_numpy(x))
        b = bf16(torch.from_numpy(x))
    assert seen == [torch.bfloat16]  # the head upcasts its input itself
    assert b.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    # bf16 keeps ~3 significant digits through 12 convolutions
    assert ((a - b).abs().max() / a.abs().max()).item() < 5e-2


def test_training_mode_runs_dropblock_and_eval_ignores_it():
    """Train mode with drop_rate > 0: Dropout after stages 1-2, DropBlock
    after stages 3-4 with its ramp counter counting the forward
    (``test_torch_port_resnet12.py`` holds both against the JAX package);
    eval is deterministic and leaves the counter alone."""
    model = ResNet12BDC(reduce_dim=8, drop_rate=0.1, dtype=torch.float32)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    assert model(x).shape == (SHAPE[0], 36)
    assert [int(model.layer3[0].num_batches_tracked), int(model.layer4[0].num_batches_tracked)] \
        == [1, 1]
    model.eval()
    with torch.no_grad():
        a, b = model(x), model(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(model.layer4[0].num_batches_tracked) == 1

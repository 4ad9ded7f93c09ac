"""The CNN backbones of the port's slice 12 against the JAX package on the
CPU: resnet18, resnet18Bdc, WRN, resnet12_mcl, resnet12_r2d2 and
resnet12MTLofficial, at weights drawn with numpy for the JAX package's
trees (``test_torch_port_meta2.draw_tree``: kernels N(0, 1/fan_in)), with
random BN scales, biases and statistics, and for resnet12MTLofficial random
``MtlConv`` scales and shifts, carried across by
``utils.convert.state_dict_from_jax``.

Sizes: ``[1, 48, 60]`` segments (resnet18Bdc's map 3 × 4; resnet12MTL-
official on ``[1, 24, 88]``, whose pooled map [640, 1, 2] tells the NCHW
flatten from the NHWC one), WRN at depth 10, widen 2, the dense resnet12s at
planes 8/12/16/20; resnet18's, resnet18Bdc's and resnet12MTLofficial's
widths are fixed by their registrations.

Tolerances:
- float32 forwards, eval and train mode (batch statistics; the running
  statistics after the call too): 1e-5 of the output's max abs
  (``FORWARD_TOL``);
- the gradients of Σ out·r (train mode) in float32 against the JAX
  package's float64 backbone (its float32 one-pass BN variance is not the
  reference, ROADMAP Queue C): 1e-4 (``GRAD_TOL``) of each gradient's max
  abs, or of a tenth of the largest gradient's where a gradient is smaller
  (a bias before a train-mode BN has a gradient that is zero in exact
  arithmetic);
  resnet12MTLofficial's gradients are held with the port in float64: at
  these weights its float32 train-mode gradients are ill-conditioned (13
  train-mode BNs over three segments; the port's float32 ones 1.9e-2, the
  JAX package's own float32 ones 2.3e-2 of the largest from float64, where
  the port in float64 is 7e-14 from it; ROADMAP Queue C);
- the converter's round trip (``state_dict_from_jax`` then the JAX
  package's ``convert_backbone_state_dict``): exact.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.models.backbones.resnet import MtlConv as JaxMtlConv  # noqa: E402
from audio_fewshot_tpu.registry import BACKBONES as JAX_BACKBONES  # noqa: E402
from audio_fewshot_tpu.utils.torch_convert import convert_backbone_state_dict  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.resnet import MtlConv  # noqa: E402
from audio_fewshot_tpu_torch.registry import BACKBONES  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_meta2 import draw_tree  # noqa: E402

FORWARD_TOL = 1e-5
GRAD_TOL = 1e-4
SPEC = (1, 48, 60)
_DENSE = {"planes": (8, 12, 16, 20)}
# name: (kwargs of both packages, segment shape)
FAMILIES = {
    "resnet18": ({}, SPEC),
    "resnet18Bdc": ({"reduce_dim": 8}, SPEC),
    "WRN": ({"depth": 10, "widen_factor": 2}, SPEC),
    "resnet12_mcl": (_DENSE, SPEC),
    "resnet12_r2d2": (_DENSE, SPEC),
    "resnet12MTLofficial": ({}, (1, 24, 88)),
}
N = 3
# families whose float32 train-mode gradients are ill-conditioned at these
# weights (the module docstring): the port's gradients in float64
FLOAT64_GRADIENTS = ("resnet12MTLofficial",)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _inputs(name, seed=0):
    return np.random.default_rng(seed).normal(size=(N,) + FAMILIES[name][1]).astype(np.float32)


def _jax_module(name, dtype=jnp.float32):
    return JAX_BACKBONES.build(name, dtype=dtype, **FAMILIES[name][0])


def _mtl_draws(tree, rng):
    """Random ``MtlConv`` scales around 1 and shifts (``draw_tree`` gives
    scales N(0, 1/I) and zero shifts)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _mtl_draws(val, rng)
        elif key == "mtl_scale":
            out[key] = rng.uniform(0.5, 1.5, size=val.shape).astype(np.float32)
        elif key == "mtl_bias":
            out[key] = rng.normal(0.0, 0.2, size=val.shape).astype(np.float32)
        else:
            out[key] = val
    return out


@functools.lru_cache(maxsize=None)
def jax_variables(name):
    """The JAX backbone's tree (its shapes from a traced ``init``) drawn with
    numpy, with random BN parameters and statistics and MtlConv scales and
    shifts."""
    x = jnp.asarray(_inputs(name)[:1])
    shapes = jax.eval_shape(lambda k: _jax_module(name).init(k, x, train=True),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, draw_tree(shapes, np.random.default_rng(0)))
    tree = randomize_batchnorm(dict(tree), np.random.default_rng(1))
    return _mtl_draws(tree, np.random.default_rng(2))


def port_backbone(name, **kw):
    model = BACKBONES.build(name, dtype=torch.float32, **FAMILIES[name][0], **kw)
    model.load_state_dict(state_dict_from_jax(jax_variables(name), name))
    return model


@functools.lru_cache(maxsize=None)
def jax_forward(name, train):
    """The JAX module's float32 output (and, in train mode, its updated
    batch statistics)."""
    module, variables = _jax_module(name), jax_variables(name)
    x = _inputs(name)
    if not train:
        return np.asarray(jax.jit(lambda v, xx: module.apply(v, xx, train=False))(variables, x)), None
    out, upd = jax.jit(lambda v, xx: module.apply(v, xx, train=True, mutable=["batch_stats"]))(
        variables, x)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, upd["batch_stats"])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_matches_jax(name, train):
    """The output of the same weights in eval and in train mode, its shape
    against ``map_shape`` / ``feature_dim``; in train mode the running
    statistics after the call against the JAX package's update."""
    ref, stats = jax_forward(name, train)
    model = port_backbone(name).train(train)
    with torch.no_grad():
        ours = model(torch.from_numpy(_inputs(name))).numpy()
    assert ours.shape == ref.shape
    assert _rel(ours, ref) <= FORWARD_TOL
    spec = FAMILIES[name][1]
    assert ours[0].size == model.feature_dim(spec)
    if hasattr(model, "map_shape") and ours.ndim == 4:
        assert ours.shape[1:] == tuple(model.map_shape(spec))
    if train:
        expected = state_dict_from_jax({"params": jax_variables(name)["params"],
                                        "batch_stats": stats}, name)
        running = {k: v for k, v in model.state_dict().items()
                   if k.endswith(("running_mean", "running_var"))}
        assert running
        for key, val in running.items():
            assert _rel(val.numpy(), expected[key].numpy()) <= FORWARD_TOL, key


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def jax_gradients(name):
    """The gradients of Σ out·r in train mode through the JAX package's
    float64 backbone, and r."""
    x = _inputs(name)
    ref, _ = jax_forward(name, True)
    r = np.random.default_rng(5).normal(size=ref.shape)
    variables = _f64(jax_variables(name))
    with jax.enable_x64(True):
        module = _jax_module(name, jnp.float64)

        def objective(params):
            out, _ = module.apply({**variables, "params": params}, x.astype(np.float64),
                                  train=True, mutable=["batch_stats"])
            return jnp.sum(out * r)

        grads = jax.jit(jax.grad(objective))(variables["params"])
    return jax.tree_util.tree_map(np.asarray, grads), r


@pytest.mark.parametrize("name", list(FAMILIES))
def test_gradients_match_a_float64_jax_backbone(name):
    """Every parameter's gradient of the float32 port (float64 for
    ``FLOAT64_GRADIENTS``) against the float64 JAX backbone;
    resnet12MTLofficial's frozen kernels get none in the port
    and zeros in the JAX package (``stop_gradient``)."""
    grads, r = jax_gradients(name)
    expected = state_dict_from_jax({"params": grads,
                                    "batch_stats": jax_variables(name)["batch_stats"]}, name)
    dtype = torch.float64 if name in FLOAT64_GRADIENTS else torch.float32
    model = port_backbone(name).to(dtype).train()
    model.dtype = dtype
    out = model(torch.from_numpy(_inputs(name)).to(dtype))
    (out.double() * torch.from_numpy(r)).sum().backward()
    params = dict(model.named_parameters())
    largest = max(np.abs(expected[k].numpy()).max() for k in params)
    checked = 0
    for key, param in params.items():
        ref = expected[key].numpy()
        if param.grad is None:
            assert key.endswith(".weight") and name == "resnet12MTLofficial", key
            assert not np.any(ref), key
            continue
        scale = max(np.abs(ref).max(), 0.1 * largest)
        err = np.abs(param.grad.numpy().astype(np.float64) - ref).max() / scale
        assert err <= GRAD_TOL, (key, err)
        checked += 1
    assert checked >= len(params) // 2


@pytest.mark.parametrize("name", list(FAMILIES))
def test_converter_round_trip(name):
    """JAX tree → ``state_dict_from_jax`` → the JAX package's
    ``convert_backbone_state_dict`` gives the tree back, and the state dict
    holds exactly the port's keys.  resnet12MTLofficial's block
    convolutions have no reference shift (the reference's bias-free
    ``Conv2dMtl``): the JAX package's converter sets them to 0, so the tree
    is held with those shifts at 0 (the stem's goes through ``bias`` +
    ``mtl_bias``)."""
    variables = jax.tree_util.tree_map(np.copy, jax_variables(name))
    if name == "resnet12MTLofficial":
        for key, block in variables["params"].items():
            for conv in block.values() if key.startswith("layer") else ():
                if "mtl_bias" in conv:
                    conv["mtl_bias"][:] = 0.0
    state = state_dict_from_jax(variables, name)
    model = BACKBONES.build(name, dtype=torch.float32, **FAMILIES[name][0])
    assert set(state) == set(model.state_dict())
    back = convert_backbone_state_dict({k: v.numpy() for k, v in state.items()}, name,
                                       variables)
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, val in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_out[path]), val,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("layer", [0, 2])
def test_resnet18_mixup_hook_matches_jax(layer):
    """The manifold-mixup hook: at ``mixup_layer`` k the state after stage k
    (0: the input) becomes λ·h + (1 − λ)·h[index], eval mode."""
    module, variables = _jax_module("resnet18"), jax_variables("resnet18")
    x = _inputs("resnet18")
    lam, index = np.float32(0.3), np.array([2, 0, 1])
    ref = jax.jit(lambda v, xx: module.apply(v, xx, train=False, mixup_lam=lam,
                                             mixup_index=index, mixup_layer=layer))(variables, x)
    plain = jax_forward("resnet18", False)[0]
    model = port_backbone("resnet18").eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x), mixup_lam=torch.tensor(lam),
                     mixup_index=torch.from_numpy(index), mixup_layer=layer).numpy()
    assert _rel(ours, np.asarray(ref)) <= FORWARD_TOL
    assert _rel(ours, plain) > 1e-2  # the hook mixed


def test_mtl_conv_kernel_takes_no_gradient():
    """``MtlConv``'s kernel enters the product detached: no gradient reaches
    it (the JAX package's ``stop_gradient``: zeros); the scale's and the
    shift's gradients are the JAX package's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 6, 7)).astype(np.float32)
    conv = JaxMtlConv(4, (3, 3))
    variables = jax.tree_util.tree_map(np.asarray, conv.init(
        jax.random.PRNGKey(0), jnp.asarray(x.transpose(0, 2, 3, 1))))
    variables["params"]["mtl_scale"] = rng.uniform(0.5, 1.5, (1, 1, 5, 4)).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(conv.apply({"params": p}, x.transpose(0, 2, 3, 1)) ** 2))(
        variables["params"])
    ours = MtlConv(5, 4)
    p = variables["params"]
    ours.load_state_dict({"weight": torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1).copy()),
                          "mtl_weight": torch.from_numpy(p["mtl_scale"].transpose(3, 2, 0, 1).copy()),
                          "mtl_bias": torch.from_numpy(np.array(p["mtl_bias"]))})
    (ours(torch.from_numpy(x)) ** 2).sum().backward()
    assert ours.weight.grad is None
    assert not np.any(np.asarray(grads["kernel"]))
    ref_scale = np.asarray(grads["mtl_scale"]).transpose(3, 2, 0, 1)
    assert _rel(ours.mtl_weight.grad.numpy(), ref_scale) <= FORWARD_TOL
    assert _rel(ours.mtl_bias.grad.numpy(), np.asarray(grads["mtl_bias"])) <= FORWARD_TOL


def test_mtl_official_flattens_nchw():
    """resnet12MTLofficial flattens its pooled [640, 1, 2] map in NCHW
    order (as the reference, unlike resnet12's NHWC); the two orders
    differ."""
    model = port_backbone("resnet12MTLofficial").eval()
    x = torch.from_numpy(_inputs("resnet12MTLofficial"))
    with torch.no_grad():
        flat = model(x)
        h = torch.relu(model.bn1(model.conv1(x)))
        h = torch.nn.functional.avg_pool2d(model.layer3(model.layer2(model.layer1(h))), (3, 10),
                                           stride=1)
    assert h.shape == (N, 640, 1, 2)
    torch.testing.assert_close(flat, h.reshape(N, -1), rtol=0, atol=0)
    assert not torch.allclose(flat, h.permute(0, 2, 3, 1).reshape(N, -1))


# the chip's phase-22 cells: (the backbone swapped in, its features at [1, 128, 157])
CHIP_CELLS = {
    "DeepBDC:resnet18Bdc": ("resnet18Bdc", 2080),
    "MCL:resnet12_mcl": ("resnet12_mcl", 640 * 8 * 9),
    "R2D2:resnet12_r2d2": ("resnet12_r2d2", 640),
    "MTL:resnet12MTLofficial": ("resnet12MTLofficial", 640 * 7 * 11),
    "S2M2:resnet18": ("resnet18", 512),
    "ProtoNet:WRN": ("WRN", 640),
}


@pytest.mark.parametrize("cell", list(CHIP_CELLS))
def test_chip_cells_swap_only_the_backbone(cell):
    """``chip_smoke.py``'s phase-22 cells are the shipped head's cell with the
    backbone swapped at its defaults (and WRN's and resnet12MTLofficial's
    fewer episodes a step); the backbone's feature width at the full
    ``[1, 128, 157]`` is the one the smoke prints."""
    from audio_fewshot_tpu_torch.eval import slice_config

    head = cell.partition(":")[0]
    backbone, width = CHIP_CELLS[cell]
    ours, shipped = slice_config(classifier=cell), slice_config(classifier=head)
    differ = {k for k in set(ours) | set(shipped) if ours.get(k) != shipped.get(k)}
    assert differ <= {"backbone", "tag", "test_episode_size"}
    assert ours["backbone"] == {"name": backbone, "kwargs": {
        "num_channels": 1, **({"reduce_dim": 64} if backbone == "resnet18Bdc" else {})}}
    assert ours["test_episode_size"] == {"WRN": 4, "resnet12MTLofficial": 8}.get(backbone, 16)
    with torch.device("meta"):  # the full-width module's shapes, no weights drawn
        model = BACKBONES.build(backbone)
    assert model.feature_dim((1, 128, 157)) == width

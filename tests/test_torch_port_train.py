"""The training pieces of the PyTorch port against the JAX package on the CPU:
the BDC backward, one DeepBDC/resnet12Bdc train step (loss, every gradient,
the BatchNorm running statistics), Adam steps, the optimizers on given
gradients against optax, the LR schedule of every shipped config, train
batches, train-mode BatchNorm, and the import rule for the new modules.

Precision.  Both packages run in float32 (the JAX build with ``precision:
fp32``).  Float32 gradient noise grows as it crosses the chain of
train-mode BatchNorms (flax computes the batch variance in one pass,
``E[x²] − E[x]²``, torch in two), so the train step is also compared with
the backbone in float64 in both packages (the BDC head stays float32 in
both, as the JAX package fixes it), which isolates the port's arithmetic
from float32 noise.  The BDC gradient itself carries ~1e-5..4e-5 of float32
noise in either package (it divides by D = sqrt(t·dist² + 1e-5)), so both
are held against float64 at 5e-5, and against each other at 1e-4."""

import ast
import copy
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402,F401  (the JAX package's optimizers are optax chains)
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.data.dataset import SpectrogramDataset as JaxDataset  # noqa: E402
from audio_fewshot_tpu.data.loader import EpisodicLoader as JaxLoader  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.ops.bdc import bdc_pool as jax_bdc_pool  # noqa: E402
from audio_fewshot_tpu.ops.bdc import triuvec as jax_triuvec  # noqa: E402
from audio_fewshot_tpu.optim import Optimizer as JaxOptimizer  # noqa: E402
from audio_fewshot_tpu.optim import build_scheduler as jax_build_scheduler  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.data.dataset import SpectrogramDataset  # noqa: E402
from audio_fewshot_tpu_torch.data.loader import EpisodicLoader  # noqa: E402
from audio_fewshot_tpu_torch.episode import materialize_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method, train_setting  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.layers import BatchNorm  # noqa: E402
from audio_fewshot_tpu_torch.ops import bdc_cuda  # noqa: E402
from audio_fewshot_tpu_torch.ops.bdc import (  # noqa: E402
    bdc_pool_triu_vjp, bdc_pool_triu_vjp_cluster, bdc_pool_triu_vjp_direct, round_tf32,
    triu_indices_flat, truncate_tf32)
from audio_fewshot_tpu_torch.optim import Optimizer, build_scheduler  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4       # relative to the gradient's max abs
STATS_TOL = 1e-5      # BN running statistics, rtol and atol
BDC_F64_TOL = 5e-5    # float32 BDC gradient against float64, either package


def train_config(**over):
    cfg = {
        "classifier": {"name": "DeepBDC", "kwargs": None},
        "backbone": {"name": "resnet12Bdc",
                     "kwargs": {"num_channels": 1, "reduce_dim": 8, "fused_bdc": False}},
        "data_root": "synthetic:10:12", "spec_shape": [1, 16, 20],
        "way_num": 5, "shot_num": 2, "query_num": 2, "train_episode": 3,
        "precision": "fp32", "seed": 0, "prefetch": 0,
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.005}, "other": None},
    }
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


# -- the BDC backward ----------------------------------------------------------

def _bdc_input(kind, shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if kind == "post_relu":
        x = np.maximum(x - 0.5, 0.0)
    elif kind == "duplicate_rows":
        x[:, 1] = x[:, 0]
        x[:, 3] = x[:, 2]
    elif kind == "zero_rows":  # dead ReLU channels
        x = np.maximum(x, 0.0)
        x[:, 0] = 0.0
        x[:, 5] = 0.0
    return x


@pytest.mark.parametrize("shape", [(4, 8, 20), (2, 64, 304)], ids=["small", "main_path"])
@pytest.mark.parametrize("kind", ["normal", "post_relu", "duplicate_rows", "zero_rows"])
def test_bdc_backward_matches_jax_grad(kind, shape):
    x = _bdc_input(kind, shape, 0)
    log_t = np.float32(np.log(1.0 / (2.0 * shape[2])))
    d = shape[1]
    ct = np.random.default_rng(1).normal(size=(shape[0], d * (d + 1) // 2)).astype(np.float32)
    ref_x, ref_t = jax.grad(
        lambda a, lt: jnp.sum(jax_triuvec(jax_bdc_pool(a, lt)) * ct), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(log_t))
    xt, lt = torch.from_numpy(x), torch.tensor([[log_t]])
    ours_x, ours_t = bdc_cuda.bdc_pool_triu_backward(xt, lt, torch.from_numpy(ct))
    assert ours_x.shape == shape and ours_t.shape == (1, 1)
    # the same as autograd through the forward wrapper on the CPU
    xg, lg = xt.clone().requires_grad_(), lt.clone().requires_grad_()
    (bdc_cuda.bdc_pool_triu(xg, lg) * torch.from_numpy(ct)).sum().backward()
    torch.testing.assert_close(xg.grad, ours_x, rtol=0, atol=0)
    torch.testing.assert_close(lg.grad, ours_t, rtol=0, atol=0)
    truth_x, truth_t = bdc_pool_triu_vjp(xt.double(), lt.double(), torch.from_numpy(ct).double())
    truth_t = float(truth_t)
    ours_x, ours_t = ours_x.numpy(), float(ours_t)
    ref_x, ref_t = np.asarray(ref_x), float(ref_t)
    for grad_x, grad_t in ((ours_x, ours_t), (ref_x, ref_t)):
        assert _rel(grad_x, truth_x.numpy()) <= BDC_F64_TOL
        assert abs(grad_t - truth_t) <= BDC_F64_TOL * abs(truth_t)
    assert _rel(ours_x, ref_x) <= 2 * BDC_F64_TOL
    assert abs(ours_t - ref_t) <= 2 * BDC_F64_TOL * abs(ref_t)
    if kind == "zero_rows":  # a dead channel gets a gradient all the same
        assert np.abs(ours_x[:, 0]).max() > 0


def _adversarial_bdc_input(kind, shape, g):
    """The five inputs of the backward's float64 gate, made with ``g``."""
    x = torch.randn(shape, generator=g)
    if kind == "post_relu":
        x = torch.relu(x - 0.5)
    elif kind == "zero_rows":
        x = torch.relu(x)
        x[:, 0] = 0.0
        x[:, 9] = 0.0
    elif kind == "near_duplicate_rows":
        x[:, 1] = x[:, 0]
        x[:, 3] = x[:, 2] * (1.0 + 1e-4)
        x[:, 5] = x[:, 4] + 1e-3 * torch.randn(x[:, 4].shape, generator=g)
    elif kind == "times_30":
        x = x * 30.0
    return x


EMULATIONS = {"direct": bdc_pool_triu_vjp_direct, "cluster": bdc_pool_triu_vjp_cluster}


@pytest.mark.parametrize("kind", ["normal", "post_relu", "zero_rows", "near_duplicate_rows",
                                  "times_30"])
@pytest.mark.parametrize("shape", [(3, 64, 304), (3, 16, 45), (3, 100, 77), (3, 128, 33)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("emulation", sorted(EMULATIONS))
def test_backward_kernel_arithmetic_against_float64(emulation, shape, kind):
    """The backward kernel's arithmetic (``bdc_pool_triu_vjp_cluster``:
    distances from row differences summed per column slice of a cluster
    block (3 slices, none of these M a multiple of 3 x 4), x̄ from
    x_i − x_j, Dsym and the log_t terms in float64; ``_direct``: one slice)
    is the gradient (float64: 1e-10) and keeps float32 within 1e-5 of
    float64 even where the plain autograd version, through the gram, is far
    off: rows equal to 1e-4, whose distance the gram's rounding swamps, and
    inputs ×30."""
    g = torch.Generator().manual_seed(3)
    x = _adversarial_bdc_input(kind, shape, g)
    d, m = shape[1], shape[2]
    log_t = torch.full((1, 1), float(np.log(1.0 / (2.0 * m))))
    ct = torch.randn((shape[0], d * (d + 1) // 2), generator=g)
    fn = EMULATIONS[emulation]
    truth_x, truth_t = bdc_pool_triu_vjp(x.double(), log_t.double(), ct.double())
    ident_x, ident_t = fn(x.double(), log_t.double(), ct.double())
    assert _rel(ident_x, truth_x) <= 1e-10 and _rel(ident_t, truth_t) <= 1e-10
    ours_x, ours_t = fn(x, log_t, ct)
    assert ours_x.dtype == torch.float32 and ours_t.shape == (1, 1)
    assert _rel(ours_x, truth_x) <= 1e-5 and _rel(ours_t, truth_t) <= 1e-5
    plain_x, _ = bdc_pool_triu_vjp(x, log_t, ct)
    assert _rel(ours_x, truth_x) < _rel(plain_x, truth_x)


def _tensor_core_product(x, s):
    """2 (r ⊙ x̃ − S x̃) with r = S 1 and x̃ = x − mean row, S x̃ by the
    three-pass split-TF32 mma (``hi = round_tf32``, ``lo = truncate_tf32``,
    per k-step of 8: hi·lo, lo·hi, hi·hi into one float32 accumulator)."""
    xc = x - x.mean(dim=0, keepdim=True)
    s_hi, x_hi = round_tf32(s), round_tf32(xc)
    s_lo, x_lo = truncate_tf32(s - s_hi), truncate_tf32(xc - x_hi)
    prod = torch.zeros_like(xc)
    for k in range(0, s.shape[0], 8):
        ks = slice(k, k + 8)
        prod = prod + s_hi[:, ks] @ x_lo[ks]
        prod = prod + s_lo[:, ks] @ x_hi[ks]
        prod = prod + s_hi[:, ks] @ x_hi[ks]
    return 2.0 * (s.sum(dim=1, keepdim=True) * xc - prod)


def test_tensor_core_product_misses_the_float64_gate():
    """Why the backward kernel's product stays on the CUDA cores: the
    tensor-core form diag(S 1) x̃ − S x̃ cancels in float32 where S is large,
    at nearly equal rows, and at d = 16 misses the 1e-5 gate that the
    difference form Σ_j S_ij (x_i − x_j) keeps by far (same S, same input)."""
    g = torch.Generator().manual_seed(3)
    x = _adversarial_bdc_input("near_duplicate_rows", (3, 16, 45), g)
    log_t = torch.full((1, 1), float(np.log(1.0 / 90.0)))
    ct = torch.randn((3, 16 * 17 // 2), generator=g)
    truth_x, _ = bdc_pool_triu_vjp(x.double(), log_t.double(), ct.double())
    # S as the kernel forms it: float32 distances, Dsym in float64
    t = float(np.exp(log_t.item()))
    full = torch.zeros((3, 16 * 16))
    full[:, torch.from_numpy(triu_indices_flat(16))] = ct
    full = full.reshape(3, 16, 16).double()
    ysym = full + full.mT
    rows = ysym.sum(-1)
    dsym = ysym - (rows[:, :, None] + rows[:, None, :]) / 16 + (rows.sum(-1) / 256)[:, None, None]
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist2 = (diff * diff).sum(-1)
    q = torch.where(dist2 > 0, t / (2.0 * torch.sqrt(t * dist2 + 1e-5)), torch.zeros_like(dist2))
    s = (dsym * q.double()).float()
    tensor_core = torch.stack([_tensor_core_product(x[i], s[i]) for i in range(3)])
    difference = 2.0 * (s[:, :, :, None] * diff).sum(dim=2)
    assert _rel(difference, truth_x) <= 1e-6
    assert _rel(tensor_core, truth_x) > 1e-5  # the gate it misses (measured 2.2e-5)


@pytest.mark.parametrize("shape", [(3, 64, 304), (3, 16, 45)], ids=lambda s: "x".join(map(str, s)))
def test_jax_grad_error_on_near_duplicate_rows_beside_the_ports(shape):
    """Where the two packages' training gradients part: on rows equal to
    within 1e-4, ``jax.grad`` of the JAX package's ``bdc_pool`` (XLA's
    autodiff through the gram, its training gradient) is far from float64,
    as the port's plain version is (the same arithmetic; the CPU path of
    ``bdc_pool_triu_backward``), while the kernel's arithmetic keeps the
    1e-5 gate.  Measured x̄ errors, relative to the max abs (jax.grad /
    plain / kernel): 1.56e-3 / 1.56e-3 / 2.5e-7 at (3, 64, 304), 9.1e-3 /
    9.1e-3 / 1.0e-7 at (3, 16, 45)."""
    g = torch.Generator().manual_seed(3)
    x = _adversarial_bdc_input("near_duplicate_rows", shape, g)
    d, m = shape[1], shape[2]
    lt = torch.full((1, 1), float(np.log(1.0 / (2.0 * m))))
    ct = torch.randn((shape[0], d * (d + 1) // 2), generator=g)
    truth_x, _ = bdc_pool_triu_vjp(x.double(), lt.double(), ct.double())
    ref_x = jax.grad(lambda a: jnp.sum(jax_triuvec(jax_bdc_pool(a, lt.numpy()[0, 0])) * ct.numpy()))(
        jnp.asarray(x.numpy()))
    jax_err = _rel(np.asarray(ref_x), truth_x)
    plain_err = _rel(bdc_cuda.bdc_pool_triu_backward(x, lt, ct)[0], truth_x)
    kernel_err = _rel(bdc_pool_triu_vjp_cluster(x, lt, ct)[0], truth_x)
    assert kernel_err <= 1e-5
    assert jax_err > 1e-3 and plain_err > 1e-3  # both far outside the gate
    assert plain_err == pytest.approx(jax_err, rel=0.05)


def test_bdc_backward_wrapper_counts_only_kernel_launches(monkeypatch):
    monkeypatch.setattr(bdc_cuda, "backward_launches", 0)
    x = torch.randn(2, 8, 6)
    bdc_cuda.bdc_pool_triu_backward(x, torch.zeros((1, 1)), torch.ones(2, 36))
    assert bdc_cuda.backward_launches == 0
    with pytest.raises(ValueError, match="cpu or cuda"):
        bdc_cuda.bdc_pool_triu_backward(x.to("meta"), torch.zeros((1, 1), device="meta"),
                                        torch.ones(2, 36, device="meta"))
    source = bdc_cuda.BACKWARD_SOURCE.read_text()
    assert 'extern "C" int bdc_pool_backward_launch' in source
    assert "atomic" not in source.replace("No atomics", "").replace("no atomics", "")


# -- train batches -------------------------------------------------------------

def test_train_batches_match_jax_payload_and_bank():
    """Dense train episodes (one random segment per clip, support clips
    drawn augment_times times) from the same seed in both packages, the
    bank-index form giving the same payload."""
    kwargs = dict(num_classes=6, clips_per_class=5, segment_shape=(1, 4, 6),
                  max_segments=4, seed=3)
    ours_ds, ref_ds = SpectrogramDataset.synthetic(**kwargs), JaxDataset.synthetic(**kwargs)
    geo = dict(way=3, shot=1, query=2, episodes_per_epoch=4, episode_size=2,
               mode="train", seed=9, prefetch=0, augment_times=2)
    ours, ref = EpisodicLoader(ours_ds, **geo), JaxLoader(ref_ds, **geo)
    indexed = EpisodicLoader(SpectrogramDataset.synthetic(**kwargs), **geo)
    indexed.use_segment_bank()
    bank = torch.from_numpy(np.ascontiguousarray(indexed.dataset.segment_bank()[0]))
    assert len(ours) == len(ref) == 2
    for epoch in (0, 1):
        for a, b, c in zip(ours.epoch(epoch), ref.epoch(epoch), indexed.epoch(epoch), strict=True):
            for field in ("support", "query", "query_clip", "query_mask", "support_target",
                          "query_target", "global_target"):
                np.testing.assert_array_equal(getattr(a, field), np.asarray(getattr(b, field)))
            assert a.query.shape == (2, 6, 1, 4, 6) and a.support.shape == (2, 6, 1, 4, 6)
            m = materialize_episode_batch(c.to("cpu"), bank)
            np.testing.assert_array_equal(m.support.numpy(), a.support)
            np.testing.assert_array_equal(m.query.numpy(), a.query)


def test_train_loader_config_surface():
    cfg = train_config(train_episode=6, episode_size=2, test_episode_size=5)
    (loader,) = get_dataloader(cfg, "train")
    assert loader.mode == "train" and len(loader) == 3 and loader.episode_size == 2
    with pytest.raises(NotImplementedError, match="dataloader_num"):
        get_dataloader(train_config(dataloader_num=2), "train")


# -- one train step --------------------------------------------------------------

@pytest.fixture(scope="module")
def step_setup():
    """The JAX method with randomized BatchNorm, its first train batch, and
    the port's method at the same weights, with the same batch."""
    cfg = train_config()
    setting = train_setting(cfg)
    jax_method = jax_build_method(cfg)
    jax_batch = next(iter(jax_get_dataloader(cfg, "train")[0].epoch(0)))
    variables = jax_method.init_variables(jax.random.PRNGKey(0), jax_batch, setting)
    variables = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, variables),
                                    np.random.default_rng(1))
    batch = next(iter(get_dataloader(cfg, "train")[0].epoch(0)))
    np.testing.assert_array_equal(batch.support, np.asarray(jax_batch.support))
    np.testing.assert_array_equal(batch.query, np.asarray(jax_batch.query))
    return cfg, setting, jax_method, variables, jax_batch, batch


def _jax_step(jax_method, variables, batch, setting):
    non_params = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        return jax_method.loss({**non_params, "params": params}, batch, setting,
                               jax.random.PRNGKey(1))

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    grads = jax.tree_util.tree_map(np.asarray, grads)
    stats = jax.tree_util.tree_map(np.asarray, out.updates["batch_stats"])
    return float(loss), float(out.metrics["acc"]), grads, stats


def _port_method(cfg, variables, backbone_dtype=torch.float32):
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(variables, "resnet12Bdc", prefix="emb_func."))
    if backbone_dtype != torch.float32:
        emb = method.emb_func
        emb.dtype = backbone_dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(backbone_dtype)
    return method.train()


def _as_port(variables, params=None, stats=None):
    """A JAX params (gradients) or batch_stats tree, the rest from
    ``variables``, under the port's state-dict names."""
    tree = {"params": params if params is not None else variables["params"],
            "batch_stats": stats if stats is not None else variables["batch_stats"]}
    return {k: v.numpy() for k, v in
            state_dict_from_jax(tree, "resnet12Bdc", prefix="emb_func.").items()}


@pytest.fixture(scope="module")
def float64_reference(step_setup):
    """Loss, gradients and BN statistics with the backbone in float64 in
    both packages (the head is float32 in both)."""
    cfg, setting, _, variables, jax_batch, batch = step_setup
    with jax.enable_x64(True):
        jax64 = jax_build_method(train_config(backbone={
            "name": "resnet12Bdc",
            "kwargs": {"num_channels": 1, "reduce_dim": 8, "fused_bdc": False, "dtype": "float64"}}))
        ref = _jax_step(jax64, variables, jax_batch, setting)
    method = _port_method(cfg, variables, torch.float64)
    loss, out = method.loss(batch.to("cpu"), setting)
    loss.backward()
    return ref, method, loss.item(), out


def test_train_step_matches_jax_float32(step_setup, float64_reference):
    cfg, setting, jax_method, variables, jax_batch, batch = step_setup
    ref_loss, ref_acc, ref_grads, ref_stats = _jax_step(jax_method, variables, jax_batch, setting)
    method = _port_method(cfg, variables)
    loss, out = method.loss(batch.to("cpu"), setting)
    assert out.seg_logits.shape == (1, 10, 5)
    loss.backward()
    assert loss.item() == pytest.approx(ref_loss, rel=LOSS_RTOL)
    assert float(out.metrics["acc"]) == pytest.approx(ref_acc, rel=1e-6)
    ref_stats = _as_port(variables, stats=ref_stats)
    state = method.state_dict()
    n_stats = 0
    for key, val in state.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(val.numpy(), ref_stats[key], rtol=STATS_TOL, atol=STATS_TOL)
            n_stats += 1
        elif key.endswith("num_batches_tracked"):
            assert int(val) == 1
    assert n_stats == 2 * 17  # 4 blocks × (3 + downsample) and the head
    grads_f32 = _as_port(variables, params=ref_grads)
    (_, _, grads_f64, _), _, _, _ = float64_reference
    grads_f64 = _as_port(variables, params=grads_f64)
    # every gradient against the JAX package's float32 one and against the
    # float64-backbone one (measured ≤ 7.3e-5 and ≤ 4.5e-5 of the max abs)
    for name, p in method.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        ours = p.grad.numpy()
        assert _rel(ours, grads_f32[name].reshape(ours.shape)) <= GRAD_TOL, name
        assert _rel(ours, grads_f64[name].reshape(ours.shape)) <= GRAD_TOL, name


def test_train_step_matches_jax_with_a_float64_backbone(float64_reference, step_setup):
    _, _, _, variables, _, _ = step_setup
    (ref_loss, ref_acc, ref_grads, ref_stats), method, loss, out = float64_reference
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
    assert float(out.metrics["acc"]) == pytest.approx(ref_acc, rel=1e-6)
    ref_grads = _as_port(variables, params=ref_grads)
    for name, p in method.named_parameters():
        ours = p.grad.double().numpy()
        assert _rel(ours, ref_grads[name].reshape(ours.shape)) <= GRAD_TOL, name
    ref_stats = _as_port(variables, stats=ref_stats)
    for key, val in method.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(val.double().numpy(), ref_stats[key],
                                       rtol=STATS_TOL, atol=STATS_TOL)


def test_three_adam_steps_losses_match_jax(step_setup):
    """Adam at the config's lr 0.005 for three steps on three episodes.  The
    first loss is the same computation at the same weights (1e-5), the
    second follows one Adam update (1e-4; measured 4e-5).  Adam's updates
    are about ±lr on every weight whose gradient exceeds its eps, whatever
    the gradient's size, so the float32 noise of near-zero gradients flips
    whole ±lr steps, and the third loss agrees to 2e-3 (measured): it is
    held at 1e-2.  The SGD run of ``test_torch_port_trainer.py`` holds a
    multi-step trajectory at 1e-4, and ``test_optimizer_update_matches_optax``
    the update itself at 1e-6."""
    cfg, setting, jax_method, variables, _, _ = step_setup
    jax_batches = list(jax_get_dataloader(cfg, "train")[0].epoch(0))
    batches = list(get_dataloader(cfg, "train")[0].epoch(0))
    jax_opt = JaxOptimizer(cfg["optimizer"])
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = jax_opt.init(params)
    non_params = {"batch_stats": stats}

    @jax.jit
    def jax_step(params, non_params, opt_state, batch):
        def loss_fn(p):
            return jax_method.loss({**non_params, "params": p}, batch, setting, jax.random.PRNGKey(1))
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, opt_state = jax_opt.apply(grads, opt_state, params,
                                          jax_opt.lr_tree(params, 1.0))
        return loss, params, {"batch_stats": out.updates["batch_stats"]}, opt_state

    ref = []
    for b in jax_batches:
        loss, params, non_params, opt_state = jax_step(params, non_params, opt_state, b)
        ref.append(float(loss))
    method = _port_method(cfg, variables)
    opt = Optimizer(cfg["optimizer"], method)
    ours = []
    for b in batches:
        loss, _ = method.loss(b.to("cpu"), setting)
        opt.zero_grad()
        loss.backward()
        opt.step()
        ours.append(loss.item())
    assert len(ours) == len(ref) == 3
    assert ours[0] == pytest.approx(ref[0], rel=LOSS_RTOL)
    assert ours[1] == pytest.approx(ref[1], rel=GRAD_TOL)
    assert ours[2] == pytest.approx(ref[2], rel=1e-2)


# -- optimizers and schedules ----------------------------------------------------

class _TwoParts(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb_func = torch.nn.Linear(4, 3)
        self.classifier = torch.nn.Linear(3, 2)


@pytest.mark.parametrize("opt_cfg", [
    {"name": "Adam", "kwargs": {"lr": 0.01}},
    {"name": "Adam", "kwargs": {"lr": 0.01, "weight_decay": 0.001, "betas": [0.8, 0.99]}},
    {"name": "AdamW", "kwargs": {"lr": 0.01, "weight_decay": 0.05}},
    {"name": "SGD", "kwargs": {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.0005}},
    {"name": "SGD", "kwargs": {"lr": 0.1, "momentum": 0.9, "nesterov": True}},
    {"name": "SGD", "kwargs": {"lr": 0.1}, "other": {"emb_func": 0.02}},
    # eps 1e-3 is large enough that sqrt(nu) + eps (torch.optim.RMSprop)
    # misses sqrt(nu + eps) (optax) by far more than the tolerance
    {"name": "RMSprop", "kwargs": {"lr": 0.01, "alpha": 0.9, "eps": 1e-3}},
    {"name": "RMSprop", "kwargs": {"lr": 0.01, "alpha": 0.9, "eps": 1e-3,
                                   "momentum": 0.9, "weight_decay": 5e-4}},
], ids=["adam", "adam_wd", "adamw", "sgd_momentum_wd", "sgd_nesterov", "sgd_groups",
        "rmsprop", "rmsprop_momentum_wd"])
def test_optimizer_update_matches_optax(opt_cfg):
    """Three updates on given gradients, per-group LRs scaled by 0.5 as an
    epoch's schedule would, against the JAX package's optax chains."""
    torch.manual_seed(0)
    model = _TwoParts()
    opt = Optimizer(opt_cfg, model)
    opt.set_lr_scale(0.5)
    names = dict(model.named_parameters())
    params = {part: {n.split(".", 1)[1]: p.detach().numpy().copy()
                     for n, p in names.items() if n.startswith(part)}
              for part in ("emb_func", "classifier")}
    jax_opt = JaxOptimizer(opt_cfg)
    state = jax_opt.init(params)
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = {part: {k: rng.normal(size=v.shape).astype(np.float32) for k, v in sub.items()}
                 for part, sub in params.items()}
        params, state = jax_opt.apply(grads, state, params, jax_opt.lr_tree(params, 0.5))
        for n, p in names.items():
            part, leaf = n.split(".", 1)
            p.grad = torch.from_numpy(grads[part][leaf])
        opt.step()
        for n, p in names.items():
            part, leaf = n.split(".", 1)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[part][leaf]),
                                       rtol=1e-6, atol=1e-6)
    assert [g["name"] for g in opt.torch.param_groups] == ["emb_func", "classifier"]


@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["plain", "momentum"])
def test_rmsprop_state_round_trips_through_state_dict(momentum):
    """Two steps, the state saved, a fresh optimizer loaded from it: its next
    step is the uninterrupted run's, to the bit (what ``load_last`` and the
    resume entry point rely on)."""
    cfg = {"name": "RMSprop", "kwargs": {"lr": 0.01, "alpha": 0.9, "eps": 1e-3,
                                         "momentum": momentum, "weight_decay": 5e-4}}
    rng = np.random.default_rng(4)
    torch.manual_seed(0)
    model = _TwoParts()
    twin = _TwoParts()
    twin.load_state_dict(model.state_dict())
    opt = Optimizer(cfg, model)
    grads = [{n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
              for n, p in model.named_parameters()} for _ in range(3)]

    def step(module, optimizer, g):
        for n, p in module.named_parameters():
            p.grad = g[n].clone()
        optimizer.step()

    for g in grads[:2]:
        step(model, opt, g)
    saved = copy.deepcopy(opt.state_dict())  # as a checkpoint file holds it
    keys = {"square_avg", "momentum_buffer"} if momentum else {"square_avg"}
    assert all(set(v) == keys for v in saved["state"].values()) and saved["state"]
    twin.load_state_dict(model.state_dict())
    resumed = Optimizer(cfg, twin)
    resumed.load_state_dict(saved)
    step(model, opt, grads[2])
    step(twin, resumed, grads[2])
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=n)


def test_optimizer_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown optimizer"):
        Optimizer({"name": "Lamb"}, _TwoParts())


def _scheduler_configs():
    """Every distinct (scheduler, optimizer lr, epochs, warmup) that a
    shipped config resolves to, plus the other schedules the copy covers."""
    seen = {}
    for path in sorted(glob.glob(os.path.join(REPO, "config", "**", "*.yaml"), recursive=True)):
        if os.sep + "headers" + os.sep in path or os.sep + "backbones" + os.sep in path:
            continue
        cfg = Config(path).get_config_dict()
        key = repr((cfg.get("lr_scheduler"), cfg.get("optimizer"), cfg.get("epoch"), cfg.get("warmup")))
        seen.setdefault(key, (os.path.relpath(path, REPO), cfg))
    extra = [
        {"lr_scheduler": {"name": "MultiStepLR", "kwargs": {"milestones": [3, 6], "gamma": 0.5}}, "warmup": 2},
        {"lr_scheduler": {"name": "CosineAnnealingLR", "kwargs": {"T_max": 6, "eta_min": 0.0001}}, "warmup": 3},
        {"lr_scheduler": {"name": "ExponentialLR", "kwargs": {"gamma": 0.9}}},
        {"lr_scheduler": {"name": "LambdaLR", "kwargs": {"lr_lambda": "lambda e: 0.5 ** (e // 2)"}}},
        {"lr_scheduler": {"name": "ReduceLROnPlateau",
                          "kwargs": {"patience": 1, "factor": 0.5, "cooldown": 1, "min_lr": 0.0001}}},
    ]
    for i, over in enumerate(extra):
        seen[f"extra{i}"] = (f"extra {over['lr_scheduler']['name']}",
                             {"epoch": 12, "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001}}, **over})
    return list(seen.values())


def test_lr_scheduler_matches_jax_for_every_shipped_config():
    configs = _scheduler_configs()
    assert len(configs) >= 8
    names = set()
    for source, cfg in configs:
        ours, ref = build_scheduler(cfg), jax_build_scheduler(cfg)
        names.add(ours.name)
        epochs = int(cfg.get("epoch", 1))
        losses = np.random.default_rng(0).uniform(0.5, 1.5, size=epochs + 8)
        for epoch in range(epochs + 8):
            assert ours.scale(epoch) == pytest.approx(ref.scale(epoch), rel=1e-12, abs=1e-15), \
                (source, epoch)
            ours.step(float(losses[epoch]))
            ref.step(float(losses[epoch]))
        assert ours.state_dict() == ref.state_dict(), source
    assert {"CosineAnnealingLR", "StepLR", "ReduceLROnPlateau"} <= names


# -- BatchNorm in train mode ------------------------------------------------------

def test_train_mode_batchnorm_follows_flax():
    """Batch statistics for the output, the *biased* batch variance into
    the running variance (torch's own BatchNorm2d uses the unbiased one)."""
    x = (np.random.default_rng(0).normal(size=(3, 5, 4, 6)) * 2.0 + 1.5).astype(np.float32)
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xn = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = bn.init(jax.random.PRNGKey(0), xn)
    ref, upd = bn.apply(variables, xn, mutable=["batch_stats"])
    ours = BatchNorm(5).train()
    out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=STATS_TOL, atol=STATS_TOL)
    np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=STATS_TOL, atol=STATS_TOL)
    unbiased = torch.nn.BatchNorm2d(5).train()
    unbiased(torch.from_numpy(x))
    assert not np.allclose(unbiased.running_var.numpy(), ours.running_var.numpy(), rtol=1e-3)
    # bf16 input: float32 statistics, bf16 output, gradients on float32 parameters
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    bf = BatchNorm(5).train()
    y = bf(xb)
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16 and bf.running_var.dtype == torch.float32
    assert bf.weight.grad.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.running_mean.numpy(), ours.running_mean.numpy(), rtol=1e-2, atol=1e-2)


# -- the import rule ----------------------------------------------------------------

NEW_MODULES = ["train.py", "optim.py", "run_trainer.py", "run_trainer_resume.py", "profile_train.py",
               "ops/audio_augmentations.py", "utils/meters.py", "utils/checkpoint.py",
               "ops/bdc_cuda.py", "data/loader.py", "models/backbones/conv_four.py",
               "models/init.py", "models/heads/proto_net.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_training_modules_import_nothing_of_jax(module):
    path = os.path.join(REPO, "audio_fewshot_tpu_torch", module)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    banned = ("jax", "jaxlib", "flax", "optax", "audio_fewshot_tpu")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if n.split(".")[0] in banned], (module, names)

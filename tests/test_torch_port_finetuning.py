"""The finetuning family of the PyTorch port (Baseline, BaselinePlus,
NegNet, RFSModel, SKDModel) against the JAX package on the CPU, at the same
weights: the JAX package's variable trees drawn with numpy
(``test_torch_port_meta2.draw_tree``; random BN statistics and biases),
carried across by ``utils/convert.py``.

Geometry: Baseline and BaselinePlus on Conv64F (``is_flatten``, ``[1, 81,
90]`` segments, 1600 features); NegNet, RFSModel and SKDModel on a narrow
resnet12 (planes 8/12/16/20 on ``[1, 96, 112]``: a [20, 2, 3] pooled map,
120 features, so its NHWC flatten order shows), ``num_class`` 7, flat
batches of 8 segments (SKD's generation 0: 32 through the backbone).

The train references are the JAX methods' own ``loss`` (float64 blocks,
Dropout the identity, ``drop_rate`` 0) with ``apply_module`` returning
given features for ``emb_func``: the student's from one jitted float64
embedding per backbone and batch shape (train mode, its VJP giving the
backbone's gradient at the head's feature cotangent), a teacher's from the
same embedding in eval mode.  Both packages cast the map to float32, so the
features and the global head are float32 in both.

Tolerances:
- one flat train step, the port with float64 blocks: loss and logits to
  1e-5 of the logits' scale, every gradient to 5e-5 of its max abs (a
  tenth of the largest where that is more; ``STEP_TOLS``; measured 3.0e-6
  and 7.9e-6, Conv64F's float32 logits head against the JAX package's
  float64 one); with float32 blocks the loss and logits to 3e-5 (measured
  4.5e-6) and the gradients to 1e-4 on Conv64F (measured 1.2e-5, as
  ``test_torch_port_metric.py``) and 2e-2 on resnet12 (measured 2.7e-3;
  ``F32_STEP_TOLS``, as ``test_torch_port_meta2.py``: float32 rounding
  through twelve train-mode BNs); resnet12Bdc's gradients (in
  ``test_torch_port_pretrains.py``) to 5e-4 with either blocks (measured
  1.6e-4 and 1.8e-4: both packages keep the BDC pool in float32, whose
  gradient through the gram carries 1e-5 to 4e-5 of float32 noise in
  each, ROADMAP Queue C);
- the eval adaptation over shared features: float64 in both to 1e-9 of
  the logits' scale (``ADAPT_F64_TOL``), the port's float32 against the
  JAX float64 to 1e-4 (``ADAPT_F32_TOL``);
- ``sgd_head_steps`` (the adaptation's update) against
  ``torch.optim.SGD``, and the written-out head gradients against
  autograd, float64: 1e-12 of their scale;
- the probe: centred logits within 2e-3 of the JAX probe's (absolute, the
  limit ``tests/test_sklearn_probe.py`` gives the JAX probe against
  sklearn; ``PROBE_ATOL``); ≥ 99 % of the predictions sklearn's;
- the flat features of the narrow resnet12: 1e-5 of their scale.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.episode import FlatBatch as JaxFlatBatch  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting as JaxSetting  # noqa: E402
from audio_fewshot_tpu.models.heads import finetuning as jax_ft  # noqa: E402
from audio_fewshot_tpu_torch.episode import FlatBatch  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.layers import Dropout  # noqa: E402
from audio_fewshot_tpu_torch.models.base import EpisodeSetting  # noqa: E402
from audio_fewshot_tpu_torch.models.heads import finetuning  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_meta2 import draw_tree  # noqa: E402
from test_torch_port_metric import _rel  # noqa: E402

STEP_TOLS = {"Conv64F": {"logits": 1e-5, "grads": 5e-5},
             "resnet12": {"logits": 1e-5, "grads": 5e-5},
             # both packages keep the BDC pool in float32 (ROADMAP Queue C)
             "resnet12Bdc": {"logits": 1e-5, "grads": 5e-4}}
F32_STEP_TOLS = {"Conv64F": {"logits": 3e-5, "grads": 1e-4},
                 "resnet12": {"logits": 3e-5, "grads": 2e-2},
                 "resnet12Bdc": {"logits": 3e-5, "grads": 5e-4}}
ADAPT_F64_TOL = 1e-9
ADAPT_F32_TOL = 1e-4
PROBE_ATOL = 2e-3
FEATURE_TOL = 1e-5
NUM_CLASS, BATCH = 7, 8
SETTING = EpisodeSetting(way=5, shot=5, query=3)
JAX_SETTING = JaxSetting(way=5, shot=5, query=3)
SPECS = {"Conv64F": (1, 81, 90), "resnet12": (1, 96, 112), "resnet12Bdc": (1, 16, 20)}
BACKBONES = {
    "Conv64F": {"name": "Conv64F", "kwargs": {"is_flatten": True, "num_channels": 1}},
    "resnet12": {"name": "resnet12", "kwargs": {"num_channels": 1, "planes": [8, 12, 16, 20],
                                                "drop_rate": 0.0}},
    # the plain BDC path in the JAX package (no Pallas kernel)
    "resnet12Bdc": {"name": "resnet12Bdc", "kwargs": {"num_channels": 1, "reduce_dim": 8,
                                                      "fused_bdc": False, "drop_rate": 0.0}},
}
FEAT_DIM = {"Conv64F": 1600, "resnet12": 120, "resnet12Bdc": 36}
# case → (classifier, backbone, kwargs)
CASES = {
    "Baseline": ("Baseline", "Conv64F", {}),
    "BaselinePlus": ("BaselinePlus", "Conv64F", {}),
    "NegNet": ("NegNet", "resnet12", {"margin": -0.01}),
    "RFSModel:distill": ("RFSModel", "resnet12", {"is_distill": True, "alpha": 0.5}),
    "SKDModel": ("SKDModel", "resnet12", {"gamma": 1.0, "alpha": 0.1}),
    "SKDModel:gen1": ("SKDModel", "resnet12", {"gamma": 1.0, "alpha": 0.1, "is_distill": True}),
}
# the pretrainers (``test_torch_port_pretrains.py`` runs their steps)
PRETRAIN_CASES = {
    "MetabaselinePretrain": ("MetabaselinePretrain", "resnet12", {}),
    "FEAT_Pretrain": ("FEAT_Pretrain", "resnet12", {}),
    "DeepBDC_Pretrain": ("DeepBDC_Pretrain", "resnet12Bdc", {"val_type": "meta"}),
    "DeepBDC_Pretrain:stl": ("DeepBDC_Pretrain", "resnet12Bdc", {"val_type": "stl"}),
    "DeepBDC_Pretrain:distill": ("DeepBDC_Pretrain", "resnet12Bdc", {"is_distill": True}),
}
ALL_CASES = {**CASES, **PRETRAIN_CASES}


def config(case, dtype=None, **kwargs):
    name, backbone, base = ALL_CASES[case]
    bk = {"name": BACKBONES[backbone]["name"], "kwargs": dict(BACKBONES[backbone]["kwargs"])}
    if dtype:
        bk["kwargs"]["dtype"] = dtype
    return {"classifier": {"name": name, "kwargs": {"num_class": NUM_CLASS, **base, **kwargs}},
            "backbone": bk, "modality": "audio", "precision": "fp32", "way_num": 5,
            "shot_num": 5, "query_num": 3, "spec_shape": list(SPECS[backbone])}


def flat_batch(backbone, seed=2):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(BATCH,) + SPECS[backbone]).astype(np.float32)
    return data, rng.integers(0, NUM_CLASS, size=BATCH).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_variables(case, seed=0):
    """The JAX method's variables (shapes traced, not compiled), drawn with
    numpy, with random BN statistics and biases."""
    _, backbone, _ = ALL_CASES[case]
    method = jax_build_method(config(case))
    data, target = flat_batch(backbone)
    shapes = jax.eval_shape(lambda key: method.init_variables(
        key, JaxFlatBatch(data=jnp.asarray(data[:2]), target=jnp.asarray(target[:2])),
        JAX_SETTING), jax.random.PRNGKey(0))
    tree = draw_tree(shapes, np.random.default_rng(seed))
    return randomize_batchnorm(jax.tree_util.tree_map(np.asarray, tree),
                               np.random.default_rng(seed + 1))


def port_method(case, variables, dtype=torch.float32):
    """The port's method at ``variables``; ``dtype`` float64: its blocks only
    (both packages cast the map to float32)."""
    name, backbone, _ = ALL_CASES[case]
    method = build_method(config(case))
    method.load_state_dict(state_dict_from_jax(variables, backbone, prefix="emb_func.",
                                               classifier=name))
    if dtype == torch.float64:
        emb = method.emb_func
        emb.dtype = dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(dtype)
    return method


class _no_dropout:
    def __enter__(self):
        self.flax, self.port = flax_nn.Dropout.__call__, Dropout.forward
        flax_nn.Dropout.__call__ = lambda self, x, *a, **k: x
        Dropout.forward = lambda self, x: x

    def __exit__(self, *exc):
        flax_nn.Dropout.__call__, Dropout.forward = self.flax, self.port


def _wide(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64)
                                  if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


@functools.lru_cache(maxsize=None)
def _embed_fns(backbone):
    """Jitted float64 embeddings of ``backbone``: train ``(params, stats, x,
    cotangent) → (features, the backbone's VJP)`` and eval ``(params, stats,
    x) → features``."""
    case = {"Conv64F": "Baseline", "resnet12": "NegNet",
            "resnet12Bdc": "DeepBDC_Pretrain"}[backbone]
    with jax.enable_x64(True):
        method = jax_build_method(config(case, dtype="float64"))

    def run(params, stats, x, train):
        v = {"params": {"emb_func": params}, "batch_stats": {"emb_func": stats}}
        with _no_dropout():
            feats, _ = method.apply_module(v, "emb_func", x, train=train,
                                           rng=jax.random.PRNGKey(1))
        return feats.reshape(feats.shape[0], -1)

    def train_fn(params, stats, x, cotangent):
        feats, vjp = jax.vjp(lambda p: run(p, stats, x, True), params)
        return feats, vjp(cotangent.astype(feats.dtype))[0]

    return jax.jit(train_fn), jax.jit(lambda p, s, x: run(p, s, x, False))


@functools.lru_cache(maxsize=None)
def _head_loss_fn(case):
    """The jitted JAX ``loss`` (float64 head parameters) with ``apply_module``
    giving ``emb_func``'s features: value and gradient in (head parameters,
    student features)."""
    with jax.enable_x64(True):
        method = jax_build_method(config(case, dtype="float64"))
    original = method.apply_module

    def loss(head, others, batch, feats, t_feats, teacher):
        def apply_module(variables, name, *args, train=False, rng=None, **kw):
            if name == "emb_func":
                return (feats if train else t_feats), {}
            return original(variables, name, *args, train=train, rng=rng, **kw)

        method.apply_module = apply_module
        method.teacher_variables = teacher
        return method.loss({**others, "params": head}, batch, JAX_SETTING,
                           jax.random.PRNGKey(1))

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 3), has_aux=True))


def _copies(name, data, distill):
    if name != "SKDModel":
        return data
    if distill:
        return np.concatenate([data, data[..., ::-1, ::-1]])
    return np.concatenate([data, data[..., ::-1], data[..., ::-1, :], data[..., ::-1, ::-1]])


@functools.lru_cache(maxsize=None)
def step_reference(case):
    """One float64 JAX flat train step: (loss, logits, gradients under the
    port's names)."""
    name, backbone, kwargs = ALL_CASES[case]
    distill = kwargs.get("is_distill", False)
    variables = jax_variables(case)
    teacher = jax_variables(case, seed=5) if distill else None
    data, target = flat_batch(backbone)
    train_fn, eval_fn = _embed_fns(backbone)
    with jax.enable_x64(True):
        wide = _wide(variables)
        params = wide["params"]
        emb, stats = params["emb_func"], wide["batch_stats"]["emb_func"]
        x = jnp.asarray(np.ascontiguousarray(_copies(name, data, distill)))
        feats, _ = train_fn(emb, stats, x, jnp.zeros((x.shape[0], FEAT_DIM[backbone])))
        t_feats = None
        t_wide = None
        if teacher is not None:
            t_wide = _wide(teacher)
            t_feats = eval_fn(t_wide["params"]["emb_func"], t_wide["batch_stats"]["emb_func"],
                              jnp.asarray(data))
        head = {k: v for k, v in params.items() if k != "emb_func"}
        others = {k: v for k, v in wide.items() if k != "params"}
        batch = JaxFlatBatch(data=jnp.asarray(data), target=jnp.asarray(target))
        (loss, out), (g_head, g_feats) = _head_loss_fn(case)(head, others, batch, feats,
                                                             t_feats, t_wide)
        _, g_emb = train_fn(emb, stats, x, g_feats)
    grads = state_dict_from_jax({"params": {**jax.tree_util.tree_map(np.asarray, g_head),
                                            "emb_func": jax.tree_util.tree_map(np.asarray, g_emb)},
                                 "batch_stats": variables["batch_stats"]},
                                backbone, prefix="emb_func.", classifier=name)
    return float(loss), np.asarray(out.seg_logits), {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_flat_train_step_matches_jax(case):
    """The loss, the logits and every gradient (head and backbone) of one
    flat train step: Baseline's linear head, BaselinePlus's cosine head,
    NegNet's margin, RFSModel's distillation and SKDModel's generation 1
    (each with a hand-set teacher), SKDModel's generation 0 (four flips, the
    flip head over the class logits)."""
    check_flat_step(case)


def check_flat_step(case):
    """The port's flat train step against ``step_reference(case)``, with
    float64 and with float32 blocks, at its backbone's ``STEP_TOLS`` and
    ``F32_STEP_TOLS``."""
    name, backbone, kwargs = ALL_CASES[case]
    ref_loss, ref_logits, grads = step_reference(case)
    variables = jax_variables(case)
    data, target = flat_batch(backbone)
    batch = FlatBatch(data=data, target=target).to("cpu")
    scale = np.abs(ref_logits).max()
    for dtype in (torch.float64, torch.float32):
        method = port_method(case, variables, dtype).train()
        if kwargs.get("is_distill"):
            method.set_teacher(port_method(case, jax_variables(case, seed=5), dtype))
            assert method._distills()
            assert not any(k.startswith("teacher") for k in method.state_dict())
        with _no_dropout():
            loss, out = method.loss(batch, SETTING)
        tols = (STEP_TOLS if dtype == torch.float64 else F32_STEP_TOLS)[backbone]
        assert loss.item() > 0.1
        assert abs(loss.item() - ref_loss) <= tols["logits"] * scale
        assert _rel(out.seg_logits.detach().numpy(), ref_logits) <= tols["logits"]
        assert out.metrics["acc"].item() == pytest.approx(
            100.0 * np.mean(ref_logits.argmax(-1) == target))
        loss.backward()
        named = dict(method.named_parameters())
        largest = max(np.abs(grads[k]).max() for k in named)
        for key, p in named.items():
            ref = grads[key].reshape(p.shape)
            # generation 1 leaves the flip head out of its loss: no gradient
            got = np.zeros_like(ref) if p.grad is None else p.grad.double().numpy()
            tol = tols["grads"] * max(np.abs(ref).max(), 0.1 * largest)
            assert np.abs(got - ref).max() <= tol, key


def test_resnet12_features_keep_the_jax_flatten_order():
    """The global heads over resnet12 read the pooled [20, 2, 3] map
    flattened in the JAX package's NHWC order: the port's flat features
    are the JAX package's, and the reference's NCHW order is not."""
    variables = jax_variables("NegNet")
    data, _ = flat_batch("resnet12")
    _, eval_fn = _embed_fns("resnet12")
    with jax.enable_x64(True):
        wide = _wide(variables)
        ref = np.asarray(eval_fn(wide["params"]["emb_func"], wide["batch_stats"]["emb_func"],
                                 jnp.asarray(data)))
    method = port_method("NegNet", variables, torch.float64).eval()
    with torch.no_grad():
        ours = method.flat_features(torch.from_numpy(data)).numpy()
        fmap = method.emb_func.layer4(method.emb_func.layer3(method.emb_func.layer2(
            method.emb_func.layer1(torch.from_numpy(data).double())))).float()
        nchw = torch.nn.functional.avg_pool2d(fmap, (5, 5), stride=1).reshape(BATCH, -1).numpy()
    assert ours.shape == (BATCH, 120)
    assert _rel(ours, ref) <= FEATURE_TOL
    assert _rel(nchw, ref) > 0.1


# -- the eval adaptation --------------------------------------------------------------------

def _episode_features(e, d=1600, seed=4):
    rng = np.random.default_rng(seed)
    sup = np.maximum(rng.normal(size=(e, 25, d)), 0.0) + 0.3 * np.repeat(
        rng.normal(size=(e, 5, d)), 5, axis=1)
    qry = np.maximum(rng.normal(size=(e, 12, d)), 0.0)
    return sup, np.tile(np.repeat(np.arange(5), 5), (e, 1)).astype(np.int32), qry


ADAPT = {"Baseline": {"inner_param": {"inner_optim": {"lr": 0.01, "momentum": 0.9,
                                                      "weight_decay": 0.001}}},
         "BaselinePlus": {"inner_param": {"inner_optim": {"lr": 0.01, "momentum": 0.9}}},
         "NegNet": {"margin": -0.01}}


@pytest.mark.parametrize("iters, episodes", [(3, 3), (20, 1)], ids=["reduced", "shipped"])
@pytest.mark.parametrize("case", list(ADAPT))
def test_eval_adaptation_matches_jax(case, iters, episodes):
    """Query logits of a head adapted to each episode's support features
    (``inner_train_iter`` 3 on three episodes: 21 steps; the shipped 20 on
    one: 140 steps), the JAX head vmapped over the episodes, in float64,
    and the port's in float64 and float32.  BaselinePlus's ``inner_optim``
    has no ``weight_decay``: the 1e-3 default applies in both."""
    kwargs = dict(ADAPT[case])
    kwargs["inner_param"] = dict(kwargs.get("inner_param", {}), inner_train_iter=iters,
                                 inner_batch_size=4)
    sup, sup_y, qry = _episode_features(episodes)
    with jax.enable_x64(True):
        jm = jax_build_method(config(case, **kwargs))
        n_steps = jm._adapt_steps(25)
        ref = np.asarray(jax.jit(jax.vmap(lambda s, y, q: jm._episode_head_logits(
            s, y, q, n_steps, way=5)))(sup, sup_y, qry))
    ours = build_method(config(case, **kwargs))
    assert (ours.inner_steps, ours.inner_wd, ours._adapt_steps(25)) == (
        jm.inner_steps, jm.inner_wd, n_steps) == (iters, 1e-3, iters * 7)
    for dtype, tol in ((torch.float64, ADAPT_F64_TOL), (torch.float32, ADAPT_F32_TOL)):
        got = ours.episode_head_logits(*(torch.tensor(a, dtype=dtype) for a in (sup,)),
                                       torch.from_numpy(sup_y), torch.tensor(qry, dtype=dtype), 5)
        assert got.shape == (episodes, 12, 5)
        assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("momentum, weight_decay", [(0.0, 0.0), (0.9, 0.0), (0.9, 1e-3)])
def test_sgd_head_steps_step_as_torch_sgd(momentum, weight_decay):
    """``sgd_head_steps`` (the eval adaptation's update: momentum and
    coupled weight decay) against ``torch.optim.SGD`` on the same float64
    objective and gradient: equal to 1e-12 of the tensors' scale, its
    inputs left as they were."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(3, 10, 6)))
    y = torch.from_numpy(rng.integers(0, 4, size=(3, 10)))
    w0 = torch.from_numpy(rng.normal(size=(3, 4, 6)))

    def objective(w):
        return sum(torch.nn.functional.cross_entropy(x[i] @ w[i].mT, y[i]) for i in range(3))

    def gradient(w):
        with torch.enable_grad():
            w = w.detach().requires_grad_()
            return torch.autograd.grad(objective(w), w)

    start = w0.clone()
    got, = finetuning.sgd_head_steps((w0,), gradient, 7, 0.3, momentum, weight_decay)
    want = w0.clone().requires_grad_()
    opt = torch.optim.SGD([want], lr=0.3, momentum=momentum, weight_decay=weight_decay)
    for _ in range(7):
        opt.zero_grad()
        objective(want).backward()
        opt.step()
    torch.testing.assert_close(w0, start, rtol=0, atol=0)
    assert (got - w0).abs().max() > 0.1
    assert (got - want.detach()).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("head", ["linear", "cosine", "negnet"])
def test_written_out_head_gradients_equal_autograd(head):
    """The adaptation's written-out gradients (each episode's mean support
    cross-entropy) against autograd of the same objective, float64, on
    three episodes: to 1e-12 of each row's scale; NegNet's at rows of norm 0
    too (``F.normalize``'s 1e-12 clamp, where the radial part drops)."""
    from torch.nn.functional import cross_entropy, normalize

    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(3, 10, 6)))
    y = torch.from_numpy(rng.integers(0, 4, size=(3, 10)))
    onehot = torch.nn.functional.one_hot(y, 4).double()

    def loss(logits):
        return sum(cross_entropy(logits[i], y[i]) for i in range(3))

    if head == "linear":
        params = (torch.from_numpy(rng.normal(size=(3, 6, 4))),
                  torch.from_numpy(rng.normal(size=(3, 4))))
        gradient = finetuning.linear_head_gradient(x, onehot)
        objective = lambda w, b: loss(torch.baddbmm(b[:, None], x, w))  # noqa: E731
    elif head == "cosine":
        params = (torch.from_numpy(rng.normal(size=(3, 6, 4))),)
        gradient = finetuning.cosine_head_gradient(x, onehot, 2.0)
        objective = lambda w: loss(2.0 * (x @ w))  # noqa: E731
    else:
        w = rng.normal(size=(3, 4, 6))
        w[1, 2] = 0.0
        params = (torch.from_numpy(w),)
        gradient = finetuning.negnet_head_gradient(x, onehot, 30.0, -0.01)
        objective = lambda w: loss(  # noqa: E731
            30.0 * (x @ normalize(w, dim=-1, eps=1e-12).mT + 0.01 * onehot))
    wanted = torch.autograd.grad(objective(*(p.requires_grad_() for p in params)), params)
    for got, want in zip(gradient(*(p.detach() for p in params)), wanted):
        # row by row: the zero row's gradient is 1e12 times the others'
        assert got.shape == want.shape
        assert ((got - want).abs().amax(-1) <= 1e-12 * want.abs().amax(-1)).all()


def test_forward_adapts_on_the_episode_batch():
    """``forward`` embeds the batch and adapts on its support targets at the
    eval way: its logits are ``episode_head_logits`` of the embedded
    features (the JAX package's ``forward`` does the same)."""
    from audio_fewshot_tpu_torch.episode import make_dense_episode_batch

    variables = jax_variables("Baseline")
    method = port_method("Baseline", variables).eval()
    rng = np.random.default_rng(6)
    sup = rng.normal(size=(2, 25) + SPECS["Conv64F"]).astype(np.float32)
    qry = rng.normal(size=(2, 15) + SPECS["Conv64F"]).astype(np.float32)
    batch = make_dense_episode_batch(sup, qry, 5, 5, 3).to("cpu")
    with torch.no_grad():
        got = method(batch, SETTING)
        s, q = method.embed(batch)
        want = method.episode_head_logits(s, batch.support_target, q, 5)
    assert got.shape == (2, 15, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the probe ------------------------------------------------------------------------------

def _probe_episodes(e=4, d=64, seed=9):
    rng = np.random.default_rng(seed)
    sup = np.empty((e, 25, d), np.float32)
    qry = np.empty((e, 40, d), np.float32)
    for i in range(e):
        means = rng.normal(size=(5, d)).astype(np.float32)
        sup[i] = np.repeat(means, 5, 0) + rng.normal(size=(25, d))
        qry[i] = np.repeat(means, 8, 0) + rng.normal(size=(40, d))
    norm = lambda x: x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-5)  # noqa: E731
    return norm(sup), np.tile(np.repeat(np.arange(5), 5), (e, 1)), norm(qry)


@functools.lru_cache(maxsize=None)
def _jax_probe(c):
    sup, sup_y, qry = _probe_episodes()
    fn = jax.jit(jax.vmap(lambda s, y, q: jax_ft.sklearn_probe_logits(s, y, q, 5, C=c)))
    return np.asarray(fn(sup, sup_y, qry))


def _centred(x):
    return x - x.mean(-1, keepdims=True)


@pytest.mark.parametrize("c", [1.0, 0.1])
def test_probe_converges_to_the_jax_probes_optimum(c):
    sup, sup_y, qry = _probe_episodes()
    ours = finetuning.sklearn_probe_logits(torch.from_numpy(sup), torch.from_numpy(sup_y),
                                           torch.from_numpy(qry), 5, c).numpy()
    np.testing.assert_allclose(_centred(ours), _centred(_jax_probe(c)), atol=PROBE_ATOL, rtol=0)


@pytest.mark.parametrize("c", [1.0, 0.1])
def test_probe_agrees_with_sklearn(c):
    sklearn_lm = pytest.importorskip("sklearn.linear_model")
    sup, sup_y, qry = _probe_episodes()
    ours = finetuning.sklearn_probe_logits(torch.from_numpy(sup), torch.from_numpy(sup_y),
                                           torch.from_numpy(qry), 5, c).numpy()
    agree = []
    for i in range(len(sup)):
        clf = sklearn_lm.LogisticRegression(C=c, max_iter=1000, random_state=0)
        clf.fit(sup[i], sup_y[i])
        agree.append(np.mean(clf.predict(qry[i]) == ours[i].argmax(-1)))
        np.testing.assert_allclose(_centred(ours[i]), _centred(clf.decision_function(qry[i])),
                                   atol=PROBE_ATOL, rtol=0)
    assert np.mean(agree) >= 0.99


def test_probe_is_batched_and_float64_stays_float64():
    """Each episode's probe is the probe of that episode alone; float64
    features give float64 logits of the same optimum."""
    sup, sup_y, qry = _probe_episodes()
    args = (torch.from_numpy(sup), torch.from_numpy(sup_y), torch.from_numpy(qry))
    batched = finetuning.sklearn_probe_logits(*args, 5, 1.0).numpy()
    alone = finetuning.sklearn_probe_logits(*(a[2:3] for a in args), 5, 1.0).numpy()
    np.testing.assert_allclose(_centred(batched[2:3]), _centred(alone), atol=1e-5, rtol=0)
    wide = finetuning.sklearn_probe_logits(args[0].double(), args[1], args[2].double(), 5, 1.0)
    assert wide.dtype == torch.float64
    np.testing.assert_allclose(_centred(wide.numpy()), _centred(batched), atol=PROBE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["RFSModel", "SKDModel"])
def test_probe_heads_fit_normalised_features_at_c_one(name):
    """RFSModel and SKDModel evaluate by the probe at C = 1 on features
    L2-normalised with + 1e-5, as the JAX package."""
    case = name if name == "SKDModel" else "RFSModel:distill"
    method = build_method(config(case))
    sup, sup_y, qry = _episode_features(2, d=120)
    s, q = torch.from_numpy(3.0 * sup).float(), torch.from_numpy(3.0 * qry).float()
    got = method.episode_head_logits(s, torch.from_numpy(sup_y), q, 5).numpy()
    jm = jax_build_method(config(case))
    ref = np.asarray(jax.jit(jax.vmap(lambda a, y, b: jm._episode_head_logits(
        a, y, b, 0, way=5)))(s.numpy(), sup_y, q.numpy()))
    np.testing.assert_allclose(_centred(got), _centred(ref), atol=PROBE_ATOL, rtol=0)


# -- weights across the packages --------------------------------------------------------------

@pytest.mark.parametrize("case", ["Baseline", "BaselinePlus", "SKDModel"])
def test_head_weights_cross_under_the_reference_names(case):
    """``classifier`` (no bias on the cosine heads) and SKDModel's
    ``rot_classifier`` come across from the JAX package's Dense kernels,
    transposed to ``[out, in]``."""
    variables = jax_variables(case)
    method = port_method(case, variables)
    params = variables["params"]
    np.testing.assert_array_equal(method.classifier.weight.detach().numpy(),
                                  params["classifier"]["kernel"].T)
    assert (method.classifier.bias is None) == (case == "BaselinePlus")
    if case == "SKDModel":
        np.testing.assert_array_equal(method.rot_classifier.weight.detach().numpy(),
                                      params["rot_classifier"]["kernel"].T)
        assert method.rot_classifier.weight.shape == (4, NUM_CLASS)

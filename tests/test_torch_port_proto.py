"""ProtoNet on Conv64F in the PyTorch port against the JAX package on the
CPU: ``proto_logits`` in both modes, the loss and every gradient at
``is_flatten`` true and false (float32, and with a float64 backbone), the
per-episode accuracies of ``Test.test_loop``, a short SGD run against the
JAX ``Trainer``; ``build_method``'s knob injection, ``init_weights`` and the
``Trainer``'s ``init_type`` hook, the ``is_clap`` guard (``use_bpa`` builds),
the chip cells against the shipped YAML, and the CLIs on
``config/synthetic/proto_smoke.yaml``.

Float32 in both (``precision: fp32``), Conv64F at ``[1, 81, 90]`` (the
least input its pools leave a map of).  Dropout cannot draw JAX's masks:
train-mode parity makes it the identity on both sides inside the test
(``test_torch_port_conv4.py`` holds the port's dropout on its own).
Tolerances: loss 1e-5 of the logits' scale; gradients 1e-4 of their max
abs (``test_train_step_matches_jax`` says which); BN running statistics
1e-5; accuracies 1e-6 relative (float32 means of the same votes)."""

import inspect
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.heads.proto_net import proto_logits as jax_proto_logits  # noqa: E402
from audio_fewshot_tpu.models.init import init_weights as jax_init_weights  # noqa: E402
from audio_fewshot_tpu.registry import CLASSIFIERS as JAX_CLASSIFIERS  # noqa: E402
import audio_fewshot_tpu.train as jax_train_module  # noqa: E402
from audio_fewshot_tpu.train import Trainer as JaxTrainer  # noqa: E402
from audio_fewshot_tpu.utils.meters import TensorboardWriter as JaxTensorboardWriter  # noqa: E402
from audio_fewshot_tpu.utils.aggregate import vote_categorical_acc as jax_vote_acc  # noqa: E402
import audio_fewshot_tpu_torch.eval as port_eval_module  # noqa: E402
import audio_fewshot_tpu_torch.train as port_train_module  # noqa: E402
from audio_fewshot_tpu_torch import run_test, run_trainer, run_trainer_resume  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.eval import Test, slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method, eval_setting, train_setting  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.layers import Dropout  # noqa: E402
from audio_fewshot_tpu_torch.models.heads.proto_net import ProtoNet, proto_logits  # noqa: E402
from audio_fewshot_tpu_torch.models.init import init_weights  # noqa: E402
from audio_fewshot_tpu_torch.registry import BACKBONES, CLASSIFIERS  # noqa: E402
from audio_fewshot_tpu_torch.train import Trainer, slice_config as train_cell  # noqa: E402
from audio_fewshot_tpu_torch.utils.aggregate import vote_categorical_acc  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402
from audio_fewshot_tpu_torch.utils.meters import TensorboardWriter  # noqa: E402
from audio_fewshot_tpu_torch.utils.seed import init_seed  # noqa: E402

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-4       # of a gradient's max abs
STATS_TOL = 1e-5      # BN running statistics, rtol and atol
ACC_RTOL = 1e-6


def proto_config(**over):
    cfg = {
        "classifier": {"name": "ProtoNet", "kwargs": None},
        "backbone": {"name": "Conv64F", "kwargs": {"num_channels": 1, "is_flatten": True}},
        "data_root": "synthetic:10:12", "spec_shape": [1, 81, 90],
        "way_num": 5, "shot_num": 2, "query_num": 2, "train_episode": 3,
        "test_episode": 4, "test_episode_size": 2, "test_epoch": 2,
        "max_segments_per_clip": 3, "segment_bucket_sizes": [32],
        "precision": "fp32", "seed": 0, "prefetch": 0, "augment": False,
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.005}, "other": None},
    }
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


def flatten_kwargs(is_flatten, **extra):
    return {"backbone": {"name": "Conv64F",
                         "kwargs": {"num_channels": 1, "is_flatten": is_flatten, **extra}}}


@pytest.fixture
def no_tensorboard(monkeypatch):
    """Both packages' TensorBoard writers as they are without tensorboard
    installed (no-ops): importing tensorboard pulls in TensorFlow on some
    hosts, seconds a process, and no test here reads the event files."""

    for module, writer in ((port_train_module, TensorboardWriter),
                           (jax_train_module, JaxTensorboardWriter)):
        class NoWriter(writer):
            def __init__(self, log_dir):
                self.step, self._writer = 0, None

        monkeypatch.setattr(module, "TensorboardWriter", NoWriter)


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout made the identity in both packages."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port_state(variables, params=None, stats=None):
    tree = {"params": params if params is not None else variables["params"],
            "batch_stats": stats if stats is not None else variables["batch_stats"]}
    return {k: v.numpy() for k, v in
            state_dict_from_jax(tree, "Conv64F", prefix="emb_func.").items()}


_INIT = {}


def _jax_init():
    """The JAX ProtoNet/Conv64F (``is_flatten``) initial variables at
    ``proto_config()``, made once and shared by the tests.  Eager, as the
    JAX ``Trainer`` initialises: its own init then finds these shapes'
    operations compiled."""
    if not _INIT:
        cfg = proto_config()
        batch = next(iter(jax_get_dataloader(cfg, "train")[0].epoch(0)))
        variables = jax_build_method(cfg).init_variables(jax.random.PRNGKey(0), batch,
                                                          train_setting(cfg))
        _INIT["variables"] = jax.tree_util.tree_map(np.asarray, variables)
    return _INIT["variables"]


def _jax_variables(is_flatten=True, seed=1):
    """``_jax_init``'s variables (without the logits head unless
    ``is_flatten``) with non-trivial BatchNorm statistics."""
    variables = {col: {"emb_func": {k: v for k, v in tree["emb_func"].items()
                                    if is_flatten or not k.startswith("logits")}}
                 for col, tree in _jax_init().items()}
    return randomize_batchnorm(variables, np.random.default_rng(seed))


# -- the head ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["euclidean", "cos_sim"])
@pytest.mark.parametrize("shot", [1, 5])
def test_proto_logits_match_jax(mode, shot):
    rng = np.random.default_rng(shot)
    sup = rng.normal(size=(3, 5 * shot, 40)).astype(np.float32)
    qry = rng.normal(size=(3, 7, 40)).astype(np.float32)
    ref = np.asarray(jax_proto_logits(qry, sup, 5, shot, mode))
    ours = proto_logits(torch.from_numpy(qry), torch.from_numpy(sup), 5, shot, mode).numpy()
    assert ours.shape == (3, 7, 5)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="unknown proto mode"):
        proto_logits(torch.from_numpy(qry), torch.from_numpy(sup), 5, shot, "manhattan")


def test_vote_categorical_acc_matches_jax():
    rng = np.random.default_rng(0)
    targets, preds = rng.integers(0, 5, 50), rng.integers(0, 5, 50)
    assert float(vote_categorical_acc(torch.from_numpy(targets), torch.from_numpy(preds))) == \
        pytest.approx(float(jax_vote_acc(targets, preds)), rel=ACC_RTOL)


# -- one train step ---------------------------------------------------------------

def _jax_step(jax_method, variables, batch, setting):
    non_params = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        return jax_method.loss({**non_params, "params": params}, batch, setting,
                               jax.random.PRNGKey(1))

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return (float(loss), float(out.metrics["acc"]), jax.tree_util.tree_map(np.asarray, grads),
            jax.tree_util.tree_map(np.asarray, out.updates["batch_stats"]))


def _port_step(cfg, variables, batch, setting, backbone_dtype=torch.float32):
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(variables, "Conv64F", prefix="emb_func."))
    emb = method.emb_func
    if backbone_dtype != torch.float32:  # the blocks only: the head stays float32
        emb.dtype = backbone_dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(backbone_dtype)
    method.train()
    loss, out = method.loss(batch.to("cpu"), setting)
    loss.backward()
    return method, loss.item(), out


@pytest.mark.parametrize("is_flatten", [True, False], ids=["flatten", "map"])
def test_train_step_matches_jax(is_flatten, no_dropout):
    """Loss, every gradient and the BN running statistics after one step,
    the port in float32 and with a float64 backbone (the logits head is
    float32 in both packages), against the JAX package with a float64
    backbone.

    - Gradients are held relative to their own max abs where it is at
      least a tenth of the largest gradient's, else to a tenth of the
      largest: several are zero in exact arithmetic (a conv bias before a
      train-mode BN; a bias that shifts every feature alike, which the
      prototype distances cancel), so their float values are noise.
    - The JAX package's float32 gradients are not the reference: its
      one-pass train-mode BN variance puts them up to 1.2e-3 of the largest
      gradient from its own float64 ones in the ``map`` case (measured),
      against 7e-6 for the port's float32.
    - The loss: |Δ| ≤ 1e-5 of the logits' max abs (a loss moves by at most
      its largest logit change; -|q - p|² cancels in float32).
    - ``flatten``: the random 1600-wide head puts the classes so far apart
      that the loss is 0; its kernel is scaled by 0.02 (loss ≈ 1.2)."""
    cfg = proto_config(**flatten_kwargs(is_flatten))
    setting = train_setting(cfg)
    jax_batch = next(iter(jax_get_dataloader(cfg, "train")[0].epoch(0)))
    batch = next(iter(get_dataloader(cfg, "train")[0].epoch(0)))
    np.testing.assert_array_equal(batch.query, np.asarray(jax_batch.query))
    variables = _jax_variables(is_flatten)
    if is_flatten:
        dense = variables["params"]["emb_func"]["logits_dense"]
        dense["kernel"] = dense["kernel"] * np.float32(0.02)
    with jax.enable_x64(True):
        jax64 = jax_build_method(proto_config(**flatten_kwargs(is_flatten, dtype="float64")))
        ref_loss, ref_acc, ref_grads, ref_stats = _jax_step(jax64, variables, jax_batch, setting)
    grads = _port_state(variables, params=ref_grads)
    largest = max(np.abs(g).max() for g in grads.values())
    stats = _port_state(variables, stats=ref_stats)
    for dtype in (torch.float32, torch.float64):
        method, loss, out = _port_step(cfg, variables, batch, setting, dtype)
        scale = out.seg_logits.detach().abs().max().item()
        assert loss > 0.1  # not a saturated softmax
        assert abs(loss - ref_loss) <= 1e-5 * scale
        assert float(out.metrics["acc"]) == pytest.approx(ref_acc, rel=ACC_RTOL)
        names = dict(method.named_parameters())
        assert len(names) == 4 * 4 + (4 if is_flatten else 0)
        for name, p in names.items():
            assert p.grad is not None, name
            ours, ref = p.grad.double().numpy(), grads[name].reshape(p.shape)
            tol = GRAD_TOL * max(np.abs(ref).max(), 0.1 * largest)
            assert np.abs(ours - ref).max() <= tol, (dtype, name)
        for key, val in method.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(val.double().numpy(), stats[key],
                                           rtol=STATS_TOL, atol=STATS_TOL, err_msg=key)


def test_use_bpa_and_is_clap_raise():
    """``use_bpa`` builds since BPA is ported (``test_torch_port_bpa.py``
    holds it against the JAX package); ``is_clap`` still raises."""
    assert build_method(proto_config(classifier={"name": "ProtoNet",
                                                 "kwargs": {"use_bpa": True}})).use_bpa
    with pytest.raises(NotImplementedError, match="the CLAP encoder"):
        build_method(proto_config(is_clap=True))


# -- evaluation ---------------------------------------------------------------------

def _recording(monkeypatch, module):
    seen = []
    inner = module.mean_confidence_interval

    def record(values, *args, **kwargs):
        seen.append(list(values))
        return inner(values, *args, **kwargs)

    monkeypatch.setattr(module, "mean_confidence_interval", record)
    return seen


def test_test_loop_episode_accuracies_match_jax(tmp_path, monkeypatch):
    """The port's ``Test`` reading the JAX package's (randomised) weights
    from its model_best.pth: every episode's accuracy of both test epochs,
    and the epoch means, are the JAX package's on the same episodes (its
    ``forward`` and ``eval_episode_accuracy``, as its ``Test`` runs them);
    the segment logits agree; no val pass runs for ProtoNet."""
    cfg = proto_config(test_episode=4)
    jax_method = jax_build_method(cfg)
    setting = eval_setting(cfg)
    loader = jax_get_dataloader(cfg, "test")[0]
    variables = _jax_variables()

    @jax.jit
    def jax_step(v, b):
        logits = jax_method.forward(v, b, setting)
        return logits, jax_method.eval_episode_accuracy(logits, b)

    ref_logits, ref_accs = [], []
    for epoch in range(cfg["test_epoch"]):
        accs = []
        for batch in loader.epoch(epoch):
            logits, acc = jax_step(variables, batch)
            accs += np.asarray(acc).tolist()
            if epoch == 0:
                ref_logits.append(np.asarray(logits))
        ref_accs.append(accs)
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(variables, "Conv64F", prefix="emb_func."))
    save_model_best(str(tmp_path), method)
    seen = _recording(monkeypatch, port_eval_module)
    test = Test(0, cfg, str(tmp_path), device="cpu")
    test.test_loop()
    assert test.val_loader is None and test.val_bank is None
    assert len(seen) == cfg["test_epoch"] + 1 and all(len(a) == 4 for a in ref_accs)
    for ours, ref in zip(seen, ref_accs, strict=False):
        np.testing.assert_allclose(ours, ref, rtol=ACC_RTOL)
    np.testing.assert_allclose(seen[-1], [np.mean(a) for a in ref_accs], rtol=ACC_RTOL)
    # the synthetic classes are separable (every episode scores 100 %):
    # the segment logits carry the comparison
    for host_batch, ref in zip(get_dataloader(cfg, "test")[0].epoch(0), ref_logits, strict=True):
        with torch.no_grad():
            logits = test.method(host_batch.to("cpu"), setting).numpy()
        assert logits.shape == ref.shape == (2, 32, 5)
        assert _rel(logits, ref) <= GRAD_TOL


# -- training -------------------------------------------------------------------------

def _losses(trainer):
    return [loss for record in trainer.history for loss in record["train_losses"]]


def test_sgd_run_matches_the_jax_trainer(tmp_path, no_dropout, no_tensorboard):
    """Two epochs × three steps with SGD (momentum 0.9, lr 5e-5; Adam's ±lr
    updates part two float32 runs after a step or two): per-step losses,
    val/test accuracies and the best/last bookkeeping."""
    sgd = {"name": "SGD", "kwargs": {"lr": 5e-5, "momentum": 0.9}, "other": None}
    over = dict(epoch=2, optimizer=sgd, result_root=str(tmp_path / "jax"),
                lr_scheduler={"name": "CosineAnnealingLR", "kwargs": {"T_max": 100, "eta_min": 0}},
                save_interval=1, compilation_cache=False)
    ref = JaxTrainer(0, proto_config(**over))
    ref_losses = []
    step = ref._jit_train_step

    def recording_step(*args, **kwargs):
        out = step(*args, **kwargs)
        ref_losses.append(float(out[2]["loss"]))
        return out

    ref._jit_train_step = recording_step
    init = jax.tree_util.tree_map(np.asarray, ref.variables)
    ref_best = ref.train_loop()
    ours = Trainer(0, proto_config(**dict(over, result_root=str(tmp_path / "port"))), device="cpu")
    ours.method.load_state_dict(state_dict_from_jax(init, "Conv64F", prefix="emb_func."))
    best = ours.train_loop()
    assert len(_losses(ours)) == len(ref_losses) == 6
    np.testing.assert_allclose(_losses(ours), ref_losses, rtol=GRAD_TOL)
    assert best == pytest.approx(ref_best, rel=1e-5)
    assert sorted(os.listdir(ours.ckpt_dir)) == sorted(os.listdir(ref.ckpt_dir))


# -- build_method's knob injection ------------------------------------------------------

class _BatchStatHead(ProtoNet):
    """A test-only classifier with the MAML family's knobs."""
    requires_batch_stat_bn = True
    backbone_kwarg_defaults = {"logits_bn_running_statistics": True}


@pytest.fixture
def batch_stat_head(monkeypatch):
    monkeypatch.setitem(CLASSIFIERS._factories, "BatchStatHead", _BatchStatHead)
    jax_head = type("BatchStatHead", (JAX_CLASSIFIERS.get("ProtoNet"),), {
        "requires_batch_stat_bn": True,
        "backbone_kwarg_defaults": {"logits_bn_running_statistics": True}})
    monkeypatch.setitem(JAX_CLASSIFIERS._factories, "BatchStatHead", jax_head)
    return {"name": "BatchStatHead", "kwargs": None}


def test_build_method_injects_the_classifier_knobs_where_the_backbone_takes_them(batch_stat_head):
    cfg = proto_config(classifier=batch_stat_head)
    ours, ref = build_method(cfg).emb_func, jax_build_method(cfg).emb_func
    assert ref.use_running_statistics is False and ref.logits_bn_running_statistics is True
    assert all(not m[1].track_running_stats for m in (ours.layer1, ours.layer2, ours.layer3,
                                                      ours.layer4))
    assert ours.logits[1].track_running_stats
    # the config's own kwarg wins over the injected default
    cfg = proto_config(classifier=batch_stat_head,
                       **flatten_kwargs(True, logits_bn_running_statistics=False))
    assert not build_method(cfg).emb_func.logits[1].track_running_stats
    assert jax_build_method(cfg).emb_func.logits_bn_running_statistics is False
    # a backbone without the knob does not get it (resnet12Bdc has no logits BN)
    bdc = {"name": "resnet12Bdc", "kwargs": {"num_channels": 1, "reduce_dim": 8}}
    cfg = proto_config(classifier=batch_stat_head, backbone=bdc)
    emb = build_method(cfg).emb_func
    assert not emb.layer1[0].bn1.track_running_stats
    assert jax_build_method(cfg).emb_func.use_running_statistics is False
    # a user-given kwarg the backbone does not take still raises
    with pytest.raises(TypeError, match="no_such_knob"):
        build_method(proto_config(**flatten_kwargs(True, no_such_knob=1)))


def test_build_method_filters_injected_knobs_by_the_factory_signature(batch_stat_head,
                                                                     monkeypatch):
    """A backbone factory whose signature names its kwargs gets only the
    injected knobs it names, without a trial call."""
    calls = []

    def sig_backbone(num_channels=1, dtype=None, use_running_statistics=True):
        calls.append(use_running_statistics)
        return torch.nn.Identity()

    monkeypatch.setitem(BACKBONES._factories, "SigBackbone", sig_backbone)
    build_method(proto_config(classifier=batch_stat_head,
                              backbone={"name": "SigBackbone", "kwargs": None}))
    assert calls == [False]  # one call: spec_shape and the logits knob filtered out


@pytest.mark.parametrize("name", ["Conv64F", "Conv32F", "R2D2Embedding", "Conv64F_MCL",
                                  "resnet12Bdc"])
def test_registered_backbones_state_the_kwargs_they_take(name):
    """Every registered backbone's factory names its kwargs (no ``**kwargs``
    in its signature), so the injected knobs are filtered by the signature
    alone: ``spec_shape`` reaches Conv64F and nothing else."""
    params = inspect.signature(BACKBONES.get(name)).parameters
    assert not any(p.kind is p.VAR_KEYWORD for p in params.values())
    assert {"num_channels", "dtype", "use_running_statistics"} <= set(params)
    assert ("spec_shape" in params) == (name == "Conv64F")


# -- init_weights and the Trainer's init_type ---------------------------------------

EXPECTED_STD = {  # of a weight with these fans
    "normal": lambda fan_in, fan_out: 0.02,
    "kaiming": lambda fan_in, fan_out: math.sqrt(2.0 / fan_in),
    "xavier": lambda fan_in, fan_out: math.sqrt(2.0 / (fan_in + fan_out)),
    "orthogonal": None,
}


@pytest.mark.parametrize("init_type", sorted(EXPECTED_STD))
def test_init_weights_redraws_what_jax_redraws_with_its_std(init_type):
    """Exactly the Conv and Linear weights change (not biases, not norm
    scales), in both packages; their standard deviations agree with each
    other and with the initialiser's (within 5 %: the smallest layer, the
    first conv, has 576 entries)."""
    variables = _jax_init()
    redrawn = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, k: jax_init_weights(p, init_type, k))(variables["params"], jax.random.PRNGKey(3)))
    before, ref = _port_state(variables), _port_state(variables, params=redrawn)
    method = build_method(proto_config())
    method.load_state_dict({k: torch.from_numpy(v) for k, v in before.items()})
    init_weights(method, init_type, torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in method.state_dict().items()}
    changed = {k for k in state if not np.array_equal(state[k], before[k])}
    ref_changed = {k for k in ref if not np.array_equal(ref[k], before[k])}
    assert changed == ref_changed
    assert changed == {f"emb_func.layer{i}.0.weight" for i in range(1, 5)} | {
        "emb_func.logits.2.weight"}
    for key in changed:
        w = torch.from_numpy(state[key])
        fan_in, fan_out = torch.nn.init._calculate_fan_in_and_fan_out(w)
        ours_std, ref_std = float(state[key].std()), float(ref[key].std())
        assert ours_std == pytest.approx(ref_std, rel=0.05), key
        if EXPECTED_STD[init_type] is not None:
            assert ours_std == pytest.approx(EXPECTED_STD[init_type](fan_in, fan_out), rel=0.05)
        else:  # orthogonal: the flattened weight has orthonormal rows or columns
            flat = w.reshape(w.shape[0], -1).double()
            gram = flat @ flat.T if flat.shape[0] <= flat.shape[1] else flat.T @ flat
            torch.testing.assert_close(gram, torch.eye(gram.shape[0], dtype=torch.float64),
                                       rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="unknown init_type"):
        init_weights(method, "uniform", torch.Generator())


def test_trainer_applies_init_type(tmp_path, no_tensorboard):
    """``init_type`` in a config redraws the Trainer's initial weights (the
    Trainer seeds the process, then builds the method, as here)."""
    init_seed(0)
    a = build_method(proto_config()).state_dict()
    drawn = Trainer(0, proto_config(result_root=str(tmp_path / "b"), init_type="kaiming"),
                    device="cpu")
    b = drawn.method.state_dict()
    w = b["emb_func.logits.2.weight"]
    assert not torch.equal(a["emb_func.layer2.0.weight"], b["emb_func.layer2.0.weight"])
    assert float(w.std()) == pytest.approx(math.sqrt(2.0 / w.shape[1]), rel=0.05)
    torch.testing.assert_close(a["emb_func.layer2.0.bias"], b["emb_func.layer2.0.bias"],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown init_type"):
        Trainer(0, proto_config(result_root=str(tmp_path / "c"), init_type="uniform"),
                device="cpu")


# -- the chip cells and the CLIs ----------------------------------------------------

@pytest.mark.parametrize("kind", ["eval", "train"])
def test_chip_cells_are_the_shipped_proto_config_cut_to_size(kind, tmp_path):
    """The ProtoNet cells ``chip_smoke.py`` runs are the shipped YAML with
    its headers but for the cuts they name (the eval cell: every key that
    evaluation reads)."""
    shipped = Config(os.path.join(REPO, "config", "proto", "proto_5shot_iid_seed0.yaml")) \
        .get_config_dict()
    if kind == "eval":
        cell = eval_cell(classifier="ProtoNet")
        cuts = {"test_episode": (600, 64), "test_epoch": (5, 2), "test_episode_size": (None, 16),
                "max_segments_per_clip": (8, 6), "spec_shape": (None, [1, 128, 157])}
        kept = ("classifier", "backbone", "modality", "test_way", "test_shot", "test_query",
                "augment_times", "seed", "ood", "tag")
    else:
        cell = train_cell(str(tmp_path), classifier="ProtoNet")
        cuts = {"epoch": (30, 2), "train_episode": (1000, 40), "test_episode": (600, 32),
                "result_root": ("./results", str(tmp_path)), "tb_scale": (1000 / 600, 40 / 32),
                "spec_shape": (None, [1, 128, 157])}
        kept = [k for k in shipped if k not in cuts and k != "includes"]
    for key, (full, cut) in cuts.items():
        assert (shipped.get(key), cell.get(key)) == (full, cut), key
    for key in kept:
        assert cell.get(key) == shipped[key], key
    assert cell["precision"] == "bf16" and cell["backbone"]["kwargs"]["is_flatten"] is True
    assert cell["data_root"] == "synthetic"
    model = build_method(cell)
    assert model.emb_func.logits[2].in_features == 64
    assert model.emb_func.logits[2].out_features == 1600


def test_clis_train_resume_and_test_on_proto_smoke(tmp_path, no_tensorboard):
    """``config/synthetic/proto_smoke.yaml`` (is_flatten on, so dropout
    draws) through ``run_trainer`` for one epoch, ``run_trainer_resume`` for
    a second and ``run_test`` on the result."""
    yaml_path = os.path.join(REPO, "config", "synthetic", "proto_smoke.yaml")
    first = run_trainer.main(["--yaml_path", yaml_path, "--result_root", str(tmp_path),
                              "--epoch", "1", "--device", "cpu", "--train_episode", "2",
                              "--test_episode", "2", "--precision", "fp32",
                              "--backbone.kwargs.is_flatten", "true"])
    assert [r["epoch"] for r in first.history] == [0]
    resumed = run_trainer_resume.main([first.result_dir, "--device", "cpu", "--epoch", "2"])
    assert resumed.start_epoch == 1 and [r["epoch"] for r in resumed.history] == [1]
    assert isinstance(resumed.method, ProtoNet) and resumed.method.emb_func.is_flatten
    assert all(np.isfinite(_losses(first) + _losses(resumed)))
    run_test.main([first.result_dir, "--device", "cpu", "--test_episode", "2"])
    log = open(os.path.join(first.result_dir, "log_files", "ProtoNet-Conv64F-test.log")).read()
    assert "loaded checkpoint" in log and "Aggregated: Acc@1" in log
    assert "Calibration pass" not in log  # ProtoNet has no energy-OOD pass

"""BPA (``ops/bpa.py``) and its ``use_bpa`` switch in the PyTorch port
against the JAX package on the CPU: ``log_sinkhorn`` and ``bpa_transform``
(cosine and euclidean costs, known labels, a ``row_mask``), ``apply_bpa``,
ProtoNet on Conv64F with ``use_bpa`` (eval logits, a train step), DeepBDC
on resnet12Bdc with ``use_bpa`` (eval logits, the calibration pass) and
``tta_eval_step``'s re-vote with BPA on the JAX package's own augmented
segments (handed in through the ``augment`` hook), in float32.

Tolerances: transport plans and affinities 1e-5 of their max (the same
ten log-space iterations; the logsumexps sum in another order); logits
1e-4 of their max abs, as ``test_torch_port_slice.py``; a train step as
``test_torch_port_proto.py`` (gradients 1e-4 of their max abs against the
JAX package with a float64 backbone, a gradient that vanishes in exact
arithmetic 1e-3 of the largest); accuracies 1e-6 relative.  Bucket padding:
the JAX package's marginals are log(mask / n + 1e-8), so a padded row keeps
1e-8 of transport mass; with 4 padded rows among 24 the real rows' logits
moved 1.02e-5 of their scale (measured, 1.01e-5 in float64: the floor, not
rounding), held at ``PAD_TOL`` = 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402

import audio_fewshot_tpu.eval as jax_eval  # noqa: E402
from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.heads.proto_net import apply_bpa as jax_apply_bpa  # noqa: E402
from audio_fewshot_tpu.ops import audio_augmentations as jaug  # noqa: E402
from audio_fewshot_tpu.ops import bpa as jax_bpa  # noqa: E402
from audio_fewshot_tpu.parallel import get_mesh  # noqa: E402
from audio_fewshot_tpu_torch import eval as port_eval  # noqa: E402
from audio_fewshot_tpu_torch.data import get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method, eval_setting, train_setting  # noqa: E402
from audio_fewshot_tpu_torch.models.heads.deepbdc import DeepBDC  # noqa: E402
from audio_fewshot_tpu_torch.models.heads.proto_net import apply_bpa, proto_logits  # noqa: E402
from audio_fewshot_tpu_torch.ops import bpa  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

from test_torch_port_augment import MEAN, STD  # noqa: E402
from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_proto import (  # noqa: E402
    _jax_step, _jax_variables, _port_state, no_dropout, proto_config)  # noqa: F401
from test_torch_port_slice import slice_config  # noqa: E402

PLAN_TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4
PAD_TOL = 1e-4
ACC_RTOL = 1e-6
USE_BPA = {"kwargs": {"use_bpa": True}}


def _close(ours, ref, tol):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * np.abs(ref).max())


def _mask(e, n, pad):
    """``[e, n]`` row masks: the last ``pad`` rows of each set are padding."""
    mask = np.ones((e, n), np.float32)
    mask[:, n - pad:] = 0.0
    return mask


# -- the transform -----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["dense", "row_mask"])
def test_log_sinkhorn_matches_jax(masked):
    rng = np.random.default_rng(0)
    cost = rng.uniform(size=(2, 9, 9)).astype(np.float32)
    mask = _mask(2, 9, 3) if masked else None
    ref = np.exp(np.asarray(jax_bpa.log_sinkhorn(cost, mask=mask)))
    ours = torch.exp(bpa.log_sinkhorn(torch.from_numpy(cost), mask=None if mask is None
                                      else torch.from_numpy(mask)))
    _close(ours, ref, PLAN_TOL)
    if masked:  # the padded rows and columns carry no transport
        assert ours[:, 6:].sum() <= 1e-6 * ours.sum() and ours[..., 6:].sum() <= 1e-6 * ours.sum()


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "row_mask"])
@pytest.mark.parametrize("labelled", [False, True], ids=["unlabelled", "labels"])
@pytest.mark.parametrize("distance", ["cosine", "euclidean"])
def test_bpa_transform_matches_jax(distance, labelled, masked):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    kwargs = {"distance": distance}
    if labelled:
        kwargs.update(n_labeled=6, num_classes=3)
    labels = np.array([0, 0, 1, 1, 2, 2] + [0] * 6) if labelled else None
    mask = _mask(2, 12, 4) if masked else None
    ref = np.asarray(jax_bpa.bpa_transform(x, labels=labels, row_mask=mask, **kwargs))
    ours = bpa.bpa_transform(torch.from_numpy(x), None if labels is None else torch.from_numpy(labels),
                             row_mask=None if mask is None else torch.from_numpy(mask), **kwargs)
    _close(ours, ref, PLAN_TOL)
    assert torch.equal(torch.diagonal(ours, dim1=-2, dim2=-1), torch.ones(2, 12))
    if labelled:
        assert float(ours[0, 0, 1]) == 1.0 and float(ours[0, 0, 2]) == 0.0


def test_apply_bpa_matches_jax_and_ignores_bucket_padding():
    """``apply_bpa`` over [support ‖ query] with 4 padded query rows against
    the JAX package's; the prototype logits of the real rows are those of
    the unpadded set (the padded rows keep only the marginal's 1e-8
    floor)."""
    rng = np.random.default_rng(2)
    sup = rng.normal(size=(2, 10, 40)).astype(np.float32)
    qry = rng.normal(size=(2, 14, 40)).astype(np.float32)
    mask = _mask(2, 14, 4)
    ref_s, ref_q = jax_apply_bpa(sup, qry, mask)
    ours_s, ours_q = apply_bpa(torch.from_numpy(sup), torch.from_numpy(qry), torch.from_numpy(mask))
    _close(ours_s, ref_s, PLAN_TOL)
    _close(ours_q, ref_q, PLAN_TOL)
    padded = proto_logits(ours_q, ours_s, 5, 2)[:, :10]
    dense_s, dense_q = apply_bpa(torch.from_numpy(sup), torch.from_numpy(qry[:, :10]),
                                 torch.ones(2, 10))
    dense = proto_logits(dense_q, dense_s, 5, 2)
    assert (padded - dense).abs().max() <= PAD_TOL * dense.abs().max()


# -- ProtoNet with use_bpa ------------------------------------------------------------

def bpa_proto_config(**backbone):
    """``test_torch_port_proto.py``'s config, ``use_bpa`` on Conv64F's map."""
    kwargs = {"num_channels": 1, "is_flatten": False, **backbone}
    return proto_config(classifier={"name": "ProtoNet", **USE_BPA},
                        backbone={"name": "Conv64F", "kwargs": kwargs})


def test_protonet_with_bpa_eval_logits_match_jax():
    cfg = bpa_proto_config()
    setting = eval_setting(cfg)
    variables = _jax_variables(is_flatten=False)
    jax_method = jax_build_method(cfg)
    method = build_method(cfg)
    assert method.use_bpa and jax_method.use_bpa
    method.load_state_dict(state_dict_from_jax(variables, "Conv64F", prefix="emb_func."))
    method.eval()
    forward = jax.jit(lambda v, b: jax_method.forward(v, b, setting))
    batches = zip(jax_get_dataloader(cfg, "test")[0].epoch(0),
                  get_dataloader(cfg, "test")[0].epoch(0), strict=True)
    for jax_batch, host_batch in batches:
        batch = host_batch.to("cpu")
        assert float(batch.query_mask.min()) == 0.0  # bucket-padded rows are there
        with torch.no_grad():
            ours = method(batch, setting)
        _close(ours, forward(variables, jax_batch), LOGIT_TOL)


def test_protonet_with_bpa_train_step_matches_jax(no_dropout):  # noqa: F811
    """Loss and every gradient of a train step through the transform, the
    port in float32 against the JAX package with a float64 backbone."""
    cfg = bpa_proto_config()
    setting = train_setting(cfg)
    jax_batch = next(iter(jax_get_dataloader(cfg, "train")[0].epoch(0)))
    batch = next(iter(get_dataloader(cfg, "train")[0].epoch(0))).to("cpu")
    variables = _jax_variables(is_flatten=False)
    with jax.enable_x64(True):
        jax64 = jax_build_method(bpa_proto_config(dtype="float64"))
        ref_loss, _, ref_grads, ref_stats = _jax_step(jax64, variables, jax_batch, setting)
    grads = _port_state(variables, params=ref_grads)
    stats = _port_state(variables, stats=ref_stats)
    largest = max(np.abs(g).max() for g in grads.values())
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(variables, "Conv64F", prefix="emb_func."))
    method.train()
    loss, out = method.loss(batch, setting)
    loss.backward()
    scale = out.seg_logits.detach().abs().max().item()
    assert loss.item() > 0.1
    assert abs(loss.item() - ref_loss) <= 1e-5 * scale
    for name, p in method.named_parameters():
        ref = grads[name].reshape(p.shape)
        vanishes = np.abs(ref).max() <= 1e-9 * largest
        tol = 1e-3 * largest if vanishes else GRAD_TOL * max(np.abs(ref).max(), 0.1 * largest)
        assert np.abs(p.grad.double().numpy() - ref).max() <= tol, name
    for key, val in method.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(val.double().numpy(), stats[key], rtol=1e-5, atol=1e-5)


# -- DeepBDC with use_bpa, and the TTA re-vote ---------------------------------------------

@pytest.fixture(scope="module")
def bdc_models():
    """DeepBDC with ``use_bpa`` at the weights of ``test_torch_port_slice.py``'s
    cell, in both packages."""
    cfg = slice_config(classifier={"name": "DeepBDC", **USE_BPA})
    jax_method = jax_build_method(cfg)
    setting = eval_setting(cfg)
    example = next(iter(jax_get_dataloader(cfg, "test")[0].epoch(0)))
    variables = jax.jit(lambda k, b: jax_method.init_variables(k, b, setting))(
        jax.random.PRNGKey(0), example)
    variables = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, variables),
                                    np.random.default_rng(1))
    method = build_method(cfg)
    assert method.use_bpa and jax_method.use_bpa
    method.load_state_dict(state_dict_from_jax(variables, "resnet12Bdc", prefix="emb_func."))
    return cfg, setting, jax_method, variables, method.eval()


def test_deepbdc_with_bpa_logits_and_calibration_match_jax(bdc_models):
    """Eval logits over ragged, bucket-padded episodes, and the calibration
    pass, which goes through ``forward`` and so through the transform."""
    cfg, setting, jax_method, variables, method = bdc_models
    forward = jax.jit(lambda v, b: jax_method.forward(v, b, setting))
    for jax_batch, host_batch in zip(jax_get_dataloader(cfg, "test")[0].epoch(0),
                                     get_dataloader(cfg, "test")[0].epoch(0), strict=True):
        with torch.no_grad():
            ours = method(host_batch.to("cpu"), setting)
        _close(ours, forward(variables, jax_batch), LOGIT_TOL)
    ref = jax_method.calibrate_threshold(variables, jax_get_dataloader(cfg, "val")[0], setting,
                                         get_mesh(1))
    ours = method.calibrate_threshold(get_dataloader(cfg, "val")[0], setting)
    assert ours is not None and ours == pytest.approx(ref, rel=LOGIT_TOL)


def test_tta_re_vote_with_bpa_matches_jax(bdc_models, monkeypatch):
    """``tta_eval_step`` with BPA: the base vote on transformed support and
    query, each flagged clip's augmented segments transformed anew beside the
    raw support.  The JAX package's step with its own draws, the port's on
    the JAX package's augmented segments: the same segments gathered and the
    same per-episode accuracies; the re-vote changes a clip's vote."""
    cfg, setting, jax_method, variables, method = bdc_models
    jax_batch = next(iter(jax_get_dataloader(cfg, "test")[0].epoch(0)))
    batch = next(iter(get_dataloader(cfg, "test")[0].epoch(0))).to("cpu")
    seen = {}
    inner = jaug.batch_augment_spectrogram

    def recording(rng, specs, *args, **kwargs):
        out = inner(rng, specs, *args, **kwargs)
        jax.debug.callback(lambda a, b: seen.update({"in": np.array(a), "out": np.array(b)}),
                           specs, out)
        return out

    monkeypatch.setattr(jaug, "batch_augment_spectrogram", recording)
    kwargs = dict(tta_mean=MEAN, tta_std=STD, num_augmentations=4, tta_segments_per_clip=3)
    step = jax.jit(lambda v, b, r: jax_eval.tta_eval_step(jax_method, v, b, r, setting, **kwargs))
    ref = np.asarray(step(variables, jax_batch, jax.random.PRNGKey(7)))

    def given(segments, mean, std, m, generator):
        np.testing.assert_array_equal(segments.numpy(), seen["in"])
        return torch.from_numpy(seen["out"].copy())

    transformed = []
    inner_bpa = port_eval.apply_bpa
    monkeypatch.setattr(port_eval, "apply_bpa",
                        lambda *a: transformed.append(a[0].shape) or inner_bpa(*a))
    with torch.no_grad():
        ours = port_eval.tta_eval_step(method, batch, setting, None, augment=given, **kwargs)
    k = max(1, int(DeepBDC.ood_fraction * batch.query_target.numel()))
    # the episode set, then the flagged clips' sets with the raw support
    assert transformed == [(2, 25, 36), (k, 25, 36)]
    np.testing.assert_allclose(ours.numpy(), ref, rtol=ACC_RTOL)
    with torch.no_grad():
        plain = method.eval_episode_accuracy(method(batch, setting), batch)
        flipped = port_eval.tta_eval_step(method, batch, setting, None, augment=lambda s, *a:
                                          torch.zeros((s.shape[0] * 4,) + s.shape[1:]), **kwargs)
    assert not torch.equal(flipped, plain)

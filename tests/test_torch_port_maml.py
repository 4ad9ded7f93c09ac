"""MAML of the PyTorch port against the JAX package on the CPU, and the MAML
family's inner-loop contract (the geometry, weights and helpers of
``test_torch_port_meta.py``: Conv64F with ``is_flatten`` on ``[1, 81, 90]``
segments, 3-way 2-shot 2-query, inner LR 0.01, 5 train / 10 eval steps).

Tolerances (relative to the logits' scale, or to a gradient's max abs):
- eval logits: as ``test_torch_port_meta.py`` (the port in float32 to 1e-4
  of the JAX package with a float64 Conv64F, with a float64 Conv64F to
  3e-5; real rows with and without bucket padding to 1e-6);
- one second-order train step (5 inner steps) against ``jax.grad`` through
  the JAX package's ``lax.scan`` with a float64 Conv64F and a float64 head:
  loss and logits 3e-5 of the logits' scale, every gradient 5e-4 of its max
  abs (``GRAD_TOL``; a tenth of the largest where that is more), the port
  with a float64 and with a float32 Conv64F.  Both packages round the map to
  float32 and the port's head is float32: measured 1.2e-4 (float64 blocks)
  and 1.1e-4 (float32), where the JAX package's own float32 step is 2.2e-2
  off its float64 one.  The first-order gradient must miss the reference by
  more than ten times ``GRAD_TOL``;
- an episode's logits alone and beside other episodes: 1e-6 of the scale
  (``ALONE_TOL``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402

from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu_torch.episode import EpisodeBatch, segment_targets  # noqa: E402
from audio_fewshot_tpu_torch.models.base import masked_cross_entropy  # noqa: E402

from test_torch_port_meta import (  # noqa: E402
    SETTING, batches, check_eval_logits, jax_variables, meta_config, port_method,
    step_reference)
from test_torch_port_metric import _rel  # noqa: E402
from test_torch_port_resnet12_heads import _check_step  # noqa: E402

GRAD_TOL = 5e-4
ALONE_TOL = 1e-6
STEP_TOLS = {"logits": 3e-5, "grads": GRAD_TOL, "vanishing": 1e-3, "stats": 0.0}


def test_maml_eval_logits_match_jax_and_ignore_bucket_padding():
    """Ten inner steps an episode, each episode's query pass normalised over
    its own real rows."""
    check_eval_logits("MAML")


def test_maml_second_order_gradient_matches_jax_and_not_first_order():
    """Loss, logits and every gradient of one train step (second order
    through 5 inner steps) against ``jax.grad`` through the JAX package's
    scan; the first-order step (the inner gradients taken without a graph)
    misses the reference."""
    variables = jax_variables("MAML")
    ref, pb = step_reference("MAML", variables, seed=2)
    for dtype in (torch.float64, torch.float32):
        method = port_method("MAML", variables, dtype).train()
        loss, out = method.loss(pb, SETTING)
        loss.backward()
        named = dict(method.named_parameters())
        assert len(named) == 22
        _check_step(named, {}, loss, out, ref, STEP_TOLS)
    method = port_method("MAML", variables, torch.float64).train()
    first = method._run(pb, SETTING, method.train_iter, second_order=False)
    masked_cross_entropy(first, segment_targets(pb), pb.query_mask).backward()
    grads = ref[2]
    largest = max(np.abs(grads[k]).max() for k in named)
    missed = max(np.abs(p.grad.double().numpy() - grads[k].reshape(p.shape)).max()
                 / max(np.abs(grads[k]).max(), 0.1 * largest)
                 for k, p in method.named_parameters())
    assert missed > 10 * GRAD_TOL


def _episode(batch: EpisodeBatch, idx) -> EpisodeBatch:
    return EpisodeBatch(*(getattr(batch, f)[idx] for f in (
        "support", "query", "query_clip", "query_mask", "support_target", "query_target")))


@pytest.mark.parametrize("name", ["MAML", "BOIL:NIL"])
def test_episodes_keep_their_own_batch_statistics(name):
    """An episode's logits are the same alone and beside others, and do not
    move when another episode's segments change; one backbone batch over
    two episodes' queries would move them."""
    method = port_method(name, jax_variables(name)).eval()
    _, pb = batches(name, 3, pad=2, seed=7)
    other = pb.replace(support=pb.support.clone(), query=pb.query.clone())
    other.support[1:] *= 3.0
    other.query[1:] += 1.0
    with torch.no_grad():
        together = method(pb, SETTING)
        alone = method(_episode(pb, slice(0, 1)), SETTING)
        changed = method(other, SETTING)
        params = method._adapt(pb.support[0], pb.support_target[0].long(), 1)
        own = method._net(params, pb.query[0], pb.query_mask[0] > 0)[0]
        mask = torch.cat([pb.query_mask[0], pb.query_mask[1]]) > 0
        shared = method._net(params, torch.cat([pb.query[0], pb.query[1]]), mask)[0][:8]
    scale = together.abs().max().item()
    assert (together[0] - alone[0]).abs().max().item() <= ALONE_TOL * scale
    assert torch.equal(together[0], changed[0])
    assert not torch.allclose(together[1:], changed[1:])
    assert (shared - own).abs().max().item() > 1e-3 * own.abs().max().item()


def test_adaptable_set_excludes_the_logits_bn1d():
    """The inner loop steps every parameter but Conv64F's logits-head BN1d
    (``emb_func.logits.1``, the JAX package's ``logits_bn``), which keeps its
    own tensors."""
    variables = jax_variables("MAML")
    method = port_method("MAML", variables)
    adaptable = method._adaptable()
    frozen = {"emb_func.logits.1.weight", "emb_func.logits.1.bias"}
    assert set(adaptable) == set(dict(method.named_parameters())) - frozen
    jax_method = jax_build_method(meta_config("MAML"))
    jax_adaptable = jax_method._adaptable(variables["params"])
    assert set(variables["params"]["emb_func"]) - set(jax_adaptable["emb_func"]) == {"logits_bn"}
    assert len(jax.tree_util.tree_leaves(jax_adaptable)) == len(adaptable)
    _, pb = batches("MAML", 1)
    with torch.no_grad():
        adapted = method._adapt(pb.support[0], pb.support_target[0].long(), 2)
    own = dict(method.named_parameters())
    for key, val in adapted.items():
        assert (val is own[key]) == (key in frozen), key


@pytest.mark.parametrize("name", ["MAML", "ANIL", "BOIL:Once_update"])
def test_eval_under_no_grad_adapts_and_writes_no_grad(name):
    """As ``Test`` holds the method (eval mode, no parameter needing grad,
    ``no_grad``), the adapted logits differ from the unadapted ones, and no
    parameter gets a ``.grad``; so with grad mode on (a step called outside
    ``test_loop``); in training, ``loss`` leaves ``.grad`` to the caller's
    backward."""
    method = port_method(name, jax_variables(name)).eval().requires_grad_(False)
    _, pb = batches(name, 2, seed=3)
    with torch.no_grad():
        adapted = method(pb, SETTING)
        unadapted = method._run(pb, SETTING, 0)
    assert _rel(adapted.numpy(), unadapted.numpy()) > 1e-3
    assert torch.equal(method(pb, SETTING).detach(), adapted)
    assert all(p.grad is None for p in method.parameters())
    method.requires_grad_(True).train()
    loss, _ = method.loss(pb, SETTING)
    assert loss.requires_grad
    assert all(p.grad is None for p in method.parameters())


def test_maml_backbone_runs_without_dropout_in_train_mode():
    """MAML applies its backbone as the JAX package's ``train=False``: the
    same logits with the module in train and in eval mode (Conv64F's
    Dropout(0.3) off); ANIL's backbone runs in the module's own mode."""
    _, pb = batches("MAML", 1, seed=4)
    for name, same in (("MAML", True), ("ANIL", False)):
        method = port_method(name, jax_variables(name))
        with torch.no_grad():
            trained = method.train()._run(pb, SETTING, 2)
            evaluated = method.eval()._run(pb, SETTING, 2)
        assert torch.equal(trained, evaluated) == same, name

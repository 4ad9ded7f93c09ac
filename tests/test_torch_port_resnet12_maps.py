"""DSN, FRN and CAN of the PyTorch port against the JAX package on the CPU
(the helpers, geometry and tolerances of
``test_torch_port_resnet12_heads.py``, which holds the other three resnet12
heads; split so that no file pins an xdist worker for long): eval logits,
a train step against the JAX package's float64 step, DSN's 1-shot
fallback, and the head weights of FRN and CAN under the reference names."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from audio_fewshot_tpu_torch.models.heads.dsn import DSN  # noqa: E402
from audio_fewshot_tpu_torch.models.heads.proto_net import proto_logits  # noqa: E402

from test_torch_port_resnet12_heads import (  # noqa: E402
    _jax_variables, _port_method, check_eval_logits, check_head_weights, check_train_step)

MAP_TESTED = ["DSN", "FRN", "CAN"]


@pytest.mark.parametrize("name", MAP_TESTED)
def test_eval_logits_match_jax(name):
    check_eval_logits(name)


@pytest.mark.parametrize("name", MAP_TESTED)
def test_train_step_matches_jax_float64(name):
    check_train_step(name)


@pytest.mark.parametrize("name", ["FRN", "CAN"])
def test_head_weights_cross_under_the_reference_names(name):
    check_head_weights(name)


def test_dsn_falls_back_to_prototypes_at_one_shot():
    """A 0-dimensional subspace is degenerate: 1-shot DSN scores by
    nearest prototype in eval and trains without the discriminative term,
    as the JAX package's."""
    from audio_fewshot_tpu.models.base import EpisodeSetting
    from audio_fewshot_tpu.models.heads.dsn import DSN as JaxDSN
    from audio_fewshot_tpu.models.heads.proto_net import proto_logits as jax_proto_logits
    from audio_fewshot_tpu_torch.episode import make_dense_episode_batch

    setting = EpisodeSetting(way=3, shot=1, query=2)
    rng = np.random.default_rng(4)
    sup = rng.normal(size=(2, 3, 1, 96, 112)).astype(np.float32)
    qry = rng.normal(size=(2, 6, 1, 96, 112)).astype(np.float32)
    batch = make_dense_episode_batch(sup, qry, 3, 1, 2).to("cpu")
    method = _port_method("DSN", _jax_variables("DSN")).eval()
    assert isinstance(method, DSN) and method.discriminative
    with torch.no_grad():
        s, q = method.embed(batch)
        logits = method(batch, setting)
    np.testing.assert_array_equal(logits.numpy(), proto_logits(q, s, 3, 1).numpy())
    ref, subspace = JaxDSN(None)._logits(q.numpy(), s.numpy(), setting)
    assert subspace is None
    # −‖q − p‖² as 2qp − ‖q‖² − ‖p‖² in float32: the error scales with ‖q‖²
    atol = 1e-6 * float((q * q).sum(-1).max())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_proto_logits(q.numpy(), s.numpy(),
                                                                           3, 1)), atol=atol)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=atol)
    loss, _ = method.train().loss(batch, setting)
    assert torch.isfinite(loss)

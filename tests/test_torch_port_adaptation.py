"""The port's ``losses.label_smooth_ce`` and
``heads.finetuning.reference_matched_adaptation`` against the JAX
package's, on the same numpy draws.

- ``label_smooth_ce``: logits of 16 rows of 5 classes at smoothing 0, 0.1
  and 0.3, rtol 1e-6 (float32, one log-softmax and one sum a row);
- ``reference_matched_adaptation``: each head kind (``linear``,
  ``dist_linear``, ``neg_cosine``), with momentum and without, on a 5-way
  5-shot support set of 32 features and 10 queries, a schedule of 3
  permutations in minibatches of 4 (21 SGD steps), the query logits within
  1e-5 of their scale (float32: the two packages sum the gradients in
  other orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.models.heads.finetuning import (  # noqa: E402
    reference_matched_adaptation as jax_adaptation)
from audio_fewshot_tpu.models.losses import label_smooth_ce as jax_label_smooth_ce  # noqa: E402
from audio_fewshot_tpu_torch.models.heads.finetuning import (  # noqa: E402
    reference_matched_adaptation)
from audio_fewshot_tpu_torch.models.losses import label_smooth_ce  # noqa: E402

WAY, SHOT, QUERY, DIM = 5, 5, 10, 32


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_label_smooth_ce_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.normal(0.0, 3.0, size=(16, 5)).astype(np.float32)
    targets = rng.integers(0, 5, size=(16,))
    ours = label_smooth_ce(torch.from_numpy(logits), torch.from_numpy(targets), smoothing)
    ref = jax_label_smooth_ce(jnp.asarray(logits), jnp.asarray(targets), smoothing)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def _head(kind, rng):
    if kind == "linear":
        return {"weight": rng.normal(0.0, 0.1, size=(WAY, DIM)).astype(np.float32),
                "bias": np.zeros(WAY, np.float32)}
    if kind == "dist_linear":
        return {"weight_g": rng.uniform(0.5, 1.5, size=(WAY, 1)).astype(np.float32),
                "weight_v": rng.normal(0.0, 0.1, size=(WAY, DIM)).astype(np.float32)}
    return {"weight": rng.normal(0.0, 0.1, size=(WAY, DIM)).astype(np.float32)}


@pytest.mark.parametrize("momentum", [0.9, 0.0])
@pytest.mark.parametrize("kind,margin,scale", [("linear", 0.0, 1.0), ("dist_linear", 0.0, 2.0),
                                              ("neg_cosine", 0.3, 10.0)])
def test_reference_matched_adaptation_matches_jax(kind, margin, scale, momentum):
    rng = np.random.default_rng(1)
    sup = rng.normal(size=(WAY * SHOT, DIM)).astype(np.float32)
    sup_y = np.repeat(np.arange(WAY), SHOT)
    qry = rng.normal(size=(QUERY, DIM)).astype(np.float32)
    params = _head(kind, rng)
    perms = [rng.permutation(WAY * SHOT) for _ in range(3)]
    kwargs = dict(batch_size=4, lr=0.05, momentum=momentum, weight_decay=1e-3, way=WAY,
                  margin=margin, scale=scale)
    ours = reference_matched_adaptation(kind, {k: torch.from_numpy(v) for k, v in params.items()},
                                        torch.from_numpy(sup), torch.from_numpy(sup_y),
                                        torch.from_numpy(qry), perms, **kwargs).numpy()
    ref = np.asarray(jax_adaptation(kind, params, jnp.asarray(sup), jnp.asarray(sup_y),
                                    jnp.asarray(qry), perms, **kwargs))
    start = reference_matched_adaptation(kind, {k: torch.from_numpy(v) for k, v in params.items()},
                                         torch.from_numpy(sup), torch.from_numpy(sup_y),
                                         torch.from_numpy(qry), [], **kwargs).numpy()
    assert ours.shape == ref.shape == (QUERY, WAY)
    assert np.abs(ours - start).max() > 1e-2 * np.abs(ref).max()  # the steps moved the head
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_reference_matched_adaptation_refuses_an_unknown_head():
    x = torch.zeros(2, DIM)
    with pytest.raises(ValueError, match="cosine"):
        reference_matched_adaptation("cosine", {}, x, torch.zeros(2), x, [], 1, 0.1, 0.0, 0.0,
                                     WAY)

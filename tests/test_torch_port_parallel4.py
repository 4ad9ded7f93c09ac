"""The heads with a BatchNorm of their own over the episode axis (ADM,
ADM_KL, ATLNet, CAN, RelationNet, VERSA) over 2 gloo ranks on the CPU,
against the port's 1-rank run and,
for ADM, RelationNet and VERSA, the JAX package's ``get_mesh(2)`` /
``get_mesh(1)``; RelationNet's and VERSA's eval on ragged episodes.

The ranks, the cells and the tolerances are ``test_torch_port_parallel3.
py``'s (ADM_KL's first loss at 1e-5, for the reason given there; ADM_KL at
SGD ``dryrun_multigpu.ADM_KL_LR`` and RelationNet at ``RELATION_LR``, where
a step is well conditioned on one rank and in the JAX package's float32
meshes); RelationNet on ``[1, 72, 72]`` segments (its relation layer needs
an 8 x 8 map).  VERSA's draws are the JAX package's from its step key for
the mesh comparison.
The ragged eval: 8 episodes of query clips of 1-2 segments in a bucket of
16 rows (34 real rows on one rank, 36 on the other), eval logits against
one rank's at rtol 1e-3 / atol 1e-2.  The controls undo a repair and must
fail the limits: the head's BatchNorm moments per rank (ADM in training,
RelationNet and VERSA in the ragged eval) and VERSA's noise drawn at one
rank's shape.
"""

import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

from audio_fewshot_tpu_torch import dryrun_multigpu as dry  # noqa: E402
from audio_fewshot_tpu_torch.parallel import World  # noqa: E402

from test_torch_port_parallel3 import (check_control, check_jax_mesh, check_one_rank,  # noqa: E402
                                       close, plans)

TIMEOUT_S = 240
RANKS = 2
HEADS = ("ADM", "ADM_KL", "ATLNet", "CAN", "RelationNet", "VERSA")
JAX_HEADS = {"ADM": None, "RelationNet": None, "VERSA": None}
CONTROLS = (("ADM", "head_bn"), ("VERSA", "draws"))
RAGGED_CONTROLS = tuple((h, "head_bn") for h in dry.RAGGED_HEADS)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel4")
    many, single, jax_runs = plans(root, HEADS, JAX_HEADS, CONTROLS)
    ragged = {f"head_ragged_eval:{h}": {"head": h} for h in dry.RAGGED_HEADS}
    many.update(ragged)
    many.update({f"head_ragged_eval:{h}:{f}": {"head": h, "fault": f}
                 for h, f in RAGGED_CONTROLS})
    return {"root": root, "many": many, "single": {**single, **ragged}, "jax": jax_runs}


@pytest.fixture(scope="module")
def ranks(cells):
    return dry.run_ranks(RANKS, cells["many"], "cpu", init_method=f"file://{cells['root']}/rdzv",
                         timeout=TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def one_rank(cells):
    return dry.run_scenarios(World(), cells["single"])


@pytest.mark.parametrize("head", HEADS)
def test_head_matches_one_rank(ranks, one_rank, head):
    """Two SGD steps of 8 episodes (4 a rank): the losses, every parameter
    and statistic after each step (the head's BatchNorm moments over both
    ranks' rows) and the eval logits of 8 episodes."""
    check_one_rank(ranks, one_rank, head)


@pytest.mark.parametrize("n_devices", [2, 1])
@pytest.mark.parametrize("head", sorted(JAX_HEADS))
def test_head_matches_the_jax_mesh(ranks, cells, head, n_devices):
    """ADM, RelationNet and VERSA (the JAX draws) from the JAX package's
    weights: the losses and every parameter against its
    ``get_mesh(n_devices)``, whose global ``jit`` takes every BatchNorm's
    moments over the whole batch."""
    check_jax_mesh(ranks, cells, head, n_devices)


@pytest.mark.parametrize("head", dry.RAGGED_HEADS)
def test_ragged_eval_matches_one_rank(ranks, one_rank, head):
    """RelationNet's and VERSA's eval-mode BatchNorms take the batch
    statistics of the real query rows, which differ between the ranks: the
    logits of 8 ragged episodes over 2 ranks are one rank's."""
    key = f"head_ragged_eval:{head}"
    single = one_rank[key]
    real = single["real_rows"]
    assert real[:4].sum() != real[4:].sum()
    for rank in ranks:
        assert torch.equal(rank[key]["real_rows"], real)
        close(rank[key]["logits"], single["logits"], 1e-3, 1e-2)


@pytest.mark.parametrize("head,fault", CONTROLS)
def test_a_repair_undone_fails_the_limits(ranks, one_rank, head, fault):
    """ADM's head BatchNorm moments per rank and VERSA's noise drawn at one
    rank's shape each miss one rank's run."""
    check_control(ranks, one_rank, head, fault)


@pytest.mark.parametrize("head", dry.RAGGED_HEADS)
def test_per_rank_moments_miss_the_ragged_eval(ranks, one_rank, head):
    """The ragged eval with the head's BatchNorm moments per rank misses one
    rank's logits: the limits see it."""
    ours = ranks[0][f"head_ragged_eval:{head}:head_bn"]
    with pytest.raises(AssertionError):
        close(ours["logits"], one_rank[f"head_ragged_eval:{head}"]["logits"], 1e-3, 1e-2)

"""The episodic heads whose losses reduce over the episode axis (DSN, FRN,
LEO, MTL, MetaBaselineKendall, DN4, ConvMNet, MCL, R2D2MCL) and
DMatchingNet's running statistics over 2 gloo ranks on the CPU, against
the port's 1-rank run and, for DSN and LEO, the
JAX package's ``get_mesh(2)`` / ``get_mesh(1)``; ``Test`` at a step the
world does not divide; every registered method admitted over ranks.

As ``test_torch_port_parallel2.py``: the two ranks are started once for the
module (``torch.multiprocessing`` into ``audio_fewshot_tpu_torch.
dryrun_multigpu``'s rank function, so they import neither JAX nor
tensorboard; a ``file://`` rendezvous under the test's temporary directory,
one thread each, a time limit on the rendezvous, the collectives and the
join) and run every scenario; the 1-rank runs take place in this process.

The cells (``dryrun_multigpu.HEAD_CELLS``): two SGD steps of 8 episodes (4 a
rank) of the mesh tests' 3-way 2-shot 2-query on ``[1, 24, 30]`` segments,
each head on Conv64F's [64, 2, 3] map or, for DSN, FRN, MetaBaselineKendall
and MTL, on the narrow resnet12 (planes 8/12/16/20), DMatchingNet on
Conv64F's flat logits head (its BatchNorm1d keeps running statistics), inner
loops of 2 steps;
against the JAX mesh DSN on the mesh tests' Conv64F cell and LEO on the
cell's 384 flat features, from the JAX package's initial weights and, for
LEO, with the draws of its step key (``PRNGKey(7)``) handed to both
packages.  Four controls undo a repair and must fail the limits: DSN's
orthogonality sum per rank, LEO's inner loss a mean over one rank's support
rows, LEO's noise drawn at one rank's shape, DMatchingNet's running
statistics the mean of one rank's episodes (``HEAD_FAULTS``).

Tolerances (float32), ``test_torch_port_parallel2.py``'s: against one rank
the first loss rtol 1e-6, the later 2e-5, parameters and statistics rtol
1e-3 / atol 5e-4, eval logits rtol 1e-3 / atol 1e-2; against the JAX mesh
the first loss rtol 2e-5 and the later 1e-4, parameters rtol 1e-3 / atol
5e-4.  FRN's and MetaBaselineKendall's first loss (and ADM_KL's, in
``test_torch_port_parallel4.py``) at the JAX mesh tests' own 1e-5
(``FIRST_LOSS_RTOLS``): 2 ranks' BatchNorm moments, summed in another order,
move it by 1.2e-6 and 1.5e-6 (ADM_KL 1.9e-6); on one rank, support rows
moved by 1e-7 of themselves move it by 4e-7.
"""

import contextlib
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu_torch import dryrun_multigpu as dry  # noqa: E402
from audio_fewshot_tpu_torch import eval as port_eval  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.parallel import World  # noqa: E402
from audio_fewshot_tpu_torch.registry import CLASSIFIERS  # noqa: E402
from audio_fewshot_tpu_torch.utils.seed import init_seed  # noqa: E402

import test_shard_equivalence as mesh_tests  # noqa: E402
from test_torch_port_parallel2 import jax_cell, jax_init, port_state  # noqa: E402

TIMEOUT_S = 240
RANKS = 2
HEADS = ("DSN", "FRN", "LEO", "MTL", "MetaBaselineKendall", "DN4", "ConvMNet", "MCL",
         "R2D2MCL", "DMatchingNet")
FIRST_LOSS_RTOLS = {"FRN": 1e-5, "MetaBaselineKendall": 1e-5, "ADM_KL": 1e-5}
#: the heads held against the JAX mesh here, with the backbone of their
#: cell there (DSN on the mesh tests' Conv64F map)
JAX_HEADS = {"DSN": dry.proto_config()["backbone"], "LEO": None}
CONTROLS = (("DSN", "disc_sum"), ("LEO", "local_mean"), ("LEO", "draws"),
            ("DMatchingNet", "running_stats"))


@contextlib.contextmanager
def fed_normal(draws):
    """``jax.random.normal`` returns the given array of the shape asked (the
    JAX heads draw their noise through it), and draws as before for any
    other shape (the initialisers)."""
    by_shape = {tuple(a.shape): a for a in draws}
    normal = jax.random.normal

    def fed(key, shape=(), dtype=jnp.float32):
        given = by_shape.get(tuple(shape))
        return normal(key, shape, dtype) if given is None else jnp.asarray(given, dtype)

    jax.random.normal = fed
    try:
        yield
    finally:
        jax.random.normal = normal


def step_draws(head, episodes=8, queries=6):
    """The Gaussian draws the JAX head takes from the mesh tests' step key
    ``PRNGKey(7)`` for a step of ``episodes`` (its whole batch): LEO's
    latent and decoder noise (the key split), VERSA's samples (the key's
    second half)."""
    kwargs = dry.HEAD_CELLS[head]["classifier"]["kwargs"]
    if head == "LEO":
        r_enc, r_dec = jax.random.split(jax.random.PRNGKey(7))
        return [np.asarray(jax.random.normal(r_enc, (episodes, 3, kwargs["hid_dim"]))),
                np.asarray(jax.random.normal(r_dec, (episodes, 3, 384)))]
    if head == "VERSA":
        key = jax.random.split(jax.random.PRNGKey(7))[1]
        return [np.asarray(jax.random.normal(key, (kwargs["sample_num"], episodes, queries,
                                                   3)))]
    return []


def jax_mesh(head, n_devices, batches, backbone=None):
    """The JAX package's ``head`` trained on ``batches`` over
    ``get_mesh(n_devices)`` (``test_shard_equivalence._run``, at the cell's
    learning rate, flax's Dropout the identity, the step key's draws):
    (losses, logits, params)."""
    cell = dry.HEAD_CELLS[head]
    lr = cell.get("optimizer", {}).get("kwargs", {}).get("lr")
    with jax_cell(lr), fed_normal(step_draws(head)):
        return mesh_tests._run(n_devices, batches, classifier=copy.deepcopy(cell["classifier"]),
                               backbone=copy.deepcopy(backbone))


def jax_inputs(root, head, backbone=None):
    """A ``head_train`` plan entry from the JAX package's initial weights
    (saved under ``root``) on the mesh tests' batches, with the step key's
    draws; and (variables, port config) for reading the JAX parameters."""
    over = {} if backbone is None else {"backbone": copy.deepcopy(backbone)}
    port_cfg = dry.head_config(head, **over)
    # the JAX package's own batches of the port's (both from seed 0)
    batches = mesh_tests._batches(2, spec=tuple(port_cfg["spec_shape"]))
    classifier = copy.deepcopy(dry.HEAD_CELLS[head]["classifier"])
    with jax_cell():
        cfg = mesh_tests._config()
        if backbone is not None:
            cfg["backbone"] = copy.deepcopy(backbone)
        mesh_tests._config = lambda: copy.deepcopy(cfg)
        variables = jax_init(classifier, batches[0])
    path = str(root / f"{head}_jax.pt")
    torch.save(port_state(variables, port_cfg), path)
    entry = {"head": head, "state": path, "seed": 0, "draws": step_draws(head), **over}
    return entry, (variables, port_cfg), batches


def close(ours, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


def held_as_one_rank(ours, single, first_rtol=1e-6):
    """The losses, both states and the eval logits of a run over ranks
    against one rank's, at the stated limits."""
    close(ours["losses"][:1], single["losses"][:1], first_rtol)
    close(ours["losses"], single["losses"], 2e-5)
    for state in ("first_state", "state"):
        for key in single[state]:
            close(ours[state][key], single[state][key], 1e-3, 5e-4)
    close(ours["logits"], single["logits"], 1e-3, 1e-2)


def check_one_rank(ranks, one_rank, head):
    key = f"head_train:{head}"
    ours = ranks[0][key]
    assert ranks[1][key]["losses"] == ours["losses"]  # one reduced gradient
    held_as_one_rank(ours, one_rank[key], FIRST_LOSS_RTOLS.get(head, 1e-6))
    init_seed(0)
    assert build_method(dry.head_config(head)).shardable


def check_jax_mesh(ranks, cells, head, n_devices):
    """The port's 2 ranks from the JAX package's weights against its
    ``get_mesh(n_devices)``: the losses and every parameter."""
    ours = ranks[0][f"head_train:{head}:jax"]
    backbone, batches = cells["jax"][head]["backbone"], cells["jax"][head]["batches"]
    losses, _, params = jax_mesh(head, n_devices, batches, backbone)
    close(ours["losses"][:1], losses[:1], 2e-5)
    close(ours["losses"], losses, 1e-4)
    variables, port_cfg = cells["jax"][head]["inits"]
    ref = port_state(variables, port_cfg, params=params)
    weights = [k for k in ref if not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked"))]
    assert len(weights) >= 8
    for key in weights:
        close(ours["state"][key], ref[key], 1e-3, 5e-4)


def check_control(ranks, one_rank, head, fault):
    """A repair undone (``fault``): the run over ranks misses one rank's at
    the limits."""
    ours, single = ranks[0][f"head_train:{head}:{fault}"], one_rank[f"head_train:{head}"]
    with pytest.raises(AssertionError):
        held_as_one_rank(ours, single, FIRST_LOSS_RTOLS.get(head, 1e-6))


def jax_cells(root, heads):
    """Each of ``heads``' JAX-weight plan entry, inits, backbone and
    batches."""
    out = {}
    for head, backbone in heads.items():
        entry, inits, batches = jax_inputs(root, head, backbone)
        out[head] = {"entry": entry, "inits": inits, "backbone": backbone, "batches": batches}
    return out


def plans(root, heads, jax_heads, controls):
    """(the plan over ranks, the 1-rank plan): each head's two steps, its
    JAX-weight run (over ranks only) and the controls (over ranks only)."""
    single = {f"head_train:{h}": {"head": h} for h in heads}
    jax_runs = jax_cells(root, jax_heads)
    many = {**single,
            **{f"head_train:{h}:jax": c["entry"] for h, c in jax_runs.items()},
            **{f"head_train:{h}:{f}": {"head": h, "fault": f} for h, f in controls}}
    return many, single, jax_runs


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel3")
    many, single, jax_runs = plans(root, HEADS, JAX_HEADS, CONTROLS)
    test_root = {"replicated_test": {"root": str(root / "test")}}
    return {"root": root, "many": {**many, **test_root}, "single": {**single, **test_root},
            "jax": jax_runs}


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
    and statistic after each step (DMatchingNet's running statistics the
    mean of every rank's episodes) and the eval logits of 8 episodes."""
    check_one_rank(ranks, one_rank, head)


@pytest.mark.parametrize("n_devices", [2, 1])
@pytest.mark.parametrize("head", sorted(JAX_HEADS))
def test_head_matches_the_jax_mesh(ranks, cells, head, n_devices):
    """DSN (its orthogonality sum over every rank's episodes) and LEO (its
    inner loss the mean over every rank's support rows, the whole step's
    draws) from the JAX package's weights: the losses and every parameter
    against its ``get_mesh(n_devices)``."""
    check_jax_mesh(ranks, cells, head, n_devices)


@pytest.mark.parametrize("head,fault", CONTROLS)
def test_a_repair_undone_fails_the_limits(ranks, one_rank, head, fault):
    """DSN's orthogonality sum per rank, LEO's inner mean over one rank's
    rows, LEO's noise drawn at one rank's shape and DMatchingNet's running
    statistics the mean of one rank's episodes each miss one rank's run:
    the limits see each fault."""
    check_control(ranks, one_rank, head, fault)


def test_test_runs_a_step_that_does_not_split_replicated(ranks, one_rank):
    """``Test`` over 2 ranks at 3 episodes a step (2 steps) runs each step
    replicated, without raising: every rank's per-episode accuracies, mean
    and CI are one rank's."""
    single = one_rank["replicated_test"]
    assert not single["replicated"] and [len(a) for a in single["episode_accs"]] == [6]
    for rank in ranks:
        ours = rank["replicated_test"]
        assert ours["replicated"]
        close(ours["episode_accs"], single["episode_accs"], 1e-6)
        close([ours["mean"], ours["ci"]], [single["mean"], single["ci"]], 1e-6)


def test_every_registered_method_runs_over_ranks(monkeypatch):
    """All 42 registered names are audited for ranks (``shardable``), and
    ``world_for`` still refuses a method that is not."""
    names = CLASSIFIERS.names()
    assert len(names) == 42
    assert [n for n in names if not CLASSIFIERS.get(n).shardable] == []
    monkeypatch.setattr(port_eval.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_eval.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(port_eval.dist, "get_rank", lambda: 0)
    init_seed(0)
    method = build_method(dry.head_config("DN4"))
    cfg = {"classifier": {"name": "DN4"}}
    assert port_eval.world_for(cfg, method, torch.device("cpu"), {}).size == 2
    monkeypatch.setattr(type(method), "shardable", False)
    with pytest.raises(ValueError, match="DN4 does not run over 2 ranks"):
        port_eval.world_for(cfg, method, torch.device("cpu"), {})

"""The flat (FINETUNING) family, FEAT and MeTAL over 2 gloo ranks on the
CPU, against the port's 1-rank run and the JAX package's ``get_mesh(2)`` /
``get_mesh(1)``, with the ``Trainer``'s replicated eval and its
``log_paramerter`` histograms.

A file of its own: ``test_torch_port_parallel.py`` already takes ≈ 70 s in
one process, and ``--dist loadfile`` wants each file under ~90 s.  As
there, the two ranks are started once for the module
(``torch.multiprocessing`` into ``audio_fewshot_tpu_torch.dryrun_multigpu``'s
rank function, so they import neither JAX nor tensorboard; a ``file://``
rendezvous under the test's temporary directory, one thread each, a time
limit on the rendezvous, the collectives and the join) and run every
scenario; the 1-rank runs take place in this process.

The cells (``dryrun_multigpu``): the 13 flat heads on the mesh tests'
Conv64F map (``[1, 24, 30]`` segments, 384 features; DeepBDC_Pretrain on
resnet12Bdc at ``reduce_dim`` 8), two SGD steps of flat batches of 8 rows (4
a rank); FEAT (its attention 384 wide, Dropout the identity, SGD at lr
5e-4: ``dryrun_multigpu.FEAT_LR``) and MeTAL on both loss-net paths on
the mesh tests' episodes; S2M2's mixed rows; IfslPretrain's featuring sums;
Baseline's ``Trainer`` eval at 3 episodes a step, which does not split over
2 ranks and runs replicated; Baseline's ``Trainer`` over 2 ranks against
the JAX ``Trainer`` at ``n_devices: 2`` (``test_torch_port_flat``'s cell).

Tolerances (float32), ``test_torch_port_parallel.py``'s: against one rank
the first loss rtol 1e-6, the later 2e-5, parameters and statistics rtol
1e-3 / atol 5e-4, eval logits rtol 1e-3 / atol 1e-2; against the JAX
package's mesh the first loss rtol 2e-5 and the later 1e-4 (flax's one-pass
float32 BN variance), parameters rtol 1e-3 / atol 5e-4; against the JAX
``Trainer`` ``test_torch_port_flat``'s step rtol 1e-4 and accuracies rtol
1e-5.  S2M2's mixed rows, the featuring sums and the replicated eval's
accuracies: rtol 1e-6 (the same arithmetic on the same rows; the sums
added in another order).
"""

import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

import audio_fewshot_tpu_torch.train as port_train  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models import train_setting as jax_train_setting  # noqa: E402
from audio_fewshot_tpu.train import Trainer as JaxTrainer  # noqa: E402
from audio_fewshot_tpu_torch import dryrun_multigpu as dry  # noqa: E402
from audio_fewshot_tpu_torch import eval as port_eval  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.layers import Dropout  # noqa: E402
from audio_fewshot_tpu_torch.parallel import World  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402
from audio_fewshot_tpu_torch.utils.seed import init_seed  # noqa: E402

import test_shard_equivalence as mesh_tests  # noqa: E402
from test_torch_port_flat import no_tensorboard_writers, trainer_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
RANKS = 2
METAL_PER_STEP = dry.metal_head(True)
#: the flat heads held step by step; S2M2 through ``s2m2_train``, which
#: also records its mixed rows
FLAT_KEYS = {h: ("s2m2_train" if h == "S2M2" else f"flat_train:{h}") for h in dry.FLAT_HEADS}
#: the flat heads whose eval logits are held too
EVALUATED = ("Baseline", "MetabaselinePretrain")


@contextlib.contextmanager
def jax_cell(lr=None):
    """``test_shard_equivalence._config()``'s cell at SGD ``lr`` (its own
    0.05 when None), and flax's Dropout the identity (the port's draws are
    its own)."""
    config, call = mesh_tests._config, flax_nn.Dropout.__call__

    def cell():
        cfg = config()
        if lr is not None:
            cfg["optimizer"] = {"name": "SGD", "kwargs": {"lr": lr}}
        return cfg

    mesh_tests._config, flax_nn.Dropout.__call__ = cell, lambda self, x, *a, **k: x
    try:
        yield
    finally:
        mesh_tests._config, flax_nn.Dropout.__call__ = config, call


def jax_init(classifier, batch):
    """The JAX package's initial variables of the cell with ``classifier``,
    as ``test_shard_equivalence._run`` draws them."""
    cfg = mesh_tests._config()
    cfg["classifier"] = classifier
    method = jax_build_method(cfg)
    setting = jax_train_setting(cfg)
    variables = jax.jit(lambda k, b: method.init_variables(k, b, setting))(
        jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(np.asarray, variables)


def port_state(variables, port_cfg, params=None):
    """The port's state dict of a JAX variable tree (``params`` in place of
    its own), the keys the port's method of ``port_cfg`` holds."""
    tree = {"params": variables["params"] if params is None else params,
            "batch_stats": variables.get("batch_stats", {})}
    state = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), "Conv64F",
                                prefix="emb_func.", classifier=port_cfg["classifier"]["name"])
    init_seed(0)
    keys = build_method(port_cfg).state_dict().keys()
    return {k: v for k, v in state.items() if k in keys}


def jax_trainer_config(root, **over):
    """``test_torch_port_flat``'s Baseline cell (Conv64F with ``is_flatten``
    on ``[1, 81, 90]``, 2 flat steps of 60, SGD at lr 5e-5) with val and
    test at 3 episodes a step: over 2 ranks or devices they run
    replicated.  ``episode_size`` 2: both packages' configs check it against
    ``n_devices``, whatever the method (a FINETUNING run reads none)."""
    return trainer_config(root, test_episode=3, test_episode_size=3, episode_size=2, **over)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The plan every rank runs, with the JAX package's initial weights in
    files, and the JAX runs each check reads."""
    root = tmp_path_factory.mktemp("parallel2")
    batches = mesh_tests._batches(2)  # the dry run's episode_batches(2)
    with jax_cell():
        inits = {"feat": (jax_init(dry.FEAT, batches[0]), dry.feat_config()),
                 "metal": (jax_init(METAL_PER_STEP, batches[0]),
                           dry.proto_config(classifier=METAL_PER_STEP))}
    paths = {}
    for key, (variables, port_cfg) in inits.items():
        paths[key] = str(root / f"{key}.pt")
        torch.save(port_state(variables, port_cfg), paths[key])
    # Baseline's Trainer: the JAX Trainer's initial weights for the port's
    mp = pytest.MonkeyPatch()
    no_tensorboard_writers(mp)
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        ref = JaxTrainer(0, jax_trainer_config(root / "jax", n_devices=2))
        assert ref.n_devices == 2
        losses, accs = [], []
        step, validate = ref._jit_train_step, ref._validate

        def recording_step(*args, **kwargs):
            out = step(*args, **kwargs)
            losses.append(float(out[2]["loss"]))
            return out

        def recording_validate(*args, **kwargs):
            out = validate(*args, **kwargs)
            accs.append(out[0])
            return out

        ref._jit_train_step, ref._validate = recording_step, recording_validate
        init = jax.tree_util.tree_map(np.asarray, ref.variables)
        ref.train_loop()
    finally:
        mp.undo()
    paths["baseline"] = str(root / "baseline.pt")
    torch.save(state_dict_from_jax(init, "Conv64F", prefix="emb_func.", classifier="Baseline"),
               paths["baseline"])
    plan = {
        **{key: {"head": h, "evaluate": h in EVALUATED} for h, key in FLAT_KEYS.items()
           if key.startswith("flat_train")},
        "s2m2_train": {},
        "feat_train": {"state": paths["feat"]},
        "metal_train": {},
        "metal_train:per_step": {"per_step": True, "state": paths["metal"]},
        **dry.flat_root_plan(str(root)),
    }
    trainer = {"trainer_train": {"cfg": jax_trainer_config(root / "port", n_devices=2),
                                 "state": paths["baseline"]}}
    return {"root": root, "plan": plan, "trainer": trainer, "inits": inits,
            "batches": batches,
            "jax_trainer": {"losses": losses, "accs": accs}}


@pytest.fixture(scope="module")
def ranks(cells):
    """Each rank's results of the plan (and Baseline's ``Trainer`` cell) over
    2 gloo ranks."""
    rdzv = cells["root"] / "rdzv"
    return dry.run_ranks(RANKS, {**cells["plan"], **cells["trainer"]}, "cpu",
                         init_method=f"file://{rdzv}", timeout=TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def one_rank(cells):
    return dry.run_scenarios(World(), cells["plan"])


def _close(ours, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


def _state_close(ours, ref, keys, rtol=1e-3, atol=5e-4):
    for key in keys:
        _close(ours[key], ref[key], rtol, atol)


def _held_as_one_rank(ranks, one_rank, key):
    """Both ranks' losses equal; the losses, both states and any eval
    logits against one rank's."""
    ours, single = ranks[0][key], one_rank[key]
    assert ranks[1][key]["losses"] == ours["losses"]  # one reduced gradient
    _close(ours["losses"][:1], single["losses"][:1], 1e-6)
    _close(ours["losses"], single["losses"], 2e-5)
    _state_close(ours["first_state"], single["first_state"], single["first_state"])
    _state_close(ours["state"], single["state"], single["state"])
    if "logits" in single:
        _close(ours["logits"], single["logits"], 1e-3, 1e-2)
    return ours


def _weights(state):
    return [k for k in state if not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked"))]


# -- the flat family ----------------------------------------------------------------------------

@pytest.mark.parametrize("head", dry.FLAT_HEADS)
def test_flat_head_matches_one_rank(ranks, one_rank, head):
    """Two flat SGD steps of 8 rows (4 a rank): the losses, every parameter
    and statistic after each step (the backbone's BatchNorm moments over
    both ranks' rows, SKDModel's flips too) and, for Baseline and
    MetabaselinePretrain, the eval logits of 8 episodes."""
    key = FLAT_KEYS[head]
    ours = _held_as_one_rank(ranks, one_rank, key)
    assert ("logits" in ours) == (head in EVALUATED)
    init_seed(0)
    assert build_method(dry.flat_config(head)).shardable


def test_s2m2_mixes_the_one_rank_rows(ranks, one_rank):
    """Each step's mixed rows and partner targets, gathered over the 2 ranks
    in rank order, are the 1-rank run's: one λ and one permutation of the
    whole flat batch, the partners taken from every rank's rows."""
    single = one_rank["s2m2_train"]["mixed"]
    assert len(single) == 2 and single[0].shape[0] == 8
    for rank in ranks:
        for ours, ref in zip(rank["s2m2_train"]["mixed"], single, strict=True):
            _close(ours, ref, 1e-6)


def test_featuring_sums_match_one_rank(ranks, one_rank):
    """IfslPretrain's featuring pass: the per-class sums and counts of the
    epoch's flat features (each rank's shard, added over the ranks) and
    the means rank 0 saved are the 1-rank run's."""
    single = one_rank["ifsl_featuring"]
    assert single["steps"] == 2 and float(single["counts"].sum()) == 16
    for rank in ranks:
        ours = rank["ifsl_featuring"]
        assert ours["steps"] == 2
        assert torch.equal(ours["counts"], single["counts"])
        _close(ours["sums"], single["sums"], 1e-6, 1e-6)
        _close(ours["means"], single["means"], 1e-6, 1e-6)


# -- the Trainer over ranks -----------------------------------------------------------------------

def test_replicated_eval_gives_one_rank_accuracies(ranks, one_rank):
    """A val and a test pass of one step of 3 episodes over 2 ranks (3 does
    not split over 2): every rank computes every episode, and the
    per-episode accuracies, means and CIs are one rank's."""
    single = one_rank["replicated_eval"]
    assert [len(a) for a in single["episode_accs"]] == [3, 3]
    for rank in ranks:
        ours = rank["replicated_eval"]
        _close(ours["episode_accs"], single["episode_accs"], 1e-6)
        _close(ours["passes"], single["passes"], 1e-6)


def test_baseline_trainer_matches_the_jax_trainer_on_two_devices(ranks, cells):
    """Baseline's ``Trainer`` over 2 gloo ranks (2 flat steps of 60, 30 a
    rank; val and test at 3 episodes a step, replicated) against the JAX
    ``Trainer`` at ``n_devices: 2`` on the host's devices, from the same
    weights: the step losses and the val / test accuracies."""
    ref = cells["jax_trainer"]
    for rank in ranks:
        record = rank["trainer_train"]["history"][0]
        assert len(record["train_losses"]) == len(ref["losses"]) == 2
        _close(record["train_losses"], ref["losses"], 1e-4)
        _close([record["val_acc"], record["test_acc"]], ref["accs"], 1e-5)


@pytest.mark.parametrize("name,divides,raises", [
    ("deepbdc_pretrain/deepbdc_pretrain_5shot_iid_seed0.yaml", {"batch_size": 128}, None),
    ("deepbdc/deepbdc_5shot_iid_seed0.yaml", {"episode_size": 1}, "episode_size (1)"),
    ("deepbdc_pretrain/deepbdc_pretrain_5shot_iid_seed0.yaml", {"batch_size": 127},
     "batch_size (127)")])
def test_the_training_divisor_of_a_shipped_config(monkeypatch, name, divides, raises):
    """The world size must divide the training batch's axis: a FINETUNING
    method's ``batch_size`` alone (the shipped DeepBDC_Pretrain config, at
    ``episode_size: 1``, builds its world over 2 ranks), an episodic
    method's ``episode_size`` (the shipped DeepBDC config does not); a
    flat batch that does not split still raises, naming its knob."""
    cfg = Config(os.path.join(REPO, "config", name)).get_config_dict()
    cfg.update(divides)
    cfg["backbone"]["kwargs"]["reduce_dim"] = 8  # the divisors read no width
    init_seed(0)
    method = build_method(cfg)
    divisors = port_train.train_divisors(cfg, method)
    assert set(divisors) == set(divides)
    monkeypatch.setattr(port_eval.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_eval.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(port_eval.dist, "get_rank", lambda: 1)
    if raises is None:
        assert port_eval.world_for(cfg, method, torch.device("cpu"), divisors).size == 2
    else:
        with pytest.raises(ValueError, match=raises.replace("(", r"\(").replace(")", r"\)")):
            port_eval.world_for(cfg, method, torch.device("cpu"), divisors)


def test_log_paramerter_writes_histograms_on_rank_0(tmp_path, monkeypatch):
    """``log_paramerter: true``: every ``log_interval`` step (here each of
    the 2) a histogram of each parameter, tagged with its name's dots as
    slashes, float32, but for the BatchNorm modules' parameters (Conv64F's
    ``layer{i}.1``); the JAX ``Trainer``'s ``_log_param_histograms``."""
    written = []

    class Writer(port_train.TensorboardWriter):
        def __init__(self, log_dir, enabled=True):
            self.step, self._writer, self.enabled = 0, None, enabled

        def add_histogram(self, tag, values, step=None):
            assert self.enabled
            written.append((tag, values))

    monkeypatch.setattr(port_train, "TensorboardWriter", Writer)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)
    trainer = port_train.Trainer(0, dry.trainer_config(str(tmp_path), log_paramerter=True),
                                 device="cpu")
    trainer.train_loop()
    params = dict(trainer.method.named_parameters())
    bn = {n for n in params if n.startswith("emb_func.layer") and n.split(".")[2] == "1"}
    assert len(bn) == 8
    expected = {n.replace(".", "/") for n in params if n not in bn}
    assert "emb_func/layer1/0/weight" in expected and "classifier/weight" in expected
    tags = [tag for tag, _ in written]
    assert set(tags) == expected and len(tags) == 2 * len(expected)
    for tag, values in written:
        assert isinstance(values, np.ndarray) and values.dtype == np.float32
        assert values.shape == tuple(params[tag.replace("/", ".")].shape)
    written.clear()
    trainer = port_train.Trainer(0, dry.trainer_config(str(tmp_path / "off")), device="cpu")
    trainer.train_loop()
    assert not written


# -- FEAT and MeTAL ------------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [2, 1])
def test_feat_matches_one_rank_and_the_jax_mesh(ranks, one_rank, cells, n_devices):
    """FEAT on the cell's map (the attention's Dropout the identity in both
    packages, SGD at ``FEAT_LR``): two steps' losses and state against one
    rank, the eval logits, and the losses and parameters against the JAX
    package's FEAT over ``get_mesh(n_devices)``."""
    ours = _held_as_one_rank(ranks, one_rank, "feat_train")
    with jax_cell(lr=dry.FEAT_LR):
        losses, _, params = mesh_tests._run(n_devices, cells["batches"], classifier=dry.FEAT)
    _close(ours["losses"][:1], losses[:1], 2e-5)
    _close(ours["losses"], losses, 1e-4)
    variables, port_cfg = cells["inits"]["feat"]
    ref = port_state(variables, port_cfg, params=params)
    weights = _weights(ref)
    assert len(weights) > 8 and "slf_attn.w_qs.weight" in weights
    _state_close(ours["state"], ref, weights)


def test_metal_default_path_matches_one_rank(ranks, one_rank):
    """MeTAL's default loss nets: two outer steps (second-order inner loops
    of every episode of the rank's shard at once) and the eval logits."""
    _held_as_one_rank(ranks, one_rank, "metal_train")


@pytest.mark.parametrize("n_devices", [2, 1])
def test_metal_per_step_matches_one_rank_and_the_jax_mesh(ranks, one_rank, cells, n_devices):
    """MeTAL's ``per_step_adapters`` path (the JAX package's
    ``test_metal_per_step_matches_across_mesh_sizes`` cell): two outer
    steps against one rank, and the losses and parameters against the JAX
    package's over ``get_mesh(n_devices)``."""
    ours = _held_as_one_rank(ranks, one_rank, "metal_train:per_step")
    with jax_cell():
        losses, _, params = mesh_tests._run(n_devices, cells["batches"],
                                          classifier=METAL_PER_STEP)
    _close(ours["losses"][:1], losses[:1], 2e-5)
    _close(ours["losses"], losses, 1e-4)
    variables, port_cfg = cells["inits"]["metal"]
    ref = port_state(variables, port_cfg, params=params)
    weights = _weights(ref)
    assert len(weights) > 8 and any(k.startswith("meta_loss_adapter.") for k in weights)
    _state_close(ours["state"], ref, weights)

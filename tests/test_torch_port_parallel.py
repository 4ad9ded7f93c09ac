"""Episode-parallel training and eval of the PyTorch port (``parallel``)
over 2 gloo ranks on the CPU, against the port's 1-rank run and the JAX
package's ``get_mesh(2)`` and ``get_mesh(1)``.

The two ranks are started once for the module (``torch.multiprocessing``
into ``audio_fewshot_tpu_torch.dryrun_multigpu``'s rank function, so they
import neither JAX nor tensorboard; a ``file://`` rendezvous under the
test's temporary directory, one thread each, a time limit on the
rendezvous, the collectives and the join) and run every scenario; the
1-rank runs take place in this process.  The cells: ProtoNet/Conv64F,
RENet's dual step and MAML on ``test_shard_equivalence._config()``'s cell
(SGD 0.05, 8 episodes of 3-way 2-shot 2-query on ``[1, 24, 30]``, its
batches), CPEANet on its depth-2 VisionTransformer (``[1, 24, 32]``), the
flagship DeepBDC/resnet12Bdc at ``reduce_dim`` 8 (one rank only: the JAX
mesh tests have no DeepBDC cell), the other shardable heads, a
``BatchNorm`` over 8 sharded rows (plain and masked) and DeepBDC's
energy-OOD TTA eval through ``Test`` on
``test_torch_port_slice.slice_config()``'s weights (plain BDC on the CPU).

Tolerances (float32 throughout), the JAX package's own between its
meshes (``test_shard_equivalence``) unless said: the first step's loss
rtol 1e-6 (2 ranks against 1) and 2e-5 (against the JAX package), a later
step's 2e-5 against one rank and 1e-4 against the JAX package, whose
float32 BN statistics flax's one-pass variance skews (RENet's 2e-4 both
ways, the JAX package's own RENet bound); parameters after the
steps rtol 1e-3, atol 5e-4, eval logits rtol 1e-3, atol 1e-2.  Two ranks
and one differ only in the order of their float32 sums (the all-reduces,
the two-pass BN moments against ATen's), which a step moves by up to
1e-5 of a loss.  The ``BatchNorm``: outputs, gradients and statistics
within 1e-5 of their scale, against one rank and against a float64 flax
``BatchNorm`` (flax's one-pass float32 variance is skewed: ROADMAP Queue
C).  DeepBDC: the accuracies, flagged clips and threshold of 2 ranks equal
one rank's; against the JAX package the flagged clips equal and the
threshold within 1e-4 (``test_torch_port_slice``'s).  The TTA's
accuracies with the port's draws are held against its 1-rank run only:
the packages draw different noise (``test_torch_port_tta`` holds the
re-vote on the JAX package's draws).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models import train_setting as jax_train_setting  # noqa: E402
from audio_fewshot_tpu.parallel.mesh import get_mesh as jax_get_mesh  # noqa: E402
from audio_fewshot_tpu.parallel.mesh import shard_batch as jax_shard_batch  # noqa: E402
from audio_fewshot_tpu.utils.checkpoint import save_variables  # noqa: E402
from audio_fewshot_tpu_torch import dryrun_multigpu as dry  # noqa: E402
from audio_fewshot_tpu_torch.eval import Test  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method, eval_setting  # noqa: E402
from audio_fewshot_tpu_torch.parallel import World  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402
from audio_fewshot_tpu_torch.utils.seed import init_seed  # noqa: E402

import test_shard_equivalence as mesh_tests  # noqa: E402
from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_slice import slice_config  # noqa: E402

TIMEOUT_S = 240
RANKS = 2
MAML = {"name": "MAML", "kwargs": {"inner_param": {"lr": 0.01, "train_iter": 2,
                                                   "test_iter": 2}, "way_num": 3}}
RENET = {"name": "RENet", "kwargs": {"feat_dim": 64, "num_class": 6}}
# test_shard_equivalence.test_cpea_vit_matches_across_mesh_sizes' cell
CPEA = {"name": "CPEANet", "kwargs": {"in_dim": 32}}
VIT = {"name": "VisionTransformer", "kwargs": {"patch_size": 8, "embed_dim": 32, "depth": 2,
                                               "num_heads": 2, "mlp_ratio": 2.0,
                                               "num_channels": 1}}
CPEA_SPEC = (1, 24, 32)


def tta_cell(**over):
    """``test_torch_port_slice``'s DeepBDC cell, one epoch of 2 steps of 2
    episodes, with the TTA (3 augmentations) unless ``over`` says not."""
    cfg = {"test_episode": 4, "test_episode_size": 2, "test_epoch": 1,
           "enhance_classification_via_energy": True, "num_augmentations": 3}
    cfg.update(over)
    return slice_config(**cfg)


def jax_init(classifier=None, batch=None, backbone=None):
    """The JAX package's initial variables of ``_config()``'s cell (with
    ``classifier`` and ``backbone``), as ``test_shard_equivalence._run``
    draws them."""
    cfg = mesh_tests._config()
    if classifier is not None:
        cfg["classifier"] = classifier
    if backbone is not None:
        cfg["backbone"] = backbone
    method = jax_build_method(cfg)
    setting = jax_train_setting(cfg)
    variables = jax.jit(lambda k, b: method.init_variables(k, b, setting))(
        jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(np.asarray, variables)


PORT_CONFIGS = {None: dry.proto_config, "MAML": dry.maml_config, "RENet": dry.renet_config,
                "CPEANet": dry.cpea_config}


def port_state(variables, classifier=None, params=None):
    """The port's state dict of a JAX variable tree (``params`` in place of
    its own), the keys the port's method holds (the MAML family's
    batch-statistics BNs hold no running statistics in the port)."""
    tree = {"params": variables["params"] if params is None else params,
            "batch_stats": variables.get("batch_stats", {})}
    name = None if classifier is None else classifier["name"]
    backbone = "vit_tiny" if name == "CPEANet" else "Conv64F"  # the ViT's layout
    state = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), backbone,
                                prefix="emb_func.", classifier=name)
    init_seed(0)
    keys = build_method(PORT_CONFIGS[name]()).state_dict().keys()
    return {k: v for k, v in state.items() if k in keys}


@pytest.fixture(scope="module")
def deepbdc_models():
    """``test_torch_port_slice.models``' JAX DeepBDC with random non-trivial
    weights (its init jitted) and the port's method holding them."""
    cfg = tta_cell()
    jax_method = jax_build_method(cfg)
    setting = eval_setting(cfg)
    example = next(iter(jax_get_dataloader(cfg, "test")[0].epoch(0)))
    variables = jax.jit(lambda k, b: jax_method.init_variables(k, b, setting))(
        jax.random.PRNGKey(0), example)
    variables = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, variables),
                                    np.random.default_rng(1))
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(variables, "resnet12Bdc", prefix="emb_func."))
    return cfg, setting, jax_method, variables, method.eval()


@pytest.fixture(scope="module")
def cells(tmp_path_factory, deepbdc_models):
    """The plan every rank runs, with the JAX package's initial weights in
    files, and the JAX runs each check reads."""
    root = tmp_path_factory.mktemp("parallel")
    batches = mesh_tests._batches(3)
    dual = mesh_tests._renet_dual_batches(2)
    cpea = mesh_tests._batches(1, spec=CPEA_SPEC)
    inits = {"proto": (jax_init(None, batches[0]), None),
             "maml": (jax_init(MAML, batches[0]), MAML),
             "renet": (jax_init(RENET, dual[0].episode), RENET),
             "cpea": (jax_init(CPEA, cpea[0], VIT), CPEA)}
    paths = {}
    for key, (variables, classifier) in inits.items():
        paths[key] = str(root / f"{key}.pt")
        torch.save(port_state(variables, classifier), paths[key])
    # DeepBDC: test_torch_port_slice's random non-trivial weights, saved
    # once as each package's model_best.pth
    _, _, _, variables, method = deepbdc_models
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    os.makedirs(os.path.join(jax_dir, "checkpoints"))
    save_variables(os.path.join(jax_dir, "checkpoints", "model_best.pth"), variables)
    save_model_best(port_dir, method)
    plan = {
        "proto_train": {"state": paths["proto"]},
        "batchnorm": {},
        "maml_train": {"state": paths["maml"]},
        "dual_train": {"state": paths["renet"]},
        "cpea_train": {"state": paths["cpea"]},
        "flagship_train": {},
        "tta_eval": {"cfg": tta_cell(), "result_path": port_dir},
        "divisibility": {},
        **{f"head_step:{head}": {"head": head} for head in dry.HEADS},
    }
    return {"root": root, "plan": plan, "inits": inits, "jax_dir": jax_dir,
            "batches": batches, "dual": dual, "cpea": cpea}


@pytest.fixture(scope="module")
def ranks(cells):
    """Each rank's results of the plan over 2 gloo ranks."""
    rdzv = cells["root"] / "rdzv"
    return dry.run_ranks(RANKS, cells["plan"], "cpu", init_method=f"file://{rdzv}",
                         timeout=TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def one_rank(cells):
    return dry.run_scenarios(World(), {k: v for k, v in cells["plan"].items()
                                       if k != "divisibility"})


def _close(ours, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


def _state_close(ours, ref, keys, rtol, atol):
    for key in keys:
        _close(ours[key], ref[key], rtol, atol)


# -- (a) ProtoNet/Conv64F ---------------------------------------------------------------------

def test_cells_are_the_jax_mesh_tests(cells):
    """The port's cell is ``_config()``'s, and its batches are ``_batches``'."""
    cfg, port = mesh_tests._config(), dry.proto_config()
    for key in ("backbone", "classifier", "way_num", "shot_num", "query_num", "precision"):
        assert port[key] == cfg[key], key
    assert port["optimizer"]["name"] == cfg["optimizer"]["name"] == "SGD"
    assert port["optimizer"]["kwargs"] == cfg["optimizer"]["kwargs"]
    for ours, ref in zip(dry.episode_batches(3), cells["batches"], strict=True):
        np.testing.assert_array_equal(ours.support, ref.support)
        np.testing.assert_array_equal(ours.query, ref.query)
    for ours, ref in zip(dry.episode_batches(1, spec=CPEA_SPEC), cells["cpea"], strict=True):
        np.testing.assert_array_equal(ours.query, ref.query)
    for ours, ref in zip(dry.dual_batches(2), cells["dual"], strict=True):
        np.testing.assert_array_equal(ours.flat.data, ref.flat.data)
        np.testing.assert_array_equal(ours.episode.global_target, ref.episode.global_target)


@pytest.mark.parametrize("n_devices", [2, 1])
def test_protonet_training_matches_one_rank_and_the_jax_mesh(ranks, one_rank, cells, n_devices):
    """(a) Losses, parameters and statistics after 3 SGD steps, and the eval
    logits of the first batch."""
    ours, single = ranks[0]["proto_train"], one_rank["proto_train"]
    assert ranks[1]["proto_train"]["losses"] == ours["losses"]  # one reduced gradient
    _close(ours["losses"][:1], single["losses"][:1], 1e-6)
    _close(ours["losses"], single["losses"], 2e-5)
    _state_close(ours["state"], single["state"], single["state"], 1e-3, 5e-4)
    _close(ours["logits"], single["logits"], 1e-3, 1e-2)
    losses, logits, params = mesh_tests._run(n_devices, cells["batches"])
    _close(ours["losses"][:1], losses[:1], 2e-5)
    _close(ours["losses"], losses, 1e-4)  # flax's float32 BN skew, one step on
    _close(ours["logits"], logits, 1e-3, 1e-2)
    ref = port_state(cells["inits"]["proto"][0], params=params)
    weights = [k for k in ref if not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked"))]
    assert weights
    _state_close(ours["state"], ref, weights, 1e-3, 5e-4)


# -- (b) BatchNorm ----------------------------------------------------------------------------

def jax_batchnorm(n_devices, masked):
    """flax's ``BatchNorm`` in float64 over the same rows, sharded over
    ``get_mesh(n_devices)``: output, input and affine gradients, running
    statistics."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.5, 2.0, size=(8, 4, 5, 6))
    cot = rng.normal(size=x.shape)
    mask = np.array([1, 0, 1, 1, 1, 1, 0, 1], dtype=bool)
    weight, bias = rng.normal(1.0, 0.2, size=4), rng.normal(0.0, 0.2, size=4)
    with jax.enable_x64(True):
        bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                               axis=1, dtype=jnp.float64, param_dtype=jnp.float64)
        variables = {"params": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                     "batch_stats": {"mean": jnp.zeros(4), "var": jnp.ones(4)}}
        mesh = jax_get_mesh(n_devices)
        rows = NamedSharding(mesh, PartitionSpec("data"))
        xs = jax.device_put(jnp.asarray(x), rows)
        m = jax.device_put(jnp.asarray(mask[:, None, None, None]
                                       * np.ones((1, 4, 5, 6), bool)), rows) if masked else None

        def f(params, xs):
            return bn.apply({**variables, "params": params}, xs, mask=m,
                            mutable=["batch_stats"])

        out, upd = f(variables["params"], xs)
        _, pull = jax.vjp(lambda p, v: f(p, v)[0], variables["params"], xs)
        d_params, dx = pull(jnp.asarray(cot))
        return {"y": np.asarray(out), "dx": np.asarray(dx),
                "d_affine": np.concatenate([np.asarray(d_params["scale"]),
                                            np.asarray(d_params["bias"])]),
                "running_mean": np.asarray(upd["batch_stats"]["mean"]),
                "running_var": np.asarray(upd["batch_stats"]["var"])}


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("n_devices", [2, 1])
def test_batchnorm_moments_span_the_ranks(ranks, one_rank, masked, n_devices):
    """(b) ``_FlaxBatchNorm`` in train mode over sharded rows: outputs,
    gradients and running statistics as one rank's and as flax's over the
    mesh (float64), plain and masked."""
    key = "masked" if masked else "plain"
    ours, single = ranks[0]["batchnorm"][key], one_rank["batchnorm"][key]
    assert torch.equal(ranks[1]["batchnorm"][key]["running_var"], ours["running_var"])
    ref = jax_batchnorm(n_devices, masked)
    for name in ("y", "dx", "d_affine", "running_mean", "running_var"):
        scale = float(np.abs(ref[name]).max())
        _close(ours[name], single[name], 0, 1e-5 * scale)
        _close(ours[name], ref[name], 0, 1e-5 * scale)


# -- (c) DeepBDC's energy-OOD TTA eval ------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [2, 1])
def test_deepbdc_tta_eval_matches_one_rank_and_the_jax_mesh(ranks, one_rank, deepbdc_models,
                                                            n_devices):
    """(c) The calibration threshold, the flagged clips of every TTA step
    (the whole step's top 20 %, on each rank) and the per-episode
    accuracies, in the one-rank order."""
    tta, single = ranks[0]["tta_eval"], one_rank["tta_eval"]
    for rank in ranks:
        assert rank["tta_eval"]["threshold"] == tta["threshold"]
        assert all(torch.equal(a, b) for a, b in zip(rank["tta_eval"]["flagged"],
                                                     tta["flagged"], strict=True))
    assert tta["threshold"] == pytest.approx(single["threshold"], rel=1e-6)
    assert len(tta["flagged"]) == 1 + 2  # the warm-up, then the epoch's 2 steps
    for ours, ref in zip(tta["flagged"], single["flagged"], strict=True):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    assert tta["episode_accs"] == single["episode_accs"]
    assert len(tta["episode_accs"][0]) == 4
    # the threshold and the flagged clips of the epoch's steps against the
    # JAX package's over the mesh
    cfg, setting, jax_method, variables, _ = deepbdc_models
    mesh = jax_get_mesh(n_devices)
    threshold = jax_method.calibrate_threshold(
        variables, jax_get_dataloader(tta_cell(), "val")[0], setting, mesh, policy="mean")
    assert tta["threshold"] == pytest.approx(threshold, rel=1e-4)
    forward = jax.jit(lambda v, b: jax_method.forward(v, b, setting))
    loader = jax_get_dataloader(tta_cell(), "test")[0]
    for step, batch in enumerate(loader.epoch(0)):
        u, _ = jax_method.clip_uncertainty(forward(variables, jax_shard_batch(batch, mesh)),
                                           batch)
        ref = np.sort(np.asarray(jax_method.ood_topk(u)))
        np.testing.assert_array_equal(np.sort(tta["flagged"][1 + step].numpy()), ref)


# -- (d) MAML, (e) RENet's dual step -------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [2, 1])
def test_maml_outer_step_matches_one_rank_and_the_jax_mesh(ranks, one_rank, cells, n_devices):
    """(d) One MAML outer step (second-order ``autograd.grad`` inner loops,
    per-episode batch statistics): its loss and the parameters after it."""
    ours, single = ranks[0]["maml_train"], one_rank["maml_train"]
    _close(ours["losses"], single["losses"], 1e-6)
    _state_close(ours["state"], single["state"], single["state"], 1e-3, 5e-4)
    losses, _, params = mesh_tests._run(n_devices, cells["batches"][:1], classifier=MAML)
    _close(ours["losses"], losses, 2e-5)
    ref = port_state(cells["inits"]["maml"][0], MAML, params=params)
    weights = [k for k in single["state"] if k in ref and not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    assert len(weights) > 8
    _state_close(ours["state"], ref, weights, 1e-3, 5e-4)


@pytest.mark.parametrize("n_devices", [2, 1])
def test_renet_dual_step_matches_one_rank_and_the_jax_mesh(ranks, one_rank, cells, n_devices):
    """(e) RENet's dual (episodic + flat) steps: both halves sharded, the
    backbone's and SCR's statistics over every rank's rows, CCA's per
    episode."""
    ours, single = ranks[0]["dual_train"], one_rank["dual_train"]
    _close(ours["losses"][:1], single["losses"][:1], 1e-6)
    _close(ours["losses"], single["losses"], 2e-4)
    # after one step: the float32 gradients through CCA move by up to 3 % of
    # their scale with the order of the BN sums alone (one rank, ATen's
    # moments against the two-pass ones), which a second step compounds
    _state_close(ours["first_state"], single["first_state"], single["state"], 1e-3, 5e-4)
    losses = mesh_tests._run_renet(n_devices, cells["dual"])
    _close(ours["losses"][:1], losses[:1], 2e-5)
    _close(ours["losses"], losses, 2e-4)


@pytest.mark.parametrize("n_devices", [2, 1])
def test_cpeanet_step_matches_one_rank_and_the_jax_mesh(ranks, one_rank, cells, n_devices):
    """CPEANet on a depth-2 VisionTransformer (LayerNorms, no batch
    statistics; test_shard_equivalence's cell): one SGD step's loss and the
    parameters after it."""
    ours, single = ranks[0]["cpea_train"], one_rank["cpea_train"]
    assert ranks[1]["cpea_train"]["losses"] == ours["losses"]
    _close(ours["losses"], single["losses"], 1e-6)
    _state_close(ours["state"], single["state"], single["state"], 1e-3, 5e-4)
    losses, _, params = mesh_tests._run(n_devices, cells["cpea"], classifier=CPEA,
                                        backbone=VIT)
    _close(ours["losses"], losses, 2e-5)
    ref = port_state(cells["inits"]["cpea"][0], CPEA, params=params)
    weights = [k for k in single["state"] if k in ref]
    assert len(weights) > 8
    _state_close(ours["state"], ref, weights, 1e-3, 5e-4)


def test_flagship_training_matches_one_rank(ranks, one_rank):
    """DeepBDC on resnet12Bdc (``reduce_dim`` 8, the BDC pool's plain
    version on the CPU), 8 episodes a step, 2 SGD steps from the seed's
    weights (the JAX package's mesh tests have no DeepBDC cell): the losses
    and every parameter and statistic after the first step.  Its float32
    BDC gradient moves by 1-3 % of a tensor's scale with the order of the
    sums alone (ROADMAP Queue C), which the second step compounds."""
    ours, single = ranks[0]["flagship_train"], one_rank["flagship_train"]
    assert ranks[1]["flagship_train"]["losses"] == ours["losses"]
    _close(ours["losses"][:1], single["losses"][:1], 1e-6)
    _close(ours["losses"], single["losses"], 2e-5)
    _state_close(ours["first_state"], single["first_state"], single["first_state"], 1e-3, 5e-4)


@pytest.mark.parametrize("head", sorted(dry.HEADS))
def test_the_other_shardable_heads_match_one_rank(ranks, one_rank, head):
    """MetaBaseline, R2D2, ANIL (its head adapted over every episode at once,
    the backbone's statistics over every rank's rows) and BOIL (per-episode
    body steps): two SGD steps' losses and the state after the first."""
    key = f"head_step:{head}"
    ours, single = ranks[0][key], one_rank[key]
    assert ranks[1][key]["losses"] == ours["losses"]
    _close(ours["losses"][:1], single["losses"][:1], 1e-6)
    _close(ours["losses"], single["losses"], 2e-5)
    _state_close(ours["first_state"], single["first_state"], single["first_state"], 1e-3, 5e-4)


# -- (f) the world size must divide the episode axis ----------------------------------------------

def test_a_world_that_does_not_divide_the_episodes_raises(ranks):
    """(f) ``get_mesh`` over 2 ranks with ``episode_size`` 3 raises, naming
    the batch knob and the world-size knobs."""
    for rank in ranks:
        message = rank["divisibility"]["message"]
        assert message is not None
        assert "episode_size (3)" in message and "world size (2" in message
        assert "n_devices" in message and "--nproc" in message


# -- one process ----------------------------------------------------------------------------------

@pytest.mark.parametrize("bank", [True, False], ids=["bank", "payload"])
def test_eval_queue_depth_changes_no_accuracy(bank):
    """``eval_queue_depth`` 0 (a drain every step), 1 and the default (32
    with a segment bank, 4 without) give the same per-episode accuracies
    (ProtoNet on the cell's Conv64F map, ragged clips, 5 steps of 2)."""
    runs = []
    for depth in (0, 1, None):
        cfg = dry.proto_config(data_root="synthetic:10:12", way_num=5, shot_num=2,
                               query_num=3, test_episode=10, test_episode_size=2,
                               test_epoch=1, max_segments_per_clip=3,
                               device_data_bank=bank, prefetch=0)
        if depth is not None:
            cfg["eval_queue_depth"] = depth
        test = Test(0, cfg, device="cpu")
        test.test_loop()
        assert (test.test_bank is not None) == bank
        runs.append(test.episode_accs)
    assert runs[0] == runs[1] == runs[2] and len(runs[0][0]) == 10


def test_deterministic_sets_the_cudnn_flags_both_ways():
    """``deterministic`` true: cuDNN's deterministic algorithms, no
    autotuning; false: autotuning.  ``Test`` reads it from the config."""
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        init_seed(0, True)
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (
            True, False)
        init_seed(0, False)
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (
            False, True)
        init_seed(0)  # None leaves them
        assert torch.backends.cudnn.benchmark
        Test(0, slice_config(test_episode=2, deterministic=True), device="cpu")
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        Test(0, slice_config(test_episode=2, deterministic=False), device="cpu")
        assert torch.backends.cudnn.benchmark and not torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


def test_a_method_not_audited_for_ranks_is_refused(monkeypatch):
    """Above one rank, ``Test`` and ``Trainer`` refuse a method whose step
    was not audited for a sharded episode axis, naming it (every registered
    method is audited: ADM here stands for one that is not)."""
    from audio_fewshot_tpu_torch import eval as port_eval

    monkeypatch.setattr(port_eval.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_eval.dist, "get_world_size", lambda: 2)
    init_seed(0)
    method = build_method(dry.proto_config(classifier={"name": "ADM", "kwargs": {"n_k": 3}}))
    monkeypatch.setattr(type(method), "shardable", False)
    with pytest.raises(ValueError, match="ADM does not run over 2 ranks"):
        port_eval.world_for({"classifier": {"name": "ADM"}}, method, torch.device("cpu"), {})

"""R2D2, R2D2MCL, ANIL and BOIL of the PyTorch port against the JAX package
on the CPU, at the same weights (the JAX package's random init with random
BN statistics and head values, carried across by ``utils/convert.py``).
MAML's own checks are in ``test_torch_port_maml.py``.

Conv64F with the shipped ``is_flatten`` on ``[1, 81, 90]`` segments (all
four pools leave a 1×1 map; the 1600-wide logits head's features);
R2D2MCL on Conv64F's map (``is_flatten``/``last_pool`` false) at
``[1, 108, 135]`` (the shipped 4×5 map).  3-way 2-shot 2-query; MAML-family
inner LR 0.01 (BOIL's groups 0.01 and 0.01, as shipped), ``test_iter`` 10.

Tolerances (relative to the logits' scale, or to a gradient's max abs):
- eval logits against the JAX package with a float64 Conv64F (its map
  rounded to float32, as both cast it, then a float64 head; the port's head
  is float32): the port in float32 to 1e-4 (``LOGIT_TOL``; the JAX
  package's own float32 run is up to 8.5e-5 of the scale off it, MAML's 10
  steps through 6-row batch statistics, and the port's up to 6.4e-5), with
  a float64 Conv64F to 3e-5 (``F64_LOGIT_TOL``; measured up to 1.24e-5,
  R2D2's solve);
- the real rows' logits with and without 2 bucket-padded query rows (the
  port against itself; BOIL's batch statistics exclude the padding): 1e-6
  of the scale (``PAD_TOL``);
- one train step against the JAX package with a float64 Conv64F and a
  float64 head, Dropout the identity in both: loss and logits 3e-5 of the
  logits' scale, every gradient 5e-4 of its max abs (``GRAD_TOL``; a tenth
  of the largest where that is more), running statistics 1e-5; the port
  with a float64 and with a float32 Conv64F.  Both packages round the map
  to float32 and the port's head is float32: measured logits 1.07e-5
  (BOIL), gradients 1.9e-4 (R2D2, float32 blocks) and 1.4e-4 (BOIL, float64
  blocks), where the JAX package's own float32 step is 2.9e-4 (BOIL) off
  its float64 one.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402

from audio_fewshot_tpu.episode import make_dense_episode_batch as jax_dense_batch  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting  # noqa: E402
from audio_fewshot_tpu.models.heads import mcl as jax_mcl  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.episode import make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.eval import SLICE_MODELS, slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.heads import mcl  # noqa: E402
from audio_fewshot_tpu_torch.train import slice_config as train_cell  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    head_state_dict_from_jax, state_dict_from_jax)
from tools.cross_framework_parity import (  # noqa: E402
    invert_maml_head_params, invert_r2d2_head_params)

from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_metric import _rel, _running, no_dropout  # noqa: E402,F401
from test_torch_port_resnet12_heads import _check_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4
F64_LOGIT_TOL = 3e-5
PAD_TOL = 1e-6
GRAD_TOL = 5e-4
STATS_TOL = 1e-5
WAY, SHOT, QUERY = 3, 2, 2
SETTING = EpisodeSetting(way=WAY, shot=SHOT, query=QUERY)
SPEC = (1, 81, 90)
MAP_SPEC = (1, 108, 135)
INNER = {"lr": 0.01, "train_iter": 5, "test_iter": 10}
KWARGS = {
    "ANIL": {"inner_param": INNER},
    "MAML": {"inner_param": INNER},
    "BOIL": {"inner_param": {"extractor_lr": 0.01, "classifier_lr": 0.01},
             "testing_method": "NIL"},
}
STEP_TOLS = {"logits": 3e-5, "grads": GRAD_TOL, "vanishing": 1e-3, "stats": STATS_TOL}


def meta_config(name, dtype=None, **over):
    """The shipped head on Conv64F at the test's small geometry, float32
    (``BOIL:<mode>`` sets BOIL's ``testing_method``)."""
    name, _, mode = name.partition(":")
    kwargs = {"is_flatten": True, "num_channels": 1}
    if name == "R2D2MCL":
        kwargs = {"is_flatten": False, "last_pool": False, "num_channels": 1}
    if dtype:
        kwargs["dtype"] = dtype
    cls_kwargs = dict(KWARGS.get(name, {}))
    if mode:
        cls_kwargs["testing_method"] = mode
    cfg = {"classifier": {"name": name, "kwargs": cls_kwargs},
           "backbone": {"name": "Conv64F", "kwargs": kwargs},
           "modality": "audio", "precision": "fp32", "way_num": WAY, "shot_num": SHOT,
           "query_num": QUERY, "spec_shape": list(MAP_SPEC if name == "R2D2MCL" else SPEC)}
    cfg.update(over)
    return cfg


def batches(name, e, pad=0, seed=0):
    """The same dense episodes for both packages; with ``pad``, that many
    bucket-padded query rows (noise, mask 0) after the real ones."""
    spec = MAP_SPEC if name.startswith("R2D2MCL") else SPEC
    rng = np.random.default_rng(seed)
    sup = rng.normal(size=(e, WAY * SHOT) + spec).astype(np.float32)
    qry = rng.normal(size=(e, WAY * QUERY) + spec).astype(np.float32)
    jb, pb = jax_dense_batch(sup, qry, WAY, SHOT, QUERY), make_dense_episode_batch(
        sup, qry, WAY, SHOT, QUERY)
    if pad:
        extra = rng.normal(size=(e, pad) + spec).astype(np.float32)
        fields = dict(query=np.concatenate([qry, extra], axis=1),
                      query_clip=np.concatenate([pb.query_clip, np.zeros((e, pad), np.int32)], 1),
                      query_mask=np.concatenate([pb.query_mask, np.zeros((e, pad), np.float32)], 1))
        jb, pb = jb.replace(**fields), pb.replace(**fields)
    return jb, pb.to("cpu")


_VARIABLES = {}
# MAML, ANIL and BOIL draw the same tree (one Conv64F and one Dense from the
# same key): one initialisation serves the three
_SAME_INIT = {"ANIL": "MAML", "BOIL": "MAML"}


def jax_variables(name):
    """The JAX method's initial variables with random BN statistics and
    head values (R2D2's scalars, the MAML-family Linear's bias), made once
    per head (once for the MAML family), its ``init_variables`` jitted (the
    same draws as op by op, one compile instead of one per op)."""
    name = name.partition(":")[0]
    name = _SAME_INIT.get(name, name)
    if name not in _VARIABLES:
        jb, _ = batches(name, 1)
        method = jax_build_method(meta_config(name))
        variables = jax.jit(lambda key: method.init_variables(key, jb, SETTING))(
            jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        variables = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, variables), rng)
        params = variables["params"]
        if "head" in params:  # α, β, γ away from 1, 0, 50
            params["head"] = {k: np.asarray(v * 1.3 + 0.2, np.float32)
                              for k, v in params["head"].items()}
        _VARIABLES[name] = variables
    return _VARIABLES[name]


def port_state(variables, name, params=None, stats=None):
    """The port's state dict of the JAX ``variables`` (with ``params`` or
    ``batch_stats`` in place of their own): the batch-statistics BNs of the
    MAML family's Conv64F hold no running statistics in the port, so theirs
    are dropped."""
    name = name.partition(":")[0]
    tree = {"params": variables["params"] if params is None else params,
            "batch_stats": variables.get("batch_stats", {}) if stats is None else stats}
    state = state_dict_from_jax(tree, "Conv64F", prefix="emb_func.", classifier=name)
    keys = build_method(meta_config(name)).state_dict().keys()
    dropped = set(state) - set(keys)
    assert all(k.endswith(("running_mean", "running_var", "num_batches_tracked"))
               for k in dropped)
    return {k: v for k, v in state.items() if k in keys}


def port_method(name, variables, dtype=torch.float32):
    method = build_method(meta_config(name))
    method.load_state_dict(port_state(variables, name))
    if dtype == torch.float64:  # the blocks only: the map and the head stay float32
        emb = method.emb_func
        emb.dtype = dtype
        for layer in (emb.layer1, emb.layer2, emb.layer3, emb.layer4):
            layer.to(dtype)
    return method


def jax_forward64(name, variables, jb):
    """The JAX package's eval logits with a float64 Conv64F (the map rounded
    to float32) and a float64 head."""
    with jax.enable_x64(True):
        jax_method = jax_build_method(meta_config(name, dtype="float64"))
        wide = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        return np.asarray(jax.jit(lambda v, b: jax_method.forward(v, b, SETTING))(wide, jb))


def check_eval_logits(name):
    """Eval-mode logits of two episodes with 2 bucket-padded query rows
    against the JAX package's (float64 Conv64F), the port in float32 and
    with a float64 Conv64F; the real rows' are the port's own on the
    unpadded batch."""
    variables = jax_variables(name)
    jb, pb = batches(name, 2, pad=2, seed=5)
    ref = jax_forward64(name, variables, jb)
    _, dense = batches(name, 2, seed=5)
    for dtype, tol in ((torch.float32, LOGIT_TOL), (torch.float64, F64_LOGIT_TOL)):
        method = port_method(name, variables, dtype).eval()
        with torch.no_grad():
            ours = method(pb, SETTING).numpy()
            unpadded = method(dense, SETTING).numpy()
        assert ours.shape == ref.shape == (2, WAY * QUERY + 2, WAY)
        assert _rel(ours, ref) <= tol
        np.testing.assert_allclose(ours[:, :WAY * QUERY], unpadded, rtol=0,
                                   atol=PAD_TOL * np.abs(ref).max())
    assert np.ptp(ref[:, :WAY * QUERY], axis=-1).max() > 10 * LOGIT_TOL * np.abs(ref).max()


@pytest.mark.parametrize("name", ["R2D2", "R2D2MCL", "ANIL", "BOIL:NIL", "BOIL:Directly",
                                  "BOIL:Once_update"])
def test_eval_logits_match_jax_and_ignore_bucket_padding(name):
    check_eval_logits(name)


# -- one train step --------------------------------------------------------------------------

def step_reference(name, variables, seed):
    """One train step of the JAX package with a float64 Conv64F and a float64
    head on the episode of ``seed``: (loss, logits, gradients, running
    statistics) under the port's names, and the port's batch."""
    jb, pb = batches(name, 1, seed=seed)
    with jax.enable_x64(True):
        jax_method = jax_build_method(meta_config(name, dtype="float64"))
        wide = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        non_params = {k: v for k, v in wide.items() if k != "params"}

        def loss_fn(params):
            return jax_method.loss({**non_params, "params": params}, jb, SETTING,
                                   jax.random.PRNGKey(1))

        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(wide["params"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
        stats = jax.tree_util.tree_map(np.asarray, (out.updates or {}).get("batch_stats", {}))
    ref_stats = port_state(variables, name, stats=stats) if stats else {}
    ref_stats = {k: v for k, v in ref_stats.items() if k.endswith(("mean", "var"))}
    return (float(loss), np.asarray(out.seg_logits),
            {k: v.numpy() for k, v in port_state(variables, name, params=grads).items()},
            {k: v.numpy() for k, v in ref_stats.items()}), pb


@pytest.mark.parametrize("name", ["R2D2", "ANIL", "BOIL"])
def test_train_step_matches_jax_float64(name, no_dropout):
    """Loss, logits, every gradient (the backbone's, the ridge scalars', the
    MAML-family head's through its inner loop: ANIL's five head steps and
    BOIL's one body-and-head step, second order) and the running statistics
    (R2D2, ANIL: their BNs update in train mode) of one train step."""
    variables = jax_variables(name)
    ref, pb = step_reference(name, variables, seed=2)
    for dtype in (torch.float64, torch.float32):
        method = port_method(name, variables, dtype).train()
        loss, out = method.loss(pb, SETTING)
        loss.backward()
        named = dict(method.named_parameters())
        assert len(named) == 20 + (3 if name == "R2D2" else 2)
        _check_step(named, _running(method), loss, out, ref, STEP_TOLS)
        assert bool(_running(method)) == (name != "BOIL")


# -- the pieces ------------------------------------------------------------------------------

def test_katz_query_mask_matches_jax():
    """R2D2MCL's query weights (the query nodes' Katz centrality, summing to
    1 over each query's positions) on random maps, float32."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 7, 16, 3, 4)).astype(np.float32)
    s = rng.normal(size=(2, 15, 16, 3, 4)).astype(np.float32)
    ours = mcl.katz_query_mask(torch.from_numpy(q), torch.from_numpy(s), 5, 3, 0.5, 20.0, 10.0)
    ref = np.asarray(jax_mcl.katz_query_mask(q, s, 5, 3, 0.5, 20.0, 10.0))
    assert ours.shape == ref.shape == (2, 7, 12)
    assert _rel(ours.numpy(), ref) <= LOGIT_TOL
    np.testing.assert_allclose(ours.sum(dim=-1).numpy(), 1.0, atol=1e-6)


def test_boil_steps_the_body_and_the_head_at_their_own_rates():
    """BOIL keys its inner LRs on the submodule: ``classifier_lr`` 0 leaves
    the head at its weights, the body moves at ``extractor_lr``."""
    variables = jax_variables("BOIL")
    cfg = meta_config("BOIL")
    cfg["classifier"]["kwargs"]["inner_param"] = {"extractor_lr": 0.01, "classifier_lr": 0.0}
    method = build_method(cfg)
    method.load_state_dict(port_state(variables, "BOIL"))
    _, pb = batches("BOIL", 1)
    with torch.no_grad():
        adapted = method._adapt(pb.support[0], pb.support_target[0].long(), 1)
    own = dict(method.named_parameters())
    for key, val in adapted.items():
        moved = not torch.equal(val, own[key])
        if key.startswith("classifier.") or ".logits.1." in key:
            assert not moved, key
        elif key.endswith(".weight"):  # a conv bias before a batch-statistics BN may not move
            assert moved, key
    assert method.train_iter == 1 and method.test_mode == "NIL"
    with pytest.raises(ValueError, match="testing_method"):
        build_method(meta_config("BOIL:Twice"))


@pytest.mark.parametrize("name", ["R2D2", "MAML", "ANIL", "BOIL"])
def test_head_weights_cross_under_the_reference_names(name):
    """``utils/convert.py``'s head entries are ``tools/cross_framework_parity.py``'s
    inverters' (``classifier.alpha/beta/gamma`` [1]; ``classifier.layers.0``),
    and the whole converted state loads into the port strictly."""
    variables = jax_variables(name)
    ours = head_state_dict_from_jax(variables, name)
    ref = (invert_r2d2_head_params if name == "R2D2" else invert_maml_head_params)(variables)
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key], val, err_msg=key)
    method = build_method(meta_config(name))
    head_keys = {k for k in method.state_dict() if not k.startswith("emb_func.")}
    assert head_keys == set(ref)
    method.load_state_dict(port_state(variables, name))
    assert head_state_dict_from_jax(jax_variables("R2D2MCL"), "R2D2MCL").keys() == {
        "classifier.alpha", "classifier.beta", "classifier.gamma"}


# -- the chip cells ------------------------------------------------------------------------------

SHIPPED = {"R2D2": "r2d2", "MAML": "maml", "ANIL": "anil", "BOIL": "boil"}


@pytest.mark.parametrize("kind", ["eval", "train"])
@pytest.mark.parametrize("name", list(SHIPPED))
def test_chip_cells_are_the_shipped_configs_cut_to_size(name, kind, tmp_path):
    """The cells ``chip_smoke.py`` runs are each head's shipped
    ``*_5shot_iid_seed0.yaml`` (``backbones/Conv64F.yaml``; MAML's two
    episodes a step) with its headers but for the cuts they name; each
    builds at full width: the 1600 flat features of Conv64F's logits head,
    the MAML family's batch-statistics BNs (ANIL's running ones)."""
    shipped = Config(os.path.join(REPO, "config", SHIPPED[name],
                                  f"{SHIPPED[name]}_5shot_iid_seed0.yaml")).get_config_dict()
    assert name in SLICE_MODELS
    if kind == "eval":
        cell = eval_cell(classifier=name, test_episode=32, test_epoch=1)
        cuts = {"test_episode": (600, 32), "test_epoch": (5, 1), "test_episode_size": (None, 16),
                "max_segments_per_clip": (8, 6), "spec_shape": (None, [1, 128, 157])}
        kept = ("classifier", "backbone", "modality", "test_way", "test_shot", "test_query",
                "augment_times", "seed", "ood", "tag", "episode_size")
    else:
        cell = train_cell(str(tmp_path), classifier=name, epoch=1, train_episode=20,
                          test_episode=16)
        cuts = {"epoch": (30, 1), "train_episode": (1000, 20), "test_episode": (600, 16),
                "result_root": ("./results", str(tmp_path)), "tb_scale": (1000 / 600, 20 / 16),
                "spec_shape": (None, [1, 128, 157])}
        kept = [k for k in shipped if k not in cuts and k != "includes"]
    for key, (full, cut) in cuts.items():
        assert (shipped.get(key), cell.get(key)) == (full, cut), key
    for key in kept:
        assert cell.get(key) == shipped.get(key), key
    if kind == "train":
        return
    model = build_method(cell)
    assert model.emb_func.feature_dim(cell["spec_shape"]) == 1600
    assert model.emb_func.layer1[1].track_running_stats == (name in ("R2D2", "ANIL"))
    if name != "R2D2":
        assert model.classifier.layers[0].weight.shape == (5, 1600)

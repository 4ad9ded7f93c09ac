"""The class-aware ViT and CPEANet of the PyTorch port against the JAX
package on the CPU, at the same weights (the JAX package's random init,
carried across by ``utils/convert.py``).

A depth-2 ViT with embed 48 and 3 heads at patch 16 on ``[1, 32, 48]``
segments (2×3 patches, 7 tokens), CPEA with ``in_dim`` 48, 3-way 2-shot
2-query.

Tolerances (relative to the output's scale, or to a gradient's max abs):
- tokens, float32 against the JAX package's float32: 1e-5 (``TOKEN_TOL``);
  bf16 against the JAX package's bf16: 2e-2 (``BF16_TOL``, measured 8.6e-3: 7 bits of
  mantissa through two blocks; flax's softmax rounds its exponentials to
  bf16 where the port's accumulates in float32, ROADMAP Queue C), each
  within 2e-2 of the float32 tokens;
- CPEA eval logits, float32 against float32: 1e-5 (``LOGIT_TOL``); the real
  rows' logits with and without 2 bucket-padded query rows: 1e-6
  (``PAD_TOL``);
- one CPEA train step against the JAX package with a float64 ViT (its
  tokens rounded to float32 in both packages, as both cast them) and a
  float64 head: loss and logits 1e-5 of the logits' scale, every gradient
  1e-4 of its max abs (``GRAD_TOL``), the port with a float64 and with a
  float32 ViT;
- ``remat`` with dropout on: the gradients equal the plain run's to 1e-6
  (``REMAT_TOL``; the recompute draws the forward's masks).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from audio_fewshot_tpu.episode import make_dense_episode_batch as jax_dense_batch  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.backbones import vit as jax_vit  # noqa: E402
from audio_fewshot_tpu.models.base import EpisodeSetting  # noqa: E402
from audio_fewshot_tpu.utils.torch_convert import invert_backbone_params  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.episode import make_dense_episode_batch  # noqa: E402
from audio_fewshot_tpu_torch.eval import SLICE_MODELS, slice_config as eval_cell  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.layers import seed_dropout  # noqa: E402
from audio_fewshot_tpu_torch.registry import BACKBONES  # noqa: E402
from audio_fewshot_tpu_torch.train import slice_config as train_cell  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import (  # noqa: E402
    head_state_dict_from_jax, state_dict_from_jax)
from tools.cross_framework_parity import invert_cpea_head_params  # noqa: E402

from test_torch_port_metric import _rel  # noqa: E402
from test_torch_port_resnet12_heads import _check_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN_TOL = 1e-5
BF16_TOL = 2e-2
LOGIT_TOL = 1e-5
PAD_TOL = 1e-6
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
WAY, SHOT, QUERY = 3, 2, 2
SETTING = EpisodeSetting(way=WAY, shot=SHOT, query=QUERY)
SPEC = (1, 32, 48)
SMALL = {"embed_dim": 48, "depth": 2, "num_heads": 3}
STEP_TOLS = {"logits": LOGIT_TOL, "grads": GRAD_TOL, "vanishing": 1e-3, "stats": 0.0}


def _x(n=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n,) + SPEC).astype(np.float32)


# -- the backbone ------------------------------------------------------------------------

# each registered factory's kwargs, the same in both packages
FACTORIES = {
    "vit_tiny": SMALL,
    "ViT": {"dim": 48, "depth": 2, "heads": 3, "mlp_dim": 96, "pool": "mean",
            "final_norm": False},
    "VisionTransformer": {**SMALL, "qkv_bias": True, "mlp_ratio": 2.0},
}
_JAX_FACTORIES = {"vit_tiny": jax_vit.vit_tiny, "ViT": jax_vit.vit,
                  "VisionTransformer": jax_vit.vision_transformer}


def _jax_vit(name, dtype="float32"):
    kwargs = dict(FACTORIES[name], dtype=dtype, num_channels=1)
    module = _JAX_FACTORIES[name](**kwargs)
    variables = module.init(jax.random.PRNGKey(0), _x(1), train=False)
    return module, jax.tree_util.tree_map(np.asarray, dict(variables))


def _port_vit(name, variables, dtype=torch.float32):
    model = BACKBONES.get(name)(**dict(FACTORIES[name], dtype=dtype, num_channels=1,
                                       spec_shape=SPEC))
    model.load_state_dict(state_dict_from_jax(variables, name))
    return model.eval()


@pytest.mark.parametrize("name", list(FACTORIES))
def test_vit_output_matches_jax(name):
    """Tokens (``vit_tiny``, ``VisionTransformer``) or the mean token with no
    final norm (``ViT``: the standard ViT's kwarg names, eps 1e-5) of three
    segments whose sides are no multiple of the patch elsewhere (cropped),
    float32."""
    module, variables = _jax_vit(name)
    x = np.concatenate([_x(3), np.zeros((3, 1, 32, 5), np.float32) + 9.0], axis=-1)
    ref = np.asarray(module.apply(variables, x, train=False))
    model = _port_vit(name, variables)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == ((3, 7, 48) if name != "ViT" else (3, 48))
    assert ours.dtype == np.float32
    assert _rel(ours, ref) <= TOKEN_TOL
    eps = {"vit_tiny": 1e-6, "VisionTransformer": 1e-6, "ViT": 1e-5}[name]
    assert model.blocks[0].norm1.eps == eps


def test_vit_bf16_tokens_match_jax_bf16():
    """The bf16 token stream against the JAX package's bf16 one, and each
    against the float32 tokens."""
    module, variables = _jax_vit("vit_tiny", "bfloat16")
    x = _x(4, seed=1)
    ref = np.asarray(module.apply(variables, x, train=False))
    ref32 = np.asarray(_jax_vit("vit_tiny")[0].apply(variables, x, train=False))
    with torch.no_grad():
        ours = _port_vit("vit_tiny", variables, torch.bfloat16)(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float32
    assert _rel(ours, ref) <= BF16_TOL
    assert _rel(ours, ref32) <= BF16_TOL and _rel(ref, ref32) <= BF16_TOL


def test_vit_remat_draws_the_forward_dropout_masks():
    """``remat`` with ``drop_rate`` 0.1 in train mode: the same tokens and
    the same gradients as without it (the block's generators rewound for
    the recompute), and train mode drops (eval does not)."""
    _, variables = _jax_vit("vit_tiny")
    x = torch.from_numpy(_x(2, seed=2))
    grads, outs = [], []
    for remat in (False, True):
        model = BACKBONES.get("vit_tiny")(**SMALL, drop_rate=0.1, remat=remat,
                                          dtype=torch.float32, spec_shape=SPEC)
        model.load_state_dict(state_dict_from_jax(variables, "vit_tiny"))
        seed_dropout(model, 3)
        model.train()
        out = model(x)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        outs.append(out.detach())
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
        with torch.no_grad():
            evaluated = model.eval()(x)
    assert torch.equal(outs[0], outs[1])
    for key, g in grads[0].items():
        assert (grads[1][key] - g).abs().max() <= REMAT_TOL * g.abs().max(), key
    assert _rel(outs[0].numpy(), evaluated.numpy()) > 1e-3  # dropout acted in train mode


# -- CPEANet ------------------------------------------------------------------------------

def cpea_config(dtype=None, **over):
    kwargs = dict(SMALL, patch_size=16, num_channels=1)
    if dtype:
        kwargs["dtype"] = dtype
    cfg = {"classifier": {"name": "CPEANet", "kwargs": {"in_dim": 48}},
           "backbone": {"name": "vit_tiny", "kwargs": kwargs},
           "modality": "audio", "precision": "fp32", "way_num": WAY, "shot_num": SHOT,
           "query_num": QUERY, "spec_shape": list(SPEC)}
    cfg.update(over)
    return cfg


def _batches(e, pad=0, seed=0):
    rng = np.random.default_rng(seed)
    sup = rng.normal(size=(e, WAY * SHOT) + SPEC).astype(np.float32)
    qry = rng.normal(size=(e, WAY * QUERY) + SPEC).astype(np.float32)
    jb, pb = jax_dense_batch(sup, qry, WAY, SHOT, QUERY), make_dense_episode_batch(
        sup, qry, WAY, SHOT, QUERY)
    if pad:
        extra = rng.normal(size=(e, pad) + SPEC).astype(np.float32)
        fields = dict(query=np.concatenate([qry, extra], axis=1),
                      query_clip=np.concatenate([pb.query_clip, np.zeros((e, pad), np.int32)], 1),
                      query_mask=np.concatenate([pb.query_mask, np.zeros((e, pad), np.float32)], 1))
        jb, pb = jb.replace(**fields), pb.replace(**fields)
    return jb, pb.to("cpu")


_VARIABLES = {}


def _cpea_variables():
    if not _VARIABLES:
        jb, _ = _batches(1)
        variables = jax_build_method(cpea_config()).init_variables(
            jax.random.PRNGKey(0), jb, SETTING)
        variables = jax.tree_util.tree_map(np.asarray, variables)
        # non-trivial LayerNorm and bias values, so that every key must land
        rng = np.random.default_rng(1)
        _VARIABLES["v"] = jax.tree_util.tree_map_with_path(
            lambda path, a: (a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
                             if path[-1].key in ("bias", "scale") else a), variables)
    return _VARIABLES["v"]


def _port_cpea(variables, dtype=torch.float32):
    method = build_method(cpea_config())
    method.load_state_dict(state_dict_from_jax(variables, "vit_tiny", prefix="emb_func.",
                                               classifier="CPEANet"))
    method.emb_func.dtype = dtype
    return method


def test_cpea_eval_logits_match_jax_and_ignore_bucket_padding():
    variables = _cpea_variables()
    jax_method = jax_build_method(cpea_config())
    jb, pb = _batches(2, pad=2, seed=5)
    ref = np.asarray(jax.jit(lambda v, b: jax_method.forward(v, b, SETTING))(variables, jb))
    method = _port_cpea(variables).eval()
    _, dense = _batches(2, seed=5)
    with torch.no_grad():
        ours = method(pb, SETTING).numpy()
        unpadded = method(dense, SETTING).numpy()
    assert ours.shape == ref.shape == (2, WAY * QUERY + 2, WAY)
    assert _rel(ours, ref) <= LOGIT_TOL
    np.testing.assert_allclose(ours[:, :WAY * QUERY], unpadded, rtol=0,
                               atol=PAD_TOL * np.abs(ref).max())
    assert np.ptp(ref[:, :WAY * QUERY], axis=-1).max() > 10 * LOGIT_TOL * np.abs(ref).max()


def test_cpea_train_step_matches_jax_float64():
    """Loss, logits and every gradient (ViT and CPEA) of one train step,
    the port with a float64 and with a float32 ViT, against the JAX package
    with a float64 ViT and a float64 head (the tokens rounded to float32 in
    both, as both cast them)."""
    variables = _cpea_variables()
    jb, pb = _batches(1, seed=2)
    with jax.enable_x64(True):
        jax_method = jax_build_method(cpea_config(dtype="float64"))
        embed = jax_method.embed

        def embed_wide(*args, **kwargs):
            sup, qry, updates = embed(*args, **kwargs)
            return sup.astype(np.float64), qry.astype(np.float64), updates

        jax_method.embed = embed_wide
        wide = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(params):
            return jax_method.loss({"params": params}, jb, SETTING, jax.random.PRNGKey(1))

        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(wide["params"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
    ref_grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": grads}, "vit_tiny", prefix="emb_func.", classifier="CPEANet").items()}
    ref = (float(loss), np.asarray(out.seg_logits), ref_grads, {})
    for dtype in (torch.float64, torch.float32):
        method = _port_cpea(variables, dtype).train()
        loss_t, out_t = method.loss(pb, SETTING)
        loss_t.backward()
        named = dict(method.named_parameters())
        assert len(named) == 4 + 12 * SMALL["depth"] + 2 + 10
        _check_step(named, {}, loss_t, out_t, ref, STEP_TOLS)


def test_vit_and_cpea_weights_cross_under_the_reference_names():
    """``utils/convert.py``'s ViT and CPEA entries are the JAX package's
    ``_invert_vit_class_aware`` and ``invert_cpea_head_params``, key for key
    and value for value, and load into the port strictly."""
    variables = _cpea_variables()
    ours = state_dict_from_jax(variables, "vit_tiny", prefix="emb_func.")
    ref = invert_backbone_params(variables, "VisionTransformer")
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
    head = head_state_dict_from_jax(variables, "CPEANet")
    ref_head = invert_cpea_head_params(variables)
    assert set(head) == set(ref_head)
    for key, val in ref_head.items():
        np.testing.assert_array_equal(head[key], val, err_msg=key)
    method = build_method(cpea_config())
    assert set(method.state_dict()) == set(ref) | set(ref_head)
    method.load_state_dict(state_dict_from_jax(variables, "vit_tiny", prefix="emb_func.",
                                               classifier="CPEANet"))


# -- the chip cells -------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["eval", "train"])
def test_cpea_chip_cells_are_the_shipped_config_at_full_width(kind, tmp_path):
    """The cells ``chip_smoke.py`` runs are ``cpea_5shot_iid_seed0.yaml`` with
    its headers but for their cuts; it builds at full width: vit_tiny, 73
    tokens of 192 for a [1, 128, 157] segment, CPEA's fc2 over 72² = 5184."""
    shipped = Config(os.path.join(REPO, "config", "cpea",
                                  "cpea_5shot_iid_seed0.yaml")).get_config_dict()
    assert "CPEANet" in SLICE_MODELS
    if kind == "eval":
        cell = eval_cell(classifier="CPEANet", test_episode=32, test_epoch=1)
        kept = ("classifier", "backbone", "modality", "test_way", "test_shot", "test_query",
                "seed", "ood", "tag")
    else:
        cell = train_cell(str(tmp_path), classifier="CPEANet", epoch=1, train_episode=20,
                          test_episode=16)
        kept = [k for k in shipped if k not in (
            "includes", "epoch", "train_episode", "test_episode", "result_root", "tb_scale",
            "spec_shape")]
    for key in kept:
        assert cell.get(key) == shipped[key], key
    if kind == "train":
        return
    model = build_method(cell)
    assert model.emb_func.map_shape(cell["spec_shape"]) == (73, 192)
    assert model.CPEA.fc2.fc1.in_features == 5184 and len(model.emb_func.blocks) == 12
    with torch.no_grad():
        tokens = model.emb_func(torch.zeros((1,) + tuple(cell["spec_shape"])))
    assert tokens.shape == (1, 73, 192) and tokens.dtype == torch.float32

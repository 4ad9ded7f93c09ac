"""The plain references against the port on the CPU, at small sizes, in
float32: the data, the backbones with the BDC head, the logits and the clip
vote."""

import copy
import json

import numpy as np
import pytest
import torch

from gpu_bench import manifest, program, weights
from gpu_bench.reference import common, data, judge

SMALL = {"deepbdc_resnet12bdc": [1, 24, 32], "protonet_conv64f": [1, 81, 90]}


def model_config(name, **changes):
    cfg = json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())["config"]
    return {**cfg, "spec_shape": SMALL[name], "precision": "fp32", **changes}


def port_method(cfg):
    from audio_fewshot_tpu_torch.config import Config
    from audio_fewshot_tpu_torch.models import build_method

    return build_method(Config(None, copy.deepcopy(cfg)).get_config_dict())


def drawn(name, cfg, seed=3):
    ref = manifest.load_module(manifest.HERE / "reference" / f"{name}.py", "reference")
    return ref, weights.draw(ref.weight_spec(cfg), seed, torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_features_match_port(name):
    cfg = model_config(name)
    ref, w = drawn(name, cfg)
    method = port_method(cfg)
    method.load_state_dict(w, strict=True)
    method.eval()
    x = torch.randn((6,) + tuple(cfg["spec_shape"]), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), common.float32_exact():
        ours = method.emb_func(x).reshape(6, -1)
        theirs = ref.features(w, x)
    scale = theirs.abs().max()
    assert float((ours - theirs).abs().max() / scale) < 1e-4


@pytest.mark.parametrize("name", sorted(SMALL))
def test_logits_and_vote_match_port(name):
    from audio_fewshot_tpu_torch.episode import EpisodeBatch
    from audio_fewshot_tpu_torch.models import eval_setting

    cfg = model_config(name, max_segments_per_clip=3)
    ref, w = drawn(name, cfg)
    method = port_method(cfg).eval()
    method.load_state_dict(w, strict=True)
    split = data.synthetic_split(5, "test", tuple(cfg["spec_shape"]), 3)
    eps = data.build_episodes(split, data.episode_plans(5, "test", 0, 2, 5, 5, 10))
    batch = EpisodeBatch(
        support=torch.as_tensor(eps.support), query=torch.as_tensor(eps.query),
        query_clip=torch.as_tensor(eps.query_clip), query_mask=torch.as_tensor(eps.query_mask),
        support_target=torch.as_tensor(np.repeat(np.arange(5), 5)[None].repeat(2, 0)),
        query_target=torch.as_tensor(eps.query_target))
    from audio_fewshot_tpu_torch.config import Config
    setting = eval_setting(Config(None, copy.deepcopy(cfg)).get_config_dict())
    with torch.no_grad(), common.float32_exact():
        ours = method(batch, setting)
        acc = method.eval_episode_accuracy(ours, batch)
    theirs = judge.reference_logits(ref, w, eps, cfg, torch.device("cpu"))
    mask = torch.as_tensor(eps.query_mask) > 0
    assert judge.logit_gap(ours[mask].numpy(), theirs[mask].numpy()) < 1e-4
    vote = common.vote_accuracy(ours, batch.query_clip, batch.query_mask, batch.query_target)
    assert torch.equal(vote.float(), acc.double().float())


def test_data_matches_port_loader():
    """The synthetic splits, the episode plans and the packed eval batches
    are the port's loader's."""
    from audio_fewshot_tpu_torch.config import Config
    from audio_fewshot_tpu_torch.data import get_dataloader

    cfg = Config(None, {**model_config("deepbdc_resnet12bdc", max_segments_per_clip=4),
                        "seed": 2 ** 31 + 9, "test_episode_size": 3, "test_episode": 9,
                        "prefetch": 0}).get_config_dict()
    loader = get_dataloader(cfg, "test")[0]
    split = data.synthetic_split(cfg["seed"], "test", tuple(cfg["spec_shape"]), 4)
    for a, b in zip(loader.dataset.clips, split.clips):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    plans = data.episode_plans(cfg["seed"], "test", 1, 9, 5, 5, 10)
    for step, batch in enumerate(loader.epoch(1)):
        eps = data.build_episodes(split, plans[3 * step:3 * step + 3])
        for field in ("support", "query", "query_clip", "query_mask", "query_target"):
            assert np.array_equal(np.asarray(getattr(batch, field)), getattr(eps, field)), field


def test_program_config_keeps_the_cells_sizes():
    cell = manifest.load_cell("deepbdc-eval-b16")
    cfg = program.config(cell, 7)
    assert cfg["spec_shape"] == [1, 128, 157] and cfg["test_episode_size"] == 16
    assert cfg["backbone"]["kwargs"]["reduce_dim"] == 64 and cfg["precision"] == "bf16"

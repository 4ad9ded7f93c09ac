"""Each configuration's analytic FLOP count against
``torch.utils.flop_counter.FlopCounterMode`` over the port's forward of one
``[1, 128, 157]`` segment, and the roofline arithmetic."""

import copy
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpu_bench import manifest
from gpu_bench.peaks import PEAKS, bdc_bound_ms


@pytest.mark.parametrize("name", ["deepbdc_resnet12bdc", "protonet_conv64f"])
def test_segment_flops_match_the_flop_counter(name):
    from audio_fewshot_tpu_torch.config import Config
    from audio_fewshot_tpu_torch.models import build_method

    cfg = json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())["config"]
    counted = manifest.load_module(manifest.HERE / "configs" / f"{name}_flops.py", "configs")
    method = build_method(Config(None, {**copy.deepcopy(cfg), "precision": "fp32"})
                          .get_config_dict()).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        method.emb_func(torch.zeros((1,) + tuple(cfg["spec_shape"])))
    assert counter.get_total_flops() == counted.segment_flops(cfg)


def test_bdc_bound_at_the_main_path_shape():
    sxm = PEAKS["H100 SXM"]
    assert bdc_bound_ms(4496, 64, 304, sxm) == pytest.approx((0.1156, "bytes"), rel=1e-3)
    assert sxm["bf16_flops"] == 989e12

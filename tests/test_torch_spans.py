"""The port's spans and row counters (``utils/spans.py``) on the CPU: the
spans of an eval step and of the loader under ``torch.profiler``, with
their nesting and threads; nothing recorded without a profiler; the row
counters over exactly the steps dispatched."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_fewshot_tpu_torch.config import Config
from audio_fewshot_tpu_torch.data import get_dataloader
from audio_fewshot_tpu_torch.eval import Test
from audio_fewshot_tpu_torch.parallel import shard_batch, transfer_ahead
from audio_fewshot_tpu_torch.utils import spans


def tiny_config(**over):
    """DeepBDC on resnet12Bdc, whose BDC pool runs inside the backbone."""
    cfg = {"classifier": {"name": "DeepBDC", "kwargs": None},
           "backbone": {"name": "resnet12Bdc", "kwargs": {"num_channels": 1, "reduce_dim": 8}},
           "way_num": 3, "shot_num": 2, "query_num": 2, "data_root": "synthetic:10:12",
           "spec_shape": [1, 16, 20], "max_segments_per_clip": 3, "precision": "fp32",
           "test_episode": 12, "test_episode_size": 2, "test_epoch": 1, "seed": 0,
           "prefetch": 2, "log_level": "warning"}
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


def bank_loader(**over):
    """The tiny config's test loader emitting bank row ids, as ``Test``'s."""
    loader = get_dataloader(tiny_config(**over), "test")[0]
    loader.use_segment_bank()
    return loader


def afs_events(prof):
    """``(name, thread, nearest afs.* ancestor)`` of every ``afs.*`` span."""
    out = []
    for e in prof.events():
        if e.name.startswith("afs."):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith("afs."):
                parent = parent.cpu_parent
            out.append((e.name, e.thread, parent.name if parent else None))
    return out


@pytest.fixture(scope="module")
def deepbdc_test():
    torch.manual_seed(0)
    return Test(0, tiny_config(), None, device="cpu")


def test_span_is_one_shared_noop_without_a_profiler():
    first, second = spans.span("afs.step"), spans.span("afs.data")
    assert first is second
    assert not isinstance(first, torch.autograd.profiler.record_function)
    with first, second:  # reentrant: nested and reused
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recording = spans.span("afs.step")
        with recording:
            pass
    assert isinstance(recording, torch.autograd.profiler.record_function)
    assert [e.name for e in prof.events() if e.name.startswith("afs.")] == ["afs.step"]


def test_an_untraced_step_enters_no_record_function(deepbdc_test, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    test = deepbdc_test
    with torch.no_grad():
        batches = transfer_ahead(test.test_loader[0].epoch(0), test.step_world,
                                 test.transfer_dtype)
        test._device_step(next(batches))
        batches.close()


def test_an_eval_step_and_the_loader_record_every_span_nested_on_its_thread(deepbdc_test):
    test = deepbdc_test
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU],
                                  **spans.every_thread()) as prof:
        batches = transfer_ahead(test.test_loader[0].epoch(0), test.step_world,
                                 test.transfer_dtype)
        for _ in range(2):
            test._device_step(next(batches))
        batches.close()
    seen = afs_events(prof)
    main = {t for n, t, _ in seen if n == "afs.step"}
    assert len(main) == 1
    parents = {(n, p) for n, _, p in seen}
    assert parents == {("afs.data", None), ("afs.data.build", None), ("afs.transfer", None),
                       ("afs.step", None), ("afs.bank_gather", "afs.step"),
                       ("afs.head", "afs.step"), ("afs.backbone", "afs.head"),
                       ("afs.bdc_pool", "afs.backbone"), ("afs.vote", "afs.step")}
    for name, thread, _ in seen:
        assert (thread in main) == (name != "afs.data.build"), (name, thread)
    assert sum(n == "afs.step" for n, _, _ in seen) == 2


def test_without_prefetch_the_build_runs_inside_the_callers_data_span():
    loader = bank_loader(prefetch=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        next(iter(loader.epoch(0)))
    assert ("afs.data.build", "afs.data") in {(n, p) for n, _, p in afs_events(prof)}


@pytest.mark.parametrize("path", ["transfer_ahead", "shard_batch"])
def test_the_row_counters_count_exactly_the_dispatched_steps(monkeypatch, deepbdc_test, path):
    """Steps dispatched from a loader that builds ``prefetch`` 2 batches
    ahead (on the card ``transfer_ahead`` takes one more): the counters
    hold the masks' own counts of those steps alone."""
    test = deepbdc_test
    loader = test.test_loader[0]
    assert loader.prefetch == 2 and len(loader) == 6
    built = []

    def recorded(epoch):
        for b in loader.epoch(epoch):
            built.append(b)
            yield b

    monkeypatch.setattr(spans, "rows_real", 0)
    monkeypatch.setattr(spans, "rows_computed", 0)
    steps = 3
    with torch.no_grad():
        if path == "transfer_ahead":
            batches = transfer_ahead(recorded(0), test.step_world, test.transfer_dtype)
            for _ in range(steps):
                test._device_step(next(batches))
            batches.close()
        else:
            host = recorded(0)
            for _ in range(steps):
                test._device_step(shard_batch(next(host), test.step_world,
                                              test.transfer_dtype))
            host.close()
    dispatched = built[:steps]
    rows = [b.support_idx.shape[0] * (b.support_idx.shape[1] + b.query_idx.shape[1])
            for b in dispatched]
    real = [b.support_idx.size + int(np.asarray(b.query_mask).sum()) for b in dispatched]
    assert spans.rows_computed == sum(rows)
    assert spans.rows_real == sum(real)
    assert 0 < spans.rows_real < spans.rows_computed


def test_the_real_rows_come_from_the_host_mask_never_from_a_device():
    host = next(iter(bank_loader(prefetch=0).epoch(0)))
    assert host.real_rows is None
    sent = host.to("meta")  # a device whose tensors hold no values
    assert sent.real_rows == host.support_idx.size + int(host.query_mask.sum())
    assert sent.to("meta").real_rows == sent.real_rows  # carried, not recounted
    sent.real_rows = None
    assert sent.to("meta").real_rows is None
    assert sent.rows == host.support_idx.shape[0] * (host.support_idx.shape[1]
                                                     + host.query_idx.shape[1])

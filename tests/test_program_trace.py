"""The readings of the program's spans and counters
(``gpu_bench/program_trace.py``, ``gpu_bench/metrics/pad_rows_pct.py``) on
hand-built traces: idle split by overlap with the launching thread's
spans, device time charged by launch, nothing read where there is nothing
to read."""

from collections import namedtuple

import pytest
from torch.autograd import DeviceType

from gpu_bench import manifest, program_trace
from gpu_bench.run import Run
from gpu_bench.trace import Trace
from audio_fewshot_tpu_torch.utils import spans as program_spans

MAIN, WORKER = 1, 2
Kernel = namedtuple("Kernel", "name device duration")
Range = namedtuple("Range", "start end")
Event = namedtuple("Event", "name device_type thread time_range kernels is_user_annotation",
                   defaults=(False,))


def device_idle_pct(trace):
    return manifest.reader("device_idle_pct").read(Run(0.0, {}, {}, trace=trace))


def idle_pct(trace, spans):
    parts, _ = program_trace.idle_split(trace, spans)
    return {k: 100.0 * v / trace.window_s for k, v in parts.items()}


@pytest.fixture
def episode():
    """One window of 100 µs: the device busy [0, 10) and [50, 100); the
    main thread in ``afs.data`` [5, 30) then in ``afs.step`` [30, 60); the
    worker building a batch over the whole gap."""
    trace = Trace(ops=[("k1", 0.0, 10.0), ("k2", 50.0, 100.0)], spans=[],
                  window=(0.0, 100.0))
    spans = [("afs.data", 5.0, 30.0, MAIN), ("afs.step", 30.0, 60.0, MAIN),
             ("afs.head", 32.0, 58.0, MAIN), ("afs.backbone", 33.0, 40.0, MAIN),
             ("afs.data.build", 0.0, 100.0, WORKER)]
    return trace, spans


def test_a_gap_over_two_spans_is_split_by_overlap(episode):
    trace, spans = episode
    got = idle_pct(trace, spans)
    # the gap [10, 50) began in afs.data: 20 µs there, 20 in afs.step
    assert got == pytest.approx({"data": 20.0, "step": 20.0, "other": 0.0})


def test_the_parts_sum_to_the_device_idle_share(episode):
    trace, spans = episode
    spans = [s for s in spans if s[0] != "afs.data"] + [("afs.transfer", 20.0, 30.0, MAIN)]
    got = idle_pct(trace, spans)
    # [10, 20) outside every span, [20, 30) in afs.transfer, [30, 50) in the step
    assert got == pytest.approx({"data": 10.0, "step": 20.0, "other": 10.0})
    _, by_span = program_trace.idle_split(trace, spans)
    assert by_span == pytest.approx({"none": 10e-6, "afs.transfer": 10e-6, "afs.step": 2e-6,
                                     "afs.head": 11e-6, "afs.backbone": 7e-6})
    assert sum(got.values()) == pytest.approx(device_idle_pct(trace)) == pytest.approx(40.0)


def test_only_the_launching_threads_spans_divide_the_idle(episode):
    trace, spans = episode
    alone = [("afs.step", 60.0, 70.0, MAIN), ("afs.data.build", 0.0, 100.0, WORKER)]
    assert program_trace.launching_thread(alone) == MAIN
    assert idle_pct(trace, alone) == pytest.approx({"data": 0.0, "step": 0.0, "other": 40.0})


def test_a_launch_inside_the_backbone_counts_though_it_runs_after_the_span(episode):
    _, spans = episode
    launched = [(MAIN, 35.0, 500.0),  # launched in afs.backbone, runs long after
                (MAIN, 45.0, 7.0),    # launched in afs.head, after the backbone
                (WORKER, 35.0, 3.0)]  # another thread at the same moment
    assert program_trace.launched_in_us(spans, launched, "afs.backbone") == 500.0
    by_span = program_trace.device_us_by_span(spans, launched + [(MAIN, 80.0, 1.0)])
    assert by_span == {"afs.backbone": 500.0, "afs.head": 7.0, "afs.data.build": 3.0,
                       "none": 1.0}


def test_launches_read_the_profilers_links_of_ops_and_spans_alone():
    """An op's kernels count once: not the span's device-side twin, not the
    copy a runtime event whose correlation id collides with the op's holds."""
    events = [
        Event("afs.backbone", DeviceType.CPU, MAIN, Range(30.0, 40.0),
              [Kernel("afs.backbone", 0, 90.0)], True),
        Event("aten::conv2d", DeviceType.CPU, MAIN, Range(31.0, 32.0),
              [Kernel("cudnn_fprop", 0, 40.0), Kernel("nchwToNhwc", 0, 5.0)]),
        Event("Command Buffer Full", DeviceType.CPU, MAIN, Range(31.5, 31.9),
              [Kernel("cudnn_fprop", 0, 40.0)]),
        Event("cudaEventRecordWithFlags", DeviceType.CPU, MAIN, Range(31.6, 31.7),
              [Kernel("nchwToNhwc", 0, 5.0)]),
        Event("aten::empty", DeviceType.CPU, MAIN, Range(33.0, 34.0), []),
        Event("afs.bdc_pool", DeviceType.CPU, MAIN, Range(36.0, 37.0),
              [Kernel("afs.bdc_pool", 0, 9.0), Kernel("bdc_pool_kernel", 0, 8.0)], True),
        Event("cudnn_fprop", DeviceType.CUDA, 0, Range(35.0, 75.0), []),
    ]
    assert program_trace.launches(events) == [(MAIN, 31.0, 45.0), (MAIN, 36.0, 8.0)]
    assert program_trace.program_spans(events) == [("afs.backbone", 30.0, 40.0, MAIN),
                                                   ("afs.bdc_pool", 36.0, 37.0, MAIN)]


def test_readings_per_step(episode):
    trace, spans = episode
    events = [Event(n, DeviceType.CPU, t, Range(a, b), []) for n, a, b, t in spans]
    events.append(Event("aten::conv2d", DeviceType.CPU, MAIN, Range(34.0, 35.0),
                        [Kernel("cudnn_fprop", 0, 40.0)]))
    got = program_trace.readings(trace, events, (75, 100))
    assert got["backbone_ms"] == pytest.approx(0.040)
    assert got["pad_rows_pct"] == pytest.approx(25.0)
    assert got["idle_data_pct"] == pytest.approx(20.0)


def test_nothing_is_read_without_device_operations_or_spans():
    cpu_run = Trace(ops=[], spans=[], window=(0.0, 100.0))
    spans = [("afs.step", 0.0, 50.0, MAIN)]
    assert program_trace.idle_split(cpu_run, spans) is None
    got = program_trace.readings(cpu_run, [], None)
    assert all(v is None for v in got.values()), got
    parent = Trace(ops=[("k", 0.0, 10.0)], spans=[], window=(0.0, 100.0))
    assert program_trace.idle_split(parent, []) is None  # a program without spans


def test_the_padded_rows_reader(monkeypatch):
    reader = manifest.reader("pad_rows_pct.eval")
    monkeypatch.setattr(program_spans, "rows_computed", 0)
    monkeypatch.setattr(program_spans, "rows_real", 0)
    assert reader.read(Run(0.0, {}, {})) is None
    monkeypatch.setattr(program_spans, "rows_computed", 4496)
    monkeypatch.setattr(program_spans, "rows_real", 3200)
    assert reader.read(Run(0.0, {}, {})) == pytest.approx(100.0 * 1296 / 4496)

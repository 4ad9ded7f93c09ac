"""Padded backbone rows over all rows the backbone computed (%), from the
program's own counters (``audio_fewshot_tpu_torch.utils.spans``:
``rows_real``, ``rows_computed``), which ``Test._device_step`` counts from
host sizes as each step is dispatched.  They run from the process's start,
so the share is over every step the run dispatched: warm-up, window and
traced stretch."""


def read(run):
    try:
        from audio_fewshot_tpu_torch.utils import spans
    except ImportError:  # a program without the counters
        return None
    computed = getattr(spans, "rows_computed", 0)
    if not computed:
        return None
    return 100.0 * (computed - spans.rows_real) / computed

"""Named spans and row counters on the eval path, for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records, and otherwise one shared no-op context, after one flag check: the
spans cost nothing measurable untraced, and no setting turns them on.
Recorded, they are CPU events of the profiler's own trace, on the clock of
its kernels, and the profiler links each kernel to the torch op that
launched it (``FunctionEvent.kernels``), so a kernel can be charged to the
span around that op even where it runs after the span has closed.  The BDC
pool's kernel, launched through ``ctypes`` outside any torch op, links to
none.

The spans (each named ``afs.*``; the thread they run on):

- ``afs.data``: ``EpisodicLoader.epoch`` handing its caller the next batch,
  the wait on the prefetch queue included, and closing the epoch, the wait
  for the prefetch worker to stop included (the caller's);
- ``afs.data.build``: building a batch: sampling, ragged packing, bank row
  ids (the prefetch worker; the caller's, inside ``afs.data``, without
  prefetch).  A profiler records another thread's spans only when asked to
  profile every thread (``every_thread``);
- ``afs.transfer``: ``parallel.shard_batch`` and ``transfer_ahead``'s copy
  and hand-over: host slice, pinning, the copy's enqueue (the caller's);
- ``afs.step``: ``eval.Test._device_step``, with inside it
  ``afs.bank_gather`` (``episode.materialize_episode_batch``),
  ``afs.head`` (the method's forward; the backbone's part of it is its
  child ``afs.backbone``, so the head's own share is what lies outside
  that child), ``afs.backbone`` (the backbone call of
  ``MethodBase.embed``, with ``afs.bdc_pool``, the BDC pool, inside it)
  and ``afs.vote`` (``MethodBase.eval_episode_accuracy``).

The counters, counted by ``Test._device_step`` as each step is dispatched
(the loader builds batches ahead of the steps), from sizes the host knows,
never from the device: ``rows_computed``, every row the backbone computes
(support rows and padded query slots), and ``rows_real``, the support rows
and the valid query segments among them.  Set both to 0 to reset.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

from torch.autograd import profiler as _profiler

#: backbone rows of the dispatched steps: support rows and valid query
#: segments (set to 0 to reset)
rows_real = 0
#: backbone rows of the dispatched steps: every support row and query slot
#: (set to 0 to reset)
rows_computed = 0

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def count_rows(batch: Any) -> None:
    """Add a dispatched episode batch's rows to the counters: its shapes and
    the real rows its copy to the device counted (``real_rows``).  A batch
    whose real rows are unknown (a mask already on the device) counts in
    neither."""
    global rows_real, rows_computed
    real = getattr(batch, "real_rows", None)
    if real is not None:
        rows_real += real
        rows_computed += batch.rows


def every_thread() -> Dict[str, Any]:
    """``torch.profiler.profile`` arguments that record every thread's
    spans (the prefetch worker's ``afs.data.build``), where this torch can;
    else none."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:  # a torch without the option
        return {}

"""Faults planted in the program underneath a run, to show that the
comparison catches them (the tests drive them on the CPU; ``calibrate``
reads them on the card):

- ``half_batch``: half of each episode's query segments left out, given
  the mean logits of the other half;
- ``altered_answer``: one query segment's logits in every step rolled by a
  class, where the method produces them.

The one-chip cells have no exchange between chips to leave out, and the
eval cells no state that a step changes.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

FAULTS = {"eval": ("half_batch", "altered_answer")}


@contextlib.contextmanager
def planted(name: str, classifier: str) -> Iterator[None]:
    """Plant fault ``name`` in the program's ``classifier`` class while the
    context is open."""
    from audio_fewshot_tpu_torch.registry import CLASSIFIERS

    cls = CLASSIFIERS.get(classifier)
    forward = cls.forward
    if name == "half_batch":
        def planted_forward(self, batch, setting):
            logits = forward(self, batch, setting).clone()
            half = logits.shape[1] // 2
            logits[:, half:] = logits[:, :half].mean(dim=1, keepdim=True)
            return logits
    elif name == "altered_answer":
        def planted_forward(self, batch, setting):
            logits = forward(self, batch, setting).clone()
            logits[:, 0] = logits[:, 0].roll(1, dims=-1)
            return logits
    else:
        raise KeyError(f"unknown fault {name!r}")
    saved = cls.__dict__.get("forward")
    cls.forward = planted_forward
    try:
        yield
    finally:
        if saved is None:
            del cls.forward
        else:
            cls.forward = saved

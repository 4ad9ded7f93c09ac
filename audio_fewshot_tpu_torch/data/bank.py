"""Device-resident segment banks (counterpart of ``audio_fewshot_tpu/data/bank.py``).

Each split's segments go to the device once, as one normalised tensor
(in ``transfer_dtype`` when set, e.g. bf16, upcast on gather); loaders then
emit bank row ids and the eval step gathers episodes with ``index_select``
(``episode.materialize_episode_batch``).

Config: ``device_data_bank``: true / false / "auto" (default: each split's
bank is on while the running total fits ``device_data_bank_max_gb``).
``device_eval_bank`` / ``device_eval_bank_max_gb`` are accepted aliases; a
non-default value under either name wins.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _resolve(config: Dict[str, Any], new_key: str, old_key: str, default):
    new = config.get(new_key, default)
    old = config.get(old_key)
    if new != default or old is None:
        return new
    return old


def setup_segment_banks(
    config: Dict[str, Any],
    loaders: List[Any],
    device: torch.device,
    transfer_dtype: Optional[torch.dtype] = None,
    logger=None,
) -> List[Optional[torch.Tensor]]:
    """Switch ``loaders`` to bank-index batches and return each one's device
    bank (None where disabled).  Loaders sharing a dataset share one bank;
    datasets are admitted smallest first until the byte cap."""
    knob = _resolve(config, "device_data_bank", "device_eval_bank", "auto")
    if not knob:
        return [None] * len(loaders)
    cap_gb = _resolve(config, "device_data_bank_max_gb", "device_eval_bank_max_gb", 4.0)
    per_elem = torch.empty((), dtype=transfer_dtype or torch.float32).element_size()
    datasets = {}
    for ld in loaders:
        datasets.setdefault(id(ld.dataset), ld.dataset)

    admitted: Dict[int, Any] = {}
    budget = float(cap_gb) * 2 ** 30
    auto = str(knob).lower() == "auto"
    for key, ds in sorted(datasets.items(), key=lambda kv: kv[1].bank_nbytes(per_elem)):
        nbytes = ds.bank_nbytes(per_elem)
        if auto and nbytes > budget:
            if logger:
                logger.info(
                    "segment bank skipped for a %.2f GiB split (budget "
                    "%.2f GiB left of device_data_bank_max_gb=%.2f)",
                    nbytes / 2 ** 30, budget / 2 ** 30, float(cap_gb),
                )
            continue
        admitted[key] = ds
        budget -= nbytes

    banks: Dict[int, torch.Tensor] = {}
    for key, ds in admitted.items():
        host, _ = ds.segment_bank()
        banks[key] = torch.from_numpy(np.ascontiguousarray(host)).to(
            device=device, dtype=transfer_dtype or torch.float32
        )
        ds.release_bank_payload()  # only the starts map is needed from here on
    for ld in loaders:
        if id(ld.dataset) in banks:
            ld.use_segment_bank()
    if logger and banks:
        logger.info(
            "device-resident segment banks: %.1f MiB on %s (%s)",
            sum(b.numel() * b.element_size() for b in banks.values()) / 2 ** 20,
            device, ", ".join(f"{b.shape[0]} segments" for b in banks.values()),
        )
    return [banks.get(id(ld.dataset)) for ld in loaders]


def resolve_transfer_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """``transfer_dtype`` config knob → torch dtype (None = keep float32)."""
    if not name:
        return None
    name = str(name).lower()
    if name in ("float32", "fp32", "none"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float16", "fp16"):
        return torch.float16
    raise ValueError(f"unsupported transfer_dtype {name!r}")

"""Process groups and episode-axis sharding (counterpart of
``audio_fewshot_tpu/parallel/mesh.py``).

One process per GPU (``torchrun``, or an entry point's ``--nproc``), each
holding the whole model.  A batch's leading axis (episodes, or a flat
batch's rows) is cut into one contiguous slice a rank: rank ``r`` of ``W``
gets rows ``[r·E/W, (r+1)·E/W)``.  After ``backward`` the gradients are
summed over the ranks in one flat buffer and divided by ``W``: every
supported loss is a mean over equal shards, so that is the gradient of
the whole batch's loss.  Whatever spans the batch axis besides is made
global on purpose: BatchNorm moments (``sharded_rows``, read by
``models.backbones.layers._FlaxBatchNorm``), ``ood_topk``, the
calibration quantiles and the per-episode accuracies (``gather_rows``).
So an N-rank run computes what a 1-rank run computes, up to the order of
the float sums.  No ``DistributedDataParallel``: the MAML family takes
``torch.autograd.grad`` in its inner loops, which DDP's hooks do not
support.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..episode import DualBatch, IndexedEpisodeBatch, IndexedFlatBatch
from ..utils.spans import span
from .collectives import World

#: seconds a collective (and the rendezvous) may wait before it fails
TIMEOUT_S = 600.0


def resolve_transfer_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The ``transfer_dtype`` knob as a torch dtype: ``data.bank``'s (the
    data package imports the models, which import this package, so it is
    looked up when called)."""
    from ..data.bank import resolve_transfer_dtype as resolve

    return resolve(name)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def maybe_init_distributed(config: Dict[str, Any],
                           device: Optional[Union[str, torch.device]] = None) -> bool:
    """Join the run's process group, once; True when one exists.

    - ``multihost: true``: rendezvous at ``tcp://<coordinator_address>``
      (or ``127.0.0.1:<port>``, the reference's rendezvous) with
      ``num_processes`` ranks, this one ``process_id`` (each falls back to
      ``WORLD_SIZE`` / ``RANK`` in the environment);
    - otherwise under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment):
      ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and the ``dist_init_method``
      config key (default ``env://``, torchrun's ``MASTER_ADDR`` /
      ``MASTER_PORT``);
    - otherwise nothing: a single process.

    The backend is NCCL on the card and gloo on the CPU; the rendezvous and
    every collective time out after ``TIMEOUT_S`` seconds."""
    if dist.is_initialized():
        return True
    env = os.environ
    if config.get("multihost"):
        addr = config.get("coordinator_address")
        if not addr and config.get("port"):
            addr = f"127.0.0.1:{int(config['port'])}"
        init_method = f"tcp://{addr}" if addr else config.get("dist_init_method", "env://")
        size = int(config.get("num_processes") or env.get("WORLD_SIZE", 1))
        rank = int(config.get("process_id") if config.get("process_id") is not None
                   else env.get("RANK", 0))
    elif int(env.get("WORLD_SIZE", "1")) > 1:
        init_method = config.get("dist_init_method") or "env://"
        size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    dev = torch.device("cuda" if device is None else device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(_device(dev, rank, config.get("device_ids")))
    dist.init_process_group(
        backend, init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def _card_ids(device_ids) -> Optional[List[int]]:
    """The ``device_ids`` knob as a list of several card indices (a comma
    string or a list; one id, the default 0, picks nothing)."""
    if device_ids is None:
        return None
    ids = ([int(i) for i in str(device_ids).split(",") if i.strip()]
           if isinstance(device_ids, (str, int)) else [int(i) for i in device_ids])
    return ids if len(ids) > 1 else None


def _device(device: torch.device, rank: int, device_ids=None) -> torch.device:
    """``cuda`` without an index is the card of this rank's ``LOCAL_RANK``,
    or the ``LOCAL_RANK``-th of ``device_ids`` where it lists several."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = _local_rank(rank)
    ids = _card_ids(device_ids)
    if ids is not None:
        if local >= len(ids):
            raise ValueError(f"rank {rank} (local rank {local}) has no card in device_ids {ids}")
        local = ids[local]
    if local >= torch.cuda.device_count():
        raise ValueError(f"rank {rank} (local rank {local}) has no card: "
                         f"{torch.cuda.device_count()} CUDA device(s) here")
    return torch.device("cuda", local)


def get_mesh(n_devices: Optional[int] = None, divisors: Optional[Dict[str, int]] = None,
             device: Optional[Union[str, torch.device]] = None, device_ids=None) -> World:
    """This process's ``World`` in the run's process group (a world of one
    without a group).

    Raises when ``n_devices`` asks for more ranks than there are cards
    (NCCL takes one card a rank) or than the run has, and when the world
    size does not divide a value of ``divisors`` (``{knob: value}``, e.g.
    ``episode_size``), naming the knob; the JAX package falls back to the
    largest divisor instead.  ``device_ids``: the cards of the host's ranks
    (``_device``)."""
    dev = torch.device("cuda" if device is None else device)
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_devices is not None and int(n_devices) != size:
        have = torch.cuda.device_count() if dev.type == "cuda" else None
        if have is not None and int(n_devices) > have:
            raise ValueError(f"requested {n_devices} devices, have {have}")
        raise ValueError(
            f"n_devices {n_devices} asks for {n_devices} ranks, but this run has {size}: "
            f"launch it with `torchrun --nproc_per_node {n_devices}` or `--nproc {n_devices}`")
    if (dev.type == "cuda" and dist.is_initialized()
            and dist.get_backend() == "nccl" and size > torch.cuda.device_count()):
        raise ValueError(f"{size} NCCL ranks need {size} cards, have "
                         f"{torch.cuda.device_count()}")
    for knob, value in (divisors or {}).items():
        if value and int(value) % size:
            raise ValueError(
                f"{knob} ({value}) must be divisible by the world size ({size} ranks: "
                f"n_devices, --nproc or torchrun --nproc_per_node)")
    return World(rank, size, _device(dev, rank, device_ids))


# -- batches --------------------------------------------------------------------------------

def _slice_host(batch: Any, world: World) -> Any:
    """This rank's rows of every leaf of a host batch (None leaves kept)."""
    if isinstance(batch, DualBatch):
        return DualBatch(episode=_slice_host(batch.episode, world),
                         flat=_slice_host(batch.flat, world))
    if world.size == 1:
        return batch
    lead = getattr(batch, dataclasses.fields(batch)[0].name)
    rows = world.rows(lead.shape[0])
    return dataclasses.replace(batch, **{
        f.name: None if getattr(batch, f.name) is None else getattr(batch, f.name)[rows]
        for f in dataclasses.fields(batch)})


def _put(batch: Any, device: torch.device, transfer_dtype) -> Any:
    if isinstance(batch, (IndexedEpisodeBatch, IndexedFlatBatch)):
        return batch.to(device)
    return batch.to(device, transfer_dtype)


def shard_batch(batch: Any, world: Optional[World], transfer_dtype=None,
                device: Optional[torch.device] = None) -> Any:
    """This rank's slice of a host ``EpisodeBatch`` / ``FlatBatch`` /
    ``DualBatch`` or their bank-row forms, on its device (``transfer_dtype``:
    the float payload's wire dtype, upcast to float32 there).  ``world``
    None: the whole batch on ``device``."""
    with span("afs.transfer"):
        if world is None:
            return _put(batch, device, transfer_dtype)
        return _put(_slice_host(batch, world), world.device, transfer_dtype)


def _pinned(batch: Any, transfer_dtype=None) -> Any:
    """A host batch with every array leaf in page-locked memory, its float
    leaves already in their wire dtype (``transfer_dtype``, else float32),
    so that the copy to the card needs no pageable temporary."""
    if isinstance(batch, DualBatch):
        return DualBatch(episode=_pinned(batch.episode, transfer_dtype),
                         flat=_pinned(batch.flat, transfer_dtype))

    def pin(x):
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)
            x = torch.from_numpy(x if x.flags.writeable else x.copy())
        dtype = (transfer_dtype or torch.float32) if x.is_floating_point() else x.dtype
        return torch.empty(x.shape, dtype=dtype, pin_memory=True).copy_(x)

    return dataclasses.replace(batch, **{f.name: pin(getattr(batch, f.name))
                                         for f in dataclasses.fields(batch)})


def _tensors(batch: Any) -> Iterator[torch.Tensor]:
    if isinstance(batch, DualBatch):
        yield from _tensors(batch.episode)
        yield from _tensors(batch.flat)
        return
    for f in dataclasses.fields(batch):
        x = getattr(batch, f.name)
        if isinstance(x, torch.Tensor):
            yield x


def transfer_ahead(batches: Iterable[Any], world: World, transfer_dtype=None) -> Iterator[Any]:
    """Each host batch's shard on the device, one batch ahead: on the card
    the next batch is copied from page-locked memory on a side stream
    (``non_blocking``) while the current one computes, and the compute
    stream waits for a batch's copy before the batch is handed out."""
    it = iter(batches)
    if world.device.type != "cuda":
        for b in it:
            yield shard_batch(b, world, transfer_dtype)
        return
    copy_stream = torch.cuda.Stream(world.device)

    def put(b):
        with span("afs.transfer"):
            local = _pinned(_slice_host(b, world), transfer_dtype)
            with torch.cuda.stream(copy_stream):
                dev = _put(local, world.device, transfer_dtype)
                done = torch.cuda.Event()
                done.record(copy_stream)
        return dev, done

    def ready(item):
        dev, done = item
        with span("afs.transfer"):
            compute = torch.cuda.current_stream(world.device)
            compute.wait_event(done)
            for t in _tensors(dev):  # the allocator must not reuse them early
                t.record_stream(compute)
        return dev

    try:
        nxt = put(next(it))
    except StopIteration:
        return
    for b in it:
        cur, nxt = nxt, put(b)
        yield ready(cur)
    yield ready(nxt)

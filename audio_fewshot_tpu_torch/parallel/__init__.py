"""Episode-axis data parallelism over several GPUs (counterpart of
``audio_fewshot_tpu/parallel``): one process a card, the batch's episode
axis (or a flat batch's rows) sharded over the ranks, parameters and
buffers broadcast from rank 0, gradients averaged in one flat all-reduce,
and BatchNorm moments and every other reduction over the episode axis
taken over all ranks, so that N ranks compute what one computes.
``launch`` starts the ranks of a run on one host."""

from .collectives import (World, all_reduce_gradients, all_reduce_mean, all_reduce_sum,
                          gather_rows, replicate, replicated_rows, rows_sharded, sharded_rows,
                          sharded_world)
from .mesh import (get_mesh, maybe_init_distributed, resolve_transfer_dtype, shard_batch,
                   transfer_ahead)

__all__ = [
    "World",
    "all_reduce_gradients",
    "all_reduce_mean",
    "all_reduce_sum",
    "gather_rows",
    "get_mesh",
    "maybe_init_distributed",
    "replicate",
    "replicated_rows",
    "resolve_transfer_dtype",
    "rows_sharded",
    "shard_batch",
    "sharded_rows",
    "sharded_world",
    "transfer_ahead",
]

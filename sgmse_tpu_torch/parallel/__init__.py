"""Data parallelism of the PyTorch port: the counterpart of ``sgmse_tpu/parallel/``.

The JAX package runs SPMD over a 1-D ``data`` mesh: the batch is sharded,
the parameters are replicated, and XLA inserts the gradient all-reduce. The
port does the same in PyTorch's idiom, one process per device:

- :mod:`.dist`: the process group (the JAX CLI's bootstrap flags, torchrun's
  and SLURM's environment), the rank helpers, the run-directory broadcast,
  the gradients' all-reduce and the validation metrics' one reduction;
- :mod:`.rows`: random draws of the global batch, of which each rank keeps
  its own rows, so that an N-rank step equals a one-process step on the
  global batch (JAX draws from one key for the global array);
- :mod:`.pool`: ``--data_parallel`` inference, one worker process per device,
  each with its own replica, the batch split by rows.
"""
from .dist import (broadcast_str, init_process_group, initialized, is_main, rank, reduce_sums,
                   world)
from .rows import global_rows

__all__ = ["broadcast_str", "global_rows", "init_process_group", "initialized", "is_main",
           "rank", "reduce_sums", "world"]

"""Batched multi-sequence runtime: N independent VIO sequences advanced in
lockstep through batched device programs (one program per stage per tick
drives all N streams). See rd_vio_tpu_torch.batch.runtime.BatchedVIO."""

from rd_vio_tpu_torch.batch.runtime import (  # noqa: F401
    BatchedVIO, run_sequences_lockstep, steady_window_start)

__all__ = ["BatchedVIO", "run_sequences_lockstep", "steady_window_start"]

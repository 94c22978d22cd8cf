"""Batch-sequence evaluation harness: several sequences through
independent Odometry instances, with their ATE and throughput aggregated.

Port of the JAX package's utils/batch_eval.py (a host module). Sequences
with the same capacities run the same programs; `parallel=True` overlaps
the host work of several sequences on threads.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from rd_vio_tpu_torch.utils.trajectory import ate_rmse


@dataclasses.dataclass
class SequenceResult:
    name: str
    n_frames: int
    n_tracked: int
    ate: Optional[float]
    wall_s: float
    fps: float


def run_sequence(name: str, make_odometry: Callable, events, gt_lookup=None):
    """events: iterable of ("imu", t, gyro, accel) | ("frame", t, image).
    gt_lookup: optional t -> ground-truth position, for the ATE."""
    odo = make_odometry()
    est_t, est_p = [], []
    n = 0
    t0 = time.perf_counter()
    for ev in events:
        if ev[0] == "imu":
            odo.add_motion(ev[1], ev[2], ev[3])
        else:
            odo.add_frame(ev[1], ev[2])
            n += 1
            if odo.state() == 1:
                ls = odo.handler.get_latest_state()
                if ls is not None:
                    est_t.append(ls[0])
                    est_p.append(ls[2])
    wall = time.perf_counter() - t0
    ate = None
    if gt_lookup is not None and len(est_p) > 10:
        gt = np.stack([gt_lookup(t) for t in est_t])
        ate = ate_rmse(np.asarray(est_p), gt)
    return SequenceResult(name=name, n_frames=n, n_tracked=len(est_p), ate=ate,
                          wall_s=wall, fps=n / max(wall, 1e-9))


def run_batch(jobs: List[tuple], parallel: bool = False,
              max_workers: int = 4) -> Dict[str, SequenceResult]:
    """jobs: list of (name, make_odometry, events, gt_lookup)."""
    results: Dict[str, SequenceResult] = {}
    if parallel and len(jobs) > 1:
        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            futs = {ex.submit(run_sequence, *j): j[0] for j in jobs}
            for fut in cf.as_completed(futs):
                r = fut.result()
                results[r.name] = r
    else:
        for j in jobs:
            r = run_sequence(*j)
            results[r.name] = r
    return results


def summarize(results: Dict[str, SequenceResult]) -> dict:
    ates = [r.ate for r in results.values() if r.ate is not None]
    return {
        "sequences": len(results),
        "total_frames": sum(r.n_frames for r in results.values()),
        "mean_fps": float(np.mean([r.fps for r in results.values()])),
        "mean_ate": float(np.mean(ates)) if ates else None,
        "max_ate": float(np.max(ates)) if ates else None,
    }

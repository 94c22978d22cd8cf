"""Checkpoint / resume of the full VIO estimator state.

The reference keeps everything in RAM with no persistence. Here the
sliding-window tracker state — window frames (poses/motion/keypoints/links),
landmark table, marginalization prior, PARSAC bin confidences, random state
— serializes to one .npz, enabling resume and golden-state regression tests.

Port of the JAX package's utils/checkpoint.py with its file layout key for
key, so that a file written by either package loads in the other: a JAX
tracker's checkpoint, loaded here, is that tracker's state in the port.

Random state. The JAX tracker draws its device-PARSAC noise from a JAX key
chain (`rng_key`); the port draws it from a `torch.Generator`
(`SlidingWindowTracker.gumbel_source`) and cannot continue a JAX key chain.
So the port writes its generator's state under keys of its own
(`torch_gumbel_state`, `torch_gumbel_device`), which the JAX loader ignores,
and carries a JAX file's `rng_key` through unchanged (`jax_rng_key` on the
restored tracker), writing it back on save; a port tracker that never saw a
JAX file writes the root of the chain a fresh JAX tracker starts from,
PRNGKey(config.random). The host seed counter of the NumPy PARSAC twins
(`host_seed_ctr`) is the same in both packages and restores exactly.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch

from rd_vio_tpu_torch.estimation import factors as F
from rd_vio_tpu_torch.models.map import Frame, Map, Track, TrackStore
from rd_vio_tpu_torch.utils.host import fetch, to_device

log = logging.getLogger(__name__)

_FRAME_ARRAYS = ("q", "p", "v", "bg", "ba", "bearings", "track_ids",
                 "imu_dt", "imu_w", "imu_a")


def jax_root_key(seed: int) -> np.ndarray:
    """The raw uint32 key jax.random.PRNGKey(seed) makes (threefry2x32):
    the high and the low 32 bits of the seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _frame_to_dict(f: Frame, prefix: str, out: dict):
    out[prefix + "id"] = np.int64(f.id)
    out[prefix + "t"] = np.float64(f.t)
    for attr in _FRAME_ARRAYS:
        out[prefix + attr] = np.asarray(getattr(f, attr))
    out[prefix + "flags"] = np.asarray(sorted(f.flags), dtype=object)


def _frame_from_dict(d: dict, prefix: str) -> Frame:
    f = Frame(float(d[prefix + "t"]))
    f.id = int(d[prefix + "id"])
    for attr in _FRAME_ARRAYS:
        if attr != "track_ids":
            setattr(f, attr, np.asarray(d[prefix + attr]))
    f.track_ids = np.asarray(d[prefix + "track_ids"], dtype=np.int64)
    f.flags = set(str(x) for x in d[prefix + "flags"])
    return f


def tracker_state(swt) -> dict:
    """The checkpoint's arrays by key (what save_tracker writes), after
    `swt.drain_pending()`: the applied, not the in-flight, states."""
    swt.drain_pending()
    out = {}
    m = swt.map
    frames = list(m.frames)
    out["n_frames"] = np.int64(len(frames))
    for i, f in enumerate(frames):
        _frame_to_dict(f, f"f{i}_", out)
        out[f"f{i}_nsub"] = np.int64(len(f.subframes))
        for j, sub in enumerate(f.subframes):
            _frame_to_dict(sub, f"f{i}_s{j}_", out)

    tracks = list(m.tracks.values())
    out["n_tracks"] = np.int64(len(tracks))
    track_meta = []
    for t in tracks:
        track_meta.append({
            "id": t.id,
            "obs": {str(k): int(v) for k, v in t.obs.items()},
            "inv_depth": float(t.inv_depth),
            "life": int(t.life),
            "flags": sorted(t.flags),
        })
    out["tracks_json"] = np.asarray(json.dumps(track_meta), dtype=object)
    # the track store's layout (port keys): each track's row and the free
    # rows in the order the next tracks take them, so that a restored map
    # gathers its tracks in the original's order; and each track's anchor
    # frame id, which after a marginalization may name a frame no longer in
    # its observations (the solves then leave the track out)
    st = m.store
    rows = np.asarray([t.row for t in tracks], np.int64)
    out["torch_store_cap"] = np.int64(st.cap)
    out["torch_store_free"] = np.asarray(st._free, np.int64)
    out["torch_track_rows"] = rows
    out["torch_track_first_fid"] = st.first_fid[rows]

    if swt.prior is not None:
        prior = fetch(swt.prior)
        for name, arr in zip(F.PriorFactor._fields, prior):
            out["prior_" + name] = np.asarray(arr)
    out["m_th"] = np.float64(swt.m_th)
    out["bin_conf_imu"] = np.asarray(fetch(swt.bin_conf_imu))
    out["bin_conf_2d2d"] = np.asarray(fetch(swt.bin_conf_2d2d))
    key = getattr(swt, "jax_rng_key", None)
    out["rng_key"] = np.asarray(key) if key is not None else jax_root_key(swt.config.random)
    out["host_seed_ctr"] = np.int64(swt._host_seed_ctr)
    if swt.gumbel_source is not None:
        gen = swt.gumbel_source.gen
        out["torch_gumbel_state"] = gen.get_state().numpy()
        out["torch_gumbel_device"] = np.asarray(gen.device.type)
    return out


def save_tracker(path: str, swt) -> None:
    """Serialize a SlidingWindowTracker (window + subframes + tracks + prior
    + PARSAC state) to `path` (.npz)."""
    out = tracker_state(swt)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **out)


def load_tracker(path: str, config, calib, caps, noise=None):
    """Reconstruct a SlidingWindowTracker from a checkpoint of either
    package, on calib.device. `noise` is SlidingWindowTracker's (the device
    PARSAC's Gumbel source); without it the tracker's own generator resumes
    from the file's `torch_gumbel_state` when the file has one from a
    generator on the same kind of device, and otherwise starts from
    config.random (a JAX file's key chain cannot be continued here)."""
    from rd_vio_tpu_torch.models.sliding_window_tracker import SlidingWindowTracker

    d = dict(np.load(path, allow_pickle=True))
    m = Map()
    n = int(d["n_frames"])
    for i in range(n):
        f = _frame_from_dict(d, f"f{i}_")
        nsub = int(d[f"f{i}_nsub"])
        for j in range(nsub):
            f.subframes.append(_frame_from_dict(d, f"f{i}_s{j}_"))
        m.attach_frame(f)

    rows = d.get("torch_track_rows")
    if rows is not None:
        m.store = TrackStore(int(d["torch_store_cap"]))
    for k, meta in enumerate(json.loads(str(d["tracks_json"]))):
        if rows is not None:
            m.store._free = [int(rows[k])]  # the row alloc() takes next
        t = Track(m.store, tid=int(meta["id"]))
        t.obs = {int(k): int(v) for k, v in meta["obs"].items()}
        if rows is not None:
            m.store.first_fid[t.row] = d["torch_track_first_fid"][k]
        else:
            # a JAX package's file: the anchor as obs gives it (the JAX
            # package's loader leaves it unset, and every solve reads it)
            t.refresh_first_fid()
        t.inv_depth = meta["inv_depth"]
        t.life = meta["life"]
        t.flags = set(meta["flags"])
        m.tracks[t.id] = t
    if rows is not None:
        m.store._free = [int(r) for r in d["torch_store_free"]]

    swt = SlidingWindowTracker(m, config, calib, caps, noise=noise)
    dev = calib.device
    if "prior_sqrt_inv_cov" in d:
        swt.prior = F.PriorFactor(
            **{name: to_device(d["prior_" + name], dev) for name in F.PriorFactor._fields}
        )
    swt.m_th = float(d["m_th"])
    for name in ("bin_conf_imu", "bin_conf_2d2d"):
        conf = np.asarray(d[name], np.float64)
        # the NumPy twins keep them on the host, the device PARSAC on the card
        setattr(swt, name, conf if config.parsac_host_masks else to_device(conf, dev))
    swt.jax_rng_key = np.asarray(d["rng_key"])
    swt._host_seed_ctr = int(d.get("host_seed_ctr", 0))
    if swt.gumbel_source is not None and "torch_gumbel_state" in d:
        gen = swt.gumbel_source.gen
        saved_on = str(d["torch_gumbel_device"])
        if saved_on == gen.device.type:
            gen.set_state(torch.from_numpy(np.asarray(d["torch_gumbel_state"])))
        else:
            log.warning("checkpoint %s: the Gumbel generator state is a %s "
                        "generator's; this tracker's (%s) starts from config.random",
                        path, saved_on, gen.device.type)
    return swt

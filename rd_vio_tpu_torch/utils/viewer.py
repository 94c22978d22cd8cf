"""Trajectory/map visualization — headless replacement for the reference's
viewer (reference examples/pviz.hpp).

The `Viewer` class mirrors pviz.hpp's full topic API — trajectory
(pviz.hpp:142-151), keyframes (:158-168), global point cloud (:171-180),
local point cloud (:183-188), extra image topics (:191-193) — and renders the
accumulated state to PNG/HTML files instead of a window (no display on a
headless host). Note the reference's own Viewer is a visualization-REMOVED
stub ("simplified version without visualization", pviz.hpp:112-121): its
keyframe/point-cloud/image methods are empty compatibility no-ops and
publish_trajectory prints positions to stdout. This implementation keeps the
same API surface but gives every topic real (headless-rendered) behavior.

Uses matplotlib when available, else writes a standalone HTML canvas plot.
Port of the JAX package's utils/viewer.py (NumPy only).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


class Viewer:
    """Headless topic-accumulating viewer with the pviz.hpp API."""

    def __init__(self, title: str = "rd_vio_tpu_torch", out_dir: str = "viz"):
        self.title = title
        self.out_dir = out_dir
        self.trajectory: List[np.ndarray] = []  # camera positions (Twc)
        self.keyframes: Dict[int, np.ndarray] = {}  # id -> 4x4 Twc
        self.global_points: Dict[int, np.ndarray] = {}  # id -> (3,)
        self.local_points: np.ndarray = np.zeros((0, 3))
        self._topic_counter: Dict[str, int] = {}

    # -- trajectory (pviz.hpp:142-151) --
    def publish_trajectory(self, T_or_R, t=None):
        if t is None:
            T = np.asarray(T_or_R)
            self.trajectory.append(T[:3, 3].copy())
        else:
            self.trajectory.append(np.asarray(t, float).copy())

    # -- keyframes (pviz.hpp:158-168) --
    def publish_keyframe(self, kf_id: int, Twc: np.ndarray):
        self.keyframes[int(kf_id)] = np.asarray(Twc, float).copy()

    def remove_keyframe(self, kf_id: int):
        self.keyframes.pop(int(kf_id), None)

    def remove_keyframes(self):
        self.keyframes.clear()

    # -- global map (pviz.hpp:171-180) --
    def publish_global_point_cloud(self, pt_id: int, point):
        self.global_points[int(pt_id)] = np.asarray(point, float).copy()

    def remove_global_point_cloud(self, pt_id: int):
        self.global_points.pop(int(pt_id), None)

    def remove_global_point_clouds(self):
        self.global_points.clear()

    # -- local map (pviz.hpp:183-188) --
    def publish_local_point_cloud(self, points, copy: bool = False):
        pts = np.asarray(points, float).reshape(-1, 3)
        self.local_points = pts.copy() if copy else pts

    def remove_local_point_cloud(self):
        self.local_points = np.zeros((0, 3))

    # -- extra image topics (pviz.hpp:191-193) --
    def publish_topic(self, topic: str, img: np.ndarray):
        """Save an image topic frame under out_dir/<topic>/NNNN.png."""
        os.makedirs(os.path.join(self.out_dir, topic), exist_ok=True)
        n = self._topic_counter.get(topic, 0)
        self._topic_counter[topic] = n + 1
        path = os.path.join(self.out_dir, topic, f"{n:05d}.png")
        arr = np.asarray(img)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.imsave(path, arr, cmap="gray" if arr.ndim == 2 else None)
        except Exception:
            np.save(os.path.splitext(path)[0] + ".npy", arr)
        return path

    # -- rendering --
    def render(self, path: str):
        """Render trajectory + keyframe poses + local/global clouds to one
        top-down plot (PNG, or HTML canvas fallback)."""
        est = (np.stack(self.trajectory)
               if self.trajectory else np.zeros((0, 3)))
        gmap = (np.stack(list(self.global_points.values()))
                if self.global_points else None)
        lmap = self.local_points if len(self.local_points) else None
        kfs = list(self.keyframes.values())
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 8))
            if gmap is not None:
                ax.scatter(gmap[:, 0], gmap[:, 1], s=2, c="#646464",
                           alpha=0.5, label="global map")
            if lmap is not None:
                ax.scatter(lmap[:, 0], lmap[:, 1], s=3, c="#1da81d",
                           alpha=0.8, label="local map")
            if len(est):
                ax.plot(est[:, 0], est[:, 1], "-", c="#0000ff", lw=1.5,
                        label="trajectory")
            for T in kfs:
                # keyframe pose: position + viewing-direction whisker
                # (pviz axes_size=0.12, kf color red)
                p = T[:3, 3]
                d = T[:3, :3] @ np.array([0.0, 0.0, 0.12])
                ax.plot([p[0], p[0] + d[0]], [p[1], p[1] + d[1]],
                        "-", c="#ff0000", lw=1.0)
                ax.plot([p[0]], [p[1]], ".", c="#ff0000", ms=4)
            ax.set_aspect("equal")
            ax.set_xlabel("x [m]")
            ax.set_ylabel("y [m]")
            ax.set_title(self.title)
            if len(est) or kfs or gmap is not None or lmap is not None:
                ax.legend(loc="best", fontsize=8)
            fig.tight_layout()
            fig.savefig(path, dpi=120)
            plt.close(fig)
            return path
        except Exception:
            return save_trajectory_plot(path, est, None, lmap, self.title)


def save_trajectory_plot(
    path: str,
    est_p: np.ndarray,
    gt_p: Optional[np.ndarray] = None,
    landmarks: Optional[np.ndarray] = None,
    title: str = "rd_vio_tpu_torch trajectory",
):
    """Top-down (x, y) trajectory + landmark plot to a PNG (or .html fallback)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        if landmarks is not None and len(landmarks):
            ax.scatter(landmarks[:, 0], landmarks[:, 1], s=2, c="#999999",
                       alpha=0.5, label="landmarks")
        if gt_p is not None and len(gt_p):
            ax.plot(gt_p[:, 0], gt_p[:, 1], "-", c="#2a7ab0", lw=1.5,
                    label="ground truth")
        ax.plot(est_p[:, 0], est_p[:, 1], "-", c="#d0543c", lw=1.5,
                label="estimate")
        ax.set_aspect("equal")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_title(title)
        ax.legend(loc="best", fontsize=8)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    except Exception:
        html_path = os.path.splitext(path)[0] + ".html"
        data = {
            "est": est_p.tolist(),
            "gt": gt_p.tolist() if gt_p is not None else None,
            "landmarks": landmarks.tolist() if landmarks is not None else None,
        }
        with open(html_path, "w") as f:
            f.write(
                "<html><body><canvas id=c width=800 height=800></canvas>"
                "<script>const D=" + json.dumps(data) + ";"
                """
const ctx=document.getElementById('c').getContext('2d');
const all=D.est.concat(D.gt||[]).concat(D.landmarks||[]);
let xs=all.map(p=>p[0]),ys=all.map(p=>p[1]);
const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
const s=780/Math.max(x1-x0,y1-y0,1e-6);
const X=p=>10+(p[0]-x0)*s, Y=p=>790-(p[1]-y0)*s;
function line(pts,color){ctx.strokeStyle=color;ctx.beginPath();
pts.forEach((p,i)=>i?ctx.lineTo(X(p),Y(p)):ctx.moveTo(X(p),Y(p)));ctx.stroke();}
if(D.landmarks){ctx.fillStyle='#999';D.landmarks.forEach(p=>ctx.fillRect(X(p),Y(p),2,2));}
if(D.gt)line(D.gt,'#2a7ab0');
line(D.est,'#d0543c');
</script></body></html>"""
            )
        return html_path

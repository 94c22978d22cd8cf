"""Port parity of the dataset layer: the camera model, image undistortion,
the EuRoC and ADVIO readers, the MJPEG .mov demuxer and muxer, the native
EuRoC loader, the pose streamers and the viewer.

The same seeded NumPy inputs go through the JAX package's function and the
port's counterpart (rd_vio_tpu_torch, on the CPU), in the module's spawned
child (`child`, tests/test_torch_image.py), with the tolerance stated beside
each comparison. Layouts are written to temporary directories.
"""

import contextlib
import os
import socket
import sys
import tempfile
from pathlib import Path

import numpy as np

from tests.test_torch_image import IN_CHILD, child  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import jax.numpy as jnp
    import torch

    from rd_vio_tpu.config import Config as ConfigJ
    from rd_vio_tpu.config import load_config as load_j
    from rd_vio_tpu.datasets import advio as advio_j
    from rd_vio_tpu.datasets import euroc as euroc_j
    from rd_vio_tpu.datasets import video as video_j
    from rd_vio_tpu.ops import camera as cam_j
    from rd_vio_tpu.ops.image import undistort as und_j
    from rd_vio_tpu.utils import pose_stream as ps_j
    from rd_vio_tpu.utils import viewer as viewer_j
    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch import native as nat_t
    from rd_vio_tpu_torch.config import load_config as load_t
    from rd_vio_tpu_torch.datasets import advio as advio_t
    from rd_vio_tpu_torch.datasets import euroc as euroc_t
    from rd_vio_tpu_torch.datasets import video as video_t
    from rd_vio_tpu_torch.ops import camera as cam_t
    from rd_vio_tpu_torch.ops.image import undistort as und_t
    from rd_vio_tpu_torch.utils import pose_stream as ps_t
    from rd_vio_tpu_torch.utils import viewer as viewer_t

REPO = Path(__file__).resolve().parents[1]
K = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]])
RADTAN = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])  # EuRoC cam0
EQUIDISTANT = np.array([-0.0036, 0.0114, -0.0133, 0.0049])


# -- camera and undistortion ----------------------------------------------


def _check_camera():
    """Every function of ops/camera in f64, each within 1e-12 (absolute, of
    values up to ~1e3 px: 2^-40 relative) of the JAX package's."""
    rng = np.random.default_rng(21)
    pix = rng.uniform([0, 0], [752, 480], (200, 2))
    norm = rng.uniform(-0.8, 0.8, (200, 2))
    xc = np.concatenate([rng.uniform(-2, 2, (200, 2)), rng.uniform(0.5, 8, (200, 1))], -1)
    T = torch.from_numpy
    pairs = [
        (cam_j.apply_k(jnp.asarray(norm), jnp.asarray(K)), cam_t.apply_k(T(norm), K)),
        (cam_j.remove_k(jnp.asarray(pix), jnp.asarray(K)), cam_t.remove_k(T(pix), T(K))),
        (cam_j.project(jnp.asarray(xc)), cam_t.project(T(xc))),
        (cam_j.dproj_dp(jnp.asarray(xc)), cam_t.dproj_dp(T(xc))),
        (cam_j.bearing_from_normalized(jnp.asarray(norm)), cam_t.bearing_from_normalized(T(norm))),
        (cam_j.bearing_from_pixel(jnp.asarray(pix), jnp.asarray(K)),
         cam_t.bearing_from_pixel(T(pix), K)),
    ]
    for model, dist in (("radtan", RADTAN), ("equidistant", EQUIDISTANT)):
        fj = cam_j.distort_radtan if model == "radtan" else cam_j.distort_equidistant
        ft = cam_t.distort_radtan if model == "radtan" else cam_t.distort_equidistant
        pairs += [
            (fj(jnp.asarray(norm), jnp.asarray(dist)), ft(T(norm), dist)),
            (cam_j.undistort(jnp.asarray(norm), jnp.asarray(dist), model),
             cam_t.undistort(T(norm), T(dist), model)),
            (cam_j.undistort_points_pixel(jnp.asarray(pix), jnp.asarray(K),
                                          jnp.asarray(dist), model),
             cam_t.undistort_points_pixel(T(pix), K, dist, model)),
        ]
    for k, (a, b) in enumerate(pairs):
        assert b.dtype == torch.float64, k
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, k
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=str(k))
    # the caller's dtype: f32 in, f32 out
    assert cam_t.undistort_points_pixel(T(pix).float(), K, RADTAN).dtype == torch.float32


def _check_remap():
    """build_remap: both maps within 1e-6 px of the JAX package's (f64 on
    the host, then f32). remap_bilinear on random f32 images: equal bit for
    bit (the JAX package's blend, fused multiply-adds included)."""
    rng = np.random.default_rng(22)
    for model, dist, (W, H) in (("radtan", RADTAN, (752, 480)),
                                ("equidistant", EQUIDISTANT, (320, 240))):
        Km = K * [[W / 752, 1, W / 752], [1, H / 480, H / 480], [1, 1, 1]]
        mj = und_j.build_remap(Km, dist, model, W, H)
        mt = und_t.build_remap(Km, dist, model, W, H)
        for a, b in zip(mj, mt):
            assert b.dtype == np.float32 and b.shape == (H, W)
            assert np.abs(a - b).max() <= 1e-6
        for img in (rng.uniform(0, 255, (H, W)).astype(np.float32),
                    rng.integers(0, 256, (H, W)).astype(np.float32)):
            a = np.asarray(und_j.remap_bilinear(img, *mj))
            b = und_t.remap_bilinear(*(torch.from_numpy(x) for x in (img, *mt))).numpy()
            np.testing.assert_array_equal(b, a)
            assert (b == 0).mean() < 0.05  # the barrel map samples inside the frame


def test_camera_and_undistortion_match_jax(child):
    child(_check_camera)
    child(_check_remap)


# -- readers ----------------------------------------------------------------


def _tiny_sequence(n_frames=6, size=(64, 48), seed=3):
    """A short seeded sequence: IMU at 200 Hz and pinhole frames at 20 Hz."""
    from rd_vio_tpu_torch.datasets import synthetic

    seq = synthetic.generate(duration=n_frames / 20.0, n_landmarks=300,
                             max_keypoints=50, seed=seed)
    rng = np.random.default_rng(seed)
    frames = [rng.uniform(0, 255, size[::-1]) for _ in range(n_frames)]
    return seq, frames


def _events_j(ds):
    return [(e.t, e.kind, None if e.gyro is None else tuple(e.gyro),
             None if e.accel is None else tuple(e.accel),
             e.image_path) for e in ds.events()]


def _check_euroc_reader():
    """EurocDataset on a written layout: IMU, frame times and files, ground
    truth and events() equal exactly; load_image with the undistorter of
    the layout's sensor.yaml (remap on the CPU) equal bit for bit."""
    from scripts.euroc_layout import write_layout

    seq, frames = _tiny_sequence()
    Kt = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]])
    dist = (-0.05, 0.01, 0.001, -0.0005)
    with tempfile.TemporaryDirectory() as tmp:
        mav0, sensor_yaml, setting_yaml = write_layout(
            tmp, seq, frames, Kt, dist,
            lambda p: cam_t.undistort_points_pixel(torch.from_numpy(p), Kt, dist).numpy())
        cj, ct = load_j(sensor_yaml, setting_yaml), load_t(sensor_yaml, setting_yaml)
        assert ct.camera_distortion_flag == cj.camera_distortion_flag == 1
        np.testing.assert_array_equal(ct.camera_distortion, cj.camera_distortion)
        dj = euroc_j.EurocDataset(mav0, undistort=euroc_j.make_undistorter(cj))
        dt = euroc_t.EurocDataset(mav0, undistort=euroc_t.make_undistorter(ct, "cpu"))
        assert dt.undistort.map_y.device.type == "cpu"
        for key in ("t", "gyro", "accel"):
            np.testing.assert_array_equal(dt.imu[key], dj.imu[key])
        np.testing.assert_array_equal(dt.frames["t"], dj.frames["t"])
        assert dt.frames["files"] == dj.frames["files"] and len(dt.frames["files"]) == 6
        for key in ("t", "p", "q"):
            np.testing.assert_array_equal(dt.ground_truth[key], dj.ground_truth[key])
        ev = _events_j(dt)
        assert ev == _events_j(dj)
        assert [k for _, k, *_ in ev].count("frame") == 6
        # IMU before a frame of the same time
        ts = [(t, k) for t, k, *_ in ev]
        assert ts == sorted(ts, key=lambda x: (x[0], x[1] != "imu"))
        for path in dt.frames["files"][:3]:
            a, b = dj.load_image(path), dt.load_image(path)
            assert b.dtype == np.float32 and b.shape == (48, 64)
            np.testing.assert_array_equal(b, a)
        assert euroc_t.make_undistorter(convert.config_from(ConfigJ())) is None


def _write_advio(root, seq, frames, mov: bool):
    iphone = Path(root) / "advio-01" / "iphone"
    iphone.mkdir(parents=True)
    if mov:
        video_t.write_mjpeg_mov(str(iphone / "frames.mov"), frames, fps=20.0, quality=95)
    else:
        from PIL import Image

        (iphone / "frames").mkdir()
        for i, fr in enumerate(frames):
            Image.fromarray(np.clip(fr, 0, 255).astype(np.uint8), mode="L").save(
                iphone / "frames" / f"{i:06d}.png")
    with open(iphone / "frames.csv", "w") as f:
        for i, t in enumerate(seq.t_frame[:len(frames)]):
            f.write(f"{t:.6f},{i:06d}.png\n" if not mov else f"{t:.6f},{i}\n")
    for name, arr in (("gyro.csv", seq.gyro), ("accelerometer.csv", seq.accel)):
        with open(iphone / name, "w") as f:
            for i, t in enumerate(seq.t_imu):
                # the phone's two streams are not sampled together
                tt = t if name == "gyro.csv" else t + 0.0013
                f.write(f"{tt:.6f}," + ",".join(f"{v:.9f}" for v in arr[i]) + "\n")


def _check_advio_reader():
    """AdvioDataset: the tables, seq_group, gyro / accel / frame times and
    events() equal exactly, from frames.mov and from an extracted frames/
    directory; load_image (flip, then the group's remap at 720x1280 on the
    CPU) equal bit for bit; the two IMU streams interleaved by each
    package's Handler into the same frame intervals."""
    assert advio_t.SEQ_INTRINSICS == advio_j.SEQ_INTRINSICS
    assert advio_t.SEQ_DISTORTIONS == advio_j.SEQ_DISTORTIONS
    assert advio_t.RESOLUTION == advio_j.RESOLUTION
    for s in range(1, 24):
        assert advio_t.seq_group(s) == advio_j.seq_group(s)
    for bad in (0, 24):
        for fn in (advio_t.seq_group, advio_j.seq_group):
            try:
                fn(bad)
            except ValueError:
                pass
            else:
                raise AssertionError(f"seq_group({bad})")
    seq, small = _tiny_sequence(n_frames=4)
    rng = np.random.default_rng(9)
    full = [rng.integers(0, 256, (1280, 720)).astype(np.float32) for _ in range(2)]
    for mov, frames, und in ((True, small, False), (False, full, True)):
        with tempfile.TemporaryDirectory() as tmp:
            _write_advio(tmp, seq, frames, mov)
            dj = advio_j.AdvioDataset(tmp, seq_id=1, undistort=und)
            dt = advio_t.AdvioDataset(tmp, seq_id=1, undistort=und, device="cpu")
            assert (dt._mov is not None) == (dj._mov is not None) == mov
            for key in ("gyro", "accel"):
                for f in ("t", "v"):
                    np.testing.assert_array_equal(getattr(dt, key)[f], getattr(dj, key)[f])
            np.testing.assert_array_equal(dt.frames["t"], dj.frames["t"])
            assert dt.frames["files"] == dj.frames["files"]
            ev = list(dt.events())
            assert ev == list(dj.events()) and len(ev) > 2 * len(seq.t_imu)
            assert ev == sorted(ev, key=lambda x: (x[0], x[1]))
            for i in range(len(frames)):
                a, b = dj.load_image(i), dt.load_image(i)
                assert b.flags["C_CONTIGUOUS"] and b.dtype == np.float32
                np.testing.assert_array_equal(b, a)
            if und:
                assert b.shape == (1280, 720) and dt._undistort.map_y.device.type == "cpu"
            else:
                _check_gyro_accel_split(dj, dt)


class _FrameSink:
    """Stands where the feature tracker sits: keeps each dispatched frame's
    IMU interval."""

    def __init__(self):
        self.frames = []

    def track_frame(self, frame):
        self.frames.append((frame.t, frame.imu_dt, frame.imu_w, frame.imu_a))


def _check_gyro_accel_split(dj, dt):
    """ADVIO's separate gyro and accel streams through each package's
    Handler (track_gyroscope / track_accelerometer interleave them into
    fused samples, frames are dispatched as IMU covers them): the same
    frames with the same IMU intervals, exactly."""
    from rd_vio_tpu.models.handler import Handler as HandlerJ
    from rd_vio_tpu_torch.models.handler import Handler as HandlerT

    out = []
    for ds, handler_cls in ((dj, HandlerJ), (dt, HandlerT)):
        sink = _FrameSink()
        handler = handler_cls(None, sink, None)
        for t, kind, i in ds.events():
            if kind == "gyro":
                handler.track_gyroscope(t, ds.gyro["v"][i])
            elif kind == "accel":
                handler.track_accelerometer(t, ds.accel["v"][i])
            else:
                handler.track_camera(t, i)
        out.append(sink.frames)
    assert len(out[1]) == len(out[0]) >= len(dt.frames["t"]) - 1
    for fj, ft in zip(*out):
        assert ft[0] == fj[0]
        for a, b in zip(fj[1:], ft[1:]):
            np.testing.assert_array_equal(b, a)


def test_readers_match_jax(child):
    child(_check_euroc_reader)
    child(_check_advio_reader)


# -- video ------------------------------------------------------------------


def _check_mov():
    """write_mjpeg_mov: the port's file equals the JAX package's byte for
    byte; MovReader: codec, size, timestamps, samples and decoded frames
    equal across the packages on both files; a non-MJPEG track raises with
    the extraction hint in both."""
    rng = np.random.default_rng(23)
    frames = [np.clip(rng.normal(128, 40, (48, 64)), 0, 255).astype(np.uint8)
              for _ in range(5)] + [rng.uniform(0, 300, (48, 64))]
    with tempfile.TemporaryDirectory() as tmp:
        pj, pt = os.path.join(tmp, "j.mov"), os.path.join(tmp, "t.mov")
        assert video_j.write_mjpeg_mov(pj, frames, fps=30.0, quality=90) == \
            video_t.write_mjpeg_mov(pt, frames, fps=30.0, quality=90)
        assert Path(pj).read_bytes() == Path(pt).read_bytes()
        for path in (pj, pt):
            rj, rt = video_j.MovReader(path), video_t.MovReader(path)
            assert (rt.codec, rt.width, rt.height, len(rt)) == \
                (rj.codec, rj.width, rj.height, len(rj)) == (b"jpeg", 64, 48, 6)
            np.testing.assert_array_equal(rt.timestamps, rj.timestamps)
            for i in range(len(rt)):
                assert rt.sample(i) == rj.sample(i)
                np.testing.assert_array_equal(rt.decode(i), rj.decode(i))
        data = bytearray(Path(pt).read_bytes())
        i = data.rindex(b"jpeg")
        data[i:i + 4] = b"avc1"
        Path(pt).write_bytes(bytes(data))
        for mod in (video_j, video_t):
            try:
                mod.MovReader(pt).decode(0)
            except NotImplementedError as e:
                assert "ffmpeg" in str(e)
            else:
                raise AssertionError("an H.264 track decoded")


def test_video_matches_jax(child):
    child(_check_mov)


# -- the native EuRoC loader -------------------------------------------------


def _check_native_loader():
    """The port's NativeEurocDataset (libpng, its own library) against the
    JAX package's Python EurocDataset (PIL): IMU rows, frame times and
    images equal exactly; the calls are counted; the loader's source is the
    JAX package's, code for code."""
    from scripts.euroc_layout import write_layout

    a = (REPO / "rd_vio_tpu" / "native" / "euroc_loader.cpp").read_text().splitlines()
    b = (REPO / "rd_vio_tpu_torch" / "native" / "euroc_loader.cpp").read_text().splitlines()
    diff = [(x, y) for x, y in zip(a, b) if x != y]
    assert len(a) == len(b) and len(diff) <= 1
    assert all(x.startswith("//") and y.startswith("//") for x, y in diff)
    assert nat_t.euroc_available()
    so = nat_t.euroc_library_path()
    assert so.exists() and so != nat_t.library_path() and so.parent == nat_t.BUILD_DIR
    seq, frames = _tiny_sequence(n_frames=12, size=(80, 60))
    with tempfile.TemporaryDirectory() as tmp:
        mav0, _, _ = write_layout(tmp, seq, frames, np.eye(3))
        dj = euroc_j.EurocDataset(mav0)
        nat_t.CALLS.clear()
        dn = nat_t.NativeEurocDataset(mav0)
        try:
            np.testing.assert_array_equal(dn.imu_t, dj.imu["t"])
            np.testing.assert_array_equal(dn.gyro, dj.imu["gyro"])
            np.testing.assert_array_equal(dn.accel, dj.imu["accel"])
            np.testing.assert_array_equal(dn.frame_t, dj.frames["t"])
            assert (dn.width, dn.height) == (80, 60)
            for i in (0, 5, 11, 1):  # out of order: the prefetch cache serves some
                img = dn.load_image(i)
                assert img.dtype == np.float32
                np.testing.assert_array_equal(img, dj.load_image(dj.frames["files"][i]))
        finally:
            dn.close()
        assert nat_t.CALLS["euroc_open"] == 1 and nat_t.CALLS["euroc_load_image"] == 4
        try:
            nat_t.NativeEurocDataset(os.path.join(tmp, "missing"))
        except IOError:
            pass
        else:
            raise AssertionError("opened a missing directory")


def test_native_euroc_loader_matches_jax(child):
    child(_check_native_loader)


# -- pose streaming and the viewer ------------------------------------------


def _received(sock, n):
    out = []
    for _ in range(n):
        out.append(sock.recvfrom(4096)[0])
    return out


def _stream_packets(mod):
    """The datagrams a SlimeVrClient and a JsonPosePublisher of `mod` send
    to a loopback socket."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    port = rx.getsockname()[1]
    try:
        cl = mod.SlimeVrClient("127.0.0.1", port)
        cl.handshake(firmware="parity")
        cl.send_rotation([0.9, 0.1, -0.2, 0.3])  # also the first heartbeat
        cl.send_rotation(np.array([1.0, 0.0, 0.0, 0.0]))
        cl.close()
        pub = mod.JsonPosePublisher("127.0.0.1", port)
        pub.publish(1.25, np.array([1.0, 0.0, 0.0, 0.0]), [0.5, -1.0, 2.0])
        pub.close()
        return _received(rx, 5)
    finally:
        rx.close()


@contextlib.contextmanager
def _no_matplotlib():
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] == "matplotlib"}
    for k in saved:
        del sys.modules[k]
    sys.modules["matplotlib"] = None
    try:
        yield
    finally:
        del sys.modules["matplotlib"]
        sys.modules.update(saved)


def _viewer_outputs(mod, out_dir):
    rng = np.random.default_rng(24)
    v = mod.Viewer(title="parity", out_dir=out_dir)
    T = np.eye(4)
    for k in range(5):
        T[:3, 3] = [0.1 * k, 0.05 * k * k, 0.0]
        v.publish_trajectory(T)
        v.publish_keyframe(k, T)
    v.publish_trajectory(np.eye(3), [0.6, 1.0, 0.0])
    v.remove_keyframe(0)
    for k in range(30):
        v.publish_global_point_cloud(k, rng.normal(size=3))
    v.remove_global_point_cloud(3)
    v.publish_local_point_cloud(rng.normal(size=(10, 3)))
    topic = v.publish_topic("frames", rng.uniform(0, 255, (24, 32)))
    state = (np.stack(v.trajectory), sorted(v.keyframes), len(v.global_points),
             v.local_points.shape)
    files = {"png": v.render(os.path.join(out_dir, "map.png")), "topic": topic,
             "plot": mod.save_trajectory_plot(os.path.join(out_dir, "traj.png"),
                                              state[0], state[0] + 0.01,
                                              rng.normal(size=(20, 3)), title="parity")}
    with _no_matplotlib():
        files["html"] = mod.save_trajectory_plot(os.path.join(out_dir, "fallback.png"),
                                                 state[0], None, None, title="parity")
    return state, {k: os.path.relpath(p, out_dir) for k, p in files.items()}


def _check_pose_stream_and_viewer():
    """SlimeVrClient / JsonPosePublisher: the same datagrams as the JAX
    package's, received on loopback. Viewer and save_trajectory_plot: the
    same accumulated state, the same file names and the same bytes in each
    file (matplotlib's PNGs and the HTML fallback)."""
    assert _stream_packets(ps_t) == _stream_packets(ps_j)
    with tempfile.TemporaryDirectory() as tj, tempfile.TemporaryDirectory() as tt:
        sj, fj = _viewer_outputs(viewer_j, tj)
        st, ft = _viewer_outputs(viewer_t, tt)
        np.testing.assert_array_equal(st[0], sj[0])
        assert st[1:] == sj[1:] and ft == fj
        assert fj["html"].endswith(".html")
        for k in ("html", "png", "topic", "plot"):
            assert Path(tt, ft[k]).read_bytes() == Path(tj, fj[k]).read_bytes(), k


def test_pose_stream_and_viewer_match_jax(child):
    child(_check_pose_stream_and_viewer)

"""Image-frontend ops (f32): CLAHE, pyramid, GFTT detection, pyramidal LK
(with the hand-written CUDA kernels behind ops/image/klt.lk_track_fwd_rev
and klt.lk_level)."""

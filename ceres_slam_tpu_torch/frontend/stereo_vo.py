"""Online stereo visual odometry from raw images.

Port of ``ceres_slam_tpu/frontend/stereo_vo.py`` (the reference's live ROS
node pipeline, ``sparse_stereo_odometry_node.cpp``). Per stereo pair:

  detect corners in both images        Harris + patch descriptors
  stereo match with the cross check    the similarity product, gated by the
    and the epipolar-row and positive    epipolar row and positive disparity
    disparity filters
  temporal match against the previous  the same matcher
    left image
  triangulate both sets, RANSAC        batched 3-point RANSAC on JAX's own
                                         threefry draw (the key split per
                                         frame, ``ops/prng.py``)
  refine the pose on the inliers       Gauss-Newton on 6 dof
  compound onto the map pose           ``T_curr_map = T_curr_prev T_prev_map``,
                                         in float64

A frame is a pure function of fixed buffers, as JAX jits it
(``extract_stereo_frame``, ``refine_pose_gn``'s ``fori_loop``,
``ransac_align``): ``frame_body`` reads the images and the tracker's
``TrackState`` (the previous frame's uvd, descriptors and validity, the
PRNG key, ``T_curr_map`` and the frame's counts) and writes the state in
place; the refinement's 10 iterations unroll. On the card a frame is one
replay (``FrameGraph``: the body captured per image shape), split in two
graphs around the one call that checks its result on the host,
``torch.linalg.svd`` of RANSAC's cross-covariances, which runs eagerly
between them (``frame_steps``). The first frame has no predecessor: it
only extracts features (``first_frame``), eagerly in both forms.
``OnlineStereoVO(frame_loop=...)`` picks the form; both give the same
bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.frontend import alignment, features
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import graph_loop, lie, prng
from ceres_slam_tpu_torch.utils import device as device_mod


class StereoFrame(NamedTuple):
    """One frame's stereo features: uvd observations and left descriptors."""

    uvd: torch.Tensor  # [N, 3]
    desc: torch.Tensor  # [N, D] left-image descriptors
    valid: torch.Tensor  # [N] bool
    corners: torch.Tensor | None = None  # [] the left image's valid corners


def extract_stereo_frame(camera: StereoCamera, img_left: torch.Tensor, img_right: torch.Tensor,
                         max_corners: int = 384, patch_radius: int = 4,
                         epipolar_tol: float = 1.5, min_disparity: float = 0.25) -> StereoFrame:
    """Detect corners in a rectified pair and match them into uvd
    observations; the epipolar-row and positive-disparity filters gate the
    matcher."""
    uv_l, _, val_l = features.harris_corners(img_left, max_corners=max_corners)
    uv_r, _, val_r = features.harris_corners(img_right, max_corners=max_corners)
    d_l = features.patch_descriptors(img_left, uv_l, patch_radius)
    d_r = features.patch_descriptors(img_right, uv_r, patch_radius)
    gate = ((torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1]) <= epipolar_tol)
            & (uv_l[:, None, 0] - uv_r[None, :, 0] > min_disparity))
    idx_r, ok = features.match_descriptors(d_l, d_r, val_l, val_r, gate=gate)
    disparity = uv_l[:, 0] - uv_r[idx_r, 0]
    uvd = torch.stack([uv_l[:, 0], uv_l[:, 1], torch.clamp(disparity, min=1e-3)], dim=-1)
    return StereoFrame(uvd=uvd, desc=d_l, valid=ok, corners=val_l.sum())


def refine_pose_gn(camera: StereoCamera, T0: torch.Tensor, pts_prev: torch.Tensor,
                   obs_curr: torch.Tensor, weights: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Pose-only Gauss-Newton refinement of the frame-to-frame transform
    ``T0 [12]`` against ``obs_curr [N, 3]`` of ``pts_prev [N, 3]`` (the
    landmarks held at their previous-frame triangulation), rows weighted by
    ``weights [N]``; a step that is not finite is skipped."""
    T = T0
    keep = weights != 0
    eye = 1e-8 * torch.eye(6, dtype=T0.dtype, device=T0.device)
    for _ in range(iters):
        p_c, J_pose, _ = lie.point_transform_jacobians(T.expand(pts_prev.shape[0], 12), pts_prev)
        r = torch.where(keep[:, None], (camera.project(p_c) - obs_curr) * weights[:, None], 0.0)
        J = torch.where(keep[:, None, None],
                        (camera.projection_jacobian(p_c) @ J_pose) * weights[:, None, None], 0.0)
        H = torch.einsum("nri,nrj->ij", J, J) + eye
        g = torch.einsum("nri,nr->i", J, r)
        dx, info = torch.linalg.solve_ex(H, -g)
        dx = torch.where(torch.all(torch.isfinite(dx)) & (info == 0), dx, 0.0)
        T = lie.se3_retract(T, dx)
    return T


class TrackSettings(NamedTuple):
    """The tracker's settings (Python values a captured frame holds)."""

    max_corners: int = 384
    ransac_iters: int = 400
    ransac_thresh: float = 4.0


class TrackState(NamedTuple):
    """What a frame reads and writes between frames, in fixed buffers: the
    previous frame's features, the PRNG key, the pose and this frame's
    counts (the left image's valid corners, the stereo matches, the
    temporal matches)."""

    prev_uvd: torch.Tensor  # [N, 3]
    prev_desc: torch.Tensor  # [N, D]
    prev_valid: torch.Tensor  # [N] bool
    key: torch.Tensor  # [2] int64
    T_curr_map: torch.Tensor  # [12] float64
    counts: torch.Tensor  # [3] int64


def track_state(max_corners: int, seed: int, device, patch_radius: int = 4) -> TrackState:
    """The state before the first frame: no features, the key of ``seed``,
    the identity pose."""
    f64 = dict(dtype=torch.float64, device=device)
    return TrackState(torch.zeros((max_corners, 3), **f64),
                      torch.zeros((max_corners, (2 * patch_radius) ** 2), **f64),
                      torch.zeros(max_corners, dtype=torch.bool, device=device),
                      prng.prng_key(torch.tensor(seed)).to(device),
                      lie.se3_identity(**f64).clone(),
                      torch.zeros(3, dtype=torch.int64, device=device))


def _keep(st: TrackState, frame: StereoFrame, n_temporal: torch.Tensor) -> None:
    """End a frame: its counts, and its features as the next frame's
    previous ones."""
    st.counts.copy_(torch.stack([frame.corners, frame.valid.sum(), n_temporal]))
    st.prev_uvd.copy_(frame.uvd)
    st.prev_desc.copy_(frame.desc)
    st.prev_valid.copy_(frame.valid)


def first_frame(camera: StereoCamera, settings: TrackSettings, st: TrackState,
                images: torch.Tensor) -> None:
    """The first frame (``images [2, H, W]``, left and right): features only."""
    frame = extract_stereo_frame(camera, images[0], images[1], max_corners=settings.max_corners)
    _keep(st, frame, torch.zeros((), dtype=torch.int64, device=images.device))


class FrameMid(NamedTuple):
    """What a frame carries across its SVD: this frame's features, the
    temporal matches, both point sets and RANSAC's moments (``W`` is what
    the SVD decomposes)."""

    frame: StereoFrame
    idx: torch.Tensor
    ok: torch.Tensor
    pts_prev: torch.Tensor
    pts_curr: torch.Tensor
    c0: torch.Tensor
    c1: torch.Tensor
    W: torch.Tensor  # [H, 3, 3] float64


def frame_track(camera: StereoCamera, settings: TrackSettings, st: TrackState,
                images: torch.Tensor) -> FrameMid:
    """A tracked frame up to its SVD: features, temporal matches, both
    triangulations, the key split (the key advanced in place), the
    hypotheses and their moments."""
    frame = extract_stereo_frame(camera, images[0], images[1], max_corners=settings.max_corners)
    idx, ok = features.match_descriptors(st.prev_desc, frame.desc, st.prev_valid, frame.valid)
    pts_prev = camera.triangulate(st.prev_uvd)
    pts_curr = camera.triangulate(frame.uvd[idx])
    key, sub = prng.split(st.key)
    st.key.copy_(key)
    hyp = alignment.draw_jax_hypotheses(ok[None], settings.ransac_iters, keys=sub[None])[0]
    c0, c1, W = alignment.umeyama_moments(*alignment.hypothesis_points(pts_prev, pts_curr, hyp))
    return FrameMid(frame, idx, ok, pts_prev, pts_curr, c0, c1, W)


def frame_finish(camera: StereoCamera, settings: TrackSettings, st: TrackState, mid: FrameMid,
                 U: torch.Tensor, Vh: torch.Tensor) -> None:
    """A tracked frame after its SVD ``W = U S Vh``: the hypotheses' poses,
    their scores, the refinement on the best one's inliers, the compounded
    pose and the state for the next frame, in place."""
    T_h = alignment.umeyama_transform(mid.c0, mid.c1, U, Vh, mid.pts_prev.dtype)
    res = alignment.ransac_select(camera, mid.pts_prev, mid.pts_curr, mid.ok, T_h,
                                  settings.ransac_thresh)
    T = refine_pose_gn(camera, res.T_1_0, mid.pts_prev, mid.frame.uvd[mid.idx],
                       res.inliers.to(mid.pts_prev.dtype))
    st.T_curr_map.copy_(lie.se3_compose(T.to(torch.float64), st.T_curr_map))
    _keep(st, mid.frame, mid.ok.sum())


def frame_body(camera: StereoCamera, settings: TrackSettings, st: TrackState,
               images: torch.Tensor) -> None:
    """One tracked frame on ``images [2, H, W]``, launch by launch (the host
    form): ``frame_track``, the SVD, ``frame_finish``."""
    mid = frame_track(camera, settings, st, images)
    U, _, Vh = torch.linalg.svd(mid.W)
    frame_finish(camera, settings, st, mid, U, Vh)


class FrameSteps(NamedTuple):
    """A tracked frame on fixed buffers as ``FrameGraph`` runs it: ``track()``
    (captured), ``svd()`` (eager) and ``finish()`` (captured). Each reads
    only the state, the images, the tensors the last ``track`` made and
    the SVD's factors, which ``svd`` writes into buffers of its own."""

    track: Callable[[], None]
    svd: Callable[[], None]
    finish: Callable[[], None]


def frame_steps(camera: StereoCamera, settings: TrackSettings, st: TrackState,
                images: torch.Tensor) -> FrameSteps:
    """The three steps of a tracked frame on the buffers ``st`` and
    ``images`` (on the CPU the tests run them in turn, as the card does)."""
    f64 = dict(dtype=torch.float64, device=images.device)
    U, Vh = (torch.zeros((settings.ransac_iters, 3, 3), **f64) for _ in range(2))
    mid: list = []

    def track():
        mid[:] = [frame_track(camera, settings, st, images)]

    def svd():
        u, _, vh = torch.linalg.svd(mid[0].W)
        U.copy_(u)
        Vh.copy_(vh)

    def finish():
        frame_finish(camera, settings, st, mid[0], U, Vh)

    return FrameSteps(track, svd, finish)


# the captures of every FrameGraph of the process, and their host seconds
FRAME_STATS = {"captures": 0, "capture_s": 0.0, "instantiate_s": 0.0}


class FrameGraph:
    """A tracked frame as two plain CUDA graphs per image shape
    (``graph_loop.DeviceGraph``, which keeps each step's closure alive,
    ROADMAP F18) around the eager SVD, on one tracker's ``TrackState`` and
    the shape's image buffers: a frame is a replay, the SVD (whose result
    check syncs with the host) and a replay. The steps run once eagerly
    before the capture, on copies of the state, on the capture stream
    (the libraries' handles and workspaces are made there). ``close()``
    frees every capture; ``FRAME_STATS`` counts the captures and times
    them and their instantiations."""

    def __init__(self, camera: StereoCamera, settings: TrackSettings, st: TrackState):
        self.camera, self.settings, self.st = camera, settings, st
        self.graphs: dict = {}

    def frame(self, images: torch.Tensor) -> None:
        """One tracked frame on ``images`` (a fixed buffer of its shape)."""
        key = (tuple(images.shape), images.dtype, images.data_ptr())
        if key not in self.graphs:
            self.graphs[key] = self._capture(images)
        steps, track, finish = self.graphs[key]
        track.replay()
        steps.svd()
        finish.replay()

    def _capture(self, images: torch.Tensor):
        device = images.get_device()
        warm = frame_steps(self.camera, self.settings, TrackState(*(t.clone() for t in self.st)),
                           images)
        stream = graph_loop.capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            warm.track()
            warm.svd()
            warm.finish()
        torch.cuda.current_stream().wait_stream(stream)
        steps = frame_steps(self.camera, self.settings, self.st, images)
        graphs = [graph_loop.DeviceGraph(fn, device) for fn in (steps.track, steps.finish)]
        FRAME_STATS["captures"] += 1
        for g in graphs:
            FRAME_STATS["capture_s"] += g.capture_s
            FRAME_STATS["instantiate_s"] += g.instantiate_s
        return (steps, *graphs)

    def close(self) -> None:
        for _, track, finish in self.graphs.values():
            track.close()
            finish.close()
        self.graphs = {}


class OnlineStereoVO:
    """Stateful online VO: feed rectified stereo pairs, read poses.

    Keeps ``T_curr_map`` (camera from map, float64), compounded per frame;
    ``trajectory`` starts with the identity before the first frame. Images
    (numpy or tensors) are taken in float64 on ``device``: each pair is
    copied into the image buffer of its shape (from the host: through a
    pinned staging buffer, one copy). ``counts`` holds, per frame, the left
    image's valid corners, the stereo matches and the temporal matches (0
    on the first frame), as tensors.

    ``frame_loop``: ``"device"`` (the default on CUDA) runs every tracked
    frame as ``FrameGraph``'s replays, ``"host"`` (the default elsewhere;
    ``"device"`` there raises) launch by launch (``frame_body``). Both
    give the same bits."""

    def __init__(self, camera: StereoCamera, max_corners: int = 384, ransac_iters: int = 400,
                 ransac_thresh: float = 4.0, seed: int = 42, device="cuda",
                 frame_loop: str | None = None):
        self.camera = camera
        self.settings = TrackSettings(int(max_corners), int(ransac_iters), float(ransac_thresh))
        self.device = device_mod.resolve(device)
        self.frame_loop = graph_loop.resolve_loop(self.device, frame_loop, "frame loop",
                                                  "frame_loop")
        self.state = track_state(self.settings.max_corners, seed, self.device)
        self.graph = FrameGraph(camera, self.settings, self.state) \
            if self.frame_loop == "device" else None
        self._images: dict = {}  # shape -> (device buffer [2, H, W], pinned staging, event)
        self._started = False
        self.trajectory = [self.state.T_curr_map.clone()]
        self.counts: list = []

    @property
    def T_curr_map(self) -> torch.Tensor:
        return self.state.T_curr_map

    def _stage(self, img_left, img_right) -> torch.Tensor:
        """The pair in the image buffer of its shape: tensors on the card
        are copied there; host images go through the shape's staging
        buffer (pinned on the card) in one host-to-device copy, and the
        staging buffer is rewritten only once the previous copy out of it
        has run."""
        left, right = (img if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img))
                       for img in (img_left, img_right))
        shape = tuple(left.shape)
        if shape not in self._images:
            on_card = self.device.type == "cuda"
            self._images[shape] = (
                torch.empty((2, *shape), dtype=torch.float64, device=self.device),
                torch.empty((2, *shape), dtype=torch.float64, pin_memory=on_card),
                torch.cuda.Event() if on_card else None)
        images, staging, done = self._images[shape]
        if left.is_cuda:
            images[0].copy_(left)
            images[1].copy_(right)
            return images
        if done is not None and not done.query():
            done.synchronize()
        staging[0].copy_(left)
        staging[1].copy_(right)
        images.copy_(staging, non_blocking=True)
        if done is not None:
            done.record()
        return images

    def process(self, img_left, img_right) -> torch.Tensor:
        """Process one rectified pair; returns the updated ``T_curr_map`` (the
        state's buffer: the next frame overwrites it)."""
        images = self._stage(img_left, img_right)
        if not self._started:
            first_frame(self.camera, self.settings, self.state, images)
            self._started = True
        elif self.graph is not None:
            self.graph.frame(images)
        else:
            frame_body(self.camera, self.settings, self.state, images)
        self.counts.append(self.state.counts.clone())
        self.trajectory.append(self.state.T_curr_map.clone())
        return self.state.T_curr_map

    def close(self) -> None:
        if self.graph is not None:
            self.graph.close()

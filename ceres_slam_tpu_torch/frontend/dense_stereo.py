"""Dense stereo disparity front end: image pair -> disparity + gradients.

Port of ``ceres_slam_tpu/frontend/dense_stereo.py`` (the cv::pyrDown,
cv::StereoSGBM and cv::Sobel roles of the reference's dense photometric
test program). Plain PyTorch: the JAX package has no kernel here.

- the matching cost volume ``[D, H, W]`` is built by a loop over the D
  disparity shifts (``torch.roll``) and box-aggregated with integral
  images (two cumsums);
- the semi-global smoothing is two or four directional dynamic programs,
  each a Python loop over its scan axis carrying a ``[rows, D]`` slab: the
  SGM recursion ``L(p,d) = C(p,d) + min(L', L'(d±1)+P1, min L' + P2) - min L'``
  vectorized over every scanline at once;
- winner-take-all with sub-pixel parabola refinement, a uniqueness test
  and a left-right consistency check give the validity mask.

The JAX package compiles the whole matcher into one program
(``@jax.jit match_disparity``, its scans ``lax.scan``s). Here its trip
counts are static (D shifts, W-1 and H-1 scan steps), so on the card the
whole matcher is captured once as one plain CUDA graph (``MatcherGraph``,
~13,000 nodes at 240x320 with 4 directions) and replayed for every pair
of the same shape and settings (``loop="device"``, the default there):
its body reads only the two input buffers, into which a pair is copied,
and constants made before the capture. ``loop="host"`` (the CPU's form)
issues the same body's launches one by one: the same bits.

``torch.argmin`` keeps the first minimum, as ``jnp.argmin`` does, and
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ceres_slam_tpu_torch.ops import graph_loop

# cost sentinel for impossible matches: large enough to lose every
# comparison, small enough that a 4-direction SGM sum stays finite in f32
_BIG = 1.0e30


def _reflect_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of an ``[H, W]`` image (OpenCV's default
    for Sobel and pyrDown; ``jnp.pad(mode="reflect")``)."""
    return F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]


def sobel_gradients(img: torch.Tensor):
    """3x3 Sobel gradients (cv::Sobel, ksize 3, BORDER_REFLECT_101):
    correlation with [-1 0 1] x [1 2 1]^T (gx) and its transpose (gy)."""
    p = _reflect_pad(img, 1)
    sm_v = p[:-2, :] + 2.0 * p[1:-1, :] + p[2:, :]  # [H, W+2]
    gx = sm_v[:, 2:] - sm_v[:, :-2]
    sm_h = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]  # [H+2, W]
    gy = sm_h[2:, :] - sm_h[:-2, :]
    return gx, gy


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: 5-tap Gaussian ([1 4 6 4 1]/16, separable,
    BORDER_REFLECT_101), then decimation by 2 (output size ceil(n/2))."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=img.dtype, device=img.device) / 16.0
    p = _reflect_pad(img, 2)
    H, W = img.shape
    rows = sum(k[i] * p[i : i + H, :] for i in range(5))  # [H, W+4]
    blur = sum(k[i] * rows[:, i : i + W] for i in range(5))  # [H, W]
    return blur[::2, ::2]


def _box_filter_sum(vol: torch.Tensor, radius: int) -> torch.Tensor:
    """Windowed sum over the trailing two axes through integral images
    (edge-replicated), vectorized over any leading axes."""
    r = radius
    lead, (H, W) = vol.shape[:-2], vol.shape[-2:]
    v = F.pad(vol.reshape(-1, H, W), (r, r, r, r), mode="replicate")
    c = torch.cumsum(torch.cumsum(v, dim=-2), dim=-1)
    c = F.pad(c, (1, 0, 1, 0))  # prepend a zero row and column
    w = 2 * r + 1
    out = (c[..., w : w + H, w : w + W] - c[..., w : w + H, 0:W]
           - c[..., 0:H, w : w + W] + c[..., 0:H, 0:W])
    return out.reshape(*lead, H, W)


def _cost_volume(left, right, max_disp: int, block: int, prefilter_cap):
    """SAD block-matching cost volume ``[D, H, W]``: the cost of matching
    ``left[y, u]`` to ``right[y, u-d]``, on the x-Sobel-prefiltered images
    clipped at ``prefilter_cap`` plus a scaled intensity term. Pixels with
    ``u < d`` carry the ``_BIG`` sentinel."""
    H, W = left.shape
    gl, _ = sobel_gradients(left)
    gr, _ = sobel_gradients(right)
    cap = prefilter_cap
    gl = gl.clamp(-cap, cap)
    gr = gr.clamp(-cap, cap)
    feats_r = torch.stack([gr, right])  # [2, H, W]
    u = torch.arange(W, device=left.device).expand(H, W)
    # a fill, not a copy from the host: a capture cannot make that copy
    big = torch.full((), _BIG, dtype=left.dtype, device=left.device)
    vol = torch.empty((max_disp, H, W), dtype=left.dtype, device=left.device)
    for d in range(max_disp):
        # right[y, u-d]: move content right by d; lanes u < d are invalid
        rs = torch.roll(feats_r, d, dims=-1)
        # gradient term dominant, intensity term scaled to the cap
        sad = (gl - rs[0]).abs() + 0.25 * (left - rs[1]).abs() * cap
        vol[d] = torch.where(u >= d, sad, big)
    r = block // 2
    invalid = vol >= big
    agg = _box_filter_sum(torch.where(invalid, 0.0, vol), r)
    cnt = _box_filter_sum(torch.where(invalid, 0.0, torch.ones_like(vol)), r)
    agg = torch.where(cnt > 0, agg / cnt.clamp_min(1.0), big)
    d_ids = torch.arange(max_disp, device=left.device)[:, None, None]
    return torch.where(u >= d_ids, agg, big)


def _sgm_dir(cost_sd: torch.Tensor, p1, p2) -> torch.Tensor:
    """One directional SGM pass. ``cost_sd``: ``[S, R, D]`` with S the scan
    axis, R the batched scanlines. Returns the aggregated ``[S, R, D]``."""
    cost_sd = cost_sd.contiguous()
    out = torch.empty_like(cost_sd)
    out[0] = cost_sd[0]
    inf_col = torch.full_like(cost_sd[0, :, :1], _BIG)
    prev = cost_sd[0]
    for s in range(1, cost_sd.shape[0]):
        m = prev.amin(dim=-1, keepdim=True)
        up = torch.cat([inf_col, prev[:, :-1]], dim=-1)
        dn = torch.cat([prev[:, 1:], inf_col], dim=-1)
        best = torch.minimum(torch.minimum(prev, m + p2), torch.minimum(up + p1, dn + p1))
        # clamp: sentinel lanes must not poison the recursion
        prev = torch.clamp_max(cost_sd[s] + best - m, _BIG)
        out[s] = prev
    return out


def _sgm_aggregate(vol: torch.Tensor, p1, p2, directions: int) -> torch.Tensor:
    """Sum of the directional DP costs, ``[D, H, W] -> [D, H, W]``;
    ``directions`` 2 (horizontal) or 4 (and vertical)."""
    hwd = vol.permute(1, 2, 0)  # [H, W, D]
    whd = hwd.transpose(0, 1)  # scan axis W, scanlines H
    lr = _sgm_dir(whd, p1, p2)
    rl = _sgm_dir(whd.flip(0), p1, p2).flip(0)
    agg = lr.transpose(0, 1) + rl.transpose(0, 1)
    if directions >= 4:
        tb = _sgm_dir(hwd, p1, p2)  # scan axis H
        bt = _sgm_dir(hwd.flip(0), p1, p2).flip(0)
        agg = agg + tb + bt
    return agg.permute(2, 0, 1).contiguous()


def _wta(S: torch.Tensor, uniqueness: float):
    """Winner-take-all, parabola sub-pixel refinement and the uniqueness
    mask. ``S``: ``[D, H, W]``. Returns ``(disp [H, W], valid [H, W])``."""
    D = S.shape[0]
    d_best = S.argmin(dim=0)  # first minimum, as jnp.argmin
    c_best = S.amin(dim=0)
    # uniqueness: the best must beat every candidate outside d* +/- 1 by
    # the ratio margin (cv::StereoSGBM::uniquenessRatio)
    d_ids = torch.arange(D, device=S.device)[:, None, None]
    far = (d_ids - d_best[None]).abs() > 1
    c_second = torch.where(far, S, _BIG).amin(dim=0)
    unique = c_best * (1.0 + uniqueness) <= c_second
    # sub-pixel parabola through (d-1, d, d+1)
    cm = S.gather(0, (d_best - 1).clamp(0, D - 1)[None])[0]
    cp = S.gather(0, (d_best + 1).clamp(0, D - 1)[None])[0]
    denom = cm - 2.0 * c_best + cp
    delta = torch.where(denom > 1e-9, 0.5 * (cm - cp) / denom.clamp_min(1e-9), 0.0)
    delta = delta.clamp(-0.5, 0.5)
    interior = (d_best > 0) & (d_best < D - 1)
    disp = d_best.to(S.dtype) + torch.where(interior, delta, 0.0)
    valid = unique & (c_best < _BIG / 8) & interior
    return disp, valid


class MatchSettings(NamedTuple):
    """The matcher's settings (``match_disparity``'s keywords)."""

    max_disp: int = 64
    block: int = 5
    p1: float = 0.03
    p2: float = 0.12
    uniqueness: float = 0.05
    lr_threshold: float = 1.0
    directions: int = 4
    prefilter_cap: float = 0.25


def matcher_body(left: torch.Tensor, right: torch.Tensor, settings: MatchSettings):
    """The whole matcher as a function of no arguments over the input
    buffers ``left`` and ``right`` (``[H, W]``, the matcher's dtype), which
    it reads as they are when it runs: ``fn() -> (disparity, valid)``. Its
    constants (the SGM penalties) are made here, before any capture."""
    o = settings
    p1 = torch.full((), o.p1, dtype=left.dtype, device=left.device)
    p2 = torch.full((), o.p2, dtype=left.dtype, device=left.device)

    def fn():
        vol = _cost_volume(left, right, o.max_disp, o.block, o.prefilter_cap)
        S = _sgm_aggregate(vol, p1, p2, o.directions)
        disp, valid = _wta(S, o.uniqueness)
        # left-right consistency: the right image's cost volume is a shear
        # of the left's (cost_R[y, u, d] = cost_L[y, u+d, d]); a pixel
        # survives iff its match maps back within lr_threshold.
        D, H, W = S.shape
        u = torch.arange(W, device=S.device)
        ud = u + torch.arange(D, device=S.device)[:, None]  # [D, W]
        S_r = S.gather(2, ud.clamp(0, W - 1)[:, None, :].expand(D, H, W))
        S_r = torch.where((ud <= W - 1)[:, None, :], S_r, _BIG)
        disp_r, valid_r = _wta(S_r, o.uniqueness)
        # map left pixel u -> right pixel u - d
        ur = (u - torch.round(disp).to(torch.int64)).clamp(0, W - 1)
        d_back = disp_r.gather(1, ur)
        vr_back = valid_r.gather(1, ur)
        lr_ok = (disp - d_back).abs() <= o.lr_threshold
        return disp, valid & lr_ok & vr_back

    return fn


# the captures of every MatcherGraph of the process, and their host seconds
MATCH_STATS = {"captures": 0, "capture_s": 0.0, "instantiate_s": 0.0}


class MatcherGraph:
    """The matcher captured once per shape, dtype and settings as one plain
    CUDA graph (``graph_loop.DeviceGraph``) and replayed for every pair of
    that key: a pair is copied into the capture's input buffers, the graph
    replays, and its outputs are copied out. ``close()`` frees every
    capture; ``MATCH_STATS`` counts the captures and times them and their
    instantiations."""

    def __init__(self):
        self.graphs: dict = {}

    def match(self, left: torch.Tensor, right: torch.Tensor, settings: MatchSettings):
        """``(disparity, valid)`` of one pair (new tensors). A capture that
        fails raises."""
        key = (tuple(left.shape), left.dtype, left.device, settings)
        if key not in self.graphs:
            self.graphs[key] = self._capture(left, right, settings)
        bufs, graph, out = self.graphs[key]
        bufs[0].copy_(left)
        bufs[1].copy_(right)
        graph.replay()
        return tuple(t.clone() for t in out)

    @staticmethod
    def _capture(left, right, settings):
        """The key's input buffers, graph and outputs. The body runs once
        eagerly first, on the capture stream, its result dropped: it loads
        the kernels' modules, which a capture cannot."""
        device = left.get_device()
        bufs = (left.clone(), right.clone())
        fn, out = matcher_body(*bufs, settings), []
        stream = graph_loop.capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = graph_loop.DeviceGraph(lambda: out.extend(fn()), device)
        MATCH_STATS["captures"] += 1
        MATCH_STATS["capture_s"] += graph.capture_s
        MATCH_STATS["instantiate_s"] += graph.instantiate_s
        return bufs, graph, out

    def close(self) -> None:
        for _, graph, _ in self.graphs.values():
            graph.close()
        self.graphs = {}


def match_disparity(left: torch.Tensor, right: torch.Tensor, max_disp: int = 64,
                    block: int = 5, p1: float = 0.03, p2: float = 0.12,
                    uniqueness: float = 0.05, lr_threshold: float = 1.0,
                    directions: int = 4, prefilter_cap: float = 0.25,
                    loop: str | None = None, graph: MatcherGraph | None = None):
    """Semi-global stereo matching of ``[H, W]`` grayscale images in [0, 1]:
    ``(left, right) -> (disparity, valid)`` of the LEFT image, with
    sub-pixel refinement and confidence masking (the cv::StereoSGBM(0, 64,
    15) role). Runs in the inputs' dtype, at least float32. ``loop``:
    ``"device"`` (the default on CUDA) replays the matcher's CUDA graph,
    kept in ``graph`` (a ``MatcherGraph``) for the next pair of the same
    key, or captured for this pair alone without one; ``"host"`` (the
    default elsewhere) launches its kernels one by one and takes no
    ``graph``. Both run one body and give the same bits."""
    dtype = torch.promote_types(left.dtype, torch.float32)
    left, right = left.to(dtype), right.to(dtype)
    settings = MatchSettings(int(max_disp), int(block), float(p1), float(p2), float(uniqueness),
                             float(lr_threshold), int(directions), float(prefilter_cap))
    loop = graph_loop.resolve_loop(left.device, loop, "matcher loop", "match_loop")
    if loop == "host":
        if graph is not None:
            raise ValueError("a MatcherGraph keeps the device matcher: match_loop='host' takes "
                             "none")
        return matcher_body(left, right, settings)()
    own = graph is None
    graph = MatcherGraph() if own else graph
    try:
        return graph.match(left, right, settings)
    finally:
        if own:
            graph.close()


def load_gray(path: str) -> torch.Tensor:
    """A grayscale image file as ``[H, W]`` float64 in [0, 1], on the CPU.
    ``.npy`` needs numpy only; other formats (png, pgm, jpg) need PIL."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float64)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return torch.from_numpy(arr)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"reading {path} needs PIL (Pillow); convert the image to .npy "
                           "or install Pillow") from e
    img = Image.open(path).convert("L")
    return torch.from_numpy(np.asarray(img, np.float64) / 255.0)

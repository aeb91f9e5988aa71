"""Port parity: live stereo VO — the threefry key split and draw, Harris
corners, patch descriptors and matching, the stereo frame, the pose
refinement, the online tracker and the ``stereo_vo`` CLI.

Frames are rendered once (the textured wall of tests/test_stereo_vo.py,
120x160, float64) and handed to both packages as numpy arrays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.apps import stereo_vo as japp
from ceres_slam_tpu.frontend import features as jfeat
from ceres_slam_tpu.frontend import stereo_vo as jsvo
from ceres_slam_tpu.models.stereo_camera import StereoCamera as JCamera
from ceres_slam_tpu.ops import lie as jlie
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.apps import stereo_vo as app
from ceres_slam_tpu_torch.frontend import alignment, features, stereo_vo
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import lie, prng
from ceres_slam_tpu_torch.utils import csvio

torch.set_num_threads(1)

CAM = (140.0, 140.0, 80.0, 60.0, 0.4)
JCAM, TCAM = JCamera.create(*CAM), StereoCamera.create(*CAM)
STEP = np.array([0.02, -0.01, 0.12, 0.002, 0.004, -0.002])


@pytest.fixture(scope="module")
def frames():
    """Six frames along tests/test_stereo_vo.py's forward motion at 120x160
    (numpy pairs), and their poses."""
    poses = [np.asarray(jlie.se3_identity(dtype=jnp.float64))]
    for _ in range(5):
        poses.append(np.asarray(jlie.se3_compose(jlie.se3_exp(jnp.asarray(STEP)), poses[-1])))
    return [_render(T) for T in poses], np.stack(poses)


def _render(T_c_w):
    """The textured wall z_w = 8 seen from T_c_w (tests/test_stereo_vo.py)."""
    H, W = 120, 160
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    dirs = np.stack([(uu - CAM[2]) / CAM[0], (vv - CAM[3]) / CAM[1], np.ones_like(uu)], axis=-1)
    T_w_c = np.asarray(jlie.se3_inverse(jnp.asarray(T_c_w)))
    R_wc, c_w = T_w_c[3:].reshape(3, 3), T_w_c[:3]

    def tex(x, y):
        return (0.5 + 0.2 * np.sin(1.3 * x) * np.cos(1.9 * y) + 0.15 * np.sin(4.1 * x + 2.0 * y)
                + 0.1 * np.cos(7.3 * x - 3.1 * y) + 0.05 * np.sin(13.0 * x * y / 4.0))

    def from_center(c):
        d_w = np.einsum("ij,hwj->hwi", R_wc, dirs)
        p_w = c + ((8.0 - c[2]) / d_w[..., 2])[..., None] * d_w
        return tex(p_w[..., 0], p_w[..., 1])

    return from_center(c_w), from_center(c_w + R_wc @ np.array([CAM[4], 0.0, 0.0]))


def _t(x):
    return torch.as_tensor(np.array(x))


# -- the key split and draw -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 42, 2**33 + 5])
def test_prng_split_and_bits_match_jax(seed):
    """prng_key, split (depths 1-4, two and three ways) and key_bits32
    equal jax.random.PRNGKey / split / bits bit for bit."""
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(torch.tensor(seed))
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(key).astype(np.int64))
    for depth in range(4):
        np.testing.assert_array_equal(prng.split(tkey, 3).numpy(),
                                      np.asarray(jax.random.split(key, 3)).astype(np.int64))
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        np.testing.assert_array_equal(tkey.numpy(), np.asarray(key).astype(np.int64))
        np.testing.assert_array_equal(
            prng.key_bits32(tsub[None], (5, 7))[0].numpy(),
            np.asarray(jax.random.bits(sub, (5, 7), jnp.uint32)).astype(np.int64))


def test_hypotheses_from_keys_match_jax():
    """draw_jax_hypotheses(keys=...) picks JAX's Gumbel top three under each
    split key (ransac_align's draw), with invalid entries never picked."""
    P, H = 40, 64
    valid = np.random.default_rng(0).random(P) > 0.3
    key = jax.random.PRNGKey(42)
    keys = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        keys.append(sub)
    got = alignment.draw_jax_hypotheses(_t(np.stack([valid] * 3)), H,
                                        keys=_t(np.asarray(keys).astype(np.int64)))
    for b, sub in enumerate(keys):
        scores = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)[None] + jax.random.gumbel(
            sub, (H, P), dtype=jnp.float32).astype(jnp.float64)
        cols = jax.lax.broadcasted_iota(jnp.int32, (H, P), 1)
        for c in range(3):
            i = jnp.argmax(scores, axis=-1)
            np.testing.assert_array_equal(got[b, :, c].numpy(), np.asarray(i))
            scores = jnp.where(cols == i[:, None], -jnp.inf, scores)
    assert valid[got.numpy()].all()


# -- features -------------------------------------------------------------------


def _checkerboard():
    return np.kron(np.indices((8, 10)).sum(0) % 2, np.ones((12, 12))).astype(np.float64)


@pytest.mark.parametrize("image", ["checkerboard", "rendered"])
def test_harris_matches_jax_exactly(frames, image):
    """uv and valid equal JAX's exactly, the invalid (-inf) corners' uv
    included; finite responses to 1e-12 x max|response| (the box sums'
    cumulative sums round in another order, and R = det - k tr^2
    cancels)."""
    img = _checkerboard() if image == "checkerboard" else frames[0][0][0]
    for n in (64, 384, 4096):
        uv, resp, valid = features.harris_corners(_t(img), max_corners=n)
        juv, jresp, jvalid = jfeat.harris_corners(jnp.asarray(img), max_corners=n)
        np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        fin = np.isfinite(np.asarray(jresp))
        np.testing.assert_array_equal(np.isfinite(resp.numpy()), fin)
        ref = np.asarray(jresp)[fin]
        np.testing.assert_allclose(resp.numpy()[fin], ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max(initial=0.0))
    if image == "checkerboard":
        assert int(valid.sum()) > 20 and (~valid).any()  # the -inf ties are exercised


def test_descriptors_and_matches_match_jax(frames):
    """Descriptors to 1e-12 absolute (unit vectors); matches (indices and
    ok) equal JAX's: left against right with the stereo gate, and frame 0
    against frame 1; a frame matched to itself is the identity."""
    (l0, r0), (l1, _) = frames[0][0], frames[0][1]
    descs = {}
    for name, img in (("l0", l0), ("r0", r0), ("l1", l1)):
        uv, _, valid = features.harris_corners(_t(img), max_corners=128)
        d = features.patch_descriptors(_t(img), uv)
        jd = jfeat.patch_descriptors(jnp.asarray(img), jnp.asarray(uv.numpy()))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-12)
        descs[name] = (d, valid, uv)
    for a, b, gated in (("l0", "r0", True), ("l0", "l1", False), ("l0", "l0", False)):
        (da, va, uva), (db, vb, uvb) = descs[a], descs[b]
        gate = ((uva[:, None, 1] - uvb[None, :, 1]).abs() <= 1.5) if gated else None
        idx, ok = features.match_descriptors(da, db, va, vb, gate=gate)
        jidx, jok = jfeat.match_descriptors(
            jnp.asarray(da.numpy()), jnp.asarray(db.numpy()), jnp.asarray(va.numpy()),
            jnp.asarray(vb.numpy()), gate=None if gate is None else jnp.asarray(gate.numpy()))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        if a == b:
            np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.nonzero(ok.numpy())[0])


def test_stereo_frame_and_refinement_match_jax(frames):
    """extract_stereo_frame equal to JAX's (uvd exactly, descriptors 1e-12),
    through stereo_frame_from_numpy; refine_pose_gn from a perturbed pose
    on the frame's inliers equal to JAX's to 1e-10, a zero weight row
    holding a point at depth 0 included."""
    (l0, r0), (l1, r1) = frames[0][0], frames[0][1]
    f0 = stereo_vo.extract_stereo_frame(TCAM, _t(l0), _t(r0))
    jf0 = jsvo.extract_stereo_frame(JCAM, jnp.asarray(l0), jnp.asarray(r0))
    ref = convert.stereo_frame_from_numpy(jax.tree.map(np.asarray, jf0))
    np.testing.assert_array_equal(f0.uvd.numpy(), ref.uvd.numpy())
    np.testing.assert_array_equal(f0.valid.numpy(), ref.valid.numpy())
    np.testing.assert_allclose(f0.desc.numpy(), ref.desc.numpy(), rtol=0, atol=1e-12)
    assert int(f0.valid.sum()) > 30
    pts = TCAM.triangulate(f0.uvd)
    T_true = torch.as_tensor(np.asarray(jlie.se3_exp(jnp.asarray(STEP))))
    obs = TCAM.project(pts @ T_true[3:].reshape(3, 3).T + T_true[:3])
    w = f0.valid.to(torch.float64)
    pts[~f0.valid] = 0.0  # a depth-0 point on every zero-weight row
    T0 = torch.as_tensor(np.asarray(jlie.se3_exp(jnp.asarray(STEP + 0.01))))
    T = stereo_vo.refine_pose_gn(TCAM, T0, pts, obs, w)
    jT = jsvo.refine_pose_gn(JCAM, jnp.asarray(T0.numpy()), jnp.asarray(pts.numpy()),
                             jnp.asarray(obs.numpy()), jnp.asarray(w.numpy()))
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=1e-10)
    np.testing.assert_allclose(T.numpy(), T_true.numpy(), rtol=0, atol=1e-6)


def test_online_vo_trajectory_matches_jax(frames):
    """Six frames of OnlineStereoVO (seed 42, 256 corners): every pose of
    the trajectory equal to JAX's to 1e-6 m (translation and rotation
    entries), and drift as tests/test_stereo_vo.py bounds it."""
    imgs, gt = frames
    vo = stereo_vo.OnlineStereoVO(TCAM, max_corners=256, device="cpu")
    jvo = jsvo.OnlineStereoVO(JCAM, max_corners=256)
    for l, r in imgs:
        vo.process(l, r)
        jvo.process(jnp.asarray(l), jnp.asarray(r))
    traj = torch.stack(vo.trajectory).numpy()
    np.testing.assert_allclose(traj, np.stack([np.asarray(T) for T in jvo.trajectory]),
                               rtol=0, atol=1e-6)
    errs = [np.linalg.norm(np.asarray(jlie.se3_log(jlie.se3_compose(
        jnp.asarray(Te), jlie.se3_inverse(jnp.asarray(Tg)))))) for Te, Tg in zip(traj[1:], gt)]
    assert errs[-1] < 0.15 and np.median(errs) < 0.06
    counts = torch.stack(vo.counts).numpy()
    assert counts.shape == (6, 3) and counts[0, 2] == 0 and (counts[1:, 2] > 30).all()


def _pipeline_trajectory(imgs, max_corners=256, seed=42):
    """The per-frame pipeline restated as one loop over its public functions,
    launch by launch, with the state in Python variables (the tracker's
    arithmetic, whatever buffers it keeps): ``(trajectory, counts)``."""
    key, prev = prng.prng_key(torch.tensor(seed)), None
    T_map = lie.se3_identity(dtype=torch.float64)
    traj, counts = [T_map], []
    for l, r in imgs:
        frame = stereo_vo.extract_stereo_frame(TCAM, _t(l), _t(r), max_corners=max_corners)
        n_temporal = torch.zeros((), dtype=torch.int64)
        if prev is not None:
            idx, ok = features.match_descriptors(prev.desc, frame.desc, prev.valid, frame.valid)
            pts_prev, pts_curr = TCAM.triangulate(prev.uvd), TCAM.triangulate(frame.uvd[idx])
            key, sub = prng.split(key)
            hyp = alignment.draw_jax_hypotheses(ok[None], 400, keys=sub[None])[0]
            res = alignment.ransac_align(TCAM, pts_prev, pts_curr, ok, hyp, thresh=4.0)
            T = stereo_vo.refine_pose_gn(TCAM, res.T_1_0, pts_prev, frame.uvd[idx],
                                         res.inliers.to(pts_prev.dtype))
            T_map, n_temporal = lie.se3_compose(T.to(torch.float64), T_map), ok.sum()
        counts.append(torch.stack([frame.corners, frame.valid.sum(), n_temporal]))
        prev = frame
        traj.append(T_map)
    return torch.stack(traj), torch.stack(counts)


def test_frame_body_equals_the_pipeline(frames):
    """OnlineStereoVO's host form (``first_frame``, then ``frame_body`` on
    its fixed buffers) gives the per-frame pipeline's trajectory and counts
    bit for bit, on the six frames."""
    imgs, _ = frames
    vo = stereo_vo.OnlineStereoVO(TCAM, max_corners=256, device="cpu", frame_loop="host")
    for l, r in imgs:
        vo.process(l, r)
    traj, counts = _pipeline_trajectory(imgs)
    assert torch.equal(torch.stack(vo.trajectory), traj)
    assert torch.equal(torch.stack(vo.counts), counts)


def test_frame_steps_read_only_their_buffers(frames):
    """``frame_steps`` built once on one state and one image buffer, then
    run frame after frame as FrameGraph replays them (each pair copied into
    the buffer; track, the SVD, finish), give ``frame_body``'s bits on a
    fresh state: a tensor the steps read between frames that is not among
    their fixed buffers (the state, the images, what ``track`` made, ``U``
    and ``Vh``) would read the frame of the build and fail this."""
    imgs, _ = frames
    settings = stereo_vo.TrackSettings(max_corners=256)
    images = torch.zeros((2, *imgs[0][0].shape), dtype=torch.float64)
    states = [stereo_vo.track_state(256, 42, "cpu") for _ in range(2)]
    stereo_vo.first_frame(TCAM, settings, states[0], _t(np.stack(imgs[0])))
    stereo_vo.first_frame(TCAM, settings, states[1], _t(np.stack(imgs[0])))
    steps = stereo_vo.frame_steps(TCAM, settings, states[1], images)
    for l, r in imgs[1:4]:
        stereo_vo.frame_body(TCAM, settings, states[0], _t(np.stack([l, r])))
        images.copy_(_t(np.stack([l, r])))
        steps.track()
        steps.svd()
        steps.finish()
        for a, b in zip(states[0], states[1]):
            assert torch.equal(a, b)


def test_device_frame_loop_needs_a_card(tmp_path):
    with pytest.raises(ValueError, match="frame_loop='host'"):
        stereo_vo.OnlineStereoVO(TCAM, device="cpu", frame_loop="device")
    with pytest.raises(ValueError, match="frame_loop='host'"):
        app.main(["--synthetic", "2", "--out", str(tmp_path / "x"), "--device", "cpu",
                  "--frame-loop", "device"])


# -- the CLI --------------------------------------------------------------------


def test_render_synthetic_matches_jax():
    """The port's renderer equals the JAX app's to 1e-14 (frames) and
    exactly (ground-truth poses)."""
    frames, gt = app._render_synthetic(TCAM, 3, device="cpu")
    jframes, jgt = japp._render_synthetic(JCAM, 3)
    np.testing.assert_array_equal(gt, jgt)
    for (l, r), (jl, jr) in zip(frames, jframes):
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=0, atol=1e-14)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-14)


def test_cli_synthetic_matches_jax(tmp_path, capsys):
    """--synthetic 6: six poses equal to the JAX app's to 1e-6, ATE < 0.5 m
    (tests/test_apps.py), the counts in the returned stats."""
    stats = app.main(["--synthetic", "6", "--out", str(tmp_path / "port"), "--device", "cpu"])
    japp.main(["--synthetic", "6", "--out", str(tmp_path / "jax")])
    poses = csvio.read_poses_csv(stats["poses"])
    assert poses.shape == (6, 12) and stats["frames"] == 6
    np.testing.assert_allclose(poses, csvio.read_poses_csv(str(tmp_path / "jax_poses.csv")),
                               rtol=0, atol=1e-6)
    assert "ATE RMSE" in capsys.readouterr().out and stats["ate"] < 0.5
    assert stats["median_temporal_matches"] > 30


def test_cli_npy_files(tmp_path):
    """--left-glob/--right-glob on .npy frames: the same poses as the
    synthetic mode on the same frames (bit for bit)."""
    frames, _ = app._render_synthetic(TCAM, 4, device="cpu")
    for i, (l, r) in enumerate(frames):
        np.save(tmp_path / f"{i:03d}_left.npy", l.numpy())
        np.save(tmp_path / f"{i:03d}_right.npy", r.numpy())
    stats = app.main(["--left-glob", str(tmp_path / "*_left.npy"), "--right-glob",
                      str(tmp_path / "*_right.npy"), "--out", str(tmp_path / "files"),
                      "--device", "cpu"])
    synth = app.main(["--synthetic", "4", "--out", str(tmp_path / "synth"), "--device", "cpu"])
    poses = csvio.read_poses_csv(stats["poses"])
    assert poses.shape == (4, 12) and "ate" not in stats
    np.testing.assert_array_equal(poses, csvio.read_poses_csv(synth["poses"]))
    with pytest.raises(SystemExit, match="mismatch"):
        app.main(["--left-glob", str(tmp_path / "*_left.npy"), "--right-glob",
                  str(tmp_path / "none*.npy"), "--out", str(tmp_path / "x"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "x_poses.csv")


def _record_jax_figures(data: str):
    """The JAX app's ATE that chip_smoke.py's live_vo phase holds the port
    to: the port's 100 rendered frames at the phase's size and camera,
    written as .npy files and run through the JAX stereo_vo CLI
    (float64, on the CPU)."""
    import time

    from ceres_slam_tpu_torch.utils import metrics

    shape, cam = (319, 1056), (611.0276, 611.0276, 516.11388, 157.433345, 0.5372)
    frames, gt = app._render_synthetic(StereoCamera.create(*cam), 100, shape=shape, device="cpu")
    os.makedirs(data, exist_ok=True)
    for i, (l, r) in enumerate(frames):
        np.save(os.path.join(data, f"{i:03d}_left.npy"), l.numpy())
        np.save(os.path.join(data, f"{i:03d}_right.npy"), r.numpy())
    out = os.path.join(data, "jax")
    t0 = time.perf_counter()
    japp.main(["--left-glob", os.path.join(data, "*_left.npy"), "--right-glob",
               os.path.join(data, "*_right.npy"), "--out", out, "--fu", str(cam[0]), "--fv",
               str(cam[1]), "--cu", str(cam[2]), "--cv", str(cam[3]), "--baseline", str(cam[4])])
    ate = metrics.ate_translation(csvio.read_poses_csv(out + "_poses.csv"), gt)
    print(f"live VO {shape[0]}x{shape[1]} 100 frames: ATE {ate!r} m "
          f"({time.perf_counter() - t0:.1f} s)")
    # where the JAX package tracks: KITTI's camera scaled with the image,
    # the fewest stereo and temporal matches over the first 10 frames
    kitti = np.array([718.856, 718.856, 607.1928, 185.2157])
    for scale in (1.0, 0.9, 0.85):
        cam = JCamera.create(*(kitti * scale), 0.5372)
        size = (round(375 * scale), round(1242 * scale))
        frames, _ = japp._render_synthetic(cam, 10, shape=size)
        vo, stereo, temporal = jsvo.OnlineStereoVO(cam), [], []
        for l, r in frames:
            prev = vo._prev
            vo.process(l, r)
            stereo.append(int(vo._prev.valid.sum()))
            if prev is not None:
                temporal.append(int(jfeat.match_descriptors(prev.desc, vo._prev.desc, prev.valid,
                                                             vo._prev.valid)[1].sum()))
        print(f"live VO {size[0]}x{size[1]} (KITTI camera x {scale}), 10 frames: fewest stereo "
              f"matches {min(stereo)}, fewest temporal matches {min(temporal)}", flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_stereo_vo.py DIR
    import sys

    jax.config.update("jax_enable_x64", True)
    _record_jax_figures(sys.argv[1])

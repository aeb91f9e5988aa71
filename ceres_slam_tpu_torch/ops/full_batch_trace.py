"""Device time of K2 and K3 per call, phase by phase, on the card.

    python -m ceres_slam_tpu_torch.ops.full_batch_trace [--shapes kitti1100,triangle200]
                                                        [--dtypes f64,f32]

On seeded random problems at the full-batch shapes of the sims, for K2
(``stereo_factor_sums``) and K3 (``schur_uy``): the device time per call of
calls issued back to back, gaps between kernels included
(``device_span_ms``), and each phase's kernel time from torch.profiler
(``kernel_ms``).
"""

from __future__ import annotations

import argparse

import torch

from ceres_slam_tpu_torch.ops import schur_kernel, stereo_factor_kernel

SHAPES = {"triangle200": (12992, 448, 200), "kitti1100": (124480, 16640, 1100)}


def device_span_ms(fn, n: int = 50) -> float:
    """Device time per call of ``n`` calls issued back to back: the stream is
    held by a spin kernel while the host enqueues them between two events,
    so no host time falls between the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e5) * n)  # ~0.2 ms of spinning per call enqueued behind it
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(fn, reps: int = 20) -> tuple[dict, float]:
    """Each device kernel's mean time per call in ms, by name, and the
    device kernels per call (torch.profiler, ``reps`` calls of a function
    that runs the same kernels every call). A session on the card now and
    then records no event or drops some: up to five sessions are tried
    until one records a whole number of events per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events and len(events) % reps == 0:
            break
    out = {}
    for e in events:
        name = e.name.split("<")[0].rsplit("::", 1)[-1]
        out[name] = out.get(name, 0.0) + e.device_time_total / reps / 1e3
    return out, len(events) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="kitti1100,triangle200")
    ap.add_argument("--dtypes", default="f64,f32")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("full_batch_trace needs a CUDA device")
    for shape in a.shapes.split(","):
        N, J, K = SHAPES[shape]
        for tag in a.dtypes.split(","):
            dtype = torch.float64 if tag == "f64" else torch.float32
            plan, poses, points = stereo_factor_kernel.random_inputs(N, J, K, dtype, "cuda", seed=7)
            bound, v = schur_kernel.random_inputs(N, J, K, dtype, "cuda", seed=7)
            for name, fn in (
                    ("K2", lambda: stereo_factor_kernel.stereo_factor_sums(plan, poses, points)),
                    ("K3", lambda: schur_kernel.schur_uy(bound, v))):
                span = device_span_ms(fn)
                by_name, _ = kernel_ms(fn)
                print(f"[trace] {name} {shape} {tag}: {span * 1e3:.2f} us per call back to back; "
                      + ", ".join(f"{k} {ms * 1e3:.2f} us" for k, ms in by_name.items()),
                      flush=True)


if __name__ == "__main__":
    main()

"""The peaks of the card and the roofline arithmetic of the port's kernels.

Peaks: NVIDIA's H100 SXM data sheet, dense rates outside the tensor cores
(the kernels do scalar f64 / f32 arithmetic), at the full 700 W. A kernel's
bound is the larger of its bytes over the HBM rate and its operations over
the peak of their type; each input byte is counted read once and each output
byte written once, from the shapes of the call (the counts of
``chip_smoke.py``'s kernel table, copied here)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f64": 34e12, "f32": 67e12}
# operations a row, counted from the kernels' sources: K1 a landmark slot,
# K3 an observation
OPS_PER_ROW = {"K1": 750, "K3": 90}


def k3_cost(N: int, J: int, K: int, elem: int) -> tuple[int, int]:
    """``schur_uy``'s ``(bytes, operations)``: U18 ``[N, 18]``, Cinv ``[J,
    3, 3]``, v ``[K, 6]`` read and Uy ``[K, 6]`` written in the dtype, one
    int32 pose and one int32 landmark index an observation."""
    return (18 * N + 9 * J + 12 * K) * elem + 8 * N, OPS_PER_ROW["K3"] * N


def k1_batch_cost(B: int, K: int, J: int, O: int, S: int, elem: int) -> tuple[int, int]:
    """The batched ``window_factor_blocks``' ``(bytes, operations)`` for B
    windows of K poses and J landmarks with O slots each (``M = J O`` slots
    a window, ``S`` real records): in the poses ``[B, K, 12]``, points ``[B,
    J, 3]`` and the 14 used values of each slot's record in the dtype, one
    int32 pose index a slot, the pose offsets ``[B, K + 1]`` and the ``S``
    records' landmark indices in int32, the cameras ``[B, 5]`` in float64;
    out the landmark blocks ``[B, J, 9]``, couplings ``[B, M, 18]``,
    landmark gradients ``[B, J, 3]``, pose rows ``[B, K, 43]`` and the costs
    ``[B]`` in the dtype."""
    M = J * O
    values = B * (12 * K + 3 * J + 14 * M) + B * (9 * J + 18 * M + 3 * J + 43 * K + 1)
    return values * elem + 4 * (B * M + B * (K + 1) + S) + 8 * 5 * B, OPS_PER_ROW["K1"] * B * M


def bound_s(nbytes: int, ops: int, tag: str) -> float:
    """The least time the card could take, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[tag])


def time_back_to_back(fn, reps: int = 200) -> float:
    """Seconds of device time a call of ``fn``: ``reps`` calls captured back
    to back in one CUDA graph, its replay timed by CUDA events (the host's
    launch cost, which a kernel of a few microseconds falls under, is out of
    it), after eager warm-up calls and a warm replay."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps

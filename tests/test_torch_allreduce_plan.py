"""The peer all-reduce's launch plan as the wrapper computes it
(``ops/allreduce_kernel``): the grid fixed per workspace (``grid_for``) and
a buffer's bytes in the slot, whole 16-byte vectors (``padded_bytes``). No
card: the kernel's own indexing is checked against its plain version in
``test_torch_cuda.py`` at the path's sizes.

Sizes: a CG iteration's U^T v and U y of kitti1100 (49,920 and 6,600 f64)
and of triangle200 (1,344 and 1,200), the LM step's blocks of kitti1100
(245,880), and ragged ones (1, 2, 3, and odd sizes above the vector width).
"""

import pytest

from ceres_slam_tpu_torch.ops import allreduce_kernel as ar

SIZES = (1, 2, 3, 5, 7, 1200, 1344, 2049, 6600, 49920, 245880)


@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
def test_padded_bytes_whole_vectors(itemsize):
    """A buffer takes the fewest whole vectors that hold it: the last one
    padded by less than a vector, none for an empty buffer."""
    assert ar.padded_bytes(0, itemsize) == 0
    for numel in SIZES:
        got = ar.padded_bytes(numel, itemsize)
        assert got % ar.VECTOR_BYTES == 0, numel
        assert 0 <= got - numel * itemsize < ar.VECTOR_BYTES, numel


def test_grid_fixed_per_workspace():
    """One block where the kernel returns at once (one rank), else the same
    grid for every size: at most the kernel's 32 blocks, all resident
    together."""
    assert ar.grid_for(1) == 1
    assert {ar.grid_for(n) for n in range(2, ar.MAX_RANKS + 1)} == {ar.BLOCKS}
    assert ar.BLOCKS <= 32 and ar.BLOCKS * ar.THREADS == 16384


@pytest.mark.parametrize("numel", [49920, 6600])
def test_path_sizes_one_or_two_vectors_a_thread(numel):
    """At a CG iteration's U^T v (49,920 f64) a thread of the grid takes at
    most two vectors from each peer; at U y (6,600 f64) at most one."""
    vectors = ar.padded_bytes(numel, 8) // ar.VECTOR_BYTES
    threads = ar.grid_for(4) * ar.THREADS
    assert -(-vectors // threads) == (2 if numel == 49920 else 1)


def test_slot_holds_the_padded_buffer():
    """``reserve``'s slot (a whole number of MiB) holds any buffer of up to
    its size rounded up to whole vectors."""
    quantum = 1 << 20
    for nbytes in (8, 12, quantum - 4, quantum, quantum + 4):
        slot = -(-nbytes // quantum) * quantum
        for itemsize in (4, 8):
            numel = nbytes // itemsize
            assert ar.padded_bytes(numel, itemsize) <= slot

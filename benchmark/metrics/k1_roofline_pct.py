"""K1 (``window_factor_blocks_batch``) alone on this cell's own batch plan,
the last step's windows: its bound (bytes over the HBM rate or operations
over the peak of the dtype, the larger; ``roofline.k1_batch_cost``) over its
time a call by CUDA events around back-to-back launches, in percent."""

from benchmark import roofline


def read(run):
    case = run.driver.kernel_case("K1")
    if case is None:
        return None
    call, nbytes, ops, tag = case
    return 100.0 * roofline.bound_s(nbytes, ops, tag) / roofline.time_back_to_back(call)

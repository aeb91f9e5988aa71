"""K3 (``schur_uy``) alone on this cell's own plan, bound to the first
trial's start: its bound (bytes over the HBM rate or operations over the f64
peak, the larger; ``roofline.k3_cost``) over its time a call by CUDA events
around back-to-back launches, in percent."""

from benchmark import roofline


def read(run):
    case = run.driver.kernel_case("K3")
    if case is None:
        return None
    call, nbytes, ops, tag = case
    return 100.0 * roofline.bound_s(nbytes, ops, tag) / roofline.time_back_to_back(call)

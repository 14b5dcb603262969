"""K4's share of its roofline: the least time the card could take for
the K4 work of every call in the window (``roofline.least_seconds`` of
the bytes and operations that the entry counts from the cell's inputs,
a launch at a time) over K4's device seconds in the window, in %. A
floor: the counts leave out the tree that no input fixes."""

from rtbench import roofline

KERNELS = ('pt_bvh_pool_kernel', 'pt_bvh_lane_kernel')


def read(run):
    if run.trace is None or run.trace.kernel_count(KERNELS) == 0:
        return None
    least = sum(roofline.least_seconds(b, o)[0]
                for b, o in run.entry.work(run)["k4"])
    return 100.0 * least * run.units / run.trace.kernel_s(KERNELS)

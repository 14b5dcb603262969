"""The share of the timed calls' host time that K4's kernels do not
cover on the device: 100 x (1 - K4's device seconds in the window /
the sum of the calls' host seconds, each call ending when its work has
completed). What is left is the program's glue around K4: Python,
other kernels, copies and the host's waits."""

KERNELS = ('pt_bvh_pool_kernel', 'pt_bvh_lane_kernel')


def read(run):
    if run.trace is None or run.trace.kernel_count(KERNELS) == 0:
        return None
    return 100.0 * (1.0 - run.trace.kernel_s(KERNELS) / sum(run.unit_s))

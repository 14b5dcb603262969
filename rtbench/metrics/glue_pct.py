"""The share of the timed calls' host time that K1's kernels do not
cover on the device: 100 x (1 - K1's device seconds in the window /
the sum of the calls' host seconds, each call ending when its work has
completed). What is left is the program's glue around K1: Python,
other kernels, copies and the host's waits. It reads every
``glue_pct.<suffix>`` without a file of its own (``glue_pct.pt``, around
K4, has one)."""

KERNELS = ('traverse_kernel',)


def read(run):
    if run.trace is None or run.trace.kernel_count(KERNELS) == 0:
        return None
    return 100.0 * (1.0 - run.trace.kernel_s(KERNELS) / sum(run.unit_s))

"""K1's share of its roofline: the least time the card could take for
the K1 work of every call in the window (``roofline.least_seconds`` of
the bytes and operations that the entry counts from the cell's inputs,
a launch at a time) over K1's device seconds in the window, in %. A
floor: the counts leave out the tree that no input fixes. It reads every
``k1_roofline.<suffix>``."""

from rtbench import roofline

KERNELS = ('traverse_kernel',)


def read(run):
    if run.trace is None or run.trace.kernel_count(KERNELS) == 0:
        return None
    least = sum(roofline.least_seconds(b, o)[0]
                for b, o in run.entry.work(run)["k1"])
    return 100.0 * least * run.units / run.trace.kernel_s(KERNELS)

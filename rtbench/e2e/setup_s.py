"""Set-up seconds: from the process's start to the first timed call
(scene, build, tables, kernels loaded or built, warm-up)."""


def read(run):
    return run.setup_s

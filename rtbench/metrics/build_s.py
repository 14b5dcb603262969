"""Host seconds of the build in set-up: the program's tree build, its
BVH16 or BVH8 tables and their copy to the device, ended by a
synchronise (the benchmark's span around them)."""


def read(run):
    return run.spans.get("build")

"""The mean rays of one K1 launch: the program's ``k1.rays`` counter over
its K1 launch counters (``packet_traverse*``), every launch of the
process (set-up, window and comparison run the same frames)."""

from rtbench import spans


def read(run):
    tr = spans.program_trace()
    if tr is None or run.trace is None:
        return None
    counts = tr.counts()
    launches = sum(v for k, v in counts.items()
                   if k.startswith("packet_traverse"))
    if not launches or not counts.get("k1.rays"):
        return None
    return counts["k1.rays"] / launches

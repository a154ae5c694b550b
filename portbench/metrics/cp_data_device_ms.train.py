"""Device ms a step of the ops launched inside the benchmark's own
``portbench.data`` spans of a ``cp_train`` cell: each rank gathers and
augments the whole global batch (the context-parallel step's contract: every
rank passes the same images), which the system's ``mdvit.data`` span does not
cover there. Read on rank 0, whose work every rank repeats."""
from bisect import bisect_right

from torch.autograd import DeviceType

from portbench.trace import SPAN_PREFIX, _union

SPAN = SPAN_PREFIX + "data"


def read(w):
    intervals = _union([(e.time_range.start, e.time_range.end) for e in w.events
                        if e.device_type == DeviceType.CPU and e.name == SPAN])
    if not intervals or not w.host_busy:
        return None
    starts = [s for s, _ in intervals]
    total, seen = 0.0, set()
    for e in w.events:  # each device op counted once, under the host op that launched it
        if e.device_type != DeviceType.CPU or not e.kernels or e.is_user_annotation \
                or e.id in seen:
            continue
        seen.add(e.id)
        i = bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= intervals[i][1]:
            total += sum(k.duration for k in e.kernels)
    return total / 1e3 / w.work

"""% of the device-only traced window in which an NCCL kernel runs and no
other device op does: the communication that compute did not hide (the
kernel's wait for the slowest rank included). ``device_idle_share.train``
counts NCCL time as busy: read the two together."""
from portbench.trace import _union


def is_nccl(name: str) -> bool:
    return name.startswith("nccl")


def exposed_s(comm: list, other: list) -> float:
    """Seconds of the union of ``comm`` intervals (µs) that no ``other``
    interval covers."""
    other = _union(other)
    total, j = 0.0, 0
    for s, e in _union(comm):
        while j < len(other) and other[j][1] <= s:
            j += 1
        covered, k = 0.0, j
        while k < len(other) and other[k][0] < e:
            covered += min(e, other[k][1]) - max(s, other[k][0])
            k += 1
        total += (e - s) - covered
    return total / 1e6


def read(w):
    spans = [((e.time_range.start, e.time_range.end), is_nccl(e.name)) for e in w.device_ops]
    comm = [t for t, nccl in spans if nccl]
    if not comm:
        return None
    return 100.0 * exposed_s(comm, [t for t, nccl in spans if not nccl]) / w.window_s

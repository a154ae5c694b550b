"""The nearest-rank 95th percentile of the traced (device-only) window's
call service times, ms: a call from when the card could start it (its
issue, or the landing of the call before, whichever is later) until its
maps are in host memory. A host stall that leaves the card without work
lengthens it; one covered by the calls in flight does not. Read here,
beside the rate it moves."""
from portbench.traffic.serve import p95


def read(w):
    return 1e3 * p95(w.latencies) if w.latencies else None

"""Device ms a step of the ops launched under PyTorch's own
``Optimizer.step#AdamW.step`` range."""

RANGE = "Optimizer.step#AdamW.step"


def read(w):
    device_s = w.device_s(w.outermost((RANGE,)))
    return 1e3 * device_s / w.work if device_s > 0 else None

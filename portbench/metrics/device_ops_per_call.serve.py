"""Device ops (kernels, copies, memsets) of the traced window a call."""
from portbench.trace import ops_per_work as read  # noqa: F401

"""Device ops (kernels, copies, memsets) of the traced window a step."""
from portbench.trace import ops_per_work as read  # noqa: F401

"""The share of the traced window in which no device op ran, % (the union
of the device ops' intervals over the window's host-clock seconds)."""
from portbench.trace import idle_pct as read  # noqa: F401

"""The plain reference's FLOPs of each step or call of the traced window
over the window's seconds, as a share of the card's peak at the
configuration's precision, %."""
from portbench.trace import mfu_pct as read  # noqa: F401

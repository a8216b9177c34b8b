"""The share of the traced window in which no operation ran on the card,
in %: 1 − the union of its activities' intervals / the window
(``harness/trace.idle_percent``, the one reader of both cell kinds)."""
from harness.trace import idle_percent as read  # noqa: F401

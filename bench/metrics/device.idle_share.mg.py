"""The device's idle share in the traced part of the window: 1 - the union
of every kernel, copy and fill on the card over the traced seconds."""
from harness.readers import idle_share as read  # noqa: F401

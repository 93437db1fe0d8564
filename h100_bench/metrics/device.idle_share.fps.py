"""Share of the traced window in which no kernel, copy or memset ran on the card (%)."""
from harness.readers import idle_share


def read(readings):
    return idle_share(readings)

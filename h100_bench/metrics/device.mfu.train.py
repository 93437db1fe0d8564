"""The whole step's share of the card's peak: the analytic least time of the window's steps or frames over the window (%)."""
from harness.readers import mfu


def read(readings):
    return mfu(readings)

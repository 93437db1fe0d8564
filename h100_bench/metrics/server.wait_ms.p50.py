"""Median ms from a request's due time to the start of its batch's `InferenceServer.forward` (host clock)."""
from harness.readers import median_ms


def read(readings):
    return median_ms(readings, 'server_wait_ms')

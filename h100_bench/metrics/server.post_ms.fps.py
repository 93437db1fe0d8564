"""Median host ms a batch spends in the outputs' device-to-host copy (`_to_numpy`) and `apply_circle_nms`."""
from harness.readers import median_ms


def read(readings):
    return median_ms(readings, 'server_post_ms')

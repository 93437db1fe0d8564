"""The lift op's byte bound at 3.35 TB/s over its CUDA-event time, forward, over the last batch's calls (%)."""
from harness.readers import roofline_share


def read(readings):
    return roofline_share(readings, 'lift')

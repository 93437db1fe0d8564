"""The ray op's byte bound at 3.35 TB/s over its CUDA-event time, forward and backward, over the last step's calls (%)."""
from harness.readers import roofline_share


def read(readings):
    return roofline_share(readings, 'rays')

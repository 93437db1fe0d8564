"""`Vampire.forward`, median CUDA-event ms a micro-batch."""
from harness.readers import median_ms


def read(readings):
    return median_ms(readings, 'model.forward', device=True)

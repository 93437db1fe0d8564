"""The image backbone and neck forward, CUDA-event ms a step."""
from harness.readers import per_unit_ms


def read(readings):
    return per_unit_ms(readings, 'model.encoder')

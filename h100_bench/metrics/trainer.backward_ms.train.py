"""The step's backward (`torch.autograd.backward`), CUDA-event ms a step."""
from harness.readers import per_unit_ms


def read(readings):
    return per_unit_ms(readings, 'trainer.backward')

"""Global-norm clip plus the AdamW step, CUDA-event ms a step."""
from harness.readers import per_unit_ms


def read(readings):
    return per_unit_ms(readings, 'trainer.optimizer')

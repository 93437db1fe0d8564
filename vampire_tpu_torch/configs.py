"""The configuration dataclasses and synthetic inputs of the JAX package.

These modules of `vampire_tpu` import no JAX, so the port reuses them as
they are instead of copying them.
"""
from vampire_tpu.configs import (LABEL_17_NAMES,  # noqa: F401
                                 BackboneConfig, HeadConfig, VampireConfig,
                                 flagship_config)
from vampire_tpu.data.synthetic import (camera_rig,  # noqa: F401
                                        synthetic_batch, tiny_config)

"""In-process micro-batching inference serving."""
from .server import InferenceServer  # noqa: F401

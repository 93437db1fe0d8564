"""Inference serving: the micro-batching InferenceServer, a pool of
replicas and the TCP front-end."""
from .server import (InferenceServer, ReplicaPool, TcpClient,  # noqa: F401
                     serve_tcp)

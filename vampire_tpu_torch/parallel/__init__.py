"""Multi-process runtime: one process a device in a torch.distributed
process group (NCCL on cards, gloo on the CPU), laid out as the JAX
package's dp x cam mesh (`mesh.py`)."""

"""Measurement scripts of the port, run on a CUDA card from the repository
root (`python -m vampire_tpu_torch.tools.<name>`)."""

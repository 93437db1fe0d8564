"""The lift kernel wrapper and the build of the CUDA sources."""

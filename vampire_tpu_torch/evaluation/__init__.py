"""Detection and LiDAR-segmentation evaluators (numpy, host side)."""

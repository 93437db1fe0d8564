"""Synthetic nuScenes-shaped inputs."""

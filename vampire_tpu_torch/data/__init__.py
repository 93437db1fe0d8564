"""The host input pipeline: the nuScenes dataset and loader, its
transforms, the fake tree, and synthetic inputs."""

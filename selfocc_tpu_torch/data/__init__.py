"""data — the port's own copy of the synthetic dataset; the real nuScenes
loaders come with a later slice."""

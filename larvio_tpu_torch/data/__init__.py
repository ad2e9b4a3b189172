"""Synthetic data: the simulator (``sim``), the ATE evaluation (``evaluate``)
and the image renderer (``render``)."""

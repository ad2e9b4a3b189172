"""Host utilities: checkpoint / resume of state trees (``checkpoint``), the
native EuRoC CSV loader and IMU ring buffer (``native``)."""

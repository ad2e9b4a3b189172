"""Host utilities: checkpoint / resume of state trees (``checkpoint``)."""

"""Fleet execution: many independent VIO instances on one card."""

"""The harness's own tests (CPU; a test marked ``cuda`` decides inside itself whether there is a card)."""

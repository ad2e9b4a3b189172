"""The kinds of traffic a cell's file can name, one module each:
``<kind>.py`` with ``run(cells.Run) -> cells.Result``."""

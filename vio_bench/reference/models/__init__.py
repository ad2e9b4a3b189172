"""Part of the benchmark's frozen plain reference (see ``vio_bench/reference/__init__.py``)."""

"""The benchmark's plain reference: a frozen copy of the image-to-pose step
(the front end's ``models/frontend.py::track_frame`` and the filter's
``models/msckf.py::filter_step``) in plain PyTorch.

The modules are copies of the measured package's ``config``, ``core``,
``models`` and ``ops`` with their imports pointed here and every hand-written
kernel replaced by its plain version on every device: the pyramidal LK
(``ops/lk.py::lk_track``), the ORB descriptor (``ops/orb.py::_describe_plain``),
and the lane-kept products and triangular solves (``core/linalg.py``: one
``torch.matmul`` / ``solve_triangular`` per lane). Nothing here imports the
measured package, JAX or the JAX package, and nothing captures a graph.
The copy is frozen: a change to the measured package does not move the
yardstick it is held to.
"""

"""Initialization package (port of ``larvio_tpu/init``).

The static path lives on the device inside the filter step
(``models/initializer.py``). This package adds the in-motion bootstrap, on
the host in numpy (it runs once per sequence and waits on data, not compute):

  * preintegration.py: IMU preintegration between keyframes
  * sfm.py: two-view essential matrix and window SfM (triangulate, PnP, BA)
  * alignment.py: gyro-bias solve and linear visual-inertial alignment
  * flexible.py: static/dynamic dispatch and the injection of its result
"""

from larvio_tpu_torch.init.flexible import FlexibleInitializer, InitResult  # noqa: F401

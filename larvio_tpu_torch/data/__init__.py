"""Synthetic image rendering (the simulator and ATE evaluation are the JAX
package's numpy-only ``larvio_tpu.data.sim`` / ``larvio_tpu.data.evaluate``)."""

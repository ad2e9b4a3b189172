"""The device's idle share, in %, over the fleet's traced window: one minus
the union of the device operations' intervals over the window's length."""


def read(rec):
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)

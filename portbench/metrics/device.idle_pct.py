"""device.idle_pct: 100 x the share of the traced window in which no
device activity ran."""


def read(t):
    if not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)

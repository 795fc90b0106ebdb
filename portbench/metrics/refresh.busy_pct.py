"""refresh.busy_pct: 100 x the device seconds of the work queued from the
harness's ``refresh`` spans (the single chain's per-block energy refresh
from positions: mc/driver.resync -> initialize_state -> physics/energy,
plain torch), over the traced window; each device activity is placed by
the runtime call that queued it."""


def read(t):
    s = t.launched_in_s("refresh")
    return 100.0 * s / t.window_s if s and t.window_s > 0 else None

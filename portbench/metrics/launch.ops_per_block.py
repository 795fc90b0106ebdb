"""launch.ops_per_block: device activities (kernels, copies, fills) the
profiler recorded in the traced window, over its blocks: the host path's
launches, a count that repeats exactly."""


def read(t):
    return len(t.device_ops) / t.blocks if t.device_ops else None

"""stepg_roofline: the step kernel's (K3, csrc/stepg.cu, one launch a
step) share of its roofline, in %: the frozen bound (bounds.steps_bound)
summed over the window's blocks, over K3's summed device time."""

from portbench import bounds


def read(t):
    busy, calls = t.kernel_s("stepg_kernel")
    if not calls or calls != len(t.records) * t.n_steps:
        return None
    least = sum(bounds.steps_bound(t.spec, t.n_steps, a, b)
                for a, b in t.records)
    return 100.0 * least / 1e3 / busy

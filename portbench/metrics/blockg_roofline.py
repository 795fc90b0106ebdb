"""blockg_roofline: the whole-block kernel's (K2, csrc/blockg.cu) share of
its roofline, in %: the frozen bound (bounds.block_bound) summed over the
window's blocks, over K2's summed device time."""

from portbench import bounds


def read(t):
    busy, calls = t.kernel_s("blockg_kernel")
    if not calls or calls != len(t.records):
        return None
    least = sum(bounds.block_bound(t.spec, t.state1, t.n_steps, a, b)
                for a, b in t.records)
    return 100.0 * least / 1e3 / busy

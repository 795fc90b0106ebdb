"""resync_roofline: the resync kernel's (K1, csrc/resync.cu: its synthesis
and its energy launch) share of its roofline, in %: the frozen bound
(bounds.resync_bound) summed over the window's blocks, over K1's summed
device time."""

from portbench import bounds


def read(t):
    busy, calls = t.kernel_s("resync_kernel", "resync_energy_kernel")
    if not calls:
        return None
    least = sum(bounds.resync_bound(t.spec, t.state1, b.n_mol)
                for _, b in t.records)
    return 100.0 * least / 1e3 / busy

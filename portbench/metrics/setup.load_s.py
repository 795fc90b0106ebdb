"""setup.load_s: seconds of the program's host set-up on the host clock,
synchronised: api.load_system (parse, Ewald, the build in float64 numpy,
the far table, to_device, the initial energy) and parallel/replicas.
replicate, as the driver ran them."""


def read(t):
    return sum(t.setup.values()) if t.setup else None

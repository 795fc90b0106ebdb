"""A frozen copy of maniac_tpu_torch's plain path: the threefry stream and
the plain MC step, for the replay of the judged block.

Copied from commit c8d5b755d87bdce149bdc4a95542cd5e6a434222 of this
repository: constants.py, geometry.py, ewald.py, system.py,
io/{deck,lammps_data,pair_coeffs}.py, physics/{energy,pbc,fwsplit}.py,
mc/moves.py and utils/{threefry,logger,errors}.py. Changed: functions that
nothing here calls are left out, the logger prints nothing, mc_step_u
takes the plain energy core where the program's dispatches to a kernel,
and _core_plain accepts a move when u_acc < p_acc, strictly, where the
program takes u_acc <= p_acc and so accepts a move of acceptance
probability 0 (an overlap, whose exp(-dE/T) underflows) whenever its f32
uniform is 0.0, one draw in 2^23. driver.py is new. It imports nothing of
the program and nothing of JAX; it parses the same generated files the
program is handed and builds its own tables from them. The energies and
structure factors that decide ``correct`` are judged by oracle.py, which
shares no code with this copy.
"""

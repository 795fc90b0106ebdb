"""One module a driver, found by the traffic mix's "driver".

A driver's ``Driver(ctx)`` sets the program up for the cell (load,
replicate) and runs one whole block of the cell's
entry a call of ``block(span)``, each call into a layer inside
``span(name)``. It keeps ``spec``, ``states`` (after the last block),
``pre`` (before it), ``u`` (the uniforms of the last block, (B, n_steps,
21)), ``loaded_energy`` (the loaded state's (6,) energy row), ``B``,
``n_steps``, ``end_of_block`` ("resync" or "refresh") and ``setup``
(seconds by part).
"""

"""
The benchmark's plain reference: float64 PyTorch written from the models'
definitions, with its own copy of the sdENM tables (``data/``).  It
imports nothing of the program and takes nothing that the program made:
it gets the float32 coordinates and residue annotations the benchmark
generated, and reads the program's outputs only to judge them.

A traffic mix names its reference module (``"reference"``), which the
route imports by that name from this package.  The module gives
``observables(coords, network, keys, options)``: the outputs named in
`keys` of the conformers `coords` ``(S, n, 3)``, float64 ``(S, ...)``,
for the springs `network` (``springs.Network``) and the traffic's
`options` of the program's call.
"""

"""The plain float32 reference of what the benchmark's window measures:
the networks (``layers`` and ``arch_*``), one trial's pruning and clipped
forward (``forward``), its hardware terms (``hardware``) and the numbers
that compare a candidate with it (``compare``). Imports nothing of the
program."""

"""The plain reference the benchmark judges the port against.

NumPy only: the GF(2^8) Cauchy Reed-Solomon code (``gf256``), the field
F_p with p = 2^31 - 1 (``m31``), threefry-2x32 and the audit protocol's
derivations (``threefry``), and the PoDR2 tag, proof and check
(``podr2``). It imports nothing of the program, and it is handed only
what the benchmark made from the seed (data, keys, fragment hashes) and
the program's outputs to judge.
"""

"""The plain reference of the benchmark's cells, in plain PyTorch.

It imports nothing of the program: the physics modules here are frozen
copies of the program's plain PyTorch ones, and ``engine.py`` computes
every TTI densely from the positions, with no incremental state, no row
index and no kernel.
"""

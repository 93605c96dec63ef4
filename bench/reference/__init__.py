"""The benchmark's plain reference: HPCG's operator, CG and MG-PCG on the
grid, in plain PyTorch, written from HPCG's description alone.

It imports neither JAX nor either package of this repository, and takes
nothing the program under test made: it is handed the grid and the
right-hand sides the harness made, and the program's outputs only to judge
them.
"""

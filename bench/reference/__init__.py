"""The plain reference of the benchmark: NumPy and plain PyTorch only.

It imports nothing of the program under test (and neither ``jax`` nor the
JAX package), and takes nothing the program has made: it works the
frequent itemsets, the rules and the recommendations out again from the
inputs the benchmark made.
"""

"""Plain NumPy/SciPy reference of the benchmark's problems. It imports
nothing of the solver under test."""

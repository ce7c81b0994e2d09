"""The least work of the benchmark's kernels, as functions of shapes only:
operations and bytes that the work needs whatever implements it, and the
published peaks of the card that turn them into a least time. Frozen
here, beside the benchmark, so that a change to the program cannot change
the yardstick."""

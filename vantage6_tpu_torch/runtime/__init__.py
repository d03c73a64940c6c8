"""The task plane: task and run records, the executor pool, the Federation."""

"""The harness behind ``benchmark/run.py``: finding a cell's files by name,
the measured window, the profiler's trace and the comparison that decides
``correct``. It imports nothing of the program; the drivers do."""

"""setup_s: from the start of the process to the start of the window:
imports, inputs, weights, the engine, the kernels' build or load and the
warm-up rounds."""


def read(win) -> float:
    return win.setup_s

"""round_ms: the wall time of all rounds completed in the window over
their count. The window runs until ``--seconds`` have passed, to the end
of the round that completes then."""


def read(win) -> float:
    return 1e3 * win.window_s / win.rounds

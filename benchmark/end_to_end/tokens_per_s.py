"""tokens_per_s: the tokens of all rounds completed in the window (every
station's sequences in full) over the window's wall time."""


def read(win) -> float:
    tokens = (win.config["federation"]["stations"] * win.traffic["batch"]
              * win.traffic["seq_len"])
    return tokens * win.rounds / win.window_s

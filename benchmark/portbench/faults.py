"""Planting a fault in the program, for the tests of the check and for
reading each fault's numbers on the card (``calibrate.py``); the
benchmark's own runs plant none."""


def patch(module, name: str, make):
    """Replace ``module.name`` by ``make(original)``; returns the function
    that puts the original back."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    return lambda: setattr(module, name, orig)

"""Columns of a station's frame as numpy arrays, without pandas.

A station's host data is any mapping of column name to a 1-D array: a
pandas DataFrame is one, a dict of numpy arrays another (pandas need
not be installed where the port runs). The JAX package's host partials call DataFrame
methods (``df[cols].to_numpy()``, ``.dropna()``); the port's go through
these helpers, which give the same arrays for both kinds of frame.
"""
from __future__ import annotations

from typing import Any

import numpy as np


def column(frame: Any, name: str, dtype: Any = None) -> np.ndarray:
    """One column as a 1-D array (in ``dtype`` when given)."""
    return np.asarray(frame[name], dtype)


def columns(frame: Any, names: list[str], dtype: Any) -> np.ndarray:
    """``[n, len(names)]`` array of the named columns in ``dtype``."""
    if not names:
        raise ValueError("at least one column is needed")
    return np.stack([column(frame, c, dtype) for c in names], axis=1)


def dropna(values: Any) -> np.ndarray:
    """The values that pandas' ``Series.dropna`` keeps: float NaN (and
    ``None`` in an object column) dropped."""
    v = np.asarray(values)
    if v.dtype.kind == "f":
        return v[~np.isnan(v)]
    if v.dtype.kind == "O":
        keep = [not (x is None or (isinstance(x, float) and x != x))
                for x in v]
        return v[np.asarray(keep, bool)]
    return v

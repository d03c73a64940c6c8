"""Session preprocessing tasks — the reference's v4.7 task-type ladder.

vantage6 4.7 splits session work into DATA EXTRACTION (source database →
session dataframe), PREPROCESSING (session dataframe → derived session
dataframe) and COMPUTE (session dataframe → aggregate). The extraction and
compute halves already exist here (node/runner.py `store_as` +
``type="session"`` databases); this module supplies the PREPROCESSING
step: declarative, station-local transformations whose RESULT persists as
a new session dataframe — raw rows still never travel.

The transform language is a small JSON pipeline (no eval/exec — a task
payload must not become remote code execution on a hospital node):

    [{"op": "select", "columns": [...]},
     {"op": "filter", "column": c, "cmp": "ge|gt|le|lt|eq|ne", "value": v},
     {"op": "dropna", "columns": [...]?},
     {"op": "rename", "mapping": {old: new}},
     {"op": "derive", "column": new, "expr": {"op": "add|sub|mul|div",
                                              "args": [colname-or-number,
                                                       colname-or-number]}},
     {"op": "astype", "column": c, "dtype": "float|int|str"},
     {"op": "clip", "column": c, "lower": a?, "upper": b?}]

Every station applies the same pipeline to its own frame; the node
persists the returned frame under the task's ``store_as`` handle and only
row counts + column metadata reach the server.

The port's copy of ``vantage6_tpu/workloads/preprocess.py``. pandas is
imported inside the functions, so the module imports where pandas is
missing; calling them there raises an error that names pandas. A station
frame that is a dict of columns is turned into a DataFrame first.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from vantage6_tpu_torch.algorithm.decorators import data

_CMPS = {
    "ge": lambda s, v: s >= v,
    "gt": lambda s, v: s > v,
    "le": lambda s, v: s <= v,
    "lt": lambda s, v: s < v,
    "eq": lambda s, v: s == v,
    "ne": lambda s, v: s != v,
}

_ARITH = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}

_DTYPES = {"float": np.float64, "int": np.int64, "str": str}


def _frame(df: Any) -> "pd.DataFrame":
    """``df`` as a pandas DataFrame (a dict of columns is converted);
    raises naming pandas when it is not installed."""
    try:
        import pandas as pd
    except ImportError as e:
        raise RuntimeError(
            "preprocessing needs pandas, which is not installed here"
        ) from e
    return df if isinstance(df, pd.DataFrame) else pd.DataFrame(dict(df))


def _column(df: pd.DataFrame, name: Any) -> pd.Series:
    """Column access with a diagnosis users can act on — a typo'd column
    must not surface as a 'missing field' KeyError."""
    if name not in df.columns:
        raise ValueError(f"unknown columns [{name!r}]")
    return df[name]


def _operand(df: pd.DataFrame, v: Any):
    """A derive() operand: a column name (string) or a literal number."""
    if isinstance(v, str):
        if v not in df.columns:
            raise ValueError(f"derive references unknown column {v!r}")
        return df[v]
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v
    raise ValueError(f"derive operand must be a column name or number: {v!r}")


def apply_pipeline(df: pd.DataFrame, steps: list[dict[str, Any]]) -> pd.DataFrame:
    """Apply the JSON pipeline; raises ValueError on any unknown op/column
    (a typo must fail the task, not silently pass data through)."""
    out = _frame(df)
    for i, step in enumerate(steps):
        op = step.get("op")
        try:
            if op == "select":
                missing = [c for c in step["columns"] if c not in out.columns]
                if missing:
                    raise ValueError(f"unknown columns {missing}")
                out = out[list(step["columns"])]
            elif op == "filter":
                if step["cmp"] not in _CMPS:
                    raise ValueError(f"unknown cmp {step['cmp']!r}")
                out = out[_CMPS[step["cmp"]](_column(out, step["column"]),
                                             step["value"])]
            elif op == "dropna":
                for c in step.get("columns") or []:
                    _column(out, c)
                out = out.dropna(subset=step.get("columns") or None)
            elif op == "rename":
                unknown = [
                    c for c in step["mapping"] if c not in out.columns
                ]
                if unknown:
                    raise ValueError(f"unknown columns {unknown}")
                out = out.rename(columns=dict(step["mapping"]))
            elif op == "derive":
                expr = step["expr"]
                if expr["op"] not in _ARITH:
                    raise ValueError(f"unknown derive op {expr['op']!r}")
                a, b = (_operand(out, v) for v in expr["args"])
                out = out.assign(**{str(step["column"]): _ARITH[expr["op"]](a, b)})
            elif op == "astype":
                if step["dtype"] not in _DTYPES:
                    raise ValueError(f"unknown dtype {step['dtype']!r}")
                _column(out, step["column"])
                out = out.astype({step["column"]: _DTYPES[step["dtype"]]})
            elif op == "clip":
                out = out.assign(**{
                    str(step["column"]): _column(out, step["column"]).clip(
                        step.get("lower"), step.get("upper")
                    )
                })
            else:
                raise ValueError(f"unknown op {op!r}")
        except KeyError as e:
            raise ValueError(
                f"pipeline step {i} ({op!r}) is missing field {e}"
            ) from None
        except ValueError as e:
            raise ValueError(f"pipeline step {i} ({op!r}): {e}") from None
    return out.reset_index(drop=True)


@data(1)
def preprocess(df: Any, steps: list[dict[str, Any]]) -> pd.DataFrame:
    """The preprocessing TASK: returns the transformed frame — submit with
    ``session=`` and ``store_as=`` so the node persists it as a session
    dataframe (only shape metadata reaches the server)."""
    return apply_pipeline(df, steps)


@data(1)
def column_summary(df: Any) -> dict[str, Any]:
    """Companion compute step: per-column dtype/count/mean — handy for
    checking a preprocessing result without pulling rows."""
    df = _frame(df)
    out = {}
    for c in df.columns:
        s = df[c]
        entry: dict[str, Any] = {
            "dtype": str(s.dtype),
            "count": int(s.count()),
        }
        if np.issubdtype(s.dtype, np.number):
            # count(), not len(): an all-NaN column must yield null, not a
            # bare NaN token that breaks strict JSON consumers
            entry["mean"] = float(s.mean()) if s.count() else None
        out[str(c)] = entry
    return out

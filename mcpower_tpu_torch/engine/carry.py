"""Carry a lowered design across from the JAX reference.

This system has no weights: what both packages must share to compute the
same counts is the static spec and the lowered arrays. :func:`from_reference`
turns a ``mcpower_tpu`` ``SimSpec`` (read through its dataclass fields, so
the reference package is never imported here) and its arrays dict into the
port's ``SimSpec`` and a dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from . import spec as _spec

# Reference dataclass name -> the port's class of the same fields.
_PORT_TYPES = {
    cls.__name__: cls
    for cls in (
        _spec.SimSpec,
        _spec.ScenarioStatic,
        _spec.SlopeStatic,
        _spec.ExtraGroupingStatic,
        _spec.ClusterStatic,
        _spec.PosthocStatic,
    )
}


def _convert(value):
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        name = type(value).__name__
        if name not in _PORT_TYPES:
            raise TypeError(f"no port counterpart for spec type {name!r}")
        cls = _PORT_TYPES[name]
        theirs = {f.name for f in dataclasses.fields(value)}
        ours = {f.name for f in dataclasses.fields(cls)}
        if theirs != ours:
            raise TypeError(
                f"{name}: fields differ from the port's "
                f"(only reference: {sorted(theirs - ours)}, only port: {sorted(ours - theirs)})"
            )
        return cls(**{f: _convert(getattr(value, f)) for f in ours})
    if isinstance(value, tuple):
        return tuple(_convert(v) for v in value)
    return value


def from_reference(spec, arrays: Dict) -> Tuple[_spec.SimSpec, Dict[str, np.ndarray]]:
    """The port's ``(SimSpec, arrays)`` for a reference ``(spec, arrays)``.

    ``arrays`` values may be numpy arrays or anything ``np.asarray`` takes;
    dtypes are kept.
    """
    return _convert(spec), {k: np.asarray(v) for k, v in arrays.items()}

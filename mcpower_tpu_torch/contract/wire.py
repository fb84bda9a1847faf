"""Binary wire format for contracts: msgpack, the reference's FFI encoding.

The reference ships contracts across its Python/R FFI as msgpack bytes
(crates/engine-py/src/lib.rs:38-120 takes ``contracts_bytes``; JSON only on
the wasm boundary). This module is the same boundary for this engine: a
label-free ``SimulationContract`` round-trips through ``pack``/``unpack``
with additive-evolution semantics (unknown keys ignored, missing keys
defaulted — the serde-default behavior of contract.rs:13-15).

The port's CLI host, which will prove the L1 contract boundary from outside
the Python API, is ROADMAP A15; nothing on the ``MCPower`` path needs this
module.
"""

from __future__ import annotations

from typing import List, Union

from .types import SimulationContract

try:  # baked into the image; gate for minimal installs
    import msgpack as _msgpack
except ImportError:  # pragma: no cover
    _msgpack = None


def _require_msgpack():
    if _msgpack is None:  # pragma: no cover
        raise RuntimeError(
            "the binary contract wire needs the 'msgpack' package; "
            "use JSON (SimulationContract.to_json) instead"
        )


def pack(contract: SimulationContract) -> bytes:
    """Contract -> canonical msgpack bytes."""
    _require_msgpack()
    return _msgpack.packb(contract.to_dict(), use_bin_type=True)


def unpack(data: bytes) -> SimulationContract:
    """msgpack bytes -> contract (additive evolution: extra keys ignored)."""
    _require_msgpack()
    d = _msgpack.unpackb(data, raw=False, strict_map_key=False)
    if not isinstance(d, dict):
        raise ValueError("wire payload must decode to a contract map")
    return SimulationContract.from_dict(d)


def pack_many(contracts: List[SimulationContract]) -> bytes:
    """Scenario batch -> one msgpack array (the FFI's find_power shape)."""
    _require_msgpack()
    return _msgpack.packb(
        [c.to_dict() for c in contracts], use_bin_type=True
    )


def unpack_many(data: bytes) -> List[SimulationContract]:
    _require_msgpack()
    arr = _msgpack.unpackb(data, raw=False, strict_map_key=False)
    if isinstance(arr, dict):
        arr = [arr]
    return [SimulationContract.from_dict(d) for d in arr]


def load(path: str) -> List[SimulationContract]:
    """Read contracts from a .msgpack/.mp or .json file by extension."""
    if path.endswith(".json"):
        import json

        with open(path, "r") as f:
            payload = json.load(f)
        if isinstance(payload, dict):
            payload = [payload]
        return [SimulationContract.from_dict(d) for d in payload]
    with open(path, "rb") as f:
        return unpack_many(f.read())


def dump(contracts: Union[SimulationContract, List[SimulationContract]], path: str) -> None:
    if isinstance(contracts, SimulationContract):
        contracts = [contracts]
    if path.endswith(".json"):
        import json

        with open(path, "w") as f:
            json.dump([c.to_dict() for c in contracts], f)
        return
    with open(path, "wb") as f:
        f.write(pack_many(contracts))

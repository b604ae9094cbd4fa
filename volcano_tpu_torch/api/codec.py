"""JSON codec for API objects crossing the wire boundary.

The control plane splits into separate OS processes (state server,
scheduler, controller manager, agents) that exchange CRD-analogue
objects over HTTP/JSON — the stand-in for the reference's apiserver
serialization (staging/src/volcano.sh/apis generated deepcopy/JSON
round-trip).  Rather than hand-writing marshal functions per type, the
codec reflects over the dataclass/enum registry:

  dataclass  -> {"#T": "ClassName", "f": {field: value...}}
  Enum       -> {"#E": ["EnumName", value]}
  Resource   -> {"#R": {dim: amount}}
  plain dict -> passed through ({"#D": {...}} wrapper only if a key
                collides with a tag)
  list/tuple -> list

Decoding tolerates missing/extra fields (forward/backward compat the
way k8s JSON does): unknown keys are dropped, absent ones take the
dataclass default.

Hot-path discipline (the wire fast lane): the control plane ships
pods/podgroups by the thousand through /snapshot, /watch and /delta,
so encode() runs off a per-class PLAN built once — interned type/field
name strings (every payload shares the same key objects instead of
re-allocating "annotations" 5k times per snapshot) and the field's
declared default.  Fields still equal to their default are elided from
the wire body entirely; decode() fills them back from the dataclass
default, which the compat contract above already guarantees.  A
default-shaped pod encodes to a handful of keys instead of ~30.

COROLLARY: a dataclass field's declared default is now part of the
wire contract.  Changing a default between versions was ALWAYS
decode-visible for absent fields; elision widens that to fields the
sender holds at its (old) default — so treat a default change on a
registered wire type as a breaking wire change and ship it as a new
field instead.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import sys
from typing import Any, Dict, Tuple

_TAGS = ("#T", "#E", "#R", "#D")

_CLASSES: Dict[str, type] = {}
_ENUMS: Dict[str, type] = {}
_FIELDS: Dict[str, frozenset] = {}
# cls -> (interned name, ((interned field name, default | _MISSING), ...))
# built lazily per class on first encode; default_factory fields get ONE
# sample value (compared against, never handed out) and only when the
# factory yields an empty builtin container or an immutable scalar —
# anything richer (random uids, Resource objects) never elides
_ENC_PLANS: Dict[type, Tuple[str, tuple]] = {}
_MISSING = dataclasses.MISSING
_built = False


def register_class(cls: type) -> type:
    """Register a dataclass or Enum for wire round-trips."""
    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        _ENUMS[cls.__name__] = cls
    elif dataclasses.is_dataclass(cls):
        _CLASSES[cls.__name__] = cls
        _FIELDS[cls.__name__] = frozenset(
            f.name for f in dataclasses.fields(cls))
    return cls


def _scan(module) -> None:
    for obj in vars(module).values():
        if isinstance(obj, type) and (
                dataclasses.is_dataclass(obj)
                or issubclass(obj, enum.Enum)):
            register_class(obj)


def _build_registry() -> None:
    """Import every module holding wire types and index them.

    Lazy so that importing the codec never drags the controller stack
    into processes that only need the API layer.
    """
    global _built
    if _built:
        return
    from volcano_tpu_torch.api import (goodput, hypernode, jobflow, netusage,
                                 node_info, numatopology, pod, podgroup,
                                 queue, serving, shard, slicehealth,
                                 types, vcjob)
    from volcano_tpu_torch.cache import cluster as cluster_mod
    from volcano_tpu_torch.controllers import cronjob, hyperjob
    for mod in (types, pod, node_info, podgroup, queue, hypernode,
                vcjob, jobflow, netusage, goodput, serving,
                numatopology, shard, slicehealth, cluster_mod, cronjob,
                hyperjob):
        _scan(mod)
    _built = True


def _enc_plan(cls: type) -> Tuple[str, tuple]:
    plan = _ENC_PLANS.get(cls)
    if plan is not None:
        return plan
    _build_registry()
    name = cls.__name__
    if name not in _CLASSES:
        register_class(cls)
    entries = []
    for f in dataclasses.fields(cls):
        default = _MISSING
        if f.default is not _MISSING:
            default = f.default
        elif f.default_factory is not _MISSING:
            sample = f.default_factory()
            # only an EMPTY builtin container is a safe elision
            # anchor for a factory: a factory returning scalars is
            # typically non-deterministic (new_uid, time.time) — its
            # one sampled value must never stand in as "the default",
            # or a value colliding with the sample would decode to a
            # freshly generated DIFFERENT one on the receiver
            if type(sample) in (dict, list, set, tuple) and not sample:
                default = sample
        entries.append((sys.intern(f.name), default))
    plan = (sys.intern(name), tuple(entries))
    _ENC_PLANS[cls] = plan
    return plan


def _is_default(v: Any, default: Any) -> bool:
    if v is default:
        return True
    # exact type match guards bool-vs-int (True == 1) and subclasses
    # whose equality lies about payload differences
    if type(v) is not type(default):
        return False
    try:
        return bool(v == default)
    except Exception:  # noqa: BLE001 — exotic __eq__: never elide
        return False


def encode(obj: Any) -> Any:
    """Encode an API object into JSON-serializable data."""
    from volcano_tpu_torch.api.resource import Resource
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Resource):
        return {"#R": dict(obj.res)}
    if isinstance(obj, enum.Enum):
        return {"#E": [type(obj).__name__, obj.value]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name, entries = _enc_plan(type(obj))
        fields = {}
        for fname, default in entries:
            v = getattr(obj, fname)
            if default is not _MISSING and _is_default(v, default):
                continue        # decode() restores it from the default
            fields[fname] = encode(v)
        return {"#T": name, "f": fields}
    if isinstance(obj, dict):
        out = {str(k): encode(v) for k, v in obj.items()}
        if any(t in out for t in _TAGS):
            return {"#D": out}
        return out
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [encode(v) for v in obj]
    raise TypeError(f"codec: cannot encode {type(obj).__name__}: {obj!r}")


def decode(data: Any) -> Any:
    """Decode JSON data produced by :func:`encode`."""
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return [decode(v) for v in data]
    if isinstance(data, dict):
        if "#R" in data and len(data) == 1:
            from volcano_tpu_torch.api.resource import Resource
            return Resource(data["#R"])
        if "#E" in data and len(data) == 1:
            _build_registry()
            name, value = data["#E"]
            cls = _ENUMS.get(name)
            if cls is None:
                raise KeyError(f"codec: unknown enum {name!r}")
            return cls(value)
        if "#T" in data:
            _build_registry()
            name = data["#T"]
            cls = _CLASSES.get(name)
            if cls is None:
                raise KeyError(f"codec: unknown class {name!r}")
            known = _FIELDS[name]
            kwargs = {k: decode(v) for k, v in data.get("f", {}).items()
                      if k in known}
            return cls(**kwargs)
        if "#D" in data and len(data) == 1:
            return {k: decode(v) for k, v in data["#D"].items()}
        return {k: decode(v) for k, v in data.items()}
    raise TypeError(f"codec: cannot decode {type(data).__name__}")


def dumps(obj: Any) -> str:
    return json.dumps(encode(obj), separators=(",", ":"))


def loads(text: str) -> Any:
    return decode(json.loads(text))

"""Multi-dimensional resource vectors.

Reference parity: pkg/scheduler/api/resource_info.go (Resource with
MilliCPU/Memory/ScalarResources).  Rebuilt as a single flat mapping of
resource-name -> float; CPU is counted in millicores and memory in bytes
to match the reference's accounting conventions, and GPUs live in the
same mapping under ``nvidia.com/gpu`` (the NVIDIA device plugin's
resource) so every fair-share / fit / preemption computation treats
GPUs exactly like any other dimension.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

CPU = "cpu"          # millicores
MEMORY = "memory"    # bytes
PODS = "pods"        # pod-count capacity
GPU = "nvidia.com/gpu"  # GPUs (NVIDIA device plugin)

# Comparison slack: resource quantities are floats; mirror the reference's
# minResource epsilon (resource_info.go minResource = 0.1).
MIN_RESOURCE = 0.1

_UNITS = {
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}
_SORTED_UNITS = sorted(_UNITS.items(), key=lambda kv: -len(kv[0]))


def parse_quantity(value) -> float:
    """Parse a k8s-style quantity ("250m", "4Gi", 2) into a float.

    CPU "m" suffix means millicores; callers decide whether the dimension
    is milli-scaled (see :func:`parse_cpu`).
    """
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if not s:
        return 0.0
    for suffix, mult in _SORTED_UNITS:
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    return float(s)


def parse_cpu(value) -> float:
    """Parse CPU quantity into millicores ("250m" -> 250, "2" -> 2000)."""
    if isinstance(value, (int, float)):
        return float(value) * 1000.0
    s = str(value).strip()
    if s.endswith("m"):
        return float(s[:-1])
    return parse_quantity(s) * 1000.0


class Resource:
    """A resource vector: {resource-name: amount}.

    Zero-valued dimensions are dropped eagerly so emptiness checks and
    iteration stay O(active dimensions).
    """

    __slots__ = ("res",)

    def __init__(self, res: Optional[Mapping[str, float]] = None):
        self.res: Dict[str, float] = {}
        if res:
            for name, value in res.items():
                if value:
                    self.res[name] = float(value)

    # -- constructors -------------------------------------------------

    @classmethod
    def from_resource_list(cls, rl: Mapping[str, object]) -> "Resource":
        """Build from a k8s-style resource list with string quantities.

        e.g. {"cpu": "250m", "memory": "1Gi", "nvidia.com/gpu": 8}.
        """
        r = cls()
        for name, value in rl.items():
            if name == CPU:
                r.res[CPU] = parse_cpu(value)
            else:
                r.res[name] = parse_quantity(value)
            if not r.res[name]:
                del r.res[name]
        return r

    def clone(self) -> "Resource":
        c = Resource.__new__(Resource)
        c.res = dict(self.res)
        return c

    @classmethod
    def empty(cls) -> "Resource":
        return cls()

    # -- accessors ----------------------------------------------------

    def get(self, name: str) -> float:
        return self.res.get(name, 0.0)

    @property
    def milli_cpu(self) -> float:
        return self.res.get(CPU, 0.0)

    @property
    def memory(self) -> float:
        return self.res.get(MEMORY, 0.0)

    @property
    def gpu(self) -> float:
        return self.res.get(GPU, 0.0)

    def resource_names(self) -> List[str]:
        return list(self.res.keys())

    def is_empty(self) -> bool:
        return all(v < MIN_RESOURCE for v in self.res.values())

    def is_zero(self, name: str) -> bool:
        return self.res.get(name, 0.0) < MIN_RESOURCE

    # -- arithmetic (in place, returning self — matches reference style)

    def add(self, other: "Resource") -> "Resource":
        for name, value in other.res.items():
            self.res[name] = self.res.get(name, 0.0) + value
        return self

    def sub(self, other: "Resource") -> "Resource":
        """Subtract; raises if other is not <= self (reference panics)."""
        if not other.less_equal(self):
            raise ValueError(f"resource underflow: {other} > {self}")
        return self.sub_unchecked(other)

    def sub_unchecked(self, other: "Resource") -> "Resource":
        """Subtract clamping at zero (reference sub without assert)."""
        for name, value in other.res.items():
            left = self.res.get(name, 0.0) - value
            if left > 0:
                self.res[name] = left
            else:
                self.res.pop(name, None)
        return self

    def multi(self, ratio: float) -> "Resource":
        for name in list(self.res):
            self.res[name] *= ratio
        return self

    def set_max(self, other: "Resource") -> "Resource":
        """Per-dimension max (reference SetMaxResource)."""
        for name, value in other.res.items():
            if value > self.res.get(name, 0.0):
                self.res[name] = value
        return self

    def min_dim(self, other: "Resource") -> "Resource":
        """Per-dimension min over the union of dimensions."""
        for name in list(self.res):
            self.res[name] = min(self.res[name], other.res.get(name, 0.0))
            if not self.res[name]:
                del self.res[name]
        return self

    # -- comparisons --------------------------------------------------

    def less_equal(self, other: "Resource", zero: str = "defaultZero") -> bool:
        """self <= other per dimension.

        zero="defaultZero": dimensions missing from *other* are treated as
        zero (strict).  zero="defaultInfinity": dimensions missing from
        *other* are unconstrained — used for queue capability checks where
        an unset capability means unlimited (resource_info.go LessEqual
        with defaultValue semantics).
        """
        for name, value in self.res.items():
            if name not in other.res:
                if zero == "defaultInfinity":
                    continue
                if value >= MIN_RESOURCE:
                    return False
            elif value > other.res[name] + MIN_RESOURCE:
                return False
        return True

    def less_equal_strict(self, other: "Resource") -> bool:
        return self.less_equal(other, zero="defaultZero")

    def less_partly(self, other: "Resource") -> bool:
        """True if ANY dimension of self < the same dimension of other."""
        for name, value in other.res.items():
            if self.res.get(name, 0.0) < value - MIN_RESOURCE:
                return True
        return False

    def less_equal_with_dimensions(self, other: "Resource",
                                   dims: Iterable[str]) -> bool:
        return all(self.res.get(d, 0.0) <= other.res.get(d, 0.0) + MIN_RESOURCE
                   for d in dims)

    def diff(self, other: "Resource") -> ("Resource", "Resource"):
        """Return (increased, decreased) per-dimension deltas."""
        inc, dec = Resource(), Resource()
        for name in set(self.res) | set(other.res):
            d = self.res.get(name, 0.0) - other.res.get(name, 0.0)
            if d > 0:
                inc.res[name] = d
            elif d < 0:
                dec.res[name] = -d
        return inc, dec

    def fit_delta(self, req: "Resource") -> "Resource":
        """Dimensions in which *req* does not fit into self (for FitError)."""
        missing = Resource()
        for name, value in req.res.items():
            have = self.res.get(name, 0.0)
            if value > have + MIN_RESOURCE:
                missing.res[name] = value - have
        return missing

    def equal(self, other: "Resource") -> bool:
        for name in set(self.res) | set(other.res):
            if abs(self.res.get(name, 0.0) - other.res.get(name, 0.0)) >= MIN_RESOURCE:
                return False
        return True

    # -- python protocol ----------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, Resource) and self.equal(other)

    def __hash__(self):  # resources are mutable; identity hash
        return id(self)

    def __repr__(self) -> str:
        parts = ", ".join(f"{k}={v:g}" for k, v in sorted(self.res.items()))
        return f"Resource({parts})"

    def to_dict(self) -> Dict[str, float]:
        return dict(self.res)

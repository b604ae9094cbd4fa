"""NUMA topology-manager policy framework — hints, merge, admit.

Reference parity: plugins/numaaware/policy/{policy,policy_best_effort,
policy_restricted,policy_single_numa_node}.go + the kubelet
TopologyManager semantics they embed:

  * each RESOURCE contributes TopologyHints — cell subsets that can
    satisfy its request, with `preferred` marking minimal-width
    subsets (a resource that fits one NUMA node prefers exactly one);
  * the policy MERGES per-resource hints by cross-product: intersect
    the masks, AND the preferred flags, keep the narrowest viable
    result (mergeFilteredHints);
  * admission is the only thing policies disagree on:
      none             — always admit, no hint computed
      best-effort      — always admit, hint guides placement/scoring
      restricted       — admit only a PREFERRED merged hint (every
                         resource at its minimal width)
      single-numa-node — admit only a preferred 1-cell merged hint

The numaaware plugin turns free/capacity cell vectors into per-
resource hints and asks the policy; this module is pure set math so
the reference's policy tests translate directly (test_numa_policy).
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Optional, Sequence, Tuple

from volcano_tpu_torch.api.numatopology import (
    POLICY_BEST_EFFORT,
    POLICY_NONE,
    POLICY_RESTRICTED,
    POLICY_SINGLE_NUMA,
)


class TopologyHint:
    """mask: frozenset of cell indices (None = no preference / any);
    preferred: the mask is minimal-width for its resource."""

    __slots__ = ("mask", "preferred")

    def __init__(self, mask: Optional[frozenset], preferred: bool):
        self.mask = mask
        self.preferred = preferred

    def __repr__(self):
        cells = sorted(self.mask) if self.mask is not None else "any"
        return f"Hint({cells}, preferred={self.preferred})"

    def __eq__(self, other):
        return (isinstance(other, TopologyHint)
                and self.mask == other.mask
                and self.preferred == other.preferred)


def resource_hints(free: Sequence[float], need: float,
                   max_width: int = 4) -> List[TopologyHint]:
    """Hints for ONE resource: every cell subset (width <= max_width)
    whose summed free amount satisfies `need`; preferred = subsets at
    the MINIMAL satisfying width (kubelet cpumanager hint semantics).
    need <= 0 -> no preference ([{None, True}]); no subset satisfies
    -> [] (merge turns that into an unpreferred deny)."""
    if need <= 0:
        return [TopologyHint(None, True)]
    n = len(free)
    hints: List[TopologyHint] = []
    min_width = None
    for width in range(1, min(n, max_width) + 1):
        for combo in combinations(range(n), width):
            if sum(free[i] for i in combo) >= need:
                if min_width is None:
                    min_width = width
                hints.append(TopologyHint(frozenset(combo),
                                          width == min_width))
    return hints


def merge_hints(n_cells: int,
                providers: Sequence[Sequence[TopologyHint]],
                validate=None) -> TopologyHint:
    """Cross-product merge (mergeFilteredHints): intersect masks, AND
    preferred flags; narrowest mask wins, preferred beating
    unpreferred at any width.  A provider with NO viable hints
    contributes {any, unpreferred} — the merge can then never be
    preferred (filterProvidersHints).

    validate(mask) -> bool, when given, drops merged candidates whose
    intersection no longer SATISFIES every resource: a raw AND can
    shrink below a provider's requirement (cpu's {0} ∩ chips' {0,1} =
    {0}, where the chips don't fit) — admitting that mask would pass
    single-numa pods the kubelet must then reject at allocation."""
    default = frozenset(range(n_cells))
    norm: List[List[TopologyHint]] = []
    for hints in providers:
        if not hints:
            norm.append([TopologyHint(None, False)])
        else:
            norm.append(list(hints))
    best = TopologyHint(default, False)
    best_found = False

    def consider(mask: frozenset, preferred: bool):
        nonlocal best, best_found
        cand = TopologyHint(mask, preferred)
        if not best_found:
            best, best_found = cand, True
            return
        if cand.preferred and not best.preferred:
            best = cand
        elif cand.preferred == best.preferred and \
                len(cand.mask) < len(best.mask):
            best = cand

    def walk(i: int, mask: frozenset, preferred: bool):
        if i == len(norm):
            if mask and (validate is None or validate(mask)):
                consider(mask, preferred)
            return
        for h in norm[i]:
            hmask = default if h.mask is None else h.mask
            walk(i + 1, mask & hmask, preferred and h.preferred)

    walk(0, default, True)
    if not best_found:
        return TopologyHint(default, False)
    return best


def admit(policy: str, hint: TopologyHint) -> bool:
    """canAdmitPodResult per policy."""
    if policy in (POLICY_NONE, POLICY_BEST_EFFORT):
        return True
    if policy == POLICY_RESTRICTED:
        return hint.preferred
    if policy == POLICY_SINGLE_NUMA:
        return hint.preferred and hint.mask is not None \
            and len(hint.mask) == 1
    return True


def merged_hint_for(cells: Sequence[Sequence[float]],
                    needs: Sequence[float],
                    max_width: int = 4
                    ) -> Tuple[TopologyHint, bool]:
    """Convenience: cells[i] = per-cell free vector (one entry per
    resource), needs = per-resource request.  Returns (merged hint,
    all_viable) — the second is False when some resource has NO
    satisfying subset at all.

    The merged mask is the narrowest cell set satisfying EVERY
    resource (satisfiability-validated, unlike the raw kubelet AND
    which can under-cover a provider).  `preferred` means the mask
    hits the theoretical lower bound max_r(min_width_r): every
    resource is as aligned as it could ever be, SIMULTANEOUSLY.  A
    pod whose cpu could fit one cell but whose chips only exist on
    another cell merges to an UNPREFERRED pair — the resources are
    not co-located, which is exactly what restricted polices."""
    n = len(cells)
    providers = []
    all_viable = True
    lower_bound = 0
    for r, need in enumerate(needs):
        hints = resource_hints([cells[i][r] for i in range(n)], need,
                               max_width=max_width)
        if not hints:
            all_viable = False
        elif need > 0:
            min_w = min(len(h.mask) for h in hints
                        if h.mask is not None)
            lower_bound = max(lower_bound, min_w)
        providers.append(hints)

    def satisfies(mask: frozenset) -> bool:
        return all(sum(cells[i][r] for i in mask) >= need
                   for r, need in enumerate(needs))

    merged = merge_hints(n, providers, validate=satisfies)
    if all_viable and merged.mask is not None and lower_bound > 0:
        merged = TopologyHint(merged.mask,
                              len(merged.mask) == lower_bound)
    return merged, all_viable

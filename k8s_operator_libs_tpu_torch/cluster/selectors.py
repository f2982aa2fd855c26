"""Kubernetes label-selector string parsing and matching.

The reference passes selector strings through to the API server
(``labels.Parse`` semantics — used for DrainSpec.PodSelector,
WaitForCompletionSpec.PodSelector, validation pod selectors).  We implement
the equality-based and set-based grammar:

    "a=b", "a==b", "a!=b", "a in (x,y)", "a notin (x,y)", "a" (exists),
    "!a" (not exists), comma-joined conjunction.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping

_IN_RE = re.compile(r"^\s*([\w./-]+)\s+(in|notin)\s+\(([^)]*)\)\s*$")
_EQ_RE = re.compile(r"^\s*([\w./-]+)\s*(==|=|!=)\s*([\w./-]*)\s*$")
_EXISTS_RE = re.compile(r"^\s*(!?)\s*([\w./-]+)\s*$")

Matcher = Callable[[Mapping[str, str]], bool]


class SelectorParseError(ValueError):
    pass


def _split_requirements(selector: str) -> List[str]:
    """Split on commas that are not inside an ``in (...)`` value set."""
    parts: List[str] = []
    depth = 0
    cur = ""
    for ch in selector:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    return parts


def parse_selector(selector: str) -> Matcher:
    """Compile a selector string into a predicate over a labels mapping.

    An empty selector matches everything (k8s ``labels.Everything()``).
    """
    selector = (selector or "").strip()
    if not selector:
        return lambda labels: True

    requirements: List[Matcher] = []
    for req in _split_requirements(selector):
        m = _IN_RE.match(req)
        if m:
            key, op, vals = m.group(1), m.group(2), m.group(3)
            values = {v.strip() for v in vals.split(",") if v.strip()}
            if op == "in":
                requirements.append(
                    lambda labels, k=key, vs=values: labels.get(k) in vs
                )
            else:
                requirements.append(
                    lambda labels, k=key, vs=values: k in labels
                    and labels.get(k) not in vs
                )
            continue
        m = _EQ_RE.match(req)
        if m:
            key, op, val = m.group(1), m.group(2), m.group(3)
            if op in ("=", "=="):
                requirements.append(lambda labels, k=key, v=val: labels.get(k) == v)
            else:
                requirements.append(lambda labels, k=key, v=val: labels.get(k) != v)
            continue
        m = _EXISTS_RE.match(req)
        if m:
            neg, key = m.group(1), m.group(2)
            if neg:
                requirements.append(lambda labels, k=key: k not in labels)
            else:
                requirements.append(lambda labels, k=key: k in labels)
            continue
        raise SelectorParseError(f"cannot parse selector requirement {req!r}")

    return lambda labels: all(r(labels) for r in requirements)


def matches(selector: str, labels: Mapping[str, str] | None) -> bool:
    return parse_selector(selector)(labels or {})


def example_labels(selector: str) -> "Dict[str, str] | None":
    """A minimal label set satisfying *selector*, or None when no such
    set can be synthesized (conflicting or unparsable requirements).
    Used by simulations that must CREATE objects a selector will match
    — e.g. the plan sandbox synthesizing validation pods — so the one
    selector grammar serves both matching and generation."""
    selector = (selector or "").strip()
    # Two-phase: collect per-key constraints first, then solve — a greedy
    # single pass mis-assigned 'a=c,a in (b,c)' (overwrote c with b) and
    # 'a in (b,c),a notin (b)' (kept the excluded b).
    equals: Dict[str, str] = {}
    in_sets: Dict[str, List[str]] = {}
    notin_sets: Dict[str, set] = {}
    must_exist: List[str] = []
    if selector:
        for req in _split_requirements(selector):
            m = _IN_RE.match(req)
            if m:
                key, op, vals = m.group(1), m.group(2), m.group(3)
                values = [v.strip() for v in vals.split(",") if v.strip()]
                if op == "in":
                    if not values:
                        return None
                    in_sets.setdefault(key, [])
                    # conjunction of in-sets: intersect
                    if in_sets[key]:
                        in_sets[key] = [
                            v for v in in_sets[key] if v in values
                        ]
                        if not in_sets[key]:
                            return None
                    else:
                        in_sets[key] = list(values)
                else:
                    notin_sets.setdefault(key, set()).update(values)
                continue
            m = _EQ_RE.match(req)
            if m:
                key, op, val = m.group(1), m.group(2), m.group(3)
                if op in ("=", "=="):
                    if key in equals and equals[key] != val:
                        return None
                    equals[key] = val
                # "!=" is satisfied by absence; add nothing
                continue
            m = _EXISTS_RE.match(req)
            if m:
                if not m.group(1):
                    must_exist.append(m.group(2))
                # "!a" is satisfied by absence
                continue
            return None
    labels: Dict[str, str] = dict(equals)
    for key, allowed in in_sets.items():
        if key in labels:
            if labels[key] not in allowed:
                return None
        else:
            excluded = notin_sets.get(key, set())
            pick = next((v for v in allowed if v not in excluded), None)
            if pick is None:
                return None
            labels[key] = pick
    for key, excluded in notin_sets.items():
        if key in labels:
            if labels[key] in excluded:
                return None
        else:
            candidate = "synthesized"
            while candidate in excluded:
                candidate += "-x"
            labels[key] = candidate
    for key in must_exist:
        labels.setdefault(key, "synthesized")
    # residual conflicts (a=b,!a) fail this final check
    try:
        return labels if parse_selector(selector)(labels) else None
    except SelectorParseError:
        return None


def labels_to_selector(labels: Dict[str, str]) -> str:
    """Reference: labels.SelectorFromSet — exact-match conjunction."""
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def match_label_selector(selector: Mapping | None, labels: Mapping[str, str] | None) -> bool:
    """Match a Kubernetes ``LabelSelector`` OBJECT (``matchLabels`` +
    ``matchExpressions``) against a labels map — the selector form PDBs,
    DaemonSets and Deployments carry in their specs
    (metav1.LabelSelectorAsSelector semantics).

    * ``matchLabels`` and ``matchExpressions`` requirements are ANDed;
    * operators: ``In``, ``NotIn``, ``Exists``, ``DoesNotExist``;
    * a MISSING selector (``None``) matches nothing, while an EMPTY
      selector object (``{}``, no requirements) matches everything —
      the policy/v1 apiserver contract for PDB-style specs.

    Raises :class:`SelectorParseError` on an unknown operator, so a
    malformed PDB fails loudly instead of silently protecting nothing.
    """
    if selector is None:
        return False
    labels = labels or {}
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for req in selector.get("matchExpressions") or []:
        key = req.get("key")
        op = req.get("operator")
        values = req.get("values") or []
        if op == "In":
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if key in labels and labels[key] in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            raise SelectorParseError(
                f"unknown matchExpressions operator {op!r} for key {key!r}"
            )
    return True

"""IntOrString — the Kubernetes int-or-percent union type.

Reference parity: the reference's ``MaxUnavailable`` field is a
``k8s.io/apimachinery/pkg/util/intstr.IntOrString`` resolved via
``intstr.GetScaledValueFromIntOrPercent`` (``pkg/upgrade/upgrade_inplace.go:54-60``).
This module reimplements the same semantics: an int is used as-is, a string
must be of the form ``"<n>%"`` and is scaled against a total.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Union

_PERCENT_RE = re.compile(r"^(\d+)%$")


@dataclass(frozen=True)
class IntOrString:
    """Either an absolute integer or a percentage string like ``"25%"``."""

    value: Union[int, str]

    def __post_init__(self) -> None:
        if isinstance(self.value, bool) or not isinstance(self.value, (int, str)):
            raise TypeError(f"IntOrString takes int or str, got {type(self.value)}")
        if isinstance(self.value, str) and not _PERCENT_RE.match(self.value):
            raise ValueError(
                f"string IntOrString must look like '25%', got {self.value!r}"
            )

    @property
    def is_percent(self) -> bool:
        return isinstance(self.value, str)

    def scaled_value(self, total: int, round_up: bool = True) -> int:
        """Resolve against *total*.

        Mirrors ``intstr.GetScaledValueFromIntOrPercent``: ints pass
        through; percentages scale ``total`` with round-up (the reference
        passes ``roundUp=true`` at upgrade_inplace.go:56).
        """
        if isinstance(self.value, int):
            return self.value
        pct = int(_PERCENT_RE.match(self.value).group(1))  # type: ignore[union-attr]
        scaled = total * pct / 100.0
        return math.ceil(scaled) if round_up else math.floor(scaled)

    @classmethod
    def parse(cls, raw: Union[int, str, "IntOrString", None]) -> "IntOrString | None":
        if raw is None or isinstance(raw, IntOrString):
            return raw
        return cls(raw)

    def to_raw(self) -> Union[int, str]:
        return self.value

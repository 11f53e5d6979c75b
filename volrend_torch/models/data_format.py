"""Leaf data formats: RGBA / SH / SG / ASG.

Same surface as the reference ``include/volrend/data_format.hpp`` +
``src/n3tree.cpp:55-101`` (parse strings like ``"SH16"``; legacy files with no
format key auto-infer SH order from data_dim).
"""

from __future__ import annotations

import dataclasses
import enum


class BasisType(enum.IntEnum):
    RGBA = 0
    SH = 1
    SG = 2
    ASG = 3


@dataclasses.dataclass(frozen=True)
class DataFormat:
    format: BasisType = BasisType.RGBA
    #: basis functions per color channel; -1 for plain RGBA
    basis_dim: int = -1

    @staticmethod
    def parse(s: str) -> "DataFormat":
        """Parse strings like 'SH16', 'SG25', 'ASG8', 'RGBA'."""
        nonalpha = next((i for i, c in enumerate(s) if not c.isalpha()), None)
        if nonalpha is not None:
            basis_dim = int(s[nonalpha:] or -1)
            name = s[:nonalpha]
            fmt = {"ASG": BasisType.ASG, "SG": BasisType.SG,
                   "SH": BasisType.SH}.get(name, BasisType.RGBA)
            return DataFormat(fmt, basis_dim)
        return DataFormat(BasisType.RGBA, -1)

    def to_string(self) -> str:
        out = self.format.name
        if self.basis_dim != -1:
            out += str(self.basis_dim)
        return out

    def __str__(self) -> str:  # pragma: no cover
        return self.to_string()

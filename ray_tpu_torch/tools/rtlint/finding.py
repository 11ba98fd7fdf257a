"""Finding record + stable fingerprints for the baseline ratchet."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``fingerprint`` deliberately excludes the line number: baselined
    sites must survive unrelated edits above them.  It includes the
    enclosing symbol (qualified function/class name) and the message
    core, so two distinct violations in one function of the same shape
    are distinguished by ``detail`` (rule-chosen discriminator, e.g.
    the blocked call and the held lock).
    """

    rule: str           # "W1".."W4"
    path: str           # repo-relative, forward slashes
    line: int           # 1-based, for humans; NOT part of the fingerprint
    symbol: str         # enclosing qualname ("Class.method", "<module>")
    message: str        # one-line human description
    hint: str = ""      # one-line fix suggestion
    detail: str = ""    # fingerprint discriminator (defaults to message)

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.detail or self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "hint": self.hint,
            "fingerprint": self.fingerprint,
        }

    def format_text(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{loc}: {self.rule} [{self.symbol}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


def sort_key(f: Finding) -> tuple:
    return (f.path, f.line, f.rule, f.detail or f.message)

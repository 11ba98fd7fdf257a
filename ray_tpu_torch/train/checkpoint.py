"""Checkpoint: the portable training-state container.

Reference parity: ``ray.train.Checkpoint`` — created from a dict or
directory, shipped through the object store, restored at the consumer
(``python/ray/train/_checkpoint.py`` — SURVEY.md §5.4; mount empty).
"""

from __future__ import annotations

import os
import pickle


class Checkpoint:
    def __init__(self, state: dict):
        self._state = dict(state)

    @classmethod
    def from_dict(cls, state: dict) -> "Checkpoint":
        return cls(state)

    def to_dict(self) -> dict:
        return dict(self._state)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        with open(os.path.join(path, "checkpoint.pkl"), "rb") as f:
            return cls(pickle.load(f))

    def to_directory(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "checkpoint.pkl"), "wb") as f:
            pickle.dump(self._state, f)
        return path

    def __repr__(self) -> str:
        return f"Checkpoint(keys={sorted(self._state)})"

"""The port's side of each model family (``reference/families/`` says what
a family is): ``<family>.py`` here builds the port's model."""

from __future__ import annotations

from reference import families


def load(cfg: dict):
    """The port's module of ``cfg``'s family; a ``ValueError`` for a family
    that has none."""
    return families.load(cfg, __name__)

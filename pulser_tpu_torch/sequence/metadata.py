"""Setting and getting the serialized Sequence metadata.

Parity with reference ``pulser-core/pulser/sequence/metadata.py``,
reorganized around a single context-local store keyed by section
instead of one context variable per section.
"""

from __future__ import annotations

import contextvars
from typing import Any

_SECTIONS = ("package_versions", "extra")

_store: contextvars.ContextVar[dict[str, dict[str, Any]]] = (
    contextvars.ContextVar("_sequence_metadata", default={})
)


def _merge(section: str, entries: dict[str, Any]) -> None:
    current = _store.get()
    _store.set(
        {
            **current,
            section: {**current.get(section, {}), **entries},
        }
    )


def _get_metadata() -> dict[str, dict[str, Any]]:
    """Gets all the existing Sequence metadata."""
    data = _store.get()
    if any(data.get(section) for section in _SECTIONS):
        return {
            section: data.get(section, {}) for section in _SECTIONS
        }
    return {}


def _reset_metadata() -> None:
    """Deletes all existing metadata."""
    _store.set({})


def store_package_version_metadata(
    package_name: str, package_version: str
) -> None:
    """Store a package name and version in the Sequence metadata."""
    _merge("package_versions", {package_name: package_version})


def store_extra_metadata(extra_metadata: dict) -> None:
    """Store any extra metadata in the Sequence metadata."""
    _merge("extra", extra_metadata)

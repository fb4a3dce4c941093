"""A module gathering all available backends.

Port of ``pulser_tpu/backends.py`` (behavioral parity with reference
``pulser-core/pulser/backends.py``): a single-point, lazily-imported
access to backends spread across packages::

    import pulser_tpu_torch.backends as backends

    backends.QPUBackend      # Same as pulser_tpu_torch.QPUBackend
    backends.TorchBackendV2  # Same as pulser_tpu_torch.emulator.TorchBackendV2

Unlike the reference's three parallel lookup structures, every
backend name resolves through one registry whose entry says whether
it is available (and from which module), renamed, or removed.

Attributes:
    QPUBackend: See :py:class:`pulser_tpu_torch.backend.QPUBackend`.
    TorchBackend: See :py:class:`pulser_tpu_torch.emulator.TorchBackend`.
    TorchBackendV2: See
        :py:class:`pulser_tpu_torch.emulator.TorchBackendV2`.
    QutipBackend: Alias of ``TorchBackend`` (reference name).
    QutipBackendV2: Alias of ``TorchBackendV2`` (reference name).
"""

from __future__ import annotations

import importlib
import warnings
from typing import TYPE_CHECKING, NamedTuple, Optional, Type

if TYPE_CHECKING:
    from pulser_tpu_torch.backend.abc import Backend
    from pulser_tpu_torch.backend.qpu import QPUBackend as QPUBackend
    from pulser_tpu_torch.emulator import TorchBackendV2 as TorchBackendV2


class _Entry(NamedTuple):
    """How one backend name resolves."""

    module: Optional[str] = None  # import source (None: not here)
    renamed_to: Optional[str] = None  # deprecated alias target
    removed: bool = False


def _local(module: str, *names: str) -> dict[str, _Entry]:
    return {name: _Entry(module=module) for name in names}


_REGISTRY: dict[str, _Entry] = {
    **_local("pulser_tpu_torch.backend", "QPUBackend"),
    **_local(
        "pulser_tpu_torch.emulator",
        "QutipBackend",
        "QutipBackendV2",
        "TorchBackend",
        "TorchBackendV2",
    ),
    **_local(
        "pasqal_cloud",
        "RemoteEmuFreeBackend",
        "RemoteMPSBackend",
        "RemoteSVBackend",
    ),
    **_local("emu_mps", "MPSBackend"),
    **_local("emu_sv", "SVBackend"),
    "EmuFreeBackendV2": _Entry(renamed_to="RemoteEmuFreeBackend"),
    "EmuMPSBackend": _Entry(renamed_to="RemoteMPSBackend"),
    "EmuSVBackend": _Entry(renamed_to="RemoteSVBackend"),
    "EmuFreeBackend": _Entry(removed=True),
    "EmuTNBackend": _Entry(removed=True),
}

# Prevents * imports from attempting to import unavailable backends
__all__: list[str] = []


def __getattr__(name: str) -> Type[Backend]:
    entry = _REGISTRY.get(name)
    if entry is None:
        raise AttributeError(
            f"Module {__name__!r} has no attribute {name!r}."
        )
    if entry.removed:
        raise AttributeError(
            f"{name!r} was deprecated and is now removed "
            f"from module {__name__!r}"
        )
    if entry.renamed_to is not None:
        warnings.warn(
            f"{name!r} was renamed to {entry.renamed_to!r}. "
            f"Please use {entry.renamed_to!r} from now on.",
            DeprecationWarning,
            stacklevel=2,
        )
        name = entry.renamed_to
        entry = _REGISTRY[name]
    assert entry.module is not None
    try:
        return getattr(  # type: ignore
            importlib.import_module(entry.module), name
        )
    except ModuleNotFoundError:
        raise AttributeError(
            f"{name!r} requires the {entry.module!r} package. To"
            f" install it, run `pip install {entry.module}`."
        )

"""Every ROADMAP title the port quotes is a live ROADMAP item.

A refusal of ``pulser_tpu_torch`` names the ROADMAP.md item that will
lift it by the item's title, in single quotes after "ROADMAP.md". This
test collects every such title from the package's sources (adjacent
string literals joined, f-string placeholders resolved against the
module's own constants) and requires each one to be the bold title of
an item in ROADMAP.md, so that renaming or closing an item cannot leave
a refusal quoting a title that no longer exists.
"""

from __future__ import annotations

import importlib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "pulser_tpu_torch"

#: Adjacent string literals on consecutive lines, as Python joins them.
_JOIN = re.compile(r"""(['"])\s*\n\s*[rfb]*\1""")
#: A title in single quotes after "ROADMAP.md" in the same literal.
_QUOTED = re.compile(r"ROADMAP\.md[^'\"\n]{0,40}?'([^'\n]+)'")
_PLACEHOLDER = re.compile(r"\{(\w+)\}")


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _quoted_titles() -> list[tuple[str, str]]:
    """``(module, title)`` for every title quoted after ROADMAP.md."""
    found = []
    for path in sorted(PACKAGE.rglob("*.py")):
        text = _JOIN.sub("", path.read_text())
        for raw in _QUOTED.findall(text):
            module = _module_name(path)
            if "{" in raw:
                mod = importlib.import_module(module)
                raw = _PLACEHOLDER.sub(
                    lambda m: str(getattr(mod, m.group(1))), raw
                )
            found.append((module, raw))
    return found


def _bold_titles() -> set[str]:
    text = (ROOT / "ROADMAP.md").read_text()
    return {t.strip().rstrip(".") for t in re.findall(r"\*\*(.+?)\*\*", text)}


QUOTED = _quoted_titles()


def test_the_scan_finds_the_shared_titles():
    """The scan sees the solver's sharding refusals (they quote
    ``PARALLEL_ROADMAP_ITEM``) and no stale title: neither the JSON
    layer's item, ported, nor an older one."""
    from pulser_tpu_torch.ops import solver

    assert solver.PARALLEL_ROADMAP_ITEM == "Parallel and serving"
    modules = {m for m, t in QUOTED if t == solver.PARALLEL_ROADMAP_ITEM}
    assert "pulser_tpu_torch.ops.solver" in modules
    assert solver._PARALLEL_ITEM.endswith(
        f"'{solver.PARALLEL_ROADMAP_ITEM}'"
    )
    assert not any("Backend, JSON" in t for _, t in QUOTED)
    assert not any(t.startswith("JSON") for _, t in QUOTED)


@pytest.mark.parametrize(
    "module,title", QUOTED, ids=[f"{m}:{t}" for m, t in QUOTED]
)
def test_quoted_title_is_a_roadmap_item(module, title):
    assert title in _bold_titles(), (
        f"{module} quotes '{title}', which is not the bold title of an"
        " item in ROADMAP.md"
    )

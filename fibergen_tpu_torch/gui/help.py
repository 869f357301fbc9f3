"""Context help from the machine-readable project-file schema.

Parses the repository's doc/fileformat.xml (the project-file schema that
both packages read; the reference renders its own doc/fileformat.xml the
same way, fibergen_gui.py:1945-2318) and
answers "what does the element under the cursor mean": help text, value
type, allowed values, default, documented attributes, and child elements.

Pure-Python and headless — the Qt editor consumes it, tests drive it
directly.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class HelpEntry:
    tag: str
    help: str = ""
    type: str = ""
    values: List[str] = field(default_factory=list)
    default: str = ""
    attribs: Dict[str, "HelpEntry"] = field(default_factory=dict)
    children: Dict[str, "HelpEntry"] = field(default_factory=dict)

    def render(self) -> str:
        """Human-readable multi-line help block for the editor pane."""
        lines = [f"<{self.tag}>  [{self.type or 'element'}]"]
        if self.help:
            lines.append(self.help)
        if self.values:
            lines.append("values: " + ", ".join(self.values))
        if self.default:
            lines.append(f"default: {self.default}")
        if self.attribs:
            lines.append("attributes:")
            for a in self.attribs.values():
                v = f" ({', '.join(a.values)})" if a.values else ""
                d = f" [default {a.default}]" if a.default else ""
                lines.append(f"  {a.tag}: {a.help}{v}{d}")
        if self.children:
            lines.append("children: " + ", ".join(sorted(self.children)))
        return "\n".join(lines)


def _schema_path() -> str:
    """The repository's doc/fileformat.xml, beside the package."""
    return os.path.join(os.path.dirname(__file__), "..", "..", "doc",
                        "fileformat.xml")


def _build(elem) -> HelpEntry:
    e = HelpEntry(
        tag=elem.tag,
        help=elem.get("help", ""),
        type=elem.get("type", ""),
        values=[v for v in elem.get("values", "").split(",") if v],
        default=(elem.text or "").strip(),
    )
    for child in elem:
        if child.tag == "attrib":
            a = HelpEntry(
                tag=child.get("name", ""),
                help=child.get("help", ""),
                type=child.get("type", ""),
                values=[v for v in child.get("values", "").split(",") if v],
                default=(child.text or "").strip(),
            )
            e.attribs[a.tag] = a
        else:
            e.children[child.tag] = _build(child)
    return e


class Schema:
    """Parsed fileformat.xml with dotted-path lookup."""

    def __init__(self, path: Optional[str] = None):
        tree = ET.parse(path or _schema_path())
        self.root = _build(tree.getroot())

    def lookup(self, path: str) -> Optional[HelpEntry]:
        """Dotted element path relative to <settings>, e.g.
        'solver.mixing_rule' or 'actions.place_fiber'; '' or 'settings'
        returns the root."""
        node = self.root
        parts = [p for p in path.split(".") if p and p != "settings"]
        for p in parts:
            if p in node.children:
                node = node.children[p]
            elif p in node.attribs:
                return node.attribs[p]
            else:
                return None
        return node

    def help_for(self, path: str) -> str:
        e = self.lookup(path)
        return e.render() if e is not None else f"(no help for '{path}')"


_SCHEMA: Optional[Schema] = None


def schema() -> Schema:
    global _SCHEMA
    if _SCHEMA is None:
        _SCHEMA = Schema()
    return _SCHEMA


_TAG_RE = re.compile(r"<\s*(/?)\s*([A-Za-z_][\w.-]*)")


def element_path_at(text: str, pos: int) -> str:
    """Dotted element path of the cursor position in an XML document —
    the open-element stack computed by scanning tags up to ``pos``
    (XMLTextEdit cursor-context help, fibergen_gui.py:1773-1944)."""
    stack: List[str] = []
    for m in _TAG_RE.finditer(text, 0, pos):
        closing, tag = m.group(1), m.group(2)
        end = text.find(">", m.end())
        if end == -1 or end >= pos:
            break  # tag still open at the cursor; handled below
        self_closing = text[max(0, end - 1):end] == "/"
        if closing:
            if stack and stack[-1] == tag:
                stack.pop()
        elif not self_closing:
            # ignore processing instructions / comments
            if not tag.startswith("!") and not tag.startswith("?"):
                stack.append(tag)
    # if the cursor is INSIDE a tag currently being typed, include it
    lt = text.rfind("<", 0, pos)
    gt = text.rfind(">", 0, pos)
    if lt > gt:
        m = _TAG_RE.match(text, lt)
        if m and not m.group(1):
            stack.append(m.group(2))
    return ".".join(stack)


def help_at(text: str, pos: int) -> str:
    """Help text for the element at character ``pos`` of the document."""
    return schema().help_for(element_path_at(text, pos))

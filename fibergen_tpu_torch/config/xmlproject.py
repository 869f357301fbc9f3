"""XML project tree with dotted-path addressing and Python-expression
attribute evaluation (a copy of fibergen_tpu/config/xmlproject.py; plain
Python).

Replaces the reference's boost::property_tree + embedded-CPython PY engine
(FGProject/get_path, fibergen.cpp:26516-26781; PY, fibergen.cpp:692-946):

- every attribute / element text may be a Python expression evaluated in a
  persistent namespace seeded with ``from math import *``, user
  ``<variables>``, executed ``<python>`` blocks, and ``fg`` (the FG object)
- dotted paths address elements; ``a.b..attr`` addresses attribute ``attr``
  of element ``a.b``; ``elem[i]`` selects the i-th element of that name
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Optional


class ExpressionEngine:
    """Persistent Python evaluation namespace (PY, fibergen.cpp:692-882)."""

    def __init__(self):
        self.enabled = True
        self.globals = {"__builtins__": __builtins__}
        self.locals = {}
        # 'from math import *' semantics (fibergen.cpp:820)
        for name in dir(math):
            if not name.startswith("_"):
                self.locals[name] = getattr(math, name)

    def add_local(self, name, value):
        self.locals[name] = value

    def remove_local(self, name):
        self.locals.pop(name, None)

    def exec_code(self, code: str):
        exec(compile(code, "<python block>", "exec"), self.globals, self.locals)

    def eval(self, expr: str):
        return eval(compile(expr, "<expr>", "eval"), self.globals, self.locals)

    def get(self, raw: str, typ=float):
        """Convert raw attribute text to typ, falling back to expression
        evaluation (pt_get, fibergen.cpp:885-946)."""
        if typ is str:
            return raw
        s = raw.strip()
        try:
            if typ is bool:
                return bool(int(s))
            return typ(s)
        except (TypeError, ValueError):
            pass
        if not self.enabled:
            raise ValueError(f"Cannot convert '{raw}' to {typ.__name__} "
                             "(expression evaluation disabled)")
        v = self.eval(s)
        if typ is bool:
            return bool(int(v)) if not isinstance(v, bool) else v
        return typ(v)


def _strip(elem_text: Optional[str]) -> str:
    return (elem_text or "").strip()


class XMLProject:
    """The project configuration tree (FGProject, fibergen.cpp:26516-26781)."""

    def __init__(self, root_tag="settings"):
        self.root = ET.Element(root_tag)
        self.xml_precision = 16

    # -------------------------------------------------------------- load/save
    def load_xml(self, filename: str):
        self.root = ET.parse(filename).getroot()

    def set_xml(self, text: str):
        self.root = ET.fromstring(text)

    def get_xml(self) -> str:
        ET.indent(self.root)
        return ET.tostring(self.root, encoding="unicode")

    # ------------------------------------------------------------- addressing
    @staticmethod
    def _split(path: str):
        """Split 'a.b..attr' into element components + optional attribute
        (get_path, fibergen.cpp:26632-26693)."""
        parts = path.split(".")
        comps = []
        attr = None
        i = 0
        while i < len(parts):
            p = parts[i]
            if p == "":
                # '..attr' -> empty component followed by attribute name
                if i + 1 < len(parts):
                    attr = parts[i + 1]
                i += 2
                continue
            comps.append(p)
            i += 1
        return comps, attr

    def _resolve(self, path: str, create=False):
        comps, attr = self._split(path)
        elem = self.root
        for c in comps:
            name, idx = c, 0
            if c.endswith("]") and "[" in c:
                name, rest = c.split("[", 1)
                idx = int(rest[:-1])
            matches = [ch for ch in elem if ch.tag == name]
            if idx < len(matches):
                elem = matches[idx]
            elif create:
                while len(matches) <= idx:
                    new = ET.SubElement(elem, name)
                    matches.append(new)
                elem = matches[idx]
            else:
                return None, attr
        return elem, attr

    # ------------------------------------------------------------- get/set
    def get(self, path: str, default: str = "") -> str:
        elem, attr = self._resolve(path)
        if elem is None:
            return default
        if attr is not None:
            return elem.get(attr, default)
        return _strip(elem.text) or default

    def has(self, path: str) -> bool:
        elem, attr = self._resolve(path)
        if elem is None:
            return False
        return attr is None or attr in elem.attrib

    def set(self, path: str, value=None):
        elem, attr = self._resolve(path, create=True)
        if value is None:
            text = ""
        elif isinstance(value, float):
            text = repr(value)
        else:
            text = str(value)
        if attr is not None:
            elem.set(attr, text)
        else:
            elem.text = text

    def erase(self, path: str):
        comps, attr = self._split(path)
        elem, a = self._resolve(path)
        if elem is None:
            return
        if a is not None:
            elem.attrib.pop(a, None)
            return
        # find parent and remove
        parent, _ = (self._resolve(".".join(comps[:-1])) if len(comps) > 1
                     else (self.root, None))
        if parent is not None:
            parent.remove(elem)


class SettingsReader:
    """Typed, expression-evaluating accessors over an element
    (pt_get helpers, fibergen.cpp:885-946)."""

    def __init__(self, engine: ExpressionEngine, elem: Optional[ET.Element]):
        self.engine = engine
        self.elem = elem

    def child(self, name) -> "SettingsReader":
        e = None if self.elem is None else self.elem.find(name)
        return SettingsReader(self.engine, e)

    def children(self, name=None):
        if self.elem is None:
            return []
        return [c for c in self.elem
                if (name is None or c.tag == name)
                and not isinstance(c.tag, type(ET.Comment))]

    def attr(self, name, default=None, typ=float):
        """Attribute of this element."""
        if self.elem is None or name not in self.elem.attrib:
            return default
        return self.engine.get(self.elem.get(name), typ)

    def has_attr(self, name):
        return self.elem is not None and name in self.elem.attrib

    def value(self, name, default=None, typ=float):
        """Child-element text, e.g. <tol>1e-6</tol> (the reference's
        pt_get(pt, 'tol')).  Falls back to an attribute of the same name."""
        if self.elem is None:
            return default
        child = self.elem.find(name)
        if child is not None and _strip(child.text):
            return self.engine.get(_strip(child.text), typ)
        if name in self.elem.attrib:
            return self.engine.get(self.elem.get(name), typ)
        return default

    def text(self, default=""):
        if self.elem is None:
            return default
        return _strip(self.elem.text) or default

"""Parameter handling compatible with the reference's Teuchos ParameterList XML.

The reference (nlesc-smcm/hymls) configures everything through nested
Teuchos ParameterLists read from XML (reference src/main.cpp:104-123,
testSuite/*.xml).  To let users of the reference switch over without
rewriting their configs, we accept the same XML schema and the same
parameter names ("Problem"/"Solver"/"Preconditioner" sublists,
"Separator Length", "Number of Levels", ...).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any, Dict, Optional


_TYPE_PARSERS = {
    "int": int,
    "double": float,
    "float": float,
    "string": str,
    "bool": lambda s: s.strip().lower() in ("1", "true", "yes"),
}


class Params:
    """A nested parameter list with defaulting `get`, mirroring
    Teuchos::ParameterList semantics (get-with-default also records the
    default so later reads are consistent)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, name: str = ""):
        self.name = name
        self._data: Dict[str, Any] = {}
        if data:
            for k, v in data.items():
                if isinstance(v, dict):
                    self._data[k] = Params(v, name=k)
                elif isinstance(v, Params):
                    self._data[k] = v
                else:
                    self._data[k] = v

    # -- dict-ish interface ------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __getitem__(self, key: str):
        return self._data[key]

    def __setitem__(self, key: str, value):
        if isinstance(value, dict):
            value = Params(value, name=key)
        self._data[key] = value

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, key: str, default=None):
        """Get a parameter; if absent, record and return the default
        (Teuchos `get` semantics)."""
        if key not in self._data:
            if default is None:
                return None
            self._data[key] = default
        return self._data[key]

    def sublist(self, key: str) -> "Params":
        """Get or create a nested parameter list."""
        if key not in self._data or not isinstance(self._data[key], Params):
            self._data[key] = Params(name=key)
        return self._data[key]

    def is_sublist(self, key: str) -> bool:
        return key in self._data and isinstance(self._data[key], Params)

    def copy(self) -> "Params":
        out = Params(name=self.name)
        for k, v in self._data.items():
            out._data[k] = v.copy() if isinstance(v, Params) else v
        return out

    def update_from(self, other: "Params") -> None:
        """Recursively overlay `other` on top of self."""
        for k, v in other._data.items():
            if isinstance(v, Params) and isinstance(self._data.get(k), Params):
                self._data[k].update_from(v)
            else:
                self._data[k] = v.copy() if isinstance(v, Params) else v

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, Params) else v)
            for k, v in self._data.items()
        }

    def __repr__(self):
        return f"Params({self.name!r}, {self.to_dict()!r})"


def _parse_list(elem: ET.Element) -> Params:
    out = Params(name=elem.attrib.get("name", ""))
    for child in elem:
        if child.tag == "ParameterList":
            out[child.attrib["name"]] = _parse_list(child)
        elif child.tag == "Parameter":
            ptype = child.attrib.get("type", "string")
            parser = _TYPE_PARSERS.get(ptype, str)
            out[child.attrib["name"]] = parser(child.attrib["value"])
    return out


def load_xml(path: str) -> Params:
    """Load a Teuchos-ParameterList-style XML file into Params."""
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "ParameterList":
        root = root.find("ParameterList")
    return _parse_list(root)


def loads_xml(text: str) -> Params:
    root = ET.fromstring(text)
    if root.tag != "ParameterList":
        root = root.find("ParameterList")
    return _parse_list(root)


def _emit_list(params: Params, name: str) -> ET.Element:
    elem = ET.Element("ParameterList", name=name)
    for key in params.keys():
        val = params[key]
        if isinstance(val, Params):
            elem.append(_emit_list(val, key))
        else:
            if isinstance(val, bool):
                t, s = "bool", ("true" if val else "false")
            elif isinstance(val, int):
                t, s = "int", str(val)
            elif isinstance(val, float):
                t, s = "double", repr(val)
            else:
                t, s = "string", str(val)
            ET.SubElement(elem, "Parameter", name=key, type=t, value=s)
    return elem


def save_xml(params: Params, path: str, name: str = "") -> None:
    """Write Params as Teuchos-ParameterList XML (the reference's
    final-parameter-list dump format, reference src/main.cpp:492-509)."""
    root = _emit_list(params, name or getattr(params, "name", "") or "")
    ET.indent(ET.ElementTree(root))
    ET.ElementTree(root).write(path, encoding="unicode")

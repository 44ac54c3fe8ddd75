"""worldgen XML <-> typed-dict normalization.

Counterpart of `robogym_tpu/worldgen/parser.py` (robogym's
worldgen/parser/normalize.py and const.py, without the xmltodict
dependency): MuJoCo XML parses to nested dicts with `@attr` keys, attribute
strings normalize to bool/float/np.ndarray, child tags known to repeat
become lists; `stringify` + `unparse_dict` invert the transform.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from collections import OrderedDict
from decimal import Decimal
from typing import Any, List

import numpy as np

# tags that always normalize to a LIST of dicts even when one child is
# present (reference worldgen/parser/const.py list_types, trimmed to the
# tags that appear in the shipped assets)
LIST_TYPES = {
    "geom", "body", "joint", "site", "camera", "light", "mesh", "material",
    "texture", "motor", "position", "general", "default", "include",
    "equality", "weld", "connect", "tendon", "fixed", "spatial", "pair",
    "exclude", "sensor", "touch", "force", "torque", "actuator", "freejoint",
}

# attributes that must stay float-typed even when they look integral
FLOAT_ARG_TYPES = {
    "@pos", "@quat", "@axis", "@size", "@euler", "@fromto", "@pos2",
    "@density", "@mass", "@damping", "@armature", "@stiffness", "@range",
    "@ctrlrange", "@forcerange", "@gear", "@timestep", "@gravity",
    "@friction", "@solref", "@solimp", "@margin", "@rgba", "@diaginertia",
}


def normalize_value(value: str) -> Any:
    """'true'/'false' -> bool; numbers -> int/float; vectors -> ndarray;
    everything else stays a string (normalize.py:120-170)."""
    s = value.strip()
    if s.lower() == "true":
        return True
    if s.lower() == "false":
        return False
    parts = s.split()
    try:
        if len(parts) > 1:
            return np.asarray([float(p) for p in parts])
        f = float(s)
        if f == int(f) and "." not in s and "e" not in s.lower():
            return int(f)
        return f
    except ValueError:
        return value


def _elem_to_dict(el: ET.Element) -> OrderedDict:
    out: OrderedDict = OrderedDict()
    for k, v in el.attrib.items():
        out[f"@{k}"] = v
    for child in el:
        d = _elem_to_dict(child)
        if child.tag in out:
            if not isinstance(out[child.tag], list):
                out[child.tag] = [out[child.tag]]
            out[child.tag].append(d)
        else:
            out[child.tag] = d
    return out


def parse_file(path: str) -> OrderedDict:
    root = ET.parse(path).getroot()
    d = OrderedDict({root.tag: _elem_to_dict(root)})
    normalize(d)
    return d


def parse_string(xml: str) -> OrderedDict:
    root = ET.fromstring(xml)
    d = OrderedDict({root.tag: _elem_to_dict(root)})
    normalize(d)
    return d


def normalize(xml_dict) -> None:
    """In-place normalization (normalize.py:26-71)."""
    if "@model" in xml_dict:
        del xml_dict["@model"]
    for key, value in list(xml_dict.items()):
        if isinstance(value, (dict, OrderedDict)):
            if key == "default" and "@class" in value:
                xml_dict[key] = [value]
            elif key in LIST_TYPES:
                xml_dict[key] = [value]
            normalize(value)
            continue
        if isinstance(value, list):
            for child in value:
                if isinstance(child, (dict, OrderedDict)):
                    normalize(child)
            continue
        if isinstance(value, str):
            xml_dict[key] = normalize_value(value)
            if key in FLOAT_ARG_TYPES:
                if isinstance(xml_dict[key], int):
                    xml_dict[key] = float(xml_dict[key])
                elif isinstance(xml_dict[key], np.ndarray):
                    xml_dict[key] = xml_dict[key].astype(np.float64)


def num2str(num) -> str:
    ret = "%g" % Decimal("%.6f" % float(num))
    return "0" if ret == "-0" else ret


def vec2str(vec: List) -> str:
    return " ".join(num2str(v) for v in vec)


def stringify(xml_dict) -> None:
    """Inverse of normalize (normalize.py:176-216): all values back to
    attribute strings, in place."""
    for key, value in list(xml_dict.items()):
        if isinstance(value, (dict, OrderedDict)):
            stringify(value)
        elif isinstance(value, list):
            if value and isinstance(value[0], (dict, OrderedDict)):
                for child in value:
                    stringify(child)
            else:
                xml_dict[key] = vec2str(value)
        elif isinstance(value, np.ndarray):
            xml_dict[key] = vec2str(value.tolist())
        elif isinstance(value, bool):
            xml_dict[key] = "true" if value else "false"
        elif isinstance(value, (int, float)):
            xml_dict[key] = num2str(value)


def _dict_to_elem(tag: str, d) -> ET.Element:
    el = ET.Element(tag)
    for k, v in d.items():
        if k.startswith("@"):
            el.set(k[1:], v)
        elif isinstance(v, list):
            for child in v:
                el.append(_dict_to_elem(k, child))
        else:
            el.append(_dict_to_elem(k, v))
    return el


def unparse_dict(xml_dict) -> str:
    """dict -> XML string (must be stringify()-ed first)."""
    if len(xml_dict) != 1:
        raise ValueError(f"want one root element, got {list(xml_dict)}")
    tag = next(iter(xml_dict))
    return ET.tostring(_dict_to_elem(tag, xml_dict[tag]), encoding="unicode")

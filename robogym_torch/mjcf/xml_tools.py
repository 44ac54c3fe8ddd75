"""MJCF XML composition: parse a document (resolving its includes),
append documents, namespace names with a prefix, set and remove attributes
by name or tag, and hand the merged tree to `robogym_torch.mjcf.compiler`.

Counterpart of `robogym_tpu/mjcf/xml_tools.py`, the analogue of robogym's
`MujocoXML`. Relative XML paths resolve against `XML_DIR`, under the
assets directory `ASSETS_DIR` that the environment variable
`ROBOGYM_TPU_ASSETS` names: robogym's own assets, which this repository
does not carry. Where the variable is unset, `ASSETS_DIR` and `XML_DIR`
are None, and whatever needs those assets raises FileNotFoundError naming
the variable.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as et
from typing import Iterable, List, Optional, Union

ASSETS_DIR: Optional[str] = os.environ.get("ROBOGYM_TPU_ASSETS") or None
XML_DIR: Optional[str] = os.path.join(ASSETS_DIR, "xmls") if ASSETS_DIR else None


def _unset(what: str) -> FileNotFoundError:
    return FileNotFoundError(f"{what} is one of robogym's assets, which this repository does not "
                             "carry: set ROBOGYM_TPU_ASSETS to robogym's assets directory")


def assets_dir(what: str) -> str:
    """`ASSETS_DIR`; raises FileNotFoundError naming `what` and the
    variable where it is unset."""
    if ASSETS_DIR is None:
        raise _unset(what)
    return ASSETS_DIR


def xml_dir(what: str) -> str:
    """`XML_DIR`, as `assets_dir`."""
    if XML_DIR is None:
        raise _unset(what)
    return XML_DIR

# attributes that refer to other named objects and must be renamed together
_RENAME_ATTRS = frozenset(
    [
        "name",
        "joint",
        "joint1",
        "joint2",
        "jointinparent",
        "geom",
        "geom1",
        "geom2",
        "site",
        "sidesite",
        "tendon",
        "tendon1",
        "tendon2",
        "body",
        "body1",
        "body2",
        "objname",
        "mesh",
        "material",
        "texture",
        "class",
        "childclass",
        "source",
        "target",
        "prefix",
        "actuator",
    ]
)

# attrs never namespaced (booleans/builtins)
_NO_RENAME_VALUES = frozenset(["true", "false", "none"])


def _stringify(value) -> str:
    if isinstance(value, (list, tuple)) or hasattr(value, "tolist"):
        seq = value.tolist() if hasattr(value, "tolist") else value
        return " ".join(repr(float(v)) if isinstance(v, float) else str(v) for v in seq)
    if isinstance(value, float):
        return repr(value)
    return str(value)


class MjcfXML:
    """Mutable MJCF document under composition (reference MujocoXML parity)."""

    def __init__(self, root_element: Optional[et.Element] = None):
        self.root_element = (
            root_element if root_element is not None else et.Element("mujoco")
        )

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, xml_path: str) -> "MjcfXML":
        """Parse an XML file (relative paths resolve against the assets dir),
        recursively inlining <include> elements (reference mujoco_xml.py:218-247)."""
        if not os.path.isabs(xml_path):
            xml_path = os.path.join(xml_dir(xml_path), xml_path)
        tree = et.parse(xml_path)
        root = tree.getroot()
        if root.tag == "mujocoinclude":
            root.tag = "mujoco"
        _resolve_includes(root, os.path.dirname(xml_path))
        return cls(root)

    @classmethod
    def from_string(cls, xml_string: str, base_dir: Optional[str] = None) -> "MjcfXML":
        root = et.fromstring(xml_string)
        if root.tag == "mujocoinclude":
            root.tag = "mujoco"
        _resolve_includes(root, base_dir or XML_DIR)
        return cls(root)

    @property
    def meshdir(self) -> str:
        return os.path.join(assets_dir("stls"), "stls")

    @property
    def texturedir(self) -> str:
        return os.path.join(assets_dir("textures"), "textures")

    def xml_string(self) -> str:
        return et.tostring(self.root_element, encoding="unicode")

    # -- composition -------------------------------------------------------

    def append(self, other: "MjcfXML") -> "MjcfXML":
        """Merge another document's sections into this one
        (reference mujoco_xml.py:262-270)."""
        for child in list(other.root_element):
            existing = self.root_element.find(child.tag)
            # Sections that accumulate entries get merged; others appended.
            if child.tag in (
                "worldbody",
                "asset",
                "actuator",
                "tendon",
                "sensor",
                "equality",
                "contact",
                "default",
            ) and existing is not None:
                for sub in list(child):
                    existing.append(sub)
            else:
                self.root_element.append(child)
        return self

    def add_default_compiler_directive(self) -> "MjcfXML":
        """(reference mujoco_xml.py:172-186)."""
        self.root_element.append(
            et.Element(
                "compiler",
                {
                    "meshdir": self.meshdir,
                    "texturedir": self.texturedir,
                    "angle": "radian",
                    "coordinate": "local",
                },
            )
        )
        return self

    # -- namespacing -------------------------------------------------------

    def add_name_prefix(
        self, name_prefix: str, exclude_attribs: Iterable[str] = ()
    ) -> "MjcfXML":
        """Prefix every name/name-reference attribute
        (reference mujoco_xml.py:272-291)."""
        excl = set(exclude_attribs)
        for node in self.root_element.iter():
            for attr in _RENAME_ATTRS - excl:
                v = node.get(attr)
                if v is None or v.lower() in _NO_RENAME_VALUES:
                    continue
                node.set(attr, name_prefix + v)
        return self

    def replace_name(self, old_name: str, new_name: str) -> "MjcfXML":
        for node in self.root_element.iter():
            for attr in _RENAME_ATTRS:
                v = node.get(attr)
                if v == old_name:
                    node.set(attr, new_name)
        return self

    # -- attribute edits ---------------------------------------------------

    def set_objects_attr(self, tag: str = "*", **kwargs) -> "MjcfXML":
        """Set attributes on every element with the given tag
        (reference mujoco_xml.py:293-304)."""
        for node in self.root_element.iter(tag if tag != "*" else None):
            if tag != "*" and node.tag != tag:
                continue
            for k, v in kwargs.items():
                node.set(k, _stringify(v))
        return self

    def set_named_objects_attr(self, name: str, tag: str = "*", **kwargs) -> "MjcfXML":
        """(reference mujoco_xml.py:306-316)."""
        for node in self.root_element.iter():
            if node.get("name") != name:
                continue
            if tag != "*" and node.tag != tag:
                continue
            for k, v in kwargs.items():
                node.set(k, _stringify(v))
        return self

    def set_prefixed_objects_attr(
        self, prefix: str, tag: str = "*", **kwargs
    ) -> "MjcfXML":
        for node in self.root_element.iter():
            n = node.get("name")
            if n is None or not n.startswith(prefix):
                continue
            if tag != "*" and node.tag != tag:
                continue
            for k, v in kwargs.items():
                node.set(k, _stringify(v))
        return self

    # -- removal -----------------------------------------------------------

    def remove_objects_by_tag(self, tag: str) -> "MjcfXML":
        self._remove_recursive(self.root_element, lambda n: n.tag == tag)
        return self

    def remove_objects_by_prefix(self, prefix: str, tag: str = "*") -> "MjcfXML":
        self._remove_recursive(
            self.root_element,
            lambda n: (n.get("name") or "").startswith(prefix)
            and (tag == "*" or n.tag == tag),
        )
        return self

    def remove_objects_by_name(
        self, names: Union[str, Iterable[str]], tag: str = "*"
    ) -> "MjcfXML":
        if isinstance(names, str):
            names = [names]
        name_set = set(names)
        self._remove_recursive(
            self.root_element,
            lambda n: n.get("name") in name_set and (tag == "*" or n.tag == tag),
        )
        return self

    @staticmethod
    def _remove_recursive(parent: et.Element, predicate) -> None:
        for child in list(parent):
            if predicate(child):
                parent.remove(child)
            else:
                MjcfXML._remove_recursive(child, predicate)

    # -- queries -----------------------------------------------------------

    def find_named(self, name: str, tag: str = "*") -> List[et.Element]:
        return [
            n
            for n in self.root_element.iter()
            if n.get("name") == name and (tag == "*" or n.tag == tag)
        ]


def _resolve_includes(root: et.Element, base_dir: Optional[str]) -> None:
    """Inline <include file="..."/> elements in place (MuJoCo include
    semantics: children of the included root replace the include node)."""
    changed = True
    while changed:
        changed = False
        for parent in root.iter():
            for idx, child in enumerate(list(parent)):
                if child.tag != "include":
                    continue
                fname = child.get("file")
                path = fname if os.path.isabs(fname) or base_dir is None else \
                    os.path.join(base_dir, fname)
                if not os.path.exists(path):
                    # includes referenced relative to the asset xml root
                    path = os.path.join(xml_dir(fname), fname)
                inc_root = et.parse(path).getroot()
                parent.remove(child)
                for offset, sub in enumerate(list(inc_root)):
                    parent.insert(idx + offset, sub)
                changed = True
                break
            if changed:
                break

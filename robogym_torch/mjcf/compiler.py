"""MJCF -> Model compiler: the port's own, so that it builds its worlds
from their XML.

Counterpart of `robogym_tpu/mjcf/compiler.py` (which replaces
`mujoco_py.load_model_from_xml`, MuJoCo's C model compiler). Host-side
numpy: every field is built in float64, as the JAX compiler builds it, and
cast once to the model's dtype at the end; `compile_xml` then makes the
port's `Model` on a device through `bridge.model_from_numpy`.

Supported MJCF subset = what the reference asset XMLs + env builders use:
bodies (incl. mocap), inertial, free/ball/slide/hinge joints, geoms
(plane/sphere/capsule/cylinder/box/ellipsoid/mesh), sites, cameras, lights,
fixed & spatial tendons, <general> (PID) / <position> / <motor> actuators,
weld/connect/joint equality constraints, contact pair/exclude, defaults with
class inheritance, includes, meshes (STL), materials (rgba only).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import xml.etree.ElementTree as et

from robogym_torch.mjcf import mesh as mesh_lib
from robogym_torch.mjcf.model import (
    BiasType,
    ConeType,
    DynType,
    EqType,
    GainType,
    GeomType,
    IntegratorType,
    JointType,
    OPTION_STATIC,
    OPTION_TENSORS,
    Option,
    TrnType,
    WrapType,
)
from robogym_torch.mjcf.xml_tools import MjcfXML

_GEOM_TYPES = {
    "plane": GeomType.PLANE,
    "sphere": GeomType.SPHERE,
    "capsule": GeomType.CAPSULE,
    "ellipsoid": GeomType.ELLIPSOID,
    "cylinder": GeomType.CYLINDER,
    "box": GeomType.BOX,
    "mesh": GeomType.MESH,
}

_JNT_TYPES = {
    "free": JointType.FREE,
    "ball": JointType.BALL,
    "slide": JointType.SLIDE,
    "hinge": JointType.HINGE,
}

# max contact points allocated per geom-type pair (key: sorted type pair)
_PAIR_NCON = {
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.CYLINDER): 4,
    (GeomType.PLANE, GeomType.ELLIPSOID): 1,
    (GeomType.PLANE, GeomType.BOX): 8,
    (GeomType.PLANE, GeomType.MESH): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.CYLINDER): 1,
    (GeomType.SPHERE, GeomType.ELLIPSOID): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 1,
    (GeomType.CAPSULE, GeomType.BOX): 2,
    (GeomType.CAPSULE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.ELLIPSOID): 1,
    (GeomType.CAPSULE, GeomType.CYLINDER): 1,
    (GeomType.BOX, GeomType.BOX): 17,
    (GeomType.BOX, GeomType.MESH): 4,
    (GeomType.BOX, GeomType.ELLIPSOID): 1,
    (GeomType.BOX, GeomType.CYLINDER): 4,
    (GeomType.MESH, GeomType.MESH): 1,
    (GeomType.MESH, GeomType.CYLINDER): 1,
    (GeomType.MESH, GeomType.ELLIPSOID): 1,
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID): 1,
    (GeomType.CYLINDER, GeomType.CYLINDER): 1,
}

MAX_HULL_VERTS = 64
MAX_HULL_FACES = 64  # raycast-render face-plane budget (mesh.hull_face_planes)


def _floats(s: Optional[str], n: Optional[int] = None, default=None) -> np.ndarray:
    if s is None:
        return None if default is None else np.asarray(default, dtype=np.float64)
    out = np.asarray([float(x) for x in s.replace(",", " ").split()], dtype=np.float64)
    if n is not None and out.size == 1 and n > 1:
        out = np.full(n, out[0])
    return out



_SOLIMP_DEFAULT = [0.9, 0.95, 0.001, 0.5, 2.0]


def _solimp(s: Optional[str], default=None) -> np.ndarray:
    """Parse solimp, padding short (3-element, MuJoCo<2.0 style) specs with
    the default midpoint/power (mjc XML allows 3 or 5 values)."""
    out = _floats(s, default=(default or _SOLIMP_DEFAULT))
    out = np.asarray(out, np.float64)
    if out.size < 5:
        out = np.concatenate([out, np.asarray(_SOLIMP_DEFAULT[out.size:])])
    return out[:5]


def _normalize_rows(a: np.ndarray) -> np.ndarray:
    """Unit-normalize each row (zero rows pass through unchanged)."""
    a = np.asarray(a, np.float64)
    if a.size == 0:
        return a
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return np.where(n > 0, a / np.maximum(n, 1e-300), a)


def _np_quat_mul(q0, q1):
    w0, x0, y0, z0 = q0
    w1, x1, y1, z1 = q1
    return np.array(
        [
            w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
            w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
            w0 * y1 + y0 * w1 + z0 * x1 - x0 * z1,
            w0 * z1 + z0 * w1 + x0 * y1 - y0 * x1,
        ]
    )


def _np_quat2mat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _np_mat2quat(m):
    # robust branch selection
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array(
            [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        )
    elif m[1, 1] >= m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array(
            [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array(
            [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        )
    return q / np.linalg.norm(q)


class _Compiler:
    def __init__(self, root: et.Element):
        self.root = root
        self.angle_deg = True  # MuJoCo default; overridden by <compiler angle="radian">
        self.meshdir = ""
        # defaults: class name -> {elemtag: {attr: val}}
        self.defaults: Dict[str, Dict[str, Dict[str, str]]] = {"__global__": {}}
        self.default_parent: Dict[str, str] = {}
        self.materials: Dict[str, np.ndarray] = {}
        self.mesh_assets: Dict[str, dict] = {}
        self.mesh_ids: Dict[str, int] = {}

        # accumulating tables
        self.bodies: List[dict] = []
        self.joints: List[dict] = []
        self.geoms: List[dict] = []
        self.sites: List[dict] = []
        self.cameras: List[dict] = []
        self.lights: List[dict] = []
        self.tendons: List[dict] = []
        self.wraps: List[dict] = []
        self.actuators: List[dict] = []
        self.equalities: List[dict] = []
        self.excludes: List[tuple] = []
        self.explicit_pairs: List[dict] = []
        self.option_attrs: Dict[str, str] = {}

    # ------------------------------------------------------------------
    def angle(self, v: np.ndarray) -> np.ndarray:
        return np.deg2rad(v) if self.angle_deg else v

    def orient(self, node: et.Element, cls_attrs: Dict[str, str]) -> np.ndarray:
        """quat from quat= / euler= / axisangle= / zaxis= / fromto handling excluded."""
        get = lambda a: node.get(a, cls_attrs.get(a))
        if get("quat") is not None:
            q = _floats(get("quat"))
            return q / np.linalg.norm(q)
        if get("euler") is not None:
            e = self.angle(_floats(get("euler")))
            # MuJoCo default eulerseq "xyz" (extrinsic x, then y, then z):
            # R = Rz(ez) @ Ry(ey) @ Rx(ex)? MuJoCo composes rotating frames:
            # q = qx * qy * qz with intrinsic axes -> equals extrinsic zyx.
            qx = np.array([np.cos(e[0] / 2), np.sin(e[0] / 2), 0, 0])
            qy = np.array([np.cos(e[1] / 2), 0, np.sin(e[1] / 2), 0])
            qz = np.array([np.cos(e[2] / 2), 0, 0, np.sin(e[2] / 2)])
            return _np_quat_mul(_np_quat_mul(qx, qy), qz)
        if get("axisangle") is not None:
            aa = _floats(get("axisangle"))
            axis = aa[:3] / np.linalg.norm(aa[:3])
            ang = self.angle(np.asarray([aa[3]]))[0]
            return np.concatenate([[np.cos(ang / 2)], axis * np.sin(ang / 2)])
        if get("zaxis") is not None:
            z = _floats(get("zaxis"))
            z = z / np.linalg.norm(z)
            # minimal rotation from (0,0,1) to z
            v = np.cross([0.0, 0.0, 1.0], z)
            w = 1.0 + z[2]
            if w < 1e-12:
                return np.array([0.0, 1.0, 0.0, 0.0])
            q = np.concatenate([[w], v])
            return q / np.linalg.norm(q)
        return np.array([1.0, 0.0, 0.0, 0.0])

    # ------------------------------------------------------------------
    def class_attrs(self, tag: str, cls: Optional[str]) -> Dict[str, str]:
        """Resolved default attributes for element `tag` under class `cls`."""
        chain = []
        cur = cls if cls is not None else "__global__"
        while cur is not None:
            chain.append(cur)
            cur = self.default_parent.get(cur)
        if chain[-1] != "__global__":
            chain.append("__global__")
        out: Dict[str, str] = {}
        for c in reversed(chain):
            out.update(self.defaults.get(c, {}).get(tag, {}))
        return out

    def attr(self, node, tag, name, cls=None, default=None):
        v = node.get(name)
        if v is not None:
            return v
        return self.class_attrs(tag, cls).get(name, default)

    # ------------------------------------------------------------------
    def parse_defaults(self, node: et.Element, parent_cls: str = "__global__"):
        cls = node.get("class", "__global__" if parent_cls == "__global__" else None)
        if node.tag == "default":
            cls = node.get("class") or parent_cls
            if cls not in self.defaults:
                self.defaults[cls] = {}
                if cls != "__global__":
                    self.default_parent[cls] = parent_cls
            for child in node:
                if child.tag == "default":
                    self.parse_defaults(child, cls)
                else:
                    tag = child.tag
                    self.defaults[cls].setdefault(tag, {}).update(child.attrib)

    # ------------------------------------------------------------------
    def parse(self):
        for comp in self.root.iter("compiler"):
            if comp.get("angle"):
                self.angle_deg = comp.get("angle") == "degree"
            if comp.get("meshdir"):
                self.meshdir = comp.get("meshdir")
        for opt in self.root.iter("option"):
            self.option_attrs.update(opt.attrib)
        for dflt in list(self.root.findall("default")):
            self.parse_defaults(dflt)
        for asset in self.root.findall("asset"):
            for m in asset.findall("material"):
                rgba = _floats(m.get("rgba"), default=[0.5, 0.5, 0.5, 1.0])
                self.materials[m.get("name")] = rgba
            for mm in asset.findall("mesh"):
                name = mm.get("name") or os.path.splitext(os.path.basename(mm.get("file")))[0]
                scale = _floats(mm.get("scale"), 3, default=[1.0, 1.0, 1.0])
                path = mm.get("file")
                if not os.path.isabs(path):
                    path = os.path.join(self.meshdir, path)
                self.mesh_assets[name] = dict(path=path, scale=scale, loaded=None)

        # world body = body 0
        self.bodies.append(
            dict(name="world", parent=0, pos=np.zeros(3), quat=np.array([1.0, 0, 0, 0]),
                 mocap=False, explicit_inertial=True, mass=0.0,
                 ipos=np.zeros(3), iquat=np.array([1.0, 0, 0, 0]),
                 inertia=np.zeros(3), childclass=None, depth=0)
        )
        for wb in self.root.findall("worldbody"):
            for child in wb:
                self.parse_body_element(child, parent_id=0, childclass=None, depth=1)

        for tend in self.root.findall("tendon"):
            for t in tend:
                self.parse_tendon(t)
        for act in self.root.findall("actuator"):
            for a in act:
                self.parse_actuator(a)
        for eq in self.root.findall("equality"):
            for e in eq:
                self.parse_equality(e)
        for con in self.root.findall("contact"):
            for c in con:
                if c.tag == "exclude":
                    self.excludes.append((c.get("body1"), c.get("body2")))
                elif c.tag == "pair":
                    self.explicit_pairs.append(dict(c.attrib))

    # ------------------------------------------------------------------
    def parse_body_element(self, node: et.Element, parent_id: int, childclass, depth: int):
        if node.tag == "body":
            self.parse_body(node, parent_id, childclass, depth)
        elif node.tag == "geom":
            self.parse_geom(node, parent_id, childclass)
        elif node.tag == "site":
            self.parse_site(node, parent_id, childclass)
        elif node.tag in ("joint", "freejoint"):
            self.parse_joint(node, parent_id, childclass)
        elif node.tag == "camera":
            self.parse_camera(node, parent_id, childclass)
        elif node.tag == "light":
            self.parse_light(node, parent_id, childclass)

    def parse_light(self, node: et.Element, body_id: int, childclass):
        """<light>: position/direction in the parent body frame.

        Consumed by render/raycast.py's shading (directional or point
        Lambertian term). Ambient/diffuse RGB are reduced to scalar
        intensities — the raycaster shades monochromatically, matching the
        reference's headlight-intensity randomization contract
        (rearrange/simulation/base.py:774-788 set_lighting)."""
        cls = node.get("class", childclass)
        attrs = self.class_attrs("light", cls)
        amb = _floats(node.get("ambient", attrs.get("ambient")), 3,
                      default=[0.0, 0.0, 0.0])
        dif = _floats(node.get("diffuse", attrs.get("diffuse")), 3,
                      default=[0.7, 0.7, 0.7])
        self.lights.append(
            dict(
                name=node.get("name", f"light{len(self.lights)}"),
                body=body_id,
                pos=_floats(node.get("pos", attrs.get("pos")), 3,
                            default=[0, 0, 0]),
                dir=_floats(node.get("dir", attrs.get("dir")), 3,
                            default=[0, 0, -1]),
                directional=(node.get("directional",
                                      attrs.get("directional", "false"))
                             == "true"),
                ambient=float(np.mean(amb)),
                diffuse=float(np.mean(dif)),
                active=(node.get("active", "true") == "true"),
            )
        )

    def parse_body(self, node: et.Element, parent_id: int, childclass, depth: int):
        cls = node.get("childclass", childclass)
        body_id = len(self.bodies)
        binfo = dict(
            name=node.get("name", f"body{body_id}"),
            parent=parent_id,
            pos=_floats(node.get("pos"), 3, default=[0, 0, 0]),
            quat=self.orient(node, {}),
            mocap=node.get("mocap", "false") == "true",
            explicit_inertial=False,
            mass=0.0,
            ipos=np.zeros(3),
            iquat=np.array([1.0, 0, 0, 0]),
            inertia=np.zeros(3),
            childclass=cls,
            depth=depth,
        )
        self.bodies.append(binfo)

        inertial = node.find("inertial")
        if inertial is not None:
            binfo["explicit_inertial"] = True
            binfo["mass"] = float(inertial.get("mass"))
            binfo["ipos"] = _floats(inertial.get("pos"), 3, default=[0, 0, 0])
            binfo["iquat"] = self.orient(inertial, {})
            if inertial.get("diaginertia") is not None:
                binfo["inertia"] = _floats(inertial.get("diaginertia"))
            elif inertial.get("fullinertia") is not None:
                fi = _floats(inertial.get("fullinertia"))
                full = np.array(
                    [[fi[0], fi[3], fi[4]], [fi[3], fi[1], fi[5]], [fi[4], fi[5], fi[2]]]
                )
                w, v = np.linalg.eigh(full)
                binfo["inertia"] = w[::-1].copy()
                vm = v[:, ::-1].copy()
                # right-handedness must be enforced AFTER the column
                # reversal (reversing 3 columns itself flips det; a
                # reflection here made mat2quat emit a garbage frame that
                # permuted principal axes on degenerate inertias)
                if np.linalg.det(vm) < 0:
                    vm[:, 2] *= -1
                binfo["iquat"] = _np_quat_mul(binfo["iquat"], _np_mat2quat(vm))

        for child in node:
            if child.tag != "inertial":
                self.parse_body_element(child, body_id, cls, depth + 1)

    def parse_joint(self, node: et.Element, body_id: int, childclass):
        if node.tag == "freejoint":
            jtype = JointType.FREE
            cls = None
            a = lambda name, default=None: node.get(name, default)
        else:
            cls = node.get("class", childclass)
            a = lambda name, default=None: self.attr(node, "joint", name, cls, default)
            jtype = _JNT_TYPES[a("type", "hinge")]
        rng = _floats(a("range"), default=[0.0, 0.0])
        if jtype in (JointType.HINGE, JointType.BALL):
            rng = self.angle(rng)
        limited = a("limited", None)
        if limited is None:
            limited = bool(np.any(rng != 0)) and jtype != JointType.FREE
        else:
            limited = limited == "true"
        ref = _floats(a("ref"), default=[0.0])[0]
        springref = _floats(a("springref"), default=[0.0])[0]
        if jtype == JointType.HINGE:
            ref = self.angle(np.asarray([ref]))[0]
            springref = self.angle(np.asarray([springref]))[0]
        self.joints.append(
            dict(
                name=node.get("name", f"joint{len(self.joints)}"),
                type=jtype,
                body=body_id,
                pos=_floats(a("pos"), 3, default=[0, 0, 0]),
                axis=_floats(a("axis"), default=[0, 0, 1.0]),
                range=rng,
                limited=limited,
                damping=float(a("damping", 0.0) or 0.0),
                armature=float(a("armature", 0.0) or 0.0),
                stiffness=float(a("stiffness", 0.0) or 0.0),
                frictionloss=float(a("frictionloss", 0.0) or 0.0),
                margin=self.angle(np.asarray([float(a("margin", 0.0) or 0.0)]))[0]
                if jtype in (JointType.HINGE, JointType.BALL)
                else float(a("margin", 0.0) or 0.0),
                ref=ref,
                springref=springref,
                solref=_floats(a("solreflimit"), default=[0.02, 1.0]),
                solimp=_solimp(a("solimplimit")),
                solref_friction=_floats(a("solreffriction"), default=[0.02, 1.0]),
                solimp_friction=_solimp(a("solimpfriction")),
            )
        )

    def parse_geom(self, node: et.Element, body_id: int, childclass):
        cls = node.get("class", childclass)
        a = lambda name, default=None: self.attr(node, "geom", name, cls, default)
        gtype = _GEOM_TYPES[a("type", "sphere")]
        size = _floats(a("size"), default=[0.0])
        size = np.pad(size, (0, max(0, 3 - size.size)))[:3]
        pos = _floats(node.get("pos", self.class_attrs("geom", cls).get("pos")), 3, default=[0, 0, 0])
        quat = self.orient(node, self.class_attrs("geom", cls))
        fromto = a("fromto")
        if fromto is not None:
            ft = _floats(fromto)
            p0, p1 = ft[:3], ft[3:]
            pos = (p0 + p1) / 2
            z = p1 - p0
            length = np.linalg.norm(z)
            z = z / max(length, 1e-12)
            v = np.cross([0.0, 0.0, 1.0], z)
            w = 1.0 + z[2]
            quat = (
                np.array([0.0, 1.0, 0.0, 0.0])
                if w < 1e-12
                else np.concatenate([[w], v]) / np.linalg.norm(np.concatenate([[w], v]))
            )
            size = np.array([size[0], length / 2, 0.0])
        material = a("material")
        rgba = _floats(a("rgba"))
        if rgba is None:
            rgba = self.materials.get(material, np.array([0.5, 0.5, 0.5, 1.0]))
        mesh_name = a("mesh")
        mesh_id = -1
        if gtype == GeomType.MESH:
            assert mesh_name is not None, f"mesh geom {node.get('name')} without mesh"
            mesh_id = self.get_mesh_id(mesh_name)
        friction = _floats(a("friction"), default=[1.0, 0.005, 0.0001])
        friction = np.pad(friction, (0, max(0, 3 - friction.size)))[:3]
        mass_attr = a("mass")
        self.geoms.append(
            dict(
                name=node.get("name", f"geom{len(self.geoms)}"),
                type=gtype,
                body=body_id,
                pos=pos,
                quat=quat,
                size=size,
                friction=friction,
                density=float(a("density", 1000.0) or 1000.0),
                mass=None if mass_attr is None else float(mass_attr),
                condim=int(a("condim", 3) or 3),
                contype=int(a("contype", 1) or 1),
                conaffinity=int(a("conaffinity", 1) or 1),
                margin=float(a("margin", 0.0) or 0.0),
                gap=float(a("gap", 0.0) or 0.0),
                solref=_floats(a("solref"), default=[0.02, 1.0]),
                solimp=_solimp(a("solimp")),
                solmix=float(a("solmix", 1.0) or 1.0),
                priority=int(a("priority", 0) or 0),
                rgba=rgba,
                mesh=mesh_id,
                group=int(a("group", 0) or 0),
            )
        )

    def get_mesh_id(self, name: str) -> int:
        if name in self.mesh_ids:
            return self.mesh_ids[name]
        asset = self.mesh_assets[name]
        if asset["loaded"] is None:
            asset["loaded"] = mesh_lib.load_mesh_asset(asset["path"], asset["scale"])
        mid = len(self.mesh_ids)
        self.mesh_ids[name] = mid
        return mid

    def parse_site(self, node: et.Element, body_id: int, childclass):
        cls = node.get("class", childclass)
        a = lambda name, default=None: self.attr(node, "site", name, cls, default)
        size = _floats(a("size"), default=[0.005])
        size = np.pad(size, (0, max(0, 3 - size.size)))[:3]
        self.sites.append(
            dict(
                name=node.get("name", f"site{len(self.sites)}"),
                body=body_id,
                pos=_floats(node.get("pos", self.class_attrs("site", cls).get("pos")), 3, default=[0, 0, 0]),
                quat=self.orient(node, self.class_attrs("site", cls)),
                size=size,
            )
        )

    def parse_camera(self, node: et.Element, body_id: int, childclass):
        """Fixed-mode <camera>: pose in the parent body frame + fovy.

        MuJoCo frame convention (consumed by render/raycast.py): the camera
        looks along its local -Z axis, +X right, +Y up; `fovy` is the
        vertical field of view in degrees. Reference counterpart: OpenGL
        offscreen rendering of these cameras (robogym uses e.g.
        assets/xmls/robot/ur16e/base.xml vision_cam_front)."""
        cls = node.get("class", childclass)
        attrs = self.class_attrs("camera", cls)
        self.cameras.append(
            dict(
                name=node.get("name", f"camera{len(self.cameras)}"),
                body=body_id,
                pos=_floats(node.get("pos", attrs.get("pos")), 3,
                            default=[0, 0, 0]),
                quat=self.orient(node, attrs),
                fovy=float(node.get("fovy", attrs.get("fovy", 45.0))),
            )
        )

    # ------------------------------------------------------------------
    def parse_tendon(self, node: et.Element):
        cls = node.get("class")
        tag = node.tag  # fixed | spatial
        a = lambda name, default=None: self.attr(node, tag, name, cls, default)
        rng = _floats(a("range"), default=[0.0, 0.0])
        tinfo = dict(
            name=node.get("name", f"tendon{len(self.tendons)}"),
            kind=tag,
            limited=(a("limited", "false") == "true") or bool(np.any(rng != 0)),
            range=rng,
            damping=float(a("damping", 0.0) or 0.0),
            stiffness=float(a("stiffness", 0.0) or 0.0),
            springlength=float(a("springlength", -1.0) or -1.0),
            frictionloss=float(a("frictionloss", 0.0) or 0.0),
            margin=float(a("margin", 0.0) or 0.0),
            solref=_floats(a("solreflimit"), default=[0.02, 1.0]),
            solimp=_solimp(a("solimplimit")),
            wrap_adr=len(self.wraps),
            wrap_num=0,
        )
        for w in node:
            if w.tag == "joint":
                self.wraps.append(
                    dict(type=WrapType.JOINT, obj=w.get("joint"), prm=float(w.get("coef")))
                )
            elif w.tag == "site":
                self.wraps.append(dict(type=WrapType.SITE, obj=w.get("site"), prm=0.0))
            elif w.tag == "geom":
                self.wraps.append(
                    dict(type=WrapType.SPHERE, obj=w.get("geom"), prm=0.0,
                         sidesite=w.get("sidesite"))
                )
            elif w.tag == "pulley":
                self.wraps.append(
                    dict(type=WrapType.PULLEY, obj=None, prm=float(w.get("divisor", 1.0)))
                )
            tinfo["wrap_num"] += 1
        self.tendons.append(tinfo)

    def parse_actuator(self, node: et.Element):
        cls = node.get("class")
        tag = node.tag
        a = lambda name, default=None: self.attr(node, tag, name, cls, default) \
            if self.attr(node, tag, name, cls, default) is not None \
            else self.attr(node, "general", name, cls, default)
        gainprm = np.zeros(10)
        biasprm = np.zeros(10)
        dynprm = np.zeros(3)
        gaintype, biastype, dyntype = GainType.FIXED, BiasType.NONE, DynType.NONE
        if tag == "general":
            gaintype = {"fixed": GainType.FIXED, "user": GainType.USER}[a("gaintype", "fixed")]
            biastype = {"none": BiasType.NONE, "affine": BiasType.AFFINE, "user": BiasType.USER}[
                a("biastype", "none")
            ]
            gp = _floats(a("gainprm"), default=[1.0])
            gainprm[: gp.size] = gp
            bp = _floats(a("biasprm"))
            if bp is not None:
                biasprm[: bp.size] = bp
            dp = _floats(a("dynprm"))
            if dp is not None:
                dynprm[: dp.size] = dp
        elif tag == "motor":
            gainprm[0] = 1.0
        elif tag == "position":
            kp = float(a("kp", 1.0) or 1.0)
            gaintype, biastype = GainType.FIXED, BiasType.AFFINE
            gainprm[0] = kp
            biasprm[1] = -kp
        elif tag == "velocity":
            kv = float(a("kv", 1.0) or 1.0)
            gaintype, biastype = GainType.FIXED, BiasType.AFFINE
            gainprm[0] = kv
            biasprm[2] = -kv
        else:
            raise NotImplementedError(f"actuator <{tag}>")

        joint, tendon = a("joint"), a("tendon")
        user = _floats(a("user"), default=[0.0])
        ctrlrange = _floats(a("ctrlrange"), default=[0.0, 0.0])
        forcerange = _floats(a("forcerange"), default=[0.0, 0.0])
        ctrllimited = a("ctrllimited")
        forcelimited = a("forcelimited")
        gear = _floats(a("gear"), default=[1.0])
        gear6 = np.zeros(6)
        gear6[: gear.size] = gear
        self.actuators.append(
            dict(
                name=node.get("name", f"actuator{len(self.actuators)}"),
                trntype=TrnType.JOINT if joint is not None else TrnType.TENDON,
                trn=joint if joint is not None else tendon,
                gaintype=gaintype,
                biastype=biastype,
                dyntype=dyntype,
                user=float(user[0]),
                gainprm=gainprm,
                biasprm=biasprm,
                dynprm=dynprm,
                ctrlrange=ctrlrange,
                forcerange=forcerange,
                ctrllimited=(ctrllimited == "true") if ctrllimited is not None else bool(np.any(ctrlrange != 0)),
                forcelimited=(forcelimited == "true") if forcelimited is not None else bool(np.any(forcerange != 0)),
                gear=gear6,
            )
        )

    def parse_equality(self, node: et.Element):
        cls = node.get("class")
        a = lambda name, default=None: self.attr(node, node.tag, name, cls, default)
        data = np.zeros(11)
        if node.tag == "weld":
            etype = EqType.WELD
            obj1, obj2 = node.get("body1"), node.get("body2")
            relpose = _floats(node.get("relpose"))
            if relpose is not None:
                data[3:10] = relpose
            else:
                data[6] = 1.0  # identity quat marker; resolved at qpos0 if all-zero
        elif node.tag == "joint":
            etype = EqType.JOINT
            obj1, obj2 = node.get("joint1"), node.get("joint2")
            poly = _floats(node.get("polycoef"), default=[0, 1, 0, 0, 0])
            data[: poly.size] = poly
        elif node.tag == "connect":
            etype = EqType.CONNECT
            obj1, obj2 = node.get("body1"), node.get("body2")
            anchor = _floats(node.get("anchor"), default=[0, 0, 0])
            data[:3] = anchor
        else:
            raise NotImplementedError(f"equality <{node.tag}>")
        self.equalities.append(
            dict(
                type=etype,
                obj1=obj1,
                obj2=obj2,
                active=a("active", "true") != "false",
                data=data,
                solref=_floats(a("solref"), default=[0.02, 1.0]),
                solimp=_solimp(a("solimp")),
            )
        )

    # ------------------------------------------------------------------
    def build(self, dtype=torch.float32) -> Dict[str, np.ndarray]:
        """The compiled model as a `bridge.model_to_numpy` dict: every field
        computed in float64 and cast once to `dtype`."""
        b = self.bodies
        nbody = len(b)
        name2body = {bi["name"]: i for i, bi in enumerate(b)}
        name2joint = {j["name"]: i for i, j in enumerate(self.joints)}
        name2geom = {g["name"]: i for i, g in enumerate(self.geoms)}
        name2site = {s["name"]: i for i, s in enumerate(self.sites)}
        name2tendon = {t["name"]: i for i, t in enumerate(self.tendons)}
        name2act = {a["name"]: i for i, a in enumerate(self.actuators)}
        name2mesh = dict(self.mesh_ids)

        # ---- joints / dofs addressing
        njnt = len(self.joints)
        jnt_qposadr = np.zeros(njnt, np.int32)
        jnt_dofadr = np.zeros(njnt, np.int32)
        nq = nv = 0
        for i, j in enumerate(self.joints):
            jnt_qposadr[i] = nq
            jnt_dofadr[i] = nv
            nq += JointType.QPOS_WIDTH[j["type"]]
            nv += JointType.DOF_WIDTH[j["type"]]

        body_jntadr = np.full(nbody, -1, np.int32)
        body_jntnum = np.zeros(nbody, np.int32)
        body_dofadr = np.full(nbody, -1, np.int32)
        body_dofnum = np.zeros(nbody, np.int32)
        for i, j in enumerate(self.joints):
            bid = j["body"]
            if body_jntadr[bid] < 0:
                body_jntadr[bid] = i
                body_dofadr[bid] = jnt_dofadr[i]
            body_jntnum[bid] += 1
            body_dofnum[bid] += JointType.DOF_WIDTH[j["type"]]

        body_parentid = np.array([bi["parent"] for bi in b], np.int32)
        # rootid: top-most non-world ancestor
        body_rootid = np.zeros(nbody, np.int32)
        for i in range(1, nbody):
            r = i
            while body_parentid[r] != 0:
                r = body_parentid[r]
            body_rootid[i] = r
        # weldid: nearest ancestor (or self) with dofs; world-welded -> 0
        body_weldid = np.zeros(nbody, np.int32)
        for i in range(1, nbody):
            w = i
            while w != 0 and body_dofnum[w] == 0:
                w = body_parentid[w]
            body_weldid[i] = w

        dof_jntid = np.zeros(nv, np.int32)
        dof_bodyid = np.zeros(nv, np.int32)
        for i, j in enumerate(self.joints):
            for k in range(JointType.DOF_WIDTH[j["type"]]):
                dof_jntid[jnt_dofadr[i] + k] = i
                dof_bodyid[jnt_dofadr[i] + k] = j["body"]
        # dof parent chain: last dof of parent body's chain
        last_dof_of_body = np.full(nbody, -1, np.int32)
        dof_parentid = np.full(nv, -1, np.int32)
        for i, j in enumerate(self.joints):
            bid = j["body"]
            # parent dof = last dof of nearest ancestor with dofs (or earlier joint in same body)
            if last_dof_of_body[bid] >= 0:
                parent_dof = last_dof_of_body[bid]
            else:
                anc = body_parentid[bid]
                while anc != 0 and last_dof_of_body[anc] < 0:
                    anc = body_parentid[anc]
                parent_dof = last_dof_of_body[anc] if anc != 0 else -1
            for k in range(JointType.DOF_WIDTH[j["type"]]):
                adr = jnt_dofadr[i] + k
                dof_parentid[adr] = parent_dof
                parent_dof = adr
            last_dof_of_body[bid] = parent_dof
        # propagate: bodies with no dofs should pass through ancestors' last dof
        # (handled by the ancestor walk above)

        # ---- body tree by depth (for FK scans)
        maxdepth = max(bi["depth"] for bi in b) if nbody > 1 else 0
        tree_levels = []
        for d in range(1, maxdepth + 1):
            lvl = tuple(i for i in range(1, nbody) if b[i]["depth"] == d)
            if lvl:
                tree_levels.append(lvl)

        # ---- mocap
        body_mocapid = np.full(nbody, -1, np.int32)
        nmocap = 0
        for i, bi in enumerate(b):
            if bi["mocap"]:
                body_mocapid[i] = nmocap
                nmocap += 1

        # ---- inertia defaults from geoms
        for i, bi in enumerate(b):
            if bi["explicit_inertial"] or i == 0:
                continue
            masses, coms, inertias = [], [], []
            for g in self.geoms:
                if g["body"] != i:
                    continue
                m, com_g, I_g = self.geom_mass_props(g)
                masses.append(m)
                coms.append(com_g)
                inertias.append(I_g)
            if not masses or sum(masses) <= 0:
                # body with joints must have mass; tiny default like MuJoCo boundmass
                bi["mass"] = 0.0
                bi["inertia"] = np.zeros(3)
                continue
            mtot = float(sum(masses))
            com = sum(m * c for m, c in zip(masses, coms)) / mtot
            Itot = np.zeros((3, 3))
            for m, c, I in zip(masses, coms, inertias):
                r = c - com
                Itot += I + m * ((r @ r) * np.eye(3) - np.outer(r, r))
            w, v = np.linalg.eigh(Itot)
            vm = v[:, ::-1].copy()
            # enforce right-handedness AFTER column reversal (see above)
            if np.linalg.det(vm) < 0:
                vm[:, 2] *= -1
            bi["mass"] = mtot
            bi["ipos"] = com
            bi["inertia"] = np.maximum(w[::-1].copy(), 1e-12)
            bi["iquat"] = _np_mat2quat(vm)

        # ---- wrap/tendon tables
        nwrap = len(self.wraps)
        wrap_type = np.array([w["type"] for w in self.wraps], np.int32) if nwrap else np.zeros(0, np.int32)
        wrap_objid = np.zeros(nwrap, np.int32)
        wrap_prm = np.zeros(nwrap)
        for i, w in enumerate(self.wraps):
            wrap_prm[i] = w["prm"]
            if w["type"] == WrapType.JOINT:
                wrap_objid[i] = name2joint[w["obj"]]
            elif w["type"] == WrapType.SITE:
                wrap_objid[i] = name2site[w["obj"]]
            elif w["type"] == WrapType.SPHERE:
                wrap_objid[i] = name2geom[w["obj"]]

        # ---- actuators
        nu = len(self.actuators)
        actuator_trnid = np.zeros(nu, np.int32)
        for i, a in enumerate(self.actuators):
            actuator_trnid[i] = (
                name2joint[a["trn"]] if a["trntype"] == TrnType.JOINT else name2tendon[a["trn"]]
            )
        # act state: controller state slots per user-gain actuator.
        # PID uses [integral, prev_err, d_smooth]; cascaded PI (user="1",
        # mujoco-py mjpid.pyx) uses [pos_integral, vel_integral,
        # smoothed_des_vel, prev_err] — allocate 4 uniformly.
        actuator_actadr = np.full(nu, -1, np.int32)
        na = 0
        for i, a in enumerate(self.actuators):
            if a["gaintype"] == GainType.USER or a["dyntype"] != DynType.NONE:
                actuator_actadr[i] = na
                na += 4

        # ---- equality
        neq = len(self.equalities)
        eq_obj1id = np.zeros(neq, np.int32)
        eq_obj2id = np.zeros(neq, np.int32)
        eq_type = np.array([e["type"] for e in self.equalities], np.int32) if neq else np.zeros(0, np.int32)
        for i, e in enumerate(self.equalities):
            table = name2body if e["type"] in (EqType.WELD, EqType.CONNECT) else name2joint
            eq_obj1id[i] = table[e["obj1"]]
            eq_obj2id[i] = table.get(e["obj2"], 0) if e["obj2"] is not None else 0

        # ---- collision pairs
        geom_contype = np.array([g["contype"] for g in self.geoms], np.int32)
        geom_conaffinity = np.array([g["conaffinity"] for g in self.geoms], np.int32)
        geom_bodyid = np.array([g["body"] for g in self.geoms], np.int32)
        geom_type_arr = np.array([g["type"] for g in self.geoms], np.int32)
        exclude_body_pairs = set()
        for b1, b2 in self.excludes:
            if b1 in name2body and b2 in name2body:
                i1, i2 = name2body[b1], name2body[b2]
                exclude_body_pairs.add((min(i1, i2), max(i1, i2)))
        pairs = []
        pair_ncon = []
        ngeom = len(self.geoms)
        for g1 in range(ngeom):
            for g2 in range(g1 + 1, ngeom):
                b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
                if b1 == b2:
                    continue
                w1, w2 = body_weldid[b1], body_weldid[b2]
                if w1 == w2:
                    continue
                # parent filter (skip if welded parent-child, unless parent is world)
                pw1 = body_weldid[body_parentid[w1]] if w1 != 0 else -1
                pw2 = body_weldid[body_parentid[w2]] if w2 != 0 else -1
                if (pw1 == w2 and w2 != 0) or (pw2 == w1 and w1 != 0):
                    continue
                if (min(b1, b2), max(b1, b2)) in exclude_body_pairs:
                    continue
                if not (
                    (geom_contype[g1] & geom_conaffinity[g2])
                    or (geom_contype[g2] & geom_conaffinity[g1])
                ):
                    continue
                t1, t2 = int(geom_type_arr[g1]), int(geom_type_arr[g2])
                key = (min(t1, t2), max(t1, t2))
                if key not in _PAIR_NCON:
                    continue  # unsupported pair type (e.g. plane-plane)
                # order pair so that the lower type id comes first
                if t1 <= t2:
                    pairs.append((g1, g2))
                else:
                    pairs.append((g2, g1))
                pair_ncon.append(_PAIR_NCON[key])
        collision_pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
        pair_ncon_arr = np.asarray(pair_ncon, np.int32)

        # ---- ancestor dof mask (nbody, nv)
        body_dof_mask = np.zeros((nbody, nv))
        for bid in range(1, nbody):
            anc = bid
            while anc != 0:
                if body_dofadr[anc] >= 0:
                    s, n = body_dofadr[anc], body_dofnum[anc]
                    body_dof_mask[bid, s : s + n] = 1.0
                anc = body_parentid[anc]

        # ---- qpos0 (joint refs; free joints take the body's world pose)
        qpos0 = np.zeros(nq)
        for i, j in enumerate(self.joints):
            adr = jnt_qposadr[i]
            t = j["type"]
            if t == JointType.FREE:
                bid = j["body"]
                assert body_parentid[bid] == 0, (
                    f"free joint on non-root body {b[bid]['name']}"
                )
                qpos0[adr : adr + 3] = b[bid]["pos"]
                qpos0[adr + 3 : adr + 7] = b[bid]["quat"]
            elif t == JointType.BALL:
                qpos0[adr] = 1.0
            else:
                qpos0[adr] = j["ref"]

        const = dict(
            nq=nq, nv=nv, nu=nu, na=na, nbody=nbody, njnt=njnt,
            ngeom=ngeom, nsite=len(self.sites), nmesh=len(self.mesh_ids),
            ntendon=len(self.tendons), nwrap=nwrap, neq=neq, nmocap=nmocap,
            nsensor=0,
            body_parentid=body_parentid, body_rootid=body_rootid,
            body_weldid=body_weldid,
            body_jntadr=body_jntadr, body_jntnum=body_jntnum,
            body_dofadr=body_dofadr, body_dofnum=body_dofnum,
            body_mocapid=body_mocapid, body_tree=tuple(tree_levels),
            jnt_type=np.array([j["type"] for j in self.joints], np.int32),
            jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
            jnt_bodyid=np.array([j["body"] for j in self.joints], np.int32),
            jnt_limited=np.array([j["limited"] for j in self.joints], bool),
            dof_jntid=dof_jntid, dof_bodyid=dof_bodyid, dof_parentid=dof_parentid,
            geom_type=geom_type_arr, geom_bodyid=geom_bodyid,
            geom_dataid=np.array([g["mesh"] for g in self.geoms], np.int32),
            geom_contype=geom_contype, geom_conaffinity=geom_conaffinity,
            geom_condim=np.array([g["condim"] for g in self.geoms], np.int32),
            site_bodyid=np.array([s["body"] for s in self.sites], np.int32),
            tendon_adr=np.array([t["wrap_adr"] for t in self.tendons], np.int32),
            tendon_num=np.array([t["wrap_num"] for t in self.tendons], np.int32),
            tendon_limited=np.array([t["limited"] for t in self.tendons], bool),
            wrap_type=wrap_type, wrap_objid=wrap_objid,
            actuator_trntype=np.array([a["trntype"] for a in self.actuators], np.int32),
            actuator_trnid=actuator_trnid,
            actuator_gaintype=np.array([a["gaintype"] for a in self.actuators], np.int32),
            actuator_biastype=np.array([a["biastype"] for a in self.actuators], np.int32),
            actuator_dyntype=np.array([a["dyntype"] for a in self.actuators], np.int32),
            actuator_actadr=actuator_actadr,
            actuator_user=np.array([a.get("user", 0.0) for a in self.actuators], np.float64) if nu else np.zeros(0),
            actuator_ctrllimited=np.array([a["ctrllimited"] for a in self.actuators], bool),
            actuator_forcelimited=np.array([a["forcelimited"] for a in self.actuators], bool),
            eq_type=eq_type, eq_obj1id=eq_obj1id, eq_obj2id=eq_obj2id,
            collision_pairs=collision_pairs, pair_ncon=pair_ncon_arr,
            body_dof_mask=body_dof_mask,
            dof_has_frictionloss=np.concatenate(
                [
                    np.full(JointType.DOF_WIDTH[j["type"]], j["frictionloss"] > 0)
                    for j in self.joints
                ]
            ) if self.joints else np.zeros(0, bool),
            ncam=len(self.cameras),
            cam_bodyid=np.array([c["body"] for c in self.cameras], np.int32),
            nlight=len(self.lights),
            light_bodyid=np.array([l["body"] for l in self.lights], np.int32),
            light_directional=np.array(
                [l["directional"] for l in self.lights], bool
            ),
            names=dict(
                body=name2body, joint=name2joint, geom=name2geom, site=name2site,
                tendon=name2tendon, actuator=name2act, mesh=name2mesh,
                camera={c["name"]: i for i, c in enumerate(self.cameras)},
            ),
        )

        # ---- option
        oa = self.option_attrs
        option = dict(
            timestep=float(oa.get("timestep", 0.002)),
            gravity=_floats(oa.get("gravity"), default=[0, 0, -9.81]),
            wind=_floats(oa.get("wind"), default=[0, 0, 0]),
            density=float(oa.get("density", 0.0)),
            viscosity=float(oa.get("viscosity", 0.0)),
            impratio=float(oa.get("impratio", 1.0)),
            iterations=int(oa.get("iterations", 30)),
            # our CG solver's budget is distinct from MuJoCo's Newton
            # `iterations`, but models that need tighter convergence than
            # the tuned default can say so: the nonstandard attribute
            # `cg_iterations` overrides directly
            **({"cg_iterations": int(oa["cg_iterations"])}
               if "cg_iterations" in oa else {}),
            cone=ConeType.PYRAMIDAL if oa.get("cone", "pyramidal") == "pyramidal" else ConeType.ELLIPTIC,
            integrator=IntegratorType.EULER,
        )

        # ---- mesh hull buffers (padded)
        nmesh = len(self.mesh_ids)
        hull_v = np.zeros((max(nmesh, 1), MAX_HULL_VERTS, 3))
        hull_m = np.zeros((max(nmesh, 1), MAX_HULL_VERTS))
        hull_c = np.zeros((max(nmesh, 1), 3))
        face_p = np.zeros((max(nmesh, 1), MAX_HULL_FACES, 4))
        face_m = np.zeros((max(nmesh, 1), MAX_HULL_FACES))
        for name, mid in self.mesh_ids.items():
            hull = self.mesh_assets[name]["loaded"]["hull"]
            k = min(len(hull), MAX_HULL_VERTS)
            hull_v[mid, :k] = hull[:k]
            hull_m[mid, :k] = 1.0
            hull_c[mid] = hull[:k].mean(axis=0)
            planes = mesh_lib.hull_face_planes(hull[:k], MAX_HULL_FACES)
            face_p[mid, : len(planes)] = planes
            face_m[mid, : len(planes)] = 1.0

        asnp = lambda key, arrs, width=None: (
            np.asarray([a[key] for a in arrs])
            if arrs
            else np.zeros((0,) if width is None else (0, width))
        )

        J = self.joints
        G = self.geoms
        T = self.tendons
        A = self.actuators
        E = self.equalities

        eq_data = asnp("data", E, 11)
        # weld with unresolved relpose (marker) resolved later at first forward
        fields = dict(
            qpos0=(qpos0),
            body_pos=(asnp("pos", b, 3)),
            body_quat=(asnp("quat", b, 4)),
            body_ipos=(asnp("ipos", b, 3)),
            body_iquat=(asnp("iquat", b, 4)),
            body_mass=(asnp("mass", b)),
            body_inertia=(asnp("inertia", b, 3)),
            jnt_pos=(asnp("pos", J, 3)),
            # MuJoCo's compiler NORMALIZES joint axes; hand XMLs carry
            # 3-digit axes (e.g. LFJ4 "0.571 0 0.821", |a|=1.000041) and the
            # un-normalized axis shifts qM rows by ~2e-5 relative — the
            # dominant term of the reach-world conformance divergence
            jnt_axis=(_normalize_rows(asnp("axis", J, 3))),
            jnt_range=(asnp("range", J, 2)),
            jnt_margin=(asnp("margin", J)),
            jnt_stiffness=(asnp("stiffness", J)),
            jnt_springref=(asnp("springref", J)),
            jnt_solref=(asnp("solref", J, 2)),
            jnt_solimp=(asnp("solimp", J, 5)),
            dof_armature=(
                np.concatenate([np.full(JointType.DOF_WIDTH[j["type"]], j["armature"]) for j in J])
                if J else np.zeros(0)),
            dof_damping=(
                np.concatenate([np.full(JointType.DOF_WIDTH[j["type"]], j["damping"]) for j in J])
                if J else np.zeros(0)),
            dof_frictionloss=(
                np.concatenate([np.full(JointType.DOF_WIDTH[j["type"]], j["frictionloss"]) for j in J])
                if J else np.zeros(0)),
            dof_solref=(
                np.concatenate([np.tile(j["solref_friction"], (JointType.DOF_WIDTH[j["type"]], 1)) for j in J])
                if J else np.zeros((0, 2))),
            dof_solimp=(
                np.concatenate([np.tile(j["solimp_friction"], (JointType.DOF_WIDTH[j["type"]], 1)) for j in J])
                if J else np.zeros((0, 5))),
            geom_pos=(asnp("pos", G, 3)),
            geom_quat=(asnp("quat", G, 4)),
            geom_size=(asnp("size", G, 3)),
            geom_friction=(asnp("friction", G, 3)),
            geom_solref=(asnp("solref", G, 2)),
            geom_solimp=(asnp("solimp", G, 5)),
            geom_solmix=(asnp("solmix", G)),
            geom_margin=(asnp("margin", G)),
            geom_gap=(asnp("gap", G)),
            geom_priority=(asnp("priority", G)),
            geom_rgba=(asnp("rgba", G, 4)),
            site_pos=(asnp("pos", self.sites, 3)),
            site_quat=(asnp("quat", self.sites, 4)),
            mesh_convex_vert=(hull_v),
            mesh_convex_mask=(hull_m),
            mesh_convex_center=(hull_c),
            mesh_face_plane=(face_p),
            mesh_face_mask=(face_m),
            cam_pos=(asnp("pos", self.cameras, 3)),
            cam_quat=(asnp("quat", self.cameras, 4)),
            cam_fovy=(asnp("fovy", self.cameras)),
            light_pos=(asnp("pos", self.lights, 3)),
            light_dir=(asnp("dir", self.lights, 3)),
            light_ambient=(asnp("ambient", self.lights)),
            light_diffuse=(asnp("diffuse", self.lights)),
            light_active=(asnp("active", self.lights)),
            headlight_diffuse=(0.4),
            headlight_ambient=(0.1),
            tendon_range=(asnp("range", T, 2)),
            tendon_stiffness=(asnp("stiffness", T)),
            tendon_damping=(asnp("damping", T)),
            tendon_lengthspring=(asnp("springlength", T)),
            tendon_margin=(asnp("margin", T)),
            tendon_solref=(asnp("solref", T, 2)),
            tendon_solimp=(asnp("solimp", T, 5)),
            tendon_frictionloss=(asnp("frictionloss", T)),
            wrap_prm=(wrap_prm),
            actuator_gainprm=(asnp("gainprm", A, 10)),
            actuator_biasprm=(asnp("biasprm", A, 10)),
            actuator_dynprm=(asnp("dynprm", A, 3)),
            actuator_ctrlrange=(asnp("ctrlrange", A, 2)),
            actuator_forcerange=(asnp("forcerange", A, 2)),
            actuator_gear=(asnp("gear", A, 6)),
            eq_active=(asnp("active", E)),
            eq_data=(eq_data),
            eq_solref=(asnp("solref", E, 2)),
            eq_solimp=(asnp("solimp", E, 5)),
        )
        return _arrays(const, option, fields, dtype)

    # ------------------------------------------------------------------
    def geom_mass_props(self, g: dict):
        """(mass, com_in_body, inertia_about_com) for one geom."""
        t, size = g["type"], g["size"]
        d = g["density"]
        R = _np_quat2mat(g["quat"])
        if t == GeomType.SPHERE:
            r = size[0]
            vol = 4.0 / 3.0 * np.pi * r**3
            m = g["mass"] if g["mass"] is not None else d * vol
            I = np.eye(3) * (2.0 / 5.0 * m * r**2)
        elif t == GeomType.BOX:
            a_, b_, c_ = size
            vol = 8 * a_ * b_ * c_
            m = g["mass"] if g["mass"] is not None else d * vol
            I = m / 3.0 * np.diag([b_**2 + c_**2, a_**2 + c_**2, a_**2 + b_**2])
        elif t == GeomType.CAPSULE:
            r, hh = size[0], size[1]
            vc = np.pi * r**2 * (2 * hh)
            vs = 4.0 / 3.0 * np.pi * r**3
            vol = vc + vs
            m = g["mass"] if g["mass"] is not None else d * vol
            mc, ms = m * vc / vol, m * vs / vol
            Ixy = mc * ((2 * hh) ** 2 / 12.0 + r**2 / 4.0) + ms * (
                2.0 / 5.0 * r**2 + hh**2 + 3.0 / 8.0 * 2 * hh * r
            )
            Iz = mc * r**2 / 2.0 + ms * 2.0 / 5.0 * r**2
            I = np.diag([Ixy, Ixy, Iz])
        elif t == GeomType.CYLINDER:
            r, hh = size[0], size[1]
            vol = np.pi * r**2 * 2 * hh
            m = g["mass"] if g["mass"] is not None else d * vol
            I = np.diag(
                [m * (3 * r**2 + (2 * hh) ** 2) / 12.0] * 2 + [m * r**2 / 2.0]
            )
        elif t == GeomType.ELLIPSOID:
            a_, b_, c_ = size
            vol = 4.0 / 3.0 * np.pi * a_ * b_ * c_
            m = g["mass"] if g["mass"] is not None else d * vol
            I = m / 5.0 * np.diag([b_**2 + c_**2, a_**2 + c_**2, a_**2 + b_**2])
        elif t == GeomType.MESH:
            asset = None
            for name, mid in self.mesh_ids.items():
                if mid == g["mesh"]:
                    asset = self.mesh_assets[name]["loaded"]
            vol, com_m, I_unit = asset["volume"], asset["com"], asset["inertia"]
            m = g["mass"] if g["mass"] is not None else d * vol
            I = I_unit * (m / vol)
            com = g["pos"] + R @ com_m
            return m, com, R @ I @ R.T
        else:  # plane etc: massless
            return 0.0, g["pos"], np.zeros((3, 3))
        return m, g["pos"], R @ I @ R.T


def _arrays(const: dict, option: dict, fields: dict, dtype) -> Dict[str, np.ndarray]:
    """`bridge.model_to_numpy`'s dict of a model: the const as it is (the
    body tree and the names as JSON text), the option's tensors and every
    model field in `dtype` (each cast from float64 once), the option's
    static fields with the port's defaults where the XML sets none."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    out = {}
    for k, v in const.items():
        if k == "body_tree":
            out["const.body_tree"] = np.asarray(json.dumps([list(map(int, lvl)) for lvl in v]))
        elif k == "names":
            out["const.names"] = np.asarray(json.dumps(v, sort_keys=True))
        else:
            out["const." + k] = np.asarray(v)
    defaults = {f.name: f.default for f in dataclasses.fields(Option)}
    for k in OPTION_TENSORS:
        out["opt." + k] = np.asarray(option[k], np.float64).astype(np_dtype)
    for k in OPTION_STATIC:
        out["opt." + k] = np.asarray(option.get(k, defaults[k]))
    for k, v in fields.items():
        out["model." + k] = np.asarray(v, np.float64).astype(np_dtype)
    return out


def compile_xml(xml: "MjcfXML | str", dtype=torch.float32, device="cuda"):
    """Compile a composed MJCF document (or raw XML string) into the
    port's `Model` on `device` (the card unless the caller asks for the
    CPU).

    The source XML string is stashed on `model.const._source_xml` so
    host-side tooling (the goal-settle world, holdout authoring) can
    rebuild the scene without re-plumbing it, and the `invweight0` cache
    (MuJoCo's mj_setConst analogue) is warmed."""
    from robogym_torch import bridge
    from robogym_torch.physics.setconst import invweight0

    if isinstance(xml, str):
        xml = MjcfXML.from_string(xml)
    comp = _Compiler(copy.deepcopy(xml.root_element))
    comp.parse()
    model = bridge.model_from_numpy(comp.build(dtype=dtype), device)
    object.__setattr__(model.const, "_source_xml", xml.xml_string())
    invweight0(model)
    return model

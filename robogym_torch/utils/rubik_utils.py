"""The Rubik's cube solver bridge and facelet conversion, host-side numpy
(the port's own copy of `robogym_tpu/utils/rubik_utils.py`; reference
robogym/utils/rubik_utils.py).

`solve_fast` gives a move sequence for a scrambled cube, through the native
two-phase solver in `native/rubik/two_phase.cc` (ctypes). The committed
`native/rubik/librubik.so` is loaded where it loads and is not older than
its source; else the library is built with `g++` into `build/rubik/` at
the root of the checkout (ignored by git), never into `native/`. A library
that neither loads nor builds raises.

Also the cubelet-state -> facelet-string conversion that the reference
takes from pycuber (CubeManipulator.to_pycuber), and the move string ->
face rotation list for `envs/dactyl/cube_manipulator.rotate_face`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native", "rubik")
_LIB_PATH = os.path.join(_NATIVE_DIR, "librubik.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "two_phase.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "rubik")

SOLVED_FACELETS = "UUUUUUUUURRRRRRRRRFFFFFFFFFDDDDDDDDDLLLLLLLLLBBBBBBBBB"

# move letter -> (axis, side) in the cube_manipulator convention
# (+X Right, -Y Front, +Z Up)
MOVE_FACE = {
    "U": (2, 1), "D": (2, 0), "R": (0, 1), "L": (0, 0),
    "B": (1, 1), "F": (1, 0),
}

_lib = None


def _build_library() -> str:
    """Compile two_phase.cc into BUILD_DIR; returns the library's path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "librubik.so")
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC_PATH],
                   check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _load(path: str):
    lib = ctypes.CDLL(path)
    lib.rubik_solve.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.rubik_solve.restype = ctypes.c_int
    lib.rubik_apply.argtypes = [ctypes.c_char_p] * 3
    lib.rubik_apply.restype = ctypes.c_int
    lib.rubik_selftest.restype = ctypes.c_int
    lib.rubik_init()
    return lib


def get_library():
    """The solver library, loaded once a process."""
    global _lib
    if _lib is None:
        lib = None
        stale = os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH) \
            if os.path.exists(_LIB_PATH) else True
        if not stale:
            try:
                lib = _load(_LIB_PATH)
            except OSError:
                lib = None
        if lib is None:
            built = os.path.join(BUILD_DIR, "librubik.so")
            if not (os.path.exists(built)
                    and os.path.getmtime(built) >= os.path.getmtime(_SRC_PATH)):
                built = _build_library()
            lib = _load(built)
        _lib = lib
    return _lib


def is_legal(facelets: str) -> bool:
    """Whether a facelet string has nine facelets of each colour and each
    centre in place, the solver's check before it searches."""
    return len(facelets) == 54 and all(facelets.count(face) == 9 and facelets[9 * i + 4] == face
                                       for i, face in enumerate("URFDLB"))


def solve_fast(facelets: str, max_depth: int = 24) -> Optional[str]:
    """Two-phase solve: a space-separated move string like "U R2 F'", or
    None for a facelet string that is not `is_legal` or that the search
    does not solve."""
    if not is_legal(facelets):
        return None
    out = ctypes.create_string_buffer(512)
    n = get_library().rubik_solve(facelets.encode(), max_depth, out, 512)
    if n < 0:
        return None
    return out.value.decode()


def apply_moves(facelets: str, moves: str) -> Optional[str]:
    """The facelet string after `moves`, or None if the solver rejects it."""
    out = ctypes.create_string_buffer(64)
    if get_library().rubik_apply(facelets.encode(), moves.encode(), out) != 0:
        return None
    return out.value.decode()


# ---------------------------------------------------------------------------
# cubelet (euler-hinge) state -> facelet string
# ---------------------------------------------------------------------------

def _facelet_table():
    """Facelet index -> (cubelet coordinate, outward normal), the kociemba
    layout on the cube axes (+X Right, -Y Front, +Z Up)."""
    table = []

    def face(normal, origin, drow, dcol):
        for r in range(3):
            for c in range(3):
                coord = np.array(origin) + r * np.array(drow) + c * np.array(dcol)
                table.append((coord, np.array(normal)))

    face((0, 0, 1), (-1, 1, 1), (0, -1, 0), (1, 0, 0))     # U: rows back to front
    face((1, 0, 0), (1, -1, 1), (0, 0, -1), (0, 1, 0))     # R: rows top to bottom
    face((0, -1, 0), (-1, -1, 1), (0, 0, -1), (1, 0, 0))   # F
    face((0, 0, -1), (-1, -1, -1), (0, 1, 0), (1, 0, 0))   # D: rows front to back
    face((-1, 0, 0), (-1, 1, 1), (0, 0, -1), (0, -1, 0))   # L: columns back to front
    face((0, 1, 0), (1, 1, 1), (0, 0, -1), (-1, 0, 0))     # B: columns right to left
    return table


_FACELET_TABLE = _facelet_table()
_AXIS_FACE = {
    (0, 0, 1): "U", (0, 0, -1): "D", (1, 0, 0): "R",
    (-1, 0, 0): "L", (0, -1, 0): "F", (0, 1, 0): "B",
}


def cubelets_to_facelets(coords: np.ndarray, mats: np.ndarray) -> str:
    """The facelet string of the 20 cubelets' home coordinates (20, 3) and
    rotation matrices (20, 3, 3), rounded to signed permutations."""
    mats = np.round(np.asarray(mats)).astype(int)
    coords = np.round(np.asarray(coords)).astype(int)
    cur = np.einsum("cij,cj->ci", mats, coords)
    lookup = {tuple(c): i for i, c in enumerate(cur)}
    out = []
    for coord, normal in _FACELET_TABLE:
        key = tuple(int(x) for x in coord)
        if key not in lookup:  # a face's centre
            out.append(_AXIS_FACE[tuple(int(x) for x in normal)])
            continue
        i = lookup[key]
        home_normal = mats[i].T @ normal
        out.append(_AXIS_FACE[tuple(int(x) for x in home_normal)])
    return "".join(out)


def moves_to_face_rotations(moves: str) -> List[Tuple[int, int, float]]:
    """Move string -> [(axis, side, angle)] for `rotate_face`. A clockwise
    quarter turn seen from outside a face is a negative rotation about the
    +axis faces' outward axis and a positive one about the -axis faces'."""
    out = []
    for tok in moves.split():
        axis, side = MOVE_FACE[tok[0]]
        turns = 1
        if len(tok) > 1 and tok[1] == "2":
            turns = 2
        elif len(tok) > 1 and tok[1] == "'":
            turns = -1
        sign = -1.0 if side == 1 else 1.0
        out.append((axis, side, float(sign * turns * (np.pi / 2))))
    return out

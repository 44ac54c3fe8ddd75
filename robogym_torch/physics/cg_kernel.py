"""The constraint solves: M^-1-preconditioned nonlinear CG with the
frozen-active-set Newton line search, on a Jacobian built in the kernel
from gathered contact data (kernel B) or given whole (kernel F).

Counterpart of `robogym_tpu/physics/cg_kernel.py`. Three wrappers, each
launching a hand-written kernel on CUDA tensors and running its plain
PyTorch version (the JAX reference transcribed) on CPU tensors:

  * `cg_full` (replaces `_cg_full_kernel` with the Euler update and
    `with_smooth`; `robogym_torch/csrc/cg_full.cu`): contact rows of J,
    aref, the regularizer, qacc_smooth, the warmstart, the solve, J^T f and
    the implicit-damping Euler velocity update. Plain version
    `cg_full_plain` (`constraint_batched._make_core(..., True, True)
    .reference`).
  * `cg_full_noeuler` (`_cg_full_kernel` without them; the same source):
    the same up to J^T f, with qacc_smooth and the warmstart given. Plain
    version `cg_full_noeuler_plain` (`_make_core(..., False).reference`).
  * `cg` (replaces `_cg_kernel`; `robogym_torch/csrc/cg.cu`): the solve on
    a prebuilt J with its row weights, for any number of rows. Plain version
    `cg_plain` (`constraint._scan_cg_solve`).

A system too large for kernel B's shared memory (`fits`) takes the route
the JAX package takes for it: the plain version of `cg_full` or
`cg_full_noeuler` with its solve in kernel F.

Shapes (per env, leading B): scalar rows Js (n_s, V), n_s may be 0; contact
offsets off1/off2 (S, 3); frames (S, 9) as [normal | tangent1 | tangent2];
friction (S, 5); dof path masks m1/m2 (S, V); cdof (V, 6); row maps (E,)
with E = n_s + S*F; M, Minv, Mimp, Minv_imp (V, V); qvel, qfrc_smooth,
qacc_prev, qs, x0 (V,); dt a 0-dim tensor, one timestep for the batch, or
(B,), each env's own.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from robogym_torch.mjcf.model import env_col
from robogym_torch.physics import constraint as cl
from robogym_torch.physics.smooth import mv
from robogym_torch.utils.rotation import cross

def contact_rows(off1, off2, frame, fric, m1, m2, cdof, nfacet: int) -> torch.Tensor:
    """Pyramidal facet rows (B, S*F, V) of the contact Jacobian, contact-
    major and facet-minor (`_contact_rows_single`)."""
    B, S = off1.shape[:2]
    ang = cdof[:, None, :, :3]                                          # (B, 1, V, 3)
    lin = cdof[:, None, :, 3:]
    jac1 = (lin + cross(ang, off1[:, :, None, :])) * m1[..., None]       # (B, S, V, 3)
    jac2 = (lin + cross(ang, off2[:, :, None, :])) * m2[..., None]
    Jrel = jac2 - jac1

    def project(row, J3):
        fr = frame[..., 3 * row:3 * row + 3]
        return (fr[..., 0, None] * J3[..., 0] + fr[..., 1, None] * J3[..., 1]) \
            + fr[..., 2, None] * J3[..., 2]

    Jn = project(0, Jrel)
    facets = [Jn]
    if nfacet >= 4:
        Jt1, Jt2 = project(1, Jrel), project(2, Jrel)
        f0, f1 = fric[..., 0:1], fric[..., 1:2]
        facets = [Jn + f0 * Jt1, Jn - f0 * Jt1, Jn + f1 * Jt2, Jn - f1 * Jt2]
    if nfacet >= 6:
        Jr = ang * (m2 - m1)[..., None]
        Jtn = project(0, Jr)
        f2 = fric[..., 2:3]
        facets += [Jn + f2 * Jtn, Jn - f2 * Jtn]
    if nfacet == 10:
        Jr1, Jr2 = project(1, Jr), project(2, Jr)
        f3, f4 = fric[..., 3:4], fric[..., 4:5]
        facets += [Jn + f3 * Jr1, Jn - f3 * Jr1, Jn + f4 * Jr2, Jn - f4 * Jr2]
    return torch.stack(facets, dim=2).reshape(B, S * nfacet, -1)


@dataclasses.dataclass
class Forced:
    """Overrides of `cg_plain`'s discrete choices, per env and iteration.
    `pick` (B, iterations) int64: -1 leaves the line search free, 0 to 3
    takes the step a1 x `LS_SCALES`[i], 4 takes no step. `flip_neg` and
    `flip_inside` (B, iterations, E) bool, or None: flip a row's state
    (jar < 0; |Dfr jar| < floss) in the effective weight `deff` of the
    Newton step a1, the only place where a row's state is not continuous
    in jar. A run of k iterations reads the first k columns."""

    pick: torch.Tensor
    flip_neg: torch.Tensor | None = None
    flip_inside: torch.Tensor | None = None

    @staticmethod
    def free(B: int, iterations: int, E: int, device) -> "Forced":
        none = torch.zeros((B, iterations, E), dtype=torch.bool, device=device)
        return Forced(torch.full((B, iterations), -1, dtype=torch.long, device=device),
                      none, none.clone())

    def take(self, idx) -> "Forced":
        """The overrides of envs `idx`."""
        return Forced(*(None if t is None else t[idx]
                        for t in (self.pick, self.flip_neg, self.flip_inside)))


STATE_FIELDS = ("x", "jar", "p", "g", "Mg")   # the state a CG iteration reads


def cg_plain(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations: int, trace=None,
             force: Forced | None = None, start: dict | None = None, states: list | None = None):
    """M^-1-preconditioned Polak-Ribière+ nonlinear CG on the soft-
    constraint cost with a frozen-active-set Newton line search (the JAX
    package's reference solve, `constraint._scan_cg_solve`), batched over a
    leading env axis: J (B, E, V), row vectors (B, E), M/Minv (B, V, V),
    qs/x0 (B, V). Returns (qacc (B, V), efc_force (B, E)).

    A list `trace` gets a dict for each iteration: the search direction
    "p" (B, V), the four steps "a" and their costs "dcost" (B, 4) of
    `LS_SCALES`, "mag" (B, 4) the magnitudes of the terms summed into each
    cost (pen(0) + pen(a) + |a c1| + a^2 c2 / 2), the choice "pick" (B,)
    (0 to 3, or 4 for no step) and "step" (B,) taken, and the rows' "jar"
    (B, E) at the iteration's start with "jmag" (B, E), the magnitudes of
    the terms summed into it. `force` (`Forced`) overrides the choices of
    the envs and iterations it names; without it the result is the same
    bit for bit.

    `start` (a dict of `STATE_FIELDS`: x, jar, p (B, V) and (B, E), g and
    Mg (B, V), and optionally "qs" in place of `qs`) replaces the set-up:
    the solve runs `iterations` iterations from that state, x0 unused; the
    state after k iterations, run one more from, gives k + 1 bit for bit.
    A list `states` gets the state after the set-up (or `start`) and after
    each iteration: `STATE_FIELDS` with the choice "pick" (B,) (-1 for the
    set-up) and "beta" (B,) (0 for the set-up), the layout of the kernels'
    trace (`split_trace`)."""

    def force_of(jar):
        neg = (jar < 0).to(jar.dtype)
        return Deq * jar + Done * jar * neg + torch.minimum(torch.maximum(Dfr * jar, -floss), floss)

    def penalty_cost(jar):
        neg = (jar < 0).to(jar.dtype)
        c_quad = 0.5 * (Deq + Done * neg) * jar * jar
        inside = (torch.abs(Dfr * jar) < floss).to(jar.dtype)
        quad_f = 0.5 * Dfr * jar * jar
        lin_f = floss * torch.abs(jar) - 0.5 * floss * floss / torch.clamp(Dfr, min=1e-12)
        c_fric = inside * quad_f + (1.0 - inside) * lin_f
        return torch.sum(c_quad + c_fric, dim=-1)

    def grad(x, jar):
        return mv(M, x - qs) + mv(J.transpose(-1, -2), force_of(jar))

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    if start is None:
        x = x0
        jar = mv(J, x0) - aref
        g = grad(x0, jar)
        Mg = mv(Minv, g)
        p = -Mg
    else:
        x, jar, p, g, Mg = (start[k] for k in STATE_FIELDS)
        qs = start.get("qs", qs)
    if trace is not None:
        Jabs = J.abs()
        jmag = mv(Jabs, x.abs()) + aref.abs()
    if states is not None:
        B = x.shape[0]
        states.append(dict(x=x, jar=jar, p=p, g=g, Mg=Mg,
                           pick=torch.full((B,), -1, dtype=torch.long, device=x.device),
                           beta=torch.zeros_like(x[:, 0])))
    for it in range(iterations):
        Jp = mv(J, p)
        dx0 = x - qs
        Mp = mv(M, p)
        c1 = dot(dx0, Mp)
        c2 = dot(p, Mp)
        f0 = force_of(jar)
        negb = jar < 0
        insideb = torch.abs(Dfr * jar) < floss
        if force is not None and force.flip_neg is not None:
            negb = negb ^ force.flip_neg[:, it]
            insideb = insideb ^ force.flip_inside[:, it]
        neg, inside = negb.to(x.dtype), insideb.to(x.dtype)
        deff = Deq + Done * neg + Dfr * inside
        phi_p = c1 + dot(f0, Jp)
        phi_pp = torch.clamp(c2 + dot(deff * Jp, Jp), min=1e-12)
        a1 = torch.clamp(-phi_p / phi_pp, 0.0, 2.0)
        pen0 = penalty_cost(jar)
        best_cost = torch.zeros_like(c1)
        best_a = torch.zeros_like(c1)
        best_i = torch.full(c1.shape, len(cl.LS_SCALES), dtype=torch.long, device=c1.device)
        steps, dcosts, mags = [], [], []
        for i, s in enumerate(cl.LS_SCALES):
            a = a1 * s
            pen_a = penalty_cost(jar + a[:, None] * Jp)
            dcost = a * c1 + 0.5 * a * a * c2 + pen_a - pen0
            take = dcost < best_cost
            best_cost = torch.where(take, dcost, best_cost)
            best_a = torch.where(take, a, best_a)
            if trace is not None or force is not None or states is not None:
                best_i = torch.where(take, i, best_i)
                steps.append(a)
            if trace is not None:
                dcosts.append(dcost)
                mags.append(pen0 + pen_a + torch.abs(a * c1) + 0.5 * a * a * c2)
        if force is not None:
            cand = torch.stack(steps + [torch.zeros_like(c1)], -1)
            pick = force.pick[:, it]
            best_a = torch.where(pick >= 0, cand.gather(-1, pick.clamp(min=0)[:, None])[:, 0],
                                 best_a)
            best_i = torch.where(pick >= 0, pick, best_i)
        if trace is not None:
            trace.append(dict(p=p, a=torch.stack(steps, -1), dcost=torch.stack(dcosts, -1),
                              mag=torch.stack(mags, -1), pick=best_i, step=best_a, jar=jar,
                              jmag=jmag))
            jmag = jmag + best_a.abs()[:, None] * mv(Jabs, p.abs())
        x = x + best_a[:, None] * p
        jar = jar + best_a[:, None] * Jp
        g_new = grad(x, jar)
        Mg_new = mv(Minv, g_new)
        num = dot(g_new, Mg_new - Mg)
        den = torch.clamp(dot(g, Mg), min=1e-12)
        beta = torch.clamp(num / den, min=0.0)
        p = -Mg_new + beta[:, None] * p
        g, Mg = g_new, Mg_new
        if states is not None:
            states.append(dict(x=x, jar=jar, p=p, g=g, Mg=Mg, pick=best_i, beta=beta))
    return x, -force_of(jar)


def stack_states(states: list) -> dict:
    """`cg_plain`'s `states` list as the kernels' trace gives it
    (`split_trace`): each field (B, iterations + 1, ...), the picks in the
    states' float dtype."""
    out = {k: torch.stack([st[k] for st in states], 1) for k in states[0]}
    out["pick"] = out["pick"].to(out["x"].dtype)
    return out


def split_trace(buf: torch.Tensor, V: int, E: int) -> dict:
    """A CG kernel's trace (B, iterations + 1, 4 V + E + 2) as named fields:
    `STATE_FIELDS` (B, iterations + 1, V or E), "pick" (B, iterations + 1)
    as written (a float; -1 in slot 0) and "beta". A slot that the kernel
    did not write is NaN in every field."""
    at = np.cumsum([0, V, E, V, V, V])
    out = {k: buf[..., at[i]:at[i + 1]] for i, k in enumerate(STATE_FIELDS)}
    out["pick"] = buf[..., at[-1]]
    out["beta"] = buf[..., at[-1] + 1]
    return out


def _plain_traced(plain, *args):
    """A plain version's outputs and its solve's states as the kernels'
    trace (`stack_states`)."""
    states = []
    out = plain(*args, solve=functools.partial(cg_plain, states=states))
    return (*out, stack_states(states))


def _trace_buffer(B, iterations, V, E, dev):
    """A kernel's trace buffer, NaN until the kernel writes it."""
    from robogym_torch import cuda

    T = cuda.cg_trace_floats(V, E)
    if T != 4 * V + E + 2:
        raise RuntimeError(f"cg trace layout: {T} floats a slot, want {4 * V + E + 2}")
    return torch.full((B, iterations + 1, T), float("nan"), dtype=torch.float32, device=dev)


def solve_inputs(kind, nfacet, rows, maps, qvel):
    """Kernel B's system as `cg_plain` and `cg` take it: J (B, E, V), aref,
    the row weights D masked by kind (Deq, Done, Dfr) and the friction
    losses (B, E)."""
    Jc = contact_rows(rows["off1"], rows["off2"], rows["frame"], rows["fric"],
                      rows["m1"], rows["m2"], rows["cdof"], nfacet)
    J = torch.cat([rows["Js"], Jc], dim=1)
    aref = -maps["bref"] * mv(J, qvel) - maps["kimp"] * maps["pos"]
    D = torch.where(maps["active"] > 0, 1.0 / maps["rcoef"], torch.zeros_like(maps["rcoef"]))
    Deq, Done, Dfr = cl.kind_masked_D(kind, D)
    return J, aref, Deq, Done, Dfr, maps["floss"]


def cg_full_noeuler_plain(kind, iterations, nfacet, rows, maps, M, Minv, qvel, qs, x0,
                          solve=cg_plain):
    """Plain version of the CG kernel without the Euler update, the solve
    by `solve` (`cg_plain`; `cg` on the route of oversized systems).
    Returns (x, f, qfrc)."""
    J, aref, Deq, Done, Dfr, floss = solve_inputs(kind, nfacet, rows, maps, qvel)
    x, f = solve(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations)
    return x, f, mv(J.transpose(-1, -2), f)


def cg_full_plain(kind, iterations, nfacet, rows, maps, M, Minv, Mimp, Minv_imp,
                  qvel, qfrc_smooth, qacc_prev, dt, solve=cg_plain):
    """Plain version of the fused CG kernel, the solve by `solve`. Returns
    (x, f, qfrc, qvel_new, qacc_smooth)."""
    qs = mv(Minv, qfrc_smooth)
    finite = torch.all(torch.abs(qacc_prev) < 1e10, dim=-1, keepdim=True)
    x0 = torch.where(finite, qacc_prev, qs)
    x, f, qfrc = cg_full_noeuler_plain(kind, iterations, nfacet, rows, maps, M, Minv, qvel, qs, x0,
                                       solve)
    qfrc_total = mv(M, x)
    qacc1 = mv(Minv_imp, qfrc_total)
    qacc_imp = qacc1 + mv(Minv_imp, qfrc_total - mv(Mimp, qacc1))
    qvel_new = qvel + env_col(dt, 1) * qacc_imp
    return x, f, qfrc, qvel_new, qs


@functools.lru_cache(maxsize=64)
def _kind_tensor(kind_key: bytes, device: str) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(kind_key, np.int32).copy(), device=device)


def _check(kernel: str, ops, dev) -> None:
    """Raise unless every (name, tensor, shape) is a contiguous float32
    tensor of that shape on `dev`."""
    for name, t, shape in ops:
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{kernel} operand {name}: {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"want a contiguous {shape} float32 tensor on {dev}")


def _row_operands(kernel, kind, nfacet, rows, maps):
    """The row-build and row-map operands of kernel B, checked, with
    (B, n_s, S, E, V) and the row kinds on the device."""
    B, n_s, V = rows["Js"].shape
    S = rows["off1"].shape[1]
    E = n_s + S * nfacet
    dev = rows["off1"].device
    want = {
        "Js": (B, n_s, V), "off1": (B, S, 3), "off2": (B, S, 3), "frame": (B, S, 9),
        "fric": (B, S, 5), "m1": (B, S, V), "m2": (B, S, V), "cdof": (B, V, 6),
    }
    ops = [(k, rows[k], s) for k, s in want.items()]
    ops += [(k, maps[k], (B, E)) for k in ("pos", "kimp", "bref", "rcoef", "active", "floss")]
    _check(kernel, ops, dev)
    if len(kind) != E:
        raise ValueError(f"{kernel}: {len(kind)} row kinds for {E} rows")
    if nfacet not in (1, 4, 6, 10):
        raise ValueError(f"{kernel}: nfacet {nfacet}")
    kind_t = _kind_tensor(np.asarray(kind, np.int32).tobytes(), str(dev))
    return [t for _, t, _ in ops], kind_t, (B, n_s, S, E, V)


def fits(E: int, V: int, euler: bool) -> bool:
    """Whether kernel B takes a system of E rows and V dofs: V <= 256 and
    an env's arrays within one block's shared memory. Above that `cg_full`
    and `cg_full_noeuler` take the route of the JAX package's oversized
    systems (`constraint_batched.py:226`): the rows built in PyTorch, the
    solve in kernel F, J^T f and the Euler update as matvecs."""
    from robogym_torch import cuda

    return V <= cuda.MAX_V and cuda.cg_full_smem_bytes(E, V, euler) <= cuda.max_smem_bytes()


def _routed_solve(trace):
    """Kernel F as the size route's solve, its trace kept in `trace["t"]`
    where `trace` is a dict."""
    if trace is None:
        return cg

    def solve(*a):
        x, f, trace["t"] = cg(*a, trace=True)
        return x, f

    return solve


def cg_full(kind, iterations, nfacet, rows, maps, M, Minv, Mimp, Minv_imp,
            qvel, qfrc_smooth, qacc_prev, dt, trace: bool = False):
    """The fused constraint solve; on CUDA tensors kernel B, or for a
    system that B does not take (`fits`) its plain version with the solve
    in kernel F (`cg`). With `trace`, one more output: the solve's state
    after the set-up and after every iteration (`split_trace`; the plain
    version's `states` on CPU tensors)."""
    args = (kind, iterations, nfacet, rows, maps, M, Minv, Mimp, Minv_imp, qvel, qfrc_smooth,
            qacc_prev, dt)
    if M.device.type == "cpu":
        return _plain_traced(cg_full_plain, *args) if trace else cg_full_plain(*args)
    from robogym_torch import cuda

    row_ops, kind_t, (B, n_s, S, E, V) = _row_operands("cg_full", kind, nfacet, rows, maps)
    dev = M.device
    ops = [(k, t, (B, V, V)) for k, t in (("M", M), ("Minv", Minv), ("Mimp", Mimp),
                                          ("Minv_imp", Minv_imp))]
    ops += [(k, t, (B, V)) for k, t in (("qvel", qvel), ("qfrc_smooth", qfrc_smooth),
                                        ("qacc_prev", qacc_prev))]
    _check("cg_full", ops, dev)
    if not fits(E, V, True):
        kept = {} if trace else None
        out = cg_full_plain(*args, solve=_routed_solve(kept))
        return (*out, kept["t"]) if trace else out
    dt_t = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    if tuple(dt_t.shape) not in ((), (B,)):
        raise ValueError(f"cg_full: dt of shape {tuple(dt_t.shape)}, want () or ({B},)")
    dt_stride = dt_t.dim()
    dt_t = dt_t.reshape(-1).contiguous()
    x = torch.empty((B, V), dtype=torch.float32, device=dev)
    f = torch.empty((B, E), dtype=torch.float32, device=dev)
    qfrc = torch.empty_like(x)
    qvel_new = torch.empty_like(x)
    qs = torch.empty_like(x)
    buf = _trace_buffer(B, iterations, V, E, dev) if trace else None
    cuda.launch("cg_full", *row_ops, *[t for _, t, _ in ops], kind_t, dt_t, x, f, qfrc,
                qvel_new, qs, buf, B, n_s, S, nfacet, V, iterations, dt_stride)
    if trace:
        return x, f, qfrc, qvel_new, qs, split_trace(buf, V, E)
    return x, f, qfrc, qvel_new, qs


def cg_full_noeuler(kind, iterations, nfacet, rows, maps, M, Minv, qvel, qs, x0,
                    trace: bool = False):
    """The constraint solve of `forward()`: kernel B without the Euler
    update, qacc_smooth `qs` and the warmstart `x0` given. Returns (x, f,
    qfrc), and with `trace` the solve's states as `cg_full` does; on CUDA
    tensors the kernel, or `cg_full`'s route for a system that B does not
    take."""
    args = (kind, iterations, nfacet, rows, maps, M, Minv, qvel, qs, x0)
    if M.device.type == "cpu":
        return _plain_traced(cg_full_noeuler_plain, *args) if trace else \
            cg_full_noeuler_plain(*args)
    from robogym_torch import cuda

    row_ops, kind_t, (B, n_s, S, E, V) = _row_operands("cg_full_noeuler", kind, nfacet, rows,
                                                       maps)
    ops = [("M", M, (B, V, V)), ("Minv", Minv, (B, V, V)), ("qvel", qvel, (B, V)),
           ("qs", qs, (B, V)), ("x0", x0, (B, V))]
    _check("cg_full_noeuler", ops, M.device)
    if not fits(E, V, False):
        kept = {} if trace else None
        out = cg_full_noeuler_plain(*args, solve=_routed_solve(kept))
        return (*out, kept["t"]) if trace else out
    x = torch.empty((B, V), dtype=torch.float32, device=M.device)
    f = torch.empty((B, E), dtype=torch.float32, device=M.device)
    qfrc = torch.empty_like(x)
    buf = _trace_buffer(B, iterations, V, E, M.device) if trace else None
    cuda.launch("cg_full_noeuler", *row_ops, *[t for _, t, _ in ops], kind_t, x, f, qfrc, buf,
                B, n_s, S, nfacet, V, iterations)
    return (x, f, qfrc, split_trace(buf, V, E)) if trace else (x, f, qfrc)


def cg(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations: int, trace: bool = False):
    """The CG solve on a prebuilt J (B, E, V) with row weights Deq, Done,
    Dfr and friction losses (B, E): `cg_plain`'s arguments and returns (and
    with `trace` the solve's states as `cg_full` does); the CUDA kernel on
    CUDA tensors, for any E and V <= 256 (J in shared memory where it fits,
    else in device memory with a scratch buffer)."""
    if M.device.type == "cpu":
        if not trace:
            return cg_plain(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations)
        states = []
        x, f = cg_plain(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations,
                        states=states)
        return x, f, stack_states(states)
    from robogym_torch import cuda

    B, E, V = J.shape
    ops = [("J", J, (B, E, V))]
    ops += [(k, t, (B, E)) for k, t in (("aref", aref), ("Deq", Deq), ("Done", Done),
                                        ("Dfr", Dfr), ("floss", floss))]
    ops += [("M", M, (B, V, V)), ("Minv", Minv, (B, V, V)), ("qs", qs, (B, V)), ("x0", x0, (B, V))]
    _check("cg", ops, M.device)
    x = torch.empty((B, V), dtype=torch.float32, device=M.device)
    f = torch.empty((B, E), dtype=torch.float32, device=M.device)
    scratch = torch.empty((B, cuda.cg_scratch_floats(E, V)), dtype=torch.float32, device=M.device)
    buf = _trace_buffer(B, iterations, V, E, M.device) if trace else None
    cuda.launch("cg", *[t for _, t, _ in ops], x, f, scratch, buf, B, E, V, iterations)
    return (x, f, split_trace(buf, V, E)) if trace else (x, f)

"""The holdout rearrange env: a fixed task from a config, its objects'
start and goal poses from saved states.

Counterpart of `robogym_tpu/envs/rearrange/holdout.py`. A holdout config
(robogym's holdout jsonnet configs, loaded with
`robogym_torch.utils.env_utils.load_env`) names its task objects
(`task_object_configs`, each an object XML expanded `count` times into the
object slots), its fixed scene objects (`scene_object_configs`), the saved
initial state (`initial_state_path`: `obj_pos` (O, 3), `obj_quat` (O, 4))
and the saved goal states (`goal_args.goal_state_paths`). The env runs on a
world compiled from that config (`worlds=`, by default the snapshot of the
stand-in `worlds/holdout_ball_like`), whose object slots and scene bodies
must be the config's. Each reset places and settles the
objects as the blocks env does, then teleports them to the saved initial
state, positions the model and draws a goal from the saved goal states
(`HoldoutObjectStateGoal`). `_compile_world` (with `blocks.compile_worlds`)
compiles such a world from the config's object XMLs.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as et
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import goals as goals_lib
from robogym_torch.envs.rearrange import simulation as sim_lib
from robogym_torch.mjcf.compiler import compile_xml
from robogym_torch.mjcf.model import Data, Model
from robogym_torch.mjcf.xml_tools import MjcfXML
from robogym_torch.physics import step as physics
from robogym_torch.worlds import holdout_ball_like

# the holdout object XMLs' assets (their `xmls/`): robogym's own are not in
# this repository, so the stand-in's
ASSETS_DIR = holdout_ball_like.DIR


@dataclasses.dataclass(frozen=True)
class HoldoutEnvConstants(blocks_lib.RearrangeEnvConstants):
    """(holdout.py:26-34)."""

    initial_state_path: Optional[str] = None
    randomize_target: bool = False
    goal_state_paths: Tuple[str, ...] = ()


def _load_object_xml(xml_path: str, name: str, tag_args: Dict, material_args: Dict) -> MjcfXML:
    """A holdout object's XML (`ASSETS_DIR`'s `xmls/<xml_path>`), its bodies,
    geoms and joints named after `name` and its `material_args` and
    `tag_args` ({tag: {attr: value}}) written into it (simulation/holdout.py
    task-object construction)."""
    full = os.path.join(ASSETS_DIR, "xmls", xml_path)
    root = et.parse(full).getroot()
    bodies = list(root.find("worldbody").findall("body"))
    if not bodies:
        raise ValueError(f"no body in {xml_path}")
    for b_i, body in enumerate(bodies):
        body.set("name", name if b_i == 0 else f"{name}:b{b_i}")
        for g_i, geom in enumerate(body.iter("geom")):
            geom.set("name", name if g_i == 0 else f"{name}:g{g_i}")
        for j_i, joint in enumerate(body.iter("joint")):
            joint.set("name", f"{name}:joint" if j_i == 0 else f"{name}:joint{j_i}")
    for args in (material_args or {}), (tag_args or {}):
        for tag, attrs in args.items():
            for el in root.iter(tag):
                for k, v in attrs.items():
                    el.set(k, str(v))
    return MjcfXML.from_string(et.tostring(root, encoding="unicode"),
                               base_dir=os.path.dirname(full))


class HoldoutObjectStateGoal(goals_lib.ObjectStateGoal):
    """Goals drawn from a pool of saved goal states
    (goals/holdout_object_state.py): `draw` gives each env's pool index
    (B,)."""

    def __init__(self, idx, pool_pos: np.ndarray, pool_quat: np.ndarray,
                 args: goals_lib.GoalArgs = goals_lib.GoalArgs(), used_table_portion: float = 1.0,
                 dtype=torch.float32, device="cpu"):
        super().__init__(idx, args, used_table_portion, dtype)
        self.pool_pos = torch.as_tensor(pool_pos, dtype=dtype, device=device)     # (P, O, 3)
        self.pool_quat = torch.as_tensor(pool_quat, dtype=dtype, device=device)   # (P, O, 4)

    def draw(self, gen, B, num_objects_used, device=None):
        return {"pool": torch.randint(0, self.pool_pos.shape[0], (B,), generator=gen,
                                      device=device)}

    def next_goal(self, draws, active_mask, object_size, num_objects_used, d: Data):
        i = draws["pool"].to(torch.long)
        return {"obj_pos": self.pool_pos[i], "obj_rot": self.pool_quat[i],
                "goal_valid": torch.ones(i.shape, dtype=torch.bool, device=i.device)}


def _load_state(state_dir: str, path: str, n: int) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(state_dir, path)) as f:
        return dict(obj_pos=np.asarray(f["obj_pos"])[:n], obj_quat=np.asarray(f["obj_quat"])[:n])


class HoldoutRearrangeEnv(blocks_lib.BlocksRearrangeEnv):
    """The fixed-scene task env (module docstring): `task_object_configs`
    and `scene_object_configs` as the config gives them, the saved states
    under `state_dir`."""

    def __init__(self, constants: HoldoutEnvConstants,
                 parameters: blocks_lib.RearrangeEnvParameters, model: Model,
                 task_object_configs: Sequence[dict], scene_object_configs: Sequence[dict] = (),
                 solver_model: Optional[Model] = None, seed: int = 0,
                 state_dir: str = holdout_ball_like.STATE_DIR):
        n = sum(int(c.get("count", 1)) for c in task_object_configs)
        self._scene_bodies = [f"scene{s}_{c}" for s, cfg in enumerate(scene_object_configs)
                              for c in range(int(cfg.get("count", 1)))]
        sp = dataclasses.replace(parameters.simulation_params, num_objects=n, max_num_objects=n)
        parameters = dataclasses.replace(parameters, simulation_params=sp)
        self._initial_state = (_load_state(state_dir, constants.initial_state_path, n)
                               if constants.initial_state_path else None)
        goal_states = [_load_state(state_dir, p, n) for p in constants.goal_state_paths]
        super().__init__(constants, parameters, model, solver_model, seed)
        if goal_states and not constants.randomize_target:
            self.goal_gen = HoldoutObjectStateGoal(
                self.idx, np.stack([g["obj_pos"] for g in goal_states]),
                np.stack([g["obj_quat"] for g in goal_states]),
                goals_lib.GoalArgs(**dict(constants.goal_args)), dtype=self.dtype,
                device=self.device)

    @staticmethod
    def _compile_world(constants, parameters, device,
                       build_world_xml=sim_lib.build_blocks_world_xml,
                       task_object_configs: Sequence[dict] = (),
                       scene_object_configs: Sequence[dict] = ()) -> Model:
        """The holdout env's main world (holdout.py `_compile_world`): the world
        with no blocks plus each task object config's XML `count` times (the
        slots `object{i}`) and each scene object config's (`scene{s}_{c}`),
        with the contact budgets of the task objects and the scene's geoms;
        for `blocks.compile_worlds`."""
        xml = build_world_xml(0, robot_control_params=parameters.robot_control_params,
                              mujoco_timestep=constants.mujoco_timestep)
        i = 0
        for cfg in task_object_configs:
            for _ in range(int(cfg.get("count", 1))):
                xml.append(_load_object_xml(cfg["xml_path"], f"object{i}", cfg.get("tag_args", {}),
                                            cfg.get("material_args", {})))
                i += 1
        for s_i, cfg in enumerate(scene_object_configs):
            for c_i in range(int(cfg.get("count", 1))):
                xml.append(_load_object_xml(cfg["xml_path"], f"scene{s_i}_{c_i}",
                                            cfg.get("tag_args", {}), cfg.get("material_args", {})))
        model = compile_xml(xml, device=device)
        # scene GEOMS, not scene objects: a composed scene body holds several
        # contact geoms, each of which can hold support contacts
        n_scene = sum(1 for nm in model.const.names["geom"] if nm.startswith("scene"))
        return sim_lib.scale_contact_budgets(model, i, n_scene)

    def _check_objects(self) -> None:
        names = self.model.const.names["body"]
        missing = [b for b in self._scene_bodies if b not in names]
        if missing:
            raise ValueError(f"the model lacks the config's scene bodies {missing}")

    def draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        """The blocks env's reset draws and, with a saved initial state, the
        draws of the goal drawn after the teleport (`initial_goal`)."""
        out = super().draw_reset(n)
        if self._initial_state is not None:
            out["initial_goal"] = self.goal_gen.draw(self.generator, n, self.num_objects,
                                                     self.device)
        return out

    def _reset_model_fields(self, draws: Dict[str, torch.Tensor], batch: int):
        """Holdouts fix colours and materials in the config (holdout.py:
        86-92): no model field; the group ids are the slots."""
        O = self.max_num_objects
        return (None, sim_lib.geom_bbox_half(self.model, self.idx.object_geom_ids),
                torch.arange(O, device=self.device).expand(batch, O))

    def reset(self, batch: int, draws: Optional[Dict[str, torch.Tensor]] = None):
        """The blocks env's reset, then (with a saved initial state) the
        objects teleported to it, the model positioned and a new goal
        (holdout.py:92-104, :181-212)."""
        draws = draws if draws is not None else self.draw_reset(batch)
        state, obs = super().reset(batch, draws)
        if self._initial_state is None:
            return state, obs
        init = {k: torch.as_tensor(v, dtype=self.dtype, device=self.device).expand(
            (batch,) + v.shape) for k, v in self._initial_state.items()}
        d = sim_lib.set_object_poses(self.idx, state.physics, init["obj_pos"], init["obj_quat"])
        d = physics.fwd_position(self.model, d)
        _, sizes, group_ids = self._reset_model_fields(draws, batch)
        goal = self._next_goal({"goal": draws["initial_goal"]}, sizes, group_ids, d, self.model)
        state = state.replace(physics=d, goal=goal,
                              prev_goal_distance=self.goal_gen.goal_distance(goal, d, self._active))
        return state, self._observe(state)


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None, device="cuda",
             seed: int = 0, worlds: Optional[Dict[str, Model]] = None,
             state_dir: str = holdout_ball_like.STATE_DIR) -> HoldoutRearrangeEnv:
    """The holdout env on `device` (the card unless the caller asks for the
    CPU) from a holdout config's `constants` and `parameters`, as the JAX
    package's `make_env` reads them, its draws seeded by `seed`, on the
    compiled `worlds` ({"model", "solver_model"}; by default the stand-in
    holdout's snapshot), its saved states under `state_dir`."""
    cst_kw = dict(constants or {})
    goal_args = dict(cst_kw.pop("goal_args", {}) or {})
    gsp = tuple(goal_args.pop("goal_state_paths", ()) or ())
    thr = cst_kw.pop("success_threshold", None)
    if isinstance(thr, dict):
        if "obj_pos" in thr:
            cst_kw["success_threshold_obj_pos"] = float(thr["obj_pos"])
        if "obj_rot" in thr:
            cst_kw["success_threshold_obj_rot"] = float(thr["obj_rot"])
    cst_kw.pop("goal_generation", None)
    if goal_args:
        cst_kw["goal_args"] = goal_args
    par_kw = dict(parameters or {})
    sim_kw = dict(par_kw.pop("simulation_params", {}))
    task_objects = sim_kw.pop("task_object_configs", [])
    scene_objects = sim_kw.pop("scene_object_configs", [])
    sim_kw.pop("shared_settings", None)
    sim_kw.setdefault("num_objects", 1)
    par_kw.pop("material_names", None)
    cst, par = blocks_lib.configs(cst_kw, dict(par_kw, simulation_params=sim_kw),
                                  constants_cls=HoldoutEnvConstants)
    cst = dataclasses.replace(cst, goal_state_paths=gsp)
    worlds = worlds or blocks_lib.load_worlds(cst, par, device, main=holdout_ball_like.SNAPSHOT)
    worlds = {k: v for k, v in worlds.items() if k != "settle_model"}
    return HoldoutRearrangeEnv(cst, par, task_object_configs=task_objects,
                               scene_object_configs=scene_objects, seed=seed,
                               state_dir=state_dir, **worlds)

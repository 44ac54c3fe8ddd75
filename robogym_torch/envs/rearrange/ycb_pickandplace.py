"""YCB pick-and-place (robogym's envs/rearrange/ycb_pickandplace.py): the
YCB env with the pick-and-place goal, the first object lifted into the
air."""

from robogym_torch.envs.rearrange import mesh as mesh_lib


def make_env(constants=None, parameters=None, mesh_names=None, mesh_files_by_name=None,
             device="cuda", seed: int = 0, worlds=None) -> mesh_lib.YcbRearrangeEnv:
    """`mesh.make_env` with `goal_generation="pickandplace"` unless the
    constants name another."""
    cst = dict(constants or {})
    cst.setdefault("goal_generation", "pickandplace")
    return mesh_lib.make_env(cst, parameters, mesh_names=mesh_names,
                             mesh_files_by_name=mesh_files_by_name, device=device, seed=seed,
                             worlds=worlds)

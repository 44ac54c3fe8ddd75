"""The YCB mesh rearrange env (robogym's envs/rearrange/ycb.py). The env
lives in `mesh.py` (`YcbRearrangeEnv`); this module keeps robogym's layout,
so that a config naming `robogym.envs.rearrange.ycb:make_env` resolves."""

from robogym_torch.envs.rearrange.mesh import YcbRearrangeEnv, make_env  # noqa: F401

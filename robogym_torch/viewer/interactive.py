"""The terminal viewer (curses): the live keyboard loop.

Counterpart of `robogym_tpu/viewer/interactive.py`. The reference viewers
are GLFW windows with per-key actuator control and teleop
(env_viewer.py:13-168, robot_control_viewer.py:18-130); a card's host has
no display, so the loop runs in a curses screen: single keystrokes, the
env (a batch of one) stepped live at a fixed rate with the held action,
and a status pane (reward triple, goal distance, tracker readings, the
action vector). The key bindings are the reference's:

Env mode (EnvViewer):
  j / k   move the selected action dimension        (env_viewer.py:92-95)
  a / z   selected action -= / += 0.05              (env_viewer.py:77-90)
  n / p   seed +1 / -1, then reset                  (env_viewer.py:61-75)
  g       resample the goal (a reset with another seed where the env
          has no `reset_goal`)                      (env_viewer.py:66-68)
  0       zero the action
  q / ESC quit

Teleop mode (teleop=True; RobotControlViewer, its sticky keys replaced by
one-step impulses since terminals send no key release):
  arrows  +-x / +-y TCP moves     z / x   z up/down
  c / v   gripper close/open      w / e   wrist rotate (GLFW's Q quits here)
  y / u   gripper tilt            - / =   speed down/up
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


def _env0(x) -> np.ndarray:
    """Env 0's value of a batched tensor, as numpy."""
    return x[0].detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class InteractiveViewer:
    """The curses live loop over a batch of one env."""

    def __init__(self, env, seed: int = 0, teleop: bool = False, rate_hz: float = 10.0):
        self.env = env
        self.seed = seed
        self.teleop = teleop
        self.period = 1.0 / rate_hz
        self.action = np.zeros(env.action_size)
        self.action_index = 0
        self.status = ""
        if teleop:
            from robogym_torch.robot.teleop import URGripperArmController

            self.controller = URGripperArmController(env)

    # -- env plumbing -------------------------------------------------------
    def _do_reset(self):
        self.env.generator.manual_seed(self.seed)
        self.state, obs = self.env.reset(1)
        self.obs = {k: _env0(v) for k, v in obs.items()}
        self.reward = np.zeros(3)
        self.done = False
        self.info = {}
        self.action[:] = 0.0

    def _resample_goal(self):
        """EnvViewer's 'G': a new goal mid-episode, through the env's
        `reset_goal(state, seed)` where it has one, else a reset with the
        seed moved on."""
        if hasattr(self.env, "reset_goal"):
            self.state = self.env.reset_goal(self.state, self.seed + 991)
        else:
            self.seed += 991
            self._do_reset()

    def _step(self):
        action = torch.as_tensor(self.action, dtype=self.env.dtype,
                                 device=self.env.device).reshape(1, -1)
        self.state, obs, reward, done, info = self.env.step(self.state, action)
        self.obs = {k: _env0(v) for k, v in obs.items()}
        self.reward = _env0(reward)
        self.done = bool(done[0])
        self.info = {k: _env0(v) for k, v in info.items()}

    # -- key handling -------------------------------------------------------
    def _handle_env_key(self, ch) -> Optional[str]:
        n = self.env.action_size
        if ch in (ord("q"), 27):
            return "quit"
        if ch == ord("k"):
            self.action_index = (self.action_index + 1) % n
        elif ch == ord("j"):
            self.action_index = (self.action_index - 1) % n
        elif ch == ord("a"):
            self.action[self.action_index] = max(-1.0, self.action[self.action_index] - 0.05)
        elif ch == ord("z"):
            self.action[self.action_index] = min(1.0, self.action[self.action_index] + 0.05)
        elif ch == ord("n"):
            self.seed += 1
            self._do_reset()
        elif ch == ord("p"):
            self.seed = max(self.seed - 1, 0)
            self._do_reset()
        elif ch == ord("g"):
            self._resample_goal()
        elif ch == ord("0"):
            self.action[:] = 0.0
        return None

    def _handle_teleop_key(self, ch) -> Optional[str]:
        import curses

        c = self.controller
        keymap = {
            curses.KEY_UP: lambda: c.move_x(-1),
            curses.KEY_DOWN: lambda: c.move_x(+1),
            curses.KEY_LEFT: lambda: c.move_y(-1),
            curses.KEY_RIGHT: lambda: c.move_y(+1),
            ord("z"): lambda: c.move_z(+1),
            ord("x"): lambda: c.move_z(-1),
            ord("c"): lambda: c.move_gripper(+1),
            ord("v"): lambda: c.move_gripper(-1),
            ord("w"): lambda: c.rotate_wrist(+1),
            ord("e"): lambda: c.rotate_wrist(-1),
            ord("y"): lambda: c.tilt_gripper(+1),
            ord("u"): lambda: c.tilt_gripper(-1),
        }
        if ch in (ord("q"), 27):
            return "quit"
        if ch == ord("-"):
            c.speed_down()
        elif ch == ord("="):
            c.speed_up()
        elif ch == ord("n"):
            self.seed += 1
            self._do_reset()
        elif ch in keymap:
            self.action = np.asarray(keymap[ch]())
        # terminals send no key release: an action is a one-step impulse,
        # decayed back to zero each tick
        return None

    # -- main loop ----------------------------------------------------------
    def run(self, max_steps: Optional[int] = None):
        import curses

        self._do_reset()

        def loop(scr):
            curses.curs_set(0)
            scr.nodelay(True)
            steps = 0
            last = time.time()
            sps = 0.0
            while max_steps is None or steps < max_steps:
                ch = scr.getch()
                if ch != -1:
                    handler = self._handle_teleop_key if self.teleop else self._handle_env_key
                    if handler(ch) == "quit":
                        return
                t0 = time.time()
                self._step()
                steps += 1
                now = time.time()
                sps = 0.9 * sps + 0.1 / max(now - t0, 1e-9)
                if self.done:
                    self._do_reset()
                if self.teleop:
                    self.action = 0.0 * self.action  # the impulse decays

                self._draw(scr, steps, sps)
                dt = self.period - (time.time() - last)
                if dt > 0:
                    time.sleep(dt)
                last = time.time()

        curses.wrapper(loop)

    def _draw(self, scr, steps, sps):
        scr.erase()
        mode = "TELEOP" if self.teleop else "ENV"
        scr.addstr(0, 0, f"[{mode}] {type(self.env).__name__}  "
                         f"seed={self.seed} step={steps} {sps:5.1f} sps")
        scr.addstr(1, 0, f"reward [env goal success] = "
                         f"{np.array2string(self.reward, precision=3)}")
        row = 2
        for k in ("goal_dist", "successes_so_far", "trial_success",
                  "is_successful", "steps_since_success"):
            if k in self.info:
                scr.addstr(row, 0, f"{k} = "
                           f"{np.array2string(np.asarray(self.info[k]), precision=3)}"[:78])
                row += 1
        acts = np.array2string(self.action, precision=2, max_line_width=76)[:300]
        for i, line in enumerate(acts.splitlines()):
            scr.addstr(row + i, 0, ("action " if i == 0 else "       ") + line)
        row += len(acts.splitlines())
        if not self.teleop:
            scr.addstr(row, 0, f"selected dim: {self.action_index} "
                               f"(j/k move, a/z adjust, n/p seed, g goal, q quit)")
        else:
            scr.addstr(row, 0, "arrows/z/x/c/v/w/e/y/u move | -/= speed | n reset | q quit")
        # a few observation scalars
        row += 1
        shown = 0
        for k in sorted(self.obs):
            v = np.asarray(self.obs[k]).ravel()
            if v.size <= 6 and shown < 6:
                scr.addstr(row + shown, 0,
                           f"obs[{k}] = {np.array2string(v, precision=3)}"[:78])
                shown += 1
        scr.refresh()

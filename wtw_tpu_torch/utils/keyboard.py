"""Interactive command source for sim evaluation (a copy of
`wtw_tpu/utils/keyboard.py`, numpy only; `play --interactive` uses it):
the keyboard analog of the reference's gamepad client
(tasks/go2_parkour.py:30-36 Joystick) and the RC-stick command mapping used
in deployment (go1_gym_deploy/utils/cheetah_state_estimator.py:148-221).

Reads single keypresses from stdin (raw mode when attached to a tty,
buffered otherwise, so scripted input like
`echo "ww2" | python -m wtw_tpu_torch.play --interactive` works headlessly)
and edits a live 15-dim MoB command vector (layout:
legged_robot.py:710-824):

  w/s  vx +/- 0.1 m/s        a/d  vy -/+ 0.1 m/s      q/e  yaw rate -/+ 0.2
  1/2/3/4  gait trot/pace/bound/pronk                  -/=  frequency -/+ 0.25
  z/x  body height -/+ 0.05  t/g  pitch +/- 0.1        f/h  footswing -/+ 0.03
  [/]  stance width -/+ 0.05 ,/.  stance length -/+ 0.02
  space  zero velocities     r  reset all to defaults  ESC/Ctrl-C  quit
"""
from __future__ import annotations

import os
import select
import sys

import numpy as np

GAITS = {"1": ("trot", (0.5, 0.0, 0.0)), "2": ("pace", (0.0, 0.0, 0.5)),
         "3": ("bound", (0.0, 0.5, 0.0)), "4": ("pronk", (0.0, 0.0, 0.0))}

# (dim, delta, lo, hi) per key — limits from scripts/go1/train.py:153-182
_BINDINGS = {
    "w": (0, +0.1, -1.0, 1.0), "s": (0, -0.1, -1.0, 1.0),
    "d": (1, +0.1, -0.6, 0.6), "a": (1, -0.1, -0.6, 0.6),
    "e": (2, +0.2, -1.0, 1.0), "q": (2, -0.2, -1.0, 1.0),
    "x": (3, +0.05, -0.25, 0.15), "z": (3, -0.05, -0.25, 0.15),
    "=": (4, +0.25, 2.0, 4.0), "-": (4, -0.25, 2.0, 4.0),
    "t": (10, +0.1, -0.4, 0.4), "g": (10, -0.1, -0.4, 0.4),
    "h": (9, +0.03, 0.03, 0.35), "f": (9, -0.03, 0.03, 0.35),
    "]": (12, +0.05, 0.10, 0.45), "[": (12, -0.05, 0.10, 0.45),
    ".": (13, +0.02, 0.35, 0.45), ",": (13, -0.02, 0.35, 0.45),
}


class KeyboardCommandSource:
    """Polls stdin without blocking and maintains the live command vector.

    In tests/pipes, keys can also be injected with feed()."""

    def __init__(self, num_commands: int = 15, vx: float = 0.0,
                 freq: float = 3.0, footswing: float = 0.08,
                 stance_width: float = 0.25, stance_length: float = 0.40):
        self.num_commands = num_commands
        self._defaults = np.zeros(num_commands, np.float32)
        if num_commands > 4:
            self._defaults[4] = freq
        if num_commands > 9:
            self._defaults[8] = 0.5
            self._defaults[9] = footswing
        if num_commands > 13:
            self._defaults[12] = stance_width
            self._defaults[13] = stance_length
        self._defaults[0] = vx
        self.cmd = self._defaults.copy()
        self.gait = "trot"
        if num_commands > 7:
            self.cmd[5:8] = GAITS["1"][1]
        self.quit = False
        self._pending: list[str] = []
        self._raw = None
        self._is_tty = sys.stdin.isatty()

    def __enter__(self):
        if self._is_tty:
            import termios
            import tty
            self._raw = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._raw is not None:
            import termios
            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              self._raw)

    def feed(self, keys: str):
        self._pending.extend(keys)

    def _drain_stdin(self):
        try:
            while select.select([sys.stdin], [], [], 0)[0]:
                ch = os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
                if not ch:          # EOF on a pipe: stop draining, keep cmd
                    break
                self._pending.append(ch)
                if not self._is_tty and len(self._pending) > 4096:
                    break
        except (OSError, ValueError):
            pass

    def poll(self) -> np.ndarray:
        """Apply pending keys; returns the current command vector."""
        self._drain_stdin()
        for ch in self._pending:
            if ch in ("\x1b", "\x03"):
                self.quit = True
            elif ch == " ":
                self.cmd[0:3] = 0.0
            elif ch == "r":
                self.cmd = self._defaults.copy()
                if self.num_commands > 7:
                    self.cmd[5:8] = GAITS["1"][1]
                self.gait = "trot"
            elif ch in GAITS and self.num_commands > 7:
                self.gait, phases = GAITS[ch]
                self.cmd[5:8] = phases
            elif ch in _BINDINGS:
                dim, delta, lo, hi = _BINDINGS[ch]
                if dim < self.num_commands:
                    self.cmd[dim] = float(np.clip(self.cmd[dim] + delta,
                                                  lo, hi))
        self._pending.clear()
        return self.cmd

    def status(self) -> str:
        c = self.cmd
        return (f"vx {c[0]:+.1f} vy {c[1]:+.1f} yaw {c[2]:+.1f} | "
                f"{self.gait} @ {c[4]:.2f} Hz | h {c[3]:+.2f} "
                f"pitch {c[10]:+.1f} swing {c[9]:.2f} | "
                f"stance {c[12]:.2f}x{c[13]:.2f}"
                if self.num_commands > 13 else
                f"vx {c[0]:+.1f} vy {c[1]:+.1f} yaw {c[2]:+.1f}")

"""Path kinds: how a workload's jobs reach the program. A workload file
names its kind (``"path"``); ``load`` finds the module of that name here:
its ``Path`` sets the job up, runs it, and checks what it produced, and
its ``control`` gives the configuration's control in the program's place."""

import importlib


def load(kind: str):
    return importlib.import_module(f"{__name__}.{kind}")

"""Helpers of ``tests/test_torch_examples_*.py``: load an example file by
path (``examples/`` is no package), run its ``main`` with its output
captured, or run it in a subprocess.

The originals import ``repro``, whose ``core/graph_sim.py`` imports
``jax.experimental.enable_x64``, which jax 0.9 dropped: the name is aliased
here, before any original is loaded, and in the subprocess's command.
"""

import contextlib
import importlib.util
import inspect
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def load(name: str):
    """The module ``examples/<name>.py``, freshly executed."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv=()) -> list[str]:
    """The lines ``mod.main`` prints for the command line ``argv``."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            if inspect.signature(mod.main).parameters:
                mod.main(list(argv))
            else:
                mod.main()
    finally:
        sys.argv = saved
    return buf.getvalue().splitlines()


def run_file(name: str, argv=(), env=None) -> list[str]:
    """The lines ``examples/<name>.py`` prints when run as a script in a
    fresh interpreter (its registrations stay out of this process)."""
    path = str(EXAMPLES / f"{name}.py")
    code = ("import sys, runpy, jax, jax.experimental\n"
            "if not hasattr(jax.experimental, 'enable_x64'):\n"
            "    jax.experimental.enable_x64 = jax.enable_x64\n"
            f"sys.argv = [{path!r}, *{list(argv)!r}]\n"
            f"runpy.run_path({path!r}, run_name='__main__')\n")
    full_env = dict(os.environ, **(env or {}))
    full_env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        full_env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=full_env, timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()

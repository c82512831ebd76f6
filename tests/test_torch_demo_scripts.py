"""The port's demo scripts (``scripts_torch/``) against the JAX package's
(``scripts/``): one case per script.

Each script is read, not run: its continuation lines are joined, the
``${VAR:-default}`` defaults expanded and the command split with ``shlex``.
The port's script must run ``python -m ctrlv_tpu_torch.tools.<tool>`` for
the JAX script's ``python tools/<tool>.py``, with the same arguments, and
those arguments must give the same config through the port's parser as
through the JAX package's (``utils/config.py::parse_args``, or
``baseline/config.py::config_from_overrides`` for the baseline's
``key=value`` commands). Fields the port alone has are named in
``PORT_ONLY``. No script needs data or weights to be checked.
"""

import dataclasses
import os
import re
import shlex

import pytest

from ctrlv_tpu.baseline.config import config_from_overrides as jax_overrides
from ctrlv_tpu.utils.config import parse_args as jax_parse_args
from ctrlv_tpu_torch.baseline.config import config_from_overrides
from ctrlv_tpu_torch.utils.config import parse_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(
    os.path.join(sub, name)
    for sub in ("train_scripts", "eval_scripts")
    for name in os.listdir(os.path.join(ROOT, "scripts", sub))
    if name.endswith(".sh")
)
PORT_ONLY = {"device"}  # None: the card; the tests' "cpu"


def read_command(path: str) -> list[str]:
    """The script's ``python`` command as argv, with its variables expanded
    to their defaults and the trailing ``"$@"`` dropped."""
    text = open(path).read().replace("\\\n", " ")
    env = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        assign = re.fullmatch(r'(\w+)="\$\{\w+:-([^}]*)\}"', line)
        if assign:
            env[assign.group(1)] = assign.group(2)
            continue
        line = re.sub(r"\$\{(\w+):-([^}]*)\}", lambda m: env.get(m.group(1), m.group(2)), line)
        line = re.sub(r"\$(\w+)", lambda m: env[m.group(1)], line.replace('"$@"', ""))
        argv = shlex.split(line)
        assert argv[0] == "python", line
        return argv
    raise AssertionError(f"{path} runs no command")


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_every_script_has_its_counterpart():
    ported = sorted(
        os.path.join(sub, name)
        for sub in ("train_scripts", "eval_scripts")
        for name in os.listdir(os.path.join(ROOT, "scripts_torch", sub))
    )
    assert ported == SCRIPTS and len(SCRIPTS) == 14


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_parses_to_the_jax_config(script):
    jax_argv = read_command(os.path.join(ROOT, "scripts", script))
    port_argv = read_command(os.path.join(ROOT, "scripts_torch", script))
    tool = re.fullmatch(r"tools/(\w+)\.py", jax_argv[1]).group(1)
    assert port_argv[:3] == ["python", "-m", f"ctrlv_tpu_torch.tools.{tool}"]
    args = jax_argv[2:]
    assert port_argv[3:] == args and args
    if tool.endswith("bbox_baseline"):
        port, ref = config_from_overrides(args), jax_overrides(args)
    else:
        port, ref = parse_args(args), jax_parse_args(args)
    port, ref = _fields(port), _fields(ref)
    assert set(port) - set(ref) == PORT_ONLY and set(ref) <= set(port)
    assert {k: port[k] for k in ref} == ref
    assert port["device"] is None  # the card

"""Files of the benchmark found by the name BENCHMARK.json or a data file
gives them: `portbench/<folder>/<name>.py` loaded as a module (a scene, a
traffic kind, a metric's reader), `portbench/<folder>/<name>.json` read
as data (a traffic mix). A later change adds such a file and its entry,
and edits none that is there."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_loaded = {}


def path(folder, name, suffix):
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{folder}: {name!r} is not a name")
    p = HERE / folder / f"{name}{suffix}"
    if not p.is_file():
        raise KeyError(f"no {folder}/{name}{suffix} in {HERE}")
    return p


def module(folder, name):
    """portbench/<folder>/<name>.py, loaded once a process."""
    p = path(folder, name, ".py")
    if p not in _loaded:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
            p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[p] = mod
    return _loaded[p]


def data(folder, name):
    """portbench/<folder>/<name>.json as a dict."""
    with open(path(folder, name, ".json")) as f:
        return json.load(f)

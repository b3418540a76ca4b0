"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, traffic mode,
metric or reference sits in a file of its own under the benchmark's
folder, named after it:

* ``workloads/<cell>.json``: the cell (config, traffic, chips, why, the
  limits of its comparison);
* ``configs/<config>.json``: the data set's sizes, metric and values;
* ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  driver of its ``mode``;
* ``modes/<mode>.py``: the loop that sends a mix (``END_TO_END``,
  ``pool_size``, ``queries_per_step``, ``warm``, ``drive``), and where the
  cell runs more than the flat index, its own ``program`` and the name of
  its ``REFERENCE``;
* ``references/<name>.py``: a plain reference (``search``, ``distances``
  for the k-NN check; or its own ``compare``), named by the configuration's
  ``metric`` unless the mode names another;
* ``values/<distribution>.py``: a configuration's data other than the
  built-in ``uniform`` (``make_points``, ``make_pool``);
* ``metrics/<name>.py``: one reader of a traced run's records a per-layer
  metric (``UNIT``, ``read(records)``, which returns None when it finds
  nothing to read).

So a later cell, configuration, mix or metric is a new file, and no code
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: the contract's names: a letter, digit or ``_`` first, then at most 63
#: letters, digits, ``_``, ``.`` and ``-``
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _file(root: Path | None, folder: str, name: str, suffix: str) -> Path:
    path = (root or ROOT) / folder / f"{_checked(name)}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r}: {path}")
    return path


def load_module(path: Path):
    """Import a Python file of the benchmark by its path (its name may
    hold dots, as a metric's does)."""
    modname = "knnbench_file_" + re.sub(r"\W", "_", str(path.relative_to(
        path.parents[1])))
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name: str, root: Path | None = None) -> dict:
    return read_json(_file(root, "configs", name, ".json"))


def traffic(name: str, root: Path | None = None) -> dict:
    return read_json(_file(root, "traffic", name, ".json"))


def cell(name: str, root: Path | None = None) -> dict:
    """The cell with its ``config`` and ``traffic`` files read in."""
    c = read_json(_file(root, "workloads", name, ".json"))
    c["name"] = name
    c["config_name"], c["traffic_name"] = c["config"], c["traffic"]
    c["config"] = config(c["config"], root)
    c["traffic"] = traffic(c["traffic"], root)
    return c


def mode(name: str, root: Path | None = None):
    return load_module(_file(root, "modes", name, ".py"))


def reference(name: str, root: Path | None = None):
    return load_module(_file(root, "references", name, ".py"))


def values(distribution: str, root: Path | None = None):
    return load_module(_file(root, "values", distribution, ".py"))


def names(folder: str, suffix: str, root: Path | None = None) -> list[str]:
    """Every name with a file in ``root/folder``."""
    return sorted(p.name[:-len(suffix)] for p in ((root or ROOT) / folder).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_")
                  and NAME.fullmatch(p.name[:-len(suffix)]))


def metric_readers(root: Path | None = None) -> dict:
    """``{name: module}`` for every ``metrics/<name>.py``."""
    return {n: load_module((root or ROOT) / "metrics" / f"{n}.py")
            for n in names("metrics", ".py", root)}

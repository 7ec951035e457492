"""Finds the benchmark's data and code files by name.

Every configuration, traffic mix, cell, metric reader and roofline is a file
of its own under this folder, named after the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<mix>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``, ``rooflines/<kernel>.py``;
and the model family that a configuration file's ``"family"`` key names,
``families/<family>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the family of a configuration file without a "family" key: the Llama-style
# stack of dense or MoE blocks
DEFAULT_FAMILY = "llama"


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str, where: Path = HERE):
    """The module ``<kind>/<name>.py`` under ``where`` (names may hold dots
    and dashes). Without that file, a name with a dot suffix takes its
    stem's: ``ttft_p95_ms.chat`` reads with ``metrics/ttft_p95_ms.py``."""
    path = Path(where) / kind / f"{name}.py"
    if not path.exists() and "." in name:
        return load_module(kind, name.rsplit(".", 1)[0], where)
    mod_name = "port_bench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict, where: Path = HERE):
    """The family module that the configuration ``cfg`` names."""
    return load_module("families", cfg.get("family", DEFAULT_FAMILY), where)


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without a ``workloads`` list, and those whose list
    names it."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]

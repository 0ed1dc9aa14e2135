"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; everything else is a file of its own under the benchmark's folder
(the first of ``paths``), found by the name alone:

- ``configs``' ``file``: the configuration's sizes, precision and
  optimizer, and the name of its plain reference
  (``reference/<name>.py``);
- ``traffic/<traffic>.json``: the mix's parameters for
  :mod:`yardstick.traffic`, and the name of its entry
  (``entries/<entry>.py``), the driver of the program's step;
- ``metrics/<metric>.py``: one per-layer metric's reader;
- ``limits/<cell>.json``: the limits of the cell's correctness check.

So a later change adds a configuration, a mix, an entry, a metric or a
cell as new files and new entries in ``BENCHMARK.json``, and edits no
file that is already there.
"""

import importlib.util
import json
import re
from pathlib import Path

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BETTER = ("lower", "higher")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
END_TO_END_SOURCES = ("host_clock", "device_trace")


def valid_name(name):
    return isinstance(name, str) and bool(NAME_RE.match(name))


def valid_unit(unit):
    return isinstance(unit, str) and bool(UNIT_RE.match(unit))


def valid_line(text):
    """A ``why``, ``layer``, ``source`` or command word: 1 to 200
    characters on one line, no tab."""
    return (isinstance(text, str) and 0 < len(text) <= 200
            and not any(c in text for c in "\n\r\t"))


def problems(doc):
    """The ways ``doc`` (a parsed ``BENCHMARK.json``) breaks the rules on
    names, units, lines and cross references; empty when it keeps them."""
    out = []

    def need(cond, what):
        if not cond:
            out.append(what)

    paths = doc.get("paths", [])
    need(1 <= len(paths) <= 16, "paths: 1 to 16 directories")
    for p in paths:
        need(isinstance(p, str) and bool(PATH_RE.match(p))
             and not p.startswith("/") and ".." not in p.split("/"),
             f"path {p!r}")
    cmd = doc.get("command", [])
    need(0 < len(cmd) <= 32 and all(valid_line(w) for w in cmd), "command")
    need(isinstance(doc.get("run_seconds"), int)
         and 1 <= doc["run_seconds"] <= 51, "run_seconds")
    configs = {c.get("name"): c for c in doc.get("configs", [])}
    need(1 <= len(doc.get("configs", [])) <= 24, "configs: 1 to 24")
    need(len(configs) == len(doc.get("configs", [])), "config names repeat")
    for c in configs.values():
        need(valid_name(c.get("name")), f"config name {c.get('name')!r}")
        need(valid_line(c.get("source")), f"config {c.get('name')} source")
        need(valid_line(c.get("why")), f"config {c.get('name')} why")
        need(len(c.get("reduced", [])) <= 16
             and all(valid_name(k) for k in c.get("reduced", [])),
             f"config {c.get('name')} reduced")
        need(any(c.get("file", "").startswith(p.rstrip("/") + "/")
                 for p in paths), f"config {c.get('name')} file outside paths")
    cells = doc.get("workloads", [])
    need(1 <= len(cells) <= 24, "workloads: 1 to 24")
    names = [w.get("name") for w in cells]
    need(len(set(names)) == len(names), "cell names repeat")
    pairs = [(w.get("config"), w.get("traffic")) for w in cells]
    need(len(set(pairs)) == len(pairs), "a (config, traffic) pair repeats")
    for w in cells:
        need(valid_name(w.get("name")), f"cell name {w.get('name')!r}")
        need(w.get("config") in configs, f"cell {w.get('name')} config")
        need(valid_name(w.get("traffic")), f"cell {w.get('name')} traffic")
        need(w.get("chips") in (1, 4), f"cell {w.get('name')} chips")
        need(valid_line(w.get("why")), f"cell {w.get('name')} why")
    used = {w.get("config") for w in cells}
    need(used == set(configs), "every configuration is used by a cell")
    metric_names = []
    for kind in ("end_to_end", "per_layer"):
        for m in doc.get(kind, []):
            metric_names.append(m.get("name"))
            need(valid_name(m.get("name")), f"metric name {m.get('name')!r}")
            need(valid_unit(m.get("unit")), f"metric {m.get('name')} unit")
            need(m.get("better") in BETTER, f"metric {m.get('name')} better")
            srcs = END_TO_END_SOURCES if kind == "end_to_end" else SOURCES
            need(m.get("source") in srcs, f"metric {m.get('name')} source")
            for cell in m.get("workloads", []):
                need(cell in names, f"metric {m.get('name')} cell {cell}")
    need(len(set(metric_names)) == len(metric_names), "metric names repeat")
    e2e = {m["name"]: m for m in doc.get("end_to_end", [])}
    need(1 <= len(e2e) <= 16 and "setup_s" in e2e, "end_to_end has setup_s")
    for m in e2e.values():
        need(isinstance(m.get("bound"), (int, float))
             and 0 < m["bound"] <= 0.25, f"metric {m.get('name')} bound")
    for m in doc.get("per_layer", []):
        need(valid_line(m.get("layer")), f"metric {m.get('name')} layer")
        need(m.get("moves") in e2e, f"metric {m.get('name')} moves")
    return out


def load_module(path, tag):
    """The Python file at ``path``, loaded as the module ``tag``."""
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        with open(self.root / "BENCHMARK.json", encoding="utf-8") as f:
            self.doc = json.load(f)
        self.dir = self.root / self.doc["paths"][0]

    def _named(self, kind, name):
        for item in self.doc[kind]:
            if item["name"] == name:
                return item
        raise KeyError(f"no {kind} entry named {name!r} in BENCHMARK.json")

    def cell(self, name):
        return self._named("workloads", name)

    def config(self, name):
        with open(self.root / self._named("configs", name)["file"],
                  encoding="utf-8") as f:
            return json.load(f)

    def _json(self, folder, name):
        with open(self.dir / folder / f"{name}.json", encoding="utf-8") as f:
            return json.load(f)

    def traffic(self, name):
        return self._json("traffic", name)

    def limits(self, cell):
        return self._json("limits", cell)

    def entry(self, name):
        return load_module(self.dir / "entries" / f"{name}.py",
                           f"bench_entry_{name}")

    def metric(self, name):
        return load_module(self.dir / "metrics" / f"{name}.py",
                           f"bench_metric_{name}")

    def reference(self, name):
        return load_module(self.dir / "reference" / f"{name}.py",
                           f"bench_reference_{name}")

    def end_to_end(self, cell):
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        """The per-layer metrics ``cell`` reports: those that list it, and
        those without a list that move a metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in reported)]

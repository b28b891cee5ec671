"""Runs one cell of the port's benchmark once, on the machine it starts on.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and
the program, `s_volsdf_tpu_torch`. The cell, its configuration
(`configs/<config>.json`), its traffic (`traffic/<traffic>.json`), the
entry the traffic names (`entries/<entry>.py`), its limits
(`limits/<workload>.json`) and a reader for each of its metrics, end to
end and per layer (`metrics/<metric>.py`), are found by the names in
`BENCHMARK.json` and the traffic file. A metric the cell lists with no
reader, or an end-to-end metric whose reader finds nothing, stops the
run with no result.

A run builds the inputs and the program from the seed and warms up
(set-up), drives one window of `--seconds`, lets the entry finish what
the check needs of the program, and then checks what the program
produced against the plain reference. With `--trace 0` the result
carries the cell's end-to-end metrics; with `--trace 1` the window is
followed by two profiled stretches (`drive.profile`), and the result
carries the per-layer metrics. Its last line on stdout is the JSON result; the
numbers compared, each with its limit, are the last lines on stderr and
the result's last key. Without CUDA, or with fewer cards than the cell
asks for, it exits with 1 and prints no result; so it does if, once the
window has closed, the process holds JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                      # noqa: E402
import importlib.util                # noqa: E402
import json                          # noqa: E402
import os                            # noqa: E402
import sys                           # noqa: E402
from typing import Dict, List, Optional   # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "s_volsdf_tpu")


class Cell:
    """One entry of BENCHMARK.json's workloads with everything it names."""

    def __init__(self, spec: Dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.spec, self.name = spec, name
        self.workload = cells[name]
        bench = os.path.join(root, spec["paths"][0])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = _load_json(os.path.join(
            root, configs[self.workload["config"]]["file"]))
        self.traffic = _load_json(os.path.join(
            bench, "traffic", self.workload["traffic"] + ".json"))
        limits = os.path.join(bench, "limits", name + ".json")
        self.limits = _load_json(limits) if os.path.exists(limits) else None
        self.bench = bench

    def entry(self, seed: int, device):
        """The traffic's entry (entries/<entry>.py) for this cell."""
        from port_bench.entries import entry_class
        return entry_class(self.traffic["entry"])(self.config, self.traffic,
                                                  seed, device)

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.spec["end_to_end"]
                if name_in(self.name, m.get("workloads"))]

    def per_layer(self) -> List[Dict]:
        return [m for m in self.spec["per_layer"]
                if name_in(self.name, m.get("workloads"))]


def name_in(name: str, names: Optional[List[str]]) -> bool:
    return names is None or name in names


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> Dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def metric_reader(bench: str, name: str):
    """`read` of metrics/<name>.py."""
    path = os.path.join(bench, "metrics", name + ".py")
    if not os.path.exists(path):
        raise RuntimeError(f"no reader for the metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Modules of JAX or the JAX package this process holds, compared by
    their whole top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def build_program(parts: Dict[str, float]) -> None:
    """The program's CUDA libraries, built once per checkout."""
    from port_bench.drive import timed
    from s_volsdf_tpu_torch.ops import cost_mapping, fused_sdf
    with timed(parts, "build"):
        fused_sdf.build()
        cost_mapping.build()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> Dict:
    """One run of a cell on `device`: set-up, the window (and with
    `trace` the profiled stretches), the check. Returns the result's
    fields; device figures only when `device` is a card."""
    import torch
    from port_bench import arith, check
    on_card = torch.device(device).type == "cuda"
    if trace and not on_card:
        raise RuntimeError("a traced run measures the card: it needs CUDA")
    wanted = cell.per_layer() if trace else cell.end_to_end()
    readers = {m["name"]: metric_reader(cell.bench, m["name"]) for m in wanted}
    parts: Dict[str, float] = {}
    parts["imports"] = time.perf_counter() - t_start
    if on_card:
        build_program(parts)
        torch.zeros(1, device=device)       # the allocator exists
        torch.cuda.reset_peak_memory_stats(device)
    entry = cell.entry(seed, device)
    entry.setup(parts)
    setup_s = time.perf_counter() - t_start
    print("[setup] " + " ".join(f"{k} {v:.3f} s" for k, v in parts.items())
          + f"; setup_s {setup_s:.3f}", flush=True)
    stretch = entry.window(seconds)
    prof = entry.profile() if trace else None
    entry.finish()
    result: Dict = {"attempted": stretch["units"], "failed": stretch["failed"]}
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    ctx = {"unit": entry.unit, "stretch": stretch, "profile": prof,
           "setup_s": setup_s, "flops_per_unit": entry.flops_per_unit(),
           "model": entry.cfg_doc["model"], "arith": arith}
    metrics: Dict[str, Dict] = {}
    for m in wanted:
        value = readers[m["name"]](ctx)
        if value is None and not trace:
            raise RuntimeError(f"{m['name']} read nothing in {cell.name}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        result["device"].update({"busy_s": prof["busy_s"],
                                 "window_s": prof["window_s"]})
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["metrics"] = metrics
    entry.release()
    correct, shown = check.verdict(entry.readings(), cell.limits)
    result["correct"] = bool(correct and stretch["failed"] == 0)
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(load_spec(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.workload["chips"]:
        print(f"{cell.name} wants {cell.workload['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    held = forbidden_modules()
    if held:
        print(f"the process holds JAX or the JAX package: {held}",
              file=sys.stderr)
        return 1
    checks = result.pop("checks")
    result["checks"] = checks
    for k, v in checks.items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

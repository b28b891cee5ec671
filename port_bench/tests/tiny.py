"""Cells at sizes a CPU test holds: the same widths, a 16x24 image, 8x4x6
volumes, 16 rays a step, 64-ray render chunks. Besides BENCHMARK.json's
cells, two variants that keep the reference's other paths held to the
port: one scene through `VolTrainer.run` (the lockstep traffic with one
scene), and that with the BlendedMVS configuration the port ships
(`config.bmvs_config`: the NeRF++ background), in the keys the dtu file
holds."""

from __future__ import annotations

import copy
import dataclasses
import json

from port_bench import run

CELLS = [w["name"] for w in run.load_spec()["workloads"]]
VARIANTS = ["serial", "serial_bmvs"]


def _subset(full, like):
    """The keys of `full` that `like` holds, nested groups alike."""
    if isinstance(like, dict):
        return {k: _subset(full[k], v) for k, v in like.items()}
    return full


def _bmvs(doc):
    from s_volsdf_tpu_torch.config import bmvs_config
    full = json.loads(json.dumps(dataclasses.asdict(bmvs_config())))
    like = dict(doc["config"])
    like["model"] = dict(like["model"], bg=full["model"]["bg"])
    return dict(doc, name="volsdf_bmvs", config=_subset(full, like))


def tiny_cell(name: str) -> run.Cell:
    spec = run.load_spec()
    train = next(w["name"] for w in spec["workloads"]
                 if run.Cell(spec, w["name"]).traffic["entry"] == "train")
    cell = run.Cell(spec, train if name in VARIANTS else name)
    c = copy.deepcopy(cell.config)
    if name == "serial_bmvs":
        c = _bmvs(c)
    c["scene"] = dict(c["scene"], img_res=[16, 24])
    c["volumes"] = dict(c["volumes"], shape=[8, 4, 6])
    c["config"]["train"]["num_pixels"] = 16
    cell.config = c
    cell.traffic = dict(cell.traffic, warmup_steps=1, trace_steps=1,
                        chunk=64, check_chunks=2, tail_steps=3)
    if name in VARIANTS:
        cell.traffic.update(scenes=1, sphere_radii=[0.8])
        cell.name = name
    return cell

"""Whole views of the field from the seed, rendered one after another by
`engine.render.render_image`; every view of the window is kept for the
check."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import torch

from port_bench import arith, check, inputs
from port_bench.drive import port_config, profile, sync, timed


class Entry:
    unit = "view"

    def __init__(self, doc: Dict, traffic: Dict, seed: int, device):
        self.doc, self.traffic, self.seed = doc, traffic, seed
        self.device = torch.device(device)
        self.scene_doc = doc["scene"]
        self.chunk = traffic["chunk"]

    def setup(self, parts: Dict[str, float]) -> None:
        from s_volsdf_tpu_torch.engine.render import render_image
        from s_volsdf_tpu_torch.models.network import init_volsdf_params
        dev = self.device
        self.render_image = render_image
        with timed(parts, "config"):
            cfg = port_config(self.doc)
        self.cfg_doc = self.doc["config"]
        self.mcfg = cfg.model
        sd = self.scene_doc
        H, W = sd["img_res"]
        with timed(parts, "inputs"):
            angles = [math.radians(a) for a in self.traffic["view_angles_deg"]]
            cams = inputs.sphere_scene((H, W), 0.8, dev, angles, sd["cam_radius"])
            self.poses, self.K = cams["poses"], cams["K"]
            self.weights = inputs.init_weights(self.cfg_doc["model"], inputs.generator(
                inputs.sub_seed(self.seed, 0, 1), dev), dev)
            sync(dev)
        with timed(parts, "model"):
            self.params = init_volsdf_params(torch.Generator().manual_seed(0),
                                             self.mcfg, dev)
            self.params.load_state_dict(self.weights)
            self.host_poses = self.poses.cpu().numpy()
            self.host_K = self.K.cpu().numpy()
        with timed(parts, "warmup"):
            # One full chunk at the image's centre: every shape a chunk of
            # the window takes.
            side = int(math.isqrt(self.chunk))
            K = self.host_K[0].copy()
            K[0, 2] -= (W - side) / 2.0
            K[1, 2] -= (H - side) / 2.0
            self._render(self.host_poses[0], K, (side, self.chunk // side))
            sync(dev)

    def _render(self, pose, K, res):
        return self.render_image(self.params, self.mcfg, pose, K, res,
                                 chunk=self.chunk, fast=self.traffic["fast"],
                                 device=self.device)

    def _view(self, i: int):
        v = i % len(self.host_poses)
        return v, self._render(self.host_poses[v], self.host_K[v],
                               tuple(self.scene_doc["img_res"]))

    def window(self, seconds: float) -> Dict:
        """Whole views until `seconds` have passed; the rate counts the
        views completed, to the end of the last one."""
        self.views, times = [], []
        t0 = time.perf_counter()
        last = t0
        while True:
            v, maps = self._view(len(self.views))
            now = time.perf_counter()
            self.views.append((v, maps))
            times.append(now - last)
            last = now
            if now - t0 >= seconds:
                break
        H, W = self.scene_doc["img_res"]
        failed = sum(1 for _, m in self.views
                     if not all(bool(torch.isfinite(torch.as_tensor(a)).all())
                                for a in m.values()))
        self.stretch = {"units": len(self.views), "seconds": last - t0,
                        "rays": len(self.views) * H * W, "unit_seconds": times,
                        "failed": failed}
        return self.stretch

    def profile(self) -> Dict:
        from s_volsdf_tpu_torch.ops import fused_sdf
        n = self.traffic["trace_views"]
        # The traced views are the window's first n, pose for pose.
        untraced = sum(self.stretch["unit_seconds"][:n])
        if len(self.stretch["unit_seconds"]) < n:
            untraced = n * self.stretch["seconds"] / self.stretch["units"]
        prof = profile(lambda: [self._view(i) for i in range(n)], n, untraced,
                       self.device, "render_image",
                       lambda: fused_sdf.fused_sdf_values.launches)
        launches = prof["counted"]
        H, W = self.scene_doc["img_res"]
        # Each launch sweeps N_samples_eval points of a chunk's rays; the
        # smallest chunk's, so that the count is never above the work.
        rows = min(self.chunk, H * W - (math.ceil(H * W / self.chunk) - 1) * self.chunk)
        prof.update({"fused_launches": launches,
                     "fused_points": launches * rows
                     * self.cfg_doc["model"]["sampler"]["N_samples_eval"]})
        return prof

    def finish(self) -> None:
        """The window's views are what the check reads."""

    def flops_per_unit(self) -> float:
        H, W = self.scene_doc["img_res"]
        return arith.view_flops(self.cfg_doc["model"], H * W)

    def release(self) -> None:
        del self.params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, control: bool = False) -> Dict[str, float]:
        """Sampled chunks of the window's views against the reference at
        the stated float32; the control is that reference with TF32
        products in the program's place."""
        chunks = check.sample_chunks(self)
        prec = check.ref.eval_model_prec(self.cfg_doc)
        want = check.reference_render(self, chunks, prec, tf32=False)
        got = (check.reference_render(self, chunks, prec, tf32=True) if control
               else check.program_render(self, chunks))
        return check.render_numbers(got, want)

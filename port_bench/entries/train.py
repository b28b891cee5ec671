"""S scenes trained from the seed: through `VolTrainer.run`, or in
lockstep through `engine.multiscene.run_joint`, one call of the
trainer's loop a window.

Set-up runs the first `checked_steps` steps through the window's own
call (a step, then the rest), keeping the first step's clipped gradient
(from Adam's first moment) and the parameters after them. After the
window, `finish` makes the check's own pair of calls from the state the
window left, its step count put past the colour anneal (`anneal_rgb`)
so that every term of the loss, the colour MLP's among them, is on, and
Adam's moments and counts cleared, as a run resumed with a fresh
optimizer has them: a call of `tail_steps` - 1 steps, and from the same
state again a call of `tail_steps` steps. The program is deterministic,
so the second call's first steps repeat the first call's; its last
step, a step deep inside a call, is what the reference follows from the
first call's end. Clearing the moments keeps them of the size of the
tail's own gradients, so that the last step's gradient comes back from
two of them (check.program_tail) without cancelling: past the window
the colour MLP's gradients are far smaller than the moments it left.
"""

from __future__ import annotations

import copy
import gc
import math
import time
from typing import Dict

import torch

from port_bench import arith, check, inputs
from port_bench.drive import port_config, profile, sync, timed


def _terms(lo) -> Dict[str, float]:
    """A step's loss and its terms, as the reference names them."""
    return {k: getattr(lo, k) for k in ("loss", "rgb_loss", "eikonal_loss",
                                        "mvs_loss", "sparse_loss")}


def _state(t) -> Dict:
    """A copy of what a trainer's next call starts from: the parameters,
    Adam's moments and counts by leaf, the step count, the generator."""
    adam = t.state.opt_state.adam
    out = {"params": {}, "adam": {}, "iter_step": t.state.iter_step,
           "epoch": t.epoch, "gen": t.gen.get_state().clone()}
    for name, p in t.state.params.named_parameters():
        out["params"][name] = p.detach().clone()
        st = adam.state.get(p)
        if st:
            out["adam"][name] = (st["exp_avg"].detach().clone(),
                                 st["exp_avg_sq"].detach().clone(),
                                 int(float(st["step"])))
    return out


def _restore(t, s: Dict) -> None:
    adam = t.state.opt_state.adam
    with torch.no_grad():
        for name, p in t.state.params.named_parameters():
            p.copy_(s["params"][name])
            adam.state.pop(p, None)
            if name in s["adam"]:
                m, v, n = s["adam"][name]
                adam.state[p] = {"step": torch.tensor(float(n)),
                                 "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
    t.state.iter_step, t.epoch = s["iter_step"], s["epoch"]
    t.gen.set_state(s["gen"])


class Entry:
    unit = "step"

    def __init__(self, doc: Dict, traffic: Dict, seed: int, device):
        self.doc, self.traffic, self.seed = doc, traffic, seed
        self.device = torch.device(device)
        self.scene_doc, self.vol_doc = doc["scene"], doc["volumes"]
        self.S = traffic["scenes"]

    def call(self, n: int) -> None:
        """The user's call: n steps of every scene."""
        if self.S > 1:
            from s_volsdf_tpu_torch.engine.multiscene import run_joint
            run_joint(self.trainers, n)
        else:
            self.trainers[0].run(n)

    def setup(self, parts: Dict[str, float]) -> None:
        from s_volsdf_tpu_torch.data.scene_dataset import SceneData
        from s_volsdf_tpu_torch.engine.trainer import VolTrainer
        from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes
        dev = self.device
        with timed(parts, "config"):
            cfg = port_config(self.doc)
        self.cfg_doc = self.doc["config"]
        sd = self.scene_doc
        self.scenes, self.vols, self.weights, self.draw_seeds = [], [], [], []
        with timed(parts, "inputs"):
            for s in range(self.S):
                sc = inputs.sphere_scene(sd["img_res"], self.traffic["sphere_radii"][s],
                                         dev, inputs.view_angles(sd["views"]),
                                         sd["cam_radius"])
                V = sc["poses"].shape[0]
                self.scenes.append({"rgb": sc["images"].reshape(V, -1, 3),
                                    "rgb_smooth": sc["images"].reshape(V, -1, 3),
                                    "poses": sc["poses"], "K": sc["K"],
                                    "img_res": tuple(sd["img_res"])})
                self.vols.append(inputs.volumes(sc, self.vol_doc, inputs.generator(
                    inputs.sub_seed(self.seed, s, 0), dev)) if cfg.use_mvs else None)
                self.weights.append(inputs.init_weights(
                    self.cfg_doc["model"], inputs.generator(
                        inputs.sub_seed(self.seed, s, 1), dev), dev))
                self.draw_seeds.append(inputs.sub_seed(self.seed, s, 2))
            sync(dev)
        with timed(parts, "trainers"):
            self.trainers = []
            for s in range(self.S):
                sc = self.scenes[s]
                host = {k: sc[k].cpu().numpy() for k in ("rgb", "poses", "K")}
                scene = SceneData(img_res=sc["img_res"], intrinsics=host["K"],
                                  poses=host["poses"], rgb=host["rgb"],
                                  rgb_smooth=host["rgb"])
                t = VolTrainer(copy.deepcopy(cfg), scene, None, device=dev)
                t.state.params.load_state_dict(self.weights[s])
                t.gen.manual_seed(self.draw_seeds[s])
                v = self.vols[s]
                if v is not None:
                    t.mvs = MVSVolumes(prob=v["prob"], z_slab=v["z_slab"],
                                       intrinsics=v["K"], c2w=v["c2w"],
                                       img_res=tuple(v["img_res"]),
                                       inverse_depth=False)
                self.trainers.append(t)
        n_checked = self.traffic["checked_steps"]
        with timed(parts, "first_steps"):
            self.call(1)
            self.first_grad = [self._first_grad(t) for t in self.trainers]
            self.losses = [[_terms(lo) for lo in t.losses] for t in self.trainers]
            self.call(n_checked - 1)
            for s, t in enumerate(self.trainers):
                self.losses[s] += [_terms(lo) for lo in t.losses]
            self.params_after = [{k: v.detach().clone() for k, v in
                                  t.state.params.state_dict().items()}
                                 for t in self.trainers]
            sync(dev)
        with timed(parts, "warmup"):
            w = self.traffic["warmup_steps"]
            t0 = time.perf_counter()
            self.call(w)
            sync(dev)
            self.step_estimate = (time.perf_counter() - t0) / w

    @staticmethod
    def _first_grad(t) -> Dict[str, torch.Tensor]:
        """The clipped gradient of the first step, as Adam's state after
        it holds it: m1 = (1 - b1) g (zero where the step left no state)."""
        adam = t.state.opt_state.adam
        return {name: (adam.state[p]["exp_avg"].detach() / (1 - 0.9)
                       if adam.state.get(p) else torch.zeros_like(p.detach()))
                for name, p in t.state.params.named_parameters()}

    def window(self, seconds: float) -> Dict:
        """One call whose steps fill `seconds` at the warm-up's pace."""
        n = max(1, math.ceil(seconds / self.step_estimate))
        t0 = time.perf_counter()
        self.call(n)
        sync(self.device)
        wall = time.perf_counter() - t0
        lead = self.trainers[0]
        failed = sum(1 for i in range(n) if any(
            t.losses[i].grad_finite == 0.0 for t in self.trainers))
        rays = self.S * self.cfg_doc["train"]["num_pixels"] * n
        self.stretch = {"units": n, "seconds": wall, "rays": rays,
                        "unit_seconds": list(lead.step_seconds), "failed": failed}
        return self.stretch

    def profile(self) -> Dict:
        from s_volsdf_tpu_torch.ops import fused_sdf
        n = self.traffic["trace_steps"]
        prof = profile(lambda: self.call(n), n,
                       n * self.stretch["seconds"] / self.stretch["units"],
                       self.device, "run_joint" if self.S > 1 else "VolTrainer.run",
                       lambda: fused_sdf.fused_sdf_values.launches)
        per_launch = (self.S * self.cfg_doc["train"]["num_pixels"]
                      * self.cfg_doc["model"]["sampler"]["N_samples_eval"])
        prof.update({"fused_launches": prof["counted"],
                     "fused_points": prof["counted"] * per_launch})
        return prof

    def finish(self) -> None:
        """The check's pair of calls (module docstring)."""
        k = self.traffic["tail_steps"]
        past = self.cfg_doc["loss"]["anneal_rgb"]
        for t in self.trainers:
            t.state.iter_step = max(t.state.iter_step, past)
            t.state.opt_state.adam.state.clear()
        start = [_state(t) for t in self.trainers]
        self.call(k - 1)
        self.tail_start = [_state(t) for t in self.trainers]
        before = [t.losses[-1].loss for t in self.trainers]
        for t, s in zip(self.trainers, start):
            _restore(t, s)
        self.call(k)
        self.tail_end = [_state(t) for t in self.trainers]
        self.tail_losses = [_terms(t.losses[-1]) for t in self.trainers]
        self.tail_replay = [abs(t.losses[-2].loss - b) / max(abs(b), 1e-30)
                            for t, b in zip(self.trainers, before)]
        sync(self.device)

    def flops_per_unit(self) -> float:
        return self.S * arith.train_step_flops(
            self.cfg_doc["model"], self.cfg_doc["train"]["num_pixels"])

    def release(self) -> None:
        del self.trainers
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, control: bool = False) -> Dict[str, float]:
        """The first steps and the tail step of every scene against the
        reference at the stated precision; the control is the reference
        at the next lower precision (check.lower_prec) in the program's
        place."""
        prec = check.ref.train_model_prec(self.cfg_doc)
        want = check.reference_training(self, prec)
        want_tail = check.reference_tail(self, prec)
        if control:
            low = check.lower_prec(prec)
            got = check.reference_training(self, low)
            got_tail = [dict(st, replay=0.0) for st in check.reference_tail(self, low)]
        else:
            got, got_tail = check.program_training(self), check.program_tail(self)
        return {**check.training_numbers(self, got, want),
                **check.tail_numbers(self, got_tail, want_tail)}
